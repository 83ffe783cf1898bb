"""Backfill — bring an MV (or sink) up over an existing MV (port of
risingwave_tpu/stream/backfill.py).

`CREATE MATERIALIZED VIEW ... FROM <mv>` scans the upstream MV's table
in (vnode, pk) order (the snapshot side) while the upstream's live
changelog streams in through a tap, and reconciles the two with a
progress pointer:

  * at every barrier after the first, the next snapshot batch of up to
    `batch_rows` rows after the pointer is read, emitted as Inserts, and
    the pointer advances;
  * a live chunk keeps only the rows at or before the pointer (their
    base row is already downstream); rows ahead of it are dropped, since
    a later snapshot batch reads their new image. This mask is entry two
    of kernel K31 (common/vnode.py `backfill_filter`): the vnode of the
    distribution key and the lexicographic pk compare in one launch;
  * once the scan is exhausted, live chunks pass through.

The upstream actor runs ahead of this one (channels buffer), so the
snapshot read is bounded to epochs <= barrier.epoch.prev: exactly the
epochs the upstream sealed before it forwarded this barrier. Without
the bound a row could arrive through both the snapshot and the live
stream.

Progress (vnode, pk, finished) is written to a state table at every
barrier and read back on recovery, so a crash in the middle of a
backfill resumes where the last committed barrier left it. Watermarks
are suppressed until the scan finishes: one covers only the live stream,
and state cleaning driven by it could purge rows the snapshot has yet to
deliver.

Snapshot rows cross from the store to the host as Python tuples and
then to the device as columns (`rows_to_chunk`), one batch a barrier.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..common.chunk import StreamChunk
from ..common.types import DataType, Field, Schema
from ..common.vnode import VNODE_COUNT, backfill_filter
from ..state.state_table import StateTable
from ..state.storage_table import StorageTable, rows_to_chunk
from .executor import Executor
from .message import Barrier, BarrierKind


def backfill_progress_schema(mv_schema: Schema,
                             pk_indices: Sequence[int]) -> Schema:
    fields = [Field("slot", DataType.INT64), Field("finished", DataType.INT64),
              Field("vnode", DataType.INT64), Field("has_pk", DataType.INT64)]
    for j, i in enumerate(pk_indices):
        fields.append(Field(f"pk{j}", mv_schema[i].data_type))
    return Schema(tuple(fields))


class BackfillExecutor(Executor):
    def __init__(self, upstream: Executor, storage: StorageTable,
                 state_table: Optional[StateTable] = None,
                 batch_rows: int = 65536, chunk_capacity: int = 8192,
                 device="cuda"):
        self.input = upstream                 # the live changelog tap
        self.storage = storage
        self.schema = storage.schema
        self.pk_indices = tuple(storage.pk_indices)
        self.state_table = state_table
        self.batch_rows = batch_rows
        self.chunk_capacity = chunk_capacity
        self.device = torch.device(device)
        self.identity = f"Backfill(table={storage.table_id})"
        self._dist_idx = tuple(storage.dist_key_indices)
        # progress
        self.finished = False
        self.vnode = 0                        # vnodes below it are done
        self.last_pk: Optional[tuple] = None  # within self.vnode
        self.snapshot_rows_total = 0

    # ------------------------------------------------------------ filtering
    def _filter_chunk(self, chunk: StreamChunk) -> StreamChunk:
        """Keep the rows the scan has covered: vnode < cur, or vnode ==
        cur and pk <= last_pk (K31)."""
        pk_vals = (self.last_pk if self.last_pk is not None
                   else (0,) * len(self.pk_indices))
        vis = backfill_filter(
            [chunk.columns[i].data for i in self._dist_idx],
            [chunk.columns[i].data for i in self.pk_indices], pk_vals,
            self.vnode, self.last_pk is not None, chunk.vis)
        return StreamChunk(chunk.columns, chunk.ops, vis, chunk.schema)

    # ------------------------------------------------------------- snapshot
    def _snapshot_batch(self, max_epoch: int) -> list[StreamChunk]:
        """Read up to batch_rows rows after the position, advance it,
        and flip `finished` when the scan is exhausted."""
        rows: list[tuple] = []
        budget = self.batch_rows
        while budget > 0 and self.vnode < VNODE_COUNT:
            got, exhausted = self.storage.scan_vnode_after(
                self.vnode, self.last_pk, budget, max_epoch=max_epoch)
            rows.extend(got)
            budget -= len(got)
            if exhausted:
                self.vnode += 1
                self.last_pk = None
            else:
                self.last_pk = tuple(got[-1][i] for i in self.pk_indices)
        if self.vnode >= VNODE_COUNT:
            self.finished = True
        self.snapshot_rows_total += len(rows)
        return [rows_to_chunk(self.schema, rows[ofs:ofs + self.chunk_capacity],
                              self.chunk_capacity, self.device)
                for ofs in range(0, len(rows), self.chunk_capacity)]

    # ------------------------------------------------------------ progress
    def _persist(self, barrier: Barrier) -> None:
        if self.state_table is None:
            return
        pk = (tuple(self.last_pk) if self.last_pk is not None
              else tuple(0 for _ in self.pk_indices))
        row = (0, int(self.finished), self.vnode,
               int(self.last_pk is not None)) + pk
        self.state_table.write_chunk_rows([(0, row)])
        self.state_table.commit(barrier.epoch.curr)

    def _recover(self) -> None:
        if self.state_table is None:
            return
        row = self.state_table.get_row((0,))
        if row is None:
            return
        _, finished, vnode, has_pk, *pk = row
        self.finished = bool(finished)
        self.vnode = int(vnode)
        self.last_pk = tuple(pk) if has_pk else None

    # --------------------------------------------------------------- stream
    async def execute(self):
        first = True
        async for msg in self.input.execute():
            if isinstance(msg, StreamChunk):
                yield msg if self.finished else self._filter_chunk(msg)
            elif isinstance(msg, Barrier):
                if first or msg.kind is BarrierKind.INITIAL:
                    first = False
                    if self.state_table is not None:
                        self.state_table.init_epoch(msg.epoch.curr)
                        self._recover()
                    yield msg
                    continue
                if not self.finished:
                    for chunk in self._snapshot_batch(msg.epoch.prev):
                        yield chunk
                self._persist(msg)
                yield msg
            elif self.finished:
                yield msg            # a watermark, once the scan is done
