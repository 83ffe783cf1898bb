"""Materialize executor — terminal op maintaining the MV's state table
(port of risingwave_tpu/stream/materialize.py).

Applies the changelog to the MV table with a ConflictBehavior and commits
at barriers. The MV table is the queryable result. The visible rows are
compacted on the device first (kernel K12 on the card) and only they
cross to the host: a top-N's 2C-row output chunk holds at most 2 x
limit visible rows.

Left out of this slice (ROADMAP Queue A): the serving hook and the
durable changelog log taps.
"""

from __future__ import annotations

import enum

from ..common.chunk import StreamChunk, OP_INSERT, OP_UPDATE_INSERT
from ..ops.hash_table import compact_mask
from ..state.state_table import StateTable
from .executor import Executor
from .message import Barrier, BarrierKind


class ConflictBehavior(enum.Enum):
    NO_CHECK = "no_check"            # trust the changelog (MV over stream ops)
    OVERWRITE = "overwrite"          # upsert by pk (tables with pk)
    IGNORE = "ignore_conflict"       # first write wins


class MaterializeExecutor(Executor):
    def __init__(self, input: Executor, table: StateTable,
                 conflict: ConflictBehavior = ConflictBehavior.NO_CHECK):
        self.input = input
        self.schema = input.schema
        self.pk_indices = table.pk_indices
        self.table = table
        self.conflict = conflict
        self.identity = f"Materialize(table={table.table_id})"

    async def execute(self):
        first = True
        async for msg in self.input.execute():
            if isinstance(msg, StreamChunk):
                self._apply(msg)
                yield msg
            elif isinstance(msg, Barrier):
                # a dataflow created mid-session initializes on its first
                # OBSERVED barrier, which need not be the Initial kind
                if first or msg.kind is BarrierKind.INITIAL:
                    first = False
                    self.table.init_epoch(msg.epoch.curr)
                else:
                    self.table.commit(msg.epoch.curr)
                yield msg
            else:
                yield msg

    def _apply(self, chunk: StreamChunk) -> None:
        rows = visible_rows(chunk)
        if self.conflict is ConflictBehavior.NO_CHECK:
            self.table.write_chunk_rows(rows)
            return
        for op, row in rows:
            if op in (OP_INSERT, OP_UPDATE_INSERT):
                pk = tuple(row[i] for i in self.table.pk_indices)
                existing = self.table.get_row(pk, dist_values=tuple(
                    row[i] for i in self.table.dist_key_indices))
                if existing is not None:
                    if self.conflict is ConflictBehavior.IGNORE:
                        continue
                    self.table.update(existing, row)
                else:
                    self.table.insert(row)
            else:
                self.table.delete(row)


def visible_rows(chunk: StreamChunk) -> list[tuple]:
    """`chunk.to_rows()`, with the visible rows gathered on the device
    (K12's compaction) before the copy to the host."""
    sel, n = compact_mask(chunk.vis)
    m = int(n)
    if m == 0:
        return []
    idx = sel[:m]
    ops = chunk.ops[idx].cpu().numpy()
    cols = [c.data[idx].cpu().numpy() for c in chunk.columns]
    valids = [None if c.valid is None else c.valid[idx].cpu().numpy()
              for c in chunk.columns]
    return [(int(ops[r]), tuple(c[r].item() if v is None or v[r] else None
                                for c, v in zip(cols, valids)))
            for r in range(m)]
