"""StorageTable — the batch read path over an MV's state (port of
risingwave_tpu/state/storage_table.py).

Reads run on the host, over the store's committed snapshot (the
manifest's SSTs; for `scan_vnode_after`, also the staged epochs up to a
bound). The key layout `table_id ++ vnode ++ memcomparable(pk)` is a
private StateTable's, so batch reads find what streaming wrote.
`rows_to_columns` turns stored rows back into columns and
`rows_to_chunk` into a padded all-Insert chunk (the backfill's snapshot
chunks, a durable top-N's and over-window's recovery).

Left out of this slice (ROADMAP Queue A): `snapshot_with_keys` and the
numpy column forms (`to_numpy`, `to_numpy_with_validity`), which serve
the batch SELECT and serving paths the port does not have.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ..common.chunk import OP_INSERT, Column, StreamChunk
from ..common.types import Schema
from ..common.vnode import VNODE_COUNT
from .serde import RowSerde
from .state_table import StateTable
from .store import StateStore


class StorageTable:
    """Read-only batch access to a (materialized) table's state."""

    def __init__(self, store: StateStore, table_id: int, schema: Schema,
                 pk_indices: Sequence[int],
                 dist_key_indices: Optional[Sequence[int]] = None,
                 pk_descending: Optional[Sequence[bool]] = None):
        # the private StateTable only carries the key layout: its
        # mem-table is never written
        self._layout = StateTable(
            store, table_id=table_id, schema=schema, pk_indices=pk_indices,
            dist_key_indices=dist_key_indices, pk_descending=pk_descending)
        self.store = store
        self.table_id = table_id
        self.schema = schema
        self.pk_indices = tuple(pk_indices)
        self._serde = RowSerde(schema)

    @classmethod
    def for_state_table(cls, t: StateTable) -> "StorageTable":
        """Batch-read view of an existing StateTable (same key layout)."""
        return cls(t.store, t.table_id, t.schema, t.pk_indices,
                   dist_key_indices=t.dist_key_indices,
                   pk_descending=t.pk_descending)

    @property
    def dist_key_indices(self) -> tuple:
        return self._layout.dist_key_indices

    # --------------------------------------------------------------- reads
    def get_row(self, pk: tuple) -> Optional[tuple]:
        """Committed point lookup by primary key."""
        pk = tuple(pk)
        key = self._layout.key_of_pk(pk, self._layout.vnode_of_pk(pk))
        for _, row in self._iter_keyrange(key, key + b"\xff"):
            return row
        return None

    def _iter_keyrange(self, start: bytes, end: bytes
                       ) -> Iterator[tuple[bytes, tuple]]:
        for k, v in self.store.iter_range(start, end, committed_only=True):
            yield k, self._serde.decode(v)

    def scan_vnode_after(self, vnode: int, after_pk: Optional[tuple],
                         limit: int, max_epoch: Optional[int] = None
                         ) -> tuple[list[tuple], bool]:
        """Up to `limit` rows of one vnode with pk strictly after
        `after_pk` (None: from the vnode's start), in pk order: the
        backfill's snapshot read. The committed snapshot and the staged
        epochs up to `max_epoch` are visible (sealed-but-uncommitted
        batches included), later epochs are not, so the read is the
        table as of one barrier. Returns (rows, vnode exhausted)."""
        start, end = self._layout.vnode_key_range(vnode)
        if after_pk is not None:
            # memcomparable keys order like their pk tuples: the next key
            # strictly after an exact pk is key ++ 0x00
            start = self._layout.key_of_pk(tuple(after_pk), vnode) + b"\x00"
        rows: list[tuple] = []
        for _, v in self.store.iter_range(start, end, committed_only=False,
                                          max_epoch=max_epoch):
            rows.append(self._serde.decode(v))
            if len(rows) > limit:
                break
        if len(rows) > limit:
            return rows[:limit], False
        return rows, True

    def batch_iter_vnode(self, vnode: int) -> Iterator[tuple]:
        """Committed rows of one vnode in pk order."""
        start, end = self._layout.vnode_key_range(vnode)
        for _, row in self._iter_keyrange(start, end):
            yield row

    def batch_iter(self, vnode_bitmap: Optional[np.ndarray] = None
                   ) -> Iterator[tuple]:
        """Every committed row, vnode by vnode (optionally a subset of
        the vnodes)."""
        vnodes = (range(VNODE_COUNT) if vnode_bitmap is None
                  else np.flatnonzero(vnode_bitmap))
        for vn in vnodes:
            yield from self.batch_iter_vnode(int(vn))


def rows_to_columns(schema: Schema, rows: list
                    ) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """(columns, validity masks) of row tuples: a None cell becomes 0
    with valid False."""
    cols, valids = [], []
    for j, f in enumerate(schema):
        vals = [r[j] for r in rows]
        valid = np.asarray([v is not None for v in vals], dtype=bool)
        arr = np.asarray([0 if v is None else v for v in vals],
                         dtype=f.data_type.np_dtype)
        cols.append(arr)
        valids.append(valid)
    return cols, valids


def rows_to_chunk(schema: Schema, rows: list, capacity: int, device
                  ) -> StreamChunk:
    """An all-Insert chunk of `capacity` rows on `device`: the first
    len(rows) visible and filled from the row tuples, the rest zero; a
    column gets a validity mask only where it holds a NULL."""
    n = len(rows)
    dev = torch.device(device)
    arrays, valids = rows_to_columns(schema, rows)
    cols = []
    for a, v, f in zip(arrays, valids, schema):
        data = torch.zeros(capacity, dtype=f.data_type.torch_dtype,
                           device=dev)
        data[:n] = torch.from_numpy(a).to(dev)
        valid = None
        if not v.all():
            valid = torch.zeros(capacity, dtype=torch.bool, device=dev)
            valid[:n] = torch.from_numpy(v).to(dev)
        cols.append(Column(data, valid))
    ops = torch.full((capacity,), OP_INSERT, dtype=torch.int8, device=dev)
    vis = torch.arange(capacity, device=dev) < n
    return StreamChunk(tuple(cols), ops, vis, schema)
