"""StateTable — the state abstraction stateful executors and MVs use
(port of risingwave_tpu/state/state_table.py).

Typed rows over a StateStore; key = vnode(dist_key) ++ memcomparable(pk);
a mem-table buffers writes between barriers; `commit(new_epoch)` flushes
and seals the epoch. Device executors keep their compute state on the
device; the StateTable is the host-side durability and MV path.

Left out of this slice (ROADMAP Queue A): the native C++ batch codec of
`write_chunk_columns` (the port writes row by row), `get_rows`, and the
consistency modes beyond double-insert detection.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

from ..common.chunk import OP_INSERT, OP_UPDATE_INSERT
from ..common.types import Schema
from ..common.vnode import VNODE_COUNT, compute_vnodes_numpy
from .serde import RowSerde, encode_memcomparable
from .store import StateStore, WriteBatch, encode_table_key


class StateTableError(Exception):
    pass


class StateTable:
    def __init__(
        self,
        store: StateStore,
        table_id: int,
        schema: Schema,
        pk_indices: Sequence[int],
        dist_key_indices: Optional[Sequence[int]] = None,
        vnode_bitmap: Optional[np.ndarray] = None,
        pk_descending: Optional[Sequence[bool]] = None,
        check_consistency: bool = True,
    ):
        self.store = store
        self.table_id = table_id
        self.schema = schema
        self.pk_indices = tuple(pk_indices)
        # dist key defaults to the first pk column; () = singleton (vnode 0)
        self.dist_key_indices = tuple(
            dist_key_indices if dist_key_indices is not None
            else self.pk_indices[:1])
        self.vnode_bitmap = (np.ones(VNODE_COUNT, dtype=bool)
                             if vnode_bitmap is None
                             else np.asarray(vnode_bitmap, dtype=bool))
        self.pk_descending = (tuple(pk_descending)
                              if pk_descending is not None else None)
        self.check_consistency = check_consistency
        self._pk_types = tuple(schema[i].data_type for i in self.pk_indices)
        self._serde = RowSerde(schema)
        # mem-table: full key -> (op, row|None); op in {+1 put, -1 delete}
        self._mem: dict[bytes, tuple[int, Optional[tuple]]] = {}
        self.epoch: Optional[int] = None

    # ------------------------------------------------------------- keys
    def _vnodes_of_batch(self, rows: Sequence[tuple]) -> np.ndarray:
        if not self.dist_key_indices:
            return np.zeros(len(rows), dtype=np.int32)
        # NULL dist-key values hash as 0, like an invalid lane's data
        cols = [
            np.asarray([0 if r[i] is None else r[i] for r in rows],
                       dtype=self.schema[i].data_type.np_dtype)
            for i in self.dist_key_indices
        ]
        return compute_vnodes_numpy(cols)

    def _key_of(self, row: tuple) -> bytes:
        pk = tuple(row[i] for i in self.pk_indices)
        return self.key_of_pk(pk, int(self._vnodes_of_batch([row])[0]))

    def key_of_pk(self, pk: tuple, vnode: int) -> bytes:
        return encode_table_key(
            self.table_id, vnode,
            encode_memcomparable(pk, self._pk_types, self.pk_descending))

    def vnode_key_range(self, vnode: int) -> tuple[bytes, bytes]:
        """[start, end) covering one vnode of this table."""
        start = encode_table_key(self.table_id, vnode, b"")
        end = (encode_table_key(self.table_id, vnode + 1, b"")
               if vnode + 1 < VNODE_COUNT
               else (self.table_id + 1).to_bytes(4, "big"))
        return start, end

    # ------------------------------------------------------------ writes
    def init_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def insert(self, row: tuple) -> None:
        k = self._key_of(row)
        prev = self._mem.get(k)
        if self.check_consistency and prev is not None and prev[0] > 0:
            raise StateTableError(
                f"double insert for key {row!r} in table {self.table_id}")
        self._mem[k] = (1, tuple(row))

    def delete(self, row: tuple) -> None:
        # always a tombstone: an insert+delete within one epoch must still
        # delete any version of the key from a prior epoch
        self._mem[self._key_of(row)] = (-1, None)

    def update(self, old_row: tuple, new_row: tuple) -> None:
        ko, kn = self._key_of(old_row), self._key_of(new_row)
        if ko == kn:
            self._mem[kn] = (1, tuple(new_row))
        else:
            self.delete(old_row)
            self.insert(new_row)

    def write_chunk_rows(self, rows: Sequence[tuple[int, tuple]]) -> None:
        """rows: (op, values) with chunk Op encoding; vnodes for the batch
        hash in one vectorized pass."""
        if not rows:
            return
        vnodes = self._vnodes_of_batch([r for _, r in rows])
        for (op, row), vn in zip(rows, vnodes):
            k = self.key_of_pk(tuple(row[i] for i in self.pk_indices),
                               int(vn))
            if op in (OP_INSERT, OP_UPDATE_INSERT):
                self._mem[k] = (1, tuple(row))
            else:
                self._mem[k] = (-1, None)

    # ------------------------------------------------------------- reads
    def get_row(self, pk: tuple,
                dist_values: Optional[tuple] = None) -> Optional[tuple]:
        """Read-through: mem-table first, then the store."""
        row_for_vnode = [None] * len(self.schema)
        for j, i in enumerate(self.pk_indices):
            row_for_vnode[i] = pk[j]
        if dist_values is not None:
            for j, i in enumerate(self.dist_key_indices):
                row_for_vnode[i] = dist_values[j]
        k = self._key_of(tuple(row_for_vnode))
        if k in self._mem:
            op, row = self._mem[k]
            return row if op > 0 else None
        v = self.store.get(k)
        return self._serde.decode(v) if v is not None else None

    def iter_vnode(self, vnode: int) -> Iterator[tuple[bytes, tuple]]:
        """All rows of one vnode, pk order, mem-table merged."""
        start, end = self.vnode_key_range(vnode)
        merged: dict[bytes, Optional[tuple]] = {}
        for k, v in self.store.iter_range(start, end):
            merged[k] = self._serde.decode(v)
        for k, (op, row) in self._mem.items():
            if start <= k < end:
                merged[k] = row if op > 0 else None
        for k in sorted(merged):
            if merged[k] is not None:
                yield k, merged[k]

    def iter_all(self) -> Iterator[tuple[bytes, tuple]]:
        for vn in np.flatnonzero(self.vnode_bitmap):
            yield from self.iter_vnode(int(vn))

    def iter_committed(self) -> Iterator[tuple]:
        """Rows as the store holds them after the last commit (the
        mem-table's writes since then left out), pk order per vnode."""
        for vn in np.flatnonzero(self.vnode_bitmap):
            start, end = self.vnode_key_range(int(vn))
            for _, v in self.store.iter_range(start, end):
                yield self._serde.decode(v)

    # ----------------------------------------------------------- barrier
    def commit(self, new_epoch: int) -> int:
        """Flush the mem-table to the store and advance the epoch.
        Returns the number of kv writes."""
        if self.epoch is None:
            raise StateTableError("init_epoch not called")
        puts: dict[bytes, Optional[bytes]] = {
            k: (self._serde.encode(row) if op > 0 else None)
            for k, (op, row) in self._mem.items()}
        if puts:
            self.store.ingest_batch(WriteBatch(self.table_id, self.epoch,
                                               puts))
        self._mem.clear()
        self.epoch = new_epoch
        return len(puts)
