"""StateTable — the state abstraction stateful executors and MVs use
(port of risingwave_tpu/state/state_table.py).

Typed rows over a StateStore; key = vnode(dist_key) ++ memcomparable(pk);
a mem-table buffers writes between barriers; `commit(new_epoch)` flushes
and seals the epoch. Device executors keep their compute state on the
device; the StateTable is the host-side durability and MV path.

`write_chunk_columns` is the per-barrier persist path. The JAX package
encodes its batches with a host C++ codec (risingwave_tpu/native); the
port writes the same bytes with vectorised numpy for all-int64 schemas
with an ascending pk, and row by row through `serde.py` otherwise.

Left out of this slice (ROADMAP Queue A): the consistency modes beyond
double-insert detection and `update_vnode_bitmap` (rescaling).
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
        # mem-table: full key -> (op, row|None, enc|None); op in {+1 put,
        # -1 delete}. Batch writes store encoded values and decode them
        # lazily on read-through.
        self._mem: dict[bytes, tuple[int, Optional[tuple],
                                     Optional[bytes]]] = {}
        self.epoch: Optional[int] = None
        self._all_i64 = all(
            np.dtype(f.data_type.np_dtype).kind == "i"
            and np.dtype(f.data_type.np_dtype).itemsize == 8
            for f in schema)

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

    def vnode_of_pk(self, pk: tuple) -> int:
        """Vnode of a pk tuple (the distribution key must lie within the
        pk, the batch point-get's precondition)."""
        if not self.dist_key_indices:
            return 0
        pos = [self.pk_indices.index(i) for i in self.dist_key_indices]
        cols = [np.asarray([pk[p]]).astype(self.schema[i].data_type.np_dtype)
                for p, i in zip(pos, self.dist_key_indices)]
        return int(compute_vnodes_numpy(cols)[0])

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
        self._mem[k] = (1, tuple(row), None)

    def delete(self, row: tuple) -> None:
        # always a tombstone: an insert+delete within one epoch must still
        # delete any version of the key from a prior epoch
        self._mem[self._key_of(row)] = (-1, None, None)

    def update(self, old_row: tuple, new_row: tuple) -> None:
        ko, kn = self._key_of(old_row), self._key_of(new_row)
        if ko == kn:
            self._mem[kn] = (1, tuple(new_row), None)
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
                self._mem[k] = (1, tuple(row), None)
            else:
                self._mem[k] = (-1, None, None)

    def write_chunk_columns(self, ops: np.ndarray, cols: Sequence[np.ndarray],
                            vis: np.ndarray) -> None:
        """Columnar batch write, the per-barrier persist path. `ops` uses
        the chunk Op encoding; rows with vis False are skipped. Column
        data is written as given (the persist views carry no NULLs).

        For all-int64 schemas with an ascending pk, keys and values are
        encoded for the whole batch in numpy, byte for byte what the JAX
        package's native codec writes (memcomparable field = 0x01 ++
        big-endian(v ^ sign bit); value row = zero null bitmap ++
        little-endian int64s); otherwise row by row."""
        ops = np.asarray(ops)
        vis = np.asarray(vis, dtype=bool)
        idx = np.flatnonzero(vis)
        if idx.size == 0:
            return
        if not (self._all_i64 and self.pk_descending is None):
            rows = [(int(ops[i]), tuple(
                np.asarray(cols[j])[i].item() for j in range(len(cols))))
                for i in idx]
            self.write_chunk_rows(rows)
            return
        n = idx.size
        mat = np.stack([np.asarray(c, dtype=np.int64)[idx] for c in cols],
                       axis=1)
        pk = np.ascontiguousarray(mat[:, list(self.pk_indices)])
        if self.dist_key_indices:
            vns = compute_vnodes_numpy(
                [mat[:, i] for i in self.dist_key_indices]).astype(np.uint8)
        else:
            vns = np.zeros(n, dtype=np.uint8)
        npk = pk.shape[1]
        kw = 5 + 9 * npk
        keys = np.empty((n, kw), dtype=np.uint8)
        keys[:, :4] = np.frombuffer(self.table_id.to_bytes(4, "big"),
                                    dtype=np.uint8)
        keys[:, 4] = vns
        flipped = np.ascontiguousarray(
            (pk.view(np.uint64) ^ np.uint64(1 << 63)).astype(">u8"))
        body = flipped.view(np.uint8).reshape(n, npk, 8)
        fields = keys[:, 5:].reshape(n, npk, 9)
        fields[:, :, 0] = 1
        fields[:, :, 1:] = body
        nb = self._serde._nbytes_nulls
        vw = nb + 8 * mat.shape[1]
        vals = np.zeros((n, vw), dtype=np.uint8)
        vals[:, nb:] = np.ascontiguousarray(mat.astype("<i8")).view(
            np.uint8).reshape(n, -1)
        kb, vb = keys.tobytes(), vals.tobytes()
        put = np.isin(ops[idx], (OP_INSERT, OP_UPDATE_INSERT))
        mem = self._mem
        for r in range(n):
            k = kb[r * kw:(r + 1) * kw]
            if put[r]:
                mem[k] = (1, None, vb[r * vw:(r + 1) * vw])
            else:
                mem[k] = (-1, None, None)

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
            return self._mem_row(k)
        v = self.store.get(k)
        return self._serde.decode(v) if v is not None else None

    def _mem_row(self, k: bytes) -> Optional[tuple]:
        op, row, enc = self._mem[k]
        if op <= 0:
            return None
        return row if row is not None else self._serde.decode(enc)

    def get_rows(self, pks: Sequence[tuple]) -> list:
        """Batch point-get (dist key within the pk): vnodes for the batch
        hash in one vectorized pass, mem-table first, then the store's
        `get_many`."""
        if not pks:
            return []
        if self.dist_key_indices:
            pos = [self.pk_indices.index(i) for i in self.dist_key_indices]
            cols = [np.asarray([0 if pk[p] is None else pk[p]
                                for pk in pks]).astype(
                        self.schema[i].data_type.np_dtype)
                    for p, i in zip(pos, self.dist_key_indices)]
            vns = compute_vnodes_numpy(cols)
        else:
            vns = np.zeros(len(pks), dtype=np.int32)
        keys = [self.key_of_pk(tuple(pk), int(vn))
                for pk, vn in zip(pks, vns)]
        out: list = []
        pending_keys, pending_pos = [], []
        for i, k in enumerate(keys):
            if k in self._mem:
                out.append(self._mem_row(k))
            else:
                out.append(None)
                pending_keys.append(k)
                pending_pos.append(i)
        for i, v in zip(pending_pos, self.store.get_many(pending_keys)):
            if v is not None:
                out[i] = self._serde.decode(v)
        return out

    def iter_vnode(self, vnode: int) -> Iterator[tuple[bytes, tuple]]:
        """All rows of one vnode, pk order, mem-table merged."""
        start, end = self.vnode_key_range(vnode)
        merged: dict[bytes, Optional[tuple]] = {}
        for k, v in self.store.iter_range(start, end):
            merged[k] = self._serde.decode(v)
        for k in self._mem:
            if start <= k < end:
                merged[k] = self._mem_row(k)
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
            k: (None if op <= 0 else
                enc if enc is not None else self._serde.encode(row))
            for k, (op, row, enc) in self._mem.items()}
        if puts:
            self.store.ingest_batch(WriteBatch(self.table_id, self.epoch,
                                               puts))
        self._mem.clear()
        self.epoch = new_epoch
        return len(puts)
