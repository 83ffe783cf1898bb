"""Chained hash join: the inner equi-join the JAX planner runs when a join
key is not integer-comparable (FLOAT64), port of
risingwave_tpu/stream/hash_join.py.

Semantics are the reference's two-sided streaming equi-join: a chunk
from one side probes the OTHER side's stored rows and emits joined
changelog rows (an insert-like row emits Insert matches, a delete-like
row Delete matches; update pairs degrade to Delete/Insert; NULL keys
never join), then updates its OWN store.

Each side's state is a multimap join key -> rows, a struct of tensors:

  key_table  the bucketed hash table over the join-key columns [CK]
             (ops/hash_table.py; float64 keys by value lane and IEEE
             `==`, so -0.0 and +0.0 are one key and a NaN row matches
             nothing);
  head       int32 [CK], the first row of the key's chain (-1: empty);
  rows       per input column [CR], with valids, next (int32 [CR], the
             chain link), live and dirty (bool [CR]) and top (int32
             scalar: rows ever allocated since the last rehash).

One chunk's apply, on a CUDA device (the plain versions beside each
kernel run on the CPU):

  netting   within-chunk pk runs: a stable lexsort (kernel K11 passes)
            and kernel K19 (`csrc/pk_net.cu`) keep one effective delete
            (the run's first row, if a retraction) and one effective
            insert (its last, if an insertion) per pk;
  probe     kernel K32 (`csrc/hash_join_probe.cu`): each active row
            looks its key up in the other side's table, walks the key's
            chain and emits one match per live row into the [M] match
            buffer (M = match_factor x chunk rows) with both sides'
            columns gathered, the overflow counted;
  own keys  kernel K3 (`csrc/hash_table.cu`) finds or claims the key
            slot of every active row, deletes included;
  deletes   kernel K33's delete entry (`csrc/hash_join_update.cu`):
            each effective delete tombstones the first live row of its
            chain with an equal pk (an atomic claim), or counts a miss;
            rows are never unlinked;
  inserts   K33's insert entry: rows at top + rank in chunk order,
            linked into their chains;
  condition kernel K5 ANDs the non-equi condition into the output's
            visibility, `data & valid`: an integer condition holds where
            its low bit is set.

Barrier work: the errs vector [unresolved keys, delete misses, match
overflow, row overflow] and both sides' load counts come back in one
fetch (the watchdog) and fail-stop with the reference's messages; a
durable side's dirty rows are compacted by kernel K34
(`csrc/hash_join_pack.cu`) and written as Inserts (live) or Deletes
(dead) in row order, the rows below a cleaning watermark as Deletes;
the eviction clears their live bits (K34); a side loaded past 0.7 of
its key or row capacity is rehashed (K34's keep compaction, K3 into a
fresh table, K33's insert), growing a capacity twofold where its live
part passes 0.35. Recovery re-applies the stored rows as one chunk.

State is updated in place where the reference donates it. Chunks apply
one at a time: the reference's `_make_apply_scan` only batches
dispatches of the same changelog (ROADMAP Queue B, B7).

Left out of this slice (ROADMAP Queue B, B12): the memory manager (LRU
stamps, host spill and reload); `state_bytes` is a plain sum.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..common.chunk import (
    Column, StreamChunk, OP_DELETE, OP_INSERT, op_sign,
)
from ..common.types import Field, Schema
from ..device import resolve_device
from ..expr.program import TYPE_CODES, ExprProgram
from ..ops import kernels
from ..ops.hash_table import (
    KEY_TYPE_CODES, HashTable, check_key_columns, compact_mask_plain,
    lookup, lookup_or_insert,
)
from ..utils.d2h import PendingFetch, pack_rows, unpack_rows
from .align import LEFT, RIGHT, barrier_align
from .executor import Executor
from .message import Barrier, BarrierKind, Watermark
from .sorted_join import _Buffers, net_pk_runs

MAX_COLS = 16       # columns a side (csrc/hash_join_*.cu)
MAX_PK = 4
# K34's modes
PACK_DIRTY, PACK_EVICT, PACK_KEEP = 0, 1, 2

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
_PP = ctypes.POINTER(_P)
_PI = ctypes.POINTER(_I)

# K32. Replaces stream/hash_join.py:_apply_impl's probe and output
# gather (335-369, 409-425) with ops/hash_table.py:lookup (175).
K_PROBE = kernels.register(kernels.CudaKernel(
    "hash_join_probe",
    replaces="risingwave_tpu/stream/hash_join.py:335",
    functions={"rw_hj_probe": [
        _I, _PP, _PP, _PI, _P, _I, _P, _P, _P, _P, _P, _L,
        _I, _PP, _PP, _PP, _PP, _PI, _I, _PP, _PP, _PP, _PP, _PI,
        _L, _P, _P, _P, _P, _P, _P, _P, _P, _P]}))

# K33. Replaces stream/hash_join.py:_apply_impl's deletes (371-399) and
# _bulk_insert (101).
K_UPDATE = kernels.register(kernels.CudaKernel(
    "hash_join_update",
    replaces="risingwave_tpu/stream/hash_join.py:371",
    functions={
        "rw_hj_delete": [_I, _PP, _PP, _PI, _P, _P, _L, _P, _P, _P, _P, _P,
                         _P],
        "rw_hj_insert": [_P, _P, _L, _I, _PP, _PP, _PI, _I, _I, _P, _PP,
                         _PP, _P, _P, _P, _P, _P, _L, _P, _P, _P]}))

# K34. Replaces stream/hash_join.py:_persist_view_impl (430),
# _evict_rows_impl (534), _evict_impl (545), _stats_impl (878) and
# _rehash_impl's compaction (885).
K_PACK = kernels.register(kernels.CudaKernel(
    "hash_join_pack",
    replaces="risingwave_tpu/stream/hash_join.py:430",
    functions={
        "rw_hj_pack": [_I, _L, _P, _P, _P, _I, _L, _D, _I, _PP, _PP, _PI,
                       _PP, _PP, _P, _P, _P, _P, _P, _P],
        "rw_hj_evict": [_L, _P, _P, _I, _L, _D, _P],
        "rw_hj_stats": [_L, _P, _L, _P, _P, _P, _P]}))


@dataclass
class HashJoinSideState:
    """Device state of one join side (key capacity CK, row capacity CR)."""

    key_table: HashTable
    head: torch.Tensor                   # int32 [CK], -1 = empty chain
    rows: tuple[torch.Tensor, ...]       # per input column [CR]
    valids: tuple[torch.Tensor, ...]     # per input column bool [CR]
    next: torch.Tensor                   # int32 [CR]
    live: torch.Tensor                   # bool [CR]
    dirty: torch.Tensor                  # bool [CR], changed since persist
    top: torch.Tensor                    # int32 scalar, rows allocated

    @property
    def key_capacity(self) -> int:
        return self.head.shape[0]

    @property
    def row_capacity(self) -> int:
        return self.live.shape[0]

    @property
    def device(self) -> torch.device:
        return self.live.device

    def tensors(self) -> list[torch.Tensor]:
        return [*self.key_table.keys, self.key_table.occupied, self.head,
                *self.rows, *self.valids, self.next, self.live, self.dirty,
                self.top]


def empty_side(key_capacity: int, row_capacity: int,
               key_dtypes: Sequence[torch.dtype],
               col_dtypes: Sequence[torch.dtype],
               device) -> HashJoinSideState:
    dev = torch.device(device)
    return HashJoinSideState(
        key_table=HashTable.empty(key_capacity, key_dtypes, dev),
        head=torch.full((key_capacity,), -1, dtype=torch.int32, device=dev),
        rows=tuple(torch.zeros(row_capacity, dtype=dt, device=dev)
                   for dt in col_dtypes),
        valids=tuple(torch.zeros(row_capacity, dtype=torch.bool, device=dev)
                     for _ in col_dtypes),
        next=torch.full((row_capacity,), -1, dtype=torch.int32, device=dev),
        live=torch.zeros(row_capacity, dtype=torch.bool, device=dev),
        dirty=torch.zeros(row_capacity, dtype=torch.bool, device=dev),
        top=torch.zeros((), dtype=torch.int32, device=dev))


def _check_store_cols(cols: Sequence[torch.Tensor], n: int,
                      what: str) -> None:
    if not 1 <= len(cols) <= MAX_COLS:
        raise ValueError(f"{what} takes 1..{MAX_COLS} columns a side")
    for c in cols:
        if c.shape[0] != n or not c.is_contiguous() \
                or c.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"{what}'s columns must be contiguous, of "
                             f"{n} rows, 1-8 bytes an element")


# ------------------------------------------------------------------ K32

def probe_plain(other: HashJoinSideState, key_cols, active, chunk_cols,
                ops, M: int, errs: torch.Tensor):
    """Plain PyTorch version of kernel K32, the reference's lock-step
    chain walk (hash_join.py:335-369, 409-425). Returns (own match
    columns, other match columns, ops, vis), M rows each; adds the
    match overflow to errs[2] in place."""
    N = active.shape[0]
    dev = active.device
    row_ids = torch.arange(N, dtype=torch.int64, device=dev)
    oslot = lookup(other.key_table, key_cols, active).to(torch.int64)
    cursor = torch.where(oslot >= 0,
                         other.head[oslot.clamp(min=0)].to(torch.int64), -1)
    # row M takes the dropped writes (the reference's mode="drop")
    out_own = torch.zeros(M + 1, dtype=torch.int64, device=dev)
    out_oth = torch.zeros(M + 1, dtype=torch.int64, device=dev)
    m = 0
    while bool((cursor >= 0).any()):
        cc = cursor.clamp(min=0)
        alive = (cursor >= 0) & other.live[cc]
        pos = m + torch.cumsum(alive.to(torch.int64), 0) - 1
        tgt = torch.where(alive & (pos < M), pos, M)
        out_own[tgt] = row_ids
        out_oth[tgt] = cursor
        m += int(alive.sum())
        cursor = torch.where(cursor >= 0, other.next[cc].to(torch.int64), -1)
    errs[2] += max(m - M, 0)
    out_own, out_oth = out_own[:M], out_oth[:M].clamp(min=0)
    vis = torch.arange(M, device=dev) < min(m, M)
    own_m = [Column(c.data[out_own], c.valid_mask()[out_own])
             for c in chunk_cols]
    oth_m = [Column(r[out_oth], v[out_oth])
             for r, v in zip(other.rows, other.valids)]
    ops_out = torch.where(op_sign(ops)[out_own] > 0, OP_INSERT,
                          OP_DELETE).to(torch.int8)
    return own_m, oth_m, ops_out, vis


def probe(other: HashJoinSideState, key_cols, active, chunk_cols, ops,
          M: int, errs: torch.Tensor, bufs: Optional[_Buffers] = None):
    """Kernel K32 on a CUDA device, the plain version on the CPU. Same
    contract as `probe_plain`, except that the order of the matches in
    [M] may differ (the multiset of visible matches is the same) and
    invisible slots' columns are unspecified. The match columns are
    allocated fresh on every call: they leave the join as an output
    chunk."""
    dev = active.device
    if dev.type == "cpu":
        return probe_plain(other, key_cols, active, chunk_cols, ops, M,
                           errs)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    N = active.shape[0]
    check_key_columns(other.key_table, key_cols, N, "K32")
    for t in (active, ops):
        if t.shape[0] != N or not t.is_contiguous() or t.device != dev:
            raise ValueError("K32 row inputs must be contiguous, of the "
                             "chunk's length, on its device")
    if active.dtype != torch.bool or ops.dtype != torch.int8:
        raise ValueError("K32 takes a bool activity mask and int8 ops")
    _check_store_cols([c.data for c in chunk_cols], N, "K32")
    _check_store_cols(other.rows, other.row_capacity, "K32")
    for c in chunk_cols:
        if c.valid is not None and (c.valid.dtype != torch.bool
                                    or not c.valid.is_contiguous()):
            raise ValueError("K32 chunk valids must be contiguous bools")
    if bufs is None:
        bufs = _Buffers(dev)
    i32 = torch.int32
    nb = (N + 255) // 256

    def out_cols(dtypes):
        return [Column(torch.empty(M, dtype=dt, device=dev),
                       torch.empty(M, dtype=torch.bool, device=dev))
                for dt in dtypes]

    own_m = out_cols([c.data.dtype for c in chunk_cols])
    oth_m = out_cols([r.dtype for r in other.rows])
    ops_out = torch.empty(M, dtype=torch.int8, device=dev)
    vis = torch.empty(M, dtype=torch.bool, device=dev)
    P = kernels.ptr_array
    K_PROBE.launches += 1
    K_PROBE.call(
        "rw_hj_probe", len(key_cols), P(key_cols),
        P(other.key_table.keys),
        kernels.int_array(KEY_TYPE_CODES[k.dtype] for k in key_cols),
        kernels.ptr(other.key_table.occupied), other.key_capacity,
        kernels.ptr(other.head), kernels.ptr(other.next),
        kernels.ptr(other.live), kernels.ptr(active), kernels.ptr(ops), N,
        len(chunk_cols), P([c.data for c in chunk_cols]),
        P([c.valid for c in chunk_cols]), P([c.data for c in own_m]),
        P([c.valid for c in own_m]),
        kernels.int_array(c.data.element_size() for c in chunk_cols),
        len(other.rows), P(other.rows), P(other.valids),
        P([c.data for c in oth_m]), P([c.valid for c in oth_m]),
        kernels.int_array(r.element_size() for r in other.rows),
        M, kernels.ptr(ops_out), kernels.ptr(vis),
        kernels.ptr(bufs.get("cnt", N, i32)),
        kernels.ptr(bufs.get("start", N, i32)),
        kernels.ptr(bufs.get("sums64", nb + 1, torch.int64)),
        kernels.ptr(bufs.get("src", M, i32)),
        kernels.ptr(bufs.get("pos", M, i32)), kernels.ptr(errs),
        kernels.stream_of(active))
    return own_m, oth_m, ops_out, vis


# ------------------------------------------------------------------ K33

def delete_rows_plain(own: HashJoinSideState, pk_chunk, pk_idx, is_del,
                      slots, errs: torch.Tensor) -> None:
    """Plain PyTorch version of K33's delete entry, the reference's
    lock-step walk with its claim contest (hash_join.py:371-399): each
    effective delete tombstones the first live row of its key's chain
    whose pk equals its own (the lowest chunk row wins a contested row);
    `own`'s live and dirty change in place; misses add to errs[1]."""
    N = is_del.shape[0]
    CR = own.row_capacity
    dev = is_del.device
    row_ids = torch.arange(N, dtype=torch.int64, device=dev)
    sl = slots.to(torch.int64)
    dcur = torch.where(is_del & (sl >= 0),
                       own.head[sl.clamp(min=0)].to(torch.int64), -1)
    found = torch.zeros(N, dtype=torch.bool, device=dev)
    while bool((dcur >= 0).any()):
        cc = dcur.clamp(min=0)
        alive = (dcur >= 0) & own.live[cc]
        pkm = torch.ones(N, dtype=torch.bool, device=dev)
        for p, c in zip(pk_idx, pk_chunk):
            pkm &= own.rows[p][cc] == c.to(own.rows[p].dtype)
        cand = alive & pkm & ~found
        # the trash row CR takes the uncontested rows' claims
        claim = torch.full((CR + 1,), N, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(0, torch.where(cand, dcur, CR), row_ids,
                              "amin")
        win = cand & (claim[cc] == row_ids)
        own.live[dcur[win]] = False
        own.dirty[dcur[win]] = True
        found |= win
        dcur = torch.where(found | (dcur < 0), -1,
                           own.next[cc].to(torch.int64))
    errs[1] += (is_del & ~found).sum(dtype=torch.int32)


def delete_rows(own: HashJoinSideState, pk_chunk, pk_idx, is_del, slots,
                errs: torch.Tensor) -> None:
    """K33's delete entry on a CUDA device, the plain version on the CPU.
    Same contract as `delete_rows_plain`; on the card the first delete
    to claim a contested row wins it (netting leaves one delete per pk a
    chunk, so only duplicate stored pks can contend)."""
    dev = is_del.device
    if dev.type == "cpu":
        return delete_rows_plain(own, pk_chunk, pk_idx, is_del, slots, errs)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    N = is_del.shape[0]
    pk_store = [own.rows[p] for p in pk_idx]
    if not 1 <= len(pk_idx) <= MAX_PK:
        raise ValueError(f"K33 takes 1..{MAX_PK} pk columns")
    for c, s in zip(pk_chunk, pk_store):
        if c.dtype != s.dtype or c.dtype not in TYPE_CODES \
                or not c.is_contiguous() or c.shape[0] != N:
            raise ValueError("K33 pk columns must be contiguous, of the "
                             "store's dtypes")
    if is_del.dtype != torch.bool or slots.dtype != torch.int32 \
            or slots.shape[0] != N:
        raise ValueError("K33 takes a bool delete mask and int32 slots")
    if own.live.data_ptr() % 4:
        raise ValueError("K33 claims live bytes by their 32-bit words")
    K_UPDATE.launches += 1
    K_UPDATE.call(
        "rw_hj_delete", len(pk_idx), kernels.ptr_array(pk_chunk),
        kernels.ptr_array(pk_store),
        kernels.int_array(TYPE_CODES[c.dtype] for c in pk_chunk),
        kernels.ptr(is_del.contiguous()), kernels.ptr(slots), N,
        kernels.ptr(own.head), kernels.ptr(own.next), kernels.ptr(own.live),
        kernels.ptr(own.dirty), kernels.ptr(errs), kernels.stream_of(is_del))


def insert_rows_plain(own: HashJoinSideState, ins, slots, cols, valids,
                      dirty_vals=None, errs: Optional[torch.Tensor] = None,
                      live_val: bool = True) -> None:
    """Plain PyTorch version of K33's insert entry, the reference's
    `_bulk_insert` (hash_join.py:101): the rows of `ins` at top + rank
    in chunk order, with their valids (unless `valids` is None), live =
    live_val and dirty = dirty_vals (default set); with `slots` they are
    linked into their key chains (batch rows of one key chained in batch
    order, the key's head at the batch's last). Updates `own` in place;
    the overflow adds to errs[3] unless errs is None."""
    CK, CR = own.key_capacity, own.row_capacity
    dev = ins.device
    n_ins = int(ins.sum())
    top = int(own.top)
    new_ridx = top + torch.cumsum(ins.to(torch.int64), 0) - 1
    ok = ins & (new_ridx < CR)
    idx = new_ridx[ok]
    for r, d in zip(own.rows, cols):
        r[idx] = d[ok].to(r.dtype)
    if valids is not None:
        for v, m in zip(own.valids, valids):
            v[idx] = m[ok]
    own.live[idx] = live_val
    own.dirty[idx] = True if dirty_vals is None else dirty_vals[ok]
    if slots is not None:
        seg = torch.where(ok, slots.to(torch.int64), CK)
        order = torch.argsort(seg, stable=True)
        sseg, sridx = seg[order], new_ridx[order]
        no = torch.zeros(1, dtype=torch.bool, device=dev)
        prev_same = torch.cat([no, sseg[1:] == sseg[:-1]])
        prev_ridx = torch.cat([torch.zeros(1, dtype=torch.int64,
                                           device=dev), sridx[:-1]])
        old_head = own.head[sseg.clamp(0, CK - 1)].to(torch.int64)
        nxt_val = torch.where(prev_same, prev_ridx, old_head)
        s_ok = ok[order]
        own.next[sridx[s_ok]] = nxt_val[s_ok].to(torch.int32)
        is_last = torch.cat([sseg[:-1] != sseg[1:], ~no])
        lm = s_ok & is_last
        own.head[sseg[lm]] = sridx[lm].to(torch.int32)
    own.top.fill_(min(top + n_ins, CR))
    if errs is not None:
        errs[3] += max(top + n_ins - CR, 0)


def insert_rows(own: HashJoinSideState, ins, slots, cols, valids,
                dirty_vals=None, errs: Optional[torch.Tensor] = None,
                live_val: bool = True, bufs: Optional[_Buffers] = None
                ) -> None:
    """K33's insert entry on a CUDA device, the plain version on the CPU.
    Same contract as `insert_rows_plain`, except that on the card rows
    are pushed onto their chains' heads in any order (every row id is the
    reference's; only the order inside a chain may differ)."""
    dev = ins.device
    if dev.type == "cpu":
        return insert_rows_plain(own, ins, slots, cols, valids, dirty_vals,
                                 errs, live_val)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    N = ins.shape[0]
    _check_store_cols(cols, N, "K33")
    _check_store_cols(own.rows, own.row_capacity, "K33")
    for c, r in zip(cols, own.rows):
        if c.dtype != r.dtype:
            raise ValueError("K33 columns must have the store's dtypes")
    if ins.dtype != torch.bool or not ins.is_contiguous() or (
            slots is not None and (slots.dtype != torch.int32
                                   or slots.shape[0] != N)) or (
            dirty_vals is not None and dirty_vals.dtype != torch.bool):
        raise ValueError("K33 takes bool masks and int32 slots")
    if bufs is None:
        bufs = _Buffers(dev)
    sums = bufs.get("ins_sums", (N + 255) // 256 + 1, torch.int32)
    K_UPDATE.launches += 1
    K_UPDATE.call(
        "rw_hj_insert", kernels.ptr(ins), kernels.ptr_or_null(slots), N,
        len(cols), kernels.ptr_array(cols),
        kernels.ptr_array(valids if valids is not None
                          else [None] * len(cols)),
        kernels.int_array(c.element_size() for c in cols),
        int(valids is not None), int(live_val),
        kernels.ptr_or_null(dirty_vals), kernels.ptr_array(own.rows),
        kernels.ptr_array(own.valids), kernels.ptr(own.next),
        kernels.ptr(own.head), kernels.ptr(own.live),
        kernels.ptr(own.dirty), kernels.ptr(own.top), own.row_capacity,
        kernels.ptr(sums), kernels.ptr_or_null(errs),
        kernels.stream_of(ins))


# ------------------------------------------------------------------ K34

def pack_plain(side: HashJoinSideState, mode: int,
               clean_col: Optional[int] = None, wm=None):
    """Plain PyTorch version of K34's pack entry: the rows selected by
    `mode` (PACK_DIRTY: dirty; PACK_EVICT: live with column `clean_col`
    below `wm`; PACK_KEEP: live or dirty) in row order in the prefix
    [0, n) of (columns, valids, ops, live, dirty), and n (int32 device
    scalar). Past n the live and dirty outputs are False and the rest
    unspecified. ops is Insert for a live row, Delete for a dead one."""
    CR = side.row_capacity
    live, dirty = side.live, side.dirty
    if mode == PACK_DIRTY:
        mask = dirty
    elif mode == PACK_EVICT:
        mask = live & (side.rows[clean_col] < wm)
    elif mode == PACK_KEEP:
        mask = live | dirty
    else:
        raise ValueError(f"unknown pack mode {mode}")
    sel, n = compact_mask_plain(mask)
    act = torch.arange(CR, device=live.device) < n
    ops = torch.where(live[sel], OP_INSERT, OP_DELETE).to(torch.int8)
    return ([r[sel] for r in side.rows], [v[sel] for v in side.valids],
            ops, live[sel] & act, dirty[sel] & act, n.to(torch.int32))


def _wm_args(side: HashJoinSideState, clean_col, wm) -> tuple:
    if clean_col is None:
        return (None, 0, 0, 0.0)
    col = side.rows[clean_col]
    if col.dtype not in (torch.int64, torch.int32, torch.float64):
        raise ValueError("K34 cleans by an int64, int32 or float64 column")
    wm_i = int(wm) if col.dtype != torch.float64 else 0
    return (kernels.ptr(col), TYPE_CODES[col.dtype], wm_i, float(wm))


def pack(side: HashJoinSideState, mode: int, clean_col: Optional[int] = None,
         wm=None, bufs: Optional[_Buffers] = None):
    """K34's pack entry on a CUDA device, the plain version on the CPU.
    Same contract as `pack_plain`; the outputs are fresh tensors."""
    dev = side.device
    if dev.type == "cpu":
        return pack_plain(side, mode, clean_col, wm)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if mode not in (PACK_DIRTY, PACK_EVICT, PACK_KEEP) or (
            mode == PACK_EVICT and clean_col is None):
        raise ValueError(f"K34 pack mode {mode} needs its inputs")
    CR = side.row_capacity
    _check_store_cols(side.rows, CR, "K34")
    cols = [torch.empty(CR, dtype=r.dtype, device=dev) for r in side.rows]
    keep = mode == PACK_KEEP
    valids = ([torch.empty(CR, dtype=torch.bool, device=dev)
               for _ in side.rows] if keep else None)
    ops = (torch.empty(CR, dtype=torch.int8, device=dev)
           if mode == PACK_DIRTY else None)
    live = torch.empty(CR, dtype=torch.bool, device=dev) if keep else None
    dirty = torch.empty(CR, dtype=torch.bool, device=dev) if keep else None
    n = torch.empty((), dtype=torch.int32, device=dev)
    if bufs is None:
        bufs = _Buffers(dev)
    sums = bufs.get("pack_sums", (CR + 255) // 256 + 1, torch.int32)
    K_PACK.launches += 1
    K_PACK.call(
        "rw_hj_pack", mode, CR, kernels.ptr(side.live),
        kernels.ptr(side.dirty), *_wm_args(side, clean_col, wm),
        len(cols), kernels.ptr_array(side.rows),
        kernels.ptr_array(side.valids),
        kernels.int_array(r.element_size() for r in side.rows),
        kernels.ptr_array(cols),
        kernels.ptr_array(valids) if keep else None,
        kernels.ptr_or_null(ops), kernels.ptr_or_null(live),
        kernels.ptr_or_null(dirty), kernels.ptr(n), kernels.ptr(sums),
        kernels.stream_of(side.live))
    return cols, valids, ops, live, dirty, n


def evict_plain(side: HashJoinSideState, clean_col: int, wm) -> None:
    """Plain version of K34's evict entry (hash_join.py:_evict_impl):
    live rows below the watermark on `clean_col` are cleared, in place."""
    side.live &= ~(side.live & (side.rows[clean_col] < wm))


def evict(side: HashJoinSideState, clean_col: int, wm) -> None:
    """K34's evict entry on a CUDA device, the plain version on the CPU."""
    dev = side.device
    if dev.type == "cpu":
        return evict_plain(side, clean_col, wm)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    K_PACK.launches += 1
    K_PACK.call("rw_hj_evict", side.row_capacity, kernels.ptr(side.live),
                *_wm_args(side, clean_col, wm), kernels.stream_of(side.live))


def side_stats_plain(side: HashJoinSideState) -> torch.Tensor:
    """Plain version of K34's stats entry (hash_join.py:_stats_impl):
    int32 [occupied key slots, live rows, top]."""
    return torch.stack([side.key_table.occupied.sum(),
                        side.live.sum(),
                        side.top.to(torch.int64)]).to(torch.int32)


def side_stats(side: HashJoinSideState) -> torch.Tensor:
    """K34's stats entry on a CUDA device, the plain version on the CPU;
    the counts stay on the device."""
    dev = side.device
    if dev.type == "cpu":
        return side_stats_plain(side)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty(3, dtype=torch.int32, device=dev)
    K_PACK.launches += 1
    K_PACK.call("rw_hj_stats", side.key_capacity,
                kernels.ptr(side.key_table.occupied), side.row_capacity,
                kernels.ptr(side.live), kernels.ptr(side.top),
                kernels.ptr(out), kernels.stream_of(side.live))
    return out


def side_from_rows(cols: Sequence[torch.Tensor], key_idx: Sequence[int],
                   key_capacity: int, row_capacity: int
                   ) -> HashJoinSideState:
    """A side store holding the given rows (all valid, live and clean),
    keyed on columns `key_idx`: a starting state for kernel checks and
    measurements."""
    dev = cols[0].device
    side = empty_side(key_capacity, row_capacity,
                      [cols[i].dtype for i in key_idx],
                      [c.dtype for c in cols], dev)
    n = cols[0].shape[0]
    ins = torch.ones(n, dtype=torch.bool, device=dev)
    _, slots, _ = lookup_or_insert(side.key_table,
                                   [cols[i].contiguous() for i in key_idx],
                                   ins)
    insert_rows(side, ins, slots, [c.contiguous() for c in cols],
                [ins] * len(cols))
    side.dirty.zero_()
    return side


# ------------------------------------------------------------- executor

class HashJoinExecutor(Executor):
    """Inner equi-join over chained hash state. Output schema = left
    columns ++ right columns (optionally projected by output_indices);
    output pk = left pk ++ right pk (the columns the projection keeps).

    condition: an optional expression over the full (left ++ right) row,
    applied after the probe as `data & valid` (the reference's non-equi
    `cond`)."""

    def __init__(self, left: Executor, right: Executor,
                 left_key_indices: Sequence[int],
                 right_key_indices: Sequence[int],
                 left_pk_indices: Sequence[int],
                 right_pk_indices: Sequence[int],
                 key_capacity: int = 1 << 14,
                 row_capacity: int = 1 << 16,
                 match_factor: int = 2,
                 condition=None,
                 output_indices: Optional[Sequence[int]] = None,
                 state_tables: Optional[tuple] = None,
                 clean_watermark_cols: tuple = (None, None),
                 watchdog_interval: Optional[int] = 1,
                 device="cuda"):
        self.device = resolve_device(device)
        self.inputs = (left, right)
        self.key_indices = (tuple(left_key_indices), tuple(right_key_indices))
        self.pk_indices_side = (tuple(left_pk_indices),
                                tuple(right_pk_indices))
        if len(self.key_indices[0]) != len(self.key_indices[1]):
            raise ValueError("join key arity differs between the sides")
        lt, rt = left.schema, right.schema
        for li, ri in zip(*self.key_indices):
            if lt[li].data_type.np_dtype != rt[ri].data_type.np_dtype:
                raise ValueError(f"join key dtype mismatch {lt[li]} vs "
                                 f"{rt[ri]}")
        self._key_dtypes = tuple(lt[i].data_type.torch_dtype
                                 for i in self.key_indices[0])
        if any(dt not in KEY_TYPE_CODES for dt in self._key_dtypes):
            raise ValueError("hash join keys must be int64, int32 or "
                             "float64")
        if not all(1 <= len(p) <= MAX_PK for p in self.pk_indices_side):
            raise ValueError(f"the hash join takes 1..{MAX_PK} pk columns "
                             "a side")
        self._col_dtypes = (tuple(f.data_type.torch_dtype for f in lt),
                            tuple(f.data_type.torch_dtype for f in rt))
        lnames, rnames = {f.name for f in lt}, {f.name for f in rt}
        full_fields = [Field(f"l_{f.name}" if f.name in rnames else f.name,
                             f.data_type, f.scale) for f in lt]
        full_fields += [Field(f"r_{f.name}" if f.name in lnames else f.name,
                              f.data_type, f.scale) for f in rt]
        self.output_indices = (tuple(output_indices)
                               if output_indices is not None
                               else tuple(range(len(full_fields))))
        self.schema = Schema(tuple(full_fields[i]
                                   for i in self.output_indices))
        out_pk_full = (tuple(self.pk_indices_side[0])
                       + tuple(len(lt) + i for i in self.pk_indices_side[1]))
        self.pk_indices = tuple(self.output_indices.index(i)
                                for i in out_pk_full
                                if i in self.output_indices)
        self.key_capacity = [key_capacity, key_capacity]
        self.row_capacity = [row_capacity, row_capacity]
        self.match_factor = match_factor
        self.condition = condition
        self._cond = None if condition is None else ExprProgram([condition])
        self.state_tables = (tuple(state_tables) if state_tables
                             else (None, None))
        self.clean_cols = tuple(clean_watermark_cols)
        self._pending_clean: list = [None, None]
        self.identity = (f"HashJoin(l={self.key_indices[0]}, "
                         f"r={self.key_indices[1]})")
        self.sides = [self._empty(s) for s in (LEFT, RIGHT)]
        self._bufs = [_Buffers(self.device), _Buffers(self.device)]
        self.rebuilds = 0
        self.persist_rows = 0        # rows the persists wrote
        if watchdog_interval not in (None, 1):
            raise ValueError(
                "watchdog_interval must be 1 or None (a lagged check would "
                "let checkpoints commit unverified state)")
        self.watchdog_interval = watchdog_interval
        self._dirty_since_flush = [False, False]
        # device error accumulator [unresolved keys, delete misses, match
        # overflow, row overflow] and each side's load after its last
        # apply [occupied slots, live rows, top]: fetched once a barrier
        self._errs_dev = torch.zeros(4, dtype=torch.int32, device=self.device)
        self._stats_dev = [torch.zeros(3, dtype=torch.int32,
                                       device=self.device) for _ in (0, 1)]
        self._occ_known = [0, 0]
        self._top_known = [0, 0]
        self._key_wms: list[dict[int, int]] = [{}, {}]
        self._emitted_key_wm: dict[int, int] = {}

    def fence_tokens(self) -> list:
        return [s.top for s in self.sides]

    def _empty(self, side: int) -> HashJoinSideState:
        return empty_side(self.key_capacity[side], self.row_capacity[side],
                          self._key_dtypes, self._col_dtypes[side],
                          self.device)

    def errs(self) -> list[int]:
        """[unresolved keys, delete misses, match overflow, row overflow]
        (one fetch)."""
        return [int(x) for x in self._errs_dev.cpu()]

    def state_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for s in self.sides for t in s.tensors())

    # ------------------------------------------------------------- apply
    def _apply(self, side: int, chunk: StreamChunk):
        """Probe the other side, emit its matches, update this side.
        Returns the output's full (left ++ right) columns, ops and
        visibility, the condition applied."""
        key_idx = self.key_indices[side]
        pk_idx = self.pk_indices_side[side]
        own, other = self.sides[side], self.sides[1 - side]
        M = self.match_factor * chunk.capacity
        bufs = self._bufs[side]
        key_cols = [chunk.columns[i].data for i in key_idx]
        active = chunk.vis
        for i in key_idx:          # NULL keys never join
            if chunk.columns[i].valid is not None:
                active = active & chunk.columns[i].valid
        _, is_ins, is_del, _ = net_pk_runs(chunk, active, pk_idx, bufs)
        own_m, oth_m, ops, vis = probe(other, key_cols, active,
                                       chunk.columns, chunk.ops, M,
                                       self._errs_dev, bufs)
        # own side: deletes before inserts (an update pair retracts the
        # old row before the new one lands)
        _, slots, n_un = lookup_or_insert(own.key_table, key_cols, active)
        self._errs_dev[0] += n_un
        delete_rows(own, [chunk.columns[p].data for p in pk_idx], pk_idx,
                    is_del, slots, self._errs_dev)
        insert_rows(own, is_ins, slots, [c.data for c in chunk.columns],
                    [c.valid_mask() for c in chunk.columns],
                    errs=self._errs_dev, bufs=bufs)
        cols = own_m + oth_m if side == LEFT else oth_m + own_m
        if self._cond is not None:
            self._cond.and_into(cols, vis, low_bit=True)
        return cols, ops, vis

    # ------------------------------------------------------- persistence
    def _persist(self, barrier: Barrier) -> None:
        """Write each durable side's dirty rows (Insert if live, Delete if
        dead, in row order) and the rows below its pending cleaning
        watermark (Deletes), then commit. Two fetches: the counts, then
        every side's packed prefixes."""
        jobs = []          # (side, table, dirty pack | None, evict pack)
        for s in (LEFT, RIGHT):
            st = self.state_tables[s]
            if st is None:
                continue
            dirty = None
            if self._dirty_since_flush[s]:
                cols, _, ops, _, _, n = pack(self.sides[s], PACK_DIRTY,
                                             bufs=self._bufs[s])
                dirty = (cols, ops, n)
                self.sides[s].dirty.zero_()
                self._dirty_since_flush[s] = False
            ev = None
            if self._pending_clean[s] is not None \
                    and self.clean_cols[s] is not None:
                cols, _, _, _, _, n = pack(self.sides[s], PACK_EVICT,
                                           self.clean_cols[s],
                                           self._pending_clean[s],
                                           bufs=self._bufs[s])
                ev = (cols, n)
            jobs.append((s, st, dirty, ev))
        if not jobs:
            return
        counts = [x[-1] for _, _, d, e in jobs for x in (d, e)
                  if x is not None]
        ns = [int(v) for v in PendingFetch(torch.stack(counts)).wait()] \
            if counts else []
        parts, plan, ci = [], [], 0
        for s, st, dirty, ev in jobs:
            nd = ne = 0
            if dirty is not None:
                nd = ns[ci]
                ci += 1
                if nd:
                    cols, ops, _ = dirty
                    parts.append(pack_rows([ops[:nd]]
                                           + [c[:nd] for c in cols]))
            if ev is not None:
                ne = ns[ci]
                ci += 1
                if ne:
                    parts.append(pack_rows([c[:ne] for c in ev[0]]))
            plan.append((s, st, nd, ne))
        host = PendingFetch(torch.cat(parts)).wait() if parts else None
        at = 0
        for s, st, nd, ne in plan:
            dts = [np.dtype(f.data_type.np_dtype)
                   for f in self.inputs[s].schema]
            if nd:
                k = len(dts) + 1
                vals = unpack_rows(host[at:at + nd * k], nd,
                                   [np.int8] + dts)
                at += nd * k
                st.write_chunk_columns(vals[0], vals[1:],
                                       np.ones(nd, dtype=bool))
            if ne:
                vals = unpack_rows(host[at:at + ne * len(dts)], ne, dts)
                at += ne * len(dts)
                st.write_chunk_columns(np.full(ne, OP_DELETE, dtype=np.int8),
                                       vals, np.ones(ne, dtype=bool))
            self.persist_rows += nd + ne
            st.commit(barrier.epoch.curr)

    def recover(self) -> None:
        """Rebuild each durable side from its state table: capacities
        sized by the reference's rule, the stored rows applied as one
        all-Insert chunk (probing the other side as the reference does;
        the output is discarded), then marked clean."""
        for s in (LEFT, RIGHT):
            st = self.state_tables[s]
            if st is None:
                continue
            rows = [r for _, r in st.iter_all()]
            if not rows:
                continue
            n = len(rows)
            grown = 1 << int(n / 0.7).bit_length()
            self.row_capacity[s] = max(self.row_capacity[s], grown)
            self.key_capacity[s] = max(self.key_capacity[s], grown)
            self.sides[s] = self._empty(s)
            cap = 1 << max(1, (n - 1).bit_length())
            sch = self.inputs[s].schema
            cols = []
            for k, f in enumerate(sch):
                a = np.zeros(cap, dtype=f.data_type.np_dtype)
                a[:n] = [r[k] for r in rows]
                cols.append(Column(torch.from_numpy(a).to(self.device)))
            chunk = StreamChunk(
                tuple(cols),
                torch.zeros(cap, dtype=torch.int8, device=self.device),
                torch.arange(cap, device=self.device) < n, sch)
            self._apply(s, chunk)
            # the recovered rows are already durable
            self.sides[s].dirty.zero_()

    # ---------------------------------------------------------- rebuild
    def _rehash(self, s: int, new_ck: int, new_cr: int) -> None:
        """Compact the live (and dirty dead) rows into a fresh side of
        the given capacities (zombie purge / growth): live rows first, in
        row order and linked; dirty dead rows after them, unlinked, so
        the next persist still writes their deletes."""
        old = self.sides[s]
        bufs = self._bufs[s]
        cols, valids, _, live, dirty, _ = pack(old, PACK_KEEP, bufs=bufs)
        fresh = empty_side(new_ck, new_cr, self._key_dtypes,
                           self._col_dtypes[s], self.device)
        _, slots, _ = lookup_or_insert(
            fresh.key_table, [cols[i] for i in self.key_indices[s]], live)
        insert_rows(fresh, live, slots, cols, valids, dirty_vals=dirty,
                    bufs=bufs)
        insert_rows(fresh, ~live & dirty, None, cols, None, live_val=False,
                    bufs=bufs)
        self.sides[s] = fresh

    def _maybe_rebuild(self) -> None:
        for s in (LEFT, RIGHT):
            ck, cr = self.key_capacity[s], self.row_capacity[s]
            # the watchdog's load counts gate the exact (blocking) stats
            if self._occ_known[s] <= 0.7 * ck \
                    and self._top_known[s] <= 0.7 * cr:
                continue
            occ, live, top = (int(x) for x in
                              side_stats(self.sides[s]).cpu())
            if occ <= 0.7 * ck and top <= 0.7 * cr:
                continue
            new_ck = ck * 2 if occ > 0.35 * ck else ck
            new_cr = cr * 2 if live > 0.35 * cr else cr
            self._rehash(s, new_ck, new_cr)
            self.key_capacity[s], self.row_capacity[s] = new_ck, new_cr
            self.rebuilds += 1
            occ2, _, top2 = (int(x) for x in side_stats(self.sides[s]).cpu())
            self._occ_known[s], self._top_known[s] = occ2, top2

    # --------------------------------------------------------- watchdog
    def _check_watchdog(self) -> None:
        """One fetch of the error counts and both sides' load (per
        barrier, never per chunk); errors fail-stop before this epoch's
        checkpoint commits."""
        vals = torch.cat([self._errs_dev, *self._stats_dev]).cpu()
        n_un, n_miss, n_mo, n_ro = (int(x) for x in vals[:4])
        for s in (LEFT, RIGHT):
            self._occ_known[s] = int(vals[4 + 3 * s])
            self._top_known[s] = int(vals[6 + 3 * s])
        if n_un:
            raise RuntimeError(
                f"join key-table overflow ({n_un} keys unresolved)")
        if n_mo:
            raise RuntimeError(
                f"join match-buffer overflow ({n_mo} matches dropped; "
                f"raise match_factor)")
        if n_ro:
            raise RuntimeError(
                f"join row-store overflow ({n_ro} rows dropped)")
        if n_miss:
            raise RuntimeError(
                f"join changelog inconsistency: {n_miss} deletes matched "
                f"no stored row")

    # ----------------------------------------------------------- stream
    async def execute(self):
        first = True
        async for kind, s, msg in barrier_align(*self.inputs):
            if kind == "chunk":
                cols, ops, vis = self._apply(s, msg)
                self._stats_dev[s] = side_stats(self.sides[s])
                self._dirty_since_flush[s] = True
                yield StreamChunk(tuple(cols[i] for i in self.output_indices),
                                  ops, vis, self.schema)
            elif kind == "barrier":
                barrier: Barrier = msg
                if first or barrier.kind is BarrierKind.INITIAL:
                    first = False
                    for st in self.state_tables:
                        if st is not None:
                            st.init_epoch(barrier.epoch.curr)
                    self.recover()
                    yield barrier
                    continue
                stopping = (barrier.mutation is not None
                            and barrier.is_stop_any())
                if self.watchdog_interval and (
                        stopping or any(self._dirty_since_flush)):
                    self._check_watchdog()
                self._persist(barrier)
                for s2 in (LEFT, RIGHT):
                    if (self._pending_clean[s2] is not None
                            and self.clean_cols[s2] is not None):
                        evict(self.sides[s2], self.clean_cols[s2],
                              self._pending_clean[s2])
                        self._pending_clean[s2] = None
                        if self.watchdog_interval is None:
                            # transfer-free mode never reads the load
                            # counts: reclaim the tombstones with a
                            # same-capacity rehash
                            self._rehash(s2, self.key_capacity[s2],
                                         self.row_capacity[s2])
                self._maybe_rebuild()
                yield barrier
            else:
                wm: Watermark = msg
                if self.clean_cols[s] is not None \
                        and wm.col_idx == self.clean_cols[s]:
                    self._pending_clean[s] = wm.val
                # key-column watermarks: the min over both sides on both
                # output key positions
                if wm.col_idx in self.key_indices[s]:
                    kpos = self.key_indices[s].index(wm.col_idx)
                    self._key_wms[s][kpos] = wm.val
                    other_wm = self._key_wms[1 - s].get(kpos)
                    if other_wm is not None:
                        val = min(wm.val, other_wm)
                        if self._emitted_key_wm.get(kpos) != val:
                            self._emitted_key_wm[kpos] = val
                            n_left = len(self.inputs[LEFT].schema)
                            for full_idx in (
                                    self.key_indices[LEFT][kpos],
                                    n_left + self.key_indices[RIGHT][kpos]):
                                if full_idx in self.output_indices:
                                    yield Watermark(
                                        self.output_indices.index(full_idx),
                                        wm.data_type, val)
