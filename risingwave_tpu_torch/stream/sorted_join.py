"""Sorted-merge streaming join: inner, LEFT, RIGHT and FULL outer, and
temporal joins (port of risingwave_tpu/stream/sorted_join.py).

Semantics match the reference's two-sided streaming equi-join: a chunk
from one side probes the OTHER side's stored rows and emits joined
changelog rows, then updates its OWN store (update pairs degrade to
Delete/Insert, NULL keys never match).

Each side's state is a dense struct-of-arrays sorted by a 63-bit hash of
the join key: rows [0, n) ascending, the int64-max sentinel beyond
(exact key equality is re-checked on every candidate, so a hash
collision only costs a compare). One chunk's apply is:

  netting   within-chunk pk runs of a retracting side are netted to one
            delete and one insert per pk (a stable lexsort: passes of
            kernel K11, ops/sort.py; then kernel K19, `csrc/pk_net.cu`,
            the run flags, which the sorted store shares);
  probe     kernel K6 (`csrc/sorted_join_probe.cu`): key hash, the
            contiguous hash range of each row in the other side, int64
            offsets, expansion into a fixed [M] match buffer (M =
            match_factor x chunk rows), exact key recheck, the gather of
            both sides' columns;
  condition kernel K5 AND-s the non-equi condition into the emit mask;
  outer     kernel K28 (`csrc/outer_join.cu`), outer joins only: each
            chunk row's count of condition-passing matches, the signed
            degree delta onto the other side's rows, the NET 0 <-> >0
            transitions of those rows (their NULL-padded rows retracted
            or re-emitted) and this side's unmatched rows, NULL keys
            included, NULL-padded: the output grows to [M matches | M
            transitions | N own rows] (the reference's managed_state/
            join/mod.rs:252-261 degree design);
  sort      the new rows by hash (kernel K11, `csrc/radix_sort.cu`, a
            stable radix sort over the hash's 63 bits);
  merge     kernel K7 (`csrc/sorted_join_merge.cu`): retraction victims,
            inline watermark eviction, and the merge of the kept rows
            with the new rows (an outer join's new rows take their match
            count as degree) into the side's second store, which is then
            swapped in. Barrier-time eviction of an idle side is the same
            kernel with no new rows.

A temporal join (FOR SYSTEM_TIME AS OF PROCTIME(), inner or left; the
reference's temporal_join.rs) is the same executor: the right side is a
table whose updates maintain its state and the degrees they scatter onto
left rows, but emit nothing. Outer joins refuse watermark state
cleaning: an evicted row could not retract its matches' degrees.

Errors accumulate on the device in `errs` [match overflow (transitions
past their buffer included), delete miss, row overflow] and are read
only by the watchdog (or by a caller).

Durable state (one state table a side): at every barrier a side that
changed is diffed against a device copy of itself as of the last
checkpoint (kernel K17, `csrc/snapshot_diff.cu`: row hashes, two K11
sorts, an exact compare against the first candidate, a compaction
straight into one packed int64 buffer), the counts and then the packed
rows are fetched, and deletes then inserts are written to the side's
state table. Degrees are not persisted: recovery replays the stored
RIGHT rows, then the LEFT rows, through the apply (K6, K28, K7) with a
generous match buffer, which rebuilds both sides' degrees.

On a CUDA device the probe scratch, the second stores and the kernels'
scratch are allocated once per side and reused: an output chunk's
tensors are valid until this side's next apply, so a consumer that
keeps rows past that copies them (the device sinks reduce or copy at
once). On the CPU every apply allocates, as the reference does.

Left out of this slice (ROADMAP Queue A, A7): the memory manager
(spill/reload; the reference refuses it for outer joins too), capacity
growth (`_maybe_grow`; `grow_sorted_arrays` serves the sorted store of
the top-N and the dynamic filter) and the sharded subclass.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

import numpy as np

from ..common.chunk import (
    Column, StreamChunk, OP_DELETE, OP_INSERT, op_sign,
)
from ..common.types import Field, Schema
from ..device import resolve_device
from ..expr.program import TYPE_CODES, ExprProgram
from ..ops import kernels
from ..ops.sort import lexsort_plain, stable_lexsort, stable_sort
from ..ops.hashing import key_hash as _chain_hash, srl
from ..utils.d2h import PendingFetch, as_i64_lanes, pack_rows, unpack_rows
from .align import LEFT, RIGHT, barrier_align
from .executor import Executor
from .message import Barrier, BarrierKind, Watermark

# khash padding beyond the live prefix: int64 max keeps searchsorted
# ranges inside [0, n)
HSENTINEL = (1 << 63) - 1
# key hashes and the sentinel lie in [0, 2^63): the sort's key bits
HASH_BITS = 63
# "no watermark yet" eviction threshold, below any real event time
NO_WATERMARK = -(1 << 62)
MAX_KEYS, MAX_COLS, MAX_MATCH = 4, 8, 8   # csrc/sorted_join_*.cu
# columns of a store that K7 merges (csrc/sorted_join_merge.cu) and that
# K29 and K21's diff read (csrc/dynamic_filter.cu, csrc/set_diff.cuh)
MAX_STORE_COLS = 16

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_PP = ctypes.POINTER(_P)
_PI = ctypes.POINTER(_I)

# K6. Replaces stream/sorted_join.py:key_hash (102) and _apply_impl's
# probe and match expansion (409-447).
K_PROBE = kernels.register(kernels.CudaKernel(
    "sorted_join_probe",
    replaces="risingwave_tpu/stream/sorted_join.py:409",
    functions={"rw_sj_probe": [
        _I, _PP, _PP, _PI, _P, _P, _P, _L, _P, _P, _L,
        _I, _PP, _PP, _PP, _PP, _PI, _I, _PP, _PP, _PP, _PP, _PI,
        _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P]}))

# K7. Replaces stream/sorted_join.py:_apply_impl's side update (535-612)
# and _evict_impl (615).
K_MERGE = kernels.register(kernels.CudaKernel(
    "sorted_join_merge",
    replaces="risingwave_tpu/stream/sorted_join.py:535",
    functions={"rw_sj_merge": [
        _P, _I, _PP, _PP, _PI, _P, _P, _L, _P, _PP, _PP, _P, _P, _I, _L,
        _L, _P, _P, _P, _PP, _PP, _P, _P, _L, _I, _PI,
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P]}))

# K28. Replaces stream/sorted_join.py:_apply_impl's outer half (443-533).
K_OUTER = kernels.register(kernels.CudaKernel(
    "outer_join",
    replaces="risingwave_tpu/stream/sorted_join.py:443",
    functions={"rw_oj_apply": [
        _L, _L, _L, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _PP, _PP, _PP, _PP, _PI, _I, _PP, _PP, _PP, _PP, _PI,
        _P, _P, _P, _P, _P, _P, _P, _P]}))


# K17. Replaces stream/sorted_join.py:_diff_impl (655) with _row_lanes
# (643) and key_hash (102).
K_DIFF = kernels.register(kernels.CudaKernel(
    "snapshot_diff",
    replaces="risingwave_tpu/stream/sorted_join.py:655",
    functions={
        "rw_diff_rowhash": [_P, _I, _PP, _PP, _PI, _P, _L, _P, _P],
        "rw_diff_compact": [_P, _PP, _PP, _P, _L, _P, _PP, _PP, _P, _L, _I,
                            _PI, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _P],
        "rw_diff_sums": [_L, _L]}))

# K19. Replaces stream/sorted_store.py:sorted_store_apply's chunk side
# (38-62) and the same netting in stream/sorted_join.py:_apply_impl
# (386-406).
K_NET = kernels.register(kernels.CudaKernel(
    "pk_net",
    replaces="risingwave_tpu/stream/sorted_store.py:28",
    functions={"rw_pk_net": [_I, _PP, _PI, _P, _P, _P, _L, _P, _P, _P, _P,
                             _P]}))


def key_hash(key_cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """63-bit nonnegative hash of the composite key (splitmix64 chain)."""
    return srl(_chain_hash(key_cols), 1)


@dataclass
class SortedSideState:
    """One side's store: dense prefix [0, n), ascending by khash."""

    khash: torch.Tensor                 # int64 [C], sentinel beyond n
    cols: tuple[torch.Tensor, ...]      # per input column [C]
    valids: tuple[torch.Tensor, ...]    # per input column bool [C]
    degree: torch.Tensor                # int32 [C]
    n: torch.Tensor                     # int32 scalar — live rows

    @property
    def capacity(self) -> int:
        return self.khash.shape[0]


def empty_sorted_side(capacity: int, col_dtypes: Sequence[torch.dtype],
                      device) -> SortedSideState:
    return SortedSideState(
        khash=torch.full((capacity,), HSENTINEL, dtype=torch.int64,
                         device=device),
        cols=tuple(torch.zeros(capacity, dtype=dt, device=device)
                   for dt in col_dtypes),
        valids=tuple(torch.zeros(capacity, dtype=torch.bool, device=device)
                     for _ in col_dtypes),
        degree=torch.zeros(capacity, dtype=torch.int32, device=device),
        n=torch.zeros((), dtype=torch.int32, device=device))


def grow_sorted_arrays(khash: torch.Tensor, cols: Sequence[torch.Tensor],
                       valids: Sequence[torch.Tensor], new_capacity: int):
    """A sorted dense store reallocated at a larger capacity: the live
    prefix unchanged, the padding the hash sentinel and zeros."""
    pad = new_capacity - khash.shape[0]
    if pad <= 0:
        raise ValueError(f"cannot grow {khash.shape[0]} slots to "
                         f"{new_capacity}")
    kh = torch.cat([khash, torch.full((pad,), HSENTINEL, dtype=khash.dtype,
                                      device=khash.device)])
    cols2 = tuple(torch.cat([c, torch.zeros(pad, dtype=c.dtype,
                                            device=c.device)])
                  for c in cols)
    valids2 = tuple(torch.cat([v, torch.zeros(pad, dtype=torch.bool,
                                              device=v.device)])
                    for v in valids)
    return kh, cols2, valids2


def _count_le(sorted_arr: torch.Tensor, dead_cum: torch.Tensor,
              vals: torch.Tensor, side: str) -> torch.Tensor:
    """Count of LIVE entries of `sorted_arr` </<= vals, where `dead_cum`
    is the inclusive prefix sum of the dead mask over the same array."""
    idx = torch.searchsorted(sorted_arr, vals, side=side)
    dead_before = torch.where(idx > 0, dead_cum[(idx - 1).clamp(min=0)], 0)
    return idx - dead_before


def _expand(offs: torch.Tensor, lo: torch.Tensor, M: int, cap: int):
    """Match slot j -> (source row, position in the searched side) for
    j < M, from inclusive int64 offsets: the reference's locating
    searchsorted."""
    N = offs.shape[0]
    j = torch.arange(M, dtype=torch.int64, device=offs.device)
    src = torch.searchsorted(offs, j, side="right")
    srcc = src.clamp(0, N - 1)
    prev = torch.where(srcc > 0, offs[(srcc - 1).clamp(min=0)], 0)
    pos = (lo[srcc] + (j - prev)).clamp(0, cap - 1)
    return j, srcc, pos


class _Buffers:
    """Tensors a side's kernels reuse from one apply to the next."""

    def __init__(self, device: torch.device):
        self.device = device
        self._t: dict = {}

    def get(self, name, n: int, dtype: torch.dtype) -> torch.Tensor:
        t = self._t.get(name)
        if t is None or t.shape[0] < n or t.dtype != dtype:
            t = self._t[name] = torch.empty(max(n, 1), dtype=dtype,
                                            device=self.device)
        return t if t.shape[0] == n else t[:n]


def net_pk_runs_plain(chunk: StreamChunk, active: torch.Tensor,
                      pk_idx: Sequence[int],
                      order: Optional[torch.Tensor] = None):
    """Plain PyTorch version of `net_pk_runs` (with torch's lexsort
    unless `order` is given)."""
    N = chunk.capacity
    dev = active.device
    if order is None:
        order = lexsort_plain(_net_keys(chunk, active, pk_idx))
    s_act = active[order]
    same = s_act[1:] & s_act[:-1]
    for p in pk_idx:
        d = chunk.columns[p].data[order]
        same = same & (d[1:] == d[:-1])
    one = torch.ones(1, dtype=torch.bool, device=dev)
    run_start = torch.cat([one, ~same])
    run_end = torch.cat([~same, one])
    s_signs = op_sign(chunk.ops)[order]
    is_del = torch.empty(N, dtype=torch.bool, device=dev)
    is_ins = torch.empty(N, dtype=torch.bool, device=dev)
    is_del[order] = run_start & (s_signs < 0) & s_act
    is_ins[order] = run_end & (s_signs > 0) & s_act
    h = key_hash([chunk.columns[p].data for p in pk_idx])
    return h, is_ins, is_del, torch.where(is_ins, h, HSENTINEL)


def _net_keys(chunk: StreamChunk, active: torch.Tensor,
              pk_idx: Sequence[int]) -> list[torch.Tensor]:
    """The netting lexsort's keys: the pk columns, then inactive rows
    last. The reference's first key, the row index, is the order every
    stable pass keeps anyway, so it is left out."""
    return [chunk.columns[p].data for p in pk_idx] \
        + [(~active).to(torch.uint8)]


def net_pk_runs(chunk: StreamChunk, active: torch.Tensor,
                pk_idx: Sequence[int], bufs: Optional[_Buffers] = None,
                order: Optional[torch.Tensor] = None):
    """Within-chunk pk-run netting of a retracting input: rows grouped by
    pk (a stable lexsort: K11 passes, unless `order` gives it); per run
    the first delete and the last insert survive. Returns (h, is_ins,
    is_del, ins_h): the pk hash of every row, the netted flags, and h
    where is_ins else the sentinel. Kernel K19 on a CUDA device (the
    outputs live in `bufs` until its next use), the plain version on the
    CPU."""
    dev = active.device
    if dev.type == "cpu":
        return net_pk_runs_plain(chunk, active, pk_idx, order)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    N = chunk.capacity
    if not 1 <= len(pk_idx) <= MAX_KEYS:
        raise ValueError(f"K19 takes 1..{MAX_KEYS} pk columns")
    if order is None:
        keys = _net_keys(chunk, active, pk_idx)
        order = stable_lexsort(keys, [64] * len(pk_idx) + [1])
    if order.dtype != torch.int64 or order.shape != (N,):
        raise ValueError("K19 takes the chunk's int64 sort order")
    if chunk.ops.dtype != torch.int8 or active.dtype != torch.bool:
        raise ValueError("K19 takes int8 ops and a bool activity mask")
    pk_cols = [chunk.columns[p].data.contiguous() for p in pk_idx]
    ops, active, order = (t.contiguous() for t in (chunk.ops, active,
                                                    order))
    if bufs is None:
        bufs = _Buffers(dev)
    h = bufs.get("net_h", N, torch.int64)
    ins_h = bufs.get("net_ins_h", N, torch.int64)
    is_del = bufs.get("net_del", N, torch.bool)
    is_ins = bufs.get("net_ins", N, torch.bool)
    K_NET.launches += 1
    K_NET.call("rw_pk_net", len(pk_cols), kernels.ptr_array(pk_cols),
               kernels.int_array(TYPE_CODES[c.dtype] for c in pk_cols),
               kernels.ptr(order), kernels.ptr(active), kernels.ptr(ops), N,
               kernels.ptr(h), kernels.ptr(is_del), kernels.ptr(is_ins),
               kernels.ptr(ins_h), kernels.stream_of(ops))
    return h, is_ins, is_del, ins_h


def store_from_rows(cols: Sequence[torch.Tensor],
                    capacity: int) -> SortedSideState:
    """A side store holding the given rows (all valid), keyed on column
    0 alone — a starting state for kernel checks and measurements."""
    dev = cols[0].device
    empty = empty_sorted_side(capacity, [c.dtype for c in cols], dev)
    n = cols[0].shape[0]
    nh, iorder = stable_sort(key_hash([cols[0]]), HASH_BITS)
    errs = torch.zeros(3, dtype=torch.int32, device=dev)
    return merge_plain(empty, nh, iorder,
                       torch.tensor(n, dtype=torch.int32, device=dev),
                       [Column(c) for c in cols], None, None, 1, (),
                       None, NO_WATERMARK, errs)


# ------------------------------------------------------------------ K6

def probe_plain(key_cols, active, is_ins, ops, other: SortedSideState,
                other_key_idx, own_cols: Sequence[Column], M: int,
                errs: torch.Tensor, bufs=None):
    """Plain PyTorch version of kernel K6. Returns (h, ins_h, own match
    columns, other match columns, ops, emit, src, pos): src and pos are
    each match slot's chunk row and other-side row (int64). Adds the
    match overflow to errs[0] in place."""
    N = active.shape[0]
    Co = other.capacity
    h = key_hash(key_cols)
    ins_h = torch.where(is_ins, h, HSENTINEL)
    lo = torch.searchsorted(other.khash, h, side="left")
    hi = torch.searchsorted(other.khash, h, side="right")
    # int64 offsets: a hot key can own more than 2^31 matches
    offs = torch.cumsum(torch.where(active, hi - lo, 0), 0)
    total = offs[N - 1]
    j, srcc, pos = _expand(offs, lo, M, Co)
    emit = (j < torch.clamp(total, max=M)) & (pos < other.n)
    for kc, oi in zip(key_cols, other_key_idx):
        oc = other.cols[oi]
        emit &= oc[pos] == kc[srcc].to(oc.dtype)
    errs[0] += torch.clamp(total - M, min=0).to(torch.int32)
    own_m = [Column(c.data[srcc], None if c.valid is None else c.valid[srcc])
             for c in own_cols]
    oth_m = [Column(r[pos], v[pos]) for r, v in zip(other.cols, other.valids)]
    ops_out = torch.where(op_sign(ops)[srcc] > 0, OP_INSERT,
                          OP_DELETE).to(torch.int8)
    return h, ins_h, own_m, oth_m, ops_out, emit, srcc, pos


def probe(key_cols, active, is_ins, ops, other: SortedSideState,
          other_key_idx, own_cols: Sequence[Column], M: int,
          errs: torch.Tensor, bufs: Optional[_Buffers] = None,
          rows: Optional[int] = None, slots: bool = False):
    """Kernel K6 on a CUDA device, the plain version on the CPU. Same
    contract as `probe_plain`, except: the match columns, ops and emit
    have `rows` (>= M, default M) rows, of which K6 writes the first M
    (an outer join's K28 writes the rest), every column has a valid mask
    when rows > M, and src and pos (int32, in `bufs`) are written only
    with `slots` (else None). The per-row scratch (h, ins_h, lo, offs)
    lives in `bufs` and is valid until the side's next apply; the match
    buffer is allocated fresh on every call, because it leaves the join
    as an output chunk and a downstream channel may still hold it when
    the next apply runs."""
    dev = active.device
    if dev.type == "cpu":
        return probe_plain(key_cols, active, is_ins, ops, other,
                           other_key_idx, own_cols, M, errs)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    N = active.shape[0]
    T = M if rows is None else rows
    if T < M:
        raise ValueError("K6's output rows hold at least its M slots")
    other_keys = [other.cols[oi] for oi in other_key_idx]
    if not 1 <= len(key_cols) <= MAX_KEYS or len(own_cols) > MAX_COLS \
            or len(other.cols) > MAX_COLS:
        raise ValueError(f"K6 takes 1..{MAX_KEYS} keys and at most "
                         f"{MAX_COLS} columns a side")
    for kc, oc in zip(key_cols, other_keys):
        if kc.dtype != oc.dtype or not kc.is_contiguous() \
                or kc.shape[0] != N:
            raise ValueError("K6 key columns must be contiguous, of the "
                             "other side's key dtypes")
    for t in (active, is_ins, ops):
        if t.shape[0] != N or not t.is_contiguous() or t.device != dev:
            raise ValueError("K6 row inputs must be contiguous, of the "
                             "chunk's length, on its device")
    for c in own_cols:
        if not c.data.is_contiguous() or c.data.shape[0] != N:
            raise ValueError("K6 chunk columns must be contiguous")
    if bufs is None:
        bufs = _Buffers(dev)
    i64 = torch.int64
    h = bufs.get("h", N, i64)
    ins_h = bufs.get("ins_h", N, i64)
    lo = bufs.get("lo", N, i64)
    offs = bufs.get("offs", N, i64)
    sums = bufs.get("sums", (N + 255) // 256, i64)
    src = bufs.get("slot_src", M, torch.int32) if slots else None
    pos = bufs.get("slot_pos", M, torch.int32) if slots else None
    ops_out = torch.empty(T, dtype=torch.int8, device=dev)
    emit = torch.empty(T, dtype=torch.bool, device=dev)
    own_m = [Column(torch.empty(T, dtype=c.data.dtype, device=dev),
                    None if c.valid is None and T == M
                    else torch.empty(T, dtype=torch.bool, device=dev))
             for c in own_cols]
    oth_m = [Column(torch.empty(T, dtype=c.dtype, device=dev),
                    torch.empty(T, dtype=torch.bool, device=dev))
             for c in other.cols]
    P = kernels.ptr_array
    K_PROBE.launches += 1
    K_PROBE.call(
        "rw_sj_probe", len(key_cols), P(key_cols), P(other_keys),
        kernels.int_array(k.element_size() for k in key_cols),
        kernels.ptr(active), kernels.ptr(is_ins), kernels.ptr(ops), N,
        kernels.ptr(other.khash), kernels.ptr(other.n), other.capacity,
        len(own_cols), P([c.data for c in own_cols]),
        P([c.valid for c in own_cols]), P([c.data for c in own_m]),
        P([c.valid for c in own_m]),
        kernels.int_array(c.data.element_size() for c in own_cols),
        len(other.cols), P(other.cols), P(other.valids),
        P([c.data for c in oth_m]), P([c.valid for c in oth_m]),
        kernels.int_array(c.element_size() for c in other.cols),
        M, kernels.ptr(h), kernels.ptr(ins_h), kernels.ptr(lo),
        kernels.ptr(offs), kernels.ptr(sums), kernels.ptr(ops_out),
        kernels.ptr(emit), kernels.ptr_or_null(src),
        kernels.ptr_or_null(pos), kernels.ptr(errs),
        kernels.stream_of(active))
    return h, ins_h, own_m, oth_m, ops_out, emit, src, pos


# ------------------------------------------------------------------ K28

def outer_segments(M: int, N: int, outer_own: bool, outer_other: bool):
    """Rows of an outer apply's output: [M matches][M transitions when
    the other side is outer][N own rows when this side is]."""
    return M + (M if outer_other else 0) + (N if outer_own else 0)


def outer_apply_plain(emit, src, pos, ops, active, null_key,
                      other: SortedSideState, chunk_cols, own_m, oth_m,
                      ops_m, M: int, outer_own: bool, outer_other: bool,
                      errs: torch.Tensor, bufs=None):
    """Plain PyTorch version of kernel K28, step by step as the JAX
    package's `_apply_impl` (443-533). emit, src, pos, ops_m, own_m and
    oth_m are the probe's M match slots after the join condition; ops,
    active (visible with a valid key) and null_key (visible with a NULL
    key) are the chunk's. Returns (match_cnt int32 [N], the other side's
    new degree, own output columns, other output columns, ops, vis),
    the output rows in `outer_segments`' layout; adds the transitions
    past their buffer to errs[0] in place."""
    N = active.shape[0]
    Co = other.capacity
    dev = active.device
    emit, src, pos = emit[:M], src[:M], pos[:M]
    signs = op_sign(ops)
    match_cnt = torch.zeros(N, dtype=torch.int32, device=dev)
    match_cnt.index_add_(0, src, emit.to(torch.int32))
    # signed degree delta onto the other side's rows (row Co: the trash)
    d_sign = torch.where(emit, signs[src], 0).to(torch.int32)
    degree = torch.cat([other.degree, other.degree[:1]])
    degree.index_add_(0, torch.where(emit, pos, Co), d_sign)
    degree = degree[:Co]
    own_parts = [[c.data[:M]] for c in own_m]
    own_vparts = [[c.valid_mask()[:M]] for c in own_m]
    oth_parts = [[c.data[:M]] for c in oth_m]
    oth_vparts = [[c.valid_mask()[:M]] for c in oth_m]
    ops_parts, vis_parts = [ops_m[:M]], [emit]
    if outer_other:
        # NET degree transitions on the other side -> NULL-row flips
        touched = torch.zeros(Co + 1, dtype=torch.bool, device=dev)
        touched[torch.where(emit, pos, Co)] = True
        touched = touched[:Co]
        o_live = torch.arange(Co, device=dev) < other.n
        was0 = other.degree == 0
        now0 = degree == 0
        t_del = touched & o_live & was0 & ~now0     # retract the NULL row
        t_ins = touched & o_live & ~was0 & now0     # re-emit the NULL row
        t_any = t_del | t_ins
        trank = torch.cumsum(t_any.to(torch.int64), 0) - 1
        tsel = torch.zeros(M + 1, dtype=torch.int64, device=dev)
        tsel[torch.where(t_any & (trank < M), trank, M)] = torch.arange(
            Co, device=dev)
        tsel = tsel[:M]
        n_trans = t_any.sum(dtype=torch.int64)
        t_vis = torch.arange(M, device=dev) < torch.clamp(n_trans, max=M)
        ops_parts.append(torch.where(t_del[tsel], OP_DELETE,
                                     OP_INSERT).to(torch.int8))
        vis_parts.append(t_vis)
        errs[0] += torch.clamp(n_trans - M, min=0).to(torch.int32)
        for parts, vparts, c in zip(own_parts, own_vparts, own_m):
            parts.append(torch.zeros(M, dtype=c.data.dtype, device=dev))
            vparts.append(torch.zeros(M, dtype=torch.bool, device=dev))
        for parts, vparts, r, v in zip(oth_parts, oth_vparts, other.cols,
                                       other.valids):
            parts.append(r[tsel])
            vparts.append(v[tsel])
    if outer_own:
        # own rows with no condition-passing match (NULL keys included)
        ops_parts.append(torch.where(signs > 0, OP_INSERT,
                                     OP_DELETE).to(torch.int8))
        vis_parts.append((active & (match_cnt == 0)) | null_key)
        for parts, vparts, c in zip(own_parts, own_vparts, chunk_cols):
            parts.append(c.data)
            vparts.append(c.valid_mask())
        for parts, vparts, c in zip(oth_parts, oth_vparts, oth_m):
            parts.append(torch.zeros(N, dtype=c.data.dtype, device=dev))
            vparts.append(torch.zeros(N, dtype=torch.bool, device=dev))
    own_out = [Column(torch.cat(p), torch.cat(v))
               for p, v in zip(own_parts, own_vparts)]
    oth_out = [Column(torch.cat(p), torch.cat(v))
               for p, v in zip(oth_parts, oth_vparts)]
    return (match_cnt, degree, own_out, oth_out, torch.cat(ops_parts),
            torch.cat(vis_parts))


def outer_apply(emit, src, pos, ops, active, null_key,
                other: SortedSideState, chunk_cols, own_m, oth_m, ops_m,
                M: int, outer_own: bool, outer_other: bool,
                errs: torch.Tensor, bufs: Optional[_Buffers] = None):
    """Kernel K28 on a CUDA device, the plain version on the CPU. Same
    contract as `outer_apply_plain`, except that on the card the other
    side's degree is updated in place (and returned), the output is
    written into the tail of the probe's [outer_segments] columns, ops
    and emit (returned as they are), and the values of invisible
    transition rows are unspecified. match_cnt lives in `bufs`."""
    dev = active.device
    if dev.type == "cpu":
        return outer_apply_plain(emit, src, pos, ops, active, null_key,
                                 other, chunk_cols, own_m, oth_m, ops_m, M,
                                 outer_own, outer_other, errs)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    N = active.shape[0]
    Co = other.capacity
    T = outer_segments(M, N, outer_own, outer_other)
    if not (outer_own or outer_other):
        raise ValueError("K28 runs for outer joins")
    if src is None or src.dtype != torch.int32 or src.shape[0] < M \
            or pos.dtype != torch.int32 or pos.shape[0] < M:
        raise ValueError("K28 takes the probe's int32 slot rows")
    for t in (emit, ops_m, *(c.data for c in own_m + oth_m),
              *(c.valid for c in own_m + oth_m)):
        if t is None or t.shape[0] != T or not t.is_contiguous():
            raise ValueError("K28 writes into the probe's output of "
                             f"{T} rows, with valid masks")
    if not 1 <= len(own_m) <= MAX_COLS or not 1 <= len(oth_m) <= MAX_COLS:
        raise ValueError(f"K28 takes 1..{MAX_COLS} columns a side")
    for c in chunk_cols:
        if not c.data.is_contiguous() or c.data.shape[0] != N:
            raise ValueError("K28 chunk columns must be contiguous")
    if bufs is None:
        bufs = _Buffers(dev)
    i32 = torch.int32
    match_cnt = bufs.get("match_cnt", N, i32)
    P = kernels.ptr_array
    K_OUTER.launches += 1
    K_OUTER.call(
        "rw_oj_apply", N, M, Co, int(outer_own), int(outer_other),
        kernels.ptr(emit), kernels.ptr(src), kernels.ptr(pos),
        kernels.ptr(ops), kernels.ptr(active), kernels.ptr(null_key),
        kernels.ptr(other.degree), kernels.ptr(other.n),
        len(own_m), P([c.data for c in chunk_cols]),
        P([c.valid for c in chunk_cols]), P([c.data for c in own_m]),
        P([c.valid for c in own_m]),
        kernels.int_array(c.data.element_size() for c in own_m),
        len(oth_m), P(other.cols), P(other.valids),
        P([c.data for c in oth_m]), P([c.valid for c in oth_m]),
        kernels.int_array(c.data.element_size() for c in oth_m),
        kernels.ptr(ops_m), kernels.ptr(emit), kernels.ptr(match_cnt),
        kernels.ptr(bufs.get("oj_delta", Co, i32)),
        kernels.ptr(bufs.get("oj_sums", (Co + 255) // 256, i32)),
        kernels.ptr(bufs.get("oj_n", 1, i32)), kernels.ptr(errs),
        kernels.stream_of(emit))
    return match_cnt, other.degree, own_m, oth_m, ops_m, emit


# ------------------------------------------------------------------ K7

def merge_plain(own: SortedSideState, nh, iorder, n_new,
                chunk_cols: Sequence[Column], is_del, h, M: int,
                match_idx: Sequence[int], clean_col: Optional[int], wm: int,
                errs: torch.Tensor, spare=None, bufs=None,
                match_cnt: Optional[torch.Tensor] = None) -> SortedSideState:
    """Plain PyTorch version of kernel K7: the side's store after
    inline eviction below `wm` on `clean_col`, the retractions `is_del`
    (None: append-only) and the insert of the new rows, sorted by hash
    (`nh` = their hashes, `iorder` = their chunk rows, `n_new` = how
    many). A new row's degree is its chunk row's `match_cnt` (an outer
    join's), else 0; kept rows keep theirs. Adds delete misses to
    errs[1] and dropped rows to errs[2] in place. With no chunk (nh of
    length 0) it is `_evict_impl`."""
    C = own.capacity
    N = nh.shape[0]
    dev = own.khash.device
    live = torch.arange(C, device=dev) < own.n
    keep = live
    if clean_col is not None:
        keep = keep & ~(own.cols[clean_col] < wm)
    if is_del is not None and N > 0:
        dlo = torch.searchsorted(own.khash, h, side="left")
        dhi = torch.searchsorted(own.khash, h, side="right")
        doffs = torch.cumsum(torch.where(is_del, dhi - dlo, 0), 0)
        dtot = doffs[N - 1]
        j, dsrcc, dpos = _expand(doffs, dlo, M, C)
        cand = (j < torch.clamp(dtot, max=M)) & keep[dpos]
        for c in match_idx:
            sc = own.cols[c]
            cand &= sc[dpos] == chunk_cols[c].data[dsrcc].to(sc.dtype)
        # one victim per retraction: the lowest matching state position
        # (row N is the trash row of the reference's dropped scatter)
        victim = torch.full((N + 1,), C, dtype=torch.int64, device=dev)
        victim.scatter_reduce_(0, torch.where(cand, dsrcc, N), dpos, "amin")
        victim = victim[:N]
        found = victim < C
        keep = torch.cat([keep, keep[:1]])
        keep[torch.where(found, victim, C)] = False
        keep = keep[:C]
        errs[1] += (is_del & ~found).sum(dtype=torch.int32)
    dead_cum = torch.cumsum((~keep).to(torch.int64), 0)
    kept_rank = torch.cumsum(keep.to(torch.int64), 0) - 1
    n_kept = kept_rank[C - 1] + 1
    # state row t -> kept_rank + (# new rows with hash < khash[t])
    pos_t = kept_rank + torch.searchsorted(nh, own.khash, side="left")
    # new row r -> r + (# kept state rows with hash <= nh[r])
    rr = torch.arange(N, device=dev)
    pos_r = rr + _count_le(own.khash, dead_cum, nh, side="right")
    new_ok = rr < n_new
    n_after = n_kept + n_new
    errs[2] += torch.clamp(n_after - C, min=0).to(torch.int32)
    n_after = torch.clamp(n_after, max=C)
    # the trash row C takes the dropped writes
    tgt_t = torch.where(keep & (pos_t < C), pos_t, C)
    tgt_r = torch.where(new_ok & (pos_r < C), pos_r, C)

    def merged(fill, dtype, old, new):
        out = torch.full((C + 1,), fill, dtype=dtype, device=dev)
        out[tgt_t] = old
        if N > 0:
            out[tgt_r] = new
        return out[:C]

    cols, valids = [], []
    for ci, (sc, sv) in enumerate(zip(own.cols, own.valids)):
        cc = chunk_cols[ci] if N > 0 else None
        cols.append(merged(0, sc.dtype, sc,
                           cc.data[iorder].to(sc.dtype) if N > 0 else None))
        valids.append(merged(False, torch.bool, sv,
                             cc.valid_mask()[iorder] if N > 0 else None))
    return SortedSideState(
        khash=merged(HSENTINEL, torch.int64, own.khash, nh),
        cols=tuple(cols), valids=tuple(valids),
        degree=merged(0, torch.int32, own.degree,
                      0 if match_cnt is None or N == 0
                      else match_cnt[iorder]),
        n=n_after.to(torch.int32))


def merge(own: SortedSideState, nh, iorder, n_new,
          chunk_cols: Sequence[Column], is_del, h, M: int,
          match_idx: Sequence[int], clean_col: Optional[int], wm: int,
          errs: torch.Tensor, spare: Optional[SortedSideState] = None,
          bufs: Optional[_Buffers] = None,
          match_cnt: Optional[torch.Tensor] = None) -> SortedSideState:
    """Kernel K7 on a CUDA device, the plain version on the CPU. Same
    contract as `merge_plain`; on the card the result is written into
    `spare` (a store of the same capacity and dtypes, which this
    overwrites) and `spare` is returned."""
    dev = own.khash.device
    if dev.type == "cpu":
        return merge_plain(own, nh, iorder, n_new, chunk_cols, is_del, h,
                           M, match_idx, clean_col, wm, errs,
                           match_cnt=match_cnt)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    C = own.capacity
    N = nh.shape[0]
    if spare is None or spare.capacity != C or spare is own \
            or len(spare.cols) != len(own.cols):
        raise ValueError("K7 writes into a second store of the same shape")
    if not 1 <= len(own.cols) <= MAX_STORE_COLS \
            or len(match_idx) > MAX_MATCH:
        raise ValueError(f"K7 takes 1..{MAX_STORE_COLS} columns and at most "
                         f"{MAX_MATCH} match columns")
    if N > 0:
        for cc, sc in zip(chunk_cols, own.cols):
            if cc.data.dtype != sc.dtype or not cc.data.is_contiguous() \
                    or cc.data.shape[0] != N:
                raise ValueError("K7 chunk columns must be contiguous, of "
                                 "the store's dtypes")
        if nh.dtype != torch.int64 or iorder.dtype != torch.int64 \
                or n_new.dtype != torch.int32:
            raise ValueError("K7 takes int64 nh/iorder and int32 n_new")
        if match_cnt is not None and (match_cnt.dtype != torch.int32
                                      or match_cnt.shape[0] != N):
            raise ValueError("K7 takes int32 match counts, one a chunk row")
    if bufs is None:
        bufs = _Buffers(dev)
    i32, i64 = torch.int32, torch.int64
    retract = is_del is not None and N > 0
    nn = max(N, 1)
    P = kernels.ptr_array
    K_MERGE.launches += 1
    K_MERGE.call(
        "rw_sj_merge", kernels.ptr(own.khash), len(own.cols), P(own.cols),
        P(own.valids), kernels.int_array(c.element_size() for c in own.cols),
        kernels.ptr(own.degree), kernels.ptr(own.n), C,
        kernels.ptr(spare.khash), P(spare.cols), P(spare.valids),
        kernels.ptr(spare.degree), kernels.ptr(spare.n),
        -1 if clean_col is None else clean_col, wm, N,
        kernels.ptr_or_null(nh if N > 0 else None),
        kernels.ptr_or_null(iorder if N > 0 else None),
        kernels.ptr_or_null(n_new if N > 0 else None),
        P([c.data for c in chunk_cols] if N > 0 else []),
        P([c.valid for c in chunk_cols] if N > 0 else []),
        kernels.ptr_or_null(is_del if retract else None),
        kernels.ptr_or_null(h if retract else None), M, len(match_idx),
        kernels.int_array(match_idx),
        kernels.ptr(bufs.get("dlo", nn, i64)),
        kernels.ptr(bufs.get("doffs", nn, i64)),
        kernels.ptr(bufs.get("dsums", (nn + 255) // 256, i64)),
        kernels.ptr(bufs.get("victim", nn, i32)),
        kernels.ptr(bufs.get("removed", C, torch.uint8)),
        kernels.ptr(bufs.get("kept_incl", C, i32)),
        kernels.ptr(bufs.get("ksums", (C + 255) // 256, i32)),
        kernels.ptr(bufs.get("hw", 1, i32)),
        kernels.ptr_or_null(match_cnt if N > 0 else None),
        kernels.ptr(errs), kernels.stream_of(own.khash))
    return spare


# ------------------------------------------------------------------ K17

def row_lanes(st: SortedSideState) -> list[torch.Tensor]:
    """Row identity and content lanes for diffing: khash ++ data
    (invalid lanes 0, floats by their bits) ++ valid bits."""
    lanes = [st.khash]
    for c, v in zip(st.cols, st.valids):
        lanes.append(torch.where(v, as_i64_lanes(c), 0))
    lanes.extend(v.to(torch.int64) for v in st.valids)
    return lanes


def diff_plain(cur: SortedSideState, snap: SortedSideState):
    """Plain PyTorch version of kernel K17, step by step as the JAX
    package's `_diff_impl`: rows in `cur` not in `snap` (inserts) and
    rows in `snap` not in `cur` (deletes), matched by row hash and an
    exact lane compare against the first candidate of equal hash.
    Returns compacted (del_cols, n_del, ins_cols, n_ins); only the first
    n entries of each column are meaningful."""
    def rowhash(st):
        live = torch.arange(st.capacity, device=st.khash.device) < st.n
        return torch.where(live, key_hash(row_lanes(st)), HSENTINEL), live

    rh_c, live_c = rowhash(cur)
    rh_s, live_s = rowhash(snap)
    sorted_c, order_c = torch.sort(rh_c, stable=True)
    sorted_s, order_s = torch.sort(rh_s, stable=True)
    lanes_c = row_lanes(cur)
    lanes_s = row_lanes(snap)

    def unmatched(rh_a, live_a, lanes_a, rh_b_sorted, order_b, lanes_b,
                  cap_b):
        pos = torch.searchsorted(rh_b_sorted, rh_a).clamp(0, cap_b - 1)
        cand = order_b[pos]
        eq = rh_b_sorted[pos] == rh_a
        for la, lb in zip(lanes_a, lanes_b):
            eq &= la == lb[cand]
        return live_a & ~eq

    ins_mask = unmatched(rh_c, live_c, lanes_c, sorted_s, order_s, lanes_s,
                         snap.capacity)
    del_mask = unmatched(rh_s, live_s, lanes_s, sorted_c, order_c, lanes_c,
                         cur.capacity)

    def compact(mask, cols):
        cap = mask.shape[0]
        rank = torch.cumsum(mask.to(torch.int64), 0) - 1
        sel = torch.zeros(cap + 1, dtype=torch.int64, device=mask.device)
        sel[torch.where(mask, rank, cap)] = torch.arange(
            cap, device=mask.device)
        sel = sel[:cap]
        return (tuple(c[sel] for c in cols),
                mask.sum(dtype=torch.int64))

    del_cols, n_del = compact(del_mask, snap.cols)
    ins_cols, n_ins = compact(ins_mask, cur.cols)
    return del_cols, n_del, ins_cols, n_ins


def pack_diff_plain(cur: SortedSideState, snap: SortedSideState):
    """`diff_plain` in K17's output layout: (packed int64 [(Cs + Cc) *
    K], counts int64 [2]); deletes' rows first, then inserts', row
    major. Entries past the counted rows are 0."""
    del_cols, n_del, ins_cols, n_ins = diff_plain(cur, snap)
    Cs, Cc, K = snap.capacity, cur.capacity, len(cur.cols)
    dev = cur.khash.device
    R = Cs + Cc
    rows = torch.zeros(R + 1, K, dtype=torch.int64, device=dev)
    ar_s = torch.arange(Cs, device=dev)
    ar_c = torch.arange(Cc, device=dev)
    rows[torch.where(ar_s < n_del, ar_s, R)] = pack_rows(del_cols).view(Cs, K)
    rows[torch.where(ar_c < n_ins, n_del + ar_c, R)] = \
        pack_rows(ins_cols).view(Cc, K)
    return rows[:R].reshape(-1), torch.stack([n_del, n_ins])


def snapshot_diff(cur: SortedSideState, snap: SortedSideState):
    """Kernel K17 on a CUDA device, the plain version on the CPU. Same
    contract as `pack_diff_plain`, except that entries past the counted
    rows are unspecified. Counts stay on the device."""
    dev = cur.khash.device
    if dev.type == "cpu":
        return pack_diff_plain(cur, snap)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    K = len(cur.cols)
    if not 1 <= K <= MAX_COLS or len(snap.cols) != K:
        raise ValueError(f"K17 diffs two stores of 1..{MAX_COLS} like "
                         "columns")
    for a, b in zip(cur.cols, snap.cols):
        if a.dtype != b.dtype or (a.is_floating_point()
                                  and a.dtype != torch.float64):
            raise ValueError("K17 takes integer, bool or float64 columns "
                             "of one dtype a column on both sides")
    for st in (cur, snap):
        for t in (st.khash, *st.cols, *st.valids):
            if not t.is_contiguous() or t.device != dev \
                    or t.shape[0] != st.capacity:
                raise ValueError("K17 store columns must be contiguous, "
                                 "of the store's capacity, on one device")
    Cs, Cc = snap.capacity, cur.capacity
    widths = kernels.int_array(c.element_size() for c in cur.cols)
    P = kernels.ptr_array
    i64 = dict(dtype=torch.int64, device=dev)
    rh_s, rh_c = torch.empty(Cs, **i64), torch.empty(Cc, **i64)
    out = torch.empty((Cs + Cc) * K, **i64)
    counts = torch.empty(2, **i64)
    mask = torch.empty(Cs + Cc, dtype=torch.uint8, device=dev)
    sums = torch.empty(K_DIFF.lib().rw_diff_sums(Cs, Cc), dtype=torch.int32,
                       device=dev)
    K_DIFF.launches += 1
    stream = kernels.stream_of(cur.khash)
    for st, rh in ((snap, rh_s), (cur, rh_c)):
        K_DIFF.call("rw_diff_rowhash", kernels.ptr(st.khash), K, P(st.cols),
                    P(st.valids), widths, kernels.ptr(st.n), st.capacity,
                    kernels.ptr(rh), stream)
    sorted_s, order_s = stable_sort(rh_s, HASH_BITS)
    sorted_c, order_c = stable_sort(rh_c, HASH_BITS)
    K_DIFF.call("rw_diff_compact", kernels.ptr(snap.khash), P(snap.cols),
                P(snap.valids), kernels.ptr(snap.n), Cs,
                kernels.ptr(cur.khash), P(cur.cols), P(cur.valids),
                kernels.ptr(cur.n), Cc, K, widths, kernels.ptr(rh_s),
                kernels.ptr(rh_c), kernels.ptr(sorted_s),
                kernels.ptr(order_s), kernels.ptr(sorted_c),
                kernels.ptr(order_c), kernels.ptr(mask), kernels.ptr(sums),
                kernels.ptr(out), kernels.ptr(counts), stream)
    return out, counts


def copy_side(dst: Optional[SortedSideState],
              src: SortedSideState) -> SortedSideState:
    """A device copy of `src`, into `dst`'s tensors when it has the same
    shapes (the checkpoint snapshot, which no apply writes)."""
    if dst is None or dst.capacity != src.capacity:
        return SortedSideState(src.khash.clone(),
                               tuple(c.clone() for c in src.cols),
                               tuple(v.clone() for v in src.valids),
                               src.degree.clone(), src.n.clone())
    for d, s_ in zip((dst.khash, *dst.cols, *dst.valids, dst.degree, dst.n),
                     (src.khash, *src.cols, *src.valids, src.degree, src.n)):
        d.copy_(s_)
    return dst


# ------------------------------------------------------------- executor

class SortedJoinExecutor(Executor):
    """Inner, outer or temporal equi-join over sorted dense state
    (integer keys)."""

    def __init__(self, left: Executor, right: Executor,
                 left_key_indices: Sequence[int],
                 right_key_indices: Sequence[int],
                 left_pk_indices: Sequence[int],
                 right_pk_indices: Sequence[int],
                 capacity: int = 1 << 17,
                 match_factor: int = 2,
                 match_factors: Optional[tuple] = None,
                 condition=None,
                 join_type: str = "inner",
                 output_indices: Optional[Sequence[int]] = None,
                 append_only: tuple[bool, bool] = (False, False),
                 clean_watermark_cols: tuple = (None, None),
                 clean_specs: Optional[tuple] = None,
                 state_tables: Optional[tuple] = None,
                 temporal: bool = False,
                 watchdog_interval: Optional[int] = 1,
                 device="cuda"):
        if join_type not in ("inner", "left", "right", "full"):
            raise ValueError(f"unknown join type {join_type!r}")
        if temporal and join_type not in ("inner", "left"):
            raise ValueError("temporal joins are inner or left")
        self.device = resolve_device(device)
        self.inputs = (left, right)
        self.key_indices = (tuple(left_key_indices), tuple(right_key_indices))
        self.pk_indices_side = (tuple(left_pk_indices),
                                tuple(right_pk_indices))
        lt, rt = left.schema, right.schema
        if len(self.key_indices[0]) != len(self.key_indices[1]):
            raise ValueError("join key arity differs between the sides")
        for li, ri in zip(*self.key_indices):
            ldt, rdt = lt[li].data_type.torch_dtype, rt[ri].data_type.torch_dtype
            if ldt != rdt:
                raise ValueError(f"join key dtype mismatch {lt[li]} vs "
                                 f"{rt[ri]}")
            if ldt.is_floating_point or ldt == torch.bool:
                raise ValueError("sorted join keys must be integer-typed")
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
        # advertise no stream key unless every key column survives the
        # projection (a partial key is not unique)
        if all(i in self.output_indices for i in out_pk_full):
            self.pk_indices = tuple(self.output_indices.index(i)
                                    for i in out_pk_full)
        else:
            self.pk_indices = ()
        self.capacity = [capacity, capacity]
        self.match_factor = match_factor
        self.match_factors = (tuple(match_factors) if match_factors
                              else (match_factor, match_factor))
        self.condition = condition
        self._cond = None if condition is None else ExprProgram([condition])
        # cleaning specs, as the reference's planner derives them:
        #   ("own", col)               evict below this side's watermark
        #   ("pair", col, kpos)        col is equi-key kpos; evict below
        #                              the min of both sides' watermarks
        #   ("band", col, other_col, d[, cap_col])
        #                              evict below the other side's
        #                              watermark + d, capped at this side's
        #                              watermark on cap_col if given
        if clean_specs is None:
            clean_specs = tuple(None if c is None else ("own", c)
                                for c in clean_watermark_cols)
        self.clean_specs = tuple(clean_specs)
        # eviction drops rows without probing, so it cannot maintain the
        # other side's degrees: an outer join refuses state cleaning
        if join_type != "inner" and self.clean_specs != (None, None):
            raise ValueError(
                "outer joins do not support watermark state cleaning")
        self.join_type = join_type
        # temporal (FOR SYSTEM_TIME AS OF PROCTIME()): the right side is
        # a table whose updates maintain its state and emit nothing
        self.temporal = temporal
        # side s keeps its unmatched rows (emits them NULL-padded)
        self._outer = (join_type in ("left", "full"),
                       join_type in ("right", "full"))
        self.append_only = tuple(append_only)
        self.clean_cols = tuple(None if sp is None else sp[1]
                                for sp in self.clean_specs)
        self._pending_clean: list[int] = [NO_WATERMARK, NO_WATERMARK]
        self._wms: list[dict[int, int]] = [{}, {}]
        self.identity = (f"SortedJoin(l={self.key_indices[0]}, "
                         f"r={self.key_indices[1]})")
        self.sides = [self._empty(s) for s in (LEFT, RIGHT)]
        self.state_tables = (tuple(state_tables) if state_tables
                             else (None, None))
        # device copy of each side as of the last durable flush (the diff
        # base); a copy, not an alias, because K7 rewrites the stores in
        # place through the spare swap
        self._snap: list[Optional[SortedSideState]] = [None, None]
        self._flush_dirty = [False, False]
        self.persist_rows = 0        # rows the persists wrote
        # second stores K7 writes into (CUDA only; made at first use)
        self._spare: list[Optional[SortedSideState]] = [None, None]
        self._bufs = [_Buffers(self.device), _Buffers(self.device)]
        if watchdog_interval not in (None, 1):
            raise ValueError("watchdog_interval must be 1 or None")
        self.watchdog_interval = watchdog_interval
        # device error accumulator [match_overflow, del_miss, row_overflow]
        self._errs_dev = torch.zeros(3, dtype=torch.int32, device=self.device)
        self._dirty = [False, False]
        self._key_wms: list[dict[int, int]] = [{}, {}]
        self._emitted_key_wm: dict[int, int] = {}
        # watermark value a side's state is already clean to
        self._cleaned_to = [NO_WATERMARK, NO_WATERMARK]

    def fence_tokens(self) -> list:
        return [s.n for s in self.sides]

    def _empty(self, side: int) -> SortedSideState:
        return empty_sorted_side(self.capacity[side], self._col_dtypes[side],
                                 self.device)

    def _spare_for(self, side: int) -> Optional[SortedSideState]:
        if self.device.type != "cuda":
            return None
        if self._spare[side] is None:
            self._spare[side] = self._empty(side)
        return self._spare[side]

    def _install(self, side: int, new: SortedSideState) -> None:
        old = self.sides[side]
        self.sides[side] = new
        if self.device.type == "cuda":
            self._spare[side] = old

    def errs(self) -> list[int]:
        """[match overflow, delete miss, row overflow] (one fetch)."""
        return [int(x) for x in self._errs_dev.cpu()]

    # ------------------------------------------------------------- apply
    def _apply(self, side: int, chunk: StreamChunk, wm: int,
               match_factor: Optional[int] = None):
        """Probe the other side, emit matches (and, in an outer join, the
        degree transitions and unmatched rows), evict+update this side.
        Returns the output's (columns, ops, vis)."""
        key_idx = self.key_indices[side]
        N = chunk.capacity
        M = (match_factor or self.match_factors[side]) * N
        other = self.sides[1 - side]
        outer_own, outer_other = self._outer[side], self._outer[1 - side]
        any_outer = outer_own or outer_other
        key_cols = [chunk.columns[i].data for i in key_idx]
        active = chunk.vis
        for i in key_idx:      # NULL keys never join
            if chunk.columns[i].valid is not None:
                active = active & chunk.columns[i].valid
        bufs = self._bufs[side]
        if self.append_only[side]:
            is_ins, is_del = active, None
        else:
            _, is_ins, is_del, _ = net_pk_runs(
                chunk, active, self.pk_indices_side[side], bufs)
        h, ins_h, own_m, oth_m, ops, emit, src, pos = probe(
            key_cols, active, is_ins, chunk.ops, other,
            self.key_indices[1 - side], chunk.columns, M, self._errs_dev,
            bufs, rows=outer_segments(M, N, outer_own, outer_other),
            slots=any_outer)
        if self._cond is not None:
            cols_m = [Column(c.data[:M],
                             None if c.valid is None else c.valid[:M])
                      for c in (own_m + oth_m if side == LEFT
                                else oth_m + own_m)]
            self._cond.and_into(cols_m, emit[:M])
        match_cnt = None
        if any_outer:
            match_cnt, degree, own_m, oth_m, ops, emit = outer_apply(
                emit, src, pos, chunk.ops, active, chunk.vis & ~active,
                other, chunk.columns, own_m, oth_m, ops, M, outer_own,
                outer_other, self._errs_dev, bufs)
            other.degree = degree
        cols = own_m + oth_m if side == LEFT else oth_m + own_m
        # new rows in hash order; non-inserts carry the sentinel, last
        nh, iorder = stable_sort(ins_h, HASH_BITS)
        n_new = is_ins.sum(dtype=torch.int32)
        new = merge(self.sides[side], nh, iorder, n_new, chunk.columns,
                    is_del, h, M,
                    self.key_indices[side] + self.pk_indices_side[side],
                    self.clean_cols[side], wm, self._errs_dev,
                    self._spare_for(side), bufs, match_cnt=match_cnt)
        self._install(side, new)
        return cols, ops, emit

    def _evict(self, side: int, wm: int) -> None:
        """Barrier-time eviction of an idle side: K7 with no new rows."""
        empty = torch.empty(0, dtype=torch.int64, device=self.device)
        new = merge(self.sides[side], empty, empty,
                    torch.zeros((), dtype=torch.int32, device=self.device),
                    (), None, None, 1, (), self.clean_cols[side], wm,
                    self._errs_dev, self._spare_for(side), self._bufs[side])
        self._install(side, new)

    # ---------------------------------------------------------- cleaning
    def _recompute_pending(self) -> None:
        """Re-derive each side's eviction bound from the latest observed
        watermarks per its clean spec (monotone: watermarks only grow)."""
        for t in (LEFT, RIGHT):
            spec = self.clean_specs[t]
            if spec is None:
                continue
            kind = spec[0]
            if kind == "own":
                v = self._wms[t].get(spec[1])
            elif kind == "pair":
                kpos = spec[2]
                a = self._wms[t].get(self.key_indices[t][kpos])
                b = self._wms[1 - t].get(self.key_indices[1 - t][kpos])
                v = None if a is None or b is None else min(a, b)
            elif kind == "band":
                o = self._wms[1 - t].get(spec[2])
                v = None if o is None else o + spec[3]
                if len(spec) > 4 and spec[4] is not None:
                    own = self._wms[t].get(spec[4])
                    v = None if own is None or v is None else min(v, own)
            else:
                raise ValueError(f"unknown clean spec {spec!r}")
            if v is not None and v > self._pending_clean[t]:
                self._pending_clean[t] = v

    # ------------------------------------------------------- persistence
    def _persist(self, barrier: Barrier) -> None:
        for s in (LEFT, RIGHT):
            st = self.state_tables[s]
            if st is None:
                continue
            if self._flush_dirty[s]:
                self._persist_diff_write(st, self.sides[s], self._snap[s])
                self._snap[s] = copy_side(self._snap[s], self.sides[s])
                self._flush_dirty[s] = False
            st.commit(barrier.epoch.curr)

    def _persist_diff_write(self, st, cur: SortedSideState,
                            snap: SortedSideState) -> None:
        """Diff one side against its snapshot (K17) and write the changed
        rows: two fetches, the counts and then the packed rows. Deletes
        go strictly before inserts: an updated row diffs as delete(old)
        plus insert(new) on one key."""
        packed, counts = snapshot_diff(cur, snap)
        nd, ni = (int(x) for x in PendingFetch(counts).wait())
        if not nd and not ni:
            return
        self.persist_rows += nd + ni
        K = len(cur.cols)
        host = PendingFetch(packed[:(nd + ni) * K]).wait()
        rows = unpack_rows(host, nd + ni, [
            torch.empty(0, dtype=c.dtype).numpy().dtype for c in cur.cols])
        if nd:
            st.write_chunk_columns(np.full(nd, OP_DELETE, dtype=np.int8),
                                   [c[:nd] for c in rows],
                                   np.ones(nd, dtype=bool))
        if ni:
            st.write_chunk_columns(np.full(ni, OP_INSERT, dtype=np.int8),
                                   [c[nd:] for c in rows],
                                   np.ones(ni, dtype=bool))

    def _recover_reset(self, s: int, rows: list) -> None:
        """Size a side for recovery and reset it to empty."""
        n = len(rows)
        while n > 0.7 * self.capacity[s]:
            self.capacity[s] *= 2
        self.sides[s] = self._empty(s)
        self._spare[s] = None

    def recover(self) -> None:
        """Rebuild device state from the per-side state tables: replay the
        RIGHT rows first (LEFT is empty, so nothing matches), then the
        LEFT rows, whose probes of the restored RIGHT side run as in the
        stream and so rebuild both sides' degrees (the condition
        included). Replay outputs are discarded."""
        if all(st is None for st in self.state_tables):
            return
        rows_by_side = [
            [] if st is None else [r for _, r in st.iter_all()]
            for st in self.state_tables]
        for s in (LEFT, RIGHT):
            self._recover_reset(s, rows_by_side[s])
        batch = 1 << 12
        # generous match buffer: a replay batch probes the full restored
        # other side; the watchdog fail-stops on an overflow
        mf = max(self.match_factor, 64)
        for s in (RIGHT, LEFT):
            rows = rows_by_side[s]
            sch = self.inputs[s].schema
            for i in range(0, len(rows), batch):
                part = rows[i:i + batch]
                cap = 1 << max(1, (len(part) - 1).bit_length())
                cols = []
                for k, f in enumerate(sch):
                    a = np.zeros(cap, dtype=f.data_type.np_dtype)
                    a[:len(part)] = [r[k] for r in part]
                    cols.append(Column(torch.from_numpy(a).to(self.device)))
                chunk = StreamChunk(
                    tuple(cols),
                    torch.zeros(cap, dtype=torch.int8, device=self.device),
                    torch.arange(cap, device=self.device) < len(part), sch)
                self._apply(s, chunk, NO_WATERMARK, match_factor=mf)
        self._snap = [copy_side(None, self.sides[s]) for s in (LEFT, RIGHT)]

    # --------------------------------------------------------- watchdog
    def _check_watchdog(self) -> None:
        vals = torch.cat([self._errs_dev, self.sides[LEFT].n.view(1),
                          self.sides[RIGHT].n.view(1)]).cpu()
        n_mo, n_miss, n_ro = (int(x) for x in vals[:3])
        if n_mo:
            raise RuntimeError(
                f"sorted-join match-buffer overflow ({n_mo} matches "
                f"dropped; raise match_factor)")
        if n_ro:
            raise RuntimeError(
                f"sorted-join state overflow ({n_ro} rows dropped; "
                f"capacity {self.capacity})")
        if n_miss:
            raise RuntimeError(
                f"sorted-join changelog inconsistency: {n_miss} deletes "
                f"matched no stored row")

    # ----------------------------------------------------------- stream
    async def execute(self):
        first = True
        async for kind, s, msg in barrier_align(*self.inputs):
            if kind == "chunk":
                self._cleaned_to[s] = self._pending_clean[s]
                cols, ops, vis = self._apply(s, msg, self._pending_clean[s])
                self._dirty[s] = True
                self._flush_dirty[s] = True
                if self.temporal and s == RIGHT:
                    continue        # table-side updates emit nothing
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
                dirty_any = any(self._dirty)
                # idle sides still clean by watermark at barriers
                for s2 in (LEFT, RIGHT):
                    if (self.clean_cols[s2] is not None
                            and self._pending_clean[s2] != NO_WATERMARK
                            and self._pending_clean[s2]
                            != self._cleaned_to[s2]
                            and not self._dirty[s2]):
                        self._evict(s2, self._pending_clean[s2])
                        self._cleaned_to[s2] = self._pending_clean[s2]
                        self._flush_dirty[s2] = True
                    self._dirty[s2] = False
                # watchdog before the barrier passes: errors fail-stop
                # this epoch
                if self.watchdog_interval and (stopping or dirty_any):
                    self._check_watchdog()
                self._persist(barrier)
                yield barrier
            else:
                wm: Watermark = msg
                self._wms[s][wm.col_idx] = wm.val
                self._recompute_pending()
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
