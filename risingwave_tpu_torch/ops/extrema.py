"""Retractable MIN/MAX state — materialized-input top-K value buffers
(port of risingwave_tpu/ops/extrema.py).

Per group, a dense buffer of the K best DISTINCT values with their
multiplicities:

    vals [C, K]   sorted best-first (desc for max, asc for min)
    cnts [C, K]   multiplicity per value (0 = empty cell)
    lossy [C]     True once any insert was dropped past the K-th value —
                  from then on deletes of untracked values are legal

One chunk nets its (group, value) deltas, keeps the K best inserted and
the K best deleted values of each group, and merges them into the
group's buffer. Inconsistencies (a delete that matches no tracked value
while the buffer is not lossy, more than K distinct deletes of one group
in one chunk, a lossy buffer that empties while its group has rows) are
counted on the device and fail-stopped by the hash agg's watchdog.

Values compare as the JAX package's programs compare them on the CPU:
NaN never equals anything (NaN runs never combine), -0.0 equals +0.0,
and subnormals equal zero, both in the sort and in `==`.

The plain functions below follow the JAX package's step by step (the
chunk's merge over the groups it touched, where JAX merges every
group: the others come back unchanged). On a
CUDA device the chunk apply is kernel K26 (`csrc/extrema_update.cu`),
after a stable sort of the rows by (group, order key) in two passes of
kernel K11; the apply's error count takes the underflow over the groups
the chunk touched, where the JAX package sums it over every group after
every chunk (`extrema_apply_plain` is the kernel's plain version).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..common.chunk import op_sign
from . import kernels
from .sort import lexsort_plain, order_key_plain, stable_sort

MAX_K = 64      # buffer width csrc/extrema_update.cu takes

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# K26. Replaces ops/extrema.py:extrema_update (51) with _order_key (34)
# and extrema_underflow (163).
K_EXTREMA = kernels.register(kernels.CudaKernel(
    "extrema_update",
    replaces="risingwave_tpu/ops/extrema.py:51",
    functions={
        "rw_extrema_keys": [_L, _P, _P, _I, _P, _L, _I, _I, _P, _P, _P],
        "rw_extrema_merge": [_L, _P, _P, _P, _P, _I, _L, _I, _I, _I, _P,
                             _P, _P, _P, _P, _P]}))

# input column dtypes the kernel reads (K4's codes)
_VALUE_CODES = {torch.int32: 1, torch.int64: 2, torch.float32: 3,
                torch.float64: 4}


def extrema_empty(C: int, K: int, dtype: torch.dtype, device) -> tuple:
    return (torch.zeros((C, K), dtype=dtype, device=device),
            torch.zeros((C, K), dtype=torch.int32, device=device),
            torch.zeros(C, dtype=torch.bool, device=device))


def extrema_row_layout(j: int, K: int) -> list:
    """Call j's buffers in the durable agg row, in the row's order (the
    JAX package's layout): per part of (vals, cnts, lossy), its column
    names — K values s{j}v{k} in the call's type, then K counts s{j}c{k}
    and the lossy flag s{j}lossy, both stored as int64."""
    return [[f"s{j}v{k}" for k in range(K)],
            [f"s{j}c{k}" for k in range(K)],
            [f"s{j}lossy"]]


def values_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`a == b` as the JAX package's CPU programs compute it: for floats
    NaN equals nothing, and zeros and the subnormals of the dtype are all
    equal."""
    if not a.is_floating_point():
        return a == b
    tiny = torch.finfo(a.dtype).tiny
    return (a == b) | ((a.abs() < tiny) & (b.abs() < tiny))


def _lexsort_rows(keys) -> torch.Tensor:
    """Per-row (dim 1) stable lexsort, last key primary."""
    order = torch.argsort(keys[0], dim=1, stable=True)
    for k in keys[1:]:
        step = torch.argsort(torch.take_along_dim(k, order, 1), dim=1,
                             stable=True)
        order = torch.take_along_dim(order, step, 1)
    return order


def extrema_update_plain(state: tuple, values: torch.Tensor,
                         valid_in: torch.Tensor, signs: torch.Tensor,
                         seg: torch.Tensor, C: int, is_max: bool):
    """One chunk's rows applied to the buffers, as the JAX package's
    `extrema_update`. values: [N] in the state dtype; valid_in: [N]
    non-null mask; signs: [N] in {-1, 0, +1}; seg: [N] group slot (C =
    trash). Returns (state', n_err int32) with fresh tensors."""
    vals, cnts, lossy = state
    K = vals.shape[1]
    N = values.shape[0]
    dev = values.device
    act = (signs != 0) & valid_in & (seg < C)
    sgs = torch.where(act, signs, 0).to(torch.int32)
    sseg = torch.where(act, seg, C).to(torch.int64)

    # ---- net delta per (group, value) run
    order = lexsort_plain([order_key_plain(values, is_max), sseg])
    o_seg = sseg[order]
    o_val = values[order]
    o_sign = sgs[order]
    first = torch.ones(1, dtype=torch.bool, device=dev)
    seg_break = torch.cat([first, o_seg[1:] != o_seg[:-1]])
    leader = seg_break | torch.cat(
        [first, ~values_equal(o_val[1:], o_val[:-1])])
    run_id = torch.cumsum(leader.to(torch.int64), 0) - 1
    run_delta = torch.zeros(N, dtype=torch.int32, device=dev).index_add_(
        0, run_id, o_sign)[run_id]

    # per-sign candidate ranks among the group's leaders, in value order
    pos = torch.arange(N, device=dev)
    seg_start = torch.cummax(torch.where(seg_break, pos, 0), 0).values
    live = leader & (o_seg < C)

    def rank_among(mask):
        m = (live & mask).to(torch.int64)
        cnt = torch.cumsum(m, 0)
        return (cnt - 1) - (cnt[seg_start] - m[seg_start])

    is_pos = run_delta > 0
    is_neg = run_delta < 0
    rank_pos = rank_among(is_pos)
    rank_neg = rank_among(is_neg)
    keep_pos = live & is_pos & (rank_pos < K)
    drop_pos = live & is_pos & (rank_pos >= K)
    keep_neg = live & is_neg & (rank_neg < K)
    drop_neg = live & is_neg & (rank_neg >= K)
    lossy2 = lossy.clone()
    lossy2[o_seg[drop_pos]] = True
    err_dropped_del = drop_neg.sum(dtype=torch.int32)

    # the merge runs over the groups the chunk touched: for any other
    # group it would give back its buffer unchanged (its cells are
    # sorted, distinct and positive)
    touched = torch.unique(o_seg[o_seg < C])
    G = touched.shape[0]
    o_g = torch.searchsorted(touched, o_seg.clamp(max=C - 1))

    def scatter_cand(keep, rank):
        # the trash row G takes the rows not kept (the reference's
        # mode="drop") and is sliced off
        tgt_row = torch.where(keep, o_g, G)
        tgt_col = torch.where(keep, rank.clamp(max=K - 1), 0)
        cv = torch.zeros((G + 1, K), dtype=vals.dtype, device=dev)
        cv[tgt_row, tgt_col] = o_val
        cc = torch.zeros((G + 1, K), dtype=torch.int32, device=dev)
        cc[tgt_row, tgt_col] = run_delta
        return cv[:G], cc[:G]

    cand_vals_p, cand_cnts_p = scatter_cand(keep_pos, rank_pos)
    cand_vals_n, cand_cnts_n = scatter_cand(keep_neg, rank_neg)

    # ---- per-group 3K merge (K state + K insert + K delete candidates)
    m_vals = torch.cat([vals[touched], cand_vals_p, cand_vals_n], 1)
    m_cnts = torch.cat([cnts[touched], cand_cnts_p, cand_cnts_n], 1)
    m_valid = m_cnts != 0
    sort_idx = _lexsort_rows([order_key_plain(m_vals, is_max), ~m_valid])
    s_vals = torch.take_along_dim(m_vals, sort_idx, 1)
    s_cnts = torch.take_along_dim(m_cnts, sort_idx, 1)
    s_valid = torch.take_along_dim(m_valid, sort_idx, 1)
    # adjacent equal-value combine (state values and candidate values are
    # each distinct, so at most one duplicate pair per value)
    dup = (s_valid[:, 1:] & s_valid[:, :-1]
           & values_equal(s_vals[:, 1:], s_vals[:, :-1]))
    s_cnts[:, :-1] += torch.where(dup, s_cnts[:, 1:], 0)
    s_valid[:, 1:] &= ~dup
    # a negative residue is a delete of an untracked value
    neg = s_valid & (s_cnts < 0)
    err_neg = (neg & ~lossy2[touched][:, None]).sum(dtype=torch.int32)
    s_valid &= s_cnts > 0
    # resort (combined zeros and negatives drop out), keep the best K
    sort2 = _lexsort_rows([order_key_plain(s_vals, is_max), ~s_valid])
    f_vals = torch.take_along_dim(s_vals, sort2, 1)
    f_cnts = torch.take_along_dim(s_cnts, sort2, 1)
    f_valid = torch.take_along_dim(s_valid, sort2, 1)
    out_vals, out_cnts, lossy3 = vals.clone(), cnts.clone(), lossy2
    lossy3[touched] |= f_valid[:, K:].any(1)
    out_vals[touched] = torch.where(
        f_valid[:, :K], f_vals[:, :K],
        torch.zeros((), dtype=vals.dtype, device=dev))
    out_cnts[touched] = torch.where(f_valid[:, :K], f_cnts[:, :K],
                                    0).to(torch.int32)
    return (out_vals, out_cnts, lossy3), err_dropped_del + err_neg


def extrema_emit(state: tuple, init, dtype: torch.dtype) -> torch.Tensor:
    """Best value per group (the identity where the buffer is empty)."""
    vals, cnts, _ = state
    return torch.where(cnts[:, 0] > 0, vals[:, 0],
                       torch.tensor(init, dtype=dtype, device=vals.device))


def underflow_mask(state: tuple, row_count: torch.Tensor) -> torch.Tensor:
    """Groups with live rows, an empty buffer and lossy history: the
    extremum is unknowable without a durable refill."""
    _, cnts, lossy = state
    return (cnts[:, 0] <= 0) & lossy & (row_count > 0)


def extrema_underflow(state: tuple, row_count: torch.Tensor) -> torch.Tensor:
    """The JAX package's fail-stop count over every group."""
    return underflow_mask(state, row_count).sum(dtype=torch.int32)


def extrema_gather(state: tuple, sel: torch.Tensor, tgt: torch.Tensor,
                   C_new: int, K: int, dtype: torch.dtype) -> tuple:
    """Rehash support: move group sel[i]'s buffers to slot tgt[i]
    (tgt == C_new drops the row: a trash row, sliced off)."""
    vals, cnts, lossy = state
    e_vals, e_cnts, e_lossy = extrema_empty(C_new + 1, K, dtype, vals.device)
    e_vals[tgt] = vals[sel]
    e_cnts[tgt] = cnts[sel]
    e_lossy[tgt] = lossy[sel]
    return e_vals[:C_new], e_cnts[:C_new], e_lossy[:C_new]


def extrema_mask_keep(state: tuple, keep: torch.Tensor) -> None:
    """Watermark eviction, in place: zero the buffers of evicted groups."""
    vals, cnts, lossy = state
    vals.masked_fill_(~keep[:, None], 0)
    cnts.masked_fill_(~keep[:, None], 0)
    lossy &= keep


def extrema_apply_plain(state: tuple, values: torch.Tensor,
                        valid: Optional[torch.Tensor], ops: torch.Tensor,
                        slots: torch.Tensor, row_count: torch.Tensor,
                        is_max: bool, err: torch.Tensor) -> None:
    """Plain PyTorch version of kernel K26, in place: the chunk's rows
    (slot -1 = not applied) into the buffers by `extrema_update_plain`;
    its error count plus the underflow over the groups the chunk touched
    (rows with a slot, NULL values included) added to `err`. row_count
    already holds the chunk's rows."""
    vals = state[0]
    C = vals.shape[0]
    ok = slots >= 0
    seg = torch.where(ok, slots.to(torch.int64), C)
    signs = torch.where(ok, op_sign(ops), 0)
    valid_in = (torch.ones_like(ok) if valid is None else valid)
    new, n_err = extrema_update_plain(state, values.to(vals.dtype),
                                      valid_in, signs, seg, C, is_max)
    for dst, src in zip(state, new):
        dst.copy_(src)
    touched = torch.zeros(C + 1, dtype=torch.bool, device=vals.device)
    touched[seg] = True
    n_err = n_err + (touched[:C] & underflow_mask(state, row_count)).sum(
        dtype=torch.int32)
    err += n_err.to(err.dtype)


def extrema_apply(state: tuple, values: torch.Tensor,
                  valid: Optional[torch.Tensor], ops: torch.Tensor,
                  slots: torch.Tensor, row_count: torch.Tensor,
                  is_max: bool, err: torch.Tensor) -> None:
    """Kernel K26 on a CUDA device, the plain version on the CPU. Same
    contract as `extrema_apply_plain`."""
    vals, cnts, lossy = state
    dev = slots.device
    if dev.type == "cpu":
        return extrema_apply_plain(state, values, valid, ops, slots,
                                   row_count, is_max, err)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    N = slots.shape[0]
    C, K = vals.shape
    if slots.dtype != torch.int32 or ops.dtype != torch.int8 \
            or ops.shape[0] != N or values.shape[0] != N:
        raise ValueError("K26 takes int32 slots, int8 ops and values of "
                         "one length")
    if values.dtype not in _VALUE_CODES or not values.is_contiguous():
        raise ValueError(f"K26 cannot read an input column of {values.dtype}")
    is_float = vals.dtype == torch.float64
    if vals.dtype not in (torch.int64, torch.float64) \
            or is_float != values.is_floating_point():
        raise ValueError("K26 keeps int64 values of integer columns and "
                         "float64 values of float columns")
    if not 1 <= K <= MAX_K or cnts.dtype != torch.int32 \
            or cnts.shape != (C, K) or lossy.shape != (C,) \
            or not (vals.is_contiguous() and cnts.is_contiguous()):
        raise ValueError(f"K26 takes contiguous [C, K <= {MAX_K}] buffers")
    if err.dtype != torch.int32 or row_count.dtype != torch.int64:
        raise ValueError("err must be int32 and row_count int64")
    if valid is not None and (valid.dtype != torch.bool
                              or valid.shape[0] != N):
        raise ValueError("valid must be a bool mask of the chunk's rows")
    i64 = dict(dtype=torch.int64, device=dev)
    okey = torch.empty(N, **i64)
    skey = torch.empty(N, **i64)
    stream = kernels.stream_of(slots)
    vcode = _VALUE_CODES[values.dtype]
    K_EXTREMA.launches += 1
    K_EXTREMA.call("rw_extrema_keys", N, kernels.ptr(slots),
                   kernels.ptr(values), vcode, kernels.ptr_or_null(valid), C,
                   int(is_max), int(is_float), kernels.ptr(okey),
                   kernels.ptr(skey), stream)
    # (group key, order key) order by two stable K11 passes: the group key
    # is 2g for a group's valued rows, 2g + 1 for its NULL rows and 2C for
    # rows not applied
    _, perm = stable_sort(okey)
    skey_sorted, order = stable_sort(skey[perm], (2 * C).bit_length(), perm)
    K_EXTREMA.launches += 1
    K_EXTREMA.call("rw_extrema_merge", N, kernels.ptr(order),
                   kernels.ptr(skey_sorted), kernels.ptr(ops),
                   kernels.ptr(values),
                   vcode, C, K, int(is_max), int(is_float), kernels.ptr(vals),
                   kernels.ptr(cnts), kernels.ptr(lossy),
                   kernels.ptr(row_count), kernels.ptr(err), stream)
