"""Barrier snapshot-recompute for "join against your own aggregate" (port
of risingwave_tpu/stream/snapshot_join_agg.py, volatile state).

The shape (TPC-H q17):

    SELECT sum(L.x) / 7.0
    FROM L JOIN P ON P.k = L.fk
           JOIN (SELECT fk, 0.2*avg(q) AS thr FROM L GROUP BY fk) A
             ON A.fk = L.fk AND L.q < A.thr
    WHERE <filters on P>

Every input is append-only, so the sub-plan is a pure function of the
accumulated input prefixes: the executor appends both inputs to dense
device stores and, at each barrier that saw rows, recomputes the
per-group aggregates, the threshold predicate, the dim-key membership
and the global aggregates, then emits the one-row changelog diff
against the previous barrier (no retraction storm, no match buffers).

The device programs, per chunk and per barrier:

  append   kernel K14 (`csrc/snapshot_append.cu`): the ordered append of
           a chunk's inserted rows at the device-side count, with the
           overflow and retraction counters (dim side: only key-valid
           rows that pass the dim filter, which kernel K5 evaluates);
  keys     kernel K15 (`csrc/segment_agg.cu`, `rw_seg_keys`): the sort
           keys, NULL-key rows and dead slots pushed to int64-max;
  sort     kernel K11 (`csrc/radix_sort.cu`): the stable sort of the
           fact keys (and of the dim keys);
  reduce   kernel K15 (`rw_seg_take`, `rw_seg_reduce`): the gather of the
           used fact columns into key order, run boundaries -> group ids,
           per-group COUNT / SUM / append-only MIN / MAX with their
           validity and the group-existence mask; K5 evaluates the
           per-group items, which K15 gathers back to the rows;
  final    K5 evaluates the residue and the fact filter; kernel K16
           (`csrc/snapshot_final.cu`) does the dim membership by binary
           search, the masked global aggregates to one row, and (after
           K5's final items) the 2-row diff chunk, on the device with no
           host sync.

Each kernel's plain PyTorch version sits beside its wrapper, a line-for-
line port of the JAX code; a wrapper runs it only for CPU tensors. The
stores are updated in place (the JAX package re-binds donated buffers).

Errors accumulate on the device in `errs` [fact overflow, dim overflow,
retraction seen]; the watchdog (or `errs()`) reads them.

Left out of this slice (ROADMAP A10): durable state — `_persist` and
`recover`; passing `state_tables` raises NotImplementedError.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ..common.chunk import (
    Column, StreamChunk, OP_INSERT, OP_UPDATE_DELETE, OP_UPDATE_INSERT,
    op_sign,
)
from ..common.types import Field, Schema
from ..device import resolve_device
from ..expr.agg import AggCall, AggKind
from ..expr.program import TYPE_CODES, ExprProgram
from ..expr.ir import input_refs
from ..ops import kernels
from ..ops.sort import stable_sort
from .align import LEFT, barrier_align
from .executor import Executor
from .message import Barrier, BarrierKind

I64_MAX = (1 << 63) - 1

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_PP = ctypes.POINTER(ctypes.c_void_p)
_PI = ctypes.POINTER(ctypes.c_int)

# limits of the kernels' by-value argument tables (csrc/*.cu)
MAX_APPEND_COLS = 16
MAX_TAKE_COLS = 16
MAX_CALLS = 8
MAX_ITEMS = 8

# K14. Replaces stream/snapshot_join_agg.py:_append_fact_impl (173) and
# _append_dim_impl (194).
K_APPEND = kernels.register(kernels.CudaKernel(
    "snapshot_append",
    replaces="risingwave_tpu/stream/snapshot_join_agg.py:173",
    functions={"rw_snapshot_append": [
        _I, _PP, _PI, _PP, _PP, _PI, _PP, _P, _P, _P, _P, _P, _L, _L, _P,
        _P, _I, _P]}))

# K15. Replaces stream/snapshot_join_agg.py:_flush_impl (217), lines
# 222-263: sort keys, run boundaries -> gid, the per-group aggregates
# and the gathers by order and by gid.
K_SEGMENT = kernels.register(kernels.CudaKernel(
    "segment_agg",
    replaces="risingwave_tpu/stream/snapshot_join_agg.py:217",
    functions={
        "rw_seg_keys": [_P, _I, _P, _P, _L, _P, _P],
        "rw_seg_take": [_I, _PP, _PI, _PP, _PP, _PP, _P, _I, _L, _P],
        "rw_seg_blocks": [_L],
        "rw_seg_reduce": [_P, _P, _P, _P, _P, _I, _PI, _PP, _PI, _PI, _PP,
                          _PI, _PP, _PP, _PP, _PI, _PP, _P, _P, _P, _P, _L,
                          _P]}))

# K16. Replaces stream/snapshot_join_agg.py:_flush_impl (217), lines
# 265-322: dim membership, the masked global aggregates, the diff chunk.
K_FINAL = kernels.register(kernels.CudaKernel(
    "snapshot_final",
    replaces="risingwave_tpu/stream/snapshot_join_agg.py:265",
    functions={
        "rw_final_blocks": [_L],
        "rw_final_reduce": [_P, _P, _P, _P, _L, _P, _P, _P, _I, _PP, _PP,
                            _I, _PI, _PP, _PI, _PI, _PP, _PI, _PP, _PI,
                            _PP, _P, _L, _P],
        "rw_final_diff": [_I, _PP, _PP, _PI, _PP, _PP, _P, _PP, _PP, _P, _P,
                          _P]}))

_KIND_CODES = {AggKind.COUNT: 0, AggKind.SUM: 1, AggKind.MIN: 2,
               AggKind.MAX: 3}


def _device_of(t: torch.Tensor) -> str:
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


def _check_cols(ts, n: int, dev) -> None:
    for t in ts:
        if t is None:
            continue
        if t.device != dev or t.dim() != 1 or t.shape[0] != n \
                or not t.is_contiguous():
            raise ValueError("kernel columns must be contiguous 1-D "
                             "tensors of one length on one device")


def _type_code(dtype: torch.dtype) -> int:
    if dtype not in TYPE_CODES:
        raise NotImplementedError(f"no kernel type code for {dtype}")
    return TYPE_CODES[dtype]


def _bool_or_none(t):
    if t is not None and t.dtype != torch.bool:
        raise ValueError("masks must be bool tensors")
    return t


# ------------------------------------------------------------- K14 append

def append_rows_plain(dst_cols, dst_valids, count, errs, src_cols,
                      src_valids, vis, ops, masks, overflow_slot: int):
    """Plain PyTorch version of kernel K14 (JAX `_append_fact_impl` /
    `_append_dim_impl`): rows with vis & op>0 & every mask, in order, at
    the device-side count; overflow -> errs[overflow_slot], retractions
    -> errs[2]; the count clamped to capacity. Updates in place."""
    C = dst_cols[0].shape[0]
    sign = op_sign(ops)
    take = vis & (sign > 0)
    retract = (vis & (sign < 0)).to(torch.int32).sum(dtype=torch.int32)
    for m in masks:
        if m is not None:
            take = take & m
    rank = torch.cumsum(take.to(torch.int32), 0) - 1
    n_new = take.to(torch.int32).sum(dtype=torch.int32)
    fn = count.to(torch.int64)
    dest = torch.where(take & (fn + rank < C), fn + rank, C)
    overflow = torch.clamp(fn + n_new - C, min=0)
    keep = dest < C
    idx = dest[keep]
    for d, s in zip(dst_cols, src_cols):
        d[idx] = s[keep].to(d.dtype)
    for dv, sv in zip(dst_valids, src_valids):
        if dv is not None:
            dv[idx] = (torch.ones_like(keep) if sv is None else sv)[keep]
    count.copy_(torch.clamp(fn + n_new, max=C).to(torch.int32))
    errs[overflow_slot] += overflow.to(torch.int32)
    errs[2] += retract


def append_rows(dst_cols, dst_valids, count, errs, src_cols, src_valids,
                vis, ops, masks=(), overflow_slot: int = 0) -> None:
    """Append a chunk's rows to a store in place: kernel K14 (every
    column in one launch) on a CUDA device, the plain version on the
    CPU. `dst_valids[k]` None = the store keeps no validity for column
    k; `src_valids[k]` None = all valid; `masks` are extra bool masks
    AND-ed into the taken rows."""
    if _device_of(vis) == "cpu":
        return append_rows_plain(dst_cols, dst_valids, count, errs,
                                 src_cols, src_valids, vis, ops, masks,
                                 overflow_slot)
    dev = vis.device
    n, C = vis.shape[0], dst_cols[0].shape[0]
    if not 0 < len(dst_cols) <= MAX_APPEND_COLS \
            or len(src_cols) != len(dst_cols) or len(masks) > 3:
        raise ValueError("K14 takes 1-16 columns and up to 3 masks")
    _check_cols([vis, ops, *src_cols, *src_valids, *masks], n, dev)
    _check_cols([*dst_cols, *dst_valids], C, dev)
    for d, s in zip(dst_cols, src_cols):
        if d.dtype != s.dtype and (d.is_floating_point()
                                   or s.is_floating_point()):
            raise ValueError("K14 converts between integer widths only")
    if vis.dtype != torch.bool or ops.dtype != torch.int8 \
            or count.dtype != torch.int32 or errs.dtype != torch.int32:
        raise ValueError("K14: bool vis, int8 ops, int32 count and errs")
    for v in [*src_valids, *dst_valids, *masks]:
        _bool_or_none(v)
    m = list(masks) + [None] * (3 - len(masks))
    K_APPEND.launches += 1
    K_APPEND.call("rw_snapshot_append", len(dst_cols),
                  kernels.ptr_array(src_cols),
                  kernels.int_array(s.element_size() for s in src_cols),
                  kernels.ptr_array(src_valids), kernels.ptr_array(dst_cols),
                  kernels.int_array(d.element_size() for d in dst_cols),
                  kernels.ptr_array(dst_valids), kernels.ptr(vis),
                  kernels.ptr(ops), *(kernels.ptr_or_null(x) for x in m),
                  n, C, kernels.ptr(count), kernels.ptr(errs),
                  overflow_slot, kernels.stream_of(vis))


# ------------------------------------------------------------- K15 keys

def sort_keys_plain(key: torch.Tensor, valid: Optional[torch.Tensor],
                    count: torch.Tensor) -> torch.Tensor:
    """Plain version of K15's key pass: where(i < count & valid, key,
    int64-max) (JAX `skey`, and the dim side's `where(dlive, ...)`)."""
    C = key.shape[0]
    live = torch.arange(C, device=key.device) < count
    if valid is not None:
        live = live & valid
    return torch.where(live, key.to(torch.int64), I64_MAX)


def sort_keys(key: torch.Tensor, valid: Optional[torch.Tensor],
              count: torch.Tensor) -> torch.Tensor:
    """Kernel K15 (`rw_seg_keys`) on a CUDA device, the plain version on
    the CPU."""
    if _device_of(key) == "cpu":
        return sort_keys_plain(key, valid, count)
    C = key.shape[0]
    _check_cols([key, _bool_or_none(valid)], C, key.device)
    if key.is_floating_point() or key.element_size() not in (4, 8):
        raise ValueError("K15 keys are 32- or 64-bit integers")
    out = torch.empty(C, dtype=torch.int64, device=key.device)
    K_SEGMENT.launches += 1
    K_SEGMENT.call("rw_seg_keys", kernels.ptr(key), key.element_size(),
                   kernels.ptr_or_null(valid), kernels.ptr(count), C,
                   kernels.ptr(out), kernels.stream_of(key))
    return out


# ------------------------------------------------------------- K15 take

def take_rows_plain(cols, valids, idx):
    """Plain version of K15's gather: (c[idx] for c, v[idx] for v)."""
    ix = idx.to(torch.int64)
    return ([c[ix] for c in cols],
            [None if v is None else v[ix] for v in valids])


def take_rows(cols, valids, idx: torch.Tensor):
    """Every column and validity gathered by one index tensor (int32 or
    int64): kernel K15 (`rw_seg_take`, one launch) on a CUDA device, the
    plain version on the CPU."""
    if _device_of(idx) == "cpu":
        return take_rows_plain(cols, valids, idx)
    if not cols:
        return [], []
    if len(cols) > MAX_TAKE_COLS:
        raise ValueError("K15 gathers at most 16 columns a launch")
    if idx.dtype not in (torch.int32, torch.int64):
        raise ValueError("K15 indices are int32 or int64")
    dev, n = idx.device, idx.shape[0]
    _check_cols([idx], n, dev)
    src_n = cols[0].shape[0]
    _check_cols([*cols, *(_bool_or_none(v) for v in valids)], src_n, dev)
    out = [torch.empty(n, dtype=c.dtype, device=dev) for c in cols]
    out_v = [None if v is None else torch.empty(n, dtype=torch.bool,
                                                device=dev) for v in valids]
    K_SEGMENT.launches += 1
    K_SEGMENT.call("rw_seg_take", len(cols), kernels.ptr_array(cols),
                   kernels.int_array(c.element_size() for c in cols),
                   kernels.ptr_array(valids), kernels.ptr_array(out),
                   kernels.ptr_array(out_v), kernels.ptr(idx),
                   idx.element_size(), n, kernels.stream_of(idx))
    return out, out_v


# ----------------------------------------------------------- K15 reduce

def segment_reduce_plain(sfk, order, count, sub_pred, calls, cols_s,
                         valids_s):
    """Plain version of K15's reduce (JAX `_flush_impl` 222-263): run
    boundaries of the sorted keys -> int32 gid; per group, each call's
    partial with its validity (cnt > 0, COUNT always valid); the group-
    existence mask (some row with a nonzero sub sign). Returns (gid,
    [Column per call], gexists)."""
    C = sfk.shape[0]
    dev = sfk.device
    live_s = order < count
    newrun = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                        sfk[1:] != sfk[:-1]])
    gid = (torch.cumsum(newrun.to(torch.int64), 0) - 1).to(torch.int32)
    g64 = gid.to(torch.int64)
    sub_sign = live_s.to(torch.int32)
    if sub_pred is not None:
        sub_sign = torch.where(sub_pred.data.to(torch.bool)
                               & sub_pred.valid_mask(), sub_sign, 0)
    outs = []
    for call in calls:
        spec = call.spec()
        if call.arg is None:
            vals = torch.zeros(C, dtype=spec.state_dtype, device=dev)
            rs = sub_sign
        else:
            vals = cols_s[call.arg]
            rs = torch.where(valids_s[call.arg], sub_sign, 0)
        st = spec.partial(vals, rs, g64, C)
        cnt = torch.zeros(C, dtype=torch.int32, device=dev).index_add_(
            0, g64, (rs != 0).to(torch.int32))
        out_valid = (cnt > 0) if call.kind is not AggKind.COUNT \
            else torch.ones(C, dtype=torch.bool, device=dev)
        outs.append(Column(spec.emit(st), out_valid))
    gexists = torch.zeros(C, dtype=torch.int32, device=dev).index_add_(
        0, g64, (sub_sign != 0).to(torch.int32)) > 0
    return gid, outs, gexists


def _call_tables(calls: Sequence[AggCall], cols_s, valids_s, n: int, dev):
    """Per-call kernel argument tables: kind codes, argument pointers,
    widths, float flags and validity pointers, each call's state dtype
    and its result dtype."""
    kinds, args, widths, floats, valids, states, rets = [], [], [], [], \
        [], [], []
    for call in calls:
        spec = call.spec()
        ret = call.ret_type.torch_dtype
        _type_code(ret)
        kinds.append(_KIND_CODES[call.kind])
        states.append(spec.state_dtype)
        rets.append(ret)
        if call.arg is None:
            args.append(None)
            widths.append(8)
            floats.append(0)
            valids.append(None)
            continue
        a, v = cols_s[call.arg], valids_s[call.arg]
        _check_cols([a, _bool_or_none(v)], n, dev)
        if a.dtype not in TYPE_CODES or a.dtype == torch.bool:
            raise NotImplementedError(f"aggregate over {a.dtype}")
        if a.is_floating_point() and call.kind is not AggKind.COUNT \
                and spec.state_dtype != torch.float64:
            raise NotImplementedError("integer aggregate of a float column")
        args.append(a)
        widths.append(a.element_size())
        floats.append(int(a.is_floating_point()))
        valids.append(v)
    return kinds, args, widths, floats, valids, states, rets


def segment_reduce(sfk, order, count, sub_pred, calls, cols_s, valids_s):
    """Kernel K15 (`rw_seg_reduce`: four launches, no host sync) on a
    CUDA device, the plain version on the CPU. Same contract as
    `segment_reduce_plain`."""
    if _device_of(sfk) == "cpu":
        return segment_reduce_plain(sfk, order, count, sub_pred, calls,
                                    cols_s, valids_s)
    dev, C = sfk.device, sfk.shape[0]
    if len(calls) > MAX_CALLS:
        raise ValueError("K15 reduces at most 8 aggregates")
    if order.dtype != torch.int64 or sfk.dtype != torch.int64:
        raise ValueError("K15 takes int64 sorted keys and order")
    pd = pv = None
    if sub_pred is not None:
        pd, pv = sub_pred.data, sub_pred.valid
    _check_cols([sfk, order, _bool_or_none(pd), _bool_or_none(pv)], C, dev)
    kinds, args, widths, floats, valids, states, rets = _call_tables(
        calls, cols_s, valids_s, C, dev)
    state = [torch.empty(C, dtype=s, device=dev) for s in states]
    # a 64-bit result of the state's own type is emitted in place
    out = [st if st.dtype == r else torch.empty(C, dtype=r, device=dev)
           for st, r in zip(state, rets)]
    out_v = [torch.empty(C, dtype=torch.bool, device=dev) for _ in calls]
    cnt = [torch.empty(C, dtype=torch.int32, device=dev) for _ in calls]
    gid = torch.empty(C, dtype=torch.int32, device=dev)
    gcount = torch.empty(C, dtype=torch.int32, device=dev)
    gexists = torch.empty(C, dtype=torch.bool, device=dev)
    sums = torch.empty(K_SEGMENT.lib().rw_seg_blocks(C) + 1,
                       dtype=torch.int32, device=dev)
    K_SEGMENT.launches += 1
    K_SEGMENT.call("rw_seg_reduce", kernels.ptr(sfk), kernels.ptr(order),
                   kernels.ptr(count), kernels.ptr_or_null(pd),
                   kernels.ptr_or_null(pv), len(calls),
                   kernels.int_array(kinds), kernels.ptr_array(args),
                   kernels.int_array(widths), kernels.int_array(floats),
                   kernels.ptr_array(valids),
                   kernels.int_array(int(s == torch.float64)
                                     for s in states),
                   kernels.ptr_array(state), kernels.ptr_array(cnt),
                   kernels.ptr_array(out),
                   kernels.int_array(_type_code(r) for r in rets),
                   kernels.ptr_array(out_v), kernels.ptr(gid),
                   kernels.ptr(gcount), kernels.ptr(gexists),
                   kernels.ptr(sums), C, kernels.stream_of(sfk))
    return gid, [Column(o, v) for o, v in zip(out, out_v)], gexists


# ------------------------------------------------------------ K16 reduce

def final_reduce_plain(sfk, order, count, sd, dn, gexists, gid, preds,
                       calls, cols_s, valids_s):
    """Plain version of K16's reduce (JAX `_flush_impl` 265-310): the
    rows that are live, keep every predicate (bool Columns: the residue
    and the fact filter) and whose key is a member of the live dim keys
    (and of an existing group, when `gexists` is given) feed each call's
    global aggregate. Returns a 1-row Column per call (COUNT always
    valid, the rest valid when a row contributed)."""
    C, Cd = sfk.shape[0], sd.shape[0]
    dev = sfk.device
    live_s = order < count
    keep = torch.ones(C, dtype=torch.bool, device=dev)
    for p in preds:
        keep &= p.data.to(torch.bool) & p.valid_mask()
    pos = torch.searchsorted(sd, sfk)
    member = (sd[pos.clamp(0, Cd - 1)] == sfk) & (pos < dn)
    if gexists is not None:
        member &= gexists[gid.to(torch.int64)]
    msign = (live_s & keep & member).to(torch.int32)
    seg0 = torch.zeros(C, dtype=torch.int64, device=dev)
    outs = []
    for call in calls:
        spec = call.spec()
        if call.arg is None:
            vals = torch.zeros(C, dtype=spec.state_dtype, device=dev)
            rs = msign
        else:
            vals = cols_s[call.arg]
            rs = torch.where(valids_s[call.arg], msign, 0)
        st = spec.partial(vals, rs, seg0, 1)
        nz = (rs != 0).to(torch.int32).sum()
        out_valid = torch.ones(1, dtype=torch.bool, device=dev) \
            if call.kind is AggKind.COUNT else (nz > 0)[None]
        outs.append(Column(spec.emit(st), out_valid))
    return outs


def final_reduce(sfk, order, count, sd, dn, gexists, gid, preds, calls,
                 cols_s, valids_s):
    """Kernel K16 (`rw_final_reduce`: per-block partials in a fixed
    order, then one block; no atomics, no host sync) on a CUDA device,
    the plain version on the CPU."""
    if _device_of(sfk) == "cpu":
        return final_reduce_plain(sfk, order, count, sd, dn, gexists, gid,
                                  preds, calls, cols_s, valids_s)
    dev, C, Cd = sfk.device, sfk.shape[0], sd.shape[0]
    if len(calls) > MAX_CALLS or len(preds) > 2:
        raise ValueError("K16 takes at most 8 aggregates and 2 predicates")
    if Cd == 0:
        raise ValueError("K16 needs a dim store of at least one slot")
    pdata = [p.data for p in preds]
    pvalid = [p.valid for p in preds]
    _check_cols([sfk, order, gid, _bool_or_none(gexists), *pdata,
                 *(_bool_or_none(v) for v in pvalid)], C, dev)
    _check_cols([sd], Cd, dev)
    for d in pdata:
        _bool_or_none(d)
    kinds, args, widths, floats, valids, states, rets = _call_tables(
        calls, cols_s, valids_s, C, dev)
    out = [torch.empty(1, dtype=r, device=dev) for r in rets]
    out_v = [torch.empty(1, dtype=torch.bool, device=dev) for _ in calls]
    blocks = K_FINAL.lib().rw_final_blocks(C)
    partials = torch.empty(max(1, blocks * len(calls) * 2),
                           dtype=torch.int64, device=dev)
    K_FINAL.launches += 1
    K_FINAL.call("rw_final_reduce", kernels.ptr(sfk), kernels.ptr(order),
                 kernels.ptr(count), kernels.ptr(sd), Cd, kernels.ptr(dn),
                 kernels.ptr_or_null(gexists), kernels.ptr(gid), len(preds),
                 kernels.ptr_array(pdata), kernels.ptr_array(pvalid),
                 len(calls), kernels.int_array(kinds),
                 kernels.ptr_array(args), kernels.int_array(widths),
                 kernels.int_array(floats), kernels.ptr_array(valids),
                 kernels.int_array(int(s == torch.float64) for s in states),
                 kernels.ptr_array(out),
                 kernels.int_array(_type_code(r) for r in rets),
                 kernels.ptr_array(out_v), kernels.ptr(partials), C,
                 kernels.stream_of(sfk))
    return [Column(o, v) for o, v in zip(out, out_v)]


# -------------------------------------------------------------- K16 diff

def final_diff_plain(cur_cols, prev, prev_valid, emitted):
    """Plain version of K16's diff (JAX `_flush_impl` 311-322): the 2-row
    chunk [prev as U-, cur as U+] (or [-, Insert] before the first
    emission), both rows invisible when nothing changed. Updates prev,
    prev_valid and emitted in place; returns (columns, ops, vis)."""
    dev = emitted.device
    cur = [c.data[0] for c in cur_cols]
    cur_valid = [c.valid_mask()[0] for c in cur_cols]
    same = torch.ones((), dtype=torch.bool, device=dev)
    for a, b, av, bv in zip(prev, cur, prev_valid, cur_valid):
        same &= (av == bv) & ((a == b) | ~bv)
    changed = ~(emitted & same)
    ops = torch.where(
        emitted,
        torch.tensor([OP_UPDATE_DELETE, OP_UPDATE_INSERT], dtype=torch.int8,
                     device=dev),
        torch.tensor([OP_INSERT, OP_INSERT], dtype=torch.int8, device=dev))
    vis = torch.stack([changed & emitted, changed])
    cols = [Column(torch.stack([p, c]), torch.stack([pv, cv]))
            for p, c, pv, cv in zip(prev, cur, prev_valid, cur_valid)]
    for p, c, pv, cv in zip(prev, cur, prev_valid, cur_valid):
        p.copy_(c)
        pv.copy_(cv)
    emitted.fill_(True)
    return cols, ops, vis


def final_diff(cur_cols, prev, prev_valid, emitted):
    """Kernel K16 (`rw_final_diff`, one thread) on a CUDA device, the
    plain version on the CPU. Same contract as `final_diff_plain`."""
    if _device_of(emitted) == "cpu":
        return final_diff_plain(cur_cols, prev, prev_valid, emitted)
    dev = emitted.device
    if len(cur_cols) > MAX_ITEMS:
        raise ValueError("K16 diffs at most 8 output columns")
    for c, p in zip(cur_cols, prev):
        if c.data.dtype != p.dtype or c.data.device != dev:
            raise ValueError("K16: output and previous value types differ")
    cols = [Column(torch.empty(2, dtype=p.dtype, device=dev),
                   torch.empty(2, dtype=torch.bool, device=dev))
            for p in prev]
    ops = torch.empty(2, dtype=torch.int8, device=dev)
    vis = torch.empty(2, dtype=torch.bool, device=dev)
    K_FINAL.launches += 1
    K_FINAL.call("rw_final_diff", len(cur_cols),
                 kernels.ptr_array([c.data for c in cur_cols]),
                 kernels.ptr_array([c.valid for c in cur_cols]),
                 kernels.int_array(_type_code(p.dtype) for p in prev),
                 kernels.ptr_array(prev), kernels.ptr_array(prev_valid),
                 kernels.ptr(emitted), kernels.ptr_array([c.data for c in
                                                          cols]),
                 kernels.ptr_array([c.valid for c in cols]),
                 kernels.ptr(ops), kernels.ptr(vis),
                 kernels.stream_of(emitted))
    return cols, ops, vis


# -------------------------------------------------------------- executor

class SnapshotJoinAggExecutor(Executor):
    """Fused (L join dim join group-agg(L)) -> global agg, evaluated by
    snapshot recompute at barriers.

    fact (LEFT input): the append-only L stream; all rows accumulate.
    dim (RIGHT input): the append-only dimension stream; only its key
    column is stored (after `dim_filter`), and its key must be unique
    (the planner requires the source's declared primary key), so
    membership is a mask, never a row multiplier.
    """

    def __init__(self, fact: Executor, dim: Executor, *,
                 fact_key: int,
                 dim_key: int,
                 sub_agg_calls: Sequence[AggCall],
                 sub_items: Sequence,          # Expr over [sub agg outputs]
                 residue,                      # Expr over [L cols ++ sub items]
                 final_agg_calls: Sequence[AggCall],
                 final_items: Sequence,        # Expr over [final agg outputs]
                 out_names: Sequence[str],
                 out_types: Sequence,
                 fact_filter=None,             # Expr over L cols (fact side)
                 sub_filter=None,              # Expr over L cols (agg side)
                 dim_filter=None,              # Expr over dim cols
                 capacity: int = 1 << 17,
                 dim_capacity: int = 1 << 14,
                 state_tables: Optional[tuple] = None,
                 watchdog_interval: Optional[int] = 1,
                 device="cuda"):
        if state_tables:
            raise NotImplementedError(
                "durable snapshot-join-agg state (persist, recover) is not "
                "ported yet (ROADMAP A10)")
        if watchdog_interval not in (None, 1):
            raise ValueError(
                "watchdog_interval must be 1 (check before every flush) "
                "or None (transfer-free mode)")
        if len(fact.schema) > 63:
            raise ValueError(
                "snapshot-join-agg fact schema exceeds the 63-column "
                "validity bitmask used for persistence")
        self.device = resolve_device(device)
        self.inputs = (fact, dim)
        self.fact_key = fact_key
        self.dim_key = dim_key
        self.sub_agg_calls = tuple(sub_agg_calls)
        self.sub_items = tuple(sub_items)
        self.residue = residue
        self.final_agg_calls = tuple(final_agg_calls)
        self.final_items = tuple(final_items)
        self.fact_filter = fact_filter
        self.sub_filter = sub_filter
        self.dim_filter = dim_filter
        self.capacity = int(capacity)
        self.dim_capacity = int(dim_capacity)
        self.watchdog_interval = watchdog_interval
        self.schema = Schema(tuple(
            Field(n, t) for n, t in zip(out_names, out_types)))
        self.pk_indices = ()
        self.identity = "SnapshotJoinAgg"
        self._fact_schema = fact.schema
        nl = len(fact.schema)
        # the fact columns the flush reads (the rest are never gathered)
        used = set()
        for c in self.sub_agg_calls + self.final_agg_calls:
            if c.arg is not None:
                used.add(c.arg)
        for e in (residue, fact_filter, sub_filter):
            if e is not None:
                used |= {i for i in input_refs(e) if i < nl}
        self._used = sorted(used)
        # one K5 program per expression list
        prog = lambda es: ExprProgram(list(es)) if es else None
        self._dim_prog = prog([dim_filter] if dim_filter is not None else [])
        self._sub_filter_prog = prog([sub_filter] if sub_filter is not None
                                     else [])
        self._sub_items_prog = prog(self.sub_items)
        self._residue_prog = prog([residue] if residue is not None else [])
        self._fact_filter_prog = prog([fact_filter]
                                      if fact_filter is not None else [])
        self._final_prog = prog(self.final_items)
        self._init_stores()
        dev = self.device
        # previous emission, on the device: a barrier costs no transfer
        # in watchdog-free mode
        self._prev = tuple(torch.zeros((), dtype=t.torch_dtype, device=dev)
                           for t in out_types)
        self._prev_valid = tuple(torch.zeros((), dtype=torch.bool,
                                             device=dev) for _ in out_types)
        self._emitted = torch.zeros((), dtype=torch.bool, device=dev)
        # errs[0] = fact overflow, errs[1] = dim overflow, errs[2] =
        # retraction seen on an append-only input
        self._errs = torch.zeros(3, dtype=torch.int32, device=dev)
        self._dirty = False
        # host upper bounds for the growth trigger (no transfer per chunk)
        self._applied_rows_upper = 0
        self._applied_dim_upper = 0

    # ------------------------------------------------------------- state
    def _init_stores(self) -> None:
        C, Cd, dev = self.capacity, self.dim_capacity, self.device
        self._fcols = tuple(
            torch.zeros(C, dtype=f.data_type.torch_dtype, device=dev)
            for f in self._fact_schema)
        self._fvalids = tuple(torch.zeros(C, dtype=torch.bool, device=dev)
                              for _ in self._fact_schema)
        self._fn = torch.zeros((), dtype=torch.int32, device=dev)
        self._dkeys = torch.zeros(Cd, dtype=torch.int64, device=dev)
        self._dn = torch.zeros((), dtype=torch.int32, device=dev)

    def fence_tokens(self) -> list:
        return [self._fn, self._dn, self._emitted]

    def errs(self) -> list[int]:
        """[fact overflow, dim overflow, retractions] (one fetch)."""
        return [int(x) for x in self._errs.cpu()]

    # ----------------------------------------------------------- appends
    def _append_fact(self, chunk: StreamChunk) -> None:
        append_rows(list(self._fcols), list(self._fvalids), self._fn,
                    self._errs, [c.data for c in chunk.columns],
                    [c.valid for c in chunk.columns], chunk.vis, chunk.ops,
                    (), overflow_slot=0)

    def _append_dim(self, chunk: StreamChunk) -> None:
        kcol = chunk.columns[self.dim_key]
        masks = [kcol.valid]
        if self._dim_prog is not None:
            p = self._dim_prog.eval(list(chunk.columns))[0]
            masks += [p.data.to(torch.bool), p.valid]
        append_rows([self._dkeys], [None], self._dn, self._errs,
                    [kcol.data], [None], chunk.vis, chunk.ops, masks,
                    overflow_slot=1)

    # ------------------------------------------------------------- flush
    def _flush(self) -> StreamChunk:
        fcols, fvalids = self._fcols, self._fvalids
        skey = sort_keys(fcols[self.fact_key], fvalids[self.fact_key],
                         self._fn)
        sfk, order = stable_sort(skey)
        cols_u, valids_u = take_rows([fcols[i] for i in self._used],
                                     [fvalids[i] for i in self._used],
                                     order)
        # the fact columns in key order; a column no expression reads
        # keeps its store tensor as a placeholder
        cols_s, valids_s = list(fcols), list(fvalids)
        for i, c, v in zip(self._used, cols_u, valids_u):
            cols_s[i], valids_s[i] = c, v
        env_fact = [Column(c, v) for c, v in zip(cols_s, valids_s)]
        sub_pred = (self._sub_filter_prog.eval(env_fact)[0]
                    if self._sub_filter_prog is not None else None)
        gid, sub_outs, gexists = segment_reduce(
            sfk, order, self._fn, sub_pred, self.sub_agg_calls, cols_s,
            valids_s)
        row_sub = []
        if self._sub_items_prog is not None:
            items = self._sub_items_prog.eval(sub_outs)
            data, valid = take_rows([c.data for c in items],
                                    [c.valid for c in items], gid)
            row_sub = [Column(d, v) for d, v in zip(data, valid)]
        preds = []
        if self._residue_prog is not None:
            preds.append(self._residue_prog.eval(env_fact + row_sub)[0])
        if self._fact_filter_prog is not None:
            preds.append(self._fact_filter_prog.eval(env_fact)[0])
        sd, _ = stable_sort(sort_keys(self._dkeys, None, self._dn))
        fin_outs = final_reduce(
            sfk, order, self._fn, sd, self._dn,
            gexists if self.sub_filter is not None else None, gid, preds,
            self.final_agg_calls, cols_s, valids_s)
        cur = self._final_prog.eval(fin_outs)
        cols, ops, vis = final_diff(cur, self._prev, self._prev_valid,
                                    self._emitted)
        return StreamChunk(tuple(cols), ops, vis, self.schema)

    # ------------------------------------------------------- housekeeping
    def _check_watchdog(self) -> None:
        errs = self.errs()
        if errs[0]:
            raise RuntimeError(
                f"snapshot-join-agg fact store overflow ({errs[0]} rows "
                f"dropped; capacity {self.capacity})")
        if errs[1]:
            raise RuntimeError(
                f"snapshot-join-agg dim store overflow ({errs[1]} rows "
                f"dropped; capacity {self.dim_capacity})")
        if errs[2]:
            raise RuntimeError(
                "snapshot-join-agg saw retractions on an append-only "
                "input — the planner must not fuse retracting inputs")

    def _maybe_grow(self) -> None:
        """Double the stores while the live count crowds capacity (reads
        the true device counts); the columns are padded, the counts
        stay."""
        def pad(a, cap):
            return torch.cat([a, torch.zeros(cap - a.shape[0],
                                             dtype=a.dtype,
                                             device=a.device)])
        n = int(self._fn)
        grew = False
        while n > 0.7 * self.capacity:
            self.capacity *= 2
            grew = True
        if grew:
            self._fcols = tuple(pad(c, self.capacity) for c in self._fcols)
            self._fvalids = tuple(pad(v, self.capacity)
                                  for v in self._fvalids)
        nd = int(self._dn)
        grew_d = False
        while nd > 0.7 * self.dim_capacity:
            self.dim_capacity *= 2
            grew_d = True
        if grew_d:
            self._dkeys = pad(self._dkeys, self.dim_capacity)

    # ------------------------------------------------------------ stream
    async def execute(self):
        first = True
        async for kind, s, msg in barrier_align(*self.inputs):
            if kind == "chunk":
                if s == LEFT:
                    self._append_fact(msg)
                    self._applied_rows_upper += msg.capacity
                else:
                    self._append_dim(msg)
                    self._applied_dim_upper += msg.capacity
                if self.watchdog_interval is None and (
                        self._applied_rows_upper > 0.9 * self.capacity
                        or self._applied_dim_upper
                        > 0.9 * self.dim_capacity):
                    # growth needs the true counts: without the
                    # watchdog's barrier fetch, pay one here instead of
                    # overflowing (and surface pending errors, which
                    # this mode must never swallow)
                    self._check_watchdog()
                    self._maybe_grow()
                    self._applied_rows_upper = int(self._fn)
                    self._applied_dim_upper = int(self._dn)
                self._dirty = True
            elif kind == "barrier":
                barrier: Barrier = msg
                if first or barrier.kind is BarrierKind.INITIAL:
                    first = False
                    yield barrier
                    continue
                stopping = barrier.mutation is not None \
                    and barrier.is_stop_any()
                if self._dirty:
                    self._dirty = False
                    if self.watchdog_interval:
                        self._check_watchdog()
                        self._maybe_grow()
                    yield self._flush()
                elif stopping and self.watchdog_interval:
                    self._check_watchdog()
                yield barrier
            # watermarks do not pass a global aggregate (no group column
            # survives), as in SimpleAgg
