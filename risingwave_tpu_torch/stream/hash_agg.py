"""HashAgg executor — grouped streaming aggregation with device state
(port of risingwave_tpu/stream/hash_agg.py).

The group map is a `HashTable` on the device plus parallel state tensors
(one per agg call), a row count and dirty bits. A linear call (COUNT,
SUM, MIN/MAX over append-only input) keeps one value per group; a MIN or
MAX over retracting input keeps a buffer of its group's K best distinct
values with their counts and a lossy flag (`ops/extrema.py`, the
reference's materialized-input state). Applying a chunk is kernel K3
(slot per row, `ops/hash_table.py`), kernel K4 (`csrc/hash_agg.cu`:
signed counts into row_count and each linear call's state, dirty bits,
the overflow accumulator), kernel K30 (`csrc/hll_update.cu`) per
approx_count_distinct sketch (its 8 HLL_REG calls in one launch), then
kernel K26 (`csrc/extrema_update.cu`) per retractable call on the same
slots, its errors added to the overflow accumulator; all on the device. At a barrier kernel K12
compacts the dirty slots and kernel K27 (`csrc/agg_flush.cu`) lays out
UpdateDelete / UpdateInsert pairs (Insert for born groups, Delete for
died ones), as the reference's changelog contract says. Watermark
eviction and rehash are plain PyTorch around K3 and K12 for now (ROADMAP
Queue B8).

Durable state (a state table of keys ++ per call its state, or for a
retractable call its K values, K counts and lossy flag ++ row_count): at
each barrier, BEFORE the flush resets the dirty bits, kernel K18
(`csrc/persist_view.cu`) compacts the dirty groups' rows (and the keys
of groups the cleaning watermark evicts) into one packed int64 buffer;
the counts and then the rows are fetched through the store's
deferred-flush stages, so with a pipelined checkpoint the fetch and the
state-table write run behind the stream. Recovery at the first barrier
re-inserts the stored groups through K3 and scatters their states.

State updates happen in place where the JAX package donated the state
buffers to its jitted programs.

Left out of this slice (ROADMAP Queue A): the memory manager (LRU
stamps, spill, reload) and the batched interval scan
(`_make_apply_scan`).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, replace
from typing import Optional, Sequence

import numpy as np
import torch

from ..common.chunk import (
    Column, StreamChunk, OP_DELETE, OP_INSERT, OP_UPDATE_DELETE,
    OP_UPDATE_INSERT, op_sign,
)
from ..common.types import Field, Schema
from ..device import resolve_device
from ..expr.agg import AggCall, AggKind, AggSpec
from ..expr.hll import hll_update, sketch_groups
from ..ops import kernels
from ..ops.extrema import (
    extrema_apply, extrema_emit, extrema_empty, extrema_gather,
    extrema_mask_keep, extrema_row_layout, values_equal,
)
from ..ops import hash_table as ht
from ..ops.hash_table import (
    HashTable, compact_mask, compact_mask_plain, lookup_or_insert,
    needs_rebuild,
)
from ..state.state_table import StateTable
from ..utils.d2h import PendingFetch, pack_rows, unpack_rows
from .executor import Executor
from .message import Barrier, BarrierKind, Watermark


@dataclass
class AggState:
    """Device state of one HashAgg instance (all tensors share capacity C)."""

    table: HashTable
    # per agg call: a [C] state, or for a retractable MIN/MAX its
    # (vals [C, K], cnts [C, K], lossy [C]) buffers
    agg_states: tuple
    row_count: torch.Tensor               # int64 [C] — group liveness
    dirty: torch.Tensor                   # bool [C] — touched since flush
    prev_exists: torch.Tensor             # bool [C] — group was in output
    prev_emit: tuple[torch.Tensor, ...]   # last emitted value per agg [C]


# ---------------------------------------------------------------- K4
# per-call state kinds of csrc/hash_agg.cu
_KIND_CODES = {
    (AggKind.COUNT, torch.int64): 0,
    (AggKind.SUM, torch.int64): 1,
    (AggKind.SUM, torch.float64): 2,
    (AggKind.MIN, torch.int64): 3,
    (AggKind.MAX, torch.int64): 4,
    (AggKind.MIN, torch.float64): 5,
    (AggKind.MAX, torch.float64): 6,
}
_VALUE_CODES = {None: 0, torch.int32: 1, torch.int64: 2, torch.float32: 3,
                torch.float64: 4}
MAX_CALLS = 32  # agg calls one K4 or K27 launch takes

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_PP = ctypes.POINTER(_P)
_PI = ctypes.POINTER(_I)
MAX_PERSIST_COLS = 64   # column groups one K18 scatter takes

# K4. Replaces stream/hash_agg.py:HashAggExecutor._apply_impl (248) with
# expr/agg.py:AggSpec.partial (74) / combine (93).
K_AGG = kernels.register(kernels.CudaKernel(
    "hash_agg",
    replaces="risingwave_tpu/stream/hash_agg.py:248",
    functions={"rw_agg_apply": [
        _P, _P, _I, _P, _P, _I, ctypes.POINTER(_I), ctypes.POINTER(_P),
        ctypes.POINTER(_P), ctypes.POINTER(_I), ctypes.POINTER(_P),
        _P, _P, _P]}))


def _call_inputs(calls: Sequence[AggCall], chunk_cols: Sequence[Column]):
    """(values, valid) per call; (None, None) for count(*)."""
    out = []
    for call in calls:
        if call.arg is None:
            out.append((None, None))
        else:
            col = chunk_cols[call.arg]
            out.append((col.data, col.valid))
    return out


def agg_apply_plain(state: AggState, specs: Sequence[AggSpec],
                    slots: torch.Tensor, ops: torch.Tensor,
                    inputs, n_unresolved: torch.Tensor,
                    overflow: torch.Tensor) -> None:
    """Plain PyTorch version of kernel K4, in place: signed segment count
    into row_count, each call's partial combined into its state, dirty
    bits for every touched slot, n_unresolved added to overflow."""
    C = state.table.capacity
    ok = slots >= 0
    seg = torch.where(ok, slots, C).to(torch.int64)   # trash segment C
    signs = torch.where(ok, op_sign(ops), 0).to(torch.int32)
    counts = torch.zeros(C + 1, dtype=torch.int64, device=slots.device)
    state.row_count += counts.index_add_(0, seg, signs.to(torch.int64))[:C]
    for spec, st, (values, valid) in zip(specs, state.agg_states, inputs):
        if values is None:
            values = torch.zeros(slots.shape[0], dtype=spec.state_dtype,
                                 device=slots.device)
        row_signs = signs if valid is None else torch.where(valid, signs, 0)
        part = spec.partial(values, row_signs, seg, C + 1)[:C]
        st.copy_(spec.combine(st, part))
    state.dirty[seg[ok]] = True
    overflow += n_unresolved.to(overflow.dtype)


def agg_apply(state: AggState, specs: Sequence[AggSpec],
              slots: torch.Tensor, ops: torch.Tensor, inputs,
              n_unresolved: torch.Tensor, overflow: torch.Tensor) -> None:
    """Kernel K4 on a CUDA device, the plain version on the CPU."""
    dev = slots.device
    if dev.type == "cpu":
        return agg_apply_plain(state, specs, slots, ops, inputs,
                               n_unresolved, overflow)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    N = slots.shape[0]
    if slots.dtype != torch.int32 or ops.dtype != torch.int8 \
            or ops.shape[0] != N:
        raise ValueError("K4 takes int32 slots and int8 ops of one length")
    kinds, value_codes, values, valids = [], [], [], []
    for spec, st, (v, valid) in zip(specs, state.agg_states, inputs):
        kinds.append(_KIND_CODES[(spec.call.kind, spec.state_dtype)])
        if spec.call.kind is AggKind.COUNT:
            v = None        # a count reads only validity (bool_and's arg)
        if v is not None and (v.dtype not in _VALUE_CODES or v.shape[0] != N
                              or not v.is_contiguous()):
            raise ValueError(f"K4 cannot read an input column of {v.dtype}")
        value_codes.append(_VALUE_CODES[None if v is None else v.dtype])
        values.append(v)
        valids.append(valid)
    if overflow.dtype != torch.int32 or n_unresolved.dtype != torch.int32:
        raise ValueError("overflow and n_unresolved must be int32")
    states = state.agg_states
    # MAX_CALLS calls a launch; the first also counts rows and marks dirty
    for lo in range(0, max(1, len(specs)), MAX_CALLS):
        hi = lo + MAX_CALLS
        K_AGG.launches += 1
        K_AGG.call("rw_agg_apply", kernels.ptr(slots), kernels.ptr(ops), N,
                   kernels.ptr(state.row_count) if lo == 0 else None,
                   kernels.ptr(state.dirty), len(kinds[lo:hi]),
                   kernels.int_array(kinds[lo:hi]),
                   kernels.ptr_array(states[lo:hi]),
                   kernels.ptr_array(values[lo:hi]),
                   kernels.int_array(value_codes[lo:hi]),
                   kernels.ptr_array(valids[lo:hi]),
                   kernels.ptr(n_unresolved), kernels.ptr(overflow),
                   kernels.stream_of(slots))


# ---------------------------------------------------------------- K18
# Replaces stream/hash_agg.py:_persist_view_impl (891) with
# _durable_cols_at (906), and _evict_keys_impl (358).
K_PERSIST = kernels.register(kernels.CudaKernel(
    "persist_view",
    replaces="risingwave_tpu/stream/hash_agg.py:891",
    functions={
        "rw_persist_view": [_L, _P, _P, _P, _I, _PP, _PI, _PI, _PI, _I, _I,
                            _I, _P, _P, _P, _P],
        "rw_evict_keys": [_L, _P, _P, _I, _PP, _PI, _I, _L, _P, _P, _P,
                          _I, _P, _P],
        "rw_pv_sums": [_L]}))


def _np_dtype(dt: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dt).numpy().dtype


def call_parts(st) -> list:
    """One call's state in the durable agg row, as (tensor, lanes) in the
    row's order: a [C] state is one lane; a retractable call's buffers
    come in `extrema_row_layout`'s order and widths."""
    if not isinstance(st, tuple):
        return [(st, 1)]
    layout = extrema_row_layout(0, st[0].shape[1])
    return [(t, len(names)) for t, names in zip(st, layout)]


def _durable_dtype(t: torch.Tensor) -> torch.dtype:
    """A state part's column type in the durable row: floats as they are,
    integers and flags widened to int64."""
    return t.dtype if t.is_floating_point() else torch.int64


def durable_cols_at(state: AggState, sel: torch.Tensor) -> list:
    """Durable-row columns gathered at `sel`: keys ++ each call's parts,
    lane by lane (`call_parts`) ++ row_count."""
    cols = [tk[sel] for tk in state.table.keys]
    for st in state.agg_states:
        for t, lanes in call_parts(st):
            dt = _durable_dtype(t)
            cols += ([t[sel].to(dt)] if t.dim() == 1
                     else [t[sel, k].to(dt) for k in range(lanes)])
    return cols + [state.row_count[sel]]


def persist_view_plain(state: AggState):
    """Plain PyTorch version of K18's persist entry, step by step as the
    JAX package's `_persist_view_impl`: the rows of the groups touched
    since the last flush, compacted in slot order. Returns (cols, ops,
    vis, n_dirty); ops = Insert where the group lives, else Delete; vis =
    it lives now or lived at the last flush."""
    C = state.table.capacity
    exists_now = state.row_count > 0
    d_slot, n_dirty = compact_mask_plain(state.dirty)
    is_dirty = torch.arange(C, device=d_slot.device) < n_dirty
    exists = exists_now[d_slot]
    existed = state.prev_exists[d_slot]
    vis = is_dirty & (exists | existed)
    ops = torch.where(exists, OP_INSERT, OP_DELETE).to(torch.int8)
    return durable_cols_at(state, d_slot), ops, vis, n_dirty


def evict_keys_plain(state: AggState, j: int, watermark: int):
    """Plain PyTorch version of K18's evict entry (the JAX package's
    `_evict_keys_impl`): the compacted keys of live groups whose key j
    lies below the cleaning watermark. Returns (keys, n)."""
    evict = (state.table.occupied & (state.table.keys[j] < watermark)
             & (state.row_count > 0))
    sel, n = compact_mask_plain(evict)
    return [tk[sel] for tk in state.table.keys], n


def persist_pack_plain(state: AggState, j: Optional[int],
                       watermark: Optional[int]):
    """The plain versions in K18's output layout: (buffer, counts). The
    buffer holds n_dirty persist rows of 2 + (durable columns) lanes
    (ops, vis, columns), then n_evict rows of the nk key lanes; counts =
    [n_dirty, n_evict] on the device. Entries past them are 0."""
    C = state.table.capacity
    nk = len(state.table.keys)
    dev = state.row_count.device
    cols, ops, vis, nd = persist_view_plain(state)
    p_rows = pack_rows([ops, vis, *cols])
    wp = p_rows.shape[0] // C
    buf = torch.zeros(C * wp + C * nk + 1, dtype=torch.int64, device=dev)
    trash = buf.shape[0] - 1
    ar = torch.arange(C * wp, device=dev)
    buf[torch.where(ar < nd * wp, ar, trash)] = p_rows
    nev = torch.zeros((), dtype=torch.int64, device=dev)
    if j is not None:
        keys, nev = evict_keys_plain(state, j, watermark)
        ar = torch.arange(C * nk, device=dev)
        buf[torch.where(ar < nev * nk, nd * wp + ar, trash)] = \
            pack_rows(keys)
    return buf[:trash], torch.stack([nd, nev])


def _column_groups(state: AggState) -> list:
    """The durable columns as K18's column groups: (tensor, lanes,
    stride), lane l of slot i at element i * stride + l. A [C] tensor is
    one lane; a retractable call's [C, K] values and counts are K lanes
    each, read in place."""
    groups = [(k, 1, 1) for k in state.table.keys]
    for st in state.agg_states:
        groups += [(t, lanes, lanes) for t, lanes in call_parts(st)]
    return groups


def persist_pack(state: AggState, j: Optional[int],
                 watermark: Optional[int]):
    """Kernel K18 on a CUDA device (the persist entry, then the evict
    entry when j is given), the plain version on the CPU. Same contract
    as `persist_pack_plain`, except that entries past the counted rows
    are unspecified."""
    dev = state.row_count.device
    if dev.type == "cpu":
        return persist_pack_plain(state, j, watermark)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    C = state.table.capacity
    keys = list(state.table.keys)
    groups = _column_groups(state)
    nk = len(keys)
    for t, lanes, _ in groups:
        if t.shape[0] != C or t.numel() != C * lanes \
                or not t.is_contiguous() or t.dtype == torch.float32:
            raise ValueError("K18 gathers contiguous [C] or [C, K] columns "
                             "of integer, bool or float64 state")
    wp = 2 + sum(lanes for _, lanes, _ in groups) + 1
    i64 = dict(dtype=torch.int64, device=dev)
    buf = torch.empty(C * wp + C * nk, **i64)
    counts = torch.zeros(2, **i64)
    sums = torch.empty(K_PERSIST.lib().rw_pv_sums(C), dtype=torch.int32,
                       device=dev)
    stream = kernels.stream_of(state.row_count)
    key_widths = kernels.int_array(k.element_size() for k in keys)
    # MAX_PERSIST_COLS groups a launch, each at its lanes' offset in the
    # row; the first also counts and scans the dirty slots
    lane_at = 2
    for lo in range(0, len(groups), MAX_PERSIST_COLS):
        part = groups[lo:lo + MAX_PERSIST_COLS]
        K_PERSIST.launches += 1
        K_PERSIST.call("rw_persist_view", C, kernels.ptr(state.dirty),
                       kernels.ptr(state.row_count),
                       kernels.ptr(state.prev_exists), len(part),
                       kernels.ptr_array(t for t, _, _ in part),
                       kernels.int_array(t.element_size() for t, _, _ in part),
                       kernels.int_array(lanes for _, lanes, _ in part),
                       kernels.int_array(stride for _, _, stride in part),
                       lane_at, wp, int(lo == 0), kernels.ptr(sums),
                       kernels.ptr(buf), kernels.ptr(counts[0:1]), stream)
        lane_at += sum(lanes for _, lanes, _ in part)
    if j is not None:
        sums2 = torch.empty_like(sums)
        K_PERSIST.launches += 1
        K_PERSIST.call("rw_evict_keys", C, kernels.ptr(state.table.occupied),
                       kernels.ptr(state.row_count), nk,
                       kernels.ptr_array(keys), key_widths, j, int(watermark),
                       kernels.ptr(sums2), kernels.ptr(buf),
                       kernels.ptr(counts[0:1]), wp,
                       kernels.ptr(counts[1:2]), stream)
    return buf, counts


# ---------------------------------------------------------------- K27
# Replaces stream/hash_agg.py:_flush_impl (300) with
# ops/extrema.py:extrema_emit (156).
K_FLUSH = kernels.register(kernels.CudaKernel(
    "agg_flush",
    replaces="risingwave_tpu/stream/hash_agg.py:300",
    functions={"rw_agg_flush": [
        _L, _P, _P, _P, _P, _P, _I, _PP, _PI, _PP, _I, _PI, _PP, _PP, _PI,
        _PI, ctypes.POINTER(_L), _PI, _PP, _PP, _P, _P, _P, _I, _I, _P]}))

_RET_CODES = {torch.int32: 1, torch.int64: 2, torch.float32: 3,
              torch.float64: 4}


def call_emit(spec: AggSpec, st) -> torch.Tensor:
    """A call's emitted value per slot, in its output type: the state of
    a linear call, the buffer head (or the identity) of a retractable
    one."""
    if isinstance(st, tuple):
        st = extrema_emit(st, spec.init, spec.state_dtype)
    return spec.emit(st)


def agg_flush_plain(state: AggState, specs: Sequence[AggSpec]):
    """Plain PyTorch version of K12 then kernel K27: the barrier diff as
    one chunk of 2C rows, dirty rank j at rows 2j (old values) and 2j + 1
    (new), the rows past the dirty ranks invisible zeros; then the dirty
    slots' prev_exists and prev_emit refreshed and their dirty bits
    cleared, in place. Returns (cols, ops, vis)."""
    C = state.table.capacity
    dev = state.row_count.device
    d_slot, n_dirty = compact_mask_plain(state.dirty)
    is_dirty = torch.arange(C, device=dev) < n_dirty
    existed = state.prev_exists[d_slot]
    exists = (state.row_count > 0)[d_slot]
    cur = [call_emit(sp, st)[d_slot]
           for sp, st in zip(specs, state.agg_states)]
    old = [pe[d_slot] for pe in state.prev_emit]
    # no-change skip (reference agg_group.rs build_change -> NoChange)
    unchanged = existed & exists
    for c, o in zip(cur, old):
        unchanged &= values_equal(c, o)
    zero = torch.zeros((), dtype=torch.bool, device=dev)

    def interleave(a, b):
        a = torch.where(is_dirty, a, zero.to(a.dtype))
        b = torch.where(is_dirty, b, zero.to(b.dtype))
        return torch.stack([a, b], dim=1).reshape(2 * C)

    ops_old = torch.where(is_dirty & exists, OP_UPDATE_DELETE, OP_DELETE)
    ops_new = torch.where(is_dirty & existed, OP_UPDATE_INSERT, OP_INSERT)
    out_ops = torch.stack([ops_old, ops_new], dim=1).reshape(2 * C).to(
        torch.int8)
    out_vis = interleave(existed & ~unchanged, exists & ~unchanged)
    out_cols = [interleave(tk[d_slot], tk[d_slot])
                for tk in state.table.keys]
    out_cols += [interleave(o, c) for o, c in zip(old, cur)]
    # refresh the dirty slots through a trash row C
    tgt = torch.where(is_dirty, d_slot, C)

    def refresh(dst, src):
        pad = torch.cat([dst, dst[:1]])
        pad[tgt] = src
        dst.copy_(pad[:C])

    refresh(state.prev_exists, exists)
    for pe, c in zip(state.prev_emit, cur):
        refresh(pe, c)
    refresh(state.dirty, torch.zeros_like(exists))
    return tuple(out_cols), out_ops, out_vis


def agg_flush(state: AggState, specs: Sequence[AggSpec]):
    """K12 then kernel K27 on a CUDA device, the plain version on the
    CPU. Same contract as `agg_flush_plain`."""
    dev = state.row_count.device
    if dev.type == "cpu":
        return agg_flush_plain(state, specs)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    C = state.table.capacity
    keys = state.table.keys
    if len(keys) > ht.MAX_KEY_COLUMNS:
        raise ValueError(f"K27 takes at most {ht.MAX_KEY_COLUMNS} keys")
    kinds, states, cnts, ks, floats, inits, rets, outs = \
        [], [], [], [], [], [], [], []
    for sp, st, pe in zip(specs, state.agg_states, state.prev_emit):
        ext = isinstance(st, tuple)
        v = st[0] if ext else st
        if v.dtype not in (torch.int64, torch.float64) \
                or pe.dtype not in _RET_CODES or pe.shape != (C,) \
                or (v.dtype == torch.float64) != pe.is_floating_point():
            raise ValueError("K27 takes int64 state to an int32 or int64 "
                             "output, float64 state to a float output")
        kinds.append(int(ext))
        states.append(v)
        cnts.append(st[1] if ext else None)
        ks.append(v.shape[1] if ext else 0)
        floats.append(int(v.dtype == torch.float64))
        init = torch.tensor(sp.init, dtype=v.dtype)
        inits.append(int(init.view(torch.int64)))
        rets.append(_RET_CODES[pe.dtype])
        outs.append(torch.empty(2 * C, dtype=pe.dtype, device=dev))
    key_out = [torch.empty(2 * C, dtype=k.dtype, device=dev) for k in keys]
    out_ops = torch.empty(2 * C, dtype=torch.int8, device=dev)
    out_vis = torch.empty(2 * C, dtype=torch.bool, device=dev)
    d_slot, n_dirty = compact_mask(state.dirty)
    # MAX_CALLS calls a launch, chained through eq; the last writes the rest
    starts = list(range(0, max(1, len(specs)), MAX_CALLS))
    eq = (torch.empty(C, dtype=torch.bool, device=dev) if len(starts) > 1
          else None)
    for lo in starts:
        hi = lo + MAX_CALLS
        K_FLUSH.launches += 1
        K_FLUSH.call("rw_agg_flush", C, kernels.ptr(d_slot),
                     kernels.ptr(n_dirty), kernels.ptr(state.row_count),
                     kernels.ptr(state.dirty), kernels.ptr(state.prev_exists),
                     len(keys), kernels.ptr_array(keys),
                     kernels.int_array(k.element_size() for k in keys),
                     kernels.ptr_array(key_out), len(kinds[lo:hi]),
                     kernels.int_array(kinds[lo:hi]),
                     kernels.ptr_array(states[lo:hi]),
                     kernels.ptr_array(cnts[lo:hi]),
                     kernels.int_array(ks[lo:hi]),
                     kernels.int_array(floats[lo:hi]),
                     (ctypes.c_longlong * max(1, hi - lo))(*inits[lo:hi]),
                     kernels.int_array(rets[lo:hi]),
                     kernels.ptr_array(state.prev_emit[lo:hi]),
                     kernels.ptr_array(outs[lo:hi]),
                     kernels.ptr(out_ops), kernels.ptr(out_vis),
                     kernels.ptr_or_null(eq), int(lo == 0),
                     int(lo == starts[-1]), kernels.stream_of(state.row_count))
    return tuple(key_out + outs), out_ops, out_vis


class HashAggExecutor(Executor):
    def __init__(self, input: Executor, group_key_indices: Sequence[int],
                 agg_calls: Sequence[AggCall], capacity: int = 1 << 16,
                 state_table: Optional[StateTable] = None,
                 group_key_names: Optional[Sequence[str]] = None,
                 cleaning_watermark_col: Optional[int] = None,
                 watchdog_interval: Optional[int] = 1,
                 minput_k: int = 32, device="cuda"):
        self.device = resolve_device(device)
        self.input = input
        self.group_key_indices = tuple(group_key_indices)
        self.agg_calls = tuple(agg_calls)
        self.specs = tuple(c.spec() for c in agg_calls)
        # retractable MIN/MAX keep top-K value buffers (reference
        # minput.rs); linear calls keep one value per group
        self.minput_k = minput_k
        self._retractable = tuple(c.retractable for c in agg_calls)
        # K4 takes the linear calls but the HLL register words, which
        # K30 updates a sketch (8 calls) at a time
        self._linear = tuple(j for j, (r, c) in enumerate(
            zip(self._retractable, agg_calls))
            if not r and c.kind is not AggKind.HLL_REG)
        self._sketches = sketch_groups(agg_calls)
        in_schema = input.schema
        gk_names = list(group_key_names or
                        [in_schema[i].name for i in self.group_key_indices])
        self.schema = Schema(tuple(
            [Field(n, in_schema[i].data_type)
             for n, i in zip(gk_names, self.group_key_indices)]
            + [Field(f"agg{j}", c.ret_type) for j, c in enumerate(agg_calls)]))
        self.pk_indices = tuple(range(len(self.group_key_indices)))
        self.capacity = capacity
        self.state_table = state_table
        self.persist_rows = 0        # rows the persists wrote
        # Watermark state cleaning: groups whose watermark-column key
        # falls below the watermark can never be touched again, so their
        # state is zeroed on the device at the barrier. The slot stays an
        # occupied zombie until a rebuild purges it.
        # `cleaning_watermark_col` is an INPUT column index and must be
        # one of the group keys.
        self.cleaning_watermark_key: Optional[int] = (
            None if cleaning_watermark_col is None
            else self.group_key_indices.index(cleaning_watermark_col))
        self._pending_clean_wm: Optional[int] = None
        # the last watermark whose groups were evicted (None before any)
        self.cleaned_below: Optional[int] = None
        self.identity = f"HashAgg(keys={self.group_key_indices})"
        self._key_dtypes = tuple(in_schema[i].data_type.torch_dtype
                                 for i in self.group_key_indices)
        self.state = self._empty_state(capacity)
        # watchdog_interval = 1: fetch (overflow, occupancy) at every
        # barrier that follows applied chunks and fail-stop on overflow;
        # None: never fetch (transfer-free mode) and purge zombies with a
        # same-capacity rehash after each eviction instead.
        if watchdog_interval not in (None, 1):
            raise ValueError(
                "watchdog_interval must be 1 (check before every checkpoint "
                "commit) or None (transfer-free mode)")
        self.watchdog_interval = watchdog_interval
        self.rebuilds = 0
        self._occ_known = 0
        self._applied_since_flush = False
        # device-side watchdog accumulator: unresolved rows of the epoch
        self._overflow_dev = torch.zeros((), dtype=torch.int32,
                                         device=self.device)

    def fence_tokens(self) -> list:
        return [self.state.table.keys[0]] + super().fence_tokens()

    # ------------------------------------------------------------ state
    def _call_init_state(self, j: int, capacity: int):
        spec = self.specs[j]
        if self._retractable[j]:
            return extrema_empty(capacity, self.minput_k, spec.state_dtype,
                                 self.device)
        return spec.init_state(capacity, self.device)

    def _empty_state(self, capacity: int) -> AggState:
        dev = self.device
        return AggState(
            table=HashTable.empty(capacity, self._key_dtypes, dev),
            agg_states=tuple(self._call_init_state(j, capacity)
                             for j in range(len(self.specs))),
            row_count=torch.zeros(capacity, dtype=torch.int64, device=dev),
            dirty=torch.zeros(capacity, dtype=torch.bool, device=dev),
            prev_exists=torch.zeros(capacity, dtype=torch.bool, device=dev),
            prev_emit=tuple(
                torch.zeros(capacity, dtype=c.ret_type.torch_dtype,
                            device=dev)
                for c in self.agg_calls),
        )

    # ------------------------------------------------------- chunk apply
    def _apply_chunk(self, chunk: StreamChunk) -> None:
        """K3, K4 over the linear calls and the row count, K30 per HLL
        sketch, then K26 per retractable call; no host sync."""
        st = self.state
        key_cols = [chunk.columns[i].data for i in self.group_key_indices]
        _, slots, n_unresolved = lookup_or_insert(
            st.table, key_cols, chunk.vis)
        inputs = _call_inputs(self.agg_calls, chunk.columns)
        lin = self._linear
        agg_apply(replace(st, agg_states=tuple(st.agg_states[j] for j in lin)),
                  [self.specs[j] for j in lin], slots, chunk.ops,
                  [inputs[j] for j in lin], n_unresolved, self._overflow_dev)
        for arg, lanes in self._sketches:
            col = chunk.columns[arg]
            hll_update([None if j is None else st.agg_states[j]
                        for j in lanes], col.data, col.valid, chunk.ops,
                       slots=slots)
        for j, retractable in enumerate(self._retractable):
            if retractable:
                values, valid = inputs[j]
                extrema_apply(st.agg_states[j], values, valid, chunk.ops,
                              slots, st.row_count,
                              self.agg_calls[j].kind is AggKind.MAX,
                              self._overflow_dev)
        self._applied_since_flush = True

    def _live_zombie(self, state: AggState):
        occ = state.table.occupied.sum(dtype=torch.int64)
        live = (state.row_count > 0).sum(dtype=torch.int64)
        return occ, live

    def _evict_impl(self, state: AggState, watermark: int) -> None:
        """Zero out groups below the state-cleaning watermark, in place.
        Slots stay occupied zombies; rebuilds reclaim them later."""
        j = self.cleaning_watermark_key
        evict = state.table.occupied & (state.table.keys[j] < watermark)
        for spec, st in zip(self.specs, state.agg_states):
            if isinstance(st, tuple):
                extrema_mask_keep(st, ~evict)
            else:
                st.masked_fill_(evict, spec.init)
        state.row_count.masked_fill_(evict, 0)
        state.dirty &= ~evict
        state.prev_exists &= ~evict
        for pe in state.prev_emit:
            pe.masked_fill_(evict, 0)

    def _rehash_impl(self, state: AggState, new_capacity: int) -> AggState:
        """Device-side rebuild: re-insert surviving groups into a fresh
        table of `new_capacity` slots (K3 over the compacted keys)."""
        keep = state.table.occupied & (
            (state.row_count > 0) | (state.dirty & state.prev_exists))
        return self._rehash_keep(state, keep, new_capacity)

    def _rehash_keep(self, state: AggState, keep: torch.Tensor,
                     new_capacity: int) -> AggState:
        C = state.table.capacity
        dev = keep.device
        sel, n_keep = compact_mask(keep)
        active = torch.arange(C, device=dev) < n_keep
        key_cols = [tk[sel] for tk in state.table.keys]
        fresh = self._empty_state(new_capacity)
        table, slots, _ = lookup_or_insert(fresh.table, key_cols, active)
        # n_unresolved is 0 by construction (new_capacity >= live set);
        # the trash row new_capacity takes inactive rows
        tgt = torch.where(active & (slots >= 0), slots.to(torch.int64),
                          new_capacity)

        def moved(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
            pad = torch.cat([dst, dst[:1]])
            pad[tgt] = src[sel]
            return pad[:new_capacity]

        def moved_call(j, dst, src):
            if self._retractable[j]:
                return extrema_gather(src, sel, tgt, new_capacity,
                                      self.minput_k,
                                      self.specs[j].state_dtype)
            return moved(dst, src)

        return AggState(
            table=table,
            agg_states=tuple(moved_call(j, e, o) for j, (e, o) in enumerate(
                zip(fresh.agg_states, state.agg_states))),
            row_count=moved(fresh.row_count, state.row_count),
            dirty=moved(fresh.dirty, state.dirty),
            prev_exists=moved(fresh.prev_exists, state.prev_exists),
            prev_emit=tuple(moved(e, o) for e, o in
                            zip(fresh.prev_emit, state.prev_emit)),
        )

    # --------------------------------------------------------- rebuild
    def _rebuild(self, new_capacity: int) -> int:
        """Purge zombies / grow via the device-side rehash. Returns the
        rebuilt occupancy (one readback — rebuilds are rare)."""
        self.state = self._rehash_impl(self.state, new_capacity)
        self.capacity = new_capacity
        self.rebuilds += 1
        occ, _ = self._live_zombie(self.state)
        return int(occ)

    def _check_watchdog(self) -> None:
        """One small blocking fetch of the device-accumulated overflow and
        the occupancy, per barrier. Overflow fail-stops before the epoch's
        checkpoint commits."""
        occ, _ = self._live_zombie(self.state)
        vals = torch.stack([self._overflow_dev.to(torch.int64), occ]).cpu()
        n_un = int(vals[0])
        if n_un:
            raise RuntimeError(
                f"hash-agg table overflow mid-epoch ({n_un} rows, "
                f"capacity {self.capacity}); recovery must replay the "
                f"epoch with a larger table")
        self._occ_known = int(vals[1])

    def _maybe_rebuild_at_barrier(self) -> None:
        """Barrier-time growth: crossing the high watermark purges zombies
        or doubles capacity, between epochs only."""
        if self._occ_known <= 0.7 * self.capacity:
            return
        occ, live = self._live_zombie(self.state)
        rebuild, cap = needs_rebuild(int(occ), int(live), self.capacity)
        if rebuild:
            self._occ_known = self._rebuild(cap)

    def overflow(self) -> int:
        """Unresolved rows accumulated on the device (one fetch)."""
        return int(self._overflow_dev)

    # ------------------------------------------------------- persistence
    def _persist(self, barrier: Barrier) -> None:
        """Durable flush, split as the store's deferred-flush stages:
        K18 and the counts' copy launch here, behind the epoch's applies
        and before the flush resets the dirty bits; the waits are pure
        event synchronizes; the continuations (on the event loop) launch
        the packed rows' copy, then write and commit the state table.
        Inline when the store does not defer, on the uploader when it
        does."""
        if self.state_table is None:
            return
        st = self.state_table
        evicting = (self.cleaning_watermark_key is not None
                    and self._pending_clean_wm is not None)
        buf, counts = persist_pack(
            self.state, self.cleaning_watermark_key if evicting else None,
            self._pending_clean_wm)
        counts_fetch = PendingFetch(counts)
        nk = len(self.state.table.keys)
        key_dts = [_np_dtype(k.dtype) for k in self.state.table.keys]
        row_dts = [np.dtype(np.int8), np.dtype(bool)] + key_dts
        for a in self.state.agg_states:
            for t, lanes in call_parts(a):
                row_dts += [_np_dtype(_durable_dtype(t))] * lanes
        row_dts.append(np.dtype(np.int64))
        wp = len(row_dts)
        new_epoch = barrier.epoch.curr
        cell: dict = {}

        def cont_prepare(host_counts):
            cell["nd"], cell["nev"] = (int(x) for x in host_counts)
            n = cell["nd"] * wp + cell["nev"] * nk
            if n:
                cell["fetch"] = PendingFetch(buf[:n])

        def wait_rows():
            f = cell.get("fetch")
            return f.wait() if f is not None else None

        def cont_apply(host):
            nd, nev = cell["nd"], cell["nev"]
            self.persist_rows += nd + nev
            if nd:
                ops, vis, *cols = unpack_rows(host, nd, row_dts)
                st.write_chunk_columns(ops, cols, vis)
            if nev:
                self._apply_evict_deletes(
                    unpack_rows(host[nd * wp:], nev, key_dts), nev)
            st.commit(new_epoch)

        st.store.defer_flush(barrier.epoch.prev,
                             (counts_fetch.wait, cont_prepare),
                             (wait_rows, cont_apply),
                             table_id=st.table_id)

    def _apply_evict_deletes(self, keys_np, n: int) -> None:
        # evicted groups leave the durable table in the epoch their device
        # state is zeroed; the non-pk columns of a delete are unused
        pad = (0,) * (sum(self._call_persist_width(j)
                          for j in range(len(self.specs))) + 1)
        self.state_table.write_chunk_rows(
            [(OP_DELETE, tuple(k[r].item() for k in keys_np) + pad)
             for r in range(n)])

    def _call_persist_width(self, j: int) -> int:
        """Columns one agg call contributes to the durable state row."""
        return sum(lanes for _, lanes in call_parts(self.state.agg_states[j]))

    def recover(self) -> None:
        """Rebuild the device state from the state table, sized from the
        stored row count (runtime growth is not persisted)."""
        if self.state_table is None:
            return
        rows = [r for _, r in self.state_table.iter_all()]
        if not rows:
            return
        need = 1 << max(self.capacity.bit_length() - 1,
                        int(len(rows) / 0.7).bit_length())
        self.capacity = max(self.capacity, need)
        self.state = self._state_from_rows(rows, self.capacity)
        self._occ_known = len(rows)

    def _state_from_rows(self, rows: list, capacity: int) -> AggState:
        """An AggState of `capacity` holding exactly `rows` (the durable
        row layout): K3 places the keys, tensor scatters the states."""
        dev = self.device
        nk = len(self.group_key_indices)
        key_cols = [torch.tensor([r[j] for r in rows], dtype=dt, device=dev)
                    for j, dt in enumerate(self._key_dtypes)]
        active = torch.ones(len(rows), dtype=torch.bool, device=dev)
        st = self._empty_state(capacity)
        table, slots, n_un = lookup_or_insert(st.table, key_cols, active)
        if int(n_un):
            raise RuntimeError("hash-agg recovery overflowed its table")
        slots = slots.to(torch.int64)
        off = nk
        for init in st.agg_states:
            for t, lanes in call_parts(init):
                v = torch.tensor([r[off:off + lanes] for r in rows],
                                 dtype=t.dtype, device=dev)
                t[slots] = v if t.dim() == 2 else v[:, 0]
                off += lanes
        st.row_count[slots] = torch.tensor(
            [r[off] for r in rows], dtype=torch.int64, device=dev)
        st.prev_exists[slots] = True
        for spec, ags, pe in zip(self.specs, st.agg_states, st.prev_emit):
            pe[slots] = call_emit(spec, ags)[slots].to(pe.dtype)
        return AggState(table=table, agg_states=st.agg_states,
                        row_count=st.row_count, dirty=st.dirty,
                        prev_exists=st.prev_exists, prev_emit=st.prev_emit)

    # ----------------------------------------------------------- stream
    async def execute(self):
        first = True
        async for msg in self.input.execute():
            if isinstance(msg, StreamChunk):
                self._apply_chunk(msg)
            elif isinstance(msg, Barrier):
                if first or msg.kind is BarrierKind.INITIAL:
                    first = False
                    if self.state_table is not None:
                        self.state_table.init_epoch(msg.epoch.curr)
                        self.recover()
                    yield msg
                    continue
                stopping = msg.mutation is not None and msg.is_stop_any()
                if self.watchdog_interval and (
                        stopping or self._applied_since_flush):
                    self._check_watchdog()
                # the persist view reads the dirty bits the flush resets
                self._persist(msg)
                flushed = self._applied_since_flush
                if flushed:
                    self._applied_since_flush = False
                    cols, ops, vis = agg_flush(self.state, self.specs)
                    yield StreamChunk(tuple(Column(c) for c in cols), ops,
                                      vis, self.schema)
                if (self.cleaning_watermark_key is not None
                        and self._pending_clean_wm is not None):
                    self._evict_impl(self.state, self._pending_clean_wm)
                    self.cleaned_below = self._pending_clean_wm
                    self._pending_clean_wm = None
                    flushed = True
                    if self.watchdog_interval is None:
                        # transfer-free mode: without occupancy readbacks
                        # the host can never trigger a purge, so purge on
                        # the device with a same-capacity rehash
                        self.state = self._rehash_impl(self.state,
                                                       self.capacity)
                if flushed:
                    self._maybe_rebuild_at_barrier()
                yield msg
            else:
                # watermarks on group-key columns pass through re-indexed;
                # others are consumed
                wm: Watermark = msg
                if wm.col_idx in self.group_key_indices:
                    pos = self.group_key_indices.index(wm.col_idx)
                    if pos == self.cleaning_watermark_key:
                        self._pending_clean_wm = wm.val
                    yield wm.with_idx(pos)
