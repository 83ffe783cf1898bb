"""SimpleAgg — global (ungrouped) aggregation (port of
risingwave_tpu/stream/simple_agg.py, the singleton executor).

The group state is one scalar tensor per agg call plus a row count, on
the device. Applying a chunk is kernel K25 (`csrc/simple_agg.cu`): every
visible row signed by its op, NULL arguments not counted, each call's
partial over the chunk folded in a fixed order and combined into its
state, without atomics (float sums are the same from run to run); a
list of more calls than one launch takes runs in several. The HLL
register words of an approx_count_distinct go to kernel K30
(`csrc/hll_update.cu`), one launch a sketch.

At a barrier the flush fetches the emitted values to the host in one
copy (a sync a barrier, as the reference's `np.asarray` of the states)
and compares them with the last emission there: unchanged values emit
nothing (the reference's NoChange); otherwise the first emission is an
Insert, later ones an UpdateDelete / UpdateInsert pair.

Durable state (a state table of slot 0 ++ one state per call ++
row_count, the JAX package's layout): written at a barrier after any
chunk; recovery reloads the states and seeds the last emission, so an
already-emitted group is not inserted twice.

Left out of this slice: `StatelessSimpleAggExecutor`, the per-chunk
partials the mesh path feeds into a SimpleAgg (ROADMAP Queue A step 9;
`combine_partials` is here), and retractable MIN/MAX (raise).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from ..common.chunk import (
    Column, StreamChunk, OP_INSERT, OP_UPDATE_DELETE, OP_UPDATE_INSERT,
    op_sign,
)
from ..common.types import Field, Schema
from ..device import resolve_device
from ..expr.agg import AggCall, AggKind, AggSpec
from ..expr.hll import hll_update, sketch_groups
from ..expr.program import TYPE_CODES
from ..ops import kernels
from ..state.state_table import StateTable
from ..utils.d2h import as_i64_lanes
from .executor import Executor, StatefulUnaryExecutor
from .message import Barrier, Watermark

_P = ctypes.c_void_p
_PP = ctypes.POINTER(_P)
_PI = ctypes.POINTER(ctypes.c_int)
_I = ctypes.c_int
_L = ctypes.c_longlong

MAX_CALLS = 8                       # csrc/simple_agg.cu
_KINDS = {AggKind.COUNT: 0, AggKind.SUM: 1, AggKind.MIN: 2,
          AggKind.MAX: 3}
_COUNT_SUM = 4                      # COUNT over partial counts

# K25. Replaces stream/simple_agg.py:SimpleAggExecutor._apply_impl (117).
K_SIMPLE = kernels.register(kernels.CudaKernel(
    "simple_agg",
    replaces="risingwave_tpu/stream/simple_agg.py:117",
    functions={
        "rw_simple_agg_apply": [_L, _P, _P, _I, _PI, _PI, _PP, _PI, _PP,
                                _PP, _P, _P, _P],
        "rw_simple_agg_blocks": [_L]}))


def _call_inputs(calls: Sequence[AggCall], chunk: StreamChunk):
    """(values, valid) per call: the argument column, (None, None) for
    count(*)."""
    out = []
    for call in calls:
        if call.arg is None:
            out.append((None, None))
        else:
            col = chunk.columns[call.arg]
            out.append((col.data, col.valid))
    return out


def simple_agg_apply_plain(specs: Sequence[AggSpec], states, row_count,
                           chunk: StreamChunk,
                           combine_partials: bool = False):
    """Plain PyTorch version of kernel K25, as the reference computes:
    (new states, new row count), fresh tensors."""
    signs = torch.where(chunk.vis, op_sign(chunk.ops), 0)
    N = chunk.capacity
    dev = chunk.ops.device
    seg = torch.zeros(N, dtype=torch.int64, device=dev)
    new_states = []
    for spec, st, (values, valid) in zip(
            specs, states, _call_inputs([s.call for s in specs], chunk)):
        if values is None:
            values = torch.zeros(N, dtype=spec.state_dtype, device=dev)
            row_signs = signs
        else:
            row_signs = signs if valid is None else torch.where(
                valid, signs, 0)
        if combine_partials and spec.call.kind is AggKind.COUNT:
            # partial rows carry counts in the arg column: sum them
            part = (values.to(spec.state_dtype)
                    * row_signs.to(spec.state_dtype)).sum()
        else:
            part = spec.partial(values, row_signs, seg, 1)[0]
        new_states.append(spec.combine(st, part))
    return tuple(new_states), row_count + signs.to(torch.int64).sum()


def simple_agg_apply(specs: Sequence[AggSpec], states, row_count,
                     chunk: StreamChunk, combine_partials: bool = False):
    """Kernels K25 (the calls, MAX_CALLS a launch; the row count in the
    first) and K30 (one launch per HLL sketch) on a CUDA device, the
    states and row count updated in place and returned; the plain
    version on the CPU."""
    dev = chunk.ops.device
    if dev.type == "cpu":
        return simple_agg_apply_plain(specs, states, row_count, chunk,
                                      combine_partials)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    calls = [s.call for s in specs]
    rest = [j for j, c in enumerate(calls) if c.kind is not AggKind.HLL_REG]
    for at in range(0, max(1, len(rest)), MAX_CALLS):
        part = rest[at:at + MAX_CALLS]
        # launches after the first count their rows into a scratch total
        rc = row_count if at == 0 else torch.zeros_like(row_count)
        _k25([specs[j] for j in part], [states[j] for j in part], rc,
             chunk, combine_partials)
    for arg, lanes in sketch_groups(calls):
        col = chunk.columns[arg]
        hll_update([None if j is None else states[j] for j in lanes],
                   col.data, col.valid, chunk.ops, vis=chunk.vis)
    return tuple(states), row_count


def _k25(specs: Sequence[AggSpec], states, row_count, chunk: StreamChunk,
         combine_partials: bool) -> None:
    """One K25 launch over at most MAX_CALLS calls, in place."""
    dev = chunk.ops.device
    N = chunk.capacity
    inputs = _call_inputs([s.call for s in specs], chunk)
    kinds, fls, vals, types, valids = [], [], [], [], []
    for spec, st, (values, valid) in zip(specs, states, inputs):
        k = spec.call.kind
        if k not in _KINDS:
            raise ValueError(f"K25 does not take {k}")
        if combine_partials and k is AggKind.COUNT:
            if values is None:
                raise ValueError("combine_partials needs every call's arg")
            kinds.append(_COUNT_SUM)
        else:
            kinds.append(_KINDS[k])
        fls.append(int(spec.state_dtype == torch.float64))
        if st.dtype != spec.state_dtype or st.dim() != 0 \
                or st.device != dev:
            raise ValueError("K25 takes scalar states of the spec's dtype")
        if values is not None:
            if values.dtype not in TYPE_CODES or values.shape != (N,) \
                    or not values.is_contiguous():
                raise ValueError(f"K25 does not take {values.dtype} or "
                                 "strided arguments")
            types.append(TYPE_CODES[values.dtype])
        else:
            types.append(0)
        if valid is not None and (valid.shape != (N,)
                                  or not valid.is_contiguous()):
            raise ValueError("K25 takes contiguous valid masks")
        vals.append(values)
        valids.append(valid)
    if row_count.dtype != torch.int64 or row_count.dim() != 0:
        raise ValueError("K25 takes an int64 scalar row count")
    if not (chunk.ops.is_contiguous() and chunk.vis.is_contiguous()):
        raise ValueError("K25 takes contiguous ops and visibility")
    blocks = K_SIMPLE.lib().rw_simple_agg_blocks(N)
    partials = torch.empty(blocks * (MAX_CALLS + 1), dtype=torch.int64,
                           device=dev)
    K_SIMPLE.launches += 1
    K_SIMPLE.call("rw_simple_agg_apply", N, kernels.ptr(chunk.ops),
                  kernels.ptr(chunk.vis), len(specs),
                  kernels.int_array(kinds), kernels.int_array(fls),
                  kernels.ptr_array(vals), kernels.int_array(types),
                  kernels.ptr_array(valids), kernels.ptr_array(states),
                  kernels.ptr(row_count), kernels.ptr(partials),
                  kernels.stream_of(partials))


class SimpleAggExecutor(StatefulUnaryExecutor):
    """The global agg group in a singleton fragment; emits the U-/U+
    changelog pair at each barrier (Insert on first emission), like the
    reference's AggGroup::build_change."""

    def __init__(self, input: Executor, agg_calls: Sequence[AggCall],
                 state_table: Optional[StateTable] = None,
                 combine_partials: bool = False, device="cuda"):
        self.device = resolve_device(device)
        self.input = input
        self.agg_calls = tuple(agg_calls)
        for c in agg_calls:
            if c.retractable:
                raise NotImplementedError(
                    "retractable min/max needs materialized-input state")
        self.specs = tuple(c.spec() for c in agg_calls)
        # combine_partials: input rows are partial states of an upstream
        # StatelessSimpleAgg (two-phase agg); counts are summed
        self.combine_partials = combine_partials
        if combine_partials and any(c.arg is None for c in agg_calls):
            raise ValueError(
                "combine_partials reads partial values from input columns; "
                "every agg call needs an arg (count partials are summed)")
        self.schema = Schema(tuple(
            Field(f"agg{j}", c.ret_type) for j, c in enumerate(agg_calls)))
        self.pk_indices = ()
        self.identity = "SimpleAgg"
        self.states = tuple(
            torch.full((), s.init, dtype=s.state_dtype, device=self.device)
            for s in self.specs)
        self.row_count = torch.zeros((), dtype=torch.int64,
                                     device=self.device)
        self._emitted = False
        self._prev_emit: Optional[tuple] = None
        self._dirty_persist = False
        self._init_stateful(state_table, 1)

    def fence_tokens(self) -> list:
        return [self.row_count] + super().fence_tokens()

    # -------------------------------------------------------------- hooks
    def on_chunk(self, chunk: StreamChunk) -> None:
        self.states, self.row_count = simple_agg_apply(
            self.specs, self.states, self.row_count, chunk,
            self.combine_partials)
        self._dirty_persist = True
        return None

    def _fetch(self) -> tuple[tuple, int]:
        """(emitted values as 0-d numpy arrays of the output dtypes, the
        row count), in one copy to the host."""
        emits = [spec.emit(st) for spec, st in zip(self.specs, self.states)]
        lanes = torch.stack([as_i64_lanes(e) for e in emits]
                            + [self.row_count]).cpu().numpy()
        out = []
        for e, lane in zip(emits, lanes[:-1]):
            dt = np.dtype(str(e.dtype).replace("torch.", ""))
            if e.is_floating_point():
                v = np.asarray(lane).view(np.float64).astype(dt)
            else:
                v = np.asarray(lane).astype(dt)
            out.append(np.asarray(v))
        return tuple(out), int(lanes[-1])

    def flush(self) -> Optional[StreamChunk]:
        cur, _ = self._fetch()
        prev = self._prev_emit
        existed = self._emitted
        self._prev_emit = cur
        self._emitted = True
        if existed and prev is not None and all(
                (a == b).all() for a, b in zip(prev, cur)):
            return None  # NoChange (reference agg_group.rs:71)
        rows_ops = []
        if existed:
            rows_ops.append((OP_UPDATE_DELETE, prev))
            rows_ops.append((OP_UPDATE_INSERT, cur))
        else:
            rows_ops.append((OP_INSERT, cur))
        cap = 2
        ops = np.full(cap, OP_INSERT, dtype=np.int8)
        vis = np.zeros(cap, dtype=bool)
        cols = [np.zeros(cap, dtype=c.dtype) for c in cur]
        for i, (op, vals) in enumerate(rows_ops):
            ops[i] = op
            vis[i] = True
            for j, v in enumerate(vals):
                cols[j][i] = v
        dev = self.device
        return StreamChunk(
            tuple(Column(torch.from_numpy(c).to(dev)) for c in cols),
            torch.from_numpy(ops).to(dev), torch.from_numpy(vis).to(dev),
            self.schema)

    def persist(self, barrier: Barrier, flushed) -> None:
        if self.state_table is None:
            return
        if self._dirty_persist:
            self._dirty_persist = False
            states = [st.cpu().numpy().item() for st in self.states]
            row = tuple(states) + (int(self.row_count.cpu()),)
            self.state_table.write_chunk_rows([(int(OP_INSERT), (0,) + row)])
        self.state_table.commit(barrier.epoch.curr)

    def recover_state(self, epoch: int) -> None:
        row = self.state_table.get_row((0,))
        if row is None:
            return
        vals = row[1:]
        self.states = tuple(
            torch.tensor(v, dtype=s.state_dtype, device=self.device)
            for v, s in zip(vals[:-1], self.specs))
        self.row_count = torch.tensor(vals[-1], dtype=torch.int64,
                                      device=self.device)
        # the recovered state was flushed before the crash: seed the last
        # emission so recovery does not re-emit an Insert for the group
        self._prev_emit, _ = self._fetch()
        self._emitted = True

    def map_watermark(self, wm: Watermark) -> Optional[Watermark]:
        return None  # no group keys to carry watermarks
