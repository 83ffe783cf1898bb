"""Aggregate functions as device reduction specs
(port of risingwave_tpu/expr/agg.py).

An aggregate splits into three pure pieces that compose with segment
reductions and hash-table scatter:

  partial(values, signs, seg_ids, num_segments) -> per-segment partials
  combine(state, partial) -> state               (associative merge)
  emit(state) -> output value

COUNT and SUM are retractable (a Delete row contributes with sign -1).
The MIN/MAX combine form is valid on append-only input only; over a
retracting input the hash agg keeps their materialized-input buffers
(ops/extrema.py) and the spec gives their state dtype and identity.

HLL_REG is one packed 8-byte register word of a 64-register HLL sketch
(expr/hll.py): approx_count_distinct lowers to 8 of them, one a lane;
the register max cannot retract, so they need an append-only input.

On the hash-agg path the per-chunk partial+combine is fused into kernel
K4 (stream/hash_agg.py), for HLL_REG into kernel K30 (expr/hll.py);
these functions are their plain PyTorch version.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

import torch

from ..common.types import DataType


class AggKind(enum.Enum):
    COUNT = "count"
    SUM = "sum"
    MIN = "min"
    MAX = "max"
    HLL_REG = "hll_reg"


@dataclass(frozen=True)
class AggCall:
    kind: AggKind
    arg: Optional[int]          # input column index (None for count(*))
    ret_type: DataType
    append_only: bool = False   # input stream has no deletes
    lane: int = 0               # HLL_REG word index (buckets [8L, 8L+8))

    @property
    def retractable(self) -> bool:
        """MIN/MAX over a retracting input: kept as a buffer of the best
        distinct values (ops/extrema.py), not as one value a group."""
        return self.kind in (AggKind.MIN, AggKind.MAX) and not self.append_only

    def spec(self) -> "AggSpec":
        return make_spec(self)


I64_MIN = -(1 << 63)
I64_MAX = (1 << 63) - 1


@dataclass(frozen=True)
class AggSpec:
    call: AggCall
    state_dtype: torch.dtype
    init: object  # identity element

    def init_state(self, capacity: int, device) -> torch.Tensor:
        return torch.full((capacity,), self.init, dtype=self.state_dtype,
                          device=device)

    # values: [N] input column data (garbage where sign == 0)
    # signs:  [N] int32 in {-1, 0, +1} (0 = masked/invisible/null)
    # seg_ids:[N] int64 segment per row
    def partial(self, values, signs, seg_ids, num_segments) -> torch.Tensor:
        k = self.call.kind
        dev = signs.device
        if k is AggKind.HLL_REG:
            from .hll import lane_partial
            return lane_partial(values, signs, seg_ids, num_segments,
                                self.call.lane)
        if k is AggKind.COUNT:
            out = torch.zeros(num_segments, dtype=torch.int64, device=dev)
            return out.index_add_(0, seg_ids, signs.to(torch.int64))
        if k is AggKind.SUM:
            v = values.to(self.state_dtype) * signs.to(self.state_dtype)
            out = torch.zeros(num_segments, dtype=self.state_dtype,
                              device=dev)
            return out.index_add_(0, seg_ids, v)
        if k in (AggKind.MIN, AggKind.MAX):
            v = torch.where(signs > 0, values.to(self.state_dtype),
                            torch.tensor(self.init, dtype=self.state_dtype,
                                         device=dev))
            out = torch.full((num_segments,), self.init,
                             dtype=self.state_dtype, device=dev)
            return out.scatter_reduce_(
                0, seg_ids, v, "amin" if k is AggKind.MIN else "amax")
        raise NotImplementedError(k)

    def combine(self, state, partial) -> torch.Tensor:
        k = self.call.kind
        if k is AggKind.HLL_REG:
            from .hll import lane_combine
            return lane_combine(state, partial)
        if k in (AggKind.COUNT, AggKind.SUM):
            return state + partial
        if k is AggKind.MIN:
            return torch.minimum(state, partial)
        if k is AggKind.MAX:
            return torch.maximum(state, partial)
        raise NotImplementedError(k)

    def emit(self, state) -> torch.Tensor:
        out = state.to(self.call.ret_type.torch_dtype)
        if out.dtype == torch.float32:
            # the JAX package's CPU cast to float32 flushes subnormal
            # results to a zero of their sign
            out = torch.where(out.abs() < torch.finfo(out.dtype).tiny,
                              out * 0, out)
        return out


def make_spec(call: AggCall) -> AggSpec:
    k = call.kind
    if k is AggKind.HLL_REG:
        if not call.append_only:
            raise NotImplementedError(
                "approx_count_distinct needs an append-only input "
                "(register max cannot retract)")
        return AggSpec(call, torch.int64, 0)
    if k is AggKind.COUNT:
        return AggSpec(call, torch.int64, 0)
    if k is AggKind.SUM:
        if call.ret_type.is_float:
            return AggSpec(call, torch.float64, 0.0)
        return AggSpec(call, torch.int64, 0)
    if k in (AggKind.MIN, AggKind.MAX):
        if call.ret_type.is_float:
            ident = float("inf") if k is AggKind.MIN else float("-inf")
            return AggSpec(call, torch.float64, ident)
        return AggSpec(call, torch.int64,
                       I64_MAX if k is AggKind.MIN else I64_MIN)
    raise NotImplementedError(k)


def count_star(append_only: bool = False) -> AggCall:
    return AggCall(AggKind.COUNT, None, DataType.INT64, append_only)


def agg_max(col: int, ret_type: DataType = DataType.INT64,
            append_only: bool = False) -> AggCall:
    return AggCall(AggKind.MAX, col, ret_type, append_only)


def agg_min(col: int, ret_type: DataType = DataType.INT64,
            append_only: bool = False) -> AggCall:
    return AggCall(AggKind.MIN, col, ret_type, append_only)


def agg_sum(col: int, ret_type: DataType = DataType.INT64,
            append_only: bool = False) -> AggCall:
    return AggCall(AggKind.SUM, col, ret_type, append_only)
