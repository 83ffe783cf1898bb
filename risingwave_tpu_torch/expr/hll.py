"""HyperLogLog for approx_count_distinct: 64 registers packed into 8 int64
words (port of risingwave_tpu/expr/hll.py).

The planner lowers approx_count_distinct into 8 hidden HLL_REG agg calls
(one a word lane: buckets [8L, 8L + 8), one byte each) and an
`hll_estimate` post projection. A row's register is the low 6 bits of
splitmix64 over its value's bits (a float by its float64 bit pattern),
its rank the 1-based index of the lowest set bit of the other 58 (59
when they are all zero); a register keeps the largest rank it saw.
Only rows of positive sign count, so NULL arguments (sign 0) and
retractions never touch a register; the planner refuses a retracting
input.

Kernel K30 (`csrc/hll_update.cu`, `hll_update`) applies a chunk to the 8
lanes of one sketch in one launch; `hll_update_plain` is its plain
version, `lane_partial` + `lane_combine` per lane as the JAX package's
`AggSpec.partial`/`combine` run them. `hll_estimate_numpy` is the JAX
package's batch estimator, the recount the card's runs are held to.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import kernels
from ..ops.hashing import s64, splitmix64, srl

M = 64               # registers
LANES = 8            # int64 words per sketch
ALPHA_M = 0.709      # alpha for m = 64
MAX_RANK = 59        # rank of a hash whose 58 rank bits are all zero

_M1 = s64(0x5555555555555555)
_M2 = s64(0x3333333333333333)
_M4 = s64(0x0F0F0F0F0F0F0F0F)
_H01 = s64(0x0101010101010101)


# ------------------------------------------------------------ torch forms
def _popcount(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of the uint64 bits in int64 `x` (integer only: a
    float log2 of a power of two may floor one short)."""
    x = x - (srl(x, 1) & _M1)
    x = (x & _M2) + (srl(x, 2) & _M2)
    x = (x + srl(x, 4)) & _M4
    return srl(x * _H01, 56)


def to_bits(vals: torch.Tensor) -> torch.Tensor:
    """The value's 64 hash input bits: a float's float64 bit pattern
    (distinct floats of one integer part stay distinct), an integer
    sign-extended, a bool 0/1."""
    if vals.is_floating_point():
        return vals.to(torch.float64).view(torch.int64)
    return vals.to(torch.int64)


def bucket_rank(vals: torch.Tensor):
    """(register 0..63, rank 1..59) per value, int64."""
    h = splitmix64(to_bits(vals))
    bucket = h & (M - 1)
    rest = srl(h, 6)
    low = rest & (-rest)
    tz = _popcount(low - 1)
    return bucket, torch.where(rest == 0, MAX_RANK, tz + 1)


def lane_partial(values: torch.Tensor, signs: torch.Tensor,
                 seg_ids: torch.Tensor, num_segments: int,
                 lane: int) -> torch.Tensor:
    """Per-segment packed register word of `lane` over the rows of
    positive sign."""
    bucket, rank = bucket_rank(values)
    live = signs > 0
    in_lane = (bucket >> 3) == lane
    out = torch.zeros(num_segments, dtype=torch.int64, device=values.device)
    for b in range(8):
        v = torch.where(live & in_lane & ((bucket & 7) == b), rank, 0)
        mx = torch.zeros_like(out).scatter_reduce_(0, seg_ids, v, "amax")
        out = out | (mx << (8 * b))
    return out


def lane_combine(state: torch.Tensor, partial: torch.Tensor) -> torch.Tensor:
    """Bytewise maximum of two packed words."""
    out = torch.zeros_like(state)
    for b in range(8):
        sh = 8 * b
        a = (state >> sh) & 255
        c = (partial >> sh) & 255
        out = out | (torch.maximum(a, c) << sh)
    return out


def registers(words: Sequence[torch.Tensor]) -> torch.Tensor:
    """8 word lanes [G] -> registers [G, 64] (int64)."""
    return torch.stack([(w >> (8 * b)) & 255 for w in words
                        for b in range(8)], dim=-1)


def estimate_from_words(words: Sequence[torch.Tensor]) -> torch.Tensor:
    """8 packed word columns [G] -> the estimate per group (int64):
    the raw HLL estimate, linear counting below 2.5 m with an empty
    register, rounded half to even."""
    regs = registers(words).to(torch.float64)
    inv = torch.sum(torch.exp2(-regs), dim=-1)
    est = ALPHA_M * M * M / inv
    zeros = torch.sum(regs == 0, dim=-1)
    small = est <= 2.5 * M
    lc = M * torch.log(torch.clamp(M / torch.clamp(zeros, min=1), min=1.0))
    est = torch.where(small & (zeros > 0), lc, est)
    from .functions import f2i
    return f2i(torch.round(est), torch.int64)


# ------------------------------------------------------------ numpy forms
def _splitmix64_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15))
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def _popcount_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = x - ((x >> np.uint64(1)) & np.uint64(0x5555555555555555))
        x = ((x & np.uint64(0x3333333333333333))
             + ((x >> np.uint64(2)) & np.uint64(0x3333333333333333)))
        x = (x + (x >> np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
        return ((x * np.uint64(0x0101010101010101))
                >> np.uint64(56)).astype(np.int64)


def _to_bits_np(vals: np.ndarray) -> np.ndarray:
    if vals.dtype == np.uint64:
        return vals
    if np.issubdtype(vals.dtype, np.floating):
        return vals.astype(np.float64).view(np.uint64)
    return vals.astype(np.int64).view(np.uint64)


def bucket_rank_numpy(vals: np.ndarray):
    h = _splitmix64_np(_to_bits_np(vals))
    bucket = (h & np.uint64(M - 1)).astype(np.int64)
    rest = (h >> np.uint64(6)).astype(np.uint64)
    with np.errstate(over="ignore"):
        low = rest & (~rest + np.uint64(1))
        tz = _popcount_np(low - np.uint64(1))
    rank = np.where(rest == 0, MAX_RANK, tz + 1)
    return bucket, rank.astype(np.int64)


def hll_estimate_numpy(vals: np.ndarray, valid: np.ndarray,
                       seg_id: np.ndarray, n_groups: int):
    """-> (estimate int64 [n_groups], out_valid): the JAX package's batch
    estimator (a group with no valid row is NULL)."""
    regs = np.zeros((n_groups, M), dtype=np.int64)
    if len(vals):
        bucket, rank = bucket_rank_numpy(np.asarray(vals))
        keep = np.asarray(valid, dtype=bool)
        np.maximum.at(regs, (seg_id[keep], bucket[keep]), rank[keep])
    rf = regs.astype(np.float64)
    inv = np.sum(np.exp2(-rf), axis=-1)
    est = ALPHA_M * M * M / inv
    zeros = np.sum(regs == 0, axis=-1)
    small = est <= 2.5 * M
    lc = M * np.log(np.maximum(M / np.maximum(zeros, 1), 1.0))
    est = np.where(small & (zeros > 0), lc, est)
    cnt = np.bincount(seg_id, weights=np.asarray(valid, np.float64),
                      minlength=n_groups)
    return np.round(est).astype(np.int64), cnt > 0


# -------------------------------------------------------------------- K30
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# K30. Replaces expr/hll.py:lane_partial (121) + lane_combine (137), as
# AggSpec.partial / combine of 8 HLL_REG calls run them inside
# stream/hash_agg.py:_apply_impl (248) and stream/simple_agg.py:
# _apply_impl (117).
K_HLL = kernels.register(kernels.CudaKernel(
    "hll_update",
    replaces="risingwave_tpu/expr/hll.py:121",
    functions={"rw_hll_update": [_L, _P, _I, _P, _P, _P, _P,
                                 ctypes.POINTER(_P), _I, _P]}))
# rows one K30 block walks (its tile; csrc/hll_update.cu says why 256)
ROWS_PER_BLOCK = 256

# value type codes of csrc/hll_update.cu
_VTYPES = {torch.int64: 0, torch.int32: 1, torch.int16: 2, torch.int8: 3,
           torch.bool: 4, torch.float64: 5, torch.float32: 6}


def _signs(ops: torch.Tensor, valid: Optional[torch.Tensor],
           slots: Optional[torch.Tensor], vis: Optional[torch.Tensor]):
    from ..common.chunk import op_sign
    if slots is not None:
        signs = torch.where(slots >= 0, op_sign(ops), 0)
    else:
        signs = torch.where(vis, op_sign(ops), 0)
    if valid is not None:
        signs = torch.where(valid, signs, 0)
    return signs


def hll_update_plain(lanes: Sequence[Optional[torch.Tensor]],
                     values: torch.Tensor, valid: Optional[torch.Tensor],
                     ops: torch.Tensor, slots: Optional[torch.Tensor] = None,
                     vis: Optional[torch.Tensor] = None) -> None:
    """Plain PyTorch version of kernel K30, in place: each present word
    lane (`lanes[L]`, [C] int64, or a 0-d word when `slots` is None and
    every visible row is in group 0) takes the bytewise max with the
    chunk's `lane_partial`. Rows count where the slot is >= 0 (or `vis`
    holds), the op is an insert and the value is valid."""
    signs = _signs(ops, valid, slots, vis)
    if slots is None:
        seg = torch.zeros(ops.shape[0], dtype=torch.int64, device=ops.device)
    for L, st in enumerate(lanes):
        if st is None:
            continue
        word = st.view(-1)
        C = word.shape[0]
        if slots is not None:
            seg = torch.where(slots >= 0, slots, C).to(torch.int64)
        part = lane_partial(values, signs, seg, C + 1, L)[:C]
        word.copy_(lane_combine(word, part))


def hll_update(lanes: Sequence[Optional[torch.Tensor]], values: torch.Tensor,
               valid: Optional[torch.Tensor], ops: torch.Tensor,
               slots: Optional[torch.Tensor] = None,
               vis: Optional[torch.Tensor] = None) -> None:
    """Kernel K30 on a CUDA device (one launch for the sketch's present
    lanes), the plain version on the CPU. Same contract as
    `hll_update_plain`."""
    dev = ops.device
    if dev.type == "cpu":
        return hll_update_plain(lanes, values, valid, ops, slots, vis)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    N = ops.shape[0]
    if len(lanes) != LANES or all(t is None for t in lanes):
        raise ValueError("K30 takes the 8 word lanes of one sketch")
    for t in lanes:
        if t is not None and (t.dtype != torch.int64 or t.device != dev
                              or not t.is_contiguous()):
            raise ValueError("K30 word lanes are contiguous int64 on the "
                             "device")
    if values.dtype not in _VTYPES or values.shape != (N,) \
            or not values.is_contiguous():
        raise ValueError(f"K30 does not take {values.dtype} or strided "
                         "values")
    if (slots is None) == (vis is None):
        raise ValueError("K30 takes slots (a hash agg) or vis (one group)")
    for t, dt in ((valid, torch.bool), (slots, torch.int32),
                  (vis, torch.bool), (ops, torch.int8)):
        if t is not None and (t.dtype != dt or t.shape != (N,)
                              or not t.is_contiguous()):
            raise ValueError("K30 takes int8 ops, int32 slots and bool "
                             "masks of the chunk's length")
    K_HLL.launches += 1
    K_HLL.call("rw_hll_update", N, kernels.ptr(values), _VTYPES[values.dtype],
               kernels.ptr_or_null(valid), kernels.ptr(ops),
               kernels.ptr_or_null(slots), kernels.ptr_or_null(vis),
               kernels.ptr_array(lanes), ROWS_PER_BLOCK,
               kernels.stream_of(ops))


def sketch_groups(calls) -> list:
    """The HLL_REG calls of an agg call list as sketches: [(arg, [call
    index or None per lane])], each lane of a sketch once, in call
    order."""
    from .agg import AggKind
    groups: list = []
    for j, c in enumerate(calls):
        if c.kind is not AggKind.HLL_REG:
            continue
        for arg, lanes in groups:
            if arg == c.arg and lanes[c.lane] is None:
                lanes[c.lane] = j
                break
        else:
            lanes = [None] * LANES
            lanes[c.lane] = j
            groups.append((c.arg, lanes))
    return groups
