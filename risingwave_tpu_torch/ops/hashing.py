"""splitmix64 on int64 tensors, bit-identical to the JAX package's uint64
arithmetic.

PyTorch has no usable uint64 shift, add or remainder (they raise
NotImplementedError on the CPU build), so the plain versions run in
int64: a multiply or add wraps to the same bits, a logical right shift
is an arithmetic shift plus a mask, and an unsigned remainder by a small
modulus goes through the two 32-bit halves. The CUDA kernels use
`unsigned long long` directly.
"""

from __future__ import annotations

import torch


def s64(c: int) -> int:
    """The int64 with the same bits as the uint64 constant `c`."""
    return c - (1 << 64) if c >= (1 << 63) else c


GOLDEN = s64(0x9E3779B97F4A7C15)
MIX1 = s64(0xBF58476D1CE4E5B9)
MIX2 = s64(0x94D049BB133111EB)
SEED = 0x243F6A8885A308D3
LOW32 = 0xFFFFFFFF


def srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of the uint64 bits held in int64 `x`."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """Public splitmix64 finalizer, uint64 -> uint64, on int64 bits."""
    x = x + GOLDEN
    x = (x ^ srl(x, 30)) * MIX1
    x = (x ^ srl(x, 27)) * MIX2
    return x ^ srl(x, 31)


def umod(h: torch.Tensor, m: int) -> torch.Tensor:
    """`h mod m` of the uint64 bits in int64 `h`, for 0 < m < 2**31."""
    if not 0 < m < (1 << 31):
        raise ValueError(f"modulus {m} out of range")
    r32 = (1 << 32) % m
    return ((srl(h, 32) % m) * r32 + (h & LOW32) % m) % m


def u64_lane(c: torch.Tensor) -> torch.Tensor:
    """The uint64 bits (in int64) that `c.astype(uint64)` gives in the
    JAX package: integers sign-extended, bools 0/1, floats converted by
    value with saturation (NaN and values below 1 give 0, values from
    2^64 up give 2^64 - 1), as XLA converts them."""
    if not c.is_floating_point():
        return c.to(torch.int64)
    x = c.to(torch.float64)
    high = x >= 2.0 ** 63
    low = torch.where(high, x - 2.0 ** 63, x)
    low = torch.where(low >= 1.0, low, 0.0)       # NaN fails the compare
    v = low.clamp(max=2.0 ** 63 - 1024).to(torch.int64)
    v = torch.where(high, v | s64(1 << 63), v)
    return torch.where(x >= 2.0 ** 64, -1, v)


def key_hash(key_cols) -> torch.Tensor:
    """splitmix64 chain over key columns (each as its `astype(uint64)`
    lane, `u64_lane`), seeded like the JAX package's `_bucket_pair` and
    `compute_vnodes`."""
    h = torch.full((key_cols[0].shape[0],), s64(SEED), dtype=torch.int64,
                   device=key_cols[0].device)
    for c in key_cols:
        x = h ^ (u64_lane(c) * GOLDEN)
        h = splitmix64(x)
    return h
