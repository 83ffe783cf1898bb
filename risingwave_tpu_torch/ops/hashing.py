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


def key_hash(key_cols) -> torch.Tensor:
    """splitmix64 chain over key columns (each widened to 64 bits with
    sign extension, as `astype(uint64)` does), seeded like the JAX
    package's `_bucket_pair` and `compute_vnodes`."""
    h = torch.full((key_cols[0].shape[0],), s64(SEED), dtype=torch.int64,
                   device=key_cols[0].device)
    for c in key_cols:
        x = h ^ (c.to(torch.int64) * GOLDEN)
        h = splitmix64(x)
    return h
