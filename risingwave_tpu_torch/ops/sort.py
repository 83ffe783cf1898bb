"""Stable sorts of int64 keys: kernel K11 (`csrc/radix_sort.cu`) on a
CUDA device, `torch.sort(stable=True)` on the CPU.

Stands in for the JAX package's stable argsorts: the sorted join's sort
of new rows by hash (risingwave_tpu/stream/sorted_join.py:571) and
every pass of `stable_lexsort` (risingwave_tpu/ops/hash_table.py:78).
`key_bits` tells the kernel how many low bits of the keys can differ,
so a flag or a bounded index sorts in one or a few 8-bit passes; 64 (the
default) takes any int64.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from . import kernels

_P = ctypes.c_void_p

# K11. Replaces stream/sorted_join.py:571 (jnp.argsort(ins_h,
# stable=True)) and the passes of ops/hash_table.py:78 stable_lexsort.
K_SORT = kernels.register(kernels.CudaKernel(
    "radix_sort",
    replaces="risingwave_tpu/stream/sorted_join.py:571",
    functions={"rw_radix_sort": [_P, _P, _P, _P, _P, _P, _P,
                                 ctypes.c_longlong, ctypes.c_int, _P],
               "rw_radix_sort_workspace": [ctypes.c_longlong,
                                           ctypes.c_int]}))

# the kernel packs counts into 30 bits
MAX_KEYS = 1 << 30
INT64_MAX = (1 << 63) - 1


def float_key_plain(x: torch.Tensor) -> torch.Tensor:
    """float64 -> int64 ordered as jnp.argsort orders floats on the CPU:
    zeros and subnormals equal (0), every NaN last and equal."""
    x = x.to(torch.float64)
    b = x.view(torch.int64)
    k = torch.where(b >= 0, b, b ^ INT64_MAX)
    k = torch.where(x.abs() < 2.2250738585072014e-308, 0, k)
    return torch.where(torch.isnan(x), INT64_MAX, k)


def order_key_plain(c: torch.Tensor, desc: bool) -> torch.Tensor:
    """One order column as an int64 sort key: integers as they are, DESC
    by bitwise complement; floats by `float_key_plain`, DESC negated
    first."""
    if c.is_floating_point():
        return float_key_plain(-c if desc else c)
    v = c.to(torch.int64)
    return ~v if desc else v


def stable_sort_plain(keys: torch.Tensor,
                      values: Optional[torch.Tensor] = None):
    """Plain PyTorch version of kernel K11: (sorted keys, permutation),
    or the values permuted instead of the permutation."""
    s, perm = torch.sort(keys, stable=True)
    return s, (perm if values is None else values[perm])


def stable_sort(keys: torch.Tensor, key_bits: int = 64,
                values: Optional[torch.Tensor] = None):
    """(sorted keys, permutation) as `torch.sort(keys, stable=True)`
    gives them; with `values`, values[permutation] in place of the
    permutation. Kernel K11 on a CUDA device (keys in [0, 2^key_bits)
    when key_bits < 64), the plain version on the CPU."""
    dev = keys.device
    if dev.type == "cpu":
        return stable_sort_plain(keys, values)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not 1 <= key_bits <= 64:
        raise ValueError(f"key_bits {key_bits} out of range")
    if keys.dtype != torch.int64 or keys.dim() != 1 \
            or not keys.is_contiguous():
        raise ValueError("K11 sorts a contiguous 1-D int64 tensor")
    n = keys.shape[0]
    if n >= MAX_KEYS:
        raise ValueError(f"K11 sorts fewer than {MAX_KEYS} keys")
    if values is not None and (values.dtype != torch.int64
                               or values.shape != keys.shape
                               or not values.is_contiguous()
                               or values.device != dev):
        raise ValueError("values must be contiguous int64 like the keys")
    i64 = dict(dtype=torch.int64, device=dev)
    out_k, out_v, tmp_k, tmp_v = (torch.empty(n, **i64) for _ in range(4))
    workspace = torch.empty(K_SORT.lib().rw_radix_sort_workspace(n, key_bits),
                            dtype=torch.int32, device=dev)
    K_SORT.launches += 1
    K_SORT.call("rw_radix_sort", kernels.ptr(keys),
                kernels.ptr_or_null(values), kernels.ptr(out_k),
                kernels.ptr(out_v), kernels.ptr(tmp_k), kernels.ptr(tmp_v),
                kernels.ptr(workspace), n, key_bits,
                kernels.stream_of(keys))
    return out_k, out_v


def key_bits_of(t: torch.Tensor) -> int:
    """Bits a sort of `t` widened to int64 must look at: 1 for bool, 8
    for uint8, 64 for signed types (sign-extended)."""
    if t.dtype == torch.bool:
        return 1
    if t.dtype == torch.uint8:
        return 8
    return 64


def lexsort_plain(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """np.lexsort semantics (last key primary) by iterated
    `torch.argsort(stable=True)`, on any device: the plain version of
    `stable_lexsort`."""
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def stable_lexsort(keys: Sequence[torch.Tensor],
                   key_bits: Optional[Sequence[int]] = None) -> torch.Tensor:
    """np.lexsort semantics (last key primary) as iterated single-key
    stable sorts: K11 passes on a CUDA device, `torch.argsort(stable=
    True)` on the CPU. `key_bits` (per key) bounds each key's bits for
    the kernel, as in `stable_sort`."""
    if keys[0].device.type == "cpu":
        return lexsort_plain(keys)
    bits = list(key_bits) if key_bits is not None \
        else [key_bits_of(k) for k in keys]
    order = None
    for k, b in zip(keys, bits):
        kk = k if order is None else k[order]
        # a float64 key sorts by its order key, not by its value cut to
        # an integer (which would interleave 0.5 with 0.7's equal rows)
        kk = float_key_plain(kk) if kk.is_floating_point() \
            else kk.to(torch.int64)
        _, order = stable_sort(kk.contiguous(), b, order)
    return order
