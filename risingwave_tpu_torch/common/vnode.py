"""Consistent-hash virtual nodes (port of risingwave_tpu/common/vnode.py).

256 vnodes; vnode = splitmix64 chain over the key columns, mod 256. The
state table places rows by this hash on the host
(`compute_vnodes_numpy`); the device form `compute_vnodes` is entry one
of kernel K31 (csrc/backfill_filter.cu), whose second entry is the
backfill's live-side filter (stream/backfill.py). Both must give the
numpy form's vnodes bit for bit: a backfill decides whether the scan
covered a live row by the vnode the state table placed it in.

Left out (ROADMAP Queue B1): the device `crc32_columns`, which no path
runs; `crc32_numpy` is its host form.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from ..ops import kernels
from ..ops.hashing import GOLDEN, SEED, s64, splitmix64

VNODE_BITS = 8
VNODE_COUNT = 1 << VNODE_BITS  # 256


@lru_cache(maxsize=1)
def _crc32_table_np() -> np.ndarray:
    poly = np.uint32(0xEDB88320)
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = np.uint32(i)
        for _ in range(8):
            c = np.where(c & 1, (c >> np.uint32(1)) ^ poly, c >> np.uint32(1))
        table[i] = c
    return table


def crc32_numpy(columns: Sequence[np.ndarray]) -> np.ndarray:
    """crc32 over the little-endian bytes of fixed-width columns, column
    by column (value-serialization goldens)."""
    table = _crc32_table_np()
    crc = np.full(len(columns[0]), 0xFFFFFFFF, dtype=np.uint32)
    for col in columns:
        col = np.asarray(col)
        if col.dtype == np.bool_:
            col = col.astype(np.uint8)
        nbytes = col.dtype.itemsize
        u = col.view(f"uint{8 * nbytes}").astype(np.uint64)
        for b in range(nbytes):
            byte = ((u >> np.uint64(8 * b)) & np.uint64(0xFF)).astype(np.uint32)
            idx = (crc ^ byte) & np.uint32(0xFF)
            crc = (crc >> np.uint32(8)) ^ table[idx]
    return crc ^ np.uint32(0xFFFFFFFF)


def compute_vnodes_numpy(key_columns: Sequence[np.ndarray]) -> np.ndarray:
    """vnode per row (int32) — must equal the JAX package's device and
    host vnodes bit for bit: state placement keys off it."""
    with np.errstate(over="ignore"):
        h = np.full(len(key_columns[0]), 0x243F6A8885A308D3, dtype=np.uint64)
        for col in key_columns:
            col = np.asarray(col)
            if col.dtype == np.bool_:
                col = col.astype(np.uint8)
            u = col.view(f"uint{8 * col.dtype.itemsize}").astype(np.uint64)
            x = h ^ (u * np.uint64(0x9E3779B97F4A7C15))
            x = x + np.uint64(0x9E3779B97F4A7C15)
            x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
            x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
            h = x ^ (x >> np.uint64(31))
    return (h & np.uint64(VNODE_COUNT - 1)).astype(np.int32)


# ----------------------------------------------------------------- device

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# K31. Replaces common/vnode.py:compute_vnodes (58) and the backfill's
# stream/backfill.py:_filter_impl (81), which runs it.
K_BACKFILL = kernels.register(kernels.CudaKernel(
    "backfill_filter",
    replaces="risingwave_tpu/stream/backfill.py:81",
    functions={
        "rw_compute_vnodes": [ctypes.POINTER(_P), ctypes.POINTER(_I), _I,
                              _L, _P, _P],
        "rw_backfill_filter": [ctypes.POINTER(_P), ctypes.POINTER(_I), _I,
                               ctypes.POINTER(_P), ctypes.POINTER(_I),
                               ctypes.POINTER(_L), _I, _L, _I, _P, _L, _P,
                               _P]}))

# K31's element type codes (csrc/backfill_filter.cu)
VNODE_TYPES = {torch.int64: 0, torch.int32: 1, torch.int16: 2,
               torch.int8: 3, torch.bool: 4, torch.float64: 5}
MAX_KEY_COLS = 4
_UNSIGNED_MASK = {torch.int32: 0xFFFFFFFF, torch.int16: 0xFFFF,
                  torch.int8: 0xFF}


def vnode_lane(col: torch.Tensor) -> torch.Tensor:
    """The uint64 bits (in int64) that the JAX package's
    `col.view(uint{width}).astype(uint64)` gives: the unsigned view of
    the column's own width, zero-extended; a float by its bit pattern;
    a bool 0/1."""
    if col.dtype == torch.bool:
        return col.to(torch.int64)
    if col.dtype == torch.float64:
        return col.view(torch.int64)
    if col.dtype == torch.float32:
        return col.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if col.dtype in _UNSIGNED_MASK:
        return col.to(torch.int64) & _UNSIGNED_MASK[col.dtype]
    return col.to(torch.int64)


def compute_vnodes_plain(key_columns: Sequence[torch.Tensor]
                         ) -> torch.Tensor:
    """Plain PyTorch version of K31's `compute_vnodes`: int32 [N]."""
    h = torch.full((key_columns[0].shape[0],), s64(SEED),
                   dtype=torch.int64, device=key_columns[0].device)
    for c in key_columns:
        h = splitmix64(h ^ (vnode_lane(c) * GOLDEN))
    return (h & (VNODE_COUNT - 1)).to(torch.int32)


def _k31_cols(cols: Sequence[torch.Tensor], dev, what: str):
    if not 1 <= len(cols) <= MAX_KEY_COLS:
        raise ValueError(f"K31 takes 1-{MAX_KEY_COLS} {what} columns")
    n = cols[0].shape[0]
    for c in cols:
        if c.dtype not in VNODE_TYPES or c.device != dev \
                or c.shape != (n,) or not c.is_contiguous():
            raise ValueError(f"K31 takes contiguous [N] int64, int32, "
                             f"int16, int8, bool or float64 {what} "
                             f"columns on the chunk's device, not "
                             f"{c.dtype}")
    return (kernels.ptr_array(cols),
            kernels.int_array(VNODE_TYPES[c.dtype] for c in cols))


def compute_vnodes(key_columns: Sequence[torch.Tensor]) -> torch.Tensor:
    """K31's `compute_vnodes` on a CUDA device, the plain version on the
    CPU: the vnode (int32 [N]) of each row's key columns."""
    dev = key_columns[0].device
    if dev.type == "cpu":
        return compute_vnodes_plain(key_columns)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    cols, types = _k31_cols(key_columns, dev, "key")
    n = key_columns[0].shape[0]
    out = torch.empty(n, dtype=torch.int32, device=dev)
    K_BACKFILL.launches += 1
    K_BACKFILL.call("rw_compute_vnodes", cols, types, len(key_columns), n,
                    kernels.ptr(out), kernels.stream_of(out))
    return out


def pk_scalar(v, dtype: torch.dtype):
    """A pk frontier value as the reference's `jnp.asarray(v, dtype)`
    holds it (a NULL, which that conversion cannot take, as 0: the
    store's NULL-cell convention)."""
    v = 0 if v is None else v
    if dtype == torch.bool:
        return bool(v)
    if dtype.is_floating_point:
        return float(v)
    return int(v)


def backfill_filter_plain(dist_cols: Sequence[torch.Tensor],
                          pk_cols: Sequence[torch.Tensor], pk_vals,
                          cur_vnode: int, has_pk: bool,
                          vis: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K31's `backfill_filter`: the visibility
    after the backfill's live-side filter, `vis & (vn < cur | (vn == cur
    & has_pk & pk <= last_pk))`, the pk compare lexicographic with IEEE
    `<` and `==` per column (-0.0 equals +0.0, NaN compares false)."""
    vn = compute_vnodes_plain(dist_cols).to(torch.int64)
    passed = vn < cur_vnode
    le = torch.ones_like(vis)
    for c, v in zip(reversed(pk_cols), reversed(pk_vals)):
        v = torch.tensor(pk_scalar(v, c.dtype), dtype=c.dtype,
                         device=c.device)
        le = (c < v) | ((c == v) & le)
    passed = passed | ((vn == cur_vnode) & bool(has_pk) & le)
    return vis & passed


def _frontier_bits(v, dtype: torch.dtype) -> int:
    v = pk_scalar(v, dtype)
    if dtype == torch.float64:
        return torch.tensor(v, dtype=torch.float64).view(torch.int64).item()
    return int(v)


def backfill_filter(dist_cols: Sequence[torch.Tensor],
                    pk_cols: Sequence[torch.Tensor], pk_vals,
                    cur_vnode: int, has_pk: bool,
                    vis: torch.Tensor) -> torch.Tensor:
    """K31's `backfill_filter` on a CUDA device, the plain version on the
    CPU. Same contract as `backfill_filter_plain`; a fresh bool [N]."""
    dev = vis.device
    if dev.type == "cpu":
        return backfill_filter_plain(dist_cols, pk_cols, pk_vals, cur_vnode,
                                     has_pk, vis)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n = vis.shape[0]
    if vis.dtype != torch.bool or vis.shape != (n,) \
            or not vis.is_contiguous():
        raise ValueError("K31 takes a contiguous bool visibility")
    dist, dist_types = _k31_cols(dist_cols, dev, "distribution key")
    pk, pk_types = _k31_cols(pk_cols, dev, "pk")
    if len(pk_vals) != len(pk_cols) or dist_cols[0].shape != (n,) \
            or pk_cols[0].shape != (n,):
        raise ValueError("K31: one frontier value per pk column, columns "
                         "of the chunk's length")
    vals = (ctypes.c_longlong * len(pk_cols))(
        *[_frontier_bits(v, c.dtype) for c, v in zip(pk_cols, pk_vals)])
    out = torch.empty_like(vis)
    K_BACKFILL.launches += 1
    K_BACKFILL.call("rw_backfill_filter", dist, dist_types, len(dist_cols),
                    pk, pk_types, vals, len(pk_cols), int(cur_vnode),
                    int(bool(has_pk)), kernels.ptr(vis), n,
                    kernels.ptr(out), kernels.stream_of(vis))
    return out
