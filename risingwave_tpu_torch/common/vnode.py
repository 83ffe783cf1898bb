"""Consistent-hash virtual nodes, host form (port of the numpy half of
risingwave_tpu/common/vnode.py).

256 vnodes; vnode = splitmix64 chain over the key columns, mod 256. The
state table places rows by this hash on the host. The device form
(`compute_vnodes`) is not on the q5 path and waits in ROADMAP Queue B1.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np

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
