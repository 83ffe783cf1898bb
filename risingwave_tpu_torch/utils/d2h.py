"""Packed device-to-host fetches (port of risingwave_tpu/utils/d2h.py).

A durable executor's persist ships its payload in two copies: first the
counts the host needs, then ONE packed int64 buffer holding every row
that changed (floats bitcast, narrower ints widened). Kernels K17 and
K18 write their output in this packed layout directly; `pack_rows` is
the plain version of that layout for their CPU paths.

A copy is launched on the event loop's thread into pinned host memory
with `non_blocking=True`, and a CUDA event is recorded after it
(`PendingFetch`). Its `wait()` only synchronizes that event, so the
checkpoint uploader may run it on a worker thread while the event loop
keeps launching work (the rule of the JAX package's `fetch_flat`:
everything that launches device work stays on one thread).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

# fetch statistics (read by chip_smoke.py's durable phases)
STATS = {"fetches": 0, "bytes": 0}


class PendingFetch:
    """A device-to-host copy of `t` in flight."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))
        else:
            self.host = t.clone()
            self.event = None
        STATS["fetches"] += 1
        STATS["bytes"] += t.numel() * t.element_size()

    def wait(self) -> np.ndarray:
        """Block until the copy landed; a pure wait (no launch)."""
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def as_i64_lanes(c: torch.Tensor) -> torch.Tensor:
    """A column as int64 lanes: floats by their float64 bits, integers
    and bools widened."""
    if c.dtype == torch.float64:
        return c.view(torch.int64)
    if c.dtype == torch.float32:
        return c.to(torch.float64).view(torch.int64)
    return c.to(torch.int64)


def pack_rows(cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain packing of n rows of K columns into int64 [n * K], row
    major: element r * K + c is column c of row r."""
    return torch.stack([as_i64_lanes(c) for c in cols], dim=1).reshape(-1)


def unpack_rows(flat: np.ndarray, n: int,
                dtypes: Sequence[np.dtype]) -> list[np.ndarray]:
    """Inverse of `pack_rows` on the host: the first n rows of a packed
    buffer, one numpy array per column in its own dtype."""
    k = len(dtypes)
    mat = np.asarray(flat[:n * k], dtype=np.int64).reshape(n, k)
    out = []
    for j, dt in enumerate(np.dtype(d) for d in dtypes):
        c = np.ascontiguousarray(mat[:, j])
        if dt.kind == "f":
            out.append(c.view(np.float64).astype(dt, copy=False))
        elif dt == np.int64:
            out.append(c)
        else:
            out.append(c.astype(dt))
    return out
