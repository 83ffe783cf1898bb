"""HopWindow executor — stateless sliding-window expansion
(port of risingwave_tpu/stream/hop_window.py).

Each input row is emitted once per window it falls into
(ceil(size / slide) copies) with window_start / window_end appended. The
whole expansion is one launch of kernel K2 (`csrc/hop_window.cu`) that
writes one chunk of capacity K * input capacity: copy k of row i sits at
k * capacity + i and shifts the aligned window start back by k slides.
Only the columns named by `output_indices` are written, so a downstream
column projection costs no extra pass.

Left out of this slice: the mesh-chain fusion hooks (`mesh_hollow`,
`mesh_chain_hop`, `mesh_prelude_fn`).
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from ..common.chunk import Column, StreamChunk
from ..common.types import DataType, Field, Schema
from ..ops import kernels
from .executor import Executor, StatelessUnaryExecutor
from .message import Watermark

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# K2. Replaces stream/hop_window.py:HopWindowExecutor._step_impl (68).
K_HOP = kernels.register(kernels.CudaKernel(
    "hop_window",
    replaces="risingwave_tpu/stream/hop_window.py:68",
    functions={"rw_hop_expand": [
        _P, _P, _P, _I, _I, _L, _L,
        _I, ctypes.POINTER(_P), ctypes.POINTER(_P), ctypes.POINTER(_I),
        _P, _P, _P, _P, _P]}))

MAX_TILED = 16   # tiled arrays one launch takes (csrc/hop_window.cu)


def hop_expand_plain(columns: Sequence[Column], ops: torch.Tensor,
                     vis: torch.Tensor, time_col: int, slide: int,
                     size: int, n_windows: int,
                     output_indices: Sequence[int]):
    """Plain PyTorch version of kernel K2. Returns (columns, ops, vis)."""
    K = n_windows
    cap = ops.shape[0]
    ts = columns[time_col].data
    ks = torch.arange(K, dtype=ts.dtype, device=ts.device).repeat_interleave(cap)

    def tiled(a):
        return a.repeat(K)

    ts_t = tiled(ts)
    # floor division keeps pre-epoch (negative) timestamps right
    ws = (ts_t // slide - ks) * slide
    we = ws + size
    # row in window iff ws <= ts < we; the upper bound can fail when the
    # slide does not divide the size
    vis_t = tiled(vis) & (ts_t < we)
    full = tuple(
        Column(tiled(c.data), None if c.valid is None else tiled(c.valid))
        for c in columns) + (Column(ws), Column(we))
    return tuple(full[i] for i in output_indices), tiled(ops), vis_t


def hop_expand(columns: Sequence[Column], ops: torch.Tensor,
               vis: torch.Tensor, time_col: int, slide: int, size: int,
               n_windows: int, output_indices: Sequence[int]):
    """Kernel K2 on a CUDA device, the plain version on the CPU."""
    device = ops.device
    if device.type == "cpu":
        return hop_expand_plain(columns, ops, vis, time_col, slide, size,
                                n_windows, output_indices)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    cap = ops.shape[0]
    N = n_windows * cap
    ts = columns[time_col].data
    if ts.dtype != torch.int64 or not ts.is_contiguous():
        raise ValueError("hop time column must be contiguous int64")
    if ops.dtype != torch.int8 or vis.dtype != torch.bool:
        raise ValueError("ops must be int8 and vis bool")
    n_in = len(columns)
    srcs, dsts, widths = [], [], []

    def tile_into(src: torch.Tensor) -> torch.Tensor:
        if src.device != device or not src.is_contiguous() \
                or src.shape[0] != cap:
            raise ValueError("hop input columns must be contiguous, on the "
                             "device, of the chunk's capacity")
        out = torch.empty(N, dtype=src.dtype, device=device)
        srcs.append(src)
        dsts.append(out)
        widths.append(src.element_size())
        return out

    i64 = dict(dtype=torch.int64, device=device)
    ws = torch.empty(N, **i64) if n_in in output_indices else None
    we = torch.empty(N, **i64) if n_in + 1 in output_indices else None
    out_cols = []
    for i in output_indices:
        if i < n_in:
            c = columns[i]
            out_cols.append(Column(
                tile_into(c.data),
                None if c.valid is None else tile_into(c.valid)))
        else:
            out_cols.append(Column(ws if i == n_in else we))
    if len(srcs) > MAX_TILED:
        raise ValueError(f"hop window tiles at most {MAX_TILED} arrays")
    vis_out = torch.empty(N, dtype=torch.bool, device=device)
    ops_out = torch.empty(N, dtype=torch.int8, device=device)
    K_HOP.launches += 1
    K_HOP.call("rw_hop_expand", kernels.ptr(ts), kernels.ptr(vis),
               kernels.ptr(ops), cap, n_windows, slide, size,
               len(srcs), kernels.ptr_array(srcs), kernels.ptr_array(dsts),
               kernels.int_array(widths), kernels.ptr_or_null(ws),
               kernels.ptr_or_null(we), kernels.ptr(vis_out),
               kernels.ptr(ops_out), kernels.stream_of(ops))
    return tuple(out_cols), ops_out, vis_out


class HopWindowExecutor(StatelessUnaryExecutor):
    def __init__(self, input: Executor, time_col: int,
                 window_slide_us: int, window_size_us: int,
                 output_indices: Sequence[int] | None = None):
        super().__init__(input)
        if window_size_us <= 0 or window_slide_us <= 0:
            raise ValueError("window size and slide must be positive")
        self.time_col = time_col
        self.slide = window_slide_us
        self.size = window_size_us
        self.n_windows = math.ceil(window_size_us / window_slide_us)
        in_fields = list(input.schema)
        full_fields = in_fields + [Field("window_start", DataType.TIMESTAMP),
                                   Field("window_end", DataType.TIMESTAMP)]
        ws_full, we_full = len(in_fields), len(in_fields) + 1
        # window_start_idx / window_end_idx are OUTPUT positions
        # (-1 = pruned)
        self.output_indices = (tuple(output_indices)
                               if output_indices is not None
                               else tuple(range(len(full_fields))))
        self.schema = Schema(tuple(full_fields[i]
                                   for i in self.output_indices))

        def _outpos(full_idx: int) -> int:
            return (self.output_indices.index(full_idx)
                    if full_idx in self.output_indices else -1)
        self.window_start_idx = _outpos(ws_full)
        self.window_end_idx = _outpos(we_full)
        self.identity = (f"HopWindow(col={time_col}, slide={window_slide_us}"
                         f"us, size={window_size_us}us)")

    def map_chunk(self, chunk: StreamChunk) -> StreamChunk:
        cols, ops, vis = hop_expand(
            chunk.columns, chunk.ops, chunk.vis, self.time_col, self.slide,
            self.size, self.n_windows, self.output_indices)
        return StreamChunk(cols, ops, vis, self.schema)

    def map_watermark(self, wm: Watermark):
        if wm.col_idx == self.time_col:
            # a watermark on event time implies one on window_start lagged
            # by the full window size
            if self.window_start_idx < 0:
                return None
            ws = (wm.val // self.slide - (self.n_windows - 1)) * self.slide
            return Watermark(self.window_start_idx, DataType.TIMESTAMP, ws)
        if wm.col_idx in self.output_indices:
            return wm.with_idx(self.output_indices.index(wm.col_idx))
        return None
