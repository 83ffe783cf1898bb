"""Project and filter executors (port of risingwave_tpu/stream/project.py).

A project is a pure chunk -> chunk map. Its expression list runs as one
launch of kernel K5 (expr/program.py); expressions that are bare column
references pass the input column through, so a pure reselection (q7's
`project [$0, $1, $2, $5]`) launches nothing. Output columns are
fresh tensors or the input's own: no executor writes its input, which a
broadcast shares with other consumers.

A filter evaluates its predicate with K5 and then fixes the changelog
ops of update pairs and masks the rows in one launch of kernel K22
(`csrc/filter_ops.cu`); its columns pass through.

Left out of this slice (ROADMAP Queue A): the mesh-chain fusion hooks
(`mesh_hollow`, `mesh_chain_hop`, `mesh_prelude_fn`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ..common.chunk import (
    OP_DELETE, OP_INSERT, OP_UPDATE_DELETE, OP_UPDATE_INSERT, StreamChunk,
)
from ..common.types import Field, Schema
from ..expr.ir import Expr, InputRef
from ..expr.program import ExprProgram
from ..ops import kernels
from .executor import Executor, StatelessUnaryExecutor
from .message import Watermark


class ProjectExecutor(StatelessUnaryExecutor):
    def __init__(self, input: Executor, exprs: Sequence[Expr],
                 names: Optional[Sequence[str]] = None,
                 watermark_mapping: Optional[dict[int, int]] = None,
                 watermark_transforms: Optional[dict] = None):
        super().__init__(input)
        self.exprs = tuple(exprs)
        names = names or [f"expr{i}" for i in range(len(exprs))]
        self.schema = Schema(tuple(Field(n, e.ret_type)
                                   for n, e in zip(names, exprs)))
        # input col idx -> output col idx for watermark passthrough
        self.watermark_mapping = watermark_mapping or {
            e.index: i for i, e in enumerate(self.exprs)
            if isinstance(e, InputRef)
        }
        # input col idx -> (output col idx, host fn) for watermarks through
        # monotone non-decreasing expressions (tumble_start/end); the
        # caller asserts monotonicity by providing the transform
        self.watermark_transforms = dict(watermark_transforms or {})
        self.identity = f"Project({', '.join(map(repr, self.exprs))})"
        self.program = ExprProgram(self.exprs)

    def map_chunk(self, chunk: StreamChunk) -> StreamChunk:
        cols = tuple(self.program.eval(chunk.columns))
        return StreamChunk(cols, chunk.ops, chunk.vis, self.schema)

    def map_watermark(self, wm: Watermark):
        tf = self.watermark_transforms.get(wm.col_idx)
        if tf is not None:
            # one input watermark may fan out to several monotone outputs
            # (tumble: event time -> window_start AND window_end)
            tfs = tf if isinstance(tf, list) else [tf]
            return [Watermark(out_idx, self.schema[out_idx].data_type,
                              fn(wm.val))
                    for out_idx, fn in tfs]
        out = self.watermark_mapping.get(wm.col_idx)
        return wm.with_idx(out) if out is not None else None



_P = ctypes.c_void_p

# K22. Replaces stream/project.py:FilterExecutor._step_impl (103), the
# op fix-up and visibility after the predicate.
K_FILTER = kernels.register(kernels.CudaKernel(
    "filter_ops",
    replaces="risingwave_tpu/stream/project.py:103",
    functions={"rw_filter_fixup": [_P, _P, _P, _P, ctypes.c_longlong, _P,
                                   _P, _P]}))


def filter_fixup_plain(pred_data: torch.Tensor,
                       pred_valid: Optional[torch.Tensor],
                       ops: torch.Tensor, vis: torch.Tensor):
    """Plain PyTorch version of kernel K22: (ops, vis) after the filter.
    NULL filters out; an update pair whose one side fails degrades to
    an Insert or a Delete of the side that passes (the partners are
    read with jnp.roll's wrap-around at both ends)."""
    cond = pred_data.to(torch.bool)
    if pred_valid is not None:
        cond = cond & pred_valid
    is_ud = ops == OP_UPDATE_DELETE
    is_ui = ops == OP_UPDATE_INSERT
    cond_prev = torch.roll(cond, 1)     # for UI rows: partner UD at i-1
    cond_next = torch.roll(cond, -1)    # for UD rows: partner UI at i+1
    new_ops = torch.where(is_ui & cond & ~cond_prev, OP_INSERT, ops)
    new_ops = torch.where(is_ud & cond & ~cond_next, OP_DELETE, new_ops)
    return new_ops.to(ops.dtype), vis & cond


def filter_fixup(pred_data: torch.Tensor, pred_valid: Optional[torch.Tensor],
                 ops: torch.Tensor, vis: torch.Tensor):
    """Kernel K22 on a CUDA device, the plain version on the CPU. Same
    contract as `filter_fixup_plain`; the outputs are fresh tensors."""
    dev = ops.device
    if dev.type == "cpu":
        return filter_fixup_plain(pred_data, pred_valid, ops, vis)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n = ops.shape[0]
    for t in (pred_data, pred_valid, vis):
        if t is not None and (t.dtype != torch.bool or t.shape != (n,)
                              or not t.is_contiguous() or t.device != dev):
            raise ValueError("K22 takes contiguous bool predicate, "
                             "validity and visibility of the chunk's "
                             "length")
    if ops.dtype != torch.int8 or not ops.is_contiguous():
        raise ValueError("K22 takes contiguous int8 ops")
    ops_out = torch.empty_like(ops)
    vis_out = torch.empty_like(vis)
    K_FILTER.launches += 1
    K_FILTER.call("rw_filter_fixup", kernels.ptr(pred_data),
                  kernels.ptr_or_null(pred_valid), kernels.ptr(ops),
                  kernels.ptr(vis), n, kernels.ptr(ops_out),
                  kernels.ptr(vis_out), kernels.stream_of(ops))
    return ops_out, vis_out


class FilterExecutor(StatelessUnaryExecutor):
    """Filter with the changelog op fix-up (reference filter.rs:
    simplified_ops): an update pair whose old row passes but new doesn't
    becomes a Delete; new-passes-only becomes an Insert. Vectorized over
    the pair structure (UpdateDelete at i, UpdateInsert at i+1)."""

    def __init__(self, input: Executor, predicate: Expr):
        super().__init__(input)
        self.predicate = predicate
        self.identity = f"Filter({predicate!r})"
        self.program = ExprProgram([predicate])

    def map_chunk(self, chunk: StreamChunk) -> StreamChunk:
        (pred,) = self.program.eval(chunk.columns)
        ops, vis = filter_fixup(pred.data, pred.valid, chunk.ops, chunk.vis)
        return StreamChunk(chunk.columns, ops, vis, chunk.schema)
