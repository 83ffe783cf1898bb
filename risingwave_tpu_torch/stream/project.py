"""Project executor (port of risingwave_tpu/stream/project.py).

A pure chunk -> chunk map. Its expression list runs as one launch of
kernel K5 (expr/program.py); expressions that are bare column
references pass the input column through, so a pure reselection (q7's
`project [$0, $1, $2, $5]`) launches nothing. Output columns are
fresh tensors or the input's own: no executor writes its input, which a
broadcast shares with other consumers.

Left out of this slice (ROADMAP Queue A): FilterExecutor and the
mesh-chain fusion hooks (`mesh_hollow`, `mesh_chain_hop`,
`mesh_prelude_fn`).
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..common.chunk import StreamChunk
from ..common.types import Field, Schema
from ..expr.ir import Expr, InputRef
from ..expr.program import ExprProgram
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

