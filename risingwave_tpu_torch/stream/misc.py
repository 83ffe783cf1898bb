"""Small stream executors (port of risingwave_tpu/stream/misc.py, NoOp
only).

Left out of this slice (ROADMAP Queue A): Values, Union, Expand,
FlowControl and WatermarkFilter.
"""

from __future__ import annotations

from ..common.chunk import StreamChunk
from .executor import StatelessUnaryExecutor


class NoOpExecutor(StatelessUnaryExecutor):
    """Identity passthrough (plan-shape padding); no device work."""

    identity = "NoOp"

    def map_chunk(self, chunk: StreamChunk) -> StreamChunk:
        return chunk
