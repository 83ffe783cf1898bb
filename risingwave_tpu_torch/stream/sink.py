"""Device blackhole sink (port of DeviceBlackholeSinkExecutor,
risingwave_tpu/stream/sink.py:183).

Consumes the changelog without host readback: chunks stay on the device
and a small on-device reduction of the last column is kept so callers
can wait on it for drain syncs.

Left out of this slice (ROADMAP Queue A): SinkExecutor and its targets
(file, log-store delivery).
"""

from __future__ import annotations

from ..common.chunk import StreamChunk
from .executor import Executor


class DeviceBlackholeSinkExecutor(Executor):
    def __init__(self, input: Executor):
        self.input = input
        self.schema = input.schema
        self.pk_indices = getattr(input, "pk_indices", ())
        self.identity = "DeviceBlackholeSink"
        self.last = None
        self.chunks = 0

    async def execute(self):
        async for msg in self.input.execute():
            if isinstance(msg, StreamChunk) and msg.columns:
                # a fresh buffer: holding the producer's column would pin
                # state the producer updates in place
                self.last = msg.columns[-1].data.sum()
                self.chunks += 1
            yield msg
