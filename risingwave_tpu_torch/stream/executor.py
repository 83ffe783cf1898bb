"""Executor base — async message-stream transforms
(port of risingwave_tpu/stream/executor.py).

An executor is a single-consumer stream of Message{Chunk, Barrier,
Watermark} with a schema and identity; executors wrap their inputs and
barriers flow through every executor in order. Here an executor is an
async generator (`execute()`); its device work is PyTorch on tensors,
launched asynchronously on the current CUDA stream.

Left out of this slice (ROADMAP Queue A): StatefulUnaryExecutor, the
template of the other stateful executors.
"""

from __future__ import annotations

from typing import AsyncIterator, Optional

from ..common.chunk import StreamChunk
from ..common.types import Schema
from .message import Barrier, Message, Watermark


class Executor:
    schema: Schema
    identity: str = "Executor"
    pk_indices: tuple[int, ...] = ()

    def execute(self) -> AsyncIterator[Message]:
        raise NotImplementedError

    def fence_tokens(self) -> list:
        """Tensors the epoch fence must wait on at a barrier: stateful
        executors launch more device work while handling the barrier
        (flush/evict/rehash) after their last chunk, so the actor waits
        for the device before reporting the barrier collected. Default:
        delegate to `input`."""
        inp = getattr(self, "input", None)
        return [] if inp is None else inp.fence_tokens()

    def __repr__(self):
        return self.identity


def gather_fence_tokens(node) -> list:
    """Duck-typed fence-token walk for arbitrary chain heads."""
    ft = getattr(node, "fence_tokens", None)
    if callable(ft):
        return ft()
    inp = getattr(node, "input", None)
    return [] if inp is None else gather_fence_tokens(inp)


class StatelessUnaryExecutor(Executor):
    """Common shape: map chunks, forward barriers/watermarks."""

    def __init__(self, input: Executor):
        self.input = input
        self.schema = input.schema
        self.pk_indices = input.pk_indices

    def map_chunk(self, chunk: StreamChunk) -> Optional[StreamChunk]:
        raise NotImplementedError

    def map_watermark(self, wm: Watermark) -> Optional[Watermark]:
        return wm

    def on_barrier(self, barrier: Barrier) -> None:
        pass

    async def execute(self):
        async for msg in self.input.execute():
            if isinstance(msg, StreamChunk):
                out = self.map_chunk(msg)
                if out is not None:
                    yield out
            elif isinstance(msg, Barrier):
                self.on_barrier(msg)
                yield msg
            else:
                wm = self.map_watermark(msg)
                if wm is None:
                    continue
                for w in (wm if isinstance(wm, list) else [wm]):
                    yield w
