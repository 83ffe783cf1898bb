"""Executor base — async message-stream transforms
(port of risingwave_tpu/stream/executor.py).

An executor is a single-consumer stream of Message{Chunk, Barrier,
Watermark} with a schema and identity; executors wrap their inputs and
barriers flow through every executor in order. Here an executor is an
async generator (`execute()`); its device work is PyTorch on tensors,
launched asynchronously on the current CUDA stream.

`StatefulUnaryExecutor` is the barrier template of single-input
stateful executors (the retractable top-N); the hash agg keeps its own
loop, as in the JAX package.
"""

from __future__ import annotations

from typing import AsyncIterator, Optional

from ..common.chunk import StreamChunk
from ..common.types import Schema
from .message import Barrier, BarrierKind, Message, Watermark


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


class StatefulUnaryExecutor(Executor):
    """Template for single-input stateful executors — the barrier
    protocol in one place:

      first/INITIAL barrier  -> init_epoch + recover, no flush
      data chunk             -> on_chunk (device launches, no transfers)
      barrier                -> watchdog fail-stop BEFORE the checkpoint
                                commits, then flush -> persist -> emit

    Subclasses implement the hooks; `watchdog_interval` must be 1 (check
    every barrier) or None (transfer-free mode, no device-to-host fetch
    ever)."""

    state_table = None

    def _init_stateful(self, state_table, watchdog_interval) -> None:
        if watchdog_interval not in (None, 1):
            raise ValueError(
                "watchdog_interval must be 1 (check before every checkpoint "
                "commit) or None (transfer-free mode): any lag would let a "
                "checkpoint commit unverified state")
        self.state_table = state_table
        self.watchdog_interval = watchdog_interval
        self._applied_since_flush = False

    # ------------------------------------------------------------- hooks
    def on_chunk(self, chunk: StreamChunk) -> Optional[StreamChunk]:
        """Apply a chunk; return an output chunk to emit now (or None)."""
        raise NotImplementedError

    def check_watchdog(self) -> None:
        """Fetch device error counters; raise to fail-stop pre-commit."""

    def flush(self) -> Optional[StreamChunk]:
        """Barrier-time changelog emission (None = nothing to emit)."""
        return None

    def persist(self, barrier: Barrier,
                flushed: Optional[StreamChunk]) -> None:
        """Write state rows + commit the state table at this barrier."""
        if self.state_table is not None:
            self.state_table.commit(barrier.epoch.curr)

    def recover_state(self, epoch: int) -> None:
        """Rebuild device state from the state table (INITIAL barrier)."""

    def on_clean_barrier(self, barrier: Barrier) -> None:
        """Post-persist barrier work (eviction/purge/rebuild)."""

    def map_watermark(self, wm: Watermark) -> Optional[Watermark]:
        return wm

    # ---------------------------------------------------------- template
    async def execute(self):
        first = True
        async for msg in self.input.execute():
            if isinstance(msg, StreamChunk):
                out = self.on_chunk(msg)
                self._applied_since_flush = True
                if out is not None:
                    yield out
            elif isinstance(msg, Barrier):
                if first or msg.kind is BarrierKind.INITIAL:
                    first = False
                    if self.state_table is not None:
                        self.state_table.init_epoch(msg.epoch.curr)
                        self.recover_state(msg.epoch.curr)
                    yield msg
                    continue
                stopping = msg.mutation is not None and msg.is_stop_any()
                if self.watchdog_interval and (
                        stopping or self._applied_since_flush):
                    self.check_watchdog()
                flushed = None
                if self._applied_since_flush:
                    self._applied_since_flush = False
                    flushed = self.flush()
                self.persist(msg, flushed)
                self.on_clean_barrier(msg)
                if flushed is not None:
                    yield flushed
                yield msg
            else:
                out = self.map_watermark(msg)
                if out is None:
                    continue
                for w in (out if isinstance(out, list) else [out]):
                    yield w


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
