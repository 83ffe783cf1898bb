"""Source executor (port of risingwave_tpu/stream/source.py, single
connector).

The stream is a select over (dedicated barrier channel, connector
chunks); barriers always win, Pause/Resume/Throttle mutations gate the
connector side, and the connector offset is committed to a state table at
each barrier so recovery reseeks it.

Flow control: kernel launches are asynchronous, so without a bound the
host would queue chunks far ahead of the device. One CUDA event per
emitted chunk bounds the chunks in flight (`max_inflight_chunks`); the
host waits on the oldest in a worker thread, keeping the event loop live.

Left out of this slice (ROADMAP Queue A): split assignment and discovery
(`splits=`, AddSplitsMutation), per-split metrics and the offset history
of the broker retention plane.
"""

from __future__ import annotations

import asyncio
from collections import deque
from typing import Optional, Protocol

import torch

from ..common.chunk import StreamChunk
from ..common.types import DataType, Schema
from ..state.state_table import StateTable
from .executor import Executor
from .message import Barrier, ResumeMutation, ThrottleMutation, Watermark


class Connector(Protocol):
    schema: Schema
    offset: int

    def next_chunk(self) -> StreamChunk: ...
    def seek(self, offset: int) -> None: ...


class SourceExecutor(Executor):
    def __init__(self, source_id: int, connector: Connector,
                 barrier_queue: "asyncio.Queue[Barrier]",
                 state_table: Optional[StateTable] = None,
                 rate_limit_rows_per_barrier: Optional[int] = None,
                 emit_watermarks: bool = False,
                 watermark_lag_us: int = 0,
                 max_inflight_chunks: int = 16):
        self.source_id = source_id
        self.connector = connector
        self.schema = connector.schema
        self.barrier_queue = barrier_queue
        self.state_table = state_table
        self.rate_limit = rate_limit_rows_per_barrier
        self.identity = f"Source({source_id})"
        self.paused = False
        # connector-declared watermarks, computed on the host (no device
        # readback); the source emits one after each chunk
        self.emit_watermarks = emit_watermarks and hasattr(
            connector, "current_watermark")
        self.watermark_lag_us = watermark_lag_us
        self._last_wm: Optional[int] = None
        self.max_inflight_chunks = max_inflight_chunks
        self._inflight: deque = deque()

    async def _acquire_credit(self) -> None:
        while len(self._inflight) >= self.max_inflight_chunks:
            ev = self._inflight.popleft()
            await asyncio.to_thread(ev.synchronize)

    def _note_inflight(self, chunk: StreamChunk) -> None:
        if chunk.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(chunk.device))
            self._inflight.append(ev)

    def _recover_offset(self) -> None:
        if self.state_table is None:
            return
        row = self.state_table.get_row((0,))
        if row is not None:
            self.connector.seek(row[1])

    def _commit_offset(self, barrier: Barrier) -> None:
        if self.state_table is None:
            return
        # (split_id, next_offset) rides the same epoch commit as operator
        # state => exactly-once resume
        self.state_table.write_chunk_rows([(0, (0, self.connector.offset))])
        self.state_table.commit(barrier.epoch.curr)

    async def execute(self):
        # first message is always the Initial barrier
        barrier = await self.barrier_queue.get()
        if self.state_table is not None:
            self.state_table.init_epoch(barrier.epoch.curr)
        self._recover_offset()
        self._apply_mutation(barrier)
        yield barrier

        sent_this_interval = 0
        while True:
            if self.paused:
                barrier = await self.barrier_queue.get()
            else:
                try:
                    barrier = self.barrier_queue.get_nowait()
                except asyncio.QueueEmpty:
                    barrier = None
            if barrier is None and self.rate_limit is not None \
                    and sent_this_interval >= self.rate_limit:
                # throttled: wait for the next barrier
                barrier = await self.barrier_queue.get()
            if barrier is not None:
                self._apply_mutation(barrier)
                self._commit_offset(barrier)
                yield barrier
                sent_this_interval = 0
                if barrier.is_stop(self.source_id):
                    return
                continue
            await self._acquire_credit()
            chunk = self.connector.next_chunk()
            self._note_inflight(chunk)
            # generators fill every chunk, so capacity is the row count
            # (no per-chunk device->host sync)
            sent_this_interval += chunk.capacity
            yield chunk
            if self.emit_watermarks:
                wm = self.connector.current_watermark() - self.watermark_lag_us
                if self._last_wm is None or wm > self._last_wm:
                    self._last_wm = wm
                    yield Watermark(self.connector.watermark_col,
                                    DataType.TIMESTAMP, wm)
            # let barriers/other actors in
            await asyncio.sleep(0)

    def _apply_mutation(self, barrier: Barrier) -> None:
        if barrier.is_pause():
            self.paused = True
        if isinstance(barrier.mutation, ResumeMutation):
            self.paused = False
        if isinstance(barrier.mutation, ThrottleMutation):
            for actor_id, limit in barrier.mutation.limits:
                if actor_id == self.source_id:
                    self.rate_limit = limit
