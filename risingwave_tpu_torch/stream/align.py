"""Two-input barrier alignment for joins (port of
risingwave_tpu/stream/align.py).

Poll both upstreams; a side that yields a barrier is blocked until the
other yields the same barrier, then ONE aligned barrier is delivered.
Chunks and watermarks pass through eagerly, tagged with their side.
When both sides are ready in one pass they are taken in the fixed order
LEFT, RIGHT, so the interleaving does not depend on task addresses.
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator

from ..common.chunk import StreamChunk
from .executor import Executor
from .message import Barrier

LEFT = 0
RIGHT = 1


async def barrier_align(left: Executor,
                        right: Executor) -> AsyncIterator[tuple]:
    """Yields ("chunk"|"watermark", side, msg) and ("barrier", None,
    barrier)."""
    streams = [left.execute().__aiter__(), right.execute().__aiter__()]
    tasks: dict[int, asyncio.Task] = {
        s: asyncio.create_task(anext(streams[s])) for s in (LEFT, RIGHT)}
    pending: dict[int, Barrier] = {}
    done: set[int] = set()
    try:
        while len(done) < 2:
            ready = [tasks[s] for s in (LEFT, RIGHT)
                     if s not in pending and s not in done]
            if not ready:
                # both sides parked on a barrier: emit one aligned barrier
                bl, br = pending[LEFT], pending[RIGHT]
                if bl.epoch.curr != br.epoch.curr:
                    raise RuntimeError(
                        f"misaligned barriers {bl.epoch} vs {br.epoch}")
                yield ("barrier", None, bl)
                pending.clear()
                for s in (LEFT, RIGHT):
                    if s not in done:
                        tasks[s] = asyncio.create_task(anext(streams[s]))
                continue
            finished, _ = await asyncio.wait(
                ready, return_when=asyncio.FIRST_COMPLETED)
            for s in (LEFT, RIGHT):
                t = tasks[s]
                if t not in finished or s in done or s in pending:
                    continue
                try:
                    msg = t.result()
                except StopAsyncIteration:
                    done.add(s)
                    pending.pop(s, None)
                    continue
                if isinstance(msg, Barrier):
                    pending[s] = msg
                elif isinstance(msg, StreamChunk):
                    yield ("chunk", s, msg)
                    tasks[s] = asyncio.create_task(anext(streams[s]))
                else:
                    yield ("watermark", s, msg)
                    tasks[s] = asyncio.create_task(anext(streams[s]))
            # one side exhausted while the other holds a barrier: it can
            # never align; deliver it (stop barriers end streams)
            if done and pending and len(done) + len(pending) == 2:
                b = next(iter(pending.values()))
                yield ("barrier", None, b)
                pending.clear()
                for s in (LEFT, RIGHT):
                    if s not in done:
                        tasks[s] = asyncio.create_task(anext(streams[s]))
    finally:
        for t in tasks.values():
            t.cancel()
