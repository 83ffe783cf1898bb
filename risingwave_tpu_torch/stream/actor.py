"""Actor — the schedulable unit driving one executor chain
(port of risingwave_tpu/stream/actor.py).

An asyncio task pulling the chain's final stream, fanning every message
out through its dispatcher (None for a terminal chain), reporting every
barrier to the coordinator (`collect`) and exiting on a Stop mutation.
Kernel launches are asynchronous, so at each barrier the actor waits for
the device to finish the epoch's work (an epoch fence) before it reports
the barrier collected. A barrier is dispatched before the fence, so
downstream actors start their barrier work while this one waits.

Left out of this slice (ROADMAP Queue A): fault injection, the hollow
(fence-exempt) producers of mesh chains and the monitor's per-phase
timing hooks.
"""

from __future__ import annotations

import asyncio
from typing import Optional, Protocol

import torch

from ..common.chunk import StreamChunk
from .exchange import Dispatcher
from .executor import Executor, gather_fence_tokens
from .message import Barrier


class BarrierCollector(Protocol):
    def collect(self, actor_id: int, barrier: Barrier) -> None: ...


async def fence(tokens) -> None:
    """Wait, in a worker thread, until the device has run everything
    queued so far on the streams of the CUDA tensors in `tokens`."""
    devices = {t.device for t in tokens
               if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        await asyncio.to_thread(ev.synchronize)


class Actor:
    def __init__(self, actor_id: int, consumer: Executor,
                 dispatcher: Optional[Dispatcher],
                 collector: Optional[BarrierCollector]):
        self.actor_id = actor_id
        self.consumer = consumer
        self.dispatcher = dispatcher
        self.collector = collector

    async def run(self) -> None:
        try:
            await self._run_inner()
        except BaseException as e:
            # report the death so barrier collection fails fast instead of
            # hanging the coordinator
            failed = getattr(self.collector, "actor_failed", None)
            if failed is not None:
                failed(self.actor_id, e)
            raise

    async def _run_inner(self) -> None:
        last_token = None
        async for msg in self.consumer.execute():
            if isinstance(msg, StreamChunk):
                if msg.columns:
                    last_token = msg.columns[0].data
                if self.dispatcher is not None:
                    await self.dispatcher.dispatch(msg)
            elif isinstance(msg, Barrier):
                barrier = msg.with_passed(self.actor_id)
                if self.dispatcher is not None:
                    await self.dispatcher.dispatch(barrier)
                # epoch fence: collected only once every device program of
                # the epoch ran (per-chunk work via the last chunk, barrier
                # work via the executors' fence tokens)
                tokens = [] if last_token is None else [last_token]
                tokens.extend(gather_fence_tokens(self.consumer))
                await fence(tokens)
                last_token = None
                if self.collector is not None:
                    self.collector.collect(self.actor_id, barrier)
                if barrier.is_stop(self.actor_id):
                    return
            elif self.dispatcher is not None:
                await self.dispatcher.dispatch(msg)

    def spawn(self) -> asyncio.Task:
        return asyncio.create_task(self.run(), name=f"actor-{self.actor_id}")
