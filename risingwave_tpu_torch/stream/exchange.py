"""Exchange: channels, dispatchers and the channel input — the
intra-process links between actors (port of
risingwave_tpu/stream/exchange.py).

A chunk crosses a channel by reference: every consumer of a broadcast
holds the same tensors, so no executor may write its input in place
(the port's executors write fresh tensors or their own state).

Left out of this slice (ROADMAP Queue A): the channel's replay buffer
and observability hooks, TapDispatcher, HashDispatcher (vnode routing),
FanoutDispatcher, MergeExecutor and the chunk coalescer of ChannelInput.
"""

from __future__ import annotations

import asyncio
from typing import Sequence

from .executor import Executor
from .message import Barrier, Message, StopMutation


class Channel:
    """Bounded single-consumer channel (the reference's permit channel)."""

    def __init__(self, capacity: int = 16):
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=capacity)

    async def send(self, msg: Message) -> None:
        await self.queue.put(msg)

    async def recv(self) -> Message:
        return await self.queue.get()


class Dispatcher:
    async def dispatch(self, msg: Message) -> None:
        raise NotImplementedError


class SimpleDispatcher(Dispatcher):
    def __init__(self, output: Channel):
        self.output = output

    async def dispatch(self, msg: Message) -> None:
        await self.output.send(msg)


class BroadcastDispatcher(Dispatcher):
    def __init__(self, outputs: Sequence[Channel]):
        self.outputs = list(outputs)

    async def dispatch(self, msg: Message) -> None:
        for o in self.outputs:
            await o.send(msg)


class ChannelInput(Executor):
    """Executor over a channel (the reference's ReceiverExecutor).

    `stop_on(barrier) -> bool` decides which Stop barrier ends the
    stream; None ends it on any Stop."""

    def __init__(self, channel: Channel, schema, stop_on=None):
        self.channel = channel
        self.schema = schema
        self.stop_on = stop_on
        self.identity = "ChannelInput"

    async def execute(self):
        while True:
            msg = await self.channel.recv()
            yield msg
            if isinstance(msg, Barrier) \
                    and isinstance(msg.mutation, StopMutation):
                if self.stop_on is None or self.stop_on(msg):
                    return
