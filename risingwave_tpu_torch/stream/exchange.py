"""Exchange: channels, dispatchers and the channel input — the
intra-process links between actors (port of
risingwave_tpu/stream/exchange.py).

A chunk crosses a channel by reference: every consumer of a broadcast
holds the same tensors, so no executor may write its input in place
(the port's executors write fresh tensors or their own state).

An MV's root actor dispatches through a TapDispatcher, which an MV or
sink built on that MV extends with its channel while the upstream runs.

Left out of this slice (ROADMAP Queue A): the channel's replay buffer
and observability hooks, HashDispatcher (vnode routing),
MergeExecutor and the chunk coalescer of ChannelInput.
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


class TapDispatcher(Dispatcher):
    """A fanout that grows at run time, on an MV's root: a `CREATE
    MATERIALIZED VIEW (or SINK) ... FROM <mv>` attaches its channel here
    while the upstream deployment runs. Attach and detach happen between
    barriers (the session holds the coordinator's rounds lock), so every
    consumer sees a barrier-aligned suffix of the stream.

    A Stop barrier whose actors cover all of a channel's consumer actors
    removes that channel right after the barrier is delivered: nobody
    drains it afterwards, and the upstream actor would block on its
    bounded capacity."""

    def __init__(self):
        self.channels: list = []          # (Channel, consumer actor ids)

    def add(self, channel: Channel, consumer_actor_ids=frozenset()) -> None:
        self.channels.append((channel, frozenset(consumer_actor_ids)))

    def remove(self, channel: Channel) -> None:
        self.channels = [(c, ids) for c, ids in self.channels
                         if c is not channel]

    async def dispatch(self, msg: Message) -> None:
        for ch, ids in list(self.channels):
            await ch.send(msg)
            if (isinstance(msg, Barrier) and ids
                    and isinstance(msg.mutation, StopMutation)
                    and ids <= msg.mutation.actor_ids):
                self.remove(ch)


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
    stream; None ends it on any Stop. A shared coordinator routes every
    deployment's Stop through a tap, so a consumer's input ends only on
    a Stop of its own actor (`actor_id`)."""

    def __init__(self, channel: Channel, schema, stop_on=None,
                 actor_id=None):
        self.channel = channel
        self.schema = schema
        self.stop_on = stop_on
        self.actor_id = actor_id
        self.identity = "ChannelInput"

    async def execute(self):
        while True:
            msg = await self.channel.recv()
            yield msg
            if isinstance(msg, Barrier) \
                    and isinstance(msg.mutation, StopMutation):
                if self.stop_on is None or self.stop_on(msg):
                    return
