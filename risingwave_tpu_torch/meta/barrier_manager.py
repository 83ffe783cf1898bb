"""Barrier coordinator — the system heartbeat
(port of risingwave_tpu/meta/barrier_manager.py, trimmed).

Paces barrier injection, pushes barriers into every source's dedicated
channel, waits until every actor reports collection, then completes the
epoch in order: a checkpoint barrier syncs the store at the epoch it
seals. Barrier latency (inject -> collected) is the headline latency
metric.

Left out of this slice (ROADMAP Queue A): the pipelined background
uploader (`checkpoint_max_inflight`), the memory and serving managers,
the epoch tracer and stuck-barrier watchdog, metrics history, scrubber,
compactor, log-store hub, cluster workers, split enumerators, replay
channels and mesh registration. Checkpoints sync inline.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Optional

from ..common.epoch import EpochPair, next_epoch, INVALID_EPOCH
from ..state.store import StateStore
from ..stream.message import Barrier, BarrierKind, Mutation, StopMutation


@dataclass
class EpochState:
    barrier: Barrier
    remaining: set[int]
    done: asyncio.Event = field(default_factory=asyncio.Event)


class BarrierCoordinator:
    def __init__(self, store: StateStore, checkpoint_frequency: int = 1):
        self.store = store
        self.checkpoint_frequency = checkpoint_frequency
        self.source_queues: list[asyncio.Queue] = []
        self.actor_ids: set[int] = set()
        self._epochs: dict[int, EpochState] = {}
        # post-restart epochs must be strictly greater than anything a
        # previous incarnation committed
        self._prev_epoch = store.committed_epoch()
        self._barrier_count = 0
        self._started = False
        self.latencies_ns: list[int] = []
        self._failure: Optional[tuple] = None
        # serializes whole rounds (inject..collect) across callers
        self._rounds_lock = asyncio.Lock()

    def register_source(self, queue: asyncio.Queue) -> None:
        self.source_queues.append(queue)

    def register_actor(self, actor_id: int) -> None:
        self.actor_ids.add(actor_id)

    # ----------------------------------------------------------- collection
    def collect(self, actor_id: int, barrier: Barrier) -> None:
        st = self._epochs.get(barrier.epoch.curr)
        if st is None:
            return
        st.remaining.discard(actor_id)
        if not st.remaining:
            st.done.set()

    def actor_failed(self, actor_id: int, exc: BaseException) -> None:
        """A dead actor can never collect, so every in-flight and future
        barrier wait fails fast instead of hanging the coordinator."""
        if self._failure is None:
            self._failure = (actor_id, exc)
        for st in self._epochs.values():
            st.done.set()

    # ------------------------------------------------------------ injection
    async def inject_barrier(self, mutation: Optional[Mutation] = None,
                             kind: Optional[BarrierKind] = None) -> Barrier:
        if self._failure is not None:
            actor_id, exc = self._failure
            raise RuntimeError(f"actor {actor_id} died") from exc
        if kind is None:
            self._barrier_count += 1
            is_ckpt = (self._barrier_count % self.checkpoint_frequency) == 0
            kind = BarrierKind.CHECKPOINT if is_ckpt else BarrierKind.BARRIER
        curr = next_epoch(self._prev_epoch)
        epoch = EpochPair(curr, self._prev_epoch)
        barrier = Barrier(epoch, kind, mutation, (), time.monotonic_ns())
        self._epochs[curr] = EpochState(barrier, set(self.actor_ids))
        self._prev_epoch = curr
        for q in self.source_queues:
            await q.put(barrier)
        return barrier

    async def wait_collected(self, barrier: Barrier) -> None:
        st = self._epochs[barrier.epoch.curr]
        await st.done.wait()
        if self._failure is not None:
            actor_id, exc = self._failure
            raise RuntimeError(
                f"actor {actor_id} died; epoch {barrier.epoch.curr} cannot "
                f"complete — recovery must restart from the last committed "
                f"checkpoint") from exc
        # complete IN ORDER: this epoch seals epoch.prev
        if (barrier.kind is BarrierKind.CHECKPOINT
                and barrier.epoch.prev != INVALID_EPOCH):
            self.store.sync(barrier.epoch.prev)
        self.latencies_ns.append(time.monotonic_ns() - barrier.inject_time_ns)
        del self._epochs[barrier.epoch.curr]

    async def run_rounds(self, n: int,
                         interval_s: Optional[float] = None) -> None:
        """Inject n barriers, waiting for each to complete. The very first
        barrier of this coordinator's life is Initial; later calls
        continue the normal cadence. interval_s=None => as fast as
        collection allows."""
        async with self._rounds_lock:
            if not self._started:
                self._started = True
                b = await self.inject_barrier(kind=BarrierKind.INITIAL)
                await self.wait_collected(b)
            for _ in range(n):
                if interval_s:
                    await asyncio.sleep(interval_s)
                b = await self.inject_barrier()
                await self.wait_collected(b)

    async def stop_all(self, actor_ids: Optional[set[int]] = None) -> None:
        async with self._rounds_lock:
            ids = frozenset(actor_ids if actor_ids is not None
                            else self.actor_ids)
            b = await self.inject_barrier(mutation=StopMutation(ids))
            await self.wait_collected(b)

    # -------------------------------------------------------------- metrics
    def barrier_latency_percentile(self, p: float) -> float:
        """Seconds; p in [0, 1]."""
        if not self.latencies_ns:
            return 0.0
        xs = sorted(self.latencies_ns)
        i = min(len(xs) - 1, int(p * len(xs)))
        return xs[i] / 1e9
