"""Barrier coordinator — the system heartbeat
(port of risingwave_tpu/meta/barrier_manager.py, trimmed).

Paces barrier injection, pushes barriers into every source's dedicated
channel, waits until every actor reports collection, then completes the
epoch in order. Barrier latency (inject -> collected) is the headline
latency metric.

Checkpoint durability is pipelined on a store that can seal (Hummock):
a checkpoint barrier only enqueues its epoch to a background uploader
task, which runs the executors' deferred persist stages (the d2h waits
on a worker thread, their continuations back on the event loop), seals
the shared buffer, builds and uploads the SST on a worker thread and
swaps the manifest on the loop, strictly in epoch order. At most
`checkpoint_max_inflight` checkpoints are in flight; a full window
holds back the next checkpoint barrier's injection. With 0, or on a
store that cannot seal (MemoryStateStore), the store syncs inline.

Left out of this slice (ROADMAP Queue A): the memory and serving
managers, the epoch tracer and stuck-barrier watchdog, metrics history,
scrubber, compactor service, log-store hub, cluster workers, split
enumerators, replay channels and mesh registration.
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


@dataclass
class _UploadJob:
    """One checkpoint handed to the background uploader."""
    prev_epoch: int          # the epoch being made durable
    curr_epoch: int


class BarrierCoordinator:
    def __init__(self, store: StateStore, checkpoint_frequency: int = 1,
                 checkpoint_max_inflight: int = 2):
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
        # epochs whose checkpoint committed, in commit order
        self.committed_epochs: list[int] = []
        # ---- the checkpoint pipeline ----
        self._upload_q: asyncio.Queue = asyncio.Queue()
        self._uploader_task: Optional[asyncio.Task] = None
        self._inflight = 0            # enqueued-but-uncommitted checkpoints
        self._slot_free = asyncio.Event()
        self._slot_free.set()
        self._upload_failure: Optional[BaseException] = None
        self.upload_busy_ns = 0       # background persist+upload+commit
        self.backpressure_wait_ns = 0  # injection stalls on a full window
        # per-checkpoint phase times (ns): seal (deferred stages + seal),
        # upload, commit
        self.upload_phases: list[tuple[int, int, int]] = []
        self.checkpoint_max_inflight = checkpoint_max_inflight

    # ------------------------------------------------- checkpoint pipeline
    @property
    def checkpoint_max_inflight(self) -> int:
        return self._ckpt_max_inflight

    @checkpoint_max_inflight.setter
    def checkpoint_max_inflight(self, n: int) -> None:
        """0 restores the inline-sync path; > 0 bounds the pipeline
        window. Also flips the store's deferred-flush gate, so executors
        defer their persists only when an uploader drains them."""
        self._ckpt_max_inflight = int(n)
        if hasattr(self.store, "defer_enabled"):
            self.store.defer_enabled = self.pipelined
        self._slot_free.set()         # re-evaluate a backpressured waiter

    @property
    def pipelined(self) -> bool:
        return self._ckpt_max_inflight > 0 and hasattr(self.store, "seal")

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
        if self._upload_failure is not None:
            raise RuntimeError(
                "checkpoint upload/commit failed; recovery must replay "
                "from the last committed epoch") from self._upload_failure
        if kind is None:
            self._barrier_count += 1
            is_ckpt = (self._barrier_count % self.checkpoint_frequency) == 0
            kind = BarrierKind.CHECKPOINT if is_ckpt else BarrierKind.BARRIER
        if kind is BarrierKind.CHECKPOINT:
            await self._acquire_ckpt_slot()
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
            if self.pipelined:
                self._enqueue_upload(barrier)
            else:
                self.store.sync(barrier.epoch.prev)
                self.committed_epochs.append(barrier.epoch.prev)
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
            await self.drain_uploads()

    async def stop_all(self, actor_ids: Optional[set[int]] = None) -> None:
        async with self._rounds_lock:
            ids = frozenset(actor_ids if actor_ids is not None
                            else self.actor_ids)
            b = await self.inject_barrier(mutation=StopMutation(ids))
            await self.wait_collected(b)
            await self.drain_uploads()

    # ------------------------------------------------------------ uploader
    def _enqueue_upload(self, barrier: Barrier) -> None:
        self._inflight += 1
        self._upload_q.put_nowait(
            _UploadJob(barrier.epoch.prev, barrier.epoch.curr))
        if self._uploader_task is None or self._uploader_task.done():
            self._uploader_task = asyncio.get_running_loop().create_task(
                self._upload_worker(), name="epoch-uploader")

    async def _acquire_ckpt_slot(self) -> None:
        if not self.pipelined:
            return
        t0 = time.monotonic_ns()
        while (self._inflight >= self._ckpt_max_inflight
               and self.pipelined and self._upload_failure is None
               and self._failure is None):
            self._slot_free.clear()
            await self._slot_free.wait()
        self.backpressure_wait_ns += time.monotonic_ns() - t0

    async def _upload_worker(self) -> None:
        """Drains the checkpoint queue strictly in order: per epoch, run
        the executors' deferred persist stages (each wait on a worker
        thread, each continuation back on the loop, where every device
        launch happens), seal the shared buffer, build and upload the
        SST on a worker thread, then swap the manifest on the loop. A
        failure parks the error for the next inject_barrier (fail-stop:
        recovery replays from the last committed epoch)."""
        store = self.store
        while not self._upload_q.empty():
            job = self._upload_q.get_nowait()
            try:
                t0 = time.monotonic_ns()
                for stages in store.take_deferred(job.prev_epoch):
                    for wait, cont in stages:
                        payload = (await asyncio.to_thread(wait)
                                   if wait is not None else None)
                        cont(payload)
                batch = store.seal(job.prev_epoch)
                t1 = time.monotonic_ns()
                await asyncio.to_thread(store.upload_sealed, batch)
                t2 = time.monotonic_ns()
                store.commit_sealed(batch)
                t3 = time.monotonic_ns()
                self.committed_epochs.append(job.prev_epoch)
                self.upload_busy_ns += t3 - t0
                self.upload_phases.append((t1 - t0, t2 - t1, t3 - t2))
            except asyncio.CancelledError:
                self._inflight -= 1
                self._slot_free.set()
                self._upload_q.task_done()
                raise
            except BaseException as e:  # noqa: BLE001 — park for injection
                self._upload_failure = e
            self._inflight -= 1
            self._slot_free.set()
            self._upload_q.task_done()

    async def drain_uploads(self) -> None:
        """Block until every enqueued checkpoint has committed (or
        failed): the quiesce point for stop and measurement, not part of
        the barrier path."""
        if self._uploader_task is not None:
            await self._upload_q.join()
        if self._upload_failure is not None:
            raise RuntimeError("checkpoint upload/commit failed during "
                               "drain") from self._upload_failure

    async def abort_uploads(self) -> None:
        """Crash entry: cancel the uploader and drop queued jobs without
        committing them. An upload in flight can at worst leave an
        orphan SST no manifest references; the manifest swap never runs
        for an aborted epoch, so `reset_uncommitted` plus replay from
        `committed_epoch` stays exact."""
        t = self._uploader_task
        self._uploader_task = None
        if t is not None and not t.done():
            t.cancel()
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        while not self._upload_q.empty():
            self._upload_q.get_nowait()
            self._upload_q.task_done()
        self._inflight = 0
        self._slot_free.set()

    def upload_overlap_pct(self) -> Optional[float]:
        """% of the background durable-flush busy time hidden behind
        compute: 100 * (1 - injection backpressure / uploader busy).
        None before the first pipelined checkpoint commits."""
        if self.upload_busy_ns <= 0:
            return None
        hidden = max(0, self.upload_busy_ns - self.backpressure_wait_ns)
        return round(100.0 * hidden / self.upload_busy_ns, 1)

    # -------------------------------------------------------------- metrics
    def barrier_latency_percentile(self, p: float) -> float:
        """Seconds; p in [0, 1]."""
        if not self.latencies_ns:
            return 0.0
        xs = sorted(self.latencies_ns)
        i = min(len(xs) - 1, int(p * len(xs)))
        return xs[i] / 1e9
