"""Stream messages: Chunk | Barrier | Watermark
(port of risingwave_tpu/stream/message.py).

Reference: src/stream/src/executor/mod.rs:228-406 (Barrier, Mutation),
:690-762 (Watermark), :765-833 (Message). Barriers carry ALL reconfiguration
(scale, new jobs, pause/resume, throttle) as mutations — configuration changes
ride the data stream so they are totally ordered with data, which is the
property that makes elastic scaling exactly-once. The protocol stays on the
host control plane; only chunk *processing* runs on the device.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Optional, Union

from ..common.chunk import StreamChunk
from ..common.epoch import EpochPair
from ..common.types import DataType


class BarrierKind(enum.Enum):
    INITIAL = "initial"        # first barrier after (re)start; no prev state
    BARRIER = "barrier"        # pace-keeping, no durability
    CHECKPOINT = "checkpoint"  # state must be synced durable at this epoch


# --- mutations (reference Mutation enum, executor/mod.rs:245-280) ---------

@dataclass(frozen=True)
class StopMutation:
    actor_ids: frozenset[int]


@dataclass(frozen=True)
class PauseMutation:
    pass


@dataclass(frozen=True)
class ResumeMutation:
    pass


@dataclass(frozen=True)
class ThrottleMutation:
    # actor id -> rows/sec limit (None lifts the limit)
    limits: tuple[tuple[int, Optional[int]], ...]


@dataclass(frozen=True)
class AddMutation:
    """New downstream actors added (CREATE MV); may pause the sources."""
    added_actor_ids: frozenset[int] = frozenset()
    pause: bool = False


@dataclass(frozen=True)
class UpdateMutation:
    """Reschedule: vnode bitmap changes per actor (elastic scaling)."""
    # actor id -> new vnode bitmap (numpy bool[256] as tuple for hashability)
    vnode_bitmaps: tuple[tuple[int, Any], ...] = ()
    dropped_actors: frozenset[int] = frozenset()


@dataclass(frozen=True)
class AddSplitsMutation:
    """Split discovery (reference: SourceManager split assignment riding
    a barrier, source_manager.rs): newly-discovered source splits reach
    their assigned actors totally ordered with data — the actor adopts
    them at barrier receipt and commits their offsets from the SAME
    barrier on. In-process only (live connector objects ride along;
    cluster deploys reject discovery-managed sources in v1)."""
    # source actor id -> ((split_id, connector), ...)
    assignments: dict = field(default_factory=dict)


Mutation = Union[StopMutation, PauseMutation, ResumeMutation,
                 ThrottleMutation, AddMutation, UpdateMutation,
                 AddSplitsMutation]


@dataclass(frozen=True)
class Barrier:
    epoch: EpochPair
    kind: BarrierKind = BarrierKind.CHECKPOINT
    mutation: Optional[Mutation] = None
    passed_actors: tuple[int, ...] = ()
    # host wall-clock when meta injected it (barrier-latency metric source)
    inject_time_ns: int = 0

    @property
    def is_checkpoint(self) -> bool:
        return self.kind is BarrierKind.CHECKPOINT

    def is_stop(self, actor_id: int) -> bool:
        return isinstance(self.mutation, StopMutation) and actor_id in self.mutation.actor_ids

    def is_stop_any(self) -> bool:
        """True for any Stop mutation regardless of target actor — used by
        executors (which don't know their actor id) for end-of-life work."""
        return isinstance(self.mutation, StopMutation)

    def is_pause(self) -> bool:
        return isinstance(self.mutation, PauseMutation) or (
            isinstance(self.mutation, AddMutation) and self.mutation.pause)

    def with_passed(self, actor_id: int) -> "Barrier":
        return Barrier(self.epoch, self.kind, self.mutation,
                       self.passed_actors + (actor_id,), self.inject_time_ns)


@dataclass(frozen=True)
class Watermark:
    """Monotonic lower bound: no future row has col < val
    (reference executor/mod.rs:690)."""
    col_idx: int
    data_type: DataType
    val: Any

    def with_idx(self, idx: int) -> "Watermark":
        return Watermark(idx, self.data_type, self.val)


Message = Union[StreamChunk, Barrier, Watermark]


def is_chunk(m: Message) -> bool:
    return isinstance(m, StreamChunk)
