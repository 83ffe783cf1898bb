"""Epochs — the global logical clock of the barrier protocol
(port of risingwave_tpu/common/epoch.py).

A 64-bit epoch is physical milliseconds since an engine origin shifted
left 16 bits; the low 16 bits are a sequence. `EpochPair{curr, prev}`
rides every barrier.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

EPOCH_PHYSICAL_SHIFT = 16
# 2022-01-01T00:00:00Z, an arbitrary engine origin
EPOCH_ORIGIN_MS = 1_640_995_200_000

INVALID_EPOCH = 0


def physical_now_ms() -> int:
    return int(time.time() * 1000) - EPOCH_ORIGIN_MS


def from_physical(ms: int) -> int:
    return ms << EPOCH_PHYSICAL_SHIFT


def to_physical(epoch: int) -> int:
    return epoch >> EPOCH_PHYSICAL_SHIFT


def next_epoch(prev: int) -> int:
    """Strictly-increasing epoch from the wall clock (or prev+1 if the
    clock has not advanced a full millisecond)."""
    cand = from_physical(physical_now_ms())
    return cand if cand > prev else prev + 1


@dataclass(frozen=True)
class EpochPair:
    curr: int
    prev: int

    @staticmethod
    def new_initial(curr: int) -> "EpochPair":
        return EpochPair(curr, INVALID_EPOCH)

    def bump(self, new_curr: int) -> "EpochPair":
        return EpochPair(new_curr, self.curr)
