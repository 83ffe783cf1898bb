"""Monotone watermark transforms of the TUMBLE projection (port of
risingwave_tpu/frontend/binder.py:136-152, TumbleStartTransform and
TumbleEndTransform).

A Project that computes tumble_start / tumble_end of an event-time column
maps a watermark on that column to one on each window column with these
host callables (`watermark_transforms`). They are classes, not closures,
so a plan holding them pickles.
"""

from __future__ import annotations


class TumbleStartTransform:
    """v -> window_start(v) = v - v % size (floor modulo)."""

    __slots__ = ("size",)

    def __init__(self, size: int):
        self.size = size

    def __call__(self, v):
        return v - v % self.size


class TumbleEndTransform(TumbleStartTransform):
    """v -> window_end(v) = window_start(v) + size."""

    def __call__(self, v):
        return (v - v % self.size) + self.size
