"""State store interfaces + in-memory implementation
(port of risingwave_tpu/state/store.py).

Epoch-versioned KV with table-scoped reads and a per-epoch `sync` for
checkpoint durability. Keys follow the layout
`table_id ++ vnode ++ memcomparable(pk)` so range scans per vnode are
contiguous. `MemoryStateStore` is a sorted map with per-epoch shared
buffers; epochs are tracked for sync semantics but everything stays in
RAM.

Left out of this slice (ROADMAP Queue A): the deferred-flush protocol
(`defer_flush`, `take_deferred`, `run_deferred`) that durable executors
use to overlap their barrier persist with the stream, per-fragment
`discard_staged_tables`, committed-only and epoch-bounded reads
(`get_committed`, `get_many`, `iter_range(committed_only, max_epoch)`),
`reset_uncommitted`, and the durable LSM store.
"""

from __future__ import annotations

import bisect
import heapq
from dataclasses import dataclass
from typing import Iterator, Optional


def encode_table_key(table_id: int, vnode: int, pk_bytes: bytes) -> bytes:
    return table_id.to_bytes(4, "big") + vnode.to_bytes(1, "big") + pk_bytes


def lazy_merge_ranges(streams):
    """K-way merge of (key, value|None) iterators, each ascending by key,
    ordered NEWEST FIRST; yields live (key, value) lazily with the newest
    version of each key winning."""
    h = []
    for pri, it in enumerate(streams):
        it = iter(it)
        for k, v in it:
            heapq.heappush(h, (k, pri, v, it))
            break
    prev_key = None
    while h:
        k, pri, v, it = heapq.heappop(h)
        for nk, nv in it:
            heapq.heappush(h, (nk, pri, nv, it))
            break
        if k == prev_key:
            continue
        prev_key = k
        if v is not None:
            yield k, v


@dataclass
class WriteBatch:
    table_id: int
    epoch: int
    # key -> value (None = tombstone/delete)
    puts: dict[bytes, Optional[bytes]]


class StateStore:
    """Epoch-versioned KV. Writes are staged per epoch; `sync(epoch)`
    makes everything up to `epoch` durable."""

    def get(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def iter_range(self, start: bytes, end: bytes
                   ) -> Iterator[tuple[bytes, bytes]]:
        """Live (key, value) pairs in [start, end), staged epochs
        included, ascending by key."""
        raise NotImplementedError

    def ingest_batch(self, batch: WriteBatch) -> None:
        raise NotImplementedError

    def sync(self, epoch: int) -> dict:
        """Make everything sealed up to `epoch` durable."""
        raise NotImplementedError

    def committed_epoch(self) -> int:
        raise NotImplementedError


class MemoryStateStore(StateStore):
    """Sorted base map + per-epoch shared buffers: `ingest_batch` stages,
    `sync` applies destructively."""

    def __init__(self):
        self._keys: list[bytes] = []       # sorted, synced base
        self._vals: dict[bytes, bytes] = {}
        self._shared: dict[int, dict[bytes, Optional[bytes]]] = {}
        self._committed_epoch = 0

    def get(self, key: bytes) -> Optional[bytes]:
        for epoch in sorted(self._shared, reverse=True):
            buf = self._shared[epoch]
            if key in buf:
                return buf[key]
        return self._vals.get(key)

    def iter_range(self, start: bytes, end: bytes):
        streams = [sorted((k, v) for k, v in self._shared[e].items()
                          if start <= k < end)
                   for e in sorted(self._shared, reverse=True)]  # newest 1st

        def base():
            i = bisect.bisect_left(self._keys, start)
            while i < len(self._keys) and self._keys[i] < end:
                k = self._keys[i]
                yield k, self._vals[k]
                i += 1
        streams.append(base())
        yield from lazy_merge_ranges(streams)

    def ingest_batch(self, batch: WriteBatch) -> None:
        self._shared.setdefault(batch.epoch, {}).update(batch.puts)

    def sync(self, epoch: int) -> dict:
        for e in sorted(e for e in self._shared if e <= epoch):
            for k, v in self._shared.pop(e).items():
                if v is None:
                    if k in self._vals:
                        del self._vals[k]
                        i = bisect.bisect_left(self._keys, k)
                        if i < len(self._keys) and self._keys[i] == k:
                            self._keys.pop(i)
                else:
                    if k not in self._vals:
                        bisect.insort(self._keys, k)
                    self._vals[k] = v
        self._committed_epoch = max(self._committed_epoch, epoch)
        return {"uncommitted_ssts": []}

    def committed_epoch(self) -> int:
        return self._committed_epoch
