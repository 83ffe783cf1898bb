"""State store interfaces + in-memory implementation
(port of risingwave_tpu/state/store.py).

Epoch-versioned KV with table-scoped reads and a per-epoch `sync` for
checkpoint durability. Keys follow the layout
`table_id ++ vnode ++ memcomparable(pk)` so range scans per vnode are
contiguous. `MemoryStateStore` is a sorted map with per-epoch shared
buffers; epochs are tracked for sync semantics but everything stays in
RAM.

The durable LSM store is `hummock.py`. Both stores carry the
deferred-flush protocol (`defer_flush`, `take_deferred`, `run_deferred`)
that durable executors use to overlap their barrier persist with the
stream, committed-only and epoch-bounded reads and `reset_uncommitted`.
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
    makes everything up to `epoch` durable.

    Deferred-flush protocol (the checkpoint pipeline's hook): a stateful
    executor's barrier-time persist splits into a device half that
    launches at the barrier and a staged host half registered here with
    `defer_flush(epoch, *stages)`, each stage a `(wait, cont)` pair:

      * `wait()` -> payload: a PURE wait (`utils/d2h.py`'s
        `PendingFetch.wait`, an event synchronize). The background
        uploader runs it on a worker thread. It MUST NOT launch work on
        the card: every launch stays on the event loop's thread.
      * `cont(payload)`: runs on the event loop; may launch follow-up
        device work (count-dependent prefix copies) and write and commit
        state tables.

    With `defer_enabled` False (the default, and the inline-sync mode)
    all stages run at once, in order. The barrier coordinator's
    background uploader enables deferral and drains the queue before it
    seals each epoch."""

    def __init__(self):
        # FIFO of (epoch, stages, table_id); epoch = the shared-buffer
        # epoch the flush writes into (it runs before that epoch seals)
        self._deferred: list[tuple] = []
        self.defer_enabled = False

    @staticmethod
    def _run_stages(stages) -> None:
        for wait, cont in stages:
            cont(wait() if wait is not None else None)

    def defer_flush(self, epoch: int, *stages, table_id=None) -> None:
        if self.defer_enabled:
            self._deferred.append((epoch, stages, table_id))
        else:
            self._run_stages(stages)

    def take_deferred(self, epoch: int) -> list[tuple]:
        """Pop every stage list registered for epochs <= epoch, in
        registration order."""
        taken = [st for e, st, _t in self._deferred if e <= epoch]
        self._deferred = [t for t in self._deferred if t[0] > epoch]
        return taken

    def discard_staged_tables(self, table_ids) -> None:
        """Drop the staged (uncommitted shared-buffer) writes and pending
        deferred flushes of exactly these tables."""
        ids = set(table_ids)
        self._deferred = [t for t in self._deferred if t[2] not in ids]
        for buf in getattr(self, "_shared", {}).values():
            for k in [k for k in buf
                      if int.from_bytes(k[:4], "big") in ids]:
                del buf[k]

    def run_deferred(self, epoch: int) -> None:
        for stages in self.take_deferred(epoch):
            self._run_stages(stages)

    def get(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def get_committed(self, key: bytes) -> Optional[bytes]:
        """Point get against the COMMITTED snapshot only: staged and
        sealed-but-uncommitted epochs are invisible."""
        raise NotImplementedError

    def get_many(self, keys) -> list:
        """Batch point-get over the same read view as `get`."""
        return [self.get(k) for k in keys]

    def iter_range(self, start: bytes, end: bytes,
                   committed_only: bool = False,
                   max_epoch: Optional[int] = None
                   ) -> Iterator[tuple[bytes, bytes]]:
        """Live (key, value) pairs in [start, end), ascending by key.
        Staged epochs are included unless committed_only; max_epoch
        bounds which staged epochs are visible."""
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
        super().__init__()
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

    def get_committed(self, key: bytes) -> Optional[bytes]:
        # the synced base map IS the committed view
        return self._vals.get(key)

    def iter_range(self, start: bytes, end: bytes,
                   committed_only: bool = False,
                   max_epoch: Optional[int] = None):
        streams = [] if committed_only else [
            sorted((k, v) for k, v in self._shared[e].items()
                   if start <= k < end)
            for e in sorted(self._shared, reverse=True)   # newest first
            if max_epoch is None or e <= max_epoch]

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
        self.run_deferred(epoch)
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

    def reset_uncommitted(self) -> None:
        """Recovery entry point (see HummockStateStore.reset_uncommitted)."""
        self._shared.clear()
        self._deferred.clear()
