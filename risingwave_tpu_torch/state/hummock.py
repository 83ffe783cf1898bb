"""Hummock-lite — the durable LSM state store behind checkpoints (port
of risingwave_tpu/state/hummock.py; the objects it writes are the same
bytes, so a directory one engine wrote is a store the other opens).

- `ingest_batch` stages writes in a per-epoch shared buffer (readable at
  once, like MemoryStateStore).
- The checkpoint pipeline is three phases:
    * `seal(epoch)`   — cheap: move every buffered epoch <= `epoch` into
      an immutable SealedBatch on the sealed queue;
    * `upload_sealed(batch)` — slow, thread-safe, host only: merge the
      batch into one sorted run, build the SST, PUT it;
    * `commit_sealed(batch)` — the commit point: insert the SST into
      L0, maybe compact, atomically swap the manifest. Only the oldest
      sealed batch may commit, so epochs commit in order.
  `sync(epoch)` is the inline composition of the three.
- Reads merge: shared buffer (newest epoch wins) > sealed batches
  (newest first) > L0 (newest SST wins) > L1.
- When L0 grows past a threshold, an inline full compaction merges
  L0 + L1 into one bottom-level SST and drops tombstones.

Recovery: `HummockStateStore.open(object_store)` reads the manifest and
serves reads at the committed version; `committed_epoch()` seeds the
barrier coordinator's epoch floor.

Left out of this slice (ROADMAP A10): the scrubber and quarantine
(read-path corruption repair from a backup), the background-compaction
protocol (`plan_compaction`, `merge_compaction`,
`install_compaction`), cluster commits (`commit_remote`,
`set_sst_id_block`) and the retry wrapper around the object store.
"""

from __future__ import annotations

import json
from typing import Iterator, Optional

from .object_store import ObjectStore
from .sstable import SsTable, build_sstable, frame_meta, unframe_meta
from .store import StateStore, WriteBatch, lazy_merge_ranges

MANIFEST_PATH = "MANIFEST"


def _sst_path(sst_id: int) -> str:
    return f"ssts/{sst_id:010d}.sst"


class SealedBatch:
    """Immutable snapshot of shared-buffer epochs <= seal_epoch, queued
    for upload. The per-epoch dicts stay distinct until the upload
    merges them; `sst_id` is allocated at seal time (on the event loop,
    so ids stay ordered with uploads in flight); `data` is set by the
    upload and installed by `commit_sealed`."""

    __slots__ = ("seal_epoch", "epochs", "sst_id", "data")

    def __init__(self, seal_epoch: int,
                 epochs: dict[int, dict[bytes, Optional[bytes]]]):
        self.seal_epoch = seal_epoch
        self.epochs = epochs
        self.sst_id: Optional[int] = None
        self.data: Optional[bytes] = None

    @property
    def is_empty(self) -> bool:
        return not any(self.epochs.values())


class HummockStateStore(StateStore):
    L0_COMPACT_THRESHOLD = 8

    def __init__(self, object_store: ObjectStore):
        super().__init__()
        self.objects = object_store
        # epoch -> {key: value|None}; dict order = staging order
        self._shared: dict[int, dict[bytes, Optional[bytes]]] = {}
        # sealed-but-uncommitted batches, oldest first (the upload queue)
        self._sealed: list[SealedBatch] = []
        self._l0: list[SsTable] = []   # newest first
        self._l1: Optional[SsTable] = None
        self._next_sst_id = 1
        self._committed_epoch = 0
        # batches a non-owner handle sealed and installed but whose
        # commit was not yet confirmed (confirm_committed drops them,
        # restage_unconfirmed puts them back in the shared buffer)
        self._unconfirmed: list[SealedBatch] = []
        self.manifest_owner = True
        if self.objects.exists(MANIFEST_PATH):
            self._load_manifest()

    # ------------------------------------------------------------ manifest
    def _load_manifest(self) -> None:
        m = json.loads(unframe_meta(self.objects.read(MANIFEST_PATH),
                                    MANIFEST_PATH))
        assert m.get("format") == 1, f"unknown manifest format {m}"
        self._committed_epoch = m["committed_epoch"]
        self._next_sst_id = m["next_sst_id"]
        self._l0 = [self._read_sst(i) for i in m["l0"]]
        self._l1 = (self._read_sst(m["l1"])
                    if m["l1"] is not None else None)

    def _read_sst(self, sst_id: int) -> SsTable:
        return SsTable.parse(sst_id, self.objects.read(_sst_path(sst_id)))

    def _write_manifest(self) -> None:
        m = {
            "format": 1,
            "committed_epoch": self._committed_epoch,
            "next_sst_id": self._next_sst_id,
            "l0": [t.sst_id for t in self._l0],
            "l1": self._l1.sst_id if self._l1 is not None else None,
        }
        self.objects.upload(MANIFEST_PATH,
                            frame_meta(json.dumps(m).encode()))

    # --------------------------------------------------------------- reads
    def get(self, key: bytes) -> Optional[bytes]:
        for epoch in sorted(self._shared, reverse=True):
            buf = self._shared[epoch]
            if key in buf:
                return buf[key]
        for batch in reversed(self._sealed):          # newest batch first
            for epoch in sorted(batch.epochs, reverse=True):
                buf = batch.epochs[epoch]
                if key in buf:
                    return buf[key]
        return self.get_committed(key)

    def get_committed(self, key: bytes) -> Optional[bytes]:
        for sst in self._l0:
            found, v = sst.get(key)
            if found:
                return v
        if self._l1 is not None:
            found, v = self._l1.get(key)
            if found:
                return v
        return None

    def iter_range(self, start: bytes, end: bytes,
                   committed_only: bool = False,
                   max_epoch: Optional[int] = None
                   ) -> Iterator[tuple[bytes, bytes]]:
        streams = []
        if not committed_only:
            buffers = [(e, self._shared[e])
                       for e in sorted(self._shared, reverse=True)]
            for batch in reversed(self._sealed):  # sealed = still staged
                buffers.extend(
                    (e, batch.epochs[e])
                    for e in sorted(batch.epochs, reverse=True))
            for epoch, buf in buffers:            # newest first
                if max_epoch is not None and epoch > max_epoch:
                    continue
                streams.append(sorted(
                    (k, v) for k, v in buf.items()
                    if start <= k and (not end or k < end)))
        for sst in self._l0:                      # newest first
            streams.append(sst.iter_range(start, end))
        if self._l1 is not None:
            streams.append(self._l1.iter_range(start, end))
        yield from lazy_merge_ranges(streams)

    def committed_epoch(self) -> int:
        return self._committed_epoch

    def reset_uncommitted(self) -> None:
        """Drop the shared buffer and the sealed-but-uncommitted queue:
        the recovery entry point (recovery resumes at the last committed
        version; anything newer was never externally visible). The
        caller stops the background uploader first (BarrierCoordinator.
        abort_uploads); an upload in flight can at worst leave an orphan
        SST that no manifest references."""
        self._shared.clear()
        self._sealed.clear()
        self._deferred.clear()
        self._unconfirmed.clear()

    def confirm_committed(self, epoch: int) -> None:
        """Every retained batch that a commit up to `epoch` covered is
        durable: drop it from the retention list."""
        self._unconfirmed = [b for b in self._unconfirmed
                             if b.seal_epoch > epoch]

    def restage_unconfirmed(self) -> None:
        """Move every sealed-but-never-confirmed batch back into the
        shared buffer under its original epochs (their local L0
        installs removed), so the next checkpoint re-seals them."""
        drop_ids = {b.sst_id for b in self._unconfirmed
                    if b.sst_id is not None}
        if drop_ids:
            self._l0 = [t for t in self._l0 if t.sst_id not in drop_ids]
        for b in self._unconfirmed:
            for e in sorted(b.epochs):
                buf = self._shared.setdefault(e, {})
                # newer staged writes of the same epoch overlay the
                # restaged ones
                merged = dict(b.epochs[e])
                merged.update(buf)
                self._shared[e] = merged
        self._unconfirmed = []

    # -------------------------------------------------------------- writes
    def ingest_batch(self, batch: WriteBatch) -> None:
        self._shared.setdefault(batch.epoch, {}).update(batch.puts)

    # ------------------------------------------------- seal/upload/commit
    def seal(self, epoch: int) -> SealedBatch:
        """Phase 1, cheap (event loop): move every shared-buffer epoch <=
        `epoch` into an immutable SealedBatch on the sealed queue. The
        batch stays readable until `commit_sealed`."""
        assert not self._sealed or epoch >= self._sealed[-1].seal_epoch, \
            f"seal epochs must be monotone ({epoch} after " \
            f"{self._sealed[-1].seal_epoch})"
        eps = sorted(e for e in self._shared if e <= epoch)
        batch = SealedBatch(epoch, {e: self._shared.pop(e) for e in eps})
        if not batch.is_empty:
            batch.sst_id = self._next_sst_id
            self._next_sst_id += 1
        self._sealed.append(batch)
        return batch

    def upload_sealed(self, batch: SealedBatch) -> None:
        """Phase 2, slow: merge + build + PUT the batch's SST. Touches
        only the immutable batch and the object store (host work, no
        device), so the uploader runs it on a worker thread."""
        if batch.sst_id is None or batch.data is not None:
            return
        merged: dict[bytes, Optional[bytes]] = {}
        for e in sorted(batch.epochs):           # oldest -> newest overlay
            merged.update(batch.epochs[e])
        data = build_sstable(batch.seal_epoch, sorted(merged.items()))
        self.objects.upload(_sst_path(batch.sst_id), data)
        batch.data = data

    def commit_sealed(self, batch: SealedBatch) -> dict:
        """Phase 3, the commit point (event loop): install the SST into
        L0, advance the committed epoch, maybe compact, swap the
        manifest. Strictly in seal order."""
        assert self._sealed and self._sealed[0] is batch, (
            "manifest swaps must land in seal order (epoch "
            f"{batch.seal_epoch} is not the oldest sealed batch)")
        new_ids: list[int] = []
        if batch.sst_id is not None:
            assert batch.data is not None, \
                "commit_sealed before upload_sealed"
            self._l0.insert(0, SsTable.parse(batch.sst_id, batch.data))
            new_ids.append(batch.sst_id)
        self._sealed.pop(0)
        self._committed_epoch = max(self._committed_epoch, batch.seal_epoch)
        if not self.manifest_owner:
            self._unconfirmed.append(batch)
            return {"uncommitted_ssts": new_ids}
        obsolete: list[int] = []
        if len(self._l0) > self.L0_COMPACT_THRESHOLD:
            obsolete = self._compact()
        # manifest swap = the commit point; object deletes strictly after
        self._write_manifest()
        for sst_id in obsolete:
            self.objects.delete(_sst_path(sst_id))
        return {"uncommitted_ssts": new_ids}

    def sync(self, epoch: int) -> dict:
        """Inline composition of the pipeline: run deferred executor
        flushes, seal, then drain the sealed queue in order."""
        self.run_deferred(epoch)
        self.seal(epoch)
        new_ids: list[int] = []
        while self._sealed and self._sealed[0].seal_epoch <= epoch:
            b = self._sealed[0]
            self.upload_sealed(b)
            new_ids.extend(self.commit_sealed(b)["uncommitted_ssts"])
        return {"uncommitted_ssts": new_ids}

    # ---------------------------------------------------------- compaction
    def _compact(self) -> list[int]:
        """Full merge of L1 + L0 into one bottom-level SST; tombstones
        drop (nothing lives below L1). Returns the obsolete sst ids,
        which the caller deletes only after the new manifest is
        durable."""
        merged: dict[bytes, Optional[bytes]] = {}
        if self._l1 is not None:
            merged.update(zip(self._l1.keys, self._l1.vals))
        for sst in reversed(self._l0):
            merged.update(zip(sst.keys, sst.vals))
        live = sorted((k, v) for k, v in merged.items() if v is not None)
        obsolete = [t.sst_id for t in self._l0]
        if self._l1 is not None:
            obsolete.append(self._l1.sst_id)
        sst_id = self._next_sst_id
        self._next_sst_id += 1
        data = build_sstable(self._committed_epoch, live)
        self.objects.upload(_sst_path(sst_id), data)
        self._l1 = SsTable.parse(sst_id, data)
        self._l0 = []
        return obsolete

    @classmethod
    def open(cls, object_store: ObjectStore) -> "HummockStateStore":
        """Recovery entry: attach to whatever the last manifest
        committed."""
        return cls(object_store)
