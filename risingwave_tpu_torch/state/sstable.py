"""SSTable — one immutable sorted run of (key, value | tombstone) entries
(port of risingwave_tpu/state/sstable.py; the bytes are the same).

Reference: src/storage/src/hummock/sstable/{builder.rs,mod.rs} — block-based
format with bloom filters and a footer. Here one checkpoint flush is a few
MB at most, so the format is a single self-checksummed block parsed whole on
open: entries are stored sorted, tombstones are explicit (a delete must mask
older versions in lower levels until bottom-level compaction drops it).

Layout (little-endian):
    magic "RWS1"
    u32 count | u64 epoch
    count * ( u32 klen | key | u32 vlen_or_TOMB | value )
    u32 crc32(everything after magic)
"""

from __future__ import annotations

import struct
import zlib
from bisect import bisect_left, bisect_right
from typing import Iterator, Optional, Sequence

MAGIC = b"RWS1"
META_MAGIC = b"RWM1"
TOMBSTONE = 0xFFFFFFFF


class SsTableCorruption(Exception):
    pass


class MetaCorruption(SsTableCorruption):
    """A framed meta object (MANIFEST/CATALOG/backup manifest) failed its
    checksum — same detection class as an SST, same quarantine rules."""


def frame_meta(body: bytes) -> bytes:
    """Self-checksummed framing for meta objects — the MANIFEST and
    CATALOG carry the same crc32 integrity envelope SSTs always had, so
    a torn or bit-rotted manifest is DETECTED at open instead of being
    json-decoded into a plausible-but-wrong world."""
    return META_MAGIC + body + struct.pack("<I", zlib.crc32(body))


def unframe_meta(data: bytes, name: str = "meta") -> bytes:
    """Verify + strip the meta frame. Unframed blobs pass through —
    stores written before the framing existed still open (their json
    layer keeps rejecting garbage, just without crc attribution)."""
    if data[:4] != META_MAGIC:
        return data
    body, (crc,) = data[4:-4], struct.unpack("<I", data[-4:])
    if zlib.crc32(body) != crc:
        raise MetaCorruption(f"{name}: checksum mismatch")
    return body


def build_sstable(epoch: int,
                  entries: Sequence[tuple[bytes, Optional[bytes]]]) -> bytes:
    """entries must be key-sorted and key-unique; value None = tombstone."""
    parts = [struct.pack("<IQ", len(entries), epoch)]
    prev = None
    for k, v in entries:
        assert prev is None or prev < k, "entries must be sorted+unique"
        prev = k
        parts.append(struct.pack("<I", len(k)))
        parts.append(k)
        if v is None:
            parts.append(struct.pack("<I", TOMBSTONE))
        else:
            parts.append(struct.pack("<I", len(v)))
            parts.append(v)
    body = b"".join(parts)
    return MAGIC + body + struct.pack("<I", zlib.crc32(body))


class SsTable:
    """Parsed SST: bisectable parallel key/value lists."""

    def __init__(self, sst_id: int, epoch: int, keys: list[bytes],
                 vals: list[Optional[bytes]]):
        self.sst_id = sst_id
        self.epoch = epoch
        self.keys = keys
        self.vals = vals

    @classmethod
    def parse(cls, sst_id: int, data: bytes) -> "SsTable":
        if data[:4] != MAGIC:
            raise SsTableCorruption(f"sst {sst_id}: bad magic")
        body, (crc,) = data[4:-4], struct.unpack("<I", data[-4:])
        if zlib.crc32(body) != crc:
            raise SsTableCorruption(f"sst {sst_id}: checksum mismatch")
        count, epoch = struct.unpack_from("<IQ", body, 0)
        off = 12
        keys: list[bytes] = []
        vals: list[Optional[bytes]] = []
        for _ in range(count):
            (klen,) = struct.unpack_from("<I", body, off)
            off += 4
            keys.append(body[off:off + klen])
            off += klen
            (vlen,) = struct.unpack_from("<I", body, off)
            off += 4
            if vlen == TOMBSTONE:
                vals.append(None)
            else:
                vals.append(body[off:off + vlen])
                off += vlen
        return cls(sst_id, epoch, keys, vals)

    def __len__(self) -> int:
        return len(self.keys)

    def get(self, key: bytes) -> tuple[bool, Optional[bytes]]:
        """(found, value) — found with value None means tombstone."""
        i = bisect_left(self.keys, key)
        if i < len(self.keys) and self.keys[i] == key:
            return True, self.vals[i]
        return False, None

    def iter_range(self, start: bytes, end: bytes
                   ) -> Iterator[tuple[bytes, Optional[bytes]]]:
        i = bisect_left(self.keys, start)
        j = bisect_right(self.keys, end) if end else len(self.keys)
        while i < j and (not end or self.keys[i] < end):
            yield self.keys[i], self.vals[i]
            i += 1

    @property
    def min_key(self) -> bytes:
        return self.keys[0] if self.keys else b""

    @property
    def max_key(self) -> bytes:
        return self.keys[-1] if self.keys else b""
