"""Nexmark event generator — device-side datagen source
(port of risingwave_tpu/connectors/nexmark.py).

The public Nexmark generator model (person/auction/bid interleaving
1:3:46 per 50 events, hot-key skew from the spec) as a pure function
`event_index -> row`: a counter-based splitmix64 of the event id, so a
chunk is generated on the device, seekable by offset, and bit-identical
to the JAX package for the same start index.

The bid, person and auction tables are kernels K1, K9 and K10
(`csrc/nexmark_bid.cu`, `nexmark_person.cu`, `nexmark_auction.cu`) on a
CUDA device; each keeps its plain PyTorch version for the CPU.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..common.chunk import Column, StreamChunk
from ..common.types import DataType, GLOBAL_DICT, schema
from ..device import resolve_device
from ..ops import kernels
from ..ops.hashing import splitmix64, umod

PERSON_PROPORTION = 1
AUCTION_PROPORTION = 3
BID_PROPORTION = 46
TOTAL_PROPORTION = 50

HOT_AUCTION_RATIO = 100
HOT_BIDDER_RATIO = 100
HOT_SELLER_RATIO = 4

FIRST_PERSON_ID = 1000
FIRST_AUCTION_ID = 1000
FIRST_CATEGORY_ID = 10

BID_SCHEMA = schema(
    ("auction", DataType.INT64),
    ("bidder", DataType.INT64),
    ("price", DataType.INT64),
    ("channel", DataType.VARCHAR),
    ("url", DataType.VARCHAR),
    ("date_time", DataType.TIMESTAMP),
    ("extra", DataType.VARCHAR),
)

PERSON_SCHEMA = schema(
    ("id", DataType.INT64),
    ("name", DataType.VARCHAR),
    ("email_address", DataType.VARCHAR),
    ("credit_card", DataType.VARCHAR),
    ("city", DataType.VARCHAR),
    ("state", DataType.VARCHAR),
    ("date_time", DataType.TIMESTAMP),
    ("extra", DataType.VARCHAR),
)

AUCTION_SCHEMA = schema(
    ("id", DataType.INT64),
    ("item_name", DataType.VARCHAR),
    ("description", DataType.VARCHAR),
    ("initial_bid", DataType.INT64),
    ("reserve", DataType.INT64),
    ("date_time", DataType.TIMESTAMP),
    ("expires", DataType.TIMESTAMP),
    ("seller", DataType.INT64),
    ("category", DataType.INT64),
    ("extra", DataType.VARCHAR),
)

_CHANNELS = ["apple", "google", "baidu", "facebook"]
_STATES = ["AZ", "CA", "ID", "OR", "WA", "WY"]
_CITIES = ["Phoenix", "Los Angeles", "San Francisco", "Boise", "Portland",
           "Bend", "Redmond", "Seattle", "Kent", "Cheyenne"]


def vocab_strings() -> dict[str, list[str]]:
    return {
        "channel": _CHANNELS,
        "state": _STATES,
        "city": _CITIES,
        "name": [f"person_{i}" for i in range(1000)],
        "email": [f"user_{i}@example.com" for i in range(1000)],
        "card": [f"{i:04d} {i:04d} {i:04d} {i:04d}" for i in range(1000)],
        "url": [f"https://b.example.com/item/{i}" for i in range(1000)],
        "item": [f"item_{i}" for i in range(1000)],
        "desc": [f"description_{i}" for i in range(100)],
        "extra": [f"extra_{i}" for i in range(100)],
    }


def vocab_ids() -> dict[str, tuple[int, ...]]:
    """Dictionary ids of every vocabulary, minted in GLOBAL_DICT. Ids need
    not be contiguous (a string may already be in the dictionary), so
    picks gather from an explicit id table."""
    return {name: tuple(GLOBAL_DICT.get_or_insert(s) for s in strings)
            for name, strings in vocab_strings().items()}


def _rand(eid: torch.Tensor, salt: int, mod: int) -> torch.Tensor:
    """Deterministic uniform int64 in [0, mod)."""
    return umod(splitmix64(eid * 2654435761 + salt), mod)


def _vocab_pick(ids: torch.Tensor, eid: torch.Tensor, salt: int):
    return ids[_rand(eid, salt, ids.shape[0])]


@dataclass(frozen=True)
class NexmarkConfig:
    base_time_us: int = 1_500_000_000_000_000  # event-time origin (us)
    inter_event_us: int = 10                   # logical event spacing
    num_active_people: int = 1000
    in_flight_auctions: int = 100


def _ids_so_far(global_id: torch.Tensor):
    """Counts of persons/auctions emitted up to global event id
    (exclusive)."""
    group = global_id // TOTAL_PROPORTION
    off = global_id % TOTAL_PROPORTION
    n_persons = group * PERSON_PROPORTION + off.clamp(max=PERSON_PROPORTION)
    n_auctions = group * AUCTION_PROPORTION + (
        off - PERSON_PROPORTION).clamp(0, AUCTION_PROPORTION)
    return n_persons, n_auctions


def _event_time(global_id: torch.Tensor, cfg: NexmarkConfig):
    return cfg.base_time_us + global_id * cfg.inter_event_us


def gen_bid_columns_plain(start_index: int, n: int, cfg: NexmarkConfig,
                          vocabs: dict[str, torch.Tensor],
                          device) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of kernel K1: bid events
    k = start_index .. start_index+n-1 (bid-local indices)."""
    k = start_index + torch.arange(n, dtype=torch.int64, device=device)
    group = k // BID_PROPORTION
    off = k % BID_PROPORTION
    global_id = (group * TOTAL_PROPORTION + PERSON_PROPORTION
                 + AUCTION_PROPORTION + off)
    n_persons, n_auctions = _ids_so_far(global_id)

    hot = _rand(global_id, 1, HOT_AUCTION_RATIO) > 0
    hot_auction = ((n_auctions - 1) // HOT_AUCTION_RATIO) * HOT_AUCTION_RATIO
    cold_auction = n_auctions - 1 - _rand(global_id, 2,
                                          cfg.in_flight_auctions)
    auction = FIRST_AUCTION_ID + torch.where(hot, hot_auction,
                                             cold_auction.clamp(min=0))

    hot_b = _rand(global_id, 3, HOT_BIDDER_RATIO) > 0
    hot_bidder = ((n_persons - 1) // HOT_BIDDER_RATIO) * HOT_BIDDER_RATIO + 1
    cold_bidder = n_persons - 1 - _rand(global_id, 4, cfg.num_active_people)
    bidder = FIRST_PERSON_ID + torch.where(hot_b, hot_bidder,
                                           cold_bidder.clamp(min=0))

    lg = _rand(global_id, 5, 5)  # decade
    mant = _rand(global_id, 6, 900) + 100
    price = mant * torch.pow(10, lg)

    channel = _vocab_pick(vocabs["channel"], global_id, 7)
    url = _vocab_pick(vocabs["url"], global_id, 8)
    date_time = _event_time(global_id, cfg)
    extra = _vocab_pick(vocabs["extra"], global_id, 9)
    return (auction, bidder, price, channel, url, date_time, extra)


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# K1. Replaces connectors/nexmark.py:gen_bid_columns (156) with
# _splitmix64 (118), _rand (127) and _vocab_pick (113).
K_BID = kernels.register(kernels.CudaKernel(
    "nexmark_bid",
    replaces="risingwave_tpu/connectors/nexmark.py:156",
    functions={"rw_nexmark_bid": [
        _L, _I, _L, _L, _L, _L,
        _P, _I, _P, _I, _P, _I,
        _P, _P, _P, _P, _P, _P, _P, _P]}))


def gen_bid_columns(start_index: int, n: int, cfg: NexmarkConfig,
                    vocabs: dict[str, torch.Tensor],
                    device) -> tuple[torch.Tensor, ...]:
    """The bid columns on `device`: kernel K1 on a CUDA device, the plain
    version on the CPU."""
    device = resolve_device(device)
    if device.type == "cpu":
        return gen_bid_columns_plain(start_index, n, cfg, vocabs, device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    i64 = dict(dtype=torch.int64, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    auction, bidder, price, date_time = (torch.empty(n, **i64)
                                         for _ in range(4))
    channel, url, extra = (torch.empty(n, **i32) for _ in range(3))
    ch, ur, ex = vocabs["channel"], vocabs["url"], vocabs["extra"]
    for v in (ch, ur, ex):
        if v.device != device or v.dtype != torch.int32:
            raise ValueError("vocab id tables must be int32 on the device")
    K_BID.launches += 1
    K_BID.call("rw_nexmark_bid", start_index, n, cfg.base_time_us,
               cfg.inter_event_us, cfg.num_active_people,
               cfg.in_flight_auctions,
               kernels.ptr(ch), ch.shape[0], kernels.ptr(ur), ur.shape[0],
               kernels.ptr(ex), ex.shape[0],
               kernels.ptr(auction), kernels.ptr(bidder), kernels.ptr(price),
               kernels.ptr(channel), kernels.ptr(url),
               kernels.ptr(date_time), kernels.ptr(extra),
               kernels.stream_of(auction))
    return (auction, bidder, price, channel, url, date_time, extra)


def gen_person_columns_plain(start_index: int, n: int, cfg: NexmarkConfig,
                             vocabs: dict[str, torch.Tensor], device):
    """Plain PyTorch version of kernel K9: person events
    k = start_index .. start_index+n-1 (person-local indices)."""
    k = start_index + torch.arange(n, dtype=torch.int64, device=device)
    global_id = k * TOTAL_PROPORTION  # persons sit at offset 0 of a group
    pid = FIRST_PERSON_ID + k
    names = vocabs["name"]
    name = names[pid % names.shape[0]]
    email = _vocab_pick(vocabs["email"], global_id, 11)
    card = _vocab_pick(vocabs["card"], global_id, 12)
    city = _vocab_pick(vocabs["city"], global_id, 13)
    state = _vocab_pick(vocabs["state"], global_id, 14)
    date_time = _event_time(global_id, cfg)
    extra = _vocab_pick(vocabs["extra"], global_id, 15)
    return (pid, name, email, card, city, state, date_time, extra)


def gen_auction_columns_plain(start_index: int, n: int, cfg: NexmarkConfig,
                              vocabs: dict[str, torch.Tensor], device):
    """Plain PyTorch version of kernel K10: auction events
    k = start_index .. start_index+n-1 (auction-local indices)."""
    k = start_index + torch.arange(n, dtype=torch.int64, device=device)
    group = k // AUCTION_PROPORTION
    off = k % AUCTION_PROPORTION
    global_id = group * TOTAL_PROPORTION + PERSON_PROPORTION + off
    n_persons, _ = _ids_so_far(global_id)
    aid = FIRST_AUCTION_ID + k
    item = _vocab_pick(vocabs["item"], global_id, 21)
    desc = _vocab_pick(vocabs["desc"], global_id, 22)
    initial_bid = _rand(global_id, 23, 1000) * 100 + 100
    reserve = initial_bid + _rand(global_id, 24, 1000) * 100
    date_time = _event_time(global_id, cfg)
    expires = date_time + (_rand(global_id, 25, 100) + 1) * 1_000_000
    hot = _rand(global_id, 26, HOT_SELLER_RATIO) > 0
    hot_seller = ((n_persons - 1) // HOT_SELLER_RATIO) * HOT_SELLER_RATIO
    cold_seller = n_persons - 1 - _rand(global_id, 27, cfg.num_active_people)
    seller = FIRST_PERSON_ID + torch.where(hot, hot_seller,
                                           cold_seller.clamp(min=0))
    category = FIRST_CATEGORY_ID + _rand(global_id, 28, 5)
    return (aid, item, desc, initial_bid, reserve, date_time, expires,
            seller, category, _vocab_pick(vocabs["extra"], global_id, 29))


# K9. Replaces connectors/nexmark.py:gen_person_columns (190).
K_PERSON = kernels.register(kernels.CudaKernel(
    "nexmark_person",
    replaces="risingwave_tpu/connectors/nexmark.py:190",
    functions={"rw_nexmark_person": [
        _L, _I, _L, _L, *([_P, _I] * 6), *([_P] * 8), _P]}))

# K10. Replaces connectors/nexmark.py:gen_auction_columns (208).
K_AUCTION = kernels.register(kernels.CudaKernel(
    "nexmark_auction",
    replaces="risingwave_tpu/connectors/nexmark.py:208",
    functions={"rw_nexmark_auction": [
        _L, _I, _L, _L, _L, *([_P, _I] * 3), *([_P] * 10), _P]}))


def _vocab_args(vocabs: dict[str, torch.Tensor], names, device) -> list:
    args = []
    for name in names:
        v = vocabs[name]
        if v.device != device or v.dtype != torch.int32:
            raise ValueError("vocab id tables must be int32 on the device")
        args += [kernels.ptr(v), v.shape[0]]
    return args


def gen_person_columns(start_index: int, n: int, cfg: NexmarkConfig,
                       vocabs: dict[str, torch.Tensor],
                       device) -> tuple[torch.Tensor, ...]:
    """The person columns on `device`: kernel K9 on a CUDA device, the
    plain version on the CPU."""
    device = resolve_device(device)
    if device.type == "cpu":
        return gen_person_columns_plain(start_index, n, cfg, vocabs, device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    pid, date_time = (torch.empty(n, dtype=torch.int64, device=device)
                      for _ in range(2))
    name, email, card, city, state, extra = (
        torch.empty(n, dtype=torch.int32, device=device) for _ in range(6))
    vargs = _vocab_args(vocabs, ("name", "email", "card", "city", "state",
                                 "extra"), device)
    K_PERSON.launches += 1
    K_PERSON.call("rw_nexmark_person", start_index, n, cfg.base_time_us,
                  cfg.inter_event_us, *vargs,
                  *(kernels.ptr(t) for t in (pid, name, email, card, city,
                                             state, date_time, extra)),
                  kernels.stream_of(pid))
    return (pid, name, email, card, city, state, date_time, extra)


def gen_auction_columns(start_index: int, n: int, cfg: NexmarkConfig,
                        vocabs: dict[str, torch.Tensor],
                        device) -> tuple[torch.Tensor, ...]:
    """The auction columns on `device`: kernel K10 on a CUDA device, the
    plain version on the CPU."""
    device = resolve_device(device)
    if device.type == "cpu":
        return gen_auction_columns_plain(start_index, n, cfg, vocabs, device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    cols = [torch.empty(n, dtype=torch.int32 if j in (1, 2, 9)
                        else torch.int64, device=device) for j in range(10)]
    vargs = _vocab_args(vocabs, ("item", "desc", "extra"), device)
    K_AUCTION.launches += 1
    K_AUCTION.call("rw_nexmark_auction", start_index, n, cfg.base_time_us,
                   cfg.inter_event_us, cfg.num_active_people, *vargs,
                   *(kernels.ptr(t) for t in cols), kernels.stream_of(cols[0]))
    return tuple(cols)


_TABLES = {
    "bid": (BID_SCHEMA, gen_bid_columns),
    "person": (PERSON_SCHEMA, gen_person_columns),
    "auction": (AUCTION_SCHEMA, gen_auction_columns),
}


class NexmarkGenerator:
    """Split reader for one Nexmark table. Offset = next event index of
    this table — the exactly-once source state."""

    def __init__(self, table: str, chunk_size: int = 4096,
                 cfg: NexmarkConfig = NexmarkConfig(), start_offset: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.table = table
        self.schema, self._gen = _TABLES[table]
        self.chunk_size = chunk_size
        self.cfg = cfg
        self.offset = start_offset
        self.vocabs = {name: torch.tensor(ids, dtype=torch.int32,
                                          device=self.device)
                       for name, ids in vocab_ids().items()}
        self._vis = torch.ones(chunk_size, dtype=torch.bool,
                               device=self.device)
        self._ops = torch.zeros(chunk_size, dtype=torch.int8,
                                device=self.device)

    def seek(self, offset: int) -> None:
        self.offset = offset

    def next_chunk(self) -> StreamChunk:
        cols = self._gen(self.offset, self.chunk_size, self.cfg,
                         self.vocabs, self.device)
        self.offset += self.chunk_size
        return StreamChunk(tuple(Column(c) for c in cols), self._ops,
                           self._vis, self.schema)

    @property
    def watermark_col(self) -> int:
        """Index of date_time in this table's schema."""
        return {"bid": 5, "person": 6, "auction": 5}[self.table]

    def current_watermark(self) -> int:
        """Event-time watermark after the last emitted chunk, from offset
        arithmetic on the host (event time is monotone in the id)."""
        if self.offset == 0:
            return self.cfg.base_time_us
        k = self.offset - 1
        if self.table == "bid":
            group, off = divmod(k, BID_PROPORTION)
            gid = (group * TOTAL_PROPORTION + PERSON_PROPORTION
                   + AUCTION_PROPORTION + off)
        elif self.table == "person":
            gid = k * TOTAL_PROPORTION
        else:
            group, off = divmod(k, AUCTION_PROPORTION)
            gid = group * TOTAL_PROPORTION + PERSON_PROPORTION + off
        return self.cfg.base_time_us + gid * self.cfg.inter_event_us
