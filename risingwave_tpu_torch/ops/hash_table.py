"""Device-resident bucketed hash table — the state backbone of HashAgg
(port of risingwave_tpu/ops/hash_table.py).

Layout: capacity C = B buckets x S slots. A key hashes to two candidate
buckets (two halves of a splitmix64 chain over the key columns) and
lives in exactly one of their 2S slots. Within a bucket the occupied
slots are a prefix; slots are never freed (emptied groups stay as
zombies until the owner rebuilds).

`lookup_or_insert` is kernel K3 (`csrc/hash_table.cu`) on a CUDA device
and the plain version below on the CPU. The plain version follows the
reference step for step (two stable sorts), so it places keys in the
same slots as the JAX package. The kernel claims slots with atomics: it
fills each bucket with the same number of new keys as the reference but
may order them differently inside the bucket (see ROADMAP Queue C).
Key columns are int64, int32 or float64: a float64 key hashes by its
`astype(uint64)` value lane and compares with IEEE `==`, so -0.0 and
+0.0 are one key and every NaN row is a new key, on the card as in the
plain version. `lookup` runs on the card inside kernel K32 (the hash
join's probe, stream/hash_join.py).

`compact_mask` (the agg's flush, evict and rehash compaction) is kernel
K12 (`csrc/compact.cu`) on a CUDA device; `stable_lexsort` lives in
ops/sort.py (kernel K11 on the card).

Left out of this slice: `stable_lexsort_rows`, `pack_rows`, `lru_stamp`
(memory manager and sorted-join helpers).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence

import torch

from . import kernels
from .hashing import LOW32, key_hash, srl
from .sort import stable_lexsort  # noqa: F401  (K11 on the card)

# Slots per bucket: keeps two-choice overflow negligible below the 0.7
# rebuild threshold while a probe reads only two 16-slot buckets.
BUCKET_SLOTS = 16
MAX_KEY_COLUMNS = 4   # key columns one K3 launch takes

_VP = ctypes.c_void_p

# K12. Replaces ops/hash_table.py:compact_mask (47).
K_COMPACT = kernels.register(kernels.CudaKernel(
    "compact",
    replaces="risingwave_tpu/ops/hash_table.py:47",
    functions={"rw_compact_mask": [_VP, ctypes.c_longlong, _VP, _VP, _VP,
                                   _VP],
               "rw_compact_blocks": [ctypes.c_longlong]}))


def compact_mask_plain(mask: torch.Tensor):
    """Plain PyTorch version of kernel K12, a cumsum-scatter compaction:
    for bool [C] `mask`, returns (sel, n) where sel int64 [C] holds the
    indices of the set bits in its first n entries (zeros past n) and n
    is the device count."""
    C = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    # the trash row C takes the unselected writes (the reference's
    # mode="drop") and is sliced off
    sel = torch.zeros(C + 1, dtype=torch.int64, device=mask.device)
    sel[torch.where(mask, rank, C)] = torch.arange(C, device=mask.device)
    return sel[:C], mask.sum(dtype=torch.int64)


def compact_mask(mask: torch.Tensor):
    """Kernel K12 on a CUDA device, the plain version on the CPU. Same
    contract as `compact_mask_plain`; n stays on the device."""
    dev = mask.device
    if dev.type == "cpu":
        return compact_mask_plain(mask)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if mask.dtype != torch.bool or mask.dim() != 1 \
            or not mask.is_contiguous():
        raise ValueError("K12 compacts a contiguous 1-D bool mask")
    C = mask.shape[0]
    sel = torch.empty(C, dtype=torch.int64, device=dev)
    n = torch.empty((), dtype=torch.int64, device=dev)
    sums = torch.empty(K_COMPACT.lib().rw_compact_blocks(C) + 1,
                       dtype=torch.int32, device=dev)
    K_COMPACT.launches += 1
    K_COMPACT.call("rw_compact_mask", kernels.ptr(mask), C, kernels.ptr(sel),
                   kernels.ptr(n), kernels.ptr(sums), kernels.stream_of(mask))
    return sel, n


@dataclass
class HashTable:
    """keys: per-key-column [C] tensors; occupied: bool [C]."""

    keys: tuple[torch.Tensor, ...]
    occupied: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.occupied.shape[0]

    @property
    def device(self) -> torch.device:
        return self.occupied.device

    @staticmethod
    def empty(capacity: int, key_dtypes: Sequence[torch.dtype],
              device) -> "HashTable":
        if capacity % BUCKET_SLOTS or capacity < 2 * BUCKET_SLOTS:
            raise ValueError(
                f"capacity {capacity} must be a multiple of {BUCKET_SLOTS}")
        return HashTable(
            tuple(torch.zeros(capacity, dtype=dt, device=device)
                  for dt in key_dtypes),
            torch.zeros(capacity, dtype=torch.bool, device=device))


def _bucket_pair(key_cols: Sequence[torch.Tensor], n_buckets: int):
    """Two candidate buckets per row (int64 [N] each) plus a per-key tie
    bit, from a splitmix64 chain over the key columns."""
    h = key_hash(key_cols)
    h1 = (h & LOW32) % n_buckets
    h2 = srl(h, 32) % n_buckets
    tie = (srl(h, 31) & 1).to(torch.bool)
    return h1, h2, tie


def _candidates(table: HashTable, key_cols: Sequence[torch.Tensor]):
    """[N, 2S] candidate slot ids + occupancy + key match per row."""
    S = BUCKET_SLOTS
    B = table.capacity // S
    N = key_cols[0].shape[0]
    h1, h2, tie = _bucket_pair(key_cols, B)
    bases = torch.stack([h1 * S, h2 * S], dim=1)                # [N, 2]
    cand = (bases[:, :, None] + torch.arange(S, device=h1.device)
            ).reshape(N, 2 * S)
    occ = table.occupied[cand]
    match = occ
    for tk, k in zip(table.keys, key_cols):
        match = match & (tk[cand] == k[:, None])
    return h1, h2, tie, cand, occ, match


def _first_match(cand: torch.Tensor, match: torch.Tensor):
    has = match.any(dim=1)
    sel = torch.argmax(match.to(torch.uint8), dim=1)
    slot = torch.gather(cand, 1, sel[:, None])[:, 0]
    return has, slot


def lookup(table: HashTable, key_cols: Sequence[torch.Tensor],
           active: torch.Tensor) -> torch.Tensor:
    """Read-only probe: slot (int32) of each active row's key, -1 if
    absent."""
    _, _, _, cand, _, match = _candidates(table, key_cols)
    has, slot = _first_match(cand, match)
    return torch.where(active & has, slot, -1).to(torch.int32)


def lookup_or_insert_plain(table: HashTable,
                           key_cols: Sequence[torch.Tensor],
                           active: torch.Tensor):
    """Plain PyTorch version of kernel K3: find or claim a slot for every
    active row. Updates `table` in place (the reference donates it).

    Returns (table, slots int32 [N] (-1 for inactive/unresolved),
    n_unresolved int32 scalar tensor). n_unresolved > 0 means both
    candidate buckets of some new key are full.

    Steps (the reference's, no data-dependent loops):
      1. match pass against both candidate buckets;
      2. a stable sort groups missing rows by key; each run's first row
         is its leader (in-chunk dedup);
      3. each leader picks the emptier of its two buckets (pre-chunk
         fill; a bucket's occupancy is a prefix);
      4. a second stable sort ranks leaders within their chosen bucket:
         slot = bucket*S + fill + rank;
      5. leaders' keys and occupancy are written; run members inherit
         the leader's slot.
    """
    S = BUCKET_SLOTS
    C = table.capacity
    N = key_cols[0].shape[0]
    dev = active.device
    pos = torch.arange(N, dtype=torch.int64, device=dev)

    h1, h2, tie, cand, occ, match = _candidates(table, key_cols)
    has, mslot = _first_match(cand, match)

    fill1 = occ[:, :S].sum(dim=1)
    fill2 = occ[:, S:].sum(dim=1)
    choose2 = (fill2 < fill1) | ((fill2 == fill1) & tie)
    c_bucket = torch.where(choose2, h2, h1)
    c_fill = torch.minimum(fill1, fill2)

    miss = active & ~has

    # ---- sort 1: group missing rows by key (runs of identical keys);
    # the reference's first key, the row id, is the identity order ----
    order = stable_lexsort([*key_cols, (~miss).to(torch.uint8)])
    s_miss = miss[order]
    same = s_miss[1:] & s_miss[:-1]
    for k in key_cols:
        sk = k[order]
        same = same & (sk[1:] == sk[:-1])
    first = torch.ones(1, dtype=torch.bool, device=dev)
    is_leader = s_miss & torch.cat([first, ~same])
    run_id = torch.cumsum(is_leader.to(torch.int64), 0) - 1
    s_bucket = c_bucket[order]
    s_fill = c_fill[order]

    # ---- sort 2: rank leaders within their chosen bucket ----
    rank_key = torch.where(is_leader, s_bucket, C // S)   # others last
    order2 = torch.argsort(rank_key, stable=True)
    r_bucket = rank_key[order2]
    new_bucket = torch.cat([first, r_bucket[1:] != r_bucket[:-1]])
    bucket_start = torch.cummax(torch.where(new_bucket, pos, 0), 0).values
    rank = pos - bucket_start
    r_fill = s_fill[order2]
    r_leader = is_leader[order2]
    r_ok = r_leader & (r_fill + rank < S)
    r_slot = torch.where(r_ok, r_bucket * S + r_fill + rank, -1)

    # leader slots back to sort-1 order, then spread over each run
    slot_s1 = torch.empty(N, dtype=torch.int64, device=dev)
    slot_s1[order2] = r_slot
    leader_slot_by_run = torch.full((N + 1,), -1, dtype=torch.int64,
                                    device=dev)
    leader_slot_by_run[torch.where(is_leader, run_id, N)] = torch.where(
        is_leader, slot_s1, -1)
    s_ins_slot = torch.where(s_miss, leader_slot_by_run[run_id], -1)

    # ---- write leaders' keys / occupancy (in place) ----
    w_idx = r_slot[r_ok]
    orig2 = order[order2][r_ok]
    for tk, k in zip(table.keys, key_cols):
        tk[w_idx] = k[orig2].to(tk.dtype)
    table.occupied[w_idx] = True

    # ---- unsort + combine ----
    ins_slot = torch.empty(N, dtype=torch.int64, device=dev)
    ins_slot[order] = s_ins_slot
    slots = torch.where(has, mslot, torch.where(miss, ins_slot, -1))
    slots = torch.where(active, slots, -1).to(torch.int32)
    n_unresolved = (active & (slots < 0)).sum(dtype=torch.int32)
    return table, slots, n_unresolved


_P = ctypes.c_void_p
_I = ctypes.c_int

# K3. Replaces ops/hash_table.py:lookup_or_insert (190) with
# _bucket_pair (130) and _candidates (160).
K_HT = kernels.register(kernels.CudaKernel(
    "hash_table",
    replaces="risingwave_tpu/ops/hash_table.py:190",
    functions={"rw_ht_lookup_or_insert": [
        _I, ctypes.POINTER(_P), ctypes.POINTER(_P), ctypes.POINTER(_I),
        _P, _I, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P]}))

# key column types K3 and K32 take, with their RwType codes
# (csrc/key_hash.cuh, as expr/program.py's TYPE_CODES)
KEY_TYPE_CODES = {torch.int64: 0, torch.int32: 1, torch.float64: 5}


def scratch_capacity(n: int) -> int:
    """Slots of K3's chunk-local leader set: a power of two >= 2n."""
    return max(64, 1 << (2 * max(n, 1) - 1).bit_length())


def check_key_columns(table: HashTable, key_cols: Sequence[torch.Tensor],
                      n: int, what: str) -> None:
    """Raise unless `key_cols` are n-row contiguous columns of the
    table's key dtypes (int64, int32 or float64) on its device."""
    if not 1 <= len(key_cols) <= MAX_KEY_COLUMNS \
            or len(key_cols) != len(table.keys):
        raise ValueError(f"{what} takes 1..{MAX_KEY_COLUMNS} key columns, "
                         "one per table key column")
    for tk, k in zip(table.keys, key_cols):
        if (k.dtype != tk.dtype or k.dtype not in KEY_TYPE_CODES
                or k.shape[0] != n or not k.is_contiguous()
                or k.device != tk.device):
            raise ValueError(f"{what}'s key columns must be contiguous "
                             "int64, int32 or float64 of the table's "
                             "dtypes, on the table's device")


def lookup_or_insert(table: HashTable, key_cols: Sequence[torch.Tensor],
                     active: torch.Tensor):
    """Kernel K3 on a CUDA device, the plain version on the CPU. Same
    contract as `lookup_or_insert_plain`; the table is updated in place."""
    dev = active.device
    if dev.type == "cpu":
        return lookup_or_insert_plain(table, key_cols, active)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    N = active.shape[0]
    C = table.capacity
    if active.dtype != torch.bool or not active.is_contiguous():
        raise ValueError("active must be a contiguous bool tensor")
    check_key_columns(table, key_cols, N, "K3")
    if table.device != dev:
        raise ValueError("K3's table must be on the rows' device")
    i32 = dict(dtype=torch.int32, device=dev)
    slots = torch.empty(N, **i32)
    n_unresolved = torch.empty((), **i32)
    cap = scratch_capacity(N)
    scratch = torch.empty(cap, **i32)
    # the first-row set only where a key column is float64 (K3 keeps
    # the bits of a key's first row: -0.0 or +0.0)
    first_row = (torch.empty(cap, **i32)
                 if any(k.dtype == torch.float64 for k in key_cols)
                 else None)
    bucket_count = torch.empty(C // BUCKET_SLOTS, **i32)
    leader_of = torch.empty(N, **i32)
    cbucket = torch.empty(N, **i32)
    cfill = torch.empty(N, **i32)
    K_HT.launches += 1
    K_HT.call("rw_ht_lookup_or_insert", len(key_cols),
              kernels.ptr_array(key_cols), kernels.ptr_array(table.keys),
              kernels.int_array(KEY_TYPE_CODES[k.dtype] for k in key_cols),
              kernels.ptr(table.occupied), C, kernels.ptr(active), N,
              kernels.ptr(slots), kernels.ptr(n_unresolved),
              kernels.ptr(scratch), kernels.ptr_or_null(first_row), cap,
              kernels.ptr(bucket_count), kernels.ptr(leader_of),
              kernels.ptr(cbucket), kernels.ptr(cfill),
              kernels.stream_of(active))
    return table, slots, n_unresolved


def needs_rebuild(n_occupied: int, n_live: int, capacity: int,
                  hi: float = 0.7) -> tuple[bool, int]:
    """Host-side policy: rebuild when load > hi. Grow 2x only if the LIVE
    set itself crowds the table; a zombie-heavy table rebuilds at the
    same capacity (purge)."""
    if n_occupied <= hi * capacity:
        return False, capacity
    if n_live > 0.5 * hi * capacity:
        return True, capacity * 2
    return True, capacity
