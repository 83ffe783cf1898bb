#!/usr/bin/env python3
"""Kernel K3 (the hash table's find-or-claim) against its plain version
on float64 keys, on one NVIDIA card.

    python3 scripts/k3_float_fault.py [--root TREE] [--stale]

Loads `risingwave_tpu_torch` from TREE (default: this checkout), so one
call can hold an older tree's K3 and this one's against the same plain
rule. The keys hold -0.0, +0.0, NaN, +-inf, negatives, 0.5, 1.1 and 1.9
(one `astype(uint64)` lane), 2^63 and 2^64, shuffled, with a fifth of
the rows inactive, in two chunks (the second finds the first's keys),
over an empty 16384-slot table and again over one pre-filled to an
eighth of its slots. The plain version places keys as the JAX package
does. Prints one JSON line per case and a last line {"ok": ...}: ok
when K3 gives -0.0 and +0.0 one slot, every NaN row a slot of its own,
the plain version's partition of rows into keys, its bucket and key
bits for every key and its per-bucket fill.

With --stale, the same cases run again with K3's scratch buffers
poisoned before the call (`lookup_or_insert_stale`: every row its own leader, 0x7fffffff,
-1): K3 must not read an entry it has not written in the same call. An
earlier K3 read `leader_of` for rows that hit, and a hit row whose stale
entry named itself copied a key from an unset first-row entry, an
access past the end of the key column.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HAZARDS = [0.0, -0.0, float("nan"), float("inf"), float("-inf"), -3.5,
           0.5, 1.1, 1.9, 2.0 ** 63, 2.0 ** 64, 7.0, 123456.0, -2.0 ** 70]


def hazard_keys(torch, n: int, seed: int):
    """n rows: distinct finite keys (x.25), a sixteenth of the rows
    hazards other than NaN, three NaN rows; a fifth inactive. The keys
    below 1.0 (every NaN row a key of its own) stay within their one
    bucket pair's 32 slots over two chunks, so nothing is unresolved."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    keys = torch.randint(2, 1 << 20, (n,), generator=g).to(torch.float64)
    keys += 0.25
    base = torch.tensor([h for h in HAZARDS if h == h], dtype=torch.float64)
    pick = torch.randperm(n, generator=g)
    haz = pick[:n // 16]
    keys[haz] = base[torch.randint(0, base.numel(), (haz.numel(),),
                                   generator=g)]
    keys[pick[n // 16:n // 16 + 3]] = float("nan")
    active = torch.rand(n, generator=g) < 0.8
    return keys, active


def partition(slots, active):
    """Row -> index of its slot group's first row (-1 inactive or
    unresolved): two slot assignments agree on the partition of rows
    into keys when these agree."""
    import torch
    n = slots.shape[0]
    ok = active & (slots >= 0)
    first = torch.full((int(slots.max().item()) + 2,), n, dtype=torch.int64,
                       device=slots.device)
    rows = torch.arange(n, device=slots.device)
    first.scatter_reduce_(0, torch.where(ok, slots.long(), first.shape[0] - 1),
                          rows, "amin")
    return torch.where(ok, first[slots.long().clamp(min=0)], -1)


STALE = ("self", "max", "neg")


def lookup_or_insert_stale(ht, kernels, table, key_cols, active, stale):
    """K3's entry as `ht.lookup_or_insert` calls it, with every scratch
    buffer filled first: "self" puts each row's own index in the
    per-row buffers and each entry's in the others, "max" 0x7fffffff,
    "neg" -1."""
    import torch
    dev = active.device
    N = active.shape[0]
    i32 = dict(dtype=torch.int32, device=dev)
    cap = ht.scratch_capacity(N)

    def buf(n):
        if stale == "self":
            return torch.arange(n, **i32)
        return torch.full((n,), 0x7fffffff if stale == "max" else -1, **i32)

    slots, scratch, first_row = buf(N), buf(cap), buf(cap)
    leader_of, cbucket, cfill = buf(N), buf(N), buf(N)
    bucket_count = buf(table.capacity // ht.BUCKET_SLOTS)
    n_unresolved = buf(1)
    ht.K_HT.call("rw_ht_lookup_or_insert", len(key_cols),
                 kernels.ptr_array(key_cols), kernels.ptr_array(table.keys),
                 kernels.int_array(ht.KEY_TYPE_CODES[k.dtype]
                                   for k in key_cols),
                 kernels.ptr(table.occupied), table.capacity,
                 kernels.ptr(active), N, kernels.ptr(slots),
                 kernels.ptr(n_unresolved), kernels.ptr(scratch),
                 kernels.ptr(first_row), cap, kernels.ptr(bucket_count),
                 kernels.ptr(leader_of), kernels.ptr(cbucket),
                 kernels.ptr(cfill), kernels.stream_of(active))
    return table, slots, n_unresolved[0]


def k3_float_report(ht, dev, n: int = 4096, cap: int = 16384,
                    prefill: bool = False, seed: int = 0,
                    stale=None) -> dict:
    """Run K3 (`ht.lookup_or_insert`, or with `stale` its entry over
    poisoned scratch) and its plain version on two chunks of hazard
    keys; the differences, counted."""
    import torch
    from risingwave_tpu_torch.ops import kernels
    S = ht.BUCKET_SLOTS
    tk = ht.HashTable.empty(cap, [torch.float64], dev)
    if prefill:
        pre = (torch.arange(cap // 8, dtype=torch.float64) * 3.0 + 1e9).to(dev)
        ht.lookup_or_insert_plain(tk, [pre], torch.ones(
            cap // 8, dtype=torch.bool, device=dev))
    tp = ht.HashTable(tuple(k.clone() for k in tk.keys), tk.occupied.clone())
    out = dict(rows=0, zero_slots_kernel=0, zero_slots_plain=0,
               nan_rows=0, nan_slots_kernel=0, nan_slots_plain=0,
               partition_diff=0, bucket_diff=0, fill_diff=0,
               key_bits_diff=0, n_unresolved_kernel=0,
               n_unresolved_plain=0)
    for chunk in range(2):
        keys, active = hazard_keys(torch, n, seed + chunk)
        keys, active = keys.to(dev), active.to(dev)
        if stale is None:
            _, sk, nk = ht.lookup_or_insert(tk, [keys], active)
        else:
            _, sk, nk = lookup_or_insert_stale(ht, kernels, tk, [keys],
                                               active, stale)
        _, sp, np_ = ht.lookup_or_insert_plain(tp, [keys], active)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        z = active & (keys == 0.0)
        nan = active & torch.isnan(keys)
        out["rows"] += int(active.sum())
        out["zero_slots_kernel"] += int(torch.unique(sk[z]).numel())
        out["zero_slots_plain"] += int(torch.unique(sp[z]).numel())
        out["nan_rows"] += int(nan.sum())
        out["nan_slots_kernel"] += int(torch.unique(sk[nan & (sk >= 0)])
                                       .numel())
        out["nan_slots_plain"] += int(torch.unique(sp[nan & (sp >= 0)])
                                      .numel())
        out["partition_diff"] += int((partition(sk, active)
                                      != partition(sp, active)).sum())
        ok = active & (sk >= 0) & (sp >= 0)
        out["bucket_diff"] += int(((sk[ok] // S) != (sp[ok] // S)).sum())
        kb = tk.keys[0][sk[ok].long()].view(torch.int64)
        pb = tp.keys[0][sp[ok].long()].view(torch.int64)
        out["key_bits_diff"] += int((kb != pb).sum())
        out["n_unresolved_kernel"] += int(nk)
        out["n_unresolved_plain"] += int(np_)
    B = cap // S
    out["fill_diff"] = int((tk.occupied.view(B, S).sum(1)
                            - tp.occupied.view(B, S).sum(1)).abs().max())
    out["ok"] = (out["zero_slots_kernel"] == out["zero_slots_plain"]
                 and out["nan_slots_kernel"] == out["nan_slots_plain"]
                 and not out["partition_diff"] and not out["bucket_diff"]
                 and not out["fill_diff"] and not out["key_bits_diff"]
                 and out["n_unresolved_kernel"] == out["n_unresolved_plain"])
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--stale", action="store_true",
                    help="also over poisoned scratch (this tree's K3 entry)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("k3_float_fault: no CUDA device available", file=sys.stderr)
        return 2
    from risingwave_tpu_torch.ops import hash_table as ht
    from risingwave_tpu_torch.ops import kernels
    kernels.build_all([kernels.KERNELS["hash_table"]])
    dev = torch.device("cuda", 0)
    ok = True
    for stale in (None, *STALE) if args.stale else (None,):
        for prefill in (False, True):
            r = k3_float_report(ht, dev, prefill=prefill, stale=stale)
            ok &= r["ok"]
            print(json.dumps({"root": args.root, "prefill": prefill,
                              "stale": stale, **r}), flush=True)
    print(json.dumps({"ok": ok, "root": args.root}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
