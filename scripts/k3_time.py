#!/usr/bin/env python3
"""Kernel K3 (the hash table's find-or-claim) timed at q5's shape, on one
NVIDIA card.

    python3 scripts/k3_time.py [--root TREE] [--reps N]

Loads `risingwave_tpu_torch` from TREE (default: this checkout), so one
call can time an older tree's K3 and this one's on the same card, each
in its own process. The input is chip_smoke.py's K3 case: a 131072-bid
Nexmark chunk (2 us between events) through q5's hop window (10 s
windows sliding by 2 s, five rows a bid), its (auction, window start)
int64 keys into a 2^20-slot table pre-filled to half its slots by the
plain version; each timed call starts from that table again. The same
keys as float64 (both columns) are timed where the tree's K3 takes
float64 keys by value. Prints one JSON line: the median device time of
`lookup_or_insert` (CUDA events, the card gated while the host queues
the calls), the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

SLIDE_US, SIZE_US = 2_000_000, 10_000_000
GATE_CYCLES = 200_000_000


def median_ms(torch, fn, setup, reps: int) -> float:
    """Median device time of fn() in ms; setup() runs before each call,
    outside its events."""
    for _ in range(3):
        setup()
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(GATE_CYCLES)
    for s, e in zip(starts, ends):
        setup()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("k3_time: no CUDA device available", file=sys.stderr)
        return 2
    from risingwave_tpu_torch.connectors.nexmark import (
        NexmarkConfig, NexmarkGenerator,
    )
    from risingwave_tpu_torch.ops import hash_table as ht
    from risingwave_tpu_torch.ops import kernels
    from risingwave_tpu_torch.stream.hop_window import hop_expand
    kernels.build_all([kernels.KERNELS[k] for k in
                       ("nexmark_bid", "hop_window", "hash_table")])
    dev = torch.device("cuda", 0)
    n, C = 131072, 1 << 20
    gen = NexmarkGenerator("bid", chunk_size=n,
                           cfg=NexmarkConfig(inter_event_us=2), device=dev)
    chunk = gen.next_chunk()
    cols, _, vis = hop_expand(chunk.columns, chunk.ops, chunk.vis, 5,
                              SLIDE_US, SIZE_US, SIZE_US // SLIDE_US, (0, 7))
    keys = [cols[0].data.contiguous(), cols[1].data.contiguous()]
    g = torch.Generator(device="cpu").manual_seed(5)
    pre = torch.randint(0, 1 << 40, (C // 2,), generator=g).to(dev)
    out = dict(root=args.root, rows=int(vis.shape[0]),
               active=int(vis.sum()))
    cases = [("int64", torch.int64)]
    if torch.float64 in getattr(ht, "KEY_TYPE_CODES", {}):
        cases.append(("float64", torch.float64))
    for name, dt in cases:
        kc = [k.to(dt) for k in keys]
        base = ht.HashTable.empty(C, [dt, dt], dev)
        ht.lookup_or_insert_plain(base, [pre.to(dt), (pre ^ 0x5555).to(dt)],
                                  torch.ones(C // 2, dtype=torch.bool,
                                             device=dev))
        work = ht.HashTable(tuple(k.clone() for k in base.keys),
                            base.occupied.clone())

        def restore():
            for a, b in zip(work.keys, base.keys):
                a.copy_(b)
            work.occupied.copy_(base.occupied)

        out[f"{name}_ms"] = median_ms(
            torch, lambda: ht.lookup_or_insert(work, kc, vis), restore,
            args.reps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    out["nvidia_smi"] = smi.stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
