#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--host-profile]

Drives the port (`risingwave_tpu_torch`, never the JAX package) through
Nexmark q5 — bid source -> HOP(2 s, 10 s) -> count(*) GROUP BY (auction,
window_start) with watermark state cleaning — and holds every
hand-written kernel against its plain PyTorch version on the card.
Phases, one JSON line each:

  1. device: the card, torch/CUDA versions, the kernels' build time;
  2. each kernel vs its plain version at the q5 shapes, with CUDA-event
     timings, the plain and library times and the least time the card
     could take (bound);
  3. q5 end to end at full width (131072-row chunks, a 2^20-slot agg,
     barriers paced by row count) into the device blackhole sink, five
     times from fresh state to show the spread: every kernel launched
     in each run, no overflow, the live groups equal a host recount;
  4. a short full-width q5 run under torch.profiler: device busy time by
     kernel, and the device's idle share against phase 3's unprofiled
     median wall; then q5 into a materialized view at a small size: the
     MV equals a host recount;
  5. the kernels line: launches on phase 3's first run, error, times,
     bounds.
With --host-profile, phase 4 also runs q5 under cProfile and lists the
host functions with the most own time.
The last line is {"ok": true, "device": {...}}. Any failed phase exits
non-zero before it. Without a CUDA device the script exits 2.
"""

from __future__ import annotations

import asyncio
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from risingwave_tpu_torch.common.chunk import Column
from risingwave_tpu_torch.common.types import DataType
from risingwave_tpu_torch.connectors.nexmark import (
    NexmarkConfig, NexmarkGenerator, gen_bid_columns, gen_bid_columns_plain,
    vocab_ids,
)
from risingwave_tpu_torch.expr.agg import count_star
from risingwave_tpu_torch.meta import BarrierCoordinator
from risingwave_tpu_torch.ops import hash_table as ht
from risingwave_tpu_torch.ops import kernels
from risingwave_tpu_torch.state import MemoryStateStore, StateTable
from risingwave_tpu_torch.stream import (
    Actor, DeviceBlackholeSinkExecutor, HashAggExecutor, HopWindowExecutor,
    MaterializeExecutor, SourceExecutor,
)
from risingwave_tpu_torch.stream.hash_agg import (
    AggState, agg_apply, agg_apply_plain,
)
from risingwave_tpu_torch.stream.hop_window import (
    hop_expand, hop_expand_plain,
)
from risingwave_tpu_torch.stream.message import BarrierKind

SLIDE_US = 2_000_000
SIZE_US = 10_000_000
# What the JAX planner builds for bench.py's _q5_ddl() (read from its
# Session graph): HOP keeps (auction, window_start) — the planner's
# Project($0, $7) after an unpruned HOP, folded into output_indices —
# and the agg cleans state on window_start (its input column 1) in
# transfer-free watchdog mode (streaming_watchdog = 0).
Q5_OUTPUT_INDICES = (0, 7)
Q5_CLEANING_COL = 1
Q5_WATCHDOG = None

# H100 SXM peak device-memory rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12


# ------------------------------------------------------------ q5 wiring

def build_q5(device, chunk_size: int, capacity: int, inter_event_us: int,
             rows_per_barrier: int, materialize: bool):
    """Source -> HOP -> HashAgg -> (MV | device blackhole), wired like
    tests/test_q5_pipeline.py with the planner's q5 arguments."""
    store = MemoryStateStore()
    barrier_q: asyncio.Queue = asyncio.Queue()
    gen = NexmarkGenerator("bid", chunk_size=chunk_size,
                           cfg=NexmarkConfig(inter_event_us=inter_event_us),
                           device=device)
    src = SourceExecutor(1, gen, barrier_q, emit_watermarks=True,
                         rate_limit_rows_per_barrier=rows_per_barrier)
    hop = HopWindowExecutor(src, time_col=5, window_slide_us=SLIDE_US,
                            window_size_us=SIZE_US,
                            output_indices=Q5_OUTPUT_INDICES)
    agg = HashAggExecutor(hop, group_key_indices=[0, hop.window_start_idx],
                          agg_calls=[count_star(append_only=True)],
                          capacity=capacity,
                          cleaning_watermark_col=Q5_CLEANING_COL,
                          watchdog_interval=Q5_WATCHDOG, device=device)
    mv = None
    if materialize:
        mv = StateTable(store, table_id=3, schema=agg.schema,
                        pk_indices=list(agg.pk_indices))
        head = MaterializeExecutor(agg, mv)
    else:
        head = DeviceBlackholeSinkExecutor(agg)
    coord = BarrierCoordinator(store)
    coord.register_source(barrier_q)
    coord.register_actor(1)
    return dict(gen=gen, src=src, hop=hop, agg=agg, mv=mv, head=head,
                coord=coord)


async def drive_paced(q5: dict, rows_per_barrier: int, rounds: int) -> float:
    """Initial barrier, then `rounds` barriers, each injected once the
    source has emitted exactly rows_per_barrier more rows (it parks at
    its rate limit); the last one is the Stop barrier, so no row follows
    it. Returns the wall seconds of the rounds."""
    coord, gen = q5["coord"], q5["gen"]
    task = Actor(1, q5["head"], None, coord).spawn()
    b = await coord.inject_barrier(kind=BarrierKind.INITIAL)
    await coord.wait_collected(b)
    t0 = time.perf_counter()
    for r in range(1, rounds + 1):
        while gen.offset < r * rows_per_barrier:
            if task.done():
                task.result()
            await asyncio.sleep(0)
        if r < rounds:
            b = await coord.inject_barrier()
            await coord.wait_collected(b)
        else:
            await coord.stop_all({1})
    wall = time.perf_counter() - t0
    await task
    return wall


def _bid_gid(k):
    return (k // 46) * 50 + 4 + k % 46


def first_bid_at_or_after(ts_us: int, cfg: NexmarkConfig) -> int:
    """Smallest bid index whose event time is >= ts_us (event time is
    monotone in the bid index)."""
    lo, hi = 0, 1
    while cfg.base_time_us + _bid_gid(hi) * cfg.inter_event_us < ts_us:
        hi *= 2
    while lo < hi:
        mid = (lo + hi) // 2
        if cfg.base_time_us + _bid_gid(mid) * cfg.inter_event_us < ts_us:
            lo = mid + 1
        else:
            hi = mid
    return lo


def recount_windows(start: int, end: int, cfg: NexmarkConfig, min_ws: int,
                    device, batch: int = 1 << 20) -> dict:
    """{(auction, window_start): count} over bids [start, end) for windows
    with window_start >= min_ws — a numpy recount of the generator's
    prefix, like bench.py's _numpy_q5. The bids come from the plain
    PyTorch generator (held bit-identical to the JAX package by the CPU
    tests)."""
    vocabs = {k: torch.tensor(v, dtype=torch.int32, device=device)
              for k, v in vocab_ids().items()}
    K = SIZE_US // SLIDE_US
    auctions, starts = [], []
    for off in range(start, end, batch):
        n = min(batch, end - off)
        cols = gen_bid_columns_plain(off, n, cfg, vocabs, device)
        auction = cols[0].cpu().numpy()
        ts = cols[5].cpu().numpy()
        base = (ts // SLIDE_US) * SLIDE_US
        for k in range(K):
            ws = base - k * SLIDE_US
            keep = (ts < ws + SIZE_US) & (ws >= min_ws)
            auctions.append(auction[keep])
            starts.append(ws[keep])
    a = np.concatenate(auctions or [np.empty(0, np.int64)])
    w = np.concatenate(starts or [np.empty(0, np.int64)])
    if a.size == 0:
        return {}
    # one int64 key per (auction, window): np.unique on it is much
    # faster than on rows
    w0 = int(w.min())
    widx = (w - w0) // SLIDE_US
    if int(widx.max()) >= 1 << 24 or int(a.min()) < 0 \
            or int(a.max()) >= 1 << 38:
        raise ValueError("recount key out of range")
    uniq, counts = np.unique((a << 24) | widx, return_counts=True)
    return {(int(u >> 24), w0 + int(u & ((1 << 24) - 1)) * SLIDE_US): int(c)
            for u, c in zip(uniq, counts)}


def live_groups(agg: HashAggExecutor) -> dict:
    st = agg.state
    live = (st.table.occupied & (st.row_count > 0)).cpu().numpy()
    a = st.table.keys[0].cpu().numpy()[live]
    w = st.table.keys[1].cpu().numpy()[live]
    c = st.row_count.cpu().numpy()[live]
    return {(int(x), int(y)): int(z) for x, y, z in zip(a, w, c)}


def mv_groups(mv: StateTable) -> dict:
    return {(row[0], row[1]): row[2] for _, row in mv.iter_all()}


# ------------------------------------------------------------- K3 checks

def k3_invariants(before: ht.HashTable, key_cols, active, slots_k, n_k,
                  table_k, slots_p, n_p, table_p) -> dict:
    """What must hold between K3 and its plain version on the same input
    (K3 may order new keys differently inside a bucket). Raises on the
    first violation; returns the measured quantities."""
    S = ht.BUCKET_SLOTS
    B = before.capacity // S
    fill_k = table_k.occupied.view(B, S).sum(1)
    fill_p = table_p.occupied.view(B, S).sum(1)
    fill_diff = int((fill_k - fill_p).abs().max())
    if fill_diff:
        raise AssertionError(f"K3 per-bucket fill differs by {fill_diff}")

    def unresolved_keys(slots):
        bad = active & (slots < 0)
        if not bool(bad.any()):
            return 0
        ks = torch.stack([k[bad].to(torch.int64) for k in key_cols], 1)
        return int(torch.unique(ks, dim=0).shape[0])

    uk, up = unresolved_keys(slots_k), unresolved_keys(slots_p)
    if uk != up:
        raise AssertionError(f"K3 distinct unresolved keys {uk} != {up}")
    if (int(n_k) > 0) != (int(n_p) > 0):
        raise AssertionError(f"K3 n_unresolved {int(n_k)} vs {int(n_p)}")
    # rows with equal keys get equal slots
    ks = torch.stack([k.to(torch.int64) for k in key_cols], 1)[active]
    sl = slots_k[active].to(torch.int64)
    uniq, inv = torch.unique(ks, dim=0, return_inverse=True)
    smin = torch.full((uniq.shape[0],), 2**40,
                      device=sl.device).scatter_reduce(0, inv, sl, "amin")
    smax = torch.full((uniq.shape[0],), -2**40,
                      device=sl.device).scatter_reduce(0, inv, sl, "amax")
    if bool((smin != smax).any()):
        raise AssertionError("K3 gave rows with equal keys different slots")
    # existing keys keep their slot; resolved rows point at their key
    pre = ht.lookup(before, key_cols, active)
    had = pre >= 0
    if bool((slots_k[had] != pre[had]).any()):
        raise AssertionError("K3 moved an existing key")
    ok = active & (slots_k >= 0)
    for tk, k in zip(table_k.keys, key_cols):
        if bool((tk[slots_k[ok].long()] != k[ok]).any()):
            raise AssertionError("K3 slot does not hold its row's key")
    # the same keys land in the same buckets when nothing overflowed
    if int(n_p) == 0:
        def bucket_keys(table):
            occ = table.occupied
            idx = torch.nonzero(occ)[:, 0]
            cols = [idx // S] + [tk[idx].to(torch.int64) for tk in table.keys]
            return torch.unique(torch.stack(cols, 1), dim=0)
        bk, bp = bucket_keys(table_k), bucket_keys(table_p)
        if bk.shape != bp.shape or bool((bk != bp).any()):
            raise AssertionError("K3 placed keys in other buckets")
    return {"fill_diff": fill_diff, "unresolved_keys": uk,
            "n_unresolved_kernel": int(n_k), "n_unresolved_plain": int(n_p),
            "existing_rows": int(had.sum())}


# ------------------------------------------------------------- timing

# cycles the card sleeps while the host queues a timed batch (~0.1 s)
GATE_CYCLES = 200_000_000


def time_ms(fn, setup=None, reps: int = 20,
            warmup: int = 3) -> tuple[float, bool]:
    """(median device time of fn() in ms, whether the host queued every
    call ahead of the card), by CUDA events around each call.

    The card first sleeps (torch.cuda._sleep) while the host queues all
    reps, so the events bracket device work only, not the host's launch
    latency: a 10 us kernel behind 50 us of Python would otherwise time
    as 50 us. setup() runs before each call, outside its events. If the
    host could not queue everything before the sleep ended (a plain
    version that syncs, say), the time includes host waits and the flag
    is False."""
    for _ in range(warmup):
        if setup:
            setup()
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    gate = torch.cuda.Event()
    torch.cuda._sleep(GATE_CYCLES)
    gate.record()
    for s, e in zip(starts, ends):
        if setup:
            setup()
        s.record()
        fn()
        e.record()
    ahead = not gate.query()
    torch.cuda.synchronize()
    return (statistics.median(s.elapsed_time(e)
                              for s, e in zip(starts, ends)), ahead)


def timings(kernel_fn, plain_fn, setup=None, library_fn=None) -> dict:
    """Kernel, plain and library times, with the queued-ahead flags."""
    ms, k_ok = time_ms(kernel_fn, setup)
    plain_ms, p_ok = time_ms(plain_fn, setup, reps=5)
    library_ms, l_ok = (time_ms(library_fn) if library_fn is not None
                        else (None, None))
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                queued_ahead={"ms": k_ok, "plain_ms": p_ok,
                              "library_ms": l_ok})


def max_diff(xs, ys) -> int:
    """Largest absolute difference between paired integer tensors."""
    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
               for x, y in zip(xs, ys))


def bytes_bound_ms(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


# ------------------------------------------------------------- phases

def phase_kernels(dev, n: int = 131072, C: int = 1 << 20) -> dict:
    """Each kernel against its plain version at q5's shapes (bids per
    chunk n, agg capacity C)."""
    cfg = NexmarkConfig(inter_event_us=2)
    gen = NexmarkGenerator("bid", chunk_size=n, cfg=cfg, device=dev)
    vocabs = gen.vocabs
    res = {}

    # ---- K1: bid columns at offsets 0 and ~1e12, and with runtime
    # moduli that are not q5's
    err = 0
    odd = NexmarkConfig(inter_event_us=50_000, in_flight_auctions=97,
                        num_active_people=1009)
    for off, c in ((0, cfg), (10**12 + 7, cfg), (987_654_321, odd)):
        err = max(err, max_diff(gen_bid_columns(off, n, c, vocabs, dev),
                                gen_bid_columns_plain(off, n, c, vocabs,
                                                      dev)))
    if err:
        raise AssertionError(f"K1 differs from plain by {err}")
    off = 10**9
    res["nexmark_bid"] = dict(
        max_abs_err=err,
        **timings(lambda: gen_bid_columns(off, n, cfg, vocabs, dev),
                  lambda: gen_bid_columns_plain(off, n, cfg, vocabs, dev)),
        bound_ms=bytes_bound_ms(n * (4 * 8 + 3 * 4)), bound_by="bytes")
    emit({"phase": "kernel", "name": "nexmark_bid", **res["nexmark_bid"]})

    # ---- K2: hop expansion of a bid chunk with q5's pruning; a slide
    # that does not divide the size; every column (int32 dictionary ids)
    # with a NULL mask and invisible rows
    chunk = gen.next_chunk()
    g = torch.Generator(device="cpu").manual_seed(3)
    cols_nulls = list(chunk.columns)
    cols_nulls[3] = Column(cols_nulls[3].data,
                           (torch.rand(n, generator=g) < 0.7).to(dev))
    vis_some = (torch.rand(n, generator=g) < 0.9).to(dev)
    err = 0
    for columns, vis_in, slide, out_idx in (
            (chunk.columns, chunk.vis, SLIDE_US, Q5_OUTPUT_INDICES),
            (chunk.columns, chunk.vis, 3_000_000, Q5_OUTPUT_INDICES),
            (cols_nulls, vis_some, SLIDE_US, tuple(range(9)))):
        K = math.ceil(SIZE_US / slide)
        hop_args = (columns, chunk.ops, vis_in, 5, slide, SIZE_US, K,
                    out_idx)
        a, b = hop_expand(*hop_args), hop_expand_plain(*hop_args)
        err = max(err, max_diff(
            [c.data for c in a[0]] + [c.valid for c in a[0]
                                      if c.valid is not None] + [a[1], a[2]],
            [c.data for c in b[0]] + [c.valid for c in b[0]
                                      if c.valid is not None] + [b[1], b[2]]))
    if err:
        raise AssertionError(f"K2 differs from plain by {err}")
    K = SIZE_US // SLIDE_US
    args = (chunk.columns, chunk.ops, chunk.vis, 5, SLIDE_US, SIZE_US, K,
            Q5_OUTPUT_INDICES)
    res["hop_window"] = dict(
        max_abs_err=err,
        **timings(lambda: hop_expand(*args), lambda: hop_expand_plain(*args)),
        bound_ms=bytes_bound_ms(n * (8 + 8 + 1 + 1) + K * n * (8 + 8 + 1 + 1)),
        bound_by="bytes")
    emit({"phase": "kernel", "name": "hop_window", **res["hop_window"]})

    # ---- K3: into a 2^20 table pre-filled to ~0.5 load
    cols, ops, vis = hop_expand(*args)
    key_cols = [cols[0].data.contiguous(), cols[1].data.contiguous()]
    base = ht.HashTable.empty(C, [torch.int64, torch.int64], dev)
    g = torch.Generator(device="cpu").manual_seed(5)
    pre = torch.randint(0, 1 << 40, (C // 2,), generator=g).to(dev)
    ht.lookup_or_insert_plain(base, [pre, pre ^ 0x5555], torch.ones(
        C // 2, dtype=torch.bool, device=dev))
    checks = []

    def clone(t: ht.HashTable) -> ht.HashTable:
        return ht.HashTable(tuple(k.clone() for k in t.keys),
                            t.occupied.clone())

    def run_case(before, kc, act):
        tk, tp = clone(before), clone(before)
        _, sk, nk = ht.lookup_or_insert(tk, kc, act)
        _, sp, np_ = ht.lookup_or_insert_plain(tp, kc, act)
        checks.append(k3_invariants(before, kc, act, sk, nk, tk, sp, np_, tp))
        return tk

    after = run_case(base, key_cols, vis)    # the chunk's keys are new
    run_case(after, key_cols, vis)           # now every key exists
    # forced overflow: 4096 distinct keys into 1024 slots
    small = ht.HashTable.empty(1024, [torch.int64, torch.int64], dev)
    ov = torch.arange(4096, device=dev, dtype=torch.int64)
    run_case(small, [ov, ov * 3], torch.ones(4096, dtype=torch.bool,
                                             device=dev))
    if not checks[2]["n_unresolved_kernel"]:
        raise AssertionError("K3 forced-overflow case reported no overflow")
    # int64 + int32 keys with negatives, some rows inactive
    mixed = ht.HashTable.empty(4096, [torch.int64, torch.int32], dev)
    ka = torch.randint(-50, 50, (20000,), generator=g).to(dev)
    kb = torch.randint(-3, 4, (20000,), generator=g,
                       dtype=torch.int32).to(dev)
    run_case(mixed, [ka, kb], (torch.rand(20000, generator=g) < 0.8).to(dev))
    work = clone(base)

    def restore():
        for a, b in zip(work.keys, base.keys):
            a.copy_(b)
        work.occupied.copy_(base.occupied)

    N = key_cols[0].shape[0]
    ks = torch.stack(key_cols, 1)[vis]
    n_distinct = int(torch.unique(ks, dim=0).shape[0])
    k3_bytes = (N * (8 + 8 + 1) + N * 4 + n_distinct * 2 * 16 * (8 + 8 + 1)
                + n_distinct * (8 + 8 + 1))
    res["hash_table"] = dict(
        max_abs_err=max(c["fill_diff"] for c in checks),
        **timings(lambda: ht.lookup_or_insert(work, key_cols, vis),
                  lambda: ht.lookup_or_insert_plain(work, key_cols, vis),
                  setup=restore),
        bound_ms=bytes_bound_ms(k3_bytes), bound_by="bytes",
        distinct_keys=n_distinct, checks=checks)
    emit({"phase": "kernel", "name": "hash_table", **res["hash_table"]})

    # ---- K4: apply the chunk's slots to a zeroed 2^20 count state
    t3 = clone(base)
    _, slots, n_un = ht.lookup_or_insert(t3, key_cols, vis)
    spec = count_star(append_only=True).spec()

    def fresh_state():
        return AggState(
            table=t3, agg_states=(spec.init_state(C, dev),),
            row_count=torch.zeros(C, dtype=torch.int64, device=dev),
            dirty=torch.zeros(C, dtype=torch.bool, device=dev),
            prev_exists=torch.zeros(C, dtype=torch.bool, device=dev),
            prev_emit=(torch.zeros(C, dtype=torch.int64, device=dev),))

    sk, sp = fresh_state(), fresh_state()
    ovk = torch.zeros((), dtype=torch.int32, device=dev)
    ovp = torch.zeros((), dtype=torch.int32, device=dev)
    inputs = [(None, None)]
    agg_apply(sk, [spec], slots, ops, inputs, n_un, ovk)
    agg_apply_plain(sp, [spec], slots, ops, inputs, n_un, ovp)
    err = max(int((sk.row_count - sp.row_count).abs().max()),
              int((sk.agg_states[0] - sp.agg_states[0]).abs().max()),
              int((sk.dirty != sp.dirty).sum()), int((ovk - ovp).abs()))
    err = max(err, k4_all_kinds_err(dev))
    if err:
        raise AssertionError(f"K4 differs from plain by {err}")
    st = fresh_state()
    ov = torch.zeros((), dtype=torch.int32, device=dev)

    def zero():
        st.row_count.zero_()
        st.agg_states[0].zero_()
        st.dirty.zero_()

    seg = torch.where(slots >= 0, slots, C).long()
    signs = torch.where(slots >= 0, 1, 0).to(torch.int64)
    rc_pad = torch.zeros(C + 1, dtype=torch.int64, device=dev)
    n_slots = int(torch.unique(slots[slots >= 0]).shape[0])
    res["hash_agg"] = dict(
        max_abs_err=err,
        **timings(lambda: agg_apply(st, [spec], slots, ops, inputs, n_un, ov),
                  lambda: agg_apply_plain(st, [spec], slots, ops, inputs,
                                          n_un, ov),
                  setup=zero,
                  library_fn=lambda: rc_pad.index_add_(0, seg, signs)),
        bound_ms=bytes_bound_ms(N * (4 + 1) + n_slots * (16 + 16 + 1)),
        bound_by="bytes", touched_slots=n_slots)
    emit({"phase": "kernel", "name": "hash_agg", **res["hash_agg"]})
    return res


def k4_all_kinds_err(dev) -> int:
    """K4 vs plain with every agg kind, NULLs and deletes (float SUM
    within a relative 1e-12: atomics add in another order)."""
    from risingwave_tpu_torch.expr.agg import agg_max, agg_min, agg_sum
    C, N = 4096, 65536
    g = torch.Generator(device="cpu").manual_seed(9)
    slots = torch.randint(-1, 64, (N,), generator=g).to(torch.int32).to(dev)
    ops = torch.randint(0, 4, (N,), generator=g).to(torch.int8).to(dev)
    iv = torch.randint(-10**6, 10**6, (N,), generator=g).to(dev)
    fv = (torch.rand(N, generator=g, dtype=torch.float64) * 100).to(dev)
    valid = (torch.rand(N, generator=g) < 0.8).to(dev)
    calls = [count_star(), agg_sum(0), agg_sum(1, DataType.FLOAT64),
             agg_min(0, append_only=True), agg_max(1, DataType.FLOAT64,
                                                   append_only=True),
             agg_sum(2)]
    specs = [c.spec() for c in calls]
    i32 = iv.to(torch.int32)
    inputs = [(None, None), (iv, valid), (fv, None), (iv, valid), (fv, None),
              (i32, None)]
    n_un = torch.tensor(3, dtype=torch.int32, device=dev)
    states = []
    for fn in (agg_apply, agg_apply_plain):
        st = AggState(
            table=ht.HashTable.empty(C, [torch.int64], dev),
            agg_states=tuple(s.init_state(C, dev) for s in specs),
            row_count=torch.zeros(C, dtype=torch.int64, device=dev),
            dirty=torch.zeros(C, dtype=torch.bool, device=dev),
            prev_exists=torch.zeros(C, dtype=torch.bool, device=dev),
            prev_emit=())
        ov = torch.zeros((), dtype=torch.int32, device=dev)
        fn(st, specs, slots, ops, inputs, n_un, ov)
        states.append((st, ov))
    (a, oa), (b, ob) = states
    err = int((a.row_count - b.row_count).abs().max())
    err = max(err, int((a.dirty != b.dirty).sum()), int((oa - ob).abs()))
    for j, (x, y) in enumerate(zip(a.agg_states, b.agg_states)):
        if x.dtype == torch.float64 and j == 2:
            rel = ((x - y).abs() / y.abs().clamp(min=1e-300)).max()
            if float(rel) > 1e-12:
                err = max(err, 1)
        else:
            err = max(err, int((x != y).sum()))
    return err


def q5_full_run(dev, cfg: NexmarkConfig, chunk: int, cap: int,
                per_barrier: int, rounds: int) -> dict:
    """One full-width q5 run from fresh state, checked: counts set to 0
    just before the drive and read just after."""
    q5 = build_q5(dev, chunk, cap, cfg.inter_event_us, per_barrier,
                  materialize=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    wall = asyncio.run(drive_paced(q5, per_barrier, rounds))
    launches = {k.name: k.launches for k in kernels.KERNELS.values()}
    torch.cuda.synchronize()
    agg, coord, gen = q5["agg"], q5["coord"], q5["gen"]
    overflow = agg.overflow()
    if overflow:
        raise AssertionError(f"q5 device overflow {overflow}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on q5: {missing}")
    t0 = time.perf_counter()
    got = live_groups(agg)
    lo = first_bid_at_or_after(agg.cleaned_below, cfg)
    want = recount_windows(lo, gen.offset, cfg, agg.cleaned_below, dev)
    recount_s = time.perf_counter() - t0
    if got != want:
        diff = set(got.items()) ^ set(want.items())
        raise AssertionError(
            f"q5 live groups differ from the recount: {len(got)} vs "
            f"{len(want)} groups, {len(diff)} differing entries")
    return dict(
        bids=gen.offset, wall_s=wall, bids_per_s=gen.offset / wall,
        barrier_p50_s=coord.barrier_latency_percentile(0.5),
        barrier_p99_s=coord.barrier_latency_percentile(0.99),
        live_groups=len(got), cleaned_below=agg.cleaned_below,
        overflow=overflow, rebuilds=agg.rebuilds, recount_s=recount_s,
        mem_allocated_bytes=torch.cuda.memory_allocated(dev),
        mem_peak_bytes=torch.cuda.max_memory_allocated(dev),
        launches=launches)


def phase_q5_full(dev, repeats: int = 5) -> dict:
    """q5 at full width into the device blackhole sink, `repeats` times
    on the same data: the first run's launches feed the kernels line,
    the medians and the min..max of the runs are the phase's numbers."""
    chunk, cap = 131072, 1 << 20
    per_barrier, rounds = 32 * chunk, 14
    cfg = NexmarkConfig(inter_event_us=2)
    runs = [q5_full_run(dev, cfg, chunk, cap, per_barrier, rounds)
            for _ in range(repeats)]
    first = runs[0]

    def spread(key):
        vals = [r[key] for r in runs]
        return statistics.median(vals), min(vals), max(vals)

    (rate, rate_lo, rate_hi) = spread("bids_per_s")
    return dict(
        bids=first["bids"], hop_rows=first["bids"] * (SIZE_US // SLIDE_US),
        barriers=rounds, chunks=first["bids"] // chunk, repeats=repeats,
        wall_s=spread("wall_s")[0], bids_per_s=rate,
        bids_per_s_min=rate_lo, bids_per_s_max=rate_hi,
        barrier_p50_s=spread("barrier_p50_s")[0],
        barrier_p99_s=spread("barrier_p99_s")[0],
        runs=[{k: r[k] for k in ("wall_s", "bids_per_s", "barrier_p50_s",
                                 "barrier_p99_s", "mem_peak_bytes")}
              for r in runs],
        **{k: first[k] for k in ("live_groups", "cleaned_below", "overflow",
                                 "rebuilds", "recount_s",
                                 "mem_allocated_bytes", "mem_peak_bytes",
                                 "launches")})


def phase_q5_profile(dev, full: dict, rounds: int = 4,
                     host: bool = False) -> dict:
    """Where q5's time goes: a fresh full-width run of a few barriers
    under torch.profiler. Device busy = the sum of kernel times on the
    card (one stream, so they do not overlap). The idle share is 1 -
    device busy per chunk over phase 3's unprofiled median wall per
    chunk; the share against the profiled run's own wall (which the
    profiler stretches) is kept beside it. Kernel names are cut to 60
    characters."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    chunk = 131072
    per_barrier = 32 * chunk
    q5 = build_q5(dev, chunk, 1 << 20, 2, per_barrier, materialize=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = asyncio.run(drive_paced(q5, per_barrier, rounds))
        torch.cuda.synchronize()
    kev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict = {}
    for e in kev:
        name = e.name[:60]
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + e.time_range.elapsed_us(), c + 1)
    busy_s = sum(t for t, _ in by_name.values()) / 1e6
    chunks = q5["gen"].offset // chunk
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    busy_per_chunk = busy_s / chunks
    wall_per_chunk = full["wall_s"] / full["chunks"]
    return dict(
        rounds=rounds, chunks=chunks, wall_s=wall, device_busy_s=busy_s,
        device_busy_per_chunk_s=busy_per_chunk,
        unprofiled_wall_per_chunk_s=wall_per_chunk,
        device_idle_share=(1 - busy_per_chunk / wall_per_chunk)
        if kev else None,
        device_idle_share_profiled=(1 - busy_s / wall) if kev else None,
        device_events=len(kev),
        top_kernels=[{"name": n, "ms": t / 1e3, "count": c}
                     for n, (t, c) in top],
        **({"host_top": host_profile(dev, rounds)} if host else {}))


def host_profile(dev, rounds: int) -> list:
    """The host's share: the same run under cProfile, the functions with
    the most own time (cProfile slows every Python call, so read the
    order, not the absolute times)."""
    import cProfile
    import pstats
    chunk = 131072
    per_barrier = 32 * chunk
    q5 = build_q5(dev, chunk, 1 << 20, 2, per_barrier, materialize=False)
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    asyncio.run(drive_paced(q5, per_barrier, rounds))
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:12]
    return [{"fn": f"{os.path.basename(f)}:{line}({name})",
             "tottime_s": tt, "ncalls": nc}
            for (f, line, name), (_, nc, tt, _, _) in rows]


def phase_q5_mv(dev) -> dict:
    """test_q5_core_end_to_end's shape on the card, into an MV."""
    chunk, per_barrier, rounds = 128, 512, 4
    cfg = NexmarkConfig(inter_event_us=50_000)
    q5 = build_q5(dev, chunk, 1 << 12, 50_000, per_barrier,
                  materialize=True)
    asyncio.run(drive_paced(q5, per_barrier, rounds))
    got = mv_groups(q5["mv"])
    want = recount_windows(0, q5["gen"].offset, cfg, -(1 << 62), dev)
    if got != want:
        raise AssertionError(f"q5 MV differs from the recount: {len(got)} "
                             f"vs {len(want)} groups")
    if len(got) <= 20:
        raise AssertionError("q5 MV: windows did not roll")
    return dict(groups=len(got), bids=q5["gen"].offset)


def main(argv) -> int:
    unknown = [a for a in argv if a != "--host-profile"]
    if unknown:
        print(f"chip_smoke: unknown arguments {unknown}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    build_s = kernels.build_all()
    logs = {k.name: [ln for ln in k.log_path.read_text().splitlines()
                     if "registers" in ln or "spill" in ln][:6]
            for k in kernels.KERNELS.values() if k.log_path.exists()}
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "build_s": build_s,
          "ptxas": logs})
    res = phase_kernels(dev)
    q5 = phase_q5_full(dev)
    emit({"phase": "q5_full", "nvidia_smi": smi, **q5})
    emit({"phase": "q5_profile",
          **phase_q5_profile(dev, q5, host="--host-profile" in argv)})
    mv = phase_q5_mv(dev)
    emit({"phase": "q5_mv", **mv})
    rows = []
    for name, k in kernels.KERNELS.items():
        r = res[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": str(k.source.relative_to(
                os.path.dirname(os.path.abspath(__file__)))),
            "replaces": k.replaces, "launches": q5["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
