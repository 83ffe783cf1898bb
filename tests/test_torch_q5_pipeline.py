"""Nexmark q5 end to end on the port (plain PyTorch versions of K1-K4 on
the CPU) against the JAX package and a host recount: source -> HOP ->
hash agg -> MV, wired like tests/test_q5_pipeline.py with the arguments
the JAX planner derives for bench.py's _q5_ddl() (HOP output pruned to
(auction, window_start), watermark state cleaning on window_start,
source watermarks, transfer-free watchdog). Barriers are paced by row
count, so both engines cut the stream at the same rows.

Also rehearses chip_smoke.py's full-width phase at a tiny size: the live
groups of the device state equal a recount of the windows above the
cleaning watermark."""

import asyncio

import pytest

from risingwave_tpu.connectors.nexmark import (
    NexmarkConfig as JaxConfig, NexmarkGenerator as JaxGenerator,
)
from risingwave_tpu.expr.agg import count_star as jax_count_star
from risingwave_tpu.meta import BarrierCoordinator as JaxCoordinator
from risingwave_tpu.state import (
    MemoryStateStore as JaxStore, StateTable as JaxTable,
)
from risingwave_tpu.stream import (
    Actor as JaxActor, HashAggExecutor as JaxAgg,
    HopWindowExecutor as JaxHop, MaterializeExecutor as JaxMat,
    SourceExecutor as JaxSource,
)
from risingwave_tpu.stream.message import BarrierKind as JaxKind


@pytest.fixture(autouse=True, scope="module")
def _port():
    """Import torch and the port when these tests run, not at collection:
    an xdist worker then runs the JAX tests before them without torch
    (the sharded-join recovery tests abort more often with it loaded)."""
    global chip_smoke, NexmarkConfig
    import chip_smoke
    from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig


CHUNK, PER_BARRIER, ROUNDS, INTER_US = 128, 512, 4, 50_000


async def _jax_q5_mv():
    store = JaxStore()
    q = asyncio.Queue()
    gen = JaxGenerator("bid", chunk_size=CHUNK,
                       cfg=JaxConfig(inter_event_us=INTER_US))
    src = JaxSource(1, gen, q, emit_watermarks=True,
                    rate_limit_rows_per_barrier=PER_BARRIER)
    hop = JaxHop(src, time_col=5, window_slide_us=chip_smoke.SLIDE_US,
                 window_size_us=chip_smoke.SIZE_US,
                 output_indices=chip_smoke.Q5_OUTPUT_INDICES)
    agg = JaxAgg(hop, group_key_indices=[0, hop.window_start_idx],
                 agg_calls=[jax_count_star(append_only=True)],
                 capacity=1 << 12,
                 cleaning_watermark_col=chip_smoke.Q5_CLEANING_COL,
                 watchdog_interval=chip_smoke.Q5_WATCHDOG)
    mv = JaxTable(store, table_id=3, schema=agg.schema,
                  pk_indices=list(agg.pk_indices))
    coord = JaxCoordinator(store)
    coord.register_source(q)
    coord.register_actor(1)
    task = JaxActor(1, JaxMat(agg, mv), None, coord).spawn()
    b = await coord.inject_barrier(kind=JaxKind.INITIAL)
    await coord.wait_collected(b)
    for r in range(1, ROUNDS + 1):
        while gen.offset < r * PER_BARRIER:
            await asyncio.sleep(0)
        if r < ROUNDS:
            b = await coord.inject_barrier()
            await coord.wait_collected(b)
    await coord.stop_all({1})
    await task
    return {(row[0], row[1]): row[2] for _, row in mv.iter_all()}, gen.offset


def test_q5_mv_matches_jax_and_recount():
    q5 = chip_smoke.build_q5("cpu", CHUNK, 1 << 12, INTER_US, PER_BARRIER,
                             materialize=True)
    asyncio.run(chip_smoke.drive_paced(q5, PER_BARRIER, ROUNDS))
    got = chip_smoke.mv_groups(q5["mv"])
    jax_mv, jax_offset = asyncio.run(_jax_q5_mv())
    assert q5["gen"].offset == jax_offset == PER_BARRIER * ROUNDS
    want = chip_smoke.recount_windows(
        0, jax_offset, NexmarkConfig(inter_event_us=INTER_US), -(1 << 62),
        "cpu")
    assert got == jax_mv
    assert got == want
    assert len(got) > 20  # windows actually rolled


@pytest.mark.parametrize("inter_us", [3_000, 20_000])
def test_q5_live_groups_match_recount(inter_us):
    """chip_smoke's full-width check at a tiny size: cleaning evicts old
    windows, the transfer-free rehash purges them, and the surviving
    groups equal a recount of the windows above the watermark."""
    chunk, per_barrier, rounds = 256, 1024, 6
    q5 = chip_smoke.build_q5("cpu", chunk, 1 << 12, inter_us, per_barrier,
                             materialize=False)
    asyncio.run(chip_smoke.drive_paced(q5, per_barrier, rounds))
    agg, gen = q5["agg"], q5["gen"]
    assert agg.overflow() == 0
    cfg = NexmarkConfig(inter_event_us=inter_us)
    floor = agg.cleaned_below
    assert floor is not None and floor > cfg.base_time_us  # windows closed
    lo = chip_smoke.first_bid_at_or_after(floor, cfg)
    want = chip_smoke.recount_windows(lo, gen.offset, cfg, floor, "cpu")
    got = chip_smoke.live_groups(agg)
    assert got == want and len(got) > 0
    assert q5["head"].chunks > 0
    c = q5["coord"]
    assert len(c.latencies_ns) == rounds + 1
    assert c.barrier_latency_percentile(0.5) > 0


def test_first_bid_at_or_after():
    cfg = NexmarkConfig(inter_event_us=7)
    for ts in (cfg.base_time_us, cfg.base_time_us + 1,
               cfg.base_time_us + 123_456_789):
        k = chip_smoke.first_bid_at_or_after(ts, cfg)
        t = lambda i: cfg.base_time_us + chip_smoke._bid_gid(i) * 7
        assert t(k) >= ts and (k == 0 or t(k - 1) < ts)


def test_chip_smoke_kernel_phase_rehearsal(monkeypatch):
    """chip_smoke's kernel phase on the CPU at a small size: every kernel
    wrapper takes its plain version here, so this checks the phase's
    shapes, invariant checks and bound arithmetic, not the kernels."""
    monkeypatch.setattr(chip_smoke, "time_ms",
                        lambda fn, *a, **kw: (0.0, True))
    res = chip_smoke.phase_kernels("cpu", n=1024, C=1 << 13)
    assert sorted(res) == ["hash_agg", "hash_table", "hop_window",
                           "nexmark_bid"]
    for r in res.values():
        assert r["max_abs_err"] == 0 and r["bound_ms"] > 0
    checks = res["hash_table"]["checks"]
    assert checks[1]["existing_rows"] > 0
    assert checks[2]["n_unresolved_kernel"] > 0
