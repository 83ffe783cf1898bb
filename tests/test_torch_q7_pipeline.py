"""Nexmark q7 end to end on the port (plain PyTorch versions of the
kernels on the CPU) against the JAX package and a numpy recount.

Both engines are wired as the JAX planner deploys bench.py's _q7_ddl():
one shared bid source broadcast to the join's append-only left side
(NoOp -> Project -> RowIdGen) and to the TUMBLE projection feeding
MAX(price) GROUP BY window_end, whose retracting output is the join's
right side; sorted join with the band condition and band cleaning;
five actors, barriers paced by row count. The size is tiny: 128-bid
chunks, small capacities.

At one barrier per chunk and a chunk spanning less event time than the
watermark lag minus the window (here 6.4 s < 20 s - 10 s) the result
does not depend on how the actors interleave, so the net output of both
engines must equal the recount, with every error counter at 0. At
bench.py's own geometry (a 131072-bid chunk spans 32.8 s, 8 chunks a
barrier) the band cleaning evicts a window's max row before the agg's
update for it arrives and retractions miss: there both engines must
give the same lossy output and the same miss count, which
chip_smoke.q7_delete_misses predicts."""

import asyncio
from collections import Counter

import pytest

from risingwave_tpu.common.types import DataType as JDT
from risingwave_tpu.connectors.nexmark import (
    NexmarkConfig as JaxConfig, NexmarkGenerator as JaxGenerator,
)
from risingwave_tpu.expr import call as jcall, col as jcol, lit as jlit
from risingwave_tpu.expr.agg import agg_max as jagg_max
from risingwave_tpu.frontend.binder import (
    TumbleEndTransform as JEnd, TumbleStartTransform as JStart,
)
from risingwave_tpu.meta import BarrierCoordinator as JaxCoordinator
from risingwave_tpu.state import MemoryStateStore as JaxStore
from risingwave_tpu.stream import (
    Actor as JActor, BroadcastDispatcher as JBroadcast, Channel as JChannel,
    ChannelInput as JInput, HashAggExecutor as JAgg,
    ProjectExecutor as JProject, RowIdGenExecutor as JRowId,
    SimpleDispatcher as JSimple, SortedJoinExecutor as JJoin,
    SourceExecutor as JSource,
)
from risingwave_tpu.stream.executor import Executor as JExecutor
from risingwave_tpu.stream.message import BarrierKind as JKind
from risingwave_tpu.stream.misc import NoOpExecutor as JNoOp

CHUNK, INTER_US, ROUNDS = 128, 50_000, 16
JOIN_CAP, AGG_CAP = 1024, 64


@pytest.fixture(autouse=True, scope="module")
def _port():
    """Import torch and the port when these tests run, not at collection:
    an xdist worker then runs the JAX tests before them without torch
    (the sharded-join recovery tests abort more often with it loaded)."""
    global chip_smoke, NexmarkConfig
    import chip_smoke
    from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig


class _JaxCollect(JExecutor):
    def __init__(self, input):
        self.input = input
        self.schema = input.schema
        self.identity = "Collect"
        self.net = Counter()

    async def execute(self):
        async for m in self.input.execute():
            if hasattr(m, "to_rows"):
                for op, row in m.to_rows():
                    self.net[row] += 1 if op in (0, 3) else -1
            yield m


def _jax_q7(chunk, inter_us, per_barrier, rounds):
    """The JAX package's q7 wired like chip_smoke.build_q7."""
    W, TS = chip_smoke.Q7_W, JDT.TIMESTAMP
    coord = JaxCoordinator(JaxStore())
    q = asyncio.Queue()
    coord.register_source(q)
    gen = JaxGenerator("bid", chunk_size=chunk,
                       cfg=JaxConfig(inter_event_us=inter_us))
    src = JSource(1, gen, q, emit_watermarks=True,
                  watermark_lag_us=chip_smoke.Q7_LAG_US,
                  rate_limit_rows_per_barrier=per_barrier)
    bid = src.schema
    ch2, ch3, ch4, ch5l, ch5r = (JChannel() for _ in range(5))

    def refs(sch, idx):
        return [jcol(i, sch[i].data_type) for i in idx]

    left = JRowId(JProject(JNoOp(JInput(ch2, bid)), refs(bid, (0, 1, 2, 5)),
                           names=["auction", "bidder", "price",
                                  "date_time"]), instance=2)
    tumble = JProject(JInput(ch3, bid), refs(bid, range(7)) + [
        jcall("tumble_start", jcol(5, TS), jlit(W)),
        jcall("tumble_end", jcol(5, TS), jlit(W))],
        names=list(bid.names) + ["window_start", "window_end"],
        watermark_transforms={5: [(7, JStart(W)), (8, JEnd(W))]})
    windows = JProject(tumble, refs(tumble.schema, (8, 2)),
                       names=["window_end", "a2"])
    agg = JAgg(JInput(ch4, windows.schema), group_key_indices=[0],
               agg_calls=[jagg_max(1, JDT.INT64, append_only=True)],
               capacity=AGG_CAP, cleaning_watermark_col=0,
               watchdog_interval=None)
    right = JProject(agg, refs(agg.schema, (1, 0)),
                     names=["maxprice", "window_end"])
    cond = jcall("and", jcall("greater_than", jcol(3, TS),
                              jcall("subtract", jcol(6, TS), jlit(W))),
                 jcall("less_than_or_equal", jcol(3, TS), jcol(6, TS)))
    join = JJoin(JInput(ch5l, left.schema), JInput(ch5r, right.schema),
                 left_key_indices=[2], right_key_indices=[0],
                 left_pk_indices=[4], right_pk_indices=[1],
                 capacity=JOIN_CAP, match_factor=2, match_factors=(2, 2),
                 condition=cond, append_only=(True, False),
                 clean_specs=chip_smoke.Q7_CLEAN_SPECS,
                 watchdog_interval=None)
    out = JProject(join, refs(join.schema, (0, 2, 1, 3, 4, 6)),
                   names=["auction", "price", "bidder", "date_time", "_sk4",
                          "_sk6"])
    head = _JaxCollect(out)
    actors = [JActor(1, src, JBroadcast([ch2, ch3]), coord),
              JActor(2, left, JSimple(ch5l), coord),
              JActor(3, windows, JSimple(ch4), coord),
              JActor(4, right, JSimple(ch5r), coord),
              JActor(5, head, None, coord)]
    for a in actors:
        coord.register_actor(a.actor_id)

    async def go():
        tasks = [a.spawn() for a in actors]
        b = await coord.inject_barrier(kind=JKind.INITIAL)
        await coord.wait_collected(b)
        for r in range(1, rounds + 1):
            while gen.offset < r * per_barrier:
                await asyncio.sleep(0)
            if r < rounds:
                b = await coord.inject_barrier()
                await coord.wait_collected(b)
        await coord.stop_all({a.actor_id for a in actors})
        await asyncio.gather(*tasks)
    asyncio.run(go())
    import numpy as np
    return head.net, gen.offset, [int(x) for x in np.asarray(join._errs_dev)]


def _drop_row_id(net):
    """(auction, price, bidder, date_time, window_end): row ids differ
    between engines (they carry each run's barrier epochs)."""
    out = Counter()
    for r, c in net.items():
        out[(r[0], r[1], r[2], r[3], r[5])] += c
    return Counter({k: v for k, v in out.items() if v})


def test_q7_matches_jax_and_recount():
    q7 = chip_smoke.build_q7("cpu", CHUNK, INTER_US, CHUNK,
                             join_capacity=JOIN_CAP, agg_capacity=AGG_CAP,
                             collect=1 << 12)
    asyncio.run(chip_smoke.drive_paced(q7, CHUNK, ROUNDS))
    got, dropped = q7["head"].rows()
    jax_net, jax_offset, jax_errs = _jax_q7(CHUNK, INTER_US, CHUNK, ROUNDS)
    assert q7["gen"].offset == jax_offset == CHUNK * ROUNDS
    want = chip_smoke.q7_recount(jax_offset,
                                 NexmarkConfig(inter_event_us=INTER_US),
                                 "cpu")
    assert dropped == 0
    assert _drop_row_id(got) == _drop_row_id(jax_net) == want
    assert len(want) >= 8                 # windows rolled and matched
    assert q7["join"].errs() == jax_errs == [0, 0, 0]
    assert q7["agg"].overflow() == 0
    # the left side was cleaned by the band: far fewer rows than bids
    assert 0 < int(q7["join"].sides[0].n) < q7["gen"].offset // 2


def test_q7_bench_geometry_rehearsal():
    """chip_smoke's q7_full at a tiny size: 128-bid chunks spanning
    32.8 s of event time, 8 chunks a barrier. The band cleaning evicts a
    window's max row before the agg's U-/U+ for it arrives, so the
    output is lossy and deletes miss; the port must lose the same rows
    and count the same misses as the JAX executor, and the misses must
    be the ones chip_smoke.q7_delete_misses predicts (the gate q7_full
    holds on the card)."""
    chunk, inter_us, per_barrier, rounds = 128, 256_000, 8 * 128, 4
    q7 = chip_smoke.build_q7("cpu", chunk, inter_us, per_barrier,
                             join_capacity=JOIN_CAP, agg_capacity=AGG_CAP,
                             collect=1 << 12)
    asyncio.run(chip_smoke.drive_paced(q7, per_barrier, rounds))
    got, dropped = q7["head"].rows()
    jax_net, jax_offset, jax_errs = _jax_q7(chunk, inter_us, per_barrier,
                                            rounds)
    assert q7["gen"].offset == jax_offset == per_barrier * rounds
    assert dropped == 0
    assert _drop_row_id(got) == _drop_row_id(jax_net)
    errs = q7["join"].errs()
    assert errs == jax_errs
    cfg = NexmarkConfig(inter_event_us=inter_us)
    misses = chip_smoke.q7_delete_misses(jax_offset, per_barrier, cfg,
                                         "cpu")
    assert errs == [0, misses, 0] and misses == rounds - 1
    assert q7["agg"].overflow() == 0
    assert len(q7["coord"].latencies_ns) == rounds + 1
    # lossy: the recount holds rows this geometry cannot produce
    assert _drop_row_id(got) != chip_smoke.q7_recount(jax_offset, cfg,
                                                      "cpu")


def test_chip_smoke_q7_kernel_phase_rehearsal(monkeypatch):
    """chip_smoke's q7 kernel phase on the CPU at a small size: every
    wrapper takes its plain version here, so this checks the phase's
    shapes, comparisons and bound arithmetic, not the kernels."""
    monkeypatch.setattr(chip_smoke, "time_ms",
                        lambda fn, *a, **kw: (0.0, True))
    res = chip_smoke.phase_kernels_q7("cpu", n=512, join_cap=1 << 12,
                                      agg_cap=256)
    assert {"expr_eval", "sorted_join_probe", "sorted_join_merge",
            "row_id"} <= set(res)
    for name in ("expr_eval", "sorted_join_probe", "sorted_join_merge",
                 "row_id"):
        assert res[name]["max_abs_err"] == 0 and res[name]["bound_ms"] > 0
    assert res["sorted_join_probe"]["matches"] > 0
    assert res["sorted_join_merge"]["errs"][1] > 0    # a miss was forced


def test_q7_agg_shape_changelog_matches_jax():
    """q7's agg alone: MAX(price) append-only grouped on one int64 key
    (window_end), cleaning on that key in transfer-free mode
    (watchdog_interval=None). Chunks span several windows, one of them
    hot, with invisible rows; every barrier's changelog (the U-/U+ pairs
    that feed the join's retracting side) equals the JAX package's."""
    import numpy as np
    from risingwave_tpu.common import StreamChunk as JChunk
    from risingwave_tpu.common.epoch import EpochPair as JPair
    from risingwave_tpu.common.types import schema as jschema
    from risingwave_tpu.stream import message as jmsg
    from risingwave_tpu_torch.common import DataType, schema
    from risingwave_tpu_torch.common.epoch import EpochPair
    from risingwave_tpu_torch.expr.agg import agg_max
    from risingwave_tpu_torch.interop import chunk_from_numpy
    from risingwave_tpu_torch.stream import message as pmsg
    from risingwave_tpu_torch.stream.hash_agg import HashAggExecutor

    W = chip_smoke.Q7_W
    rng = np.random.default_rng(23)
    script, t = [("b",)], 0
    for _ in range(6):
        for _ in range(2):
            ts = t + np.sort(rng.integers(0, 3 * W, 128))
            t = int(ts[-1])
            price = rng.integers(1, 10**4, 128)
            price[rng.random(128) < 0.02] = 10**4 + 5       # ties at the top
            vis = rng.random(128) < 0.95
            script.append(("c", [ts - ts % W + W, price], vis))
            script.append(("w", t - 2 * W - t % W + W))
        script.append(("b",))

    class _In:
        def __init__(self, sch, msgs):
            self.schema, self.pk_indices, self._m = sch, (), msgs

        async def execute(self):
            for m in self._m:
                yield m
                await asyncio.sleep(0)

    def msgs(sch, chunk_fn, mod, pair, ts_dt):
        out, prev = [], 0
        for i, it in enumerate(script):
            if it[0] == "c":
                out.append(chunk_fn(sch, it[1], it[2]))
            elif it[0] == "w":
                out.append(mod.Watermark(0, ts_dt, it[1]))
            else:
                curr = (i + 1) << 16
                kind = (mod.BarrierKind.INITIAL if prev == 0
                        else mod.BarrierKind.CHECKPOINT)
                out.append(mod.Barrier(pair(curr, prev), kind))
                prev = curr
        return out

    jsch = jschema(("window_end", JDT.TIMESTAMP), ("a2", JDT.INT64))
    psch = schema(("window_end", DataType.TIMESTAMP), ("a2", DataType.INT64))
    jin = _In(jsch, msgs(
        jsch, lambda s, a, v: JChunk.from_numpy(
            s, a, capacity=len(v)).with_vis(np.asarray(v)),
        jmsg, JPair, JDT.TIMESTAMP))
    pin = _In(psch, msgs(
        psch, lambda s, a, v: chunk_from_numpy(
            s, a, np.zeros(len(v), np.int8), v, device="cpu"),
        pmsg, EpochPair, DataType.TIMESTAMP))
    kw = dict(group_key_indices=[0], capacity=AGG_CAP,
              cleaning_watermark_col=0, watchdog_interval=None)
    jagg = JAgg(jin, agg_calls=[jagg_max(1, JDT.INT64, append_only=True)],
                **kw)
    pagg = HashAggExecutor(pin, agg_calls=[agg_max(1, DataType.INT64,
                                                   append_only=True)],
                           device="cpu", **kw)

    async def logs(agg):
        out, cur = [], Counter()
        async for m in agg.execute():
            if hasattr(m, "to_rows"):
                cur.update(m.to_rows())
            elif hasattr(m, "epoch"):
                out.append(cur)
                cur = Counter()
        return out

    jl, pl = asyncio.run(logs(jagg)), asyncio.run(logs(pagg))
    assert len(pl) == len(jl) == 7
    assert pl == jl
    # updates of a window's max came out as U-/U+ pairs
    assert any(op == 2 for log in pl for op, _ in log)
    assert pagg.overflow() == 0 and pagg.cleaned_below is not None
