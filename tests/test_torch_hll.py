"""Differential tests of approx_count_distinct's HLL: the port's hash,
bucket and rank, `lane_partial`/`lane_combine` and the plain version of
kernel K30 (`hll_update_plain`) against the JAX package's
`expr/hll.py`; the estimate against JAX's and its batch estimator; and
the hash agg and the simple agg with HLL register words, fed the same
scripted chunks, in lockstep with JAX's executors (per-barrier
changelogs as multisets, every register word exact).

Values cover int64, int32, bool and float64 (NaN, +-0, +-inf: a float's
float64 bit pattern is hashed), with NULLs, invisible rows and
non-insert ops (a register only sees rows of positive sign)."""

import asyncio
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest

from risingwave_tpu.common import DataType as JDT
from risingwave_tpu.common import StreamChunk as JChunk
from risingwave_tpu.common.epoch import EpochPair as JEpochPair
from risingwave_tpu.common.types import schema as jschema
from risingwave_tpu.expr import agg as jagg
from risingwave_tpu.expr import hll as jhll
from risingwave_tpu.stream import message as jmsg
from risingwave_tpu.stream.hash_agg import HashAggExecutor as JaxAgg
from risingwave_tpu.stream.simple_agg import SimpleAggExecutor as JaxSimple


@pytest.fixture(autouse=True, scope="module")
def _port():
    global torch, H, pagg, DataType, schema, EpochPair, pmsg, PortAgg
    global PortSimple, chunk_from_numpy, interop
    import torch
    from risingwave_tpu_torch import interop
    from risingwave_tpu_torch.common import DataType, schema
    from risingwave_tpu_torch.common.epoch import EpochPair
    from risingwave_tpu_torch.expr import agg as pagg
    from risingwave_tpu_torch.expr import hll as H
    from risingwave_tpu_torch.interop import chunk_from_numpy
    from risingwave_tpu_torch.stream import message as pmsg
    from risingwave_tpu_torch.stream.hash_agg import HashAggExecutor as PortAgg
    from risingwave_tpu_torch.stream.simple_agg import (
        SimpleAggExecutor as PortSimple)


def _values(rng, kind: str, n: int) -> np.ndarray:
    if kind == "float64":
        v = rng.normal(0, 1e6, n)
        v[:6] = [np.nan, 0.0, -0.0, np.inf, -np.inf, 5e-324]
        return v
    if kind == "bool":
        return rng.random(n) < 0.5
    if kind == "int32":
        return rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
    v = rng.integers(-2 ** 62, 2 ** 62, n)
    v[:3] = [np.iinfo(np.int64).min, 0, -1]
    return v


@pytest.mark.parametrize("kind", ["int64", "int32", "bool", "float64"])
def test_lane_partial_and_combine_match_jax(kind):
    rng = np.random.default_rng(3)
    n, G = 4096, 37
    vals = _values(rng, kind, n)
    signs = rng.choice([-1, 0, 1, 1, 1], n).astype(np.int32)
    seg = rng.integers(0, G, n)
    pb, pr = H.bucket_rank(torch.from_numpy(vals))
    jb, jr = jhll._bucket_rank_jnp(jnp.asarray(vals))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    nb, nr = H.bucket_rank_numpy(vals)
    np.testing.assert_array_equal(pr.numpy(), nr)
    state = rng.integers(0, 2 ** 62, G)
    for lane in range(8):
        p = H.lane_partial(torch.from_numpy(vals), torch.from_numpy(signs),
                           torch.from_numpy(seg), G, lane)
        j = jhll.lane_partial(jnp.asarray(vals), jnp.asarray(signs),
                              jnp.asarray(seg), G, lane)
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
        pc = H.lane_combine(torch.from_numpy(state), p)
        jc = jhll.lane_combine(jnp.asarray(state), j)
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("form", ["slots", "vis"])
def test_hll_update_plain_matches_jax_specs(form):
    """K30's plain version over all 8 lanes against the JAX package's
    AggSpec partial + combine of 8 HLL_REG calls, as its hash agg
    (`slots`, -1 for an invisible row) and its simple agg (`vis`, one
    group) run them."""
    rng = np.random.default_rng(7)
    n, C = 2048, (61 if form == "slots" else 1)
    vals = rng.integers(0, 5000, n)
    valid = rng.random(n) < 0.9
    ops = rng.choice([0, 0, 0, 1, 2, 3], n).astype(np.int8)
    vis = rng.random(n) < 0.9
    slots = np.where(vis, rng.integers(0, C, n), -1).astype(np.int32)
    init = rng.integers(0, 2 ** 40, (8, C))
    lanes = [torch.from_numpy(init[L].copy()) for L in range(8)]
    kw = (dict(slots=torch.from_numpy(slots)) if form == "slots"
          else dict(vis=torch.from_numpy(vis)))
    if form == "vis":
        lanes = [x.view(()) for x in lanes]
    H.hll_update_plain(lanes, torch.from_numpy(vals),
                       torch.from_numpy(valid), torch.from_numpy(ops), **kw)
    ok = slots >= 0 if form == "slots" else vis
    sign = np.where(ok, np.where((ops == 0) | (ops == 3), 1, -1), 0)
    sign = np.where(valid, sign, 0).astype(np.int32)
    seg = np.where(ok, slots, C) if form == "slots" else np.zeros(n, int)
    for L in range(8):
        spec = jagg.AggCall(jagg.AggKind.HLL_REG, 0, JDT.INT64, True,
                            lane=L).spec()
        part = spec.partial(jnp.asarray(vals), jnp.asarray(sign),
                            jnp.asarray(seg), C + 1)[:C]
        want = np.asarray(spec.combine(jnp.asarray(init[L]), part))
        np.testing.assert_array_equal(lanes[L].reshape(-1).numpy(), want)
    assert any(int(x.sum()) for x in lanes)


@pytest.mark.parametrize("distinct", [1, 40, 300, 5000, 200000])
def test_estimate_matches_jax_and_numpy(distinct):
    """Sketches of 1 .. 200000 distinct values in 16 groups: the
    estimate (linear counting and raw ranges) equals JAX's and the batch
    estimator's bit for bit."""
    rng = np.random.default_rng(distinct)
    n, G = 4 * distinct, 16
    vals = rng.integers(0, distinct, n) * 7919
    seg = rng.integers(0, G, n)
    words = [torch.zeros(G, dtype=torch.int64) for _ in range(8)]
    H.hll_update_plain(words, torch.from_numpy(vals), None,
                       torch.zeros(n, dtype=torch.int8),
                       slots=torch.from_numpy(seg.astype(np.int32)))
    got = H.estimate_from_words(words).numpy()
    want = np.asarray(jhll.estimate_from_words_jnp(
        [jnp.asarray(w.numpy()) for w in words]))
    batch, ok = jhll.hll_estimate_numpy(vals, np.ones(n, bool), seg, G)
    mine, _ = H.hll_estimate_numpy(vals, np.ones(n, bool), seg, G)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, batch)
    np.testing.assert_array_equal(mine, batch)
    truth = np.asarray([len(np.unique(vals[seg == g])) for g in range(G)])
    assert np.all(np.abs(got - truth) <= 0.5 * truth + 2)


def test_registers_round_trip_through_interop():
    rng = np.random.default_rng(1)
    regs = rng.integers(0, 60, (9, 64))
    words = interop.hll_words_from_registers(regs)
    assert len(words) == 8 and words[0].dtype == np.int64
    np.testing.assert_array_equal(interop.hll_registers_from_words(words),
                                  regs)
    np.testing.assert_array_equal(
        H.registers([torch.from_numpy(w) for w in words]).numpy(), regs)


COLS = [("k", "INT64"), ("v", "INT64"), ("f", "FLOAT64")]


def _script(seed, n_epochs=6, cap=128, keys=40):
    """Insert-only chunks with NULL values, invisible rows and barriers:
    [("chunk", arrays, valids, vis) | ("barrier",)]."""
    rng = np.random.default_rng(seed)
    out = [("barrier",)]
    for _ in range(n_epochs):
        for _ in range(3):
            arrays = [rng.integers(0, keys, cap), rng.integers(0, 300, cap),
                      _values(rng, "float64", cap)]
            valids = [None, rng.random(cap) < 0.85, rng.random(cap) < 0.85]
            out.append(("chunk", arrays, valids, rng.random(cap) < 0.9))
        out.append(("barrier",))
    return out


class _Scripted:
    def __init__(self, sch, msgs):
        self.schema = sch
        self.pk_indices = ()
        self._msgs = msgs

    async def execute(self):
        for m in self._msgs:
            yield m
            await asyncio.sleep(0)


def _messages(script, sch, jax: bool):
    out, prev = [], 0
    mod, ep = (jmsg, JEpochPair) if jax else (pmsg, EpochPair)
    for i, item in enumerate(script):
        if item[0] == "chunk":
            _, arrays, valids, vis = item
            ops = np.zeros(len(vis), np.int8)
            if jax:
                out.append(JChunk.from_numpy(
                    sch, arrays, ops=ops, capacity=len(vis),
                    valids=valids).with_vis(np.asarray(vis)))
            else:
                out.append(chunk_from_numpy(sch, arrays, ops, vis, valids,
                                            device="cpu"))
        else:
            curr = (i + 1) << 16
            kind = (mod.BarrierKind.INITIAL if prev == 0
                    else mod.BarrierKind.CHECKPOINT)
            out.append(mod.Barrier(ep(curr, prev), kind))
            prev = curr
    return out


def _calls(mod, dt):
    """count(*), then approx_count_distinct(v) and (f) as the planner
    lowers them: a COUNT and 8 register words each."""
    calls = [mod.count_star(True)]
    for arg in (1, 2):
        calls.append(mod.AggCall(mod.AggKind.COUNT, arg, dt.INT64, True))
        calls += [mod.AggCall(mod.AggKind.HLL_REG, arg, dt.INT64, True,
                              lane=L) for L in range(8)]
    return calls


async def _logs(ex):
    logs, cur = [], Counter()
    async for msg in ex.execute():
        if hasattr(msg, "to_rows"):
            cur.update(msg.to_rows())
        elif hasattr(msg, "epoch"):
            logs.append(cur)
            cur = Counter()
    return logs


@pytest.mark.parametrize("grouped", [True, False])
def test_hll_aggs_lockstep_match_jax(grouped):
    """The hash agg (grouped, 40 groups in 64 slots) and the simple agg with
    two sketches: every barrier's changelog, register words included,
    equals JAX's; the final registers (unpacked by `interop`) and the
    estimates over the final words equal JAX's."""
    script = _script(seed=11 if grouped else 12)
    jsch = jschema(*[(n, getattr(JDT, t)) for n, t in COLS])
    psch = schema(*[(n, getattr(DataType, t)) for n, t in COLS])
    jin = _Scripted(jsch, _messages(script, jsch, True))
    pin = _Scripted(psch, _messages(script, psch, False))
    if grouped:
        j = JaxAgg(jin, [0], _calls(jagg, JDT), capacity=64)
        p = PortAgg(pin, [0], _calls(pagg, DataType), capacity=64,
                    device="cpu")
    else:
        j = JaxSimple(jin, _calls(jagg, JDT))
        p = PortSimple(pin, _calls(pagg, DataType), device="cpu")
    jl, pl = asyncio.run(_logs(j)), asyncio.run(_logs(p))
    assert len(pl) == len(jl) == 7
    for b, (x, y) in enumerate(zip(pl, jl)):
        assert x == y, f"barrier {b}"
    assert sum(len(x) for x in pl) > (40 if grouped else 6)
    if grouped:
        pw = [p.state.agg_states[j_] for j_ in range(2, 10)]
        jw = [np.asarray(j.state.agg_states[j_]) for j_ in range(2, 10)]
        assert p.capacity == j.capacity
    else:
        pw = [p.states[j_].reshape(1) for j_ in range(2, 10)]
        jw = [np.asarray(j.states[j_]).reshape(1) for j_ in range(2, 10)]
    for x, y in zip(pw, jw):
        np.testing.assert_array_equal(x.numpy(), y)
    # the first sketch's registers per group, and JAX's re-packed
    regs = interop.hll_registers_from_words(jw)
    np.testing.assert_array_equal(
        interop.hll_registers_from_words([x.numpy() for x in pw]), regs)
    for x, y in zip(pw, interop.hll_words_from_registers(regs)):
        np.testing.assert_array_equal(x.numpy(), y)
    assert regs.max() > 0
    np.testing.assert_array_equal(
        H.estimate_from_words(pw).numpy(),
        np.asarray(jhll.estimate_from_words_jnp([jnp.asarray(y)
                                                 for y in jw])))
