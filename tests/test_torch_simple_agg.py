"""The port's global aggregate (the plain version of kernel K25 on the
CPU) against the JAX package's SimpleAggExecutor.

Inputs come from a numpy seed: Inserts, Deletes and U-/U+ pairs with
NULL arguments and invisible rows, over (v int64, w int32, f float64)
rows; every call kind of the slice: count(*), count(x), SUM to int64
and to float64 (AVG's half), append-only MIN / MAX of int and float
arguments, and COUNT over partial counts (`combine_partials`).

Lockstep: the same chunks through both executors' apply and, after
every chunk, their barrier flush: the states and the row count are
equal (exactly for integer states and integer-valued floats, within a
relative 1e-12 for other float sums), and so is the flush: nothing on
NoChange, an Insert first, then U-/U+ pairs. A port executor started
from a JAX executor's state (`interop`) goes on alike. Through the
barrier loops the per-barrier changelogs are equal.

Durable: `SELECT count(*), sum(price), max(price) FROM bid` through both
sessions on Hummock stores, epochs from a counter: every state table's
bytes equal after every barrier; a store the JAX session wrote and
abandoned recovers in the port to JAX's MV."""

import asyncio
import shutil
from collections import Counter

import numpy as np
import pytest

import risingwave_tpu.meta.barrier_manager as jax_bm
from risingwave_tpu.common import DataType as JDT
from risingwave_tpu.common import StreamChunk as JChunk
from risingwave_tpu.common.epoch import EpochPair as JEpochPair
from risingwave_tpu.common.types import schema as jschema
from risingwave_tpu.expr.agg import AggCall as JCall, AggKind as JKind
from risingwave_tpu.frontend import Session as JaxSession
from risingwave_tpu.state import HummockStateStore as JaxH
from risingwave_tpu.state import LocalFsObjectStore as JaxLocalFs
from risingwave_tpu.stream import message as jmsg
from risingwave_tpu.stream.simple_agg import SimpleAggExecutor as JaxSA
from risingwave_tpu.stream.source import SourceExecutor as JaxSource

INS, DEL, UD, UI = 0, 1, 2, 3
CHUNK = 64


@pytest.fixture(autouse=True, scope="module")
def _port():
    """Import torch and the port when these tests run, not at
    collection."""
    global torch, DataType, schema, EpochPair, chunk_from_numpy, pmsg
    global PortSA, PCall, PKind, interop, sa, port_bm, PortSession, H
    global LocalFs, PortSource
    import torch
    import risingwave_tpu_torch.meta.barrier_manager as port_bm
    from risingwave_tpu_torch import interop
    from risingwave_tpu_torch.common import DataType, schema
    from risingwave_tpu_torch.common.epoch import EpochPair
    from risingwave_tpu_torch.expr.agg import AggCall as PCall
    from risingwave_tpu_torch.expr.agg import AggKind as PKind
    from risingwave_tpu_torch.frontend import Session as PortSession
    from risingwave_tpu_torch.interop import chunk_from_numpy
    from risingwave_tpu_torch.state import HummockStateStore as H
    from risingwave_tpu_torch.state import LocalFsObjectStore as LocalFs
    from risingwave_tpu_torch.stream import message as pmsg
    from risingwave_tpu_torch.stream import simple_agg as sa
    from risingwave_tpu_torch.stream.simple_agg import (
        SimpleAggExecutor as PortSA)
    from risingwave_tpu_torch.stream.source import (
        SourceExecutor as PortSource)


class _Scripted:
    def __init__(self, sch, msgs=()):
        self.schema = sch
        self.pk_indices = ()
        self._msgs = list(msgs)

    async def execute(self):
        for m in self._msgs:
            yield m
            await asyncio.sleep(0)


def _schema(port: bool):
    dt = DataType if port else JDT
    mk = schema if port else jschema
    return mk(("v", dt.INT64), ("w", dt.INT32), ("f", dt.FLOAT64))


def _chunks(seed: int, n: int, append_only: bool = False,
            integral: bool = True):
    """(arrays, ops, vis, valids) chunks; `integral` floats are whole
    numbers (sums exact in any order)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        v = rng.integers(-10 ** 6, 10 ** 6, CHUNK)
        w = rng.integers(-5, 5, CHUNK).astype(np.int32)
        f = (rng.integers(-1000, 1000, CHUNK).astype(np.float64)
             if integral else rng.normal(size=CHUNK) * 100)
        ops = (np.zeros(CHUNK, np.int8) if append_only
               else rng.choice([INS, DEL, UD, UI], CHUNK).astype(np.int8))
        vis = rng.random(CHUNK) < 0.9
        out.append(([v, w, f], ops, vis,
                    [None, rng.random(CHUNK) < 0.85,
                     rng.random(CHUNK) < 0.9]))
    return out


def _jchunk(c):
    arrays, ops, vis, valids = c
    ch = JChunk.from_numpy(_schema(False), arrays, ops=ops,
                           capacity=CHUNK, valids=valids)
    return ch.with_vis(np.asarray(vis))


def _pchunk(c):
    arrays, ops, vis, valids = c
    return chunk_from_numpy(_schema(True), arrays, ops, vis, valids,
                            device="cpu")


# (kind, arg, ret type, append_only)
CASES = {
    "retracting": ([("count", None, "INT64"), ("count", 1, "INT64"),
                    ("sum", 0, "INT64"), ("sum", 0, "FLOAT64"),
                    ("sum", 1, "INT64"), ("sum", 2, "FLOAT64")], False),
    "append_only_extrema": ([("max", 0, "INT64"), ("min", 1, "INT32"),
                             ("max", 2, "FLOAT64"), ("min", 2, "FLOAT64"),
                             ("count", 2, "INT64")], True),
    "float_sums": ([("sum", 2, "FLOAT64"), ("count", None, "INT64")],
                   False),
    "combine_partials": ([("count", 0, "INT64"), ("sum", 2, "FLOAT64")],
                         False),
}


def _calls(case, port: bool):
    spec, ao = CASES[case]
    call, kind, dt = ((PCall, PKind, DataType) if port
                      else (JCall, JKind, JDT))
    return [call(getattr(kind, k.upper()), a, getattr(dt, t), ao)
            for k, a, t in spec]


def _exec(case, port: bool, msgs=(), state_table=None):
    kw = dict(combine_partials=case == "combine_partials")
    if port:
        return PortSA(_Scripted(_schema(True), msgs), _calls(case, True),
                      device="cpu", **kw)
    return JaxSA(_Scripted(_schema(False), msgs), _calls(case, False), **kw)


def _states_equal(px, jx, rel: float = 0.0):
    got = interop.simple_agg_state_to_numpy(px)
    assert got["row_count"] == int(np.asarray(jx.row_count))
    for a, b in zip(got["states"], jx.states):
        b = np.asarray(b)
        if a.dtype == np.float64 and rel:
            np.testing.assert_allclose(a, b, rtol=rel)
        else:
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _rows(chunk):
    if chunk is None:
        return None
    return [(op, tuple(round(x, 6) if isinstance(x, float) else x
                       for x in vals)) for op, vals in chunk.to_rows()]


@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_and_flush_lockstep_match_jax(case):
    jx, px = _exec(case, False), _exec(case, True)
    spec, ao = CASES[case]
    integral = case != "float_sums"
    chunks = _chunks(sorted(CASES).index(case), 5, ao, integral)
    kinds = []
    for i, c in enumerate(chunks):
        jx.on_chunk(_jchunk(c))
        px.on_chunk(_pchunk(c))
        _states_equal(px, jx, 0.0 if integral else 1e-12)
        jout, pout = jx.flush(), px.flush()
        assert _rows(pout) == _rows(jout), f"chunk {i}"
        kinds.append(None if pout is None else pout.to_rows()[0][0])
        # a second flush with no chunk between: NoChange in both
        assert jx.flush() is None and px.flush() is None
    assert kinds[0] == INS and UD in kinds


def test_invisible_and_null_rows_change_nothing():
    """A chunk of invisible rows, or of NULL arguments only, is NoChange
    for the counts of the argument and the sums (count(*) still moves
    on visible rows)."""
    jx, px = _exec("retracting", False), _exec("retracting", True)
    c = _chunks(3, 1)[0]
    for ex, mk in ((jx, _jchunk), (px, _pchunk)):
        ex.on_chunk(mk(c))
        ex.flush()
    arrays, ops, vis, valids = _chunks(4, 1)[0]
    hidden = (arrays, ops, np.zeros(CHUNK, bool), valids)
    for ex, mk in ((jx, _jchunk), (px, _pchunk)):
        ex.on_chunk(mk(hidden))
        assert ex.flush() is None
    _states_equal(px, jx)


def test_state_carried_from_jax_continues_alike():
    jx = _exec("retracting", False)
    chunks = _chunks(8, 5)
    for c in chunks[:2]:
        jx.on_chunk(_jchunk(c))
        jx.flush()
    px = _exec("retracting", True)
    interop.simple_agg_state_from_numpy(
        px, [np.asarray(s) for s in jx.states], int(np.asarray(jx.row_count)),
        jx._prev_emit, jx._emitted)
    for i, c in enumerate(chunks[2:]):
        jx.on_chunk(_jchunk(c))
        px.on_chunk(_pchunk(c))
        assert _rows(px.flush()) == _rows(jx.flush()), f"chunk {i}"
        _states_equal(px, jx)


def _script(chunks, port: bool, per_barrier: int = 2):
    msg = pmsg if port else jmsg
    ep = EpochPair if port else JEpochPair
    mk = _pchunk if port else _jchunk
    msgs = [msg.Barrier(ep(1 << 16, 0), msg.BarrierKind.INITIAL)]
    e = 1 << 16
    for i, c in enumerate(chunks):
        msgs.append(mk(c))
        if i % per_barrier == per_barrier - 1:
            msgs.append(msg.Barrier(ep(e + (1 << 16), e),
                                    msg.BarrierKind.CHECKPOINT))
            e += 1 << 16
    return msgs


def test_barrier_loop_matches_jax():
    """Through the barrier loops, with a barrier after a chunk of
    invisible rows (NoChange): per-barrier changelogs equal."""
    chunks = _chunks(21, 6)
    arrays, ops, vis, valids = chunks[3]
    chunks[3] = (arrays, ops, np.zeros(CHUNK, bool), valids)
    jx = _exec("retracting", False, _script(chunks, False, 1))
    px = _exec("retracting", True, _script(chunks, True, 1))

    async def drain(ex):
        return [m async for m in ex.execute()]

    def logs(msgs, chunk_cls):
        out, cur = [], Counter()
        for m in msgs:
            if isinstance(m, chunk_cls):
                cur += Counter(_rows(m))
            elif type(m).__name__ == "Barrier":
                out.append(cur)
                cur = Counter()
        return out

    jlog = logs(asyncio.run(drain(jx)), JChunk)
    plog = logs(asyncio.run(drain(px)), type(_pchunk(chunks[0])))
    assert plog == jlog and len(plog) == 7
    assert plog[4] == Counter()                # NoChange barrier


def test_apply_plain_matches_the_executor():
    """`simple_agg_apply_plain` (what chip_smoke.py holds K25 against) is
    the executor's CPU path."""
    px = _exec("retracting", True)
    st, rc = px.states, px.row_count
    for c in _chunks(5, 3):
        ch = _pchunk(c)
        st, rc = sa.simple_agg_apply_plain(px.specs, st, rc, ch)
        px.on_chunk(ch)
    for a, b in zip(st, px.states):
        assert torch.equal(a, b)
    assert int(rc) == int(px.row_count)


# --------------------------------------------------------------- durable

PER, ROUNDS, CRASH_AT = 256, 5, 3
DDL = ["SET streaming_watchdog = 0",
       ("CREATE SOURCE bid WITH (connector='nexmark', table='bid', "
        f"chunk_size=128, rate_limit={PER})"),
       ("CREATE MATERIALIZED VIEW g AS SELECT count(*), sum(price), "
        "max(price) FROM bid")]


@pytest.fixture(scope="module")
def det_epochs():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_bm, port_bm):
            mp.setattr(mod, "next_epoch", lambda prev: prev + (1 << 16))
        yield


def _source(s, cls):
    dep = s.catalog.mvs["g"].deployment
    for roots in dep.roots.values():
        for r in roots:
            if isinstance(r, cls):
                return dep, r


async def _paced(s, source_cls, start, stop):
    dep, src = _source(s, source_cls)
    snaps = []
    for r in range(start, stop):
        while src.connector.offset < r * PER:
            for t in dep.tasks:
                if t.done():
                    t.result()
            await asyncio.sleep(0)
        b = await s.coord.inject_barrier()
        await s.coord.wait_collected(b)
        await s.coord.drain_uploads()
        snaps.append(list(s.store.iter_range(b"", b"")))
    return snaps


def _mv(s):
    return sorted(r for _, r in s.catalog.mvs["g"].table.iter_all())


@pytest.fixture(scope="module")
def jax_durable(det_epochs, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jg_full"))
    part_dir = str(tmp_path_factory.mktemp("jg_part") / "store")

    async def go():
        s = JaxSession(store=JaxH(JaxLocalFs(path)))
        for st in DDL:
            await s.execute(st)
        snaps = await _paced(s, JaxSource, 1, CRASH_AT + 1)
        shutil.copytree(path, part_dir)
        snaps += await _paced(s, JaxSource, CRASH_AT + 1, ROUNDS + 1)
        return snaps, _mv(s)

    return dict(full=asyncio.run(go()), part_dir=part_dir)


def test_durable_state_equals_jax_after_every_barrier(jax_durable,
                                                      tmp_path):
    snaps, mv = jax_durable["full"]

    async def go():
        s = PortSession(device="cpu", store=H(LocalFs(str(tmp_path))))
        for st in DDL:
            await s.execute(st)
        got = await _paced(s, PortSource, 1, ROUNDS + 1)
        return got, _mv(s)

    got, pmv = asyncio.run(go())
    assert len(got) == len(snaps) == ROUNDS
    for r, (a, b) in enumerate(zip(got, snaps)):
        # the source offsets, the agg's state row, the MV
        assert len({int.from_bytes(k[:4], "big") for k, _ in b}) == 3
        assert a == b, f"state differs after barrier {r + 1}"
    assert pmv == mv and mv[0][0] == ROUNDS * PER


def test_store_written_by_jax_recovers_in_port(jax_durable, tmp_path):
    """JAX ran CRASH_AT barriers and was abandoned; the port recovers the
    agg's states and last emission from its store and runs on: the MV
    equals JAX's uninterrupted run (no second Insert of the group)."""
    _, mv = jax_durable["full"]

    async def resume(path):
        s = PortSession(device="cpu", store=H.open(LocalFs(path)))
        await s.recover()
        await _paced(s, PortSource, CRASH_AT + 1, ROUNDS + 1)
        return _mv(s)

    assert asyncio.run(resume(jax_durable["part_dir"])) == mv
