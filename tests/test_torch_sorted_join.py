"""Differential tests: the port's SortedJoinExecutor (plain PyTorch
versions of kernels K5, K6 and K7 on the CPU) against the JAX package's,
inner joins only.

Lockstep: the same chunks go through both executors' apply (and the
barrier-time evict) with no async interleaving, and after every step
both sides' stores must be equal slot for slot (khash, columns, valids,
degree, n), the errs counters equal, and the match buffers equal (emit
mask, ops, every column). The cases port the inner cases of
tests/test_sorted_join.py: basic, retraction and update pair, NULL keys,
an update pair within one chunk, inline watermark eviction, the
append-only fast path, the three overflow counters and a random stream.

Stream: both executors driven through barrier alignment by the same
scripts; per-barrier changelogs (multisets) must be equal, and their sum
the one tests/test_sorted_join.py expects."""

import asyncio
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest

from risingwave_tpu.common import StreamChunk as JChunk
from risingwave_tpu.common import DataType as JDT
from risingwave_tpu.common.epoch import EpochPair as JEpochPair
from risingwave_tpu.common.types import schema as jschema
from risingwave_tpu.stream.sorted_join import SortedJoinExecutor as JaxJoin

INS, DEL, UD, UI = 0, 1, 2, 3
CAP = 16


@pytest.fixture(autouse=True, scope="module")
def _port():
    """Import torch and the port when these tests run, not at collection:
    an xdist worker then runs the JAX tests before them without torch
    (the sharded-join recovery tests abort more often with it loaded)."""
    global torch, DataType, schema, EpochPair, chunk_from_numpy
    global sorted_side_to_numpy, pmsg, PortJoin
    import torch
    from risingwave_tpu_torch.common import DataType, schema
    from risingwave_tpu_torch.common.epoch import EpochPair
    from risingwave_tpu_torch.interop import (
        chunk_from_numpy, sorted_side_to_numpy)
    from risingwave_tpu_torch.stream import message as pmsg
    from risingwave_tpu_torch.stream.sorted_join import (
        SortedJoinExecutor as PortJoin)


class _Scripted:
    def __init__(self, sch, msgs=()):
        self.schema = sch
        self.pk_indices = ()
        self._msgs = list(msgs)

    async def execute(self):
        for m in self._msgs:
            yield m
            await asyncio.sleep(0)


def _schemas(port: bool):
    dt = DataType if port else JDT
    mk = schema if port else jschema
    return (mk(("k", dt.INT64), ("lv", dt.INT64)),
            mk(("k", dt.INT64), ("rv", dt.INT64)))


def _arrays(rows, cap=CAP, key_valid=None):
    """(arrays, ops, vis, valids) of a chunk holding `rows` = (op, k, v)
    followed by invisible padding."""
    n = len(rows)
    k = np.zeros(cap, np.int64)
    v = np.zeros(cap, np.int64)
    ops = np.zeros(cap, np.int8)
    k[:n] = [r[1] for r in rows]
    v[:n] = [r[2] for r in rows]
    ops[:n] = [r[0] for r in rows]
    vis = np.arange(cap) < n
    kv = None
    if key_valid is not None:
        kv = np.zeros(cap, bool)
        kv[:n] = key_valid
    return [k, v], ops, vis, [kv, None]


def _jchunk(sch, arrays, ops, vis, valids):
    ch = JChunk.from_numpy(sch, arrays, ops=ops, capacity=len(vis),
                           valids=valids)
    return ch.with_vis(np.asarray(vis))


def _pchunk(sch, arrays, ops, vis, valids):
    return chunk_from_numpy(sch, arrays, ops, vis, valids, device="cpu")


# JAX executors by configuration: cases that share one reuse its
# compiled programs (each instance compiles its own), from empty state
_JAX_JOINS: dict = {}


def _joins(**kw):
    lj, rj = _schemas(False)
    lp, rp = _schemas(True)
    common = dict(left_key_indices=[0], right_key_indices=[0],
                  left_pk_indices=[1], right_pk_indices=[1], capacity=64)
    common.update(kw)
    key = repr(sorted(common.items()))
    jj = _JAX_JOINS.get(key)
    if jj is None:
        jj = _JAX_JOINS[key] = JaxJoin(_Scripted(lj), _Scripted(rj),
                                       **common)
    jj.sides = [jj._empty(s) for s in (0, 1)]
    jj._errs_dev = jnp.zeros(3, dtype=jnp.int32)
    return jj, PortJoin(_Scripted(lp), _Scripted(rp), device="cpu",
                        **common)


def _assert_states_equal(jj, pj):
    for s in (0, 1):
        j, p = jj.sides[s], sorted_side_to_numpy(pj.sides[s])
        assert int(np.asarray(j.n)) == p["n"]
        np.testing.assert_array_equal(np.asarray(j.khash), p["khash"])
        np.testing.assert_array_equal(np.asarray(j.degree), p["degree"])
        for a, b in zip(j.cols, p["cols"]):
            np.testing.assert_array_equal(np.asarray(a), b)
        for a, b in zip(j.valids, p["valids"]):
            np.testing.assert_array_equal(np.asarray(a), b)
    np.testing.assert_array_equal(np.asarray(jj._errs_dev),
                                  pj._errs_dev.numpy())


def _run_lockstep(steps, **kw):
    """steps: ("chunk", side, rows[, key_valid], wm) | ("evict", side, wm).
    Returns the port join after checking every step."""
    jj, pj = _joins(**kw)
    schemas = (_schemas(False), _schemas(True))
    for st in steps:
        if st[0] == "evict":
            _, side, wm = st
            jj.sides[side] = jj._evict(jj.sides[side], jnp.int64(wm),
                                       jnp.int64(-1), side=side)
            pj._evict(side, wm)
            _assert_states_equal(jj, pj)
            continue
        _, side, rows, key_valid, wm = st
        arrays, ops, vis, valids = _arrays(rows, key_valid=key_valid)
        jc = _jchunk(schemas[0][side], arrays, ops, vis, valids)
        pc = _pchunk(schemas[1][side], arrays, ops, vis, valids)
        out = jj._apply(jj.sides[side], jj.sides[1 - side], jj._errs_dev,
                        jc, jnp.int64(wm), side=side,
                        match_factor=jj.match_factors[side])
        jj.sides[side], _, jcols, jops, jemit, jj._errs_dev, _ = out
        pcols, pops, pemit = pj._apply(side, pc, wm)
        np.testing.assert_array_equal(np.asarray(jemit), pemit.numpy())
        np.testing.assert_array_equal(np.asarray(jops), pops.numpy())
        for a, b in zip(jcols, pcols):
            np.testing.assert_array_equal(np.asarray(a.data), b.data.numpy())
            np.testing.assert_array_equal(np.asarray(a.valid_mask()),
                                          b.valid_mask().numpy())
        _assert_states_equal(jj, pj)
    return pj


NOWM = -(1 << 62)


def _random_steps(seed, n=30, deletes=True):
    rng = np.random.default_rng(seed)
    live = [dict(), dict()]
    next_pk = [0, 1_000_000]
    steps = []
    for _ in range(n):
        side = int(rng.integers(0, 2))
        rows = []
        for _ in range(int(rng.integers(1, 9))):
            if deletes and live[side] and rng.random() < 0.4:
                pk = int(rng.choice(list(live[side].keys())))
                k = live[side].pop(pk)
                if rng.random() < 0.5:      # an update pair on one pk
                    k2 = int(rng.integers(0, 6))
                    rows += [(UD, k, pk), (UI, k2, pk)]
                    live[side][pk] = k2
                else:
                    rows.append((DEL, k, pk))
            else:
                k = int(rng.integers(0, 6))
                pk = next_pk[side]
                next_pk[side] += 1
                live[side][pk] = k
                rows.append((INS, k, pk))
        steps.append(("chunk", side, rows[:CAP], None, NOWM))
    return steps


LOCKSTEP_CASES = {
    "basic": ([("chunk", 0, [(INS, 1, 10), (INS, 2, 20)], None, NOWM),
               ("chunk", 1, [(INS, 1, 100), (INS, 3, 300)], None, NOWM)],
              {}),
    "retraction_and_update_pair": (
        [("chunk", 1, [(INS, 1, 100)], None, NOWM),
         ("chunk", 0, [(INS, 1, 10)], None, NOWM),
         ("chunk", 0, [(UD, 1, 10), (UI, 1, 11)], None, NOWM),
         ("chunk", 0, [(DEL, 1, 11)], None, NOWM)], {}),
    "null_keys": ([("chunk", 0, [(INS, 1, 10), (INS, 1, 11)],
                    [True, False], NOWM),
                   ("chunk", 1, [(INS, 1, 100)], None, NOWM)], {}),
    "update_pair_within_chunk": (
        [("chunk", 0, [(INS, 7, 1)], None, NOWM),
         ("chunk", 1, [(INS, 7, 50)], None, NOWM),
         ("chunk", 1, [(UD, 7, 50), (UI, 7, 51)], None, NOWM),
         # insert+delete+insert of one pk in one chunk nets to one insert
         ("chunk", 1, [(INS, 8, 60), (DEL, 8, 60), (INS, 9, 60)], None,
          NOWM)], {}),
    "watermark_eviction_inline": (
        [("chunk", 0, [(INS, 1, 10), (INS, 3, 1500)], None, NOWM),
         ("chunk", 0, [(INS, 2, 2000)], None, 1000),
         ("chunk", 1, [(INS, 1, 100), (INS, 2, 200)], None, NOWM),
         ("evict", 0, 1600), ("evict", 1, 150)],
        {"clean_watermark_cols": (1, 1)}),
    "append_only": (
        [("chunk", 0, [(INS, 1, 10), (INS, 1, 11), (INS, 2, 20)], None,
          NOWM),
         ("chunk", 1, [(INS, 1, 100)], None, NOWM),
         ("chunk", 1, [(INS, 2, 200)], None, NOWM)],
        {"append_only": (True, True)}),
    "overflow_counters": (
        # 20 rows into 16 slots; 3 x 8 matches into a 16-slot buffer; a
        # delete of a row never stored
        [("chunk", 1, [(INS, 1, 100 + i) for i in range(3)], None, NOWM),
         ("chunk", 0, [(INS, 1, i) for i in range(8)], None, NOWM),
         ("chunk", 0, [(INS, 5, 50 + i) for i in range(12)], None, NOWM),
         ("chunk", 1, [(DEL, 4, 999)], None, NOWM)],
        {"capacity": 16, "match_factor": 1}),
    "random": (_random_steps(11) + [("evict", 0, NOWM)], {}),
    "random_append_only_left": (_random_steps(5, deletes=False),
                                {"append_only": (True, False)}),
}


@pytest.mark.parametrize("case", sorted(LOCKSTEP_CASES))
def test_apply_and_evict_lockstep(case):
    steps, kw = LOCKSTEP_CASES[case]
    pj = _run_lockstep(steps, **kw)
    if case == "overflow_counters":
        assert pj.errs() == [8, 1, 4]


# ------------------------------------------------------------ the stream

def _stream(l_script, r_script, port=True, **kw):
    """Drive the port's executor (or the JAX package's); scripts hold
    ("c", rows[, key_valid]), ("wm", col, val) and ("b", curr). Returns
    the join and its changelog per barrier, as multisets of (sign, row)."""
    if port:
        schemas, mod, dt, pair = (_schemas(True), pmsg, DataType.INT64,
                                  EpochPair)
    else:
        from risingwave_tpu.stream import message as mod
        schemas, dt, pair = _schemas(False), JDT.INT64, JEpochPair

    def msgs(script, sch):
        out, prev = [], 0
        for item in script:
            if item[0] == "c":
                kv = item[2] if len(item) > 2 else None
                mk = _pchunk if port else _jchunk
                out.append(mk(sch, *_arrays(item[1], key_valid=kv)))
            elif item[0] == "wm":
                out.append(mod.Watermark(item[1], dt, item[2]))
            else:
                kind = (mod.BarrierKind.INITIAL if prev == 0
                        else mod.BarrierKind.CHECKPOINT)
                out.append(mod.Barrier(pair(item[1], prev), kind))
                prev = item[1]
        return out

    lsch, rsch = schemas
    cls, extra = (PortJoin, {"device": "cpu"}) if port else (JaxJoin, {})
    join = cls(_Scripted(lsch, msgs(l_script, lsch)),
               _Scripted(rsch, msgs(r_script, rsch)),
               left_key_indices=[0], right_key_indices=[0],
               left_pk_indices=[1], right_pk_indices=[1],
               **{"capacity": 64, **kw, **extra})

    async def go():
        logs, c = [], Counter()
        async for m in join.execute():
            if hasattr(m, "to_rows"):
                for op, vals in m.to_rows():
                    c[(1 if op in (INS, UI) else -1, vals)] += 1
            elif hasattr(m, "epoch"):
                logs.append(c)
                c = Counter()
        return logs
    return join, asyncio.run(go())


STREAM_CASES = {
    "basic": ([("b", 1), ("c", [(INS, 1, 10), (INS, 2, 20)]), ("b", 2)],
              [("b", 1), ("c", [(INS, 1, 100), (INS, 3, 300)]), ("b", 2)],
              {}, {(1, (1, 10, 1, 100)): 1}),
    "retraction_and_update_pair": (
        [("b", 1), ("c", [(INS, 1, 10)]), ("b", 2),
         ("c", [(UD, 1, 10), (UI, 1, 11)]), ("c", [(DEL, 1, 11)]), ("b", 3)],
        [("b", 1), ("c", [(INS, 1, 100)]), ("b", 2), ("b", 3)], {},
        {(1, (1, 10, 1, 100)): 1, (-1, (1, 10, 1, 100)): 1,
         (1, (1, 11, 1, 100)): 1, (-1, (1, 11, 1, 100)): 1}),
    "null_keys": ([("b", 1), ("c", [(INS, 1, 10), (INS, 1, 11)],
                                [True, False]), ("b", 2)],
                  [("b", 1), ("c", [(INS, 1, 100)]), ("b", 2)], {},
                  {(1, (1, 10, 1, 100)): 1}),
    "update_pair_within_chunk": (
        [("b", 1), ("c", [(INS, 7, 1)]), ("b", 2), ("b", 3)],
        [("b", 1), ("c", [(INS, 7, 50)]), ("b", 2),
         ("c", [(UD, 7, 50), (UI, 7, 51)]), ("b", 3)], {},
        {(1, (7, 1, 7, 50)): 1, (-1, (7, 1, 7, 50)): 1,
         (1, (7, 1, 7, 51)): 1}),
    "watermark_eviction_inline": (
        [("b", 1), ("c", [(INS, 1, 10)]), ("wm", 1, 1000),
         ("c", [(INS, 2, 2000)]), ("b", 2), ("b", 3)],
        [("b", 1), ("b", 2), ("c", [(INS, 1, 100), (INS, 2, 200)]),
         ("b", 3)],
        {"clean_watermark_cols": (1, None)},
        {(1, (2, 2000, 2, 200)): 1}),
    "append_only": (
        [("b", 1), ("c", [(INS, 1, 10), (INS, 1, 11), (INS, 2, 20)]),
         ("b", 2)],
        [("b", 1), ("c", [(INS, 1, 100)]), ("c", [(INS, 2, 200)]),
         ("b", 2)],
        {"append_only": (True, True)},
        {(1, (1, 10, 1, 100)): 1, (1, (1, 11, 1, 100)): 1,
         (1, (2, 20, 2, 200)): 1}),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_stream_changelog(case):
    """Per-barrier changelogs equal the JAX executor's; their sum is the
    one tests/test_sorted_join.py expects."""
    l_script, r_script, kw, want = STREAM_CASES[case]
    join, logs = _stream(l_script, r_script, **kw)
    _, jax_logs = _stream(l_script, r_script, port=False, **kw)
    assert logs == jax_logs
    assert sum(logs, Counter()) == Counter(want)
    assert join.errs() == [0, 0, 0]
    if case == "watermark_eviction_inline":
        assert int(join.sides[0].n) == 1


def test_overflow_fail_stops():
    with pytest.raises(RuntimeError, match="state overflow"):
        _stream([("b", 1), ("c", [(INS, i, i) for i in range(16)]),
                 ("c", [(INS, 100 + i, i) for i in range(4)]), ("b", 2)],
                [("b", 1), ("b", 2)], capacity=16)


def test_sorted_side_round_trip():
    """A JAX side store carried into the port through numpy continues
    there: the same arrays, and a probe against it matches JAX's."""
    from risingwave_tpu_torch.interop import sorted_side_from_numpy
    jj, pj = _joins()
    _run_steps = _random_steps(3, n=12)
    schemas = (_schemas(False), _schemas(True))
    for _, side, rows, kv, wm in _run_steps:
        arrays, ops, vis, valids = _arrays(rows, key_valid=kv)
        out = jj._apply(jj.sides[side], jj.sides[1 - side], jj._errs_dev,
                        _jchunk(schemas[0][side], arrays, ops, vis, valids),
                        jnp.int64(wm), side=side,
                        match_factor=jj.match_factors[side])
        jj.sides[side], jj._errs_dev = out[0], out[5]
    for s in (0, 1):
        j = jj.sides[s]
        pj.sides[s] = sorted_side_from_numpy(
            np.asarray(j.khash), [np.asarray(c) for c in j.cols],
            [np.asarray(v) for v in j.valids], np.asarray(j.degree),
            int(np.asarray(j.n)), device="cpu")
    pj._errs_dev = torch.from_numpy(np.array(jj._errs_dev))
    _assert_states_equal(jj, pj)
    # both continue identically
    rows = [(INS, k, 5000 + k) for k in range(6)]
    arrays, ops, vis, valids = _arrays(rows)
    out = jj._apply(jj.sides[0], jj.sides[1], jj._errs_dev,
                    _jchunk(schemas[0][0], arrays, ops, vis, valids),
                    jnp.int64(NOWM), side=0,
                    match_factor=jj.match_factors[0])
    jj.sides[0], jj._errs_dev = out[0], out[5]
    _, _, pemit = pj._apply(0, _pchunk(schemas[1][0], arrays, ops, vis,
                                       valids), NOWM)
    np.testing.assert_array_equal(np.asarray(out[4]), pemit.numpy())
    _assert_states_equal(jj, pj)
