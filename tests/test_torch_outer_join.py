"""Differential tests of the port's outer and temporal joins: the sorted
join's outer half (the plain version of kernel K28, with K6's slots and
K7's degrees) against the JAX package's `_apply_impl`.

Lockstep: the same chunks go through both executors' apply with no
async interleaving, for LEFT, RIGHT and FULL joins and chunks of both
sides, with a non-equi condition, NULL keys, retractions and update
pairs, a degree that goes 1 -> 0 -> 1 inside one chunk, and a match
buffer that overflows. After every chunk both sides'
stores are equal slot for slot (khash, columns, valids, degree, n, read
through `interop`), the errs counters equal, and the whole [M | M | N]
output equal (emit mask, ops, every column and valid mask).

Stream: a temporal join's right side updates emit nothing, the analogue
of tests/test_missing_executors.py::
test_temporal_join_right_updates_emit_nothing, and a FULL join's
per-barrier changelogs equal JAX's as multisets."""

import asyncio
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest

from risingwave_tpu.common import StreamChunk as JChunk
from risingwave_tpu.common import DataType as JDT
from risingwave_tpu.common.epoch import EpochPair as JEpochPair
from risingwave_tpu.common.types import schema as jschema
from risingwave_tpu.expr import call as jcall, col as jcol
from risingwave_tpu.stream.sorted_join import SortedJoinExecutor as JaxJoin

INS, DEL, UD, UI = 0, 1, 2, 3
CAP = 16
NOWM = -(1 << 62)


@pytest.fixture(autouse=True, scope="module")
def _port():
    """Import torch and the port when these tests run, not at collection:
    an xdist worker then runs the JAX tests before them without torch."""
    global torch, Scripted, DataType, schema, EpochPair, chunk_from_numpy
    global sorted_side_to_numpy, pmsg, PortJoin, pcall, pcol
    import torch
    from chip_smoke import Scripted
    from risingwave_tpu_torch.common import DataType, schema
    from risingwave_tpu_torch.common.epoch import EpochPair
    from risingwave_tpu_torch.expr import call as pcall, col as pcol
    from risingwave_tpu_torch.interop import (
        chunk_from_numpy, sorted_side_to_numpy)
    from risingwave_tpu_torch.stream import message as pmsg
    from risingwave_tpu_torch.stream.sorted_join import (
        SortedJoinExecutor as PortJoin)


def _schemas(port: bool):
    dt = DataType if port else JDT
    mk = schema if port else jschema
    return (mk(("k", dt.INT64), ("lv", dt.INT64)),
            mk(("k", dt.INT64), ("rv", dt.INT64)))


def _cond(port: bool):
    """lv < rv over the joined row (k, lv, k, rv)."""
    c, cl = (pcall, pcol) if port else (jcall, jcol)
    dt = DataType.INT64 if port else JDT.INT64
    return c("less_than", cl(1, dt), cl(3, dt))


def _arrays(rows, cap=CAP, key_valid=None):
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
        kv = np.ones(cap, bool)
        kv[:n] = key_valid
    return [k, v], ops, vis, [kv, None]


def _jchunk(sch, arrays, ops, vis, valids):
    ch = JChunk.from_numpy(sch, arrays, ops=ops, capacity=len(vis),
                           valids=valids)
    return ch.with_vis(np.asarray(vis))


def _pchunk(sch, arrays, ops, vis, valids):
    return chunk_from_numpy(sch, arrays, ops, vis, valids, device="cpu")


# JAX executors by configuration: cases that share one reuse its
# compiled programs, from empty state
_JAX_JOINS: dict = {}


def _joins(cond: bool, **kw):
    lj, rj = _schemas(False)
    lp, rp = _schemas(True)
    common = dict(left_key_indices=[0], right_key_indices=[0],
                  left_pk_indices=[1], right_pk_indices=[1], capacity=64)
    common.update(kw)
    key = (cond, repr(sorted(common.items())))
    jj = _JAX_JOINS.get(key)
    if jj is None:
        jj = _JAX_JOINS[key] = JaxJoin(
            Scripted(lj), Scripted(rj),
            condition=_cond(False) if cond else None, **common)
    jj.sides = [jj._empty(s) for s in (0, 1)]
    jj._errs_dev = jnp.zeros(3, dtype=jnp.int32)
    return jj, PortJoin(Scripted(lp), Scripted(rp), device="cpu",
                        condition=_cond(True) if cond else None, **common)


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


def _run_lockstep(steps, cond=True, **kw):
    """steps: (side, rows[, key_valid]). Returns the port join after
    checking every step."""
    jj, pj = _joins(cond, **kw)
    schemas = (_schemas(False), _schemas(True))
    for st in steps:
        side, rows = st[0], st[1]
        key_valid = st[2] if len(st) > 2 else None
        arrays, ops, vis, valids = _arrays(rows, key_valid=key_valid)
        jc = _jchunk(schemas[0][side], arrays, ops, vis, valids)
        pc = _pchunk(schemas[1][side], arrays, ops, vis, valids)
        out = jj._apply(jj.sides[side], jj.sides[1 - side], jj._errs_dev,
                        jc, jnp.int64(NOWM), side=side,
                        match_factor=jj.match_factors[side])
        jj.sides[side], odeg, jcols, jops, jemit, jj._errs_dev, _ = out
        o = jj.sides[1 - side]
        jj.sides[1 - side] = type(o)(o.khash, o.cols, o.valids, odeg, o.n)
        pcols, pops, pemit = pj._apply(side, pc, NOWM)
        np.testing.assert_array_equal(np.asarray(jemit), pemit.numpy())
        np.testing.assert_array_equal(np.asarray(jops), pops.numpy())
        assert len(jcols) == len(pcols)
        for a, b in zip(jcols, pcols):
            np.testing.assert_array_equal(np.asarray(a.data), b.data.numpy())
            np.testing.assert_array_equal(np.asarray(a.valid_mask()),
                                          b.valid_mask().numpy())
        _assert_states_equal(jj, pj)
    return pj


def _random_steps(seed, n=24):
    """Chunks of both sides over 4 keys with NULL keys, deletes and
    update pairs (that move a row between keys, so degrees rise and
    fall inside a chunk)."""
    rng = np.random.default_rng(seed)
    live = [dict(), dict()]
    next_pk = [0, 1000]
    steps = []
    for _ in range(n):
        side = int(rng.integers(0, 2))
        rows, kv = [], []
        for _ in range(int(rng.integers(1, 7))):
            if live[side] and rng.random() < 0.45:
                pk = int(rng.choice(list(live[side].keys())))
                k, valid = live[side].pop(pk)
                if rng.random() < 0.5:
                    k2, v2 = int(rng.integers(0, 4)), rng.random() > 0.15
                    rows += [(UD, k, pk), (UI, k2, pk)]
                    kv += [valid, v2]
                    live[side][pk] = (k2, v2)
                else:
                    rows.append((DEL, k, pk))
                    kv.append(valid)
            else:
                k, valid = int(rng.integers(0, 4)), rng.random() > 0.15
                pk = next_pk[side]
                next_pk[side] += 1
                live[side][pk] = (k, valid)
                rows.append((INS, k, pk))
                kv.append(valid)
        steps.append((side, rows[:CAP], kv[:CAP]))
    return steps


# rows (op, k, pk); the condition is lv < rv, so left pks below the
# right pks they meet match
HAND = [
    (1, [(INS, 1, 100), (INS, 2, 200)]),
    (0, [(INS, 1, 10), (INS, 1, 11), (INS, 3, 30)]),
    # a left NULL key and a left row failing the condition
    (0, [(INS, 2, 500), (INS, 2, 12)], [False, True]),
    # right retraction: left rows of key 1 lose their only match
    (1, [(DEL, 1, 100)]),
    # degree 0 -> 1 -> 0 -> 1 of the right row 200 inside one chunk
    (0, [(DEL, 2, 12), (INS, 2, 13), (UD, 2, 13), (UI, 2, 14)]),
    # an update pair on the right moving key 2 -> 1
    (1, [(UD, 2, 200), (UI, 1, 200)]),
    (0, [(DEL, 1, 10), (DEL, 3, 30)]),
]


@pytest.mark.parametrize("join_type", ["left", "right", "full"])
@pytest.mark.parametrize("case", ["hand", "random"])
def test_outer_apply_lockstep(join_type, case):
    steps = HAND if case == "hand" else _random_steps(
        {"left": 3, "right": 4, "full": 5}[join_type])
    pj = _run_lockstep(steps, join_type=join_type)
    assert pj.errs() == [0, 0, 0]


def test_outer_overflow_lockstep():
    """Eight right rows of one key meet one left row whose match buffer
    holds M = 4 (match factor 1, 4-row chunks): the four matches past it
    count in errs[0] exactly as JAX's, and only the four emitted ones
    move degrees and retract NULL rows. (The transitions' own overflow
    term cannot fire: each transition needs an emitting slot, so there
    are at most M of them.)"""
    steps = [(1, [(INS, 5, 100 + i) for i in range(8)]),
             (0, [(INS, 5, 1)])]
    jj, pj = _joins(False, join_type="full", match_factor=1)
    schemas = (_schemas(False), _schemas(True))
    for side, rows in steps:
        arrays, ops, vis, valids = _arrays(rows, cap=4 if side == 0
                                           else CAP)
        out = jj._apply(jj.sides[side], jj.sides[1 - side], jj._errs_dev,
                        _jchunk(schemas[0][side], arrays, ops, vis, valids),
                        jnp.int64(NOWM), side=side, match_factor=1)
        jj.sides[side], odeg, jcols, jops, jemit, jj._errs_dev, _ = out
        o = jj.sides[1 - side]
        jj.sides[1 - side] = type(o)(o.khash, o.cols, o.valids, odeg, o.n)
        pcols, pops, pemit = pj._apply(
            side, _pchunk(schemas[1][side], arrays, ops, vis, valids), NOWM,
            match_factor=1)
        np.testing.assert_array_equal(np.asarray(jemit), pemit.numpy())
        np.testing.assert_array_equal(np.asarray(jops), pops.numpy())
        for a, b in zip(jcols, pcols):
            np.testing.assert_array_equal(np.asarray(a.data), b.data.numpy())
        _assert_states_equal(jj, pj)
    assert pj.errs() == [4, 0, 0]
    assert sorted_side_to_numpy(pj.sides[1])["degree"][:8].tolist() \
        == [1, 1, 1, 1, 0, 0, 0, 0]


def test_outer_join_refusals_are_jaxs():
    """State cleaning on an outer join and a temporal RIGHT join raise in
    the port (JAX asserts)."""
    lp, rp = _schemas(True)
    with pytest.raises(ValueError, match="watermark state cleaning"):
        PortJoin(Scripted(lp), Scripted(rp), [0], [0], [1], [1],
                 join_type="left", clean_watermark_cols=(1, None),
                 device="cpu")
    with pytest.raises(ValueError, match="inner or left"):
        PortJoin(Scripted(lp), Scripted(rp), [0], [0], [1], [1],
                 join_type="right", temporal=True, device="cpu")
    lj, rj = _schemas(False)
    with pytest.raises(AssertionError):
        JaxJoin(Scripted(lj), Scripted(rj), [0], [0], [1], [1],
                join_type="left", clean_watermark_cols=(1, None))


# ------------------------------------------------------------ the stream

def _stream(l_script, r_script, port=True, pks=((1,), (1,)), **kw):
    """Drive the port's executor (or JAX's); scripts hold ("c", rows) and
    ("b", curr). Returns its changelog per barrier, as multisets of
    (sign, row)."""
    if port:
        schemas, mod, pair = _schemas(True), pmsg, EpochPair
    else:
        from risingwave_tpu.stream import message as mod
        schemas, pair = _schemas(False), JEpochPair

    def msgs(script, sch):
        out, prev = [], 0
        for item in script:
            if item[0] == "c":
                mk = _pchunk if port else _jchunk
                out.append(mk(sch, *_arrays(item[1])))
            else:
                kind = (mod.BarrierKind.INITIAL if prev == 0
                        else mod.BarrierKind.CHECKPOINT)
                out.append(mod.Barrier(pair(item[1], prev), kind))
                prev = item[1]
        return out

    lsch, rsch = schemas
    cls, extra = (PortJoin, {"device": "cpu"}) if port else (JaxJoin, {})
    join = cls(Scripted(lsch, msgs(l_script, lsch)),
               Scripted(rsch, msgs(r_script, rsch)),
               left_key_indices=[0], right_key_indices=[0],
               left_pk_indices=list(pks[0]), right_pk_indices=list(pks[1]),
               **{"capacity": 64, **kw, **extra})

    async def go():
        logs, c = [], Counter()
        async for m in join.execute():
            if hasattr(m, "to_rows"):
                for op, vals in m.to_rows():
                    c[(1 if op in (INS, UI) else -1, vals)] += 1
            elif hasattr(m, "epoch"):
                logs.append(+c)
                c = Counter()
        return logs
    return join, asyncio.run(go())


def test_temporal_join_right_updates_emit_nothing():
    """The right (table) side's update emits nothing: the first left row
    saw rv=100 and is never retracted, the second sees rv=200; as a LEFT
    temporal join a left row with no match emits its NULL row once."""
    left = [("b", 1), ("b", 2), ("c", [(INS, 1, 10)]), ("b", 3), ("b", 4),
            ("c", [(INS, 1, 11), (INS, 9, 12)]), ("b", 5)]
    right = [("b", 1), ("c", [(INS, 1, 100)]), ("b", 2), ("b", 3),
             ("c", [(UD, 1, 100), (UI, 1, 200)]), ("b", 4), ("b", 5)]
    for jt in ("inner", "left"):
        join, logs = _stream(left, right, pks=((1,), (0,)), temporal=True,
                             join_type=jt)
        _, jax_logs = _stream(left, right, port=False, pks=((1,), (0,)),
                              temporal=True, join_type=jt)
        assert logs == jax_logs
        want = Counter({(1, (1, 10, 1, 100)): 1, (1, (1, 11, 1, 200)): 1})
        if jt == "left":
            want[(1, (9, 12, None, None))] = 1
        assert sum(logs, Counter()) == want
        assert join.errs() == [0, 0, 0]


def test_full_join_stream_changelog():
    """A FULL join with retractions on both sides: per-barrier changelogs
    equal JAX's as multisets, and their sum is the final join."""
    left = [("b", 1), ("c", [(INS, 1, 10), (INS, 2, 20)]), ("b", 2),
            ("c", [(DEL, 1, 10), (INS, 3, 30)]), ("b", 3), ("b", 4)]
    right = [("b", 1), ("b", 2), ("c", [(INS, 1, 100), (INS, 2, 200)]),
             ("b", 3), ("c", [(UD, 2, 200), (UI, 3, 200)]), ("b", 4)]
    join, logs = _stream(left, right, join_type="full")
    _, jax_logs = _stream(left, right, port=False, join_type="full")
    assert logs == jax_logs
    net = sum(logs, Counter())
    final = Counter()
    for (sign, row), n in net.items():
        final[row] += sign * n
    assert +final == Counter({(2, 20, None, None): 1,
                              (3, 30, 3, 200): 1,
                              (None, None, 1, 100): 1})
    assert join.errs() == [0, 0, 0]
