"""Differential tests of the port's chained hash join
(risingwave_tpu_torch/stream/hash_join.py) and of the hash table's
float64 keys against the JAX package.

Hash table: the plain `lookup` and kernel K3's plain version against
JAX's `lookup` / `lookup_or_insert` on int64 and float64 keys holding
-0.0, +0.0, NaN, +-inf, negatives, 0.5, 1.1 and 1.9 (one lane), 2^63
and 2^64: slots, table keys (bit for bit), occupancy and the unresolved
count are equal, a NaN row takes a slot of its own, and more than 32
distinct keys below 1.0 overflow their one bucket pair in both.

Executor: the same chunks go through JAX's `_apply_impl` and the port's
`_apply` (the plain versions of K32, K33, K3 and K19) over seeded
sequences on both sides with inserts, deletes, update pairs, an insert
and a delete of one pk in one chunk, NULL keys, duplicate keys, float
keys at +-0.0, NaN and inf, a float64 pk, a boolean and an int64
condition. After every chunk the changelogs are equal as multisets
(the port's match order may differ: ROADMAP accepted difference 10),
the row stores (rows, valids, live, dirty, top) and key tables equal
exactly, the chains equal as sets per key (accepted difference 11) and
the errs vectors equal. Then through `execute`: growth from 32-key /
64-row capacities through the rebuild, output_indices, the watermark
eviction of tests/test_hash_join.py::test_join_state_cleaning, and the
match, row and key overflow fail-stops at JAX's barrier.

Tolerance: none, every comparison is exact (floats bit for bit)."""

import asyncio
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from risingwave_tpu.common import DataType as JDT
from risingwave_tpu.common import StreamChunk as JChunk
from risingwave_tpu.common.epoch import EpochPair as JEpochPair
from risingwave_tpu.common.types import schema as jschema
from risingwave_tpu.expr import call as jcall, col as jcol
from risingwave_tpu.ops import hash_table as jht
from risingwave_tpu.state import MemoryStateStore as JStore
from risingwave_tpu.state import StateTable as JStateTable
from risingwave_tpu.stream import Barrier as JBarrier
from risingwave_tpu.stream import BarrierKind as JBK
from risingwave_tpu.stream import Watermark as JWatermark
from risingwave_tpu.stream.hash_join import HashJoinExecutor as JaxJoin

INS, DEL, UD, UI = 0, 1, 2, 3
CAP = 16
# float keys: the hazards of one lane (NaN, negatives, zeros and 0.5
# all hash as lane 0; 1.1 and 1.9 as lane 1) and the saturating ends
HAZARD_KEYS = [0.0, -0.0, float("nan"), float("inf"), float("-inf"), -3.5,
               0.5, 1.1, 1.9, 2.0 ** 63, 2.0 ** 64, 7.0, 123456.0]


@pytest.fixture(autouse=True, scope="module")
def _port():
    """Import torch and the port when these tests run, not at collection."""
    global torch, Scripted, DataType, schema, EpochPair, chunk_from_numpy
    global hash_join_side_to_numpy, pht, pmsg, PortJoin, pcall, pcol
    global MemoryStateStore, StateTable
    import torch
    from chip_smoke import Scripted
    from risingwave_tpu_torch.common import DataType, schema
    from risingwave_tpu_torch.common.epoch import EpochPair
    from risingwave_tpu_torch.expr import call as pcall, col as pcol
    from risingwave_tpu_torch.interop import (
        chunk_from_numpy, hash_join_side_to_numpy)
    from risingwave_tpu_torch.ops import hash_table as pht
    from risingwave_tpu_torch.state import MemoryStateStore, StateTable
    from risingwave_tpu_torch.stream import message as pmsg
    from risingwave_tpu_torch.stream.hash_join import (
        HashJoinExecutor as PortJoin)


# ---------------------------------------------------------- hash table

def _table_pair(cap, dtypes):
    jt = jht.HashTable.empty(cap, [getattr(jnp, d) for d in dtypes])
    pt = pht.HashTable.empty(cap, [getattr(torch, d) for d in dtypes], "cpu")
    return jt, pt


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int64) if a.dtype == np.float64 else a


def _assert_tables_equal(jt, pt):
    np.testing.assert_array_equal(np.asarray(jt.occupied),
                                  pt.occupied.numpy())
    for a, b in zip(jt.keys, pt.keys):
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))


# every K3 case pads its rounds to one row count and uses one capacity,
# so JAX compiles `lookup` and `lookup_or_insert` once per key signature
K3_ROWS, K3_CAP = 320, 1024
_JLOOKUP = jax.jit(jht.lookup)
_JINSERT = jax.jit(jht.lookup_or_insert)


def _k3_rounds(dtypes, rounds):
    """rounds: [(key arrays, active)]: K3's plain version and `lookup`
    against JAX's, round after round on one table (rows padded to
    K3_ROWS with inactive ones). Returns each round's (slots, n
    unresolved) over its own rows."""
    jt, pt = _table_pair(K3_CAP, dtypes)
    out = []
    for keys, act in rounds:
        n = len(act)
        keys = [np.concatenate([k, np.zeros(K3_ROWS - n, k.dtype)])
                for k in keys]
        act = np.concatenate([act, np.zeros(K3_ROWS - n, bool)])
        jk = [jnp.asarray(k) for k in keys]
        pk = [torch.from_numpy(k) for k in keys]
        ja, pa = jnp.asarray(act), torch.from_numpy(act)
        np.testing.assert_array_equal(np.asarray(_JLOOKUP(jt, jk, ja)),
                                      pht.lookup(pt, pk, pa).numpy())
        jt, js, jn = _JINSERT(jt, jk, ja)
        _, ps, pn = pht.lookup_or_insert_plain(pt, pk, pa)
        np.testing.assert_array_equal(np.asarray(js), ps.numpy())
        assert int(jn) == int(pn)
        _assert_tables_equal(jt, pt)
        out.append((ps.numpy()[:n], int(pn)))
    return out


def test_k3_float64_hazards_match_jax():
    rng = np.random.default_rng(7)
    keys = np.array(HAZARD_KEYS * 3, dtype=np.float64)
    rng.shuffle(keys)
    act = rng.random(keys.shape[0]) < 0.9
    (slots, n_un), (slots2, _) = _k3_rounds(
        ["float64"], [([keys], act), ([keys], act)])
    assert n_un == 0
    a = act
    # -0.0 and +0.0 share one slot
    z = a & (keys == 0.0)
    assert len(set(slots[z])) == 1
    # every NaN row a slot of its own, and a new one in the next round
    nan = a & np.isnan(keys)
    assert len(set(slots[nan])) == nan.sum()
    assert not set(slots[nan]) & set(slots2[nan])
    # the other keys found again in round two
    fin = a & ~np.isnan(keys)
    np.testing.assert_array_equal(slots[fin], slots2[fin])


def test_k3_int64_and_mixed_keys_match_jax():
    rng = np.random.default_rng(8)
    ka = rng.integers(-40, 40, 300).astype(np.int64)
    kb = rng.choice(np.array(HAZARD_KEYS[:9]), 300)
    act = rng.random(300) < 0.8
    _k3_rounds(["int64"], [([ka], act), ([ka[::-1].copy()], act)])
    _k3_rounds(["int64", "float64"], [([ka, kb], act)])


def test_k3_keys_below_one_overflow_one_bucket_pair():
    """NaN, negatives, zeros and fractions all hash as lane 0, so they
    share one bucket pair: a chunk's new keys all take the pair's emptier
    bucket (its pre-chunk fill), and past 32 such keys both are full, in
    both engines."""
    one = np.ones(20, bool)
    a = np.linspace(-5.0, 0.9, 20)
    b = np.linspace(-9.0, -5.5, 20)
    nan = np.full(20, np.nan)
    out = _k3_rounds(["float64"], [([a], one), ([b], one), ([nan], one)])
    assert [n for _, n in out] == [4, 4, 20]


# ------------------------------------------------------------ executor

def _schemas(port: bool):
    dt = DataType if port else JDT
    mk = schema if port else jschema
    return (mk(("k", dt.FLOAT64), ("lid", dt.INT64), ("lv", dt.INT64)),
            mk(("k", dt.FLOAT64), ("rid", dt.FLOAT64), ("rv", dt.INT64)))


def _cond(port: bool, kind):
    """Over the full row (k, lid, lv, k, rid, rv): 'bool' is lv < rv,
    'int' is rv - lv (an int64 condition: holds where its low bit is
    set)."""
    if kind is None:
        return None
    c, cl = (pcall, pcol) if port else (jcall, jcol)
    dt = DataType.INT64 if port else JDT.INT64
    name = "less_than" if kind == "bool" else "subtract"
    return c(name, cl(2, dt), cl(5, dt))


_JAX_JOINS: dict = {}


def _joins(cond=None, **kw):
    """A JAX join (cached by configuration: its compiled programs are
    reused, its state reset) and a fresh port join on the CPU."""
    lj, rj = _schemas(False)
    lp, rp = _schemas(True)
    common = dict(left_key_indices=[0], right_key_indices=[0],
                  left_pk_indices=[1], right_pk_indices=[1],
                  key_capacity=256, row_capacity=256, match_factor=4)
    common.update(kw)
    key = (cond, repr(sorted(common.items())))
    jj = _JAX_JOINS.get(key)
    if jj is None:
        jj = _JAX_JOINS[key] = JaxJoin(Scripted(lj), Scripted(rj),
                                       condition=_cond(False, cond),
                                       **common)
    jj.sides = [jj._empty(s) for s in (0, 1)]
    jj._errs_dev = jnp.zeros(4, dtype=jnp.int32)
    return jj, PortJoin(Scripted(lp), Scripted(rp), device="cpu",
                        condition=_cond(True, cond), **common)


def _arrays(rows, cap=CAP):
    """rows: (op, k, pk, v[, key_valid])."""
    n = len(rows)
    k = np.zeros(cap, np.float64)
    pk = np.zeros(cap, np.float64)
    v = np.zeros(cap, np.int64)
    ops = np.zeros(cap, np.int8)
    kv = np.ones(cap, bool)
    for i, r in enumerate(rows):
        ops[i], k[i], pk[i], v[i] = r[0], r[1], r[2], r[3]
        kv[i] = r[4] if len(r) > 4 else True
    return [k, pk, v], ops, np.arange(cap) < n, [kv, None, None]


def _jchunk(sch, arrays, ops, vis, valids):
    arrays = [a.astype(f.data_type.np_dtype) for a, f in zip(arrays, sch)]
    return JChunk.from_numpy(sch, arrays, ops=ops, capacity=len(vis),
                             valids=valids).with_vis(jnp.asarray(vis))


def _canon(cols_data, cols_valid, ops, vis):
    """The visible rows as a Counter of (op, (valid, bits) per column)."""
    vis = np.asarray(vis) != 0
    out = Counter()
    datas = [_bits(d) for d in cols_data]
    for i in np.flatnonzero(vis):
        out[(int(ops[i]),) + tuple(
            (bool(v[i]), int(d[i]) if v[i] else 0)
            for d, v in zip(datas, cols_valid))] += 1
    return out


def _chains(head, nxt):
    out = {}
    for slot in np.flatnonzero(head >= 0):
        rows, cur = set(), int(head[slot])
        while cur >= 0:
            rows.add(cur)
            cur = int(nxt[cur])
        out[int(slot)] = frozenset(rows)
    return out


def _assert_sides_equal(jj, pj):
    for s in (0, 1):
        j, p = jj.sides[s], hash_join_side_to_numpy(pj.sides[s])
        assert int(j.top) == p["top"]
        np.testing.assert_array_equal(np.asarray(j.key_table.occupied),
                                      p["occupied"])
        for a, b in zip(j.key_table.keys, p["table_keys"]):
            np.testing.assert_array_equal(_bits(a), _bits(b))
        for name in ("live", "dirty"):
            np.testing.assert_array_equal(np.asarray(getattr(j, name)),
                                          p[name])
        for a, b in zip(j.rows, p["rows"]):
            np.testing.assert_array_equal(_bits(a), _bits(b))
        for a, b in zip(j.valids, p["valids"]):
            np.testing.assert_array_equal(np.asarray(a), b)
        assert _chains(np.asarray(j.head), np.asarray(j.next)) \
            == _chains(p["head"], p["next"])
    np.testing.assert_array_equal(np.asarray(jj._errs_dev),
                                  pj._errs_dev.numpy())


def _jax_apply(jj, side, jc):
    """JAX's apply and condition (hash_join.py:_drain_run) of one chunk:
    (columns, ops, the visibility JAX's chunk carries)."""
    own, cols, ops, vis, errs, _, _ = jj._apply(
        jj.sides[side], jj.sides[1 - side], jj._errs_dev, jc, side=side)
    jj.sides[side], jj._errs_dev = own, errs
    out = JChunk(tuple(cols), ops, vis, None)
    if jj.condition is not None:
        pred = jj.condition.eval(cols)
        out = out.mask(pred.data & pred.valid_mask())
    return cols, np.asarray(ops), np.asarray(out.vis)


def _run_lockstep(steps, cond=None, **kw):
    """steps: (side, rows). Checks every step; returns the port join."""
    jj, pj = _joins(cond, **kw)
    schemas = (_schemas(False), _schemas(True))
    for side, rows in steps:
        arrays, ops, vis, valids = _arrays(rows)
        jcols, jops, jvis = _jax_apply(
            jj, side, _jchunk(schemas[0][side], arrays, ops, vis, valids))
        pc = chunk_from_numpy(schemas[1][side], arrays, ops, vis, valids,
                              device="cpu")
        pcols, pops, pvis = pj._apply(side, pc)
        want = _canon([np.asarray(c.data) for c in jcols],
                      [np.asarray(c.valid_mask()) for c in jcols], jops, jvis)
        got = _canon([c.data.numpy() for c in pcols],
                     [c.valid_mask().numpy() for c in pcols], pops.numpy(),
                     pvis.numpy())
        assert got == want
        _assert_sides_equal(jj, pj)
    return pj


def _random_steps(seed, n=20):
    """Chunks of both sides over a few float keys (hazards included) with
    NULL keys, deletes, update pairs that move a row between keys, and
    an insert plus a delete of one pk inside one chunk."""
    rng = np.random.default_rng(seed)
    keys = [0.0, -0.0, 1.5, 2.5, float("inf"), -1.0, float("nan")]
    p_key = [0.2, 0.2, 0.2, 0.15, 0.1, 0.1, 0.05]
    live = [dict(), dict()]
    next_pk = [0, 1000]
    steps = []

    def new_key():
        return float(rng.choice(keys, p=p_key)), bool(rng.random() > 0.1)

    for _ in range(n):
        side = int(rng.integers(0, 2))
        rows = []
        for _ in range(int(rng.integers(1, 6))):
            r = rng.random()
            # a stored NaN-key row is never found again (NaN == NaN is
            # false), so only rows with other keys are retracted
            cands = [p for p, (k, _, _) in live[side].items()
                     if not np.isnan(k)]
            if cands and r < 0.4:
                pk = int(rng.choice(cands))
                k, kv, v = live[side].pop(pk)
                if rng.random() < 0.5:
                    k2, kv2 = new_key()
                    v2 = int(rng.integers(0, 50))
                    rows += [(UD, k, pk, v, kv), (UI, k2, pk, v2, kv2)]
                    live[side][pk] = (k2, kv2, v2)
                else:
                    rows.append((DEL, k, pk, v, kv))
            else:
                k, kv = new_key()
                pk = next_pk[side]
                next_pk[side] += 1
                v = int(rng.integers(0, 50))
                rows.append((INS, k, pk, v, kv))
                if r > 0.9:          # inserted and deleted in one chunk
                    rows.append((DEL, k, pk, v, kv))
                else:
                    live[side][pk] = (k, kv, v)
        steps.append((side, rows[:CAP]))
    return steps


HAND = [
    # duplicate keys, -0.0 and +0.0 one key, NaN matching nothing
    (1, [(INS, 0.0, 100, 5), (INS, -0.0, 101, 6), (INS, float("nan"), 102, 7),
         (INS, float("inf"), 103, 8)]),
    (0, [(INS, -0.0, 1, 1), (INS, float("nan"), 2, 2),
         (INS, float("inf"), 3, 9), (INS, 0.0, 4, 3, False)]),
    # a right update pair moving 0.0 -> inf; a delete by pk -0.0 of the
    # row stored as +0.0 (the float64 pk compares with IEEE ==)
    (1, [(UD, 0.0, 100, 5), (UI, float("inf"), 100, 4), (DEL, -0.0, 101, 6)]),
    # insert then delete of one pk in one chunk; a delete of a NaN-key
    # row misses (errs[1]) in both engines
    (0, [(INS, float("inf"), 5, 1), (DEL, float("inf"), 5, 1),
         (DEL, float("nan"), 2, 2)]),
    (1, [(DEL, float("inf"), 100, 4), (INS, -0.0, -0.0, 11)]),
]


@pytest.mark.parametrize("cond", [None, "bool", "int"])
@pytest.mark.parametrize("case", ["hand", "random"])
def test_hash_join_apply_lockstep(case, cond):
    steps = HAND if case == "hand" else _random_steps(
        {None: 1, "bool": 2, "int": 3}[cond])
    pj = _run_lockstep(steps, cond)
    if case == "hand":
        assert pj.errs()[1] == 1 and pj.errs()[0] == 0


# -------------------------------------------------------------- stream

def _messages(port: bool, side: int, script, schemas):
    """script: ("b", epoch) | ("c", rows) | ("w", col, val) for one side;
    the first barrier is INITIAL."""
    sch = schemas[side]
    out = []
    for item in script:
        if item[0] == "b":
            e = item[1]
            kind = (pmsg.BarrierKind if port else JBK)
            kind = kind.INITIAL if e == 1 else kind.CHECKPOINT
            ep = (EpochPair if port else JEpochPair)(e, e - 1)
            out.append((pmsg.Barrier if port else JBarrier)(ep, kind))
        elif item[0] == "w":
            dt = DataType.FLOAT64 if port else JDT.FLOAT64
            out.append((pmsg.Watermark if port else JWatermark)(
                item[1], dt, item[2]))
        else:
            arrays, ops, vis, valids = _arrays(item[1])
            if port:
                out.append(chunk_from_numpy(sch, arrays, ops, vis, valids,
                                            device="cpu"))
            else:
                out.append(_jchunk(sch, arrays, ops, vis, valids))
    return out


async def _drain(join):
    """Per barrier interval the changelog Counter; the error raised, if
    any, as (intervals done, message)."""
    logs, cur = [], Counter()
    try:
        async for m in join.execute():
            if hasattr(m, "epoch"):
                logs.append(cur)
                cur = Counter()
            elif hasattr(m, "columns"):
                cols = m.columns
                cur += _canon([np.asarray(c.data) for c in cols],
                              [np.asarray(c.valid_mask()) for c in cols],
                              np.asarray(m.ops), np.asarray(m.vis))
    except RuntimeError as e:
        return logs, (len(logs), str(e))
    return logs, None


def _run_stream(left, right, *, jax_kw=None, state=None, **kw):
    """Both engines' executors over the same scripts; asserts the per
    barrier changelogs and any fail-stop agree. Returns (jax join, port
    join)."""
    lj, rj = _schemas(False)
    lp, rp = _schemas(True)
    common = dict(left_key_indices=[0], right_key_indices=[0],
                  left_pk_indices=[1], right_pk_indices=[1],
                  key_capacity=256, row_capacity=256, match_factor=4)
    common.update(kw)
    st_j = st_p = None
    if state is not None:
        st_j = tuple(JStateTable(state[0], 30 + s, sch, pk_indices=[1])
                     for s, sch in enumerate((lj, rj)))
        st_p = tuple(StateTable(state[1], 30 + s, sch, pk_indices=[1])
                     for s, sch in enumerate((lp, rp)))
    jj = JaxJoin(Scripted(lj, _messages(False, 0, left, (lj, rj))),
                 Scripted(rj, _messages(False, 1, right, (lj, rj))),
                 state_tables=st_j, **common, **(jax_kw or {}))
    # one dispatch a chunk, as the port applies them (the batched scan
    # emits the same changelog)
    jj._use_chunk_batching = False
    pj = PortJoin(Scripted(lp, _messages(True, 0, left, (lp, rp))),
                  Scripted(rp, _messages(True, 1, right, (lp, rp))),
                  state_tables=st_p, device="cpu", **common)
    jl, jerr = asyncio.run(_drain(jj))
    pl, perr = asyncio.run(_drain(pj))
    assert perr == jerr
    assert pl == jl
    assert pj.rebuilds == jj.rebuilds
    return jj, pj


def _grow_script(seed, side, n_chunks, per_barrier, pk0):
    rng = np.random.default_rng(seed)
    out, pk, e = [("b", 1)], pk0, 1
    for i in range(n_chunks):
        rows = []
        for _ in range(CAP):
            k = float(rng.integers(0, 40)) + (0.5 if rng.random() < 0.5
                                               else 0.0)
            rows.append((INS, k, pk, int(rng.integers(0, 9))))
            pk += 1
        if side == 1 and i % 3 == 2:
            # retract a third of the chunk before it (its pks pk-16-CAP..)
            rows = rows[:8] + [(DEL, r[1], r[2], r[3]) for r in prev[::2]]
        prev = rows
        out.append(("c", rows))
        if i % per_barrier == per_barrier - 1:
            e += 1
            out.append(("b", e))
    e += 1
    out.append(("b", e))
    return out


def test_hash_join_growth_and_output_indices_match_jax():
    """From 32-key / 64-row capacities, ~40 distinct float keys and a
    few hundred rows a side grow both sides through the rebuild (JAX's
    0.7 / 0.35 rule) in both engines; output_indices projects the
    output; the per-barrier changelogs and the final stores agree."""
    jj, pj = _run_stream(_grow_script(11, 0, 7, 1, 0),
                         _grow_script(12, 1, 7, 1, 10_000),
                         key_capacity=32, row_capacity=64,
                         output_indices=[1, 2, 4, 5])
    assert pj.rebuilds >= 3
    assert pj.key_capacity == jj.key_capacity
    assert pj.row_capacity == jj.row_capacity
    _assert_sides_equal(jj, pj)


def test_hash_join_state_cleaning_matches_jax():
    """tests/test_hash_join.py::test_join_state_cleaning on both engines
    (float keys): rows below the cleaning watermark leave the device
    state and the durable tables."""
    left = [("b", 1), ("c", [(INS, 1.0, 10, 0), (INS, 9.0, 20, 0)]),
            ("b", 2), ("w", 0, 5.0), ("b", 3)]
    right = [("b", 1), ("b", 2), ("w", 0, 5.0), ("b", 3)]
    stores = (JStore(), MemoryStateStore())
    jj, pj = _run_stream(left, right, state=stores,
                         clean_watermark_cols=(0, 0))
    stores[0].sync(3)
    stores[1].sync(3)
    lp, _ = _schemas(True)
    remaining = sorted(r[1] for _, r in
                       StateTable(stores[1], 30, lp, pk_indices=[1])
                       .iter_all())
    assert remaining == [20]
    assert int(pj.sides[0].live.sum()) == int(np.asarray(
        jj.sides[0].live).sum()) == 1
    _assert_sides_equal(jj, pj)


def _fail_case(kind):
    if kind == "match":
        # 20 right rows of key 1.0 meet one left row: M = 16 holds 16
        right = [("b", 1), ("c", [(INS, 1.0, 100 + i, i) for i in range(10)]),
                 ("c", [(INS, 1.0, 200 + i, i) for i in range(10)]), ("b", 2),
                 ("b", 3)]
        left = [("b", 1), ("b", 2), ("c", [(INS, 1.0, 1, 0)]), ("b", 3)]
        return left, right, dict(match_factor=1)
    if kind == "row":
        # 80 rows into a 64-row store inside one barrier interval
        left = [("b", 1)] + [("c", [(INS, float(i % 7), 16 * c + i, 0)
                                    for i in range(CAP)])
                             for c in range(5)] + [("b", 2), ("b", 3)]
        return left, [("b", 1), ("b", 2), ("b", 3)], dict(
            key_capacity=64, row_capacity=64)
    # key: 48 NaN rows (48 keys, one bucket pair of 32 slots)
    left = [("b", 1), ("b", 2)] + [
        ("c", [(INS, float("nan"), 16 * c + i, 0) for i in range(CAP)])
        for c in range(3)] + [("b", 3)]
    return left, [("b", 1), ("b", 2), ("b", 3)], dict(key_capacity=64)


@pytest.mark.parametrize("kind", ["match", "row", "key"])
def test_hash_join_overflow_fail_stops_with_jax(kind):
    left, right, kw = _fail_case(kind)
    jj, pj = _run_stream(left, right, **kw)
    want = {"match": [0, 0, 4, 0], "row": [0, 0, 0, 16],
            "key": [16, 0, 0, 0]}[kind]
    assert pj.errs() == want
