"""The port's retractable MIN/MAX against the JAX package's: the plain
top-K buffer functions of `ops/extrema.py` (what kernel K26 is held to
on the card) on identical seeded chunks, the hash agg's barrier flush
(kernel K27's plain version) on identical states with linear and
retractable calls mixed, and the hash agg with retractable MAX/MIN in
lockstep with JAX's `HashAggExecutor` (tests/test_hash_agg.py's
retractable cases and a random stream with NULLs, deletes that miss,
and float values at the edges of XLA's CPU comparisons: NaN, +-0,
subnormals, +-inf).

Values, counts and lossy flags compare exactly (floats by their bits);
error counts compare exactly for the update and zero/non-zero alike
for the underflow, which the port takes over the groups a chunk touched
and the JAX package over every group after every chunk. Changelogs
compare per barrier as multisets of (op, row), floats by their bits and
every NaN as one token."""

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
from risingwave_tpu.expr import agg as jagg
from risingwave_tpu.ops import extrema as jext
from risingwave_tpu.ops.hash_table import HashTable as JHT
from risingwave_tpu.state import MemoryStateStore as JStore
from risingwave_tpu.state import StateTable as JStateTable
from risingwave_tpu.stream import message as jmsg
from risingwave_tpu.stream.hash_agg import AggState as JAggState
from risingwave_tpu.stream.hash_agg import HashAggExecutor as JaxAgg

I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
SUB = 5e-324


@pytest.fixture(autouse=True, scope="module")
def _port():
    """Import torch and the port when these tests run, not at
    collection."""
    global torch, pext, DataType, schema, EpochPair, pagg, pmsg, PortAgg
    global chunk_from_numpy, ha, HashTable, MemoryStateStore, StateTable
    global chip_smoke
    import torch
    import chip_smoke
    from risingwave_tpu_torch.common import DataType, schema
    from risingwave_tpu_torch.common.epoch import EpochPair
    from risingwave_tpu_torch.expr import agg as pagg
    from risingwave_tpu_torch.interop import chunk_from_numpy
    from risingwave_tpu_torch.ops import extrema as pext
    from risingwave_tpu_torch.ops.hash_table import HashTable
    from risingwave_tpu_torch.state import MemoryStateStore, StateTable
    from risingwave_tpu_torch.stream import hash_agg as ha
    from risingwave_tpu_torch.stream import message as pmsg
    from risingwave_tpu_torch.stream.hash_agg import HashAggExecutor as PortAgg


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int64) if a.dtype == np.float64 else a


def _assert_state_equal(pst, jst):
    for p, j in zip(pst, jst):
        np.testing.assert_array_equal(_bits(p.numpy()), _bits(np.asarray(j)))


# ------------------------------------------------------------ extrema

def _chunks(rng, dtype, C, n_chunks, N, is_max):
    """chip_smoke's hazard chunks (`extrema_edge_chunks`) with the JAX
    function's inputs beside them: (values, valid, signs, seg, ops,
    slots), seg = C and sign 0 where a row is invisible."""
    out = []
    for vals, valid, ops, slots in chip_smoke.extrema_edge_chunks(
            rng, dtype, C, n_chunks, N, is_max):
        visible = slots >= 0
        ins = (ops == 0) | (ops == 3)
        signs = np.where(visible, np.where(ins, 1, -1), 0).astype(np.int32)
        seg = np.where(visible, slots, C).astype(np.int64)
        out.append((vals, valid, signs, seg, ops, slots))
    return out


_JUPDATE = jax.jit(jext.extrema_update, static_argnames=("C", "is_max"))


@pytest.mark.parametrize("dtype", ["int64", "float64"])
@pytest.mark.parametrize("is_max", [True, False])
@pytest.mark.parametrize("K", [2, 32])
def test_extrema_update_matches_jax(dtype, is_max, K):
    C, N = 6, 48
    rng = np.random.default_rng(K * 4 + is_max * 2 + (dtype == "float64"))
    jdt = jnp.float64 if dtype == "float64" else jnp.int64
    tdt = torch.float64 if dtype == "float64" else torch.int64
    jst = jext.extrema_empty(C, K, jdt)
    pst = pext.extrema_empty(C, K, tdt, "cpu")
    ast = pext.extrema_empty(C, K, tdt, "cpu")    # through extrema_apply
    rc = np.zeros(C, np.int64)
    j_acc = p_acc = 0
    saw = Counter()
    for vals, valid, signs, seg, ops, slots in _chunks(rng, dtype, C, 9, N,
                                                         is_max):
        rc += np.bincount(seg[seg < C], weights=signs[seg < C],
                          minlength=C + 1)[:C].astype(np.int64)
        jst, je = _JUPDATE(jst, jnp.asarray(vals), jnp.asarray(valid),
                           jnp.asarray(signs), jnp.asarray(seg), C=C,
                           is_max=is_max)
        t = torch.from_numpy
        pst, pe = pext.extrema_update_plain(
            pst, t(vals), t(valid), t(signs), t(seg), C, is_max)
        _assert_state_equal(pst, jst)
        assert int(pe) == int(je)
        # the kernel's contract: the same state, the update errors plus
        # the underflow of the touched groups
        err = torch.zeros((), dtype=torch.int32)
        pext.extrema_apply_plain(ast, t(vals), t(valid), t(ops), t(slots),
                                 t(rc), is_max, err)
        _assert_state_equal(ast, jst)
        j_acc += int(je) + int(jext.extrema_underflow(jst, jnp.asarray(rc)))
        p_acc += int(err)
        assert (j_acc == 0) == (p_acc == 0)
        assert int(err) >= int(pe)
        saw["err"] += int(je) > 0
        saw["lossy"] += int(np.asarray(jst[2]).sum()) > 0
        saw["underflow"] += int(jext.extrema_underflow(
            jst, jnp.asarray(rc))) > 0
    # the hazards were reached
    assert saw["err"] > 0
    if K == 2:
        assert saw["lossy"] > 0 and saw["underflow"] > 0
    # emit, underflow, gather and mask-keep on the final state
    init = (-np.inf if is_max else np.inf) if dtype == "float64" else (
        I64_MIN if is_max else I64_MAX)
    np.testing.assert_array_equal(
        _bits(pext.extrema_emit(pst, init, tdt).numpy()),
        _bits(np.asarray(jext.extrema_emit(jst, init, jdt))))
    assert int(pext.extrema_underflow(pst, torch.from_numpy(rc))) == \
        int(jext.extrema_underflow(jst, jnp.asarray(rc)))
    sel = np.array([4, 1, 0, 5, 2, 3])
    tgt = np.array([7, 3, 9, 0, 9, 1])          # 9 = C_new: dropped
    jg = jext.extrema_gather(jst, jnp.asarray(sel), jnp.asarray(tgt), 9, K,
                             jdt)
    pg = pext.extrema_gather(pst, torch.from_numpy(sel),
                             torch.from_numpy(tgt), 9, K, tdt)
    _assert_state_equal(pg, jg)
    keep = np.array([True, False, True, False, False, True])
    jk = jext.extrema_mask_keep(jst, jnp.asarray(keep))
    pext.extrema_mask_keep(pst, torch.from_numpy(keep))
    _assert_state_equal(pst, jk)


def test_float_ties_follow_xla_cpu():
    """A subnormal beside a zero and -0.0 beside +0.0 combine into one
    value (the first seen keeps its bits); NaNs never combine, so a NaN
    delete is an error unless the buffer is lossy."""
    C, K = 2, 4
    vals = np.array([0.0, SUB, -0.0, np.nan, np.nan, 1.0, -SUB])
    signs = np.array([1, 1, 1, 1, 1, 1, -1], np.int32)
    seg = np.zeros(7, np.int64)
    valid = np.ones(7, bool)
    t = torch.from_numpy
    for is_max in (True, False):
        jst, je = _JUPDATE(jext.extrema_empty(C, K, jnp.float64),
                           jnp.asarray(vals), jnp.asarray(valid),
                           jnp.asarray(signs), jnp.asarray(seg), C=C,
                           is_max=is_max)
        pst, pe = pext.extrema_update_plain(
            pext.extrema_empty(C, K, torch.float64, "cpu"), t(vals),
            t(valid), t(signs), t(seg), C, is_max)
        _assert_state_equal(pst, jst)
        assert int(pe) == int(je) == 0
        cnts = pst[1][0].tolist()
        # zeros and subnormals: one value of count 3 - 1; 1.0; two NaNs
        assert sorted(cnts) == [1, 1, 1, 2]
        d = np.array([np.nan]), np.array([-1], np.int32)
        jst2, je2 = _JUPDATE(jst, jnp.asarray(d[0]), jnp.ones(1, bool),
                             jnp.asarray(d[1]), jnp.zeros(1, jnp.int64),
                             C=C, is_max=is_max)
        pst2, pe2 = pext.extrema_update_plain(
            pst, t(d[0]), torch.ones(1, dtype=torch.bool), t(d[1]),
            torch.zeros(1, dtype=torch.int64), C, is_max)
        _assert_state_equal(pst2, jst2)
        assert int(pe2) == int(je2) == 1


# -------------------------------------------------------------- flush

def _flush_calls(mod, dt):
    return [mod.count_star(), mod.agg_max(1), mod.agg_sum(2, dt.FLOAT64),
            mod.agg_min(2, dt.FLOAT64), mod.agg_max(1, append_only=True),
            mod.agg_sum(2, dt.FLOAT32)]


class _Scripted:
    """An executor whose stream is a fixed list of messages."""

    def __init__(self, sch, msgs):
        self.schema = sch
        self.pk_indices = ()
        self._msgs = msgs

    async def execute(self):
        for m in self._msgs:
            yield m
            await asyncio.sleep(0)


COLS = [("k", "INT64"), ("v", "INT64"), ("f", "FLOAT64")]


def _schemas():
    return (jschema(*[(n, getattr(JDT, t)) for n, t in COLS]),
            schema(*[(n, getattr(DataType, t)) for n, t in COLS]))


def test_flush_plain_matches_jax():
    """K27's plain version against JAX's `_flush_impl` on one random
    state: COUNT, a retractable MAX, a float SUM, a retractable float
    MIN, an append-only MAX and a REAL (float32) SUM; groups born, dying,
    changed and unchanged, NaN and subnormal emitted values (float32
    subnormals compare as float32 values)."""
    rng = np.random.default_rng(5)
    C, K = 64, 4
    jsch, psch = _schemas()
    jx = JaxAgg(_Scripted(jsch, []), [0], _flush_calls(jagg, JDT),
                capacity=C, minput_k=K)
    px = PortAgg(_Scripted(psch, []), [0], _flush_calls(pagg, DataType),
                 capacity=C, minput_k=K, device="cpu")
    occ = rng.random(C) < 0.8
    keys = np.where(occ, rng.integers(0, 1000, C), 0).astype(np.int64)
    rc = np.where(occ, rng.integers(0, 3, C), 0).astype(np.int64)
    dirty = occ & (rng.random(C) < 0.6)
    prev = occ & (rng.random(C) < 0.7)
    prev = np.where(dirty, prev, rc > 0)
    fpool = np.array([np.nan, 0.0, -0.0, SUB, 1.5, -2.0])

    def buffers(pool, dtype):
        v = np.sort(rng.choice(pool, (C, K)), axis=1).astype(dtype)
        c = rng.integers(0, 3, (C, K)).astype(np.int32)
        c[:, 1:] *= c[:, :1] > 0                   # empty cells trail
        v = np.where(c > 0, v, 0).astype(dtype)
        return v, c, rng.random(C) < 0.2

    ext_i = buffers(np.arange(-5, 5), np.int64)
    ext_f = buffers(fpool, np.float64)
    lin = [rng.integers(0, 5, C).astype(np.int64), None,
           rng.choice(fpool, C), None, rng.integers(-3, 3, C),
           rng.choice(fpool, C)]
    states = [lin[0], ext_i, lin[2], ext_f, lin[4], lin[5]]
    # emitted values before the flush: the current emit where the slot is
    # not dirty (an invariant of the executor), random where it is
    jspecs = jx.specs
    emits = []
    for j, st in enumerate(states):
        if isinstance(st, tuple):
            cur = np.asarray(jext.extrema_emit(
                tuple(jnp.asarray(x) for x in st), jspecs[j].init,
                jspecs[j].state_dtype))
        else:
            cur = st
        noise = (rng.choice(fpool, C) if cur.dtype == np.float64
                 else rng.integers(-5, 5, C))
        ret = np.float32 if j == 5 else cur.dtype
        emits.append(np.where(dirty & (rng.random(C) < 0.5), noise,
                              cur).astype(ret))
    # five live dirty groups whose only candidate change is one float
    # SUM's: the FLOAT64 SUM's 0 -> subnormal and +0 -> -0 (unchanged to
    # XLA's CPU compare: no rows) and NaN -> NaN (changed: a pair); the
    # REAL SUM's 0 -> a float32 subnormal (the cast flushes it: no rows)
    # and an emitted float32 subnormal -> 0 (equal in float32: no rows)
    cases = np.flatnonzero(occ & dirty)[:5]
    for slot, (jc, new_, old_) in zip(cases,
                                      [(2, SUB, 0.0), (2, -0.0, 0.0),
                                       (2, np.nan, np.nan),
                                       (5, 1e-40, 0.0), (5, 0.0, 1e-40)]):
        rc[slot], prev[slot] = 1, True
        # no NaN but the case's own: the other float SUM at 1.5, the
        # buffers empty (their identity)
        for j in (2, 5):
            states[j][slot] = 1.5
        for j in (1, 3):
            states[j][1][slot] = 0
        for j in (0, 2, 4, 5):
            emits[j][slot] = states[j][slot]
        states[jc][slot], emits[jc][slot] = new_, old_
        for j in (1, 3):
            emits[j][slot] = np.asarray(jext.extrema_emit(
                tuple(jnp.asarray(x) for x in states[j]), jspecs[j].init,
                jspecs[j].state_dtype))[slot]

    def jstate():
        return JAggState(
            JHT((jnp.asarray(keys),), jnp.asarray(occ)),
            tuple(tuple(jnp.asarray(x) for x in s) if isinstance(s, tuple)
                  else jnp.asarray(s) for s in states),
            jnp.asarray(rc), jnp.asarray(dirty), jnp.asarray(prev),
            tuple(jnp.asarray(e) for e in emits))

    def pstate():
        t = torch.from_numpy
        return ha.AggState(
            HashTable((t(keys.copy()),), t(occ.copy())),
            tuple(tuple(t(x.copy()) for x in s) if isinstance(s, tuple)
                  else t(s.copy()) for s in states),
            t(rc.copy()), t(dirty.copy()), t(prev.copy()),
            tuple(t(e.copy()) for e in emits))

    jst2, jcols, jops, jvis = jx._flush_impl(jstate())
    pst = pstate()
    pcols, pops, pvis = ha.agg_flush_plain(pst, px.specs)
    vis = np.asarray(jvis)
    np.testing.assert_array_equal(pvis.numpy(), vis)
    # of the five cases only NaN -> NaN emits its pair
    ranks = np.searchsorted(np.flatnonzero(dirty), cases)
    assert vis.reshape(-1, 2)[ranks].any(1).tolist() == \
        [False, False, True, False, False]
    assert 10 < vis.sum() < 2 * C
    np.testing.assert_array_equal(pops.numpy()[vis], np.asarray(jops)[vis])
    for p, j in zip(pcols, jcols):
        np.testing.assert_array_equal(_bits(p.numpy()[vis]),
                                      _bits(np.asarray(j)[vis]))
    # rows past the dirty ranks are invisible zeros
    nd = int(dirty.sum())
    assert not pvis.numpy()[2 * nd:].any()
    np.testing.assert_array_equal(pst.prev_exists.numpy(),
                                  np.asarray(jst2.prev_exists))
    assert not pst.dirty.numpy().any()
    for p, j in zip(pst.prev_emit, jst2.prev_emit):
        np.testing.assert_array_equal(_bits(p.numpy()), _bits(np.asarray(j)))


# ------------------------------------------------------ lockstep agg

def _row_key(row):
    return tuple("nan" if isinstance(x, float) and x != x
                 else (np.float64(x).view(np.int64).item()
                       if isinstance(x, float) else x) for x in row)


async def _changelogs(agg):
    logs, cur = [], Counter()
    async for msg in agg.execute():
        if hasattr(msg, "to_rows"):
            cur.update((op, _row_key(r)) for op, r in msg.to_rows())
        elif hasattr(msg, "epoch"):
            logs.append(cur)
            cur = Counter()
    return logs


def _messages(epochs, sch, barrier_mod, epoch_cls, to_chunk):
    out = [barrier_mod.Barrier(epoch_cls(1 << 16, 0),
                               barrier_mod.BarrierKind.INITIAL)]
    for e, rows in enumerate(epochs, start=2):
        if rows:
            cap = max(16, len(rows))
            pad = cap - len(rows)
            ops = np.asarray([r[0] for r in rows] + [0] * pad, np.int8)
            ks = np.asarray([r[1] for r in rows] + [0] * pad, np.int64)
            vs = np.asarray([r[2] for r in rows] + [0] * pad, np.int64)
            fs = np.asarray([r[3] for r in rows] + [0.0] * pad)
            fv = np.asarray([r[4] for r in rows] + [True] * pad)
            vis = np.arange(cap) < len(rows)
            out.append(to_chunk(sch, [ks, vs, fs], ops, vis, fv))
        out.append(barrier_mod.Barrier(epoch_cls(e << 16, (e - 1) << 16),
                                       barrier_mod.BarrierKind.CHECKPOINT))
    return out


def _jchunk(sch, arrays, ops, vis, fv):
    return JChunk.from_numpy(sch, arrays, ops=ops, capacity=len(vis),
                             valids=[None, None, fv]).with_vis(
        jnp.asarray(vis))


def _pchunk(sch, arrays, ops, vis, fv):
    return chunk_from_numpy(sch, arrays, ops, vis, [None, None, fv],
                            device="cpu")


def _lockstep(epochs, calls, K=32, capacity=64, jtable=None, ptable=None,
              watchdog=1):
    jsch, psch = _schemas()
    jin = _Scripted(jsch, _messages(epochs, jsch, jmsg, JEpochPair, _jchunk))
    pin = _Scripted(psch, _messages(epochs, psch, pmsg, EpochPair, _pchunk))
    jx = JaxAgg(jin, [0], calls(jagg, JDT), capacity=capacity, minput_k=K,
                state_table=jtable, watchdog_interval=watchdog)
    px = PortAgg(pin, [0], calls(pagg, DataType), capacity=capacity,
                 minput_k=K, state_table=ptable, watchdog_interval=watchdog,
                 device="cpu")
    return jx, px


def _run_both(epochs, calls, **kw):
    jx, px = _lockstep(epochs, calls, **kw)
    jl = asyncio.run(_changelogs(jx))
    pl = asyncio.run(_changelogs(px))
    return jx, px, jl, pl


def _max_i(mod, dt):
    return [mod.agg_max(1)]


def _min_i(mod, dt):
    return [mod.agg_min(1)]


I, D = 0, 1


@pytest.mark.parametrize("case", ["flip", "duplicates"])
def test_retractable_cases_match_jax(case):
    """tests/test_hash_agg.py's flip of the maximum and duplicates of the
    minimum, through both executors."""
    if case == "flip":
        epochs = [[(I, 1, 10, 0, 1), (I, 1, 30, 0, 1), (I, 1, 20, 0, 1)],
                  [(D, 1, 30, 0, 1)], [(D, 1, 20, 0, 1), (I, 1, 5, 0, 1)]]
        calls, want = _max_i, [(1, 30), (1, 20), (1, 10)]
    else:
        epochs = [[(I, 7, 4, 0, 1), (I, 7, 4, 0, 1), (I, 7, 9, 0, 1)],
                  [(D, 7, 4, 0, 1)], [(D, 7, 4, 0, 1)]]
        calls, want = _min_i, [(7, 4), (7, 4), (7, 9)]
    _, _, jl, pl = _run_both(epochs, calls)
    assert pl == jl
    got = [r for log in pl for (op, r) in log if op in (0, 3)]
    assert [r for r in got] == [w for i, w in enumerate(want)
                                if i == 0 or w != want[i - 1]]


def _random_epochs(seed, n_epochs=6, rows=40, keys=5, float_vals=False):
    rng = np.random.default_rng(seed)
    live: list = []
    epochs = []
    fpool = np.array([np.nan, -0.0, 0.0, SUB, 1.0, -1.0, np.inf, 4.5])
    for _ in range(n_epochs):
        out = []
        for _ in range(rows):
            if live and rng.random() < 0.4:
                out.append((D,) + live.pop(int(rng.integers(len(live)))))
            else:
                r = (int(rng.integers(0, keys)), int(rng.integers(0, 30)),
                     float(rng.choice(fpool)) if float_vals else 0.0,
                     bool(rng.random() > 0.1))
                live.append(r)
                out.append((I,) + r)
        epochs.append(out)
    return epochs, live


def _mixed(mod, dt):
    return [mod.agg_max(1), mod.count_star(), mod.agg_min(2, dt.FLOAT64),
            mod.agg_max(2, dt.FLOAT64), mod.agg_sum(1)]


@pytest.mark.parametrize("K", [32, 3])
def test_random_stream_matches_jax_and_golden(K):
    """A random insert/delete stream over MAX/MIN (int and float, NULL
    floats), COUNT and SUM: the same changelog per barrier as JAX; at
    K = 32 the MV equals a multiset model's maxima (the golden of
    tests/test_hash_agg.py)."""
    epochs, live = _random_epochs(11 + K, float_vals=True)
    jx, px, jl, pl = _run_both(epochs, _mixed, K=K, watchdog=None)
    assert pl == jl
    # a deleted NaN never matches its insert: an error in both engines
    assert (px.overflow() == 0) == (int(jx._overflow_dev) == 0)
    for j, jst in enumerate(jx.state.agg_states):
        if isinstance(jst, tuple):
            # buffers per group key, not per slot
            def by_key(keys, st):
                return {int(k): tuple(_bits(np.asarray(a)[i]).tolist()
                                      for a in st)
                        for i, k in enumerate(np.asarray(keys))
                        if np.asarray(st[1])[i, 0] > 0}
            assert by_key(px.state.table.keys[0].numpy(),
                          [a.numpy() for a in px.state.agg_states[j]]) == \
                by_key(jx.state.table.keys[0], jst)
    if K == 32:
        mv = {}
        for log in pl:
            for op, row in log:
                if op in (0, 3):
                    mv[row[0]] = row[1]
                elif op == 1:
                    mv.pop(row[0], None)
        want = {}
        for k, v, _, _ in live:
            want[k] = max(want.get(k, v), v)
        assert mv == want


def test_underflow_fail_stops_with_jax():
    """K = 2, three distinct values: the spill marks the group lossy;
    deleting the tracked values with a row left fail-stops both engines
    at the same barrier."""
    epochs = [[(I, 1, 10, 0, 1), (I, 1, 20, 0, 1), (I, 1, 30, 0, 1)],
              [(D, 1, 30, 0, 1), (D, 1, 20, 0, 1)], [(I, 1, 1, 0, 1)]]
    jx, px = _lockstep(epochs, _max_i, K=2)
    for ex in (jx, px):
        with pytest.raises(RuntimeError, match="overflow"):
            asyncio.run(_changelogs(ex))


def test_persist_recover_matches_jax():
    """tests/test_hash_agg.py's persist/recover with K = 4: both engines
    write the same state rows, and a fresh port executor recovers the
    buffer from its own table (30 -> 10, no underflow)."""
    K = 4
    fields = [("k", "INT64")] + [(f"v{k}", "INT64") for k in range(K)] \
        + [(f"c{k}", "INT64") for k in range(K)] \
        + [("lossy", "INT64"), ("_row_count", "INT64")]
    jst = JStore()
    pstore = MemoryStateStore()

    def tables():
        return (JStateTable(jst, table_id=21, schema=jschema(
                    *[(n, getattr(JDT, t)) for n, t in fields]),
                    pk_indices=[0]),
                StateTable(pstore, table_id=21, schema=schema(
                    *[(n, getattr(DataType, t)) for n, t in fields]),
                    pk_indices=[0]))

    jt, pt = tables()
    epochs = [[(I, 1, 10, 0, 1), (I, 1, 30, 0, 1), (I, 2, 5, 0, 1)]]
    _run_both(epochs, _max_i, K=K, jtable=jt, ptable=pt)
    jrows = sorted(r for _, r in jt.iter_all())
    prows = sorted(r for _, r in pt.iter_all())
    assert prows == jrows and len(prows) == 2
    _, pt2 = tables()
    psch = _schemas()[1]
    msgs = _messages([[(D, 1, 30, 0, 1)]], psch, pmsg, EpochPair, _pchunk)
    px = PortAgg(_Scripted(psch, msgs), [0], [pagg.agg_max(1)], capacity=64,
                 state_table=pt2, minput_k=K, device="cpu")
    pl = asyncio.run(_changelogs(px))
    got = [(op, r) for log in pl for op, r in log.elements()]
    assert sorted(got) == [(2, (1, 30)), (3, (1, 10))]
