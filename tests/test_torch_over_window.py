"""The port's over-window (plain versions of kernels K23/K24 and of the
store's K7/K11/K19/K20 steps on the CPU) against the JAX package's
GeneralOverWindowExecutor and EowcOverWindowExecutor.

Inputs come from a numpy seed: inserts, deletes (some missing), U-/U+
pairs and pk runs inside one chunk, over (p, o, t, v, f, pk) rows:
partition keys, a float order column with NaN, -0.0, +0.0, a subnormal,
+-inf and repeats, an int order column of many duplicates, int and float
arguments with NULLs, one partition whose argument is NULL throughout.

Window scan: on the same store, JAX's `_compute_windows` and the port's
keys (K20's plain entry), lexsort and `window_scan_plain` give the same
row order (the port drops JAX's store-position pass: with duplicate
order keys the order is still equal) and the same window values:
exactly for integer arguments, within a relative 1e-12 of the largest
value for float sums and avgs. Over a NaN or +-inf argument the port's
sums keep it in its partition (held against a partition-by-partition
numpy recount); JAX's global prefix sums agree up to the first
partition holding one and give NaN after it (ROADMAP Queue C).

Lockstep: the same chunks through both executors' apply and, after
every chunk, their barrier flush; the store, the error counters and the
last emitted rows are equal exactly (integer arguments), and so is the
per-flush changelog as a multiset of (op, row). A port executor started
from a JAX executor's mid-stream state (`interop`) goes on alike.

Barrier loops: the watchdog grows a 2^7-slot store in both engines;
EOWC's ripeness and frontier under watermarks match, per barrier.

Durable: q6 and the EOWC body at a small size through both sessions on
Hummock stores, epochs from a counter: every state table's bytes equal
after every barrier; a store the JAX session wrote and abandoned
recovers in the port to JAX's MV."""

import asyncio
import shutil
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest

import risingwave_tpu.meta.barrier_manager as jax_bm
from risingwave_tpu.common import DataType as JDT
from risingwave_tpu.common import StreamChunk as JChunk
from risingwave_tpu.common.epoch import EpochPair as JEpochPair
from risingwave_tpu.common.types import schema as jschema
from risingwave_tpu.frontend import Session as JaxSession
from risingwave_tpu.state import HummockStateStore as JaxH
from risingwave_tpu.state import LocalFsObjectStore as JaxLocalFs
from risingwave_tpu.stream import message as jmsg
from risingwave_tpu.stream.eowc_over_window import (
    EowcOverWindowExecutor as JaxEowc)
from risingwave_tpu.stream.general_over_window import (
    GeneralOverWindowExecutor as JaxGOW, WindowSpec as JaxWS)
from risingwave_tpu.stream.source import SourceExecutor as JaxSource

INS, DEL, UD, UI = 0, 1, 2, 3
CHUNK = 64
FLOATS = [np.nan, -0.0, 0.0, 1.5, -2.25, 1e-310, np.inf, 1.5, -np.inf, 7.0]


@pytest.fixture(autouse=True, scope="module")
def _port():
    """Import torch and the port when these tests run, not at
    collection."""
    global torch, DataType, schema, EpochPair, chunk_from_numpy, pmsg
    global PortGOW, PortEowc, PWS, interop, gow, port_bm, PortSession, H
    global LocalFs, PortSource
    import torch
    import risingwave_tpu_torch.meta.barrier_manager as port_bm
    from risingwave_tpu_torch import interop
    from risingwave_tpu_torch.common import DataType, schema
    from risingwave_tpu_torch.common.epoch import EpochPair
    from risingwave_tpu_torch.frontend import Session as PortSession
    from risingwave_tpu_torch.interop import chunk_from_numpy
    from risingwave_tpu_torch.state import HummockStateStore as H
    from risingwave_tpu_torch.state import LocalFsObjectStore as LocalFs
    from risingwave_tpu_torch.stream import general_over_window as gow
    from risingwave_tpu_torch.stream import message as pmsg
    from risingwave_tpu_torch.stream.eowc_over_window import (
        EowcOverWindowExecutor as PortEowc)
    from risingwave_tpu_torch.stream.general_over_window import (
        GeneralOverWindowExecutor as PortGOW, WindowSpec as PWS)
    from risingwave_tpu_torch.stream.source import (
        SourceExecutor as PortSource)


class _Scripted:
    def __init__(self, sch, msgs=(), pk=(5,)):
        self.schema = sch
        self.pk_indices = pk
        self._msgs = list(msgs)

    async def execute(self):
        for m in self._msgs:
            yield m
            await asyncio.sleep(0)


def _schema(port: bool):
    dt = DataType if port else JDT
    mk = schema if port else jschema
    return mk(("p", dt.INT64), ("o", dt.FLOAT64), ("t", dt.INT64),
              ("v", dt.INT64), ("f", dt.FLOAT64), ("pk", dt.INT64))


def _stream(seed: int, n_chunks: int, n_parts: int = 4, miss: bool = True,
            ordered_t: bool = False):
    """Chunks of (op, p, o, t, v, f, pk, o_valid, v_valid, f_valid) rows;
    partition 0's v is NULL throughout. With `ordered_t`, t grows with
    the chunk (an event time) and no row retracts."""
    rng = np.random.default_rng(seed)
    live: dict = {}
    next_pk = 0
    out = []

    def fresh(p=None, t=0):
        p = int(rng.integers(0, n_parts)) if p is None else p
        return (p, float(FLOATS[int(rng.integers(0, len(FLOATS)))]),
                t if ordered_t else int(rng.integers(0, 5)),
                int(rng.integers(-50, 50)),
                float(rng.integers(-400, 400)) / 8.0,
                bool(rng.random() < 0.95), bool(p != 0 and
                                                rng.random() < 0.9),
                bool(rng.random() < 0.9))

    def row(op, r, pk):
        return (op, *r[:5], pk, *r[5:])

    for ci in range(n_chunks):
        rows = []
        while len(rows) < CHUNK - 4:
            x = rng.random()
            if ordered_t:
                r = fresh(t=ci * 100 + len(rows))
                live[next_pk] = r
                rows.append(row(INS, r, next_pk))
                next_pk += 1
                continue
            if live and x < 0.2:
                pk = int(rng.choice(list(live)))
                rows.append(row(DEL, live.pop(pk), pk))
            elif live and x < 0.45:
                pk = int(rng.choice(list(live)))
                old = live[pk]
                new = fresh(old[0])
                rows += [row(UD, old, pk), row(UI, new, pk)]
                live[pk] = new
                if rng.random() < 0.2:
                    new2 = fresh(old[0])
                    rows += [row(UD, new, pk), row(UI, new2, pk)]
                    live[pk] = new2
            elif x < 0.5:
                r = fresh()
                rows += [row(INS, r, next_pk), row(DEL, r, next_pk)]
                next_pk += 1
            elif miss and x < 0.52:
                rows.append(row(DEL, fresh(), 10 ** 9 + next_pk))
                next_pk += 1
            else:
                r = fresh()
                live[next_pk] = r
                rows.append(row(INS, r, next_pk))
                next_pk += 1
        out.append(rows[:CHUNK])
    return out


def _arrays(rows, cap=CHUNK):
    n = len(rows)
    p, t, v, pk = (np.zeros(cap, np.int64) for _ in range(4))
    o, f = np.zeros(cap), np.zeros(cap)
    ops = np.zeros(cap, np.int8)
    ov, vv, fv = (np.ones(cap, bool) for _ in range(3))
    for i, r in enumerate(rows):
        ops[i], p[i], o[i], t[i], v[i], f[i], pk[i], ov[i], vv[i], fv[i] = r
    return ([p, o, t, v, f, pk], ops, np.arange(cap) < n,
            [None, ov, None, vv, fv, None])


def _jchunk(rows):
    arrays, ops, vis, valids = _arrays(rows)
    ch = JChunk.from_numpy(_schema(False), arrays, ops=ops,
                           capacity=len(vis), valids=valids)
    return ch.with_vis(np.asarray(vis))


def _pchunk(rows):
    arrays, ops, vis, valids = _arrays(rows)
    return chunk_from_numpy(_schema(True), arrays, ops, vis, valids,
                            device="cpu")


def _specs(ws, port: bool):
    cls = PWS if port else JaxWS
    return tuple(cls(k, arg=a, preceding=pr, offset=off, name=f"w{j}")
                 for j, (k, a, pr, off) in enumerate(ws))


# window sets: (kind, arg, preceding, offset); arguments: 3 = v (int,
# NULL in partition 0), 4 = f (float), 1 = o (float order column)
RANKS = [("row_number", None, None, 1), ("rank", None, None, 1),
         ("dense_rank", None, None, 1)]
INT_AGGS = [("sum", 3, None, 1), ("count", 3, None, 1), ("avg", 3, None, 1),
            ("sum", 3, 2, 1), ("count", 4, 4, 1), ("avg", 3, 0, 1)]
FLOAT_AGGS = [("sum", 4, None, 1), ("avg", 4, None, 1), ("sum", 4, 3, 1),
              ("avg", 4, 1, 1)]
NONFINITE_AGGS = [("sum", 1, None, 1), ("avg", 1, None, 1),
                  ("sum", 1, 2, 1), ("avg", 1, 0, 1), ("count", 1, None, 1)]
OFFSETS = [("lag", 3, None, 2), ("lead", 4, None, 1),
           ("first_value", 1, None, 1), ("lag", 1, None, 1),
           ("lead", 3, None, 3)]
SCAN_CASES = {
    "ranks_dup_int_keys": ((0,), [(2, False)], RANKS + INT_AGGS[:2]),
    "ranks_float_keys_asc": ((0,), [(1, False)], RANKS + OFFSETS[:3]),
    "float_desc_then_int": ((0,), [(1, True), (2, False)],
                            RANKS + OFFSETS),
    "int_aggs_all_null_part": ((0,), [(2, True), (5, False)], INT_AGGS),
    "float_aggs": ((0,), [(2, False)], FLOAT_AGGS + RANKS[:1]),
    "one_partition": ((), [(2, False), (1, True)],
                      RANKS + INT_AGGS[:2] + OFFSETS[:2]),
    # sums over o, whose NaN and +-inf stay in their own partition
    "sums_over_nonfinite_args": ((0,), [(2, False)], NONFINITE_AGGS),
}


_STORES: dict = {}


def _jax_store(case_windows, parts, order, seed, C=256):
    """A JAX executor over the store 5 chunks of seed `seed` leave; the
    store is built once a seed (each executor compiles its own apply)
    and copied into the case's executor."""
    jx = JaxGOW(_Scripted(_schema(False)), parts, order,
                _specs(case_windows, False), capacity=C)
    if seed not in _STORES:
        for rows in _stream(seed, 5):
            jx.on_chunk(_jchunk(rows))
        _STORES[seed] = (jx.khash, jx.cols, jx.valids, jx.n, jx._errs_dev)
    jx.khash, jx.cols, jx.valids, jx.n, jx._errs_dev = _STORES[seed]
    return jx


def _port_from(jx, parts, order, ws):
    px = PortGOW(_Scripted(_schema(True)), parts, order, _specs(ws, True),
                 capacity=jx.capacity, device="cpu")
    interop.over_window_state_from_numpy(px, **_jax_state(jx))
    return px


def _jax_state(ex) -> dict:
    return dict(khash=np.asarray(ex.khash),
                cols=[np.asarray(c) for c in ex.cols],
                valids=[np.asarray(v) for v in ex.valids],
                n=int(np.asarray(ex.n)),
                em_hash=np.asarray(ex.em_hash),
                em_cols=[np.asarray(c) for c in ex.em_cols],
                em_valids=[np.asarray(v) for v in ex.em_valids],
                em_n=int(np.asarray(ex.em_n)),
                errs=[int(x) for x in np.asarray(ex._errs_dev)])


@np.errstate(invalid="ignore")
def _frame_sums_np(x, valid, g, kind, preceding):
    """sum or avg over each row's frame, partition by partition (runs of
    equal g), with numpy's sequential cumsum: (values, valids)."""
    n = len(x)
    out, ov = np.zeros(n), np.zeros(n, bool)
    cut = np.r_[0, np.flatnonzero(g[1:] != g[:-1]) + 1, n]
    for a, b in zip(cut[:-1], cut[1:]):
        s = np.cumsum(np.where(valid[a:b], x[a:b], 0.0))
        c = np.cumsum(valid[a:b].astype(np.int64))
        lo = np.arange(b - a) - (preceding if preceding is not None
                                 else b - a) - 1
        in_frame = lo >= 0
        s = s - np.where(in_frame, s[np.maximum(lo, 0)], 0.0)
        c = c - np.where(in_frame, c[np.maximum(lo, 0)], 0)
        out[a:b] = s / np.maximum(c, 1) if kind == "avg" else s
        ov[a:b] = c > 0
    return out, ov


def _assert_close_nonfinite(got, want, scale, msg):
    """Equal NaN and +-inf positions; finite values within 1e-12 of
    `scale`."""
    for f in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(f(got), f(want), err_msg=msg)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                               atol=1e-12 * scale, err_msg=msg)


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_window_scan_matches_jax(case):
    parts, order, ws = SCAN_CASES[case]
    jx = _jax_store(ws, parts, order, sorted(SCAN_CASES).index(case) % 2)
    px = _port_from(jx, parts, order, ws)
    C = jx.capacity
    live = jnp.arange(C, dtype=jnp.int32) < jx.n
    jorder, jouts, jvalids = jx._compute_windows(jx.cols, jx.valids, live)
    okeys, gkey = gow.window_keys(px.store, px.order_specs, parts)
    porder = gow.window_order(px.store, okeys, gkey)
    # the port's lexsort has no store-position pass; ties (duplicate
    # order keys, equal NaNs) still fall in store order
    np.testing.assert_array_equal(porder.numpy(), np.asarray(jorder))
    cols, valids, _ = gow.window_scan_plain(px.store, porder, gkey,
                                            px.order_specs, px.windows)
    nin = len(px.store.cols)
    n = int(jx.n)
    for j, (w, jo, jv) in enumerate(zip(px.windows, jouts, jvalids)):
        got, gv = cols[nin + j].numpy(), valids[nin + j].numpy()
        want = np.asarray(jo).astype(got.dtype)
        np.testing.assert_array_equal(gv, np.asarray(jv), err_msg=w.kind)
        m = gv[:n]
        if w.kind in ("sum", "avg") and w.arg == 1:
            # a NaN or inf argument: the port keeps it in its partition
            # (a partition-by-partition recount); JAX's global prefix
            # sums agree up to the first partition holding one and turn
            # later partitions' values to NaN (ROADMAP Queue C)
            g = gkey[porder].numpy()[:n]
            x, xv = cols[1].numpy()[:n], valids[1].numpy()[:n]
            ref, rv = _frame_sums_np(x, xv, g, w.kind, w.preceding)
            np.testing.assert_array_equal(gv[:n], rv, err_msg=w.kind)
            scale = np.abs(x[xv & np.isfinite(x)]).sum() + 1.0
            _assert_close_nonfinite(got[:n][m], ref[m], scale, w.kind)
            bad = np.flatnonzero(xv & ~np.isfinite(x))
            assert len(bad), "no NaN or inf argument"
            upto = int(np.flatnonzero(g == g[bad[0]]).max()) + 1
            _assert_close_nonfinite(got[:upto][m[:upto]],
                                    want[:upto][m[:upto]], scale, w.kind)
            later = m[upto:] & np.isfinite(got[upto:n])
            if w.preceding is None:
                assert later.any() and np.isnan(want[upto:n][later]).all()
        elif w.kind in ("sum", "avg") and w.arg == 4:
            scale = np.abs(want[:n][m]).max(initial=0.0) + 1.0
            np.testing.assert_allclose(got[:n][m], want[:n][m], rtol=0,
                                       atol=1e-12 * scale, err_msg=w.kind)
        elif got.dtype == np.float64:
            np.testing.assert_array_equal(got[:n][m].view(np.int64),
                                          want[:n][m].view(np.int64),
                                          err_msg=w.kind)
        else:
            np.testing.assert_array_equal(got[:n][m], want[:n][m],
                                          err_msg=w.kind)
    # the edge cases bite: NULL frames and partition edges
    if case == "int_aggs_all_null_part":
        p0 = cols[0].numpy()[:n] == 0
        assert p0.any() and not valids[nin][:n].numpy()[p0].any()
    if "float" in case:
        o = cols[1].numpy()[:n]
        assert np.isnan(o).any() and (o == 0).any()


# integer arguments only: the flush compares whole rows exactly
LOCKSTEP = {
    "ranks_and_int_aggs": ((0,), [(2, False)], RANKS + INT_AGGS[:5]),
    "offsets_desc": ((0,), [(1, True), (2, False)],
                     [("lag", 3, None, 2), ("lead", 3, None, 1),
                      ("first_value", 1, None, 1), ("lag", 1, None, 1),
                      ("avg", 3, 2, 1), ("dense_rank", None, None, 1)]),
    "one_partition": ((), [(2, False), (1, False)],
                      [("row_number", None, None, 1), ("sum", 3, 1, 1),
                       ("rank", None, None, 1)]),
}


def _changelog(chunk) -> Counter:
    acc = Counter()
    for op, vals in chunk.to_rows():
        key = tuple("nan" if isinstance(x, float) and x != x else x
                    for x in vals)
        acc[(op, key)] += 1
    return acc


def _assert_state_equal(got: dict, want: dict, where: str):
    for k in ("n", "em_n", "errs"):
        assert got[k] == want[k], f"{k} differs {where}"
    for k in ("khash", "em_hash"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=where)
    n, en = want["n"], want["em_n"]
    for k, m in (("cols", n), ("valids", n), ("em_cols", en),
                 ("em_valids", en)):
        for a, b in zip(got[k], want[k]):
            a, b = a[:m], b[:m]
            np.testing.assert_array_equal(
                a.view(np.int64) if a.dtype == np.float64 else a,
                b.view(np.int64) if b.dtype == np.float64 else b,
                err_msg=f"{k} {where}")


@pytest.mark.parametrize("case", sorted(LOCKSTEP))
def test_flush_lockstep_matches_jax(case):
    parts, order, ws = LOCKSTEP[case]
    jx = JaxGOW(_Scripted(_schema(False)), parts, order,
                _specs(ws, False), capacity=256)
    px = PortGOW(_Scripted(_schema(True)), parts, order, _specs(ws, True),
                 capacity=256, device="cpu")
    emitted = 0
    for i, rows in enumerate(_stream(11 + sorted(LOCKSTEP).index(case), 5)):
        jx.on_chunk(_jchunk(rows))
        px.on_chunk(_pchunk(rows))
        jout, pout = jx.flush(), px.flush()
        _assert_state_equal(interop.over_window_state_to_numpy(px),
                            _jax_state(jx), f"after chunk {i}")
        assert _changelog(pout) == _changelog(jout), f"chunk {i}"
        emitted += int(np.asarray(jout.vis).sum())
    st = _jax_state(jx)
    assert emitted > 0 and st["errs"][1] > 0 and st["em_n"] > 0


def test_state_carried_from_jax_continues_alike():
    parts, order, ws = LOCKSTEP["ranks_and_int_aggs"]
    jx = JaxGOW(_Scripted(_schema(False)), parts, order,
                _specs(ws, False), capacity=256)
    chunks = _stream(7, 6)
    for rows in chunks[:3]:
        jx.on_chunk(_jchunk(rows))
        jx.flush()
    px = _port_from(jx, parts, order, ws)
    _assert_state_equal(interop.over_window_state_to_numpy(px),
                        _jax_state(jx), "carried")
    for i, rows in enumerate(chunks[3:]):
        jx.on_chunk(_jchunk(rows))
        px.on_chunk(_pchunk(rows))
        assert _changelog(px.flush()) == _changelog(jx.flush())
        _assert_state_equal(interop.over_window_state_to_numpy(px),
                            _jax_state(jx), f"after chunk {i}")


def test_card_flush_reference_matches_the_cpu_path():
    """`over_window_flush(plain=True)`, what chip_smoke.py holds the card
    against (torch's sorts throughout), equals the CPU path's flush."""
    parts, order, ws = LOCKSTEP["offsets_desc"]
    px = PortGOW(_Scripted(_schema(True)), parts, order, _specs(ws, True),
                 capacity=256, device="cpu")
    for rows in _stream(5, 3):
        px.on_chunk(_pchunk(rows))
    em = (px.em_hash, px.em_cols, px.em_valids, px.em_n)
    a = gow.over_window_flush(px.store, parts, px.order_specs, px.windows,
                              *em)
    b = gow.over_window_flush(px.store, parts, px.order_specs, px.windows,
                              *em, plain=True)
    for x, y in zip([a[0], a[3], *a[4], *a[5], a[6], a[7]],
                    [b[0], b[3], *b[4], *b[5], b[6], b[7]]):
        assert torch.equal(x.view(torch.int64) if x.dtype == torch.float64
                           else x,
                           y.view(torch.int64) if y.dtype == torch.float64
                           else y)


# ---------------------------------------------------------------- loops

def _script(chunks, port: bool, per_barrier: int = 2, wm_col=None):
    msg = pmsg if port else jmsg
    ep = EpochPair if port else JEpochPair
    mk = _pchunk if port else _jchunk
    dt = DataType if port else JDT
    msgs = [msg.Barrier(ep(1 << 16, 0), msg.BarrierKind.INITIAL)]
    e = 1 << 16
    for i, rows in enumerate(chunks):
        msgs.append(mk(rows))
        if wm_col is not None:
            # event time t closes all but the chunk's last quarter
            ts = [r[3] for r in rows]
            msgs.append(msg.Watermark(wm_col, dt.INT64,
                                      int(max(ts)) - CHUNK // 4))
        if i % per_barrier == per_barrier - 1:
            msgs.append(msg.Barrier(ep(e + (1 << 16), e),
                                    msg.BarrierKind.CHECKPOINT))
            e += 1 << 16
    return msgs


async def _drain(ex) -> list:
    return [m async for m in ex.execute()]


def _per_barrier(msgs, chunk_cls) -> list:
    out, cur = [], Counter()
    for m in msgs:
        if isinstance(m, chunk_cls):
            cur += _changelog(m)
        elif type(m).__name__ == "Barrier":
            out.append(cur)
            cur = Counter()
    return out


def test_barrier_loop_with_growth_matches_jax():
    """Through the barrier loop with the watchdog on, a 2^7-slot store
    grows to 2^8 in both engines; per-barrier changelogs equal."""
    parts, order, ws = LOCKSTEP["ranks_and_int_aggs"]
    chunks = _stream(13, 10, miss=False)
    jx = JaxGOW(_Scripted(_schema(False), _script(chunks, False)), parts,
                order, _specs(ws, False), capacity=128)
    px = PortGOW(_Scripted(_schema(True), _script(chunks, True)), parts,
                 order, _specs(ws, True), capacity=128, device="cpu")
    jlog = _per_barrier(asyncio.run(_drain(jx)), JChunk)
    plog = _per_barrier(asyncio.run(_drain(px)), type(_pchunk([])))
    assert len(plog) == len(jlog) == 6 and plog == jlog
    assert px.capacity == jx.capacity == 256
    _assert_state_equal(interop.over_window_state_to_numpy(px),
                        _jax_state(jx), "at the end")


def test_watchdog_fails_stop_on_delete_miss():
    row = (0, 1.0, 1, 1, 1.0, True, True, True)
    chunks = [[(INS, *row[:5], 1, *row[5:]), (DEL, *row[:5], 99, *row[5:])]]
    px = PortGOW(_Scripted(_schema(True), _script(chunks, True, 1)), (0,),
                 [(2, False)], _specs(RANKS[:1], True), capacity=256,
                 device="cpu")
    with pytest.raises(RuntimeError, match="1 deletes matched no row"):
        asyncio.run(_drain(px))


EOWC_WS = [("row_number", None, None, 1), ("sum", 3, None, 1),
           ("lag", 4, None, 1), ("avg", 3, 2, 1)]


def test_eowc_ripeness_and_frontier_match_jax():
    """Append-only rows with an event time (t) and watermarks on it: per
    barrier the port's EOWC executor (its barrier loop) emits the Inserts
    JAX's emits, each row once, and keeps the same frontier; a port
    executor carried from JAX's mid-stream state (store and frontier,
    `interop`) emits what JAX emits next."""
    chunks = _stream(17, 8, ordered_t=True)
    px = PortEowc(_Scripted(_schema(True), _script(chunks, True, wm_col=2)),
                  (0,), [(2, False)], _specs(EOWC_WS, True), capacity=256,
                  device="cpu")
    plog = _per_barrier(asyncio.run(_drain(px)), type(_pchunk([])))
    # JAX step by step, as its barrier loop would drive it
    jx = JaxEowc(_Scripted(_schema(False)), (0,), [(2, False)],
                 _specs(EOWC_WS, False), capacity=256)
    jlog, carried = [Counter()], None
    for i, rows in enumerate(chunks):
        wm = max(r[3] for r in rows) - CHUNK // 4
        jx.on_chunk(_jchunk(rows))
        jx.map_watermark(jmsg.Watermark(2, JDT.INT64, wm))
        if carried is not None:
            carried.on_chunk(_pchunk(rows))
            carried.map_watermark(pmsg.Watermark(2, DataType.INT64, wm))
        if i % 2 == 1:
            jx.check_watchdog()              # grows the store
            jout = jx.flush()
            jlog.append(Counter() if jout is None else _changelog(jout))
            if carried is not None:
                carried.check_watchdog()
                pout = carried.flush()
                assert (Counter() if pout is None else _changelog(pout)) \
                    == jlog[-1], f"carried, chunk {i}"
        if i == 3:
            carried = PortEowc(_Scripted(_schema(True)), (0,), [(2, False)],
                               _specs(EOWC_WS, True), capacity=256,
                               device="cpu")
            interop.over_window_state_from_numpy(carried, **_jax_state(jx))
            interop.eowc_frontier_from_numpy(carried, jx._emitted_to,
                                             jx._wm_pending)
    assert plog == jlog and len(plog) == 5
    total = sum(plog, Counter())
    assert total and all(op == INS for op, _ in total)
    assert max(total.values()) == 1            # each row once
    assert interop.eowc_frontier_to_numpy(px) == dict(
        emitted_to=jx._emitted_to, wm_pending=jx._wm_pending)
    # open rows stay buffered: the gate is not vacuous
    assert int(px.store.n) > sum(total.values())


# --------------------------------------------------------------- durable

PER, ROUNDS, CRASH_AT = 256, 5, 3
Q6 = ("CREATE MATERIALIZED VIEW q6 AS "
      "SELECT Q.seller, Q.id, "
      "avg(Q.final) OVER (PARTITION BY Q.seller ORDER BY Q.id "
      "ROWS BETWEEN 9 PRECEDING AND CURRENT ROW) AS avgf "
      "FROM (SELECT max(B.price) AS final, A.seller, A.id "
      "      FROM auction A JOIN bid B ON A.id = B.auction "
      "        AND B.date_time BETWEEN A.date_time AND A.expires "
      "      GROUP BY A.id, A.seller) Q")
# the EOWC body over bid's integer columns (a durable table of bid's
# VARCHAR columns needs the string dictionary's log, ROADMAP A10)
EOWC = ("CREATE MATERIALIZED VIEW ew AS SELECT auction, date_time, price, "
        "row_number() OVER (PARTITION BY auction ORDER BY date_time) AS rn, "
        "sum(price) OVER (PARTITION BY auction ORDER BY date_time) AS sp "
        "FROM (SELECT auction, date_time, price FROM bid) B "
        "EMIT ON WINDOW CLOSE")


# rows a barrier: q6's auctions run ahead of its bids in event time
PACE = {"q6": {"bid": 4 * PER, "auction": 68}, "ew": {"bid": PER}}


def _durable_ddl(view: str):
    """q6 (1024 bids and the 68 auctions of their event time a barrier)
    or the EOWC body over bids (256 a barrier), durable, small
    capacities."""
    ddl = ["SET streaming_join_capacity = 4096",
           "SET streaming_agg_capacity = 1024",
           "SET streaming_over_window_capacity = 256"]
    pace = PACE[view]
    if view == "q6":
        ddl.append("CREATE SOURCE auction WITH (connector='nexmark', "
                   "table='auction', chunk_size=68, rate_limit=68, "
                   "emit_watermarks=1)")
    ddl.append("CREATE SOURCE bid WITH (connector='nexmark', table='bid', "
               f"chunk_size={pace['bid'] // 2}, rate_limit={pace['bid']}, "
               "emit_watermarks=1, watermark_lag_us=400)")
    ddl.append(Q6 if view == "q6" else EOWC)
    return ddl


@pytest.fixture(scope="module")
def det_epochs():
    """Epochs from a counter in both engines (tests/test_torch_durable.py's
    fixture of the same name)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_bm, port_bm):
            mp.setattr(mod, "next_epoch", lambda prev: prev + (1 << 16))
        yield


def _all_sources(s, name, cls):
    dep = s.catalog.mvs[name].deployment
    found = []
    for roots in dep.roots.values():
        for r in roots:
            stack = [r]
            while stack:
                x = stack.pop()
                if isinstance(x, cls):
                    found.append(x)
                for attr in ("input", "inputs"):
                    v = getattr(x, attr, None)
                    for c in (v if isinstance(v, (list, tuple)) else [v]):
                        if c is not None and hasattr(c, "execute"):
                            stack.append(c)
    return dep, {id(x): x for x in found}.values()


async def _paced(s, name, source_cls, start, stop):
    dep, srcs = _all_sources(s, name, source_cls)
    pace = PACE[name]
    snaps = []
    for r in range(start, stop):
        while any(x.connector.offset < r * pace[x.connector.table]
                  for x in srcs):
            for t in dep.tasks:
                if t.done():
                    t.result()
            await asyncio.sleep(0)
        b = await s.coord.inject_barrier()
        await s.coord.wait_collected(b)
        await s.coord.drain_uploads()
        snaps.append(list(s.store.iter_range(b"", b"")))
    return snaps


def _mv(s, name):
    return sorted(r for _, r in s.catalog.mvs[name].table.iter_all())


@pytest.fixture(scope="module")
def jax_durable(det_epochs, tmp_path_factory):
    """Each view through one JAX session over ROUNDS barriers: the store
    bytes after each and the MV; and a copy of the q6 object store as it
    stood after barrier CRASH_AT, a store abandoned there."""
    out = {}
    for view in ("q6", "ew"):
        path = str(tmp_path_factory.mktemp(f"jw_{view}"))
        part_dir = str(tmp_path_factory.mktemp(f"jwp_{view}") / "store")

        async def go():
            s = JaxSession(store=JaxH(JaxLocalFs(path)))
            for st in _durable_ddl(view):
                await s.execute(st)
            snaps = await _paced(s, view, JaxSource, 1, CRASH_AT + 1)
            shutil.copytree(path, part_dir)
            snaps += await _paced(s, view, JaxSource, CRASH_AT + 1,
                                  ROUNDS + 1)
            return snaps, _mv(s, view)

        out[view] = dict(full=asyncio.run(go()), part_dir=part_dir)
    return out


@pytest.mark.parametrize("view", ["q6", "ew"])
def test_durable_state_equals_jax_after_every_barrier(jax_durable, tmp_path,
                                                      view):
    snaps, mv = jax_durable[view]["full"]

    async def go():
        s = PortSession(device="cpu", store=H(LocalFs(str(tmp_path))))
        for st in _durable_ddl(view):
            await s.execute(st)
        got = await _paced(s, view, PortSource, 1, ROUNDS + 1)
        return got, _mv(s, view)

    got, pmv = asyncio.run(go())
    assert len(got) == len(snaps) == ROUNDS
    for r, (a, b) in enumerate(zip(got, snaps)):
        tables = {int.from_bytes(k[:4], "big") for k, _ in b}
        # q6: two sources, the join's two sides, the agg, the over-window
        # input rows, the MV; EOWC: the source, the input rows, the
        # frontier, the MV
        assert len(tables) == (7 if view == "q6" else 4), tables
        assert a == b, f"state differs after barrier {r + 1}"
    assert pmv == mv and len(mv) > 10


def test_store_written_by_jax_recovers_in_port(jax_durable, tmp_path):
    """JAX ran q6 for CRASH_AT barriers and was abandoned; the port
    recovers its store (the over-window re-applies its stored rows and
    seeds its diff baseline) and runs to the end: the MV equals JAX's
    uninterrupted run; so does the port's own crash and recovery."""
    _, mv = jax_durable["q6"]["full"]

    async def resume(path):
        s = PortSession(device="cpu", store=H.open(LocalFs(path)))
        await s.recover()
        await _paced(s, "q6", PortSource, CRASH_AT + 1, ROUNDS + 1)
        return _mv(s, "q6")

    assert asyncio.run(resume(jax_durable["q6"]["part_dir"])) == mv

    async def first():
        s = PortSession(device="cpu", store=H(LocalFs(str(tmp_path))))
        for st in _durable_ddl("q6"):
            await s.execute(st)
        await _paced(s, "q6", PortSource, 1, CRASH_AT + 1)
        await s.crash()

    asyncio.run(first())
    assert asyncio.run(resume(str(tmp_path))) == mv
