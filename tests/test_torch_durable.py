"""Durable q7 in the port against the JAX package.

Kernels (plain versions on the CPU, inputs made from a seed with numpy):
K17's `diff_plain` against JAX's `SortedJoinExecutor._diff_impl` and
K18's `persist_view_plain` / `evict_keys_plain` against JAX's
`HashAggExecutor._persist_view_impl` / `_evict_keys_impl`, exactly,
duplicate identical rows and NULL lanes included; each packed layout
unpacks to the same rows.

Sessions (bench_q7_kill's statements at a small size: 128-bid chunks,
two a barrier, one bid every 20 ms, so a barrier spans 5.12 s of event
time, under the lag minus the window, where the join counts no delete
miss): epochs come from a counter instead of the wall clock in both
engines, so row ids, and with them every state table, are comparable.
  * after every barrier each state table holds the same key/value bytes
    in both engines, and the CATALOG object is the same bytes;
  * a store the JAX session wrote for N barriers, then crashed, recovers
    in the port's session, which runs M more: its MV equals a JAX run of
    N + M barriers and the numpy recount;
  * the port's own crash(), reopen and recover() gives the same MV.

At bench_q7d's statements with four chunks a barrier, where the delete
misses depend on how far the join is behind, the port's durable and
volatile sessions count what JAX's durable and volatile sessions count.
"""

import asyncio
import types
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest

import risingwave_tpu.meta.barrier_manager as jax_bm
from risingwave_tpu.frontend import Session as JaxSession
from risingwave_tpu.ops.hash_table import HashTable as JaxHT
from risingwave_tpu.state import HummockStateStore as JaxH
from risingwave_tpu.state import LocalFsObjectStore as JaxLocalFs
from risingwave_tpu.stream.hash_agg import AggState as JaxAggState
from risingwave_tpu.stream.hash_agg import HashAggExecutor as JaxHashAgg
from risingwave_tpu.stream.sorted_join import (
    SortedJoinExecutor as JaxSJ, SortedSideState as JaxSide)
from risingwave_tpu.stream.source import SourceExecutor as JaxSource

W = 10_000_000
CS, PER, INTER_US, N, M = 128, 256, 20_000, 4, 4


@pytest.fixture(autouse=True, scope="module")
def _port():
    """Import torch and the port when these tests run, not at
    collection."""
    global torch, chip_smoke, port_bm, sj, ha, d2h, PortSession, H, LocalFs
    global PortSource, NexmarkConfig
    import torch
    import chip_smoke
    import risingwave_tpu_torch.meta.barrier_manager as port_bm
    from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig
    from risingwave_tpu_torch.frontend import Session as PortSession
    from risingwave_tpu_torch.state import HummockStateStore as H
    from risingwave_tpu_torch.state import LocalFsObjectStore as LocalFs
    from risingwave_tpu_torch.stream import SourceExecutor as PortSource
    from risingwave_tpu_torch.stream import hash_agg as ha
    from risingwave_tpu_torch.stream import sorted_join as sj
    from risingwave_tpu_torch.utils import d2h


# ------------------------------------------------------------------ K17

def _side_np(rng, C, n, kinds, null_p=0.0, dup=False):
    kh = rng.integers(0, 1 << 62, C, dtype=np.int64)
    cols, valids = [], []
    for k in kinds:
        if k == "f64":
            cols.append(rng.normal(size=C) * 1e3)
        elif k == "i32":
            cols.append(rng.integers(-100, 100, C).astype(np.int32))
        else:
            cols.append(rng.integers(-50, 50, C, dtype=np.int64))
        valids.append(rng.random(C) >= null_p)
    if dup:                          # every other row repeats the one before
        src = np.arange(C) - (np.arange(C) % 2)
        kh, cols, valids = kh[src], [c[src] for c in cols], \
            [v[src] for v in valids]
    return kh, cols, valids, n


def _mutated(rng, side, frac):
    kh, cols, valids, n = side
    C = kh.shape[0]
    hit = rng.random(C) < frac
    cols = [c.copy() for c in cols]
    cols[0] = np.where(hit, cols[0] + 1, cols[0]).astype(cols[0].dtype)
    roll = rng.integers(0, C)
    return (np.roll(kh, roll), [np.roll(c, roll) for c in cols],
            [np.roll(v, roll) for v in valids], n)


def _jax_side(side):
    kh, cols, valids, n = side
    return JaxSide(jnp.asarray(kh), tuple(jnp.asarray(c) for c in cols),
                   tuple(jnp.asarray(v) for v in valids),
                   jnp.zeros(kh.shape[0], dtype=jnp.int32),
                   jnp.asarray(n, dtype=jnp.int32))


def _port_side(side):
    kh, cols, valids, n = side
    return sj.SortedSideState(
        torch.from_numpy(kh), tuple(torch.from_numpy(c) for c in cols),
        tuple(torch.from_numpy(v) for v in valids),
        torch.zeros(kh.shape[0], dtype=torch.int32),
        torch.tensor(n, dtype=torch.int32))


DIFF_CASES = {
    "mixed": dict(kinds=("i64", "i64", "i64"), frac=0.2),
    "empty": dict(kinds=("i64", "i64"), frac=0.0),
    "duplicates": dict(kinds=("i64", "i64"), frac=0.3, dup=True),
    "nulls": dict(kinds=("i64", "i32", "i64"), frac=0.2, null_p=0.4),
    "float64": dict(kinds=("i64", "f64"), frac=0.2),
    "full": dict(kinds=("i64", "i64"), frac=0.1, full=True),
}


@pytest.mark.parametrize("case", sorted(DIFF_CASES))
def test_k17_plain_matches_jax_diff(case):
    p = DIFF_CASES[case]
    rng = np.random.default_rng(sorted(DIFF_CASES).index(case))
    C = 512
    n = C if p.get("full") else 300
    snap = _side_np(rng, C, n, p["kinds"], p.get("null_p", 0.0),
                    p.get("dup", False))
    cur = (_mutated(rng, snap, p["frac"]) if p["frac"] else snap)
    ns = types.SimpleNamespace(_row_lanes=JaxSJ._row_lanes)
    jd, jnd, ji, jni = JaxSJ._diff_impl(ns, _jax_side(cur), _jax_side(snap))
    pd, pnd, pi, pni = sj.diff_plain(_port_side(cur), _port_side(snap))
    assert int(pnd) == int(jnd) and int(pni) == int(jni)
    for a, b in zip(pd + pi, jd + ji):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if case == "empty":
        assert int(pnd) == int(pni) == 0
    else:
        assert int(pnd) > 0 and int(pni) > 0
    # the packed layout K17 writes: deletes' rows, then inserts'
    packed, counts = sj.pack_diff_plain(_port_side(cur), _port_side(snap))
    nd, ni = (int(x) for x in counts)
    rows = d2h.unpack_rows(packed.numpy(), nd + ni,
                           [c.dtype for c in cur[1]])
    for r, a, b in zip(rows, jd, ji):
        np.testing.assert_array_equal(
            r, np.concatenate([np.asarray(a)[:nd], np.asarray(b)[:ni]]))


# ------------------------------------------------------------------ K18

def _agg_np(rng, C, n_keys=1):
    occ = rng.random(C) < 0.6
    keys = [np.where(occ, rng.integers(0, 40, C), 0).astype(np.int64)
            for _ in range(n_keys)]
    rc = np.where(occ, rng.integers(0, 3, C), 0).astype(np.int64)
    return dict(keys=keys, occ=occ,
                states=[rng.integers(-99, 99, C, dtype=np.int64),
                        rng.normal(size=C)],
                rc=rc, dirty=occ & (rng.random(C) < 0.5),
                prev=occ & (rng.random(C) < 0.5))


def _jax_agg(a):
    return JaxAggState(
        JaxHT(tuple(jnp.asarray(k) for k in a["keys"]),
              jnp.asarray(a["occ"])),
        tuple(jnp.asarray(s) for s in a["states"]), jnp.asarray(a["rc"]),
        jnp.asarray(a["dirty"]), jnp.asarray(a["prev"]),
        tuple(jnp.zeros_like(jnp.asarray(s)) for s in a["states"]))


def _port_agg(a):
    from risingwave_tpu_torch.ops.hash_table import HashTable
    t = torch.from_numpy
    return ha.AggState(
        HashTable(tuple(t(k) for k in a["keys"]), t(a["occ"])),
        tuple(t(s) for s in a["states"]), t(a["rc"]), t(a["dirty"]),
        t(a["prev"]), tuple(torch.zeros_like(t(s)) for s in a["states"]))


@pytest.mark.parametrize("wm", [20, -1, 1 << 40])
def test_k18_plain_matches_jax_persist_and_evict(wm):
    rng = np.random.default_rng(wm & 0xFFFF)
    a = _agg_np(rng, 256, n_keys=2)
    ns = types.SimpleNamespace(_retractable=(False, False), minput_k=32,
                               cleaning_watermark_key=1)
    ns._durable_cols_at = lambda st, sel: JaxHashAgg._durable_cols_at(
        ns, st, sel)
    jc, jops, jvis, jnd = JaxHashAgg._persist_view_impl(ns, _jax_agg(a))
    pc, pops, pvis, pnd = ha.persist_view_plain(_port_agg(a))
    assert int(pnd) == int(jnd) > 0
    for x, y in zip([pops, pvis, *pc], [jops, jvis, *jc]):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    jk, jn = JaxHashAgg._evict_keys_impl(ns, _jax_agg(a), wm)
    pk, pn = ha.evict_keys_plain(_port_agg(a), 1, wm)
    assert int(pn) == int(jn)
    assert (int(pn) == 0) == (wm < 0)
    for x, y in zip(pk, jk):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    # the packed buffer: persist rows (ops, vis, keys, states, row count),
    # then the evicted keys
    buf, counts = ha.persist_pack_plain(_port_agg(a), 1, wm)
    nd, nev = (int(x) for x in counts)
    dts = [np.int8, bool, np.int64, np.int64, np.int64, np.float64,
           np.int64]
    rows = d2h.unpack_rows(buf.numpy(), nd, dts)
    for r, y in zip(rows, [jops, jvis, *jc]):
        np.testing.assert_array_equal(r, np.asarray(y)[:nd])
    ev = d2h.unpack_rows(buf.numpy()[nd * len(dts):], nev,
                         [np.int64, np.int64])
    for r, y in zip(ev, jk):
        np.testing.assert_array_equal(r, np.asarray(y)[:nev])


def test_k18_plain_matches_jax_with_extrema_buffers():
    """K18's persist view over a COUNT beside a retractable MAX (K = 4):
    the buffer's values, counts (widened) and lossy flag as 2K + 1
    columns, as JAX's `_durable_cols_at` lays them out, also packed."""
    rng = np.random.default_rng(3)
    C, K = 128, 4
    a = _agg_np(rng, C)
    vals = np.sort(rng.integers(-50, 50, (C, K)), axis=1)[:, ::-1].copy()
    cnts = rng.integers(0, 3, (C, K)).astype(np.int32)
    lossy = rng.random(C) < 0.3
    a["states"] = [a["states"][0], (vals, cnts, lossy)]
    ns = types.SimpleNamespace(_retractable=(False, True), minput_k=K)
    ns._durable_cols_at = lambda st, sel: JaxHashAgg._durable_cols_at(
        ns, st, sel)
    ja = _jax_agg(dict(a, states=[a["states"][0], 0]))
    ja.agg_states = (ja.agg_states[0], tuple(jnp.asarray(x)
                                             for x in (vals, cnts, lossy)))
    pa = _port_agg(dict(a, states=[a["states"][0], vals]))
    pa.agg_states = (pa.agg_states[0], tuple(torch.from_numpy(x)
                                             for x in (vals, cnts, lossy)))
    jc, jops, jvis, jnd = JaxHashAgg._persist_view_impl(ns, ja)
    pc, pops, pvis, pnd = ha.persist_view_plain(pa)
    assert int(pnd) == int(jnd) > 0 and len(pc) == len(jc) == 1 + 1 + 9 + 1
    for x, y in zip([pops, pvis, *pc], [jops, jvis, *jc]):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    buf, counts = ha.persist_pack_plain(pa, None, None)
    nd = int(counts[0])
    dts = [np.int8, bool] + [np.int64] * (1 + 1 + 2 * K + 1 + 1)
    for r, y in zip(d2h.unpack_rows(buf.numpy(), nd, dts),
                    [jops, jvis, *jc]):
        np.testing.assert_array_equal(r, np.asarray(y)[:nd])


# ------------------------------------------------------------- sessions

def _ddl():
    """bench_q7_kill's statements with CS-bid chunks, one bid every
    INTER_US and a PER-row rate limit (the pacing rides the catalog into
    a recovery)."""
    return [st.replace("rate_limit=65536", f"rate_limit={PER}")
            .replace("inter_event_us=250,", f"inter_event_us={INTER_US},")
            for st in chip_smoke.with_chunk(
                chip_smoke.Q7K_DDL, chip_smoke.Q7K_CHUNK, CS)]


def _walk(dep, cls):
    out = []
    for roots in dep.roots.values():
        for r in roots:
            node = r
            while node is not None:
                if isinstance(node, cls):
                    out.append(node)
                node = getattr(node, "input", None)
    return out


async def _paced(s, source_cls, start, stop, name="q7"):
    """Barriers start..stop-1, barrier r once the source emitted
    r * PER bids (its rate limit is PER a barrier); a snapshot of the
    whole store after each, uploads drained."""
    dep = s.catalog.mvs[name].deployment
    src = _walk(dep, source_cls)[0]
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


def _mv(s, name="q7"):
    return sorted(r for _, r in s.catalog.mvs[name].table.iter_all())


def _mv_committed(s, name):
    """The MV's rows as the store holds them after its last commit, in
    either engine: a chunk the sources emit after the last barrier may
    reach the MV's mem-table before the read, at a moment that differs
    from run to run."""
    t = s.catalog.mvs[name].table
    rows = []
    for vn in np.flatnonzero(t.vnode_bitmap):
        start, end = t.vnode_key_range(int(vn))
        rows += [t._serde.decode(v) for _, v in t.store.iter_range(start,
                                                                   end)]
    return sorted(rows)


def _jax_session(path, rounds, crash=False):
    async def go():
        s = JaxSession(store=JaxH(JaxLocalFs(path)))
        for st in _ddl():
            await s.execute(st)
        snaps = await _paced(s, JaxSource, 1, rounds + 1)
        mv = _mv(s)
        catalog = s.store.objects.read("CATALOG")
        if crash:
            await s.crash()
        return snaps, mv, catalog
    return asyncio.run(go())


@pytest.fixture(scope="module")
def det_epochs():
    """Epochs from a counter in both engines (row ids derive from them)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_bm, port_bm):
            mp.setattr(mod, "next_epoch", lambda prev: prev + (1 << 16))
        yield


@pytest.fixture(scope="module")
def jax_runs(det_epochs, tmp_path_factory):
    full = _jax_session(str(tmp_path_factory.mktemp("jfull")), N + M)
    part_dir = str(tmp_path_factory.mktemp("jpart"))
    _jax_session(part_dir, N, crash=True)
    return dict(full=full, part_dir=part_dir)


def _recount():
    return chip_smoke.q7_recount((N + M) * PER,
                                 NexmarkConfig(inter_event_us=INTER_US),
                                 "cpu")


def test_state_tables_equal_jax_after_every_barrier(jax_runs, tmp_path):
    snaps, mv, catalog = jax_runs["full"]

    async def go():
        s = PortSession(device="cpu",
                        store=H(LocalFs(str(tmp_path / "p"))))
        for st in _ddl():
            await s.execute(st)
        got = await _paced(s, PortSource, 1, N + M + 1)
        return got, _mv(s), s.store.objects.read("CATALOG"), \
            s.catalog.mvs["q7"].deployment
    got, pmv, pcat, dep = asyncio.run(go())
    assert len(got) == len(snaps) == N + M
    for r, (a, b) in enumerate(zip(got, snaps)):
        tables = {int.from_bytes(k[:4], "big") for k, _ in b}
        # source offsets, agg, both join sides, the MV
        assert tables == {1, 2, 3, 4, 5}, tables
        assert a == b, f"state differs after barrier {r + 1}"
    assert pmv == mv and pcat == catalog
    join = dep.executors(sj.SortedJoinExecutor)[0]
    assert join.errs() == [0, 0, 0] and join.persist_rows > 0
    assert chip_smoke.q7_delete_misses(
        (N + M) * PER, PER, NexmarkConfig(inter_event_us=INTER_US),
        "cpu") == 0


def test_store_written_by_jax_recovers_in_port(jax_runs):
    _, mv, _ = jax_runs["full"]

    async def go():
        s = PortSession(device="cpu",
                        store=H.open(LocalFs(jax_runs["part_dir"])))
        await s.recover()
        await _paced(s, PortSource, N + 1, N + M + 1)
        return _mv(s)
    got = asyncio.run(go())
    assert got == mv
    assert chip_smoke.mv_counter(got) == _recount() and len(got) >= 3


def test_port_crash_and_recover(jax_runs, tmp_path):
    _, mv, _ = jax_runs["full"]
    path = str(tmp_path / "p")

    async def first():
        s = PortSession(device="cpu", store=H(LocalFs(path)))
        for st in _ddl():
            await s.execute(st)
        await _paced(s, PortSource, 1, N + 1)
        await s.crash()

    async def second():
        s = PortSession(device="cpu", store=H.open(LocalFs(path)))
        await s.recover()
        await _paced(s, PortSource, N + 1, N + M + 1)
        return _mv(s)

    asyncio.run(first())
    assert asyncio.run(second()) == mv


def _short_barrier_ddl(per):
    """bench_q7d's statements at 128-bid chunks that span as much event
    time as q7d's 32768-bid ones (8.9 s), the source throttled to `per`
    bids between barriers."""
    out = []
    for st in chip_smoke.with_chunk(chip_smoke.Q7D_DDL, chip_smoke.Q7D_CHUNK,
                                    CS):
        st = st.replace("inter_event_us=250,", "inter_event_us=64000,")
        st = st.replace(f"streaming_join_capacity = {1 << 18}",
                        "streaming_join_capacity = 4096")
        if st.startswith("CREATE SOURCE"):
            st = st[:-1] + f", rate_limit={per})"
        out.append(st)
    return out


def _jax_join_errs(ddl, per, rounds, store):
    """The JAX session's join error counters after `rounds` barriers
    paced like chip_smoke.session_run (the last one the Stop barrier)."""
    async def go():
        s = JaxSession(store=store)
        for st in ddl:
            await s.execute(st)
        dep = s.catalog.sinks["q7"].deployment
        src = _walk(dep, JaxSource)[0]
        join = _walk(dep, JaxSJ)[0]
        for r in range(1, rounds + 1):
            while src.connector.offset < r * per:
                await asyncio.sleep(0)
            if r < rounds:
                b = await s.coord.inject_barrier()
                await s.coord.wait_collected(b)
            else:
                await s.coord.stop_all({a.actor_id for a in dep.actors})
        await asyncio.gather(*dep.tasks)
        return [int(x) for x in np.asarray(join._errs_dev)]
    return asyncio.run(go())


def test_q7_misses_at_short_barriers_match_jax(tmp_path):
    """Four 8.9 s chunks a barrier (35.6 s of event time, q7d's geometry
    at 4 chunks): the join applies the agg's update for a straddling
    window before it has read the epoch's last left watermarks, so
    fewer deletes miss than straddling windows whose max rises, and
    q7_delete_misses refuses to predict the count. The port's durable
    session counts what its volatile session and the JAX package's
    durable and volatile sessions count."""
    per, rounds = 4 * CS, 8
    ddl = _short_barrier_ddl(per)
    port = [chip_smoke.session_run("cpu", d, rounds, per, store=st)["join"]
            .errs() for d, st in (
                (ddl, H(LocalFs(str(tmp_path / "p")))),
                (chip_smoke.volatile(ddl), None))]
    jax = [_jax_join_errs(ddl, per, rounds,
                          JaxH(JaxLocalFs(str(tmp_path / "j")))),
           _jax_join_errs(chip_smoke.volatile(ddl), per, rounds, None)]
    assert port + jax == [port[0]] * 4 and port[0][0::2] == [0, 0]
    cfg = NexmarkConfig(inter_event_us=64000)
    assert port[0][1] < chip_smoke.q7_rising_straddles(per * rounds, per,
                                                       cfg, "cpu")
    with pytest.raises(ValueError, match="how far the join is behind"):
        chip_smoke.q7_delete_misses(per * rounds, per, cfg, "cpu")


def test_durable_varchar_table_raises(tmp_path):
    """The string dictionary's durable log is not ported: a durable
    table holding a VARCHAR column refuses to build rather than persist
    dictionary ids no later incarnation could decode."""
    async def go():
        s = PortSession(device="cpu",
                        store=H(LocalFs(str(tmp_path / "p"))))
        await s.execute("CREATE SOURCE person WITH (connector='nexmark', "
                        "table='person', chunk_size=64)")
        with pytest.raises(NotImplementedError, match="VARCHAR"):
            await s.execute("CREATE MATERIALIZED VIEW m AS "
                            "SELECT id, name FROM person")
    asyncio.run(go())


# ------------------------------------------------------ canonical q5

def _q5c_ddl():
    """The canonical Nexmark q5 (chip_smoke.Q5C_SELECT), durable, at
    CS-bid chunks of one bid every 2 ms and PER bids a barrier, 2^12-slot
    aggs (K = 32 top-K buffers in the MaxBids agg) and join sides."""
    ddl = chip_smoke.q5c_ddl(CS, durable_=1, agg_cap=1 << 12,
                             join_cap=1 << 12)
    return [st.replace("inter_event_us=2)",
                       f"inter_event_us=2000, rate_limit={PER})")
            for st in ddl]


def _q5c_session(engine, path, start, stop, crash=False, recover=False):
    async def go():
        if engine == "jax":
            s = JaxSession(store=JaxH.open(JaxLocalFs(path)) if recover
                           else JaxH(JaxLocalFs(path)))
        else:
            s = PortSession(device="cpu", store=H.open(LocalFs(path))
                            if recover else H(LocalFs(path)))
        if recover:
            await s.recover()
        else:
            for st in _q5c_ddl():
                await s.execute(st)
        snaps = await _paced(s, JaxSource if engine == "jax" else PortSource,
                             start, stop, name="q5c")
        mv = _mv(s, "q5c")
        if crash:
            await s.crash()
        elif engine == "port":
            await s.shutdown()
        return snaps, mv
    return asyncio.run(go())


def test_durable_q5c_state_and_recovery_match_jax(det_epochs, tmp_path):
    """The canonical q5, durable: after every barrier each state table
    (two COUNT aggs, the MaxBids agg's 65-lane buffer rows, both join
    sides, the MV, the source) holds the same bytes in both engines; the
    port's crash(), reopen and recover() ends at JAX's uninterrupted
    MV."""
    jsnaps, jmv = _q5c_session("jax", str(tmp_path / "j"), 1, N + M + 1)
    psnaps, pmv = _q5c_session("port", str(tmp_path / "p"), 1, N + M + 1)
    assert len(psnaps) == len(jsnaps) == N + M
    for r, (a, b) in enumerate(zip(psnaps, jsnaps)):
        assert a == b, f"state differs after barrier {r + 1}"
    tables = {int.from_bytes(k[:4], "big") for k, _ in jsnaps[-1]}
    assert len(tables) >= 6
    assert pmv == jmv and len(jmv) >= 3
    path = str(tmp_path / "c")
    _q5c_session("port", path, 1, N + 1, crash=True)
    _, rmv = _q5c_session("port", path, N + 1, N + M + 1, recover=True)
    assert rmv == jmv


# --------------------------------------------------- durable LEFT join

LJ_DDL = [
    "SET streaming_join_capacity = 4096",
    ("CREATE SOURCE auction WITH (connector='nexmark', table='auction', "
     "chunk_size=128, rate_limit=256)"),
    # persons lag the auctions in event time: an auction's seller often
    # arrives barriers later and retracts the auction's NULL row
    ("CREATE SOURCE person WITH (connector='nexmark', table='person', "
     "chunk_size=32, rate_limit=32)"),
    ("CREATE MATERIALIZED VIEW lj AS SELECT A.id, P.id AS pid "
     "FROM auction A LEFT OUTER JOIN person P "
     "ON A.seller = P.id AND A.category = 10"),
]


def _lj_session(engine, path, start, stop, crash=False, recover=False):
    """The durable LEFT join (tests/test_outer_join_sql.py's view, ids
    only), barriers start..stop-1, barrier r once every source emitted r
    times its rate limit; a snapshot of the store after each."""
    async def go():
        if engine == "jax":
            s = JaxSession(store=JaxH.open(JaxLocalFs(path)) if recover
                           else JaxH(JaxLocalFs(path)))
        else:
            s = PortSession(device="cpu", store=H.open(LocalFs(path))
                            if recover else H(LocalFs(path)))
        if recover:
            await s.recover()
        else:
            for st in LJ_DDL:
                await s.execute(st)
        dep = s.catalog.mvs["lj"].deployment
        srcs = _walk(dep, JaxSource if engine == "jax" else PortSource)
        rate = {"auction": 256, "person": 32}
        snaps = []
        for r in range(start, stop):
            while any(x.connector.offset < r * rate[x.connector.table]
                      for x in srcs):
                for t in dep.tasks:
                    if t.done():
                        t.result()
                await asyncio.sleep(0)
            b = await s.coord.inject_barrier()
            await s.coord.wait_collected(b)
            await s.coord.drain_uploads()
            snaps.append(list(s.store.iter_range(b"", b"")))
        mv = _mv_committed(s, "lj")
        if crash:
            await s.crash()
        elif engine == "port":
            await s.shutdown()
        return snaps, mv
    return asyncio.run(go())


def test_durable_left_join_state_and_recovery_match_jax(det_epochs,
                                                        tmp_path):
    """A durable LEFT join: after every barrier both join sides' state
    tables, the sources' and the MV hold the same bytes in both engines
    (degrees are not persisted); the port's crash at barrier N, reopen
    and recover() (which rebuilds both sides' degrees by replay) ends at
    JAX's uninterrupted MV, NULL-row retractions after the recovery
    included."""
    jsnaps, jmv = _lj_session("jax", str(tmp_path / "j"), 1, N + M + 1)
    psnaps, pmv = _lj_session("port", str(tmp_path / "p"), 1, N + M + 1)
    assert len(psnaps) == len(jsnaps) == N + M
    for r, (a, b) in enumerate(zip(psnaps, jsnaps)):
        assert a == b, f"state differs after barrier {r + 1}"
    tables = {int.from_bytes(k[:4], "big") for k, _ in jsnaps[-1]}
    assert len(tables) == 5, tables
    assert pmv == jmv and any(r[1] is None for r in jmv) \
        and any(r[1] is not None for r in jmv)
    path = str(tmp_path / "c")
    _, cmv = _lj_session("port", path, 1, N + 1, crash=True)
    _, rmv = _lj_session("port", path, N + 1, N + M + 1, recover=True)
    assert rmv == jmv
    # rows NULL-padded at the crash that matched after the recovery: only
    # a rebuilt degree retracts their NULL rows
    null_then = {r[0] for r in cmv if r[1] is None}
    assert null_then & {r[0] for r in rmv if r[1] is not None}


# ------------------------------------------- durable approx_count_distinct

ACD_VIEWS = {"acd": "ACD_SELECT", "q15_wide": "Q15_WIDE_SELECT"}


def _acd_ddl(view="acd"):
    """chip_smoke.ACD_SELECT (approx_count_distinct, bool_and, bool_or,
    max, min per auction; coalesce and greatest above) or
    Q15_WIDE_SELECT (76 agg calls, 72 of them in eight sketches),
    durable, at CS-bid chunks and PER bids a barrier, a 2^12-slot
    agg."""
    return [
        "SET streaming_durability = 1",
        "SET streaming_agg_capacity = 4096",
        ("CREATE SOURCE bid WITH (connector='nexmark', table='bid', "
         f"chunk_size={CS}, rate_limit={PER})"),
        "CREATE MATERIALIZED VIEW acd AS "
        + getattr(chip_smoke, ACD_VIEWS[view])]


def _acd_session(engine, path, start, stop, crash=False, recover=False,
                 view="acd"):
    async def go():
        if engine == "jax":
            s = JaxSession(store=JaxH.open(JaxLocalFs(path)) if recover
                           else JaxH(JaxLocalFs(path)))
        else:
            s = PortSession(device="cpu", store=H.open(LocalFs(path))
                            if recover else H(LocalFs(path)))
        if recover:
            await s.recover()
        else:
            for st in _acd_ddl(view):
                await s.execute(st)
        snaps = await _paced(s, JaxSource if engine == "jax" else PortSource,
                             start, stop, name="acd")
        mv = _mv_committed(s, "acd")
        if crash:
            await s.crash()
        elif engine == "port":
            await s.shutdown()
        return snaps, mv
    return asyncio.run(go())


@pytest.mark.parametrize("view", sorted(ACD_VIEWS))
def test_durable_acd_state_and_recovery_match_jax(det_epochs, tmp_path,
                                                  view):
    """approx_count_distinct durable: after every barrier the agg's state
    table (keys; 16 calls of which 8 HLL register words, or q15_wide's
    76 of which 72, past one K18 launch's 64 column groups on the card;
    row count), the MV and the source hold the same bytes in both
    engines; the port's crash(), reopen and recover() ends at JAX's
    uninterrupted MV."""
    kw = dict(view=view)
    jsnaps, jmv = _acd_session("jax", str(tmp_path / "j"), 1, N + M + 1,
                               **kw)
    psnaps, pmv = _acd_session("port", str(tmp_path / "p"), 1, N + M + 1,
                               **kw)
    assert len(psnaps) == len(jsnaps) == N + M
    for r, (a, b) in enumerate(zip(psnaps, jsnaps)):
        assert a == b, f"state differs after barrier {r + 1}"
    est = 2 if view == "acd" else 5             # an estimate column
    assert pmv == jmv and len(jmv) >= (10 if view == "acd" else 1)
    assert any(r[est] > 1 for r in jmv)         # estimates past one
    path = str(tmp_path / "c")
    _acd_session("port", path, 1, N + 1, crash=True, **kw)
    _, rmv = _acd_session("port", path, N + 1, N + M + 1, recover=True,
                          **kw)
    assert rmv == jmv


# ------------------------------------------------------------ MV-on-MV

def _mvmv_ddl():
    """chip_smoke's mv_agg durable (all-integer columns) at CS-bid chunks
    and PER bids a barrier, a 2^12-slot agg."""
    return [
        "SET streaming_durability = 1",
        "SET streaming_agg_capacity = 4096",
        ("CREATE SOURCE bid WITH (connector='nexmark', table='bid', "
         f"chunk_size={CS}, rate_limit={PER})"),
        f"CREATE MATERIALIZED VIEW mv_agg AS {chip_smoke.MVMV_AGG_SELECT}"]


MVMV_AT = 3          # paced barriers of mv_agg before mv_hot is created


def _mvmv_session(engine, mp, path, stop, crash_at=None, recover_at=None):
    """mv_agg over paced bids and, from barrier MVMV_AT + 1 (its
    bring-up barrier, at a known offset), mv_hot over it, backfilled two
    rows a barrier; barriers up to `stop`, a snapshot of the whole store
    after each from mv_hot's bring-up on. With `crash_at` the session
    crashes after that barrier; with `recover_at` (the barrier it
    crashed after) it replays the store's catalog and runs on."""
    if engine == "jax":
        from risingwave_tpu.stream.backfill import BackfillExecutor as BF
        S, Store, Fs, Src = JaxSession, JaxH, JaxLocalFs, JaxSource
        mk = {}
    else:
        from risingwave_tpu_torch.stream.backfill import (
            BackfillExecutor as BF)
        S, Store, Fs, Src = PortSession, H, LocalFs, PortSource
        mk = {"device": "cpu"}
    init = BF.__init__

    def small(self, *a, **kw):
        kw["batch_rows"] = 2
        init(self, *a, **kw)
    mp.setattr(BF, "__init__", small)

    async def go():
        snaps = []
        if recover_at is not None:
            s = S(store=Store.open(Fs(path)), **mk)
            await s.recover()
            start = recover_at + 1
        else:
            s = S(store=Store(Fs(path)), **mk)
            for st in _mvmv_ddl():
                await s.execute(st)
            snaps += await _paced(s, Src, 1, MVMV_AT + 1, name="mv_agg")
            src = _walk(s.catalog.mvs["mv_agg"].deployment, Src)[0]
            while src.connector.offset < (MVMV_AT + 1) * PER:
                await asyncio.sleep(0)
            await s.execute("CREATE MATERIALIZED VIEW mv_hot AS "
                            + chip_smoke.MVMV_HOT_SELECT)
            await s.coord.drain_uploads()
            snaps.append(list(s.store.iter_range(b"", b"")))
            start = MVMV_AT + 2
        end = (crash_at if crash_at is not None else stop) + 1
        snaps += await _paced(s, Src, start, end, name="mv_agg")
        bfs = _walk(s.catalog.mvs["mv_hot"].deployment, BF)
        rows = {n: _mv_committed(s, n) for n in ("mv_agg", "mv_hot")}
        done = [bf.finished for bf in bfs]
        if crash_at is not None:
            await s.crash()
        elif engine == "port":
            await s.shutdown()
        return snaps, rows, done
    return asyncio.run(go())


def test_durable_mv_on_mv_state_and_mid_backfill_recovery_match_jax(
        det_epochs, tmp_path, monkeypatch):
    """mv_hot over mv_agg, durable: after every barrier the whole store
    (the backfill's progress table, both MVs, the agg and the source)
    holds the same bytes in both engines, during the backfill and after
    it; the port's crash() in the middle of the backfill, reopen and
    recover() resumes from the persisted progress and ends at JAX's
    uninterrupted MVs, mv_hot equal to the recount over mv_agg."""
    stop = MVMV_AT + 12
    with monkeypatch.context() as mp:
        jsnaps, jrows, jdone = _mvmv_session("jax", mp, str(tmp_path / "j"),
                                             stop)
    with monkeypatch.context() as mp:
        psnaps, prows, pdone = _mvmv_session("port", mp,
                                             str(tmp_path / "p"), stop)
    assert len(psnaps) == len(jsnaps) == stop
    for r, (a, b) in enumerate(zip(psnaps, jsnaps)):
        assert a == b, f"state differs after barrier {r + 1}"
    tables = {int.from_bytes(k[:4], "big") for k, _ in jsnaps[-1]}
    assert len(tables) == 5, tables   # source, agg, 2 MVs, progress
    assert prows == jrows and pdone == jdone == [True]
    hot, _ = chip_smoke.mvmv_recount(jrows["mv_agg"])
    assert Counter(tuple(r) for r in jrows["mv_hot"]) == hot and hot
    # a crash in the middle of the backfill, then recovery
    path = str(tmp_path / "c")
    crash_at = MVMV_AT + 3
    with monkeypatch.context() as mp:
        _, _, mid = _mvmv_session("port", mp, path, stop, crash_at=crash_at)
        assert mid == [False], "the crash must land mid-backfill"
        _, rrows, rdone = _mvmv_session("port", mp, path, stop,
                                        recover_at=crash_at)
    assert rrows == jrows and rdone == [True]


def test_refused_mv_on_mv_leaves_upstream_ticking(tmp_path):
    """A durable MV over mv_agg with a VARCHAR column is refused at
    build, after its stream scan was built: no channel of it is left on
    mv_agg's tap, and mv_agg runs on through more barriers than that
    channel could hold (its root would block on it)."""
    async def go():
        s = PortSession(device="cpu", store=H(LocalFs(str(tmp_path / "p"))))
        for st in _mvmv_ddl():
            await s.execute(st)
        await s.tick(2)
        s.env.channel_capacity = 2
        with pytest.raises(NotImplementedError, match="VARCHAR"):
            await s.execute("CREATE MATERIALIZED VIEW v AS "
                            "SELECT auction, 'x' AS t FROM mv_agg")
        up = s.catalog.mvs["mv_agg"]
        assert up.tap.channels == [] and set(s.catalog.mvs) == {"mv_agg"}
        before = len(_mv_committed(s, "mv_agg"))
        await asyncio.wait_for(s.tick(6), timeout=60)
        after = len(_mv_committed(s, "mv_agg"))
        await s.shutdown()
        return before, after
    before, after = asyncio.run(go())
    assert 0 < before < after
