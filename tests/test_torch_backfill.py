"""The port's vnode, backfill filter, StorageTable and BackfillExecutor
against the JAX package's.

Kernel K31 runs here as its plain versions (inputs made from a numpy
seed): `compute_vnodes_plain` against JAX's jitted `compute_vnodes` and
`compute_vnodes_numpy` over every key type and the widening hazards
(negative int32/int16/int8 zero-extended, -0.0 and +0.0 and NaN payloads
hashed by their bits, bools), bit for bit; `backfill_filter_plain`
against JAX's jitted `_filter_impl` on hazard chunks: frontiers at vnode
edges, `has_pk` both ways, -0.0 and NaN in the pk and in the frontier,
invisible rows, one to three key columns. The chunks hold no subnormal
float: XLA's CPU may flush one to zero in the compare, the port follows
IEEE (ROADMAP accepted difference 7).

StorageTable.scan_vnode_after reads the same rows as JAX's from the same
writes, on the in-memory store and on Hummock with sealed-but-uncommitted
batches, for every `max_epoch` bound. The BackfillExecutor runs in
lockstep with JAX's (tests/test_backfill.py's resume-mid-scan and
live-filter cases): the same messages in, the same rows out per barrier,
the same progress rows in the state table.
"""

import asyncio
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from risingwave_tpu.common import DataType as JDT
from risingwave_tpu.common import schema as jschema
from risingwave_tpu.common.chunk import StreamChunk as JChunk
from risingwave_tpu.common.epoch import EpochPair as JEpochPair
from risingwave_tpu.common.vnode import compute_vnodes as jax_vnodes
from risingwave_tpu.common.vnode import compute_vnodes_numpy
from risingwave_tpu.state import HummockStateStore as JHummock
from risingwave_tpu.state import InMemObjectStore as JInMem
from risingwave_tpu.state import MemoryStateStore as JMem
from risingwave_tpu.state import StateTable as JStateTable
from risingwave_tpu.state import StorageTable as JStorage
from risingwave_tpu.stream import Barrier as JBarrier
from risingwave_tpu.stream import BarrierKind as JKind
from risingwave_tpu.stream.backfill import BackfillExecutor as JBackfill
from risingwave_tpu.stream.backfill import (
    backfill_progress_schema as j_progress_schema)
from risingwave_tpu.stream.executor import Executor as JExecutor

N = 256


@pytest.fixture(autouse=True, scope="module")
def _port():
    """Import torch and the port when these tests run, not at
    collection."""
    global torch, DT, schema, PChunk, PEpochPair, vnode, PMem, PHummock
    global PInMem, PStateTable, PStorage, PBarrier, PKind, PBackfill
    global p_progress_schema, PExecutor, chunk_from_numpy
    import torch
    from risingwave_tpu_torch.common import DataType as DT
    from risingwave_tpu_torch.common import schema
    from risingwave_tpu_torch.common import vnode
    from risingwave_tpu_torch.common.chunk import StreamChunk as PChunk
    from risingwave_tpu_torch.common.epoch import EpochPair as PEpochPair
    from risingwave_tpu_torch.interop import chunk_from_numpy
    from risingwave_tpu_torch.state import HummockStateStore as PHummock
    from risingwave_tpu_torch.state import InMemObjectStore as PInMem
    from risingwave_tpu_torch.state import MemoryStateStore as PMem
    from risingwave_tpu_torch.state import StateTable as PStateTable
    from risingwave_tpu_torch.state.storage_table import (
        StorageTable as PStorage)
    from risingwave_tpu_torch.stream import Barrier as PBarrier
    from risingwave_tpu_torch.stream import BarrierKind as PKind
    from risingwave_tpu_torch.stream.backfill import (
        BackfillExecutor as PBackfill,
        backfill_progress_schema as p_progress_schema)
    from risingwave_tpu_torch.stream.executor import Executor as PExecutor


# ----------------------------------------------------------- the columns

def _hazard_columns(seed: int) -> dict:
    """name -> numpy [N] column: int64 (the limits among them), int32,
    int16 and int8 with negatives (zero-extended by the vnode), float64
    with -0.0, +0.0, NaNs of two payloads, infinities and ties, bool."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-50, 50, N)
    k[:4] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0, -1]
    i = rng.integers(-2 ** 31, 2 ** 31, N).astype(np.int32)
    i[::3] = rng.integers(-3, 3, len(i[::3]))          # ties in the pk
    f = rng.integers(-6, 6, N) / 2.0
    f[:6] = [0.0, -0.0, np.nan, np.inf, -np.inf, 1.5]
    nan2 = np.array([0x7FF8000000000001], dtype=np.int64).view(np.float64)
    f[6] = nan2[0]                                      # another payload
    f[7:12] = [-0.0, 0.0, -0.0, np.nan, 0.0]
    s = rng.integers(-2 ** 15, 2 ** 15, N).astype(np.int16)
    b8 = rng.integers(-128, 128, N).astype(np.int8)
    b = rng.random(N) < 0.5
    return {"k": k, "i": i, "f": f, "s": s, "b8": b8, "b": b}


KEY_SETS = [("k",), ("i",), ("f",), ("b",), ("s",), ("b8",), ("i", "f"),
            ("b", "k"), ("k", "i", "f"), ("f", "b", "s", "b8")]


@pytest.mark.parametrize("keys", KEY_SETS, ids="-".join)
def test_compute_vnodes_plain_matches_jax(keys):
    cols = _hazard_columns(0)
    arrs = [cols[c] for c in keys]
    want = np.asarray(jax.jit(jax_vnodes)([jnp.asarray(a) for a in arrs]))
    assert (compute_vnodes_numpy(arrs) == want).all()
    got = vnode.compute_vnodes([torch.from_numpy(a.copy()) for a in arrs])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(want.tolist())) > 1


def test_vnode_widening_hazards():
    """The widening that places state: -1 as int32 is 0xFFFFFFFF, not
    all ones; -0.0 and +0.0 and two NaN payloads hash apart; a bool is
    0/1."""
    t = torch.tensor
    lane = vnode.vnode_lane
    assert lane(t([-1], dtype=torch.int32)).item() == 0xFFFFFFFF
    assert lane(t([-1], dtype=torch.int8)).item() == 0xFF
    assert lane(t([True, False])).tolist() == [1, 0]
    f = _hazard_columns(0)["f"][[0, 1, 2, 6]]
    v = vnode.compute_vnodes_plain([torch.from_numpy(f.copy())]).tolist()
    assert v == compute_vnodes_numpy([f]).tolist()
    assert len(set(v)) == 4


# ------------------------------------------------------ the live filter

SCHEMA_COLS = [("k", "INT64"), ("i", "INT32"), ("f", "FLOAT64"),
               ("b", "BOOLEAN"), ("s", "INT16")]
FILTER_CASES = {
    # (pk indices, dist key indices)
    "int64": ((0,), (0,)),
    "int32_float": ((1, 2), (1,)),
    "float": ((2,), (2,)),
    "bool_int64": ((3, 0), (3, 0)),
    "three": ((0, 1, 2), (0, 1, 2)),
    "int16_float_dist2": ((4, 2), (4, 2)),
}


def _filter_chunk_np(seed):
    cols = _hazard_columns(seed)
    arrays = [cols[n] for n, _ in SCHEMA_COLS]
    vis = np.random.default_rng(seed + 7).random(N) < 0.8
    return arrays, vis


def _jax_backfill(pk, dist):
    sch = jschema(*[(n, getattr(JDT, t)) for n, t in SCHEMA_COLS])
    st = JStorage(JMem(), 9, sch, pk, dist_key_indices=dist)
    return JBackfill(None, st)


def _frontiers(arrays, pk, dist):
    """(cur vnode, last pk or None): vnode edges 0 and 255, the vnodes
    of chunk rows with their own pk (equality), with -0.0 and NaN."""
    vn = compute_vnodes_numpy([arrays[i] for i in dist])
    out = [(0, None), (255, None), (256, None), (0, (0,) * len(pk))]
    for r in (0, 1, 2, 6, 9, 40, 100, 200):
        out.append((int(vn[r]), tuple(arrays[i][r].item() for i in pk)))
        out.append((int(vn[r]), None))
    return out


@pytest.mark.parametrize("case", sorted(FILTER_CASES))
def test_backfill_filter_plain_matches_jax(case):
    pk, dist = FILTER_CASES[case]
    arrays, vis = _filter_chunk_np(1)
    jbf = _jax_backfill(pk, dist)
    jsch = jbf.storage.schema
    jc = JChunk.from_numpy(jsch, arrays, capacity=N).with_vis(
        jnp.asarray(vis))
    kept = set()
    for cur, last in _frontiers(arrays, pk, dist):
        jbf.vnode, jbf.last_pk = cur, last
        want = np.asarray(jbf._filter_chunk(jc).vis)
        vals = last if last is not None else (0,) * len(pk)
        got = vnode.backfill_filter(
            [torch.from_numpy(arrays[i].copy()) for i in dist],
            [torch.from_numpy(arrays[i].copy()) for i in pk], vals, cur,
            last is not None, torch.from_numpy(vis.copy()))
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{cur} {last}")
        kept.add(int(want.sum()))
    assert len(kept) > 3          # the frontiers cut the chunk apart


# ------------------------------------------------------- StorageTable

SCAN_SCHEMA = [("k", "INT64"), ("v", "INT64")]


def _write_epochs(engine, hummock: bool):
    """One table written over epochs 1-4 (inserts, updates, deletes),
    epoch 1 committed, 2 sealed but not committed (Hummock), 3 and 4
    staged. Returns (store, StorageTable)."""
    if engine == "jax":
        sch = jschema(*[(n, getattr(JDT, t)) for n, t in SCAN_SCHEMA])
        store = JHummock(JInMem()) if hummock else JMem()
        T, S = JStateTable, JStorage
    else:
        sch = schema(*[(n, getattr(DT, t)) for n, t in SCAN_SCHEMA])
        store = PHummock(PInMem()) if hummock else PMem()
        T, S = PStateTable, PStorage
    t = T(store, table_id=7, schema=sch, pk_indices=(0,))
    t.init_epoch(1)
    t.write_chunk_rows([(0, (k, 10 * k)) for k in range(120)])
    t.commit(2)
    if hummock:
        store.sync(1)
    else:
        store.sync(1)
    t.write_chunk_rows([(1, (k, 10 * k)) for k in range(0, 120, 5)]
                       + [(0, (k, 10 * k)) for k in range(200, 230)])
    t.commit(3)
    if hummock:
        store.seal(2)                  # sealed, not uploaded or committed
    t.write_chunk_rows([(3, (k, -k)) for k in range(1, 120, 7)])
    t.commit(4)
    t.write_chunk_rows([(0, (k, k)) for k in range(300, 310)])
    t.commit(5)
    return store, S.for_state_table(t)


@pytest.mark.parametrize("hummock", [False, True], ids=["memory", "hummock"])
def test_scan_vnode_after_respects_max_epoch(hummock):
    """Every vnode scanned in batches of 7 rows after each epoch bound,
    in both engines: the same rows in the same order; a bound hides the
    later epochs, sealed-but-uncommitted batches included."""
    js, jt = _write_epochs("jax", hummock)
    ps, pt = _write_epochs("port", hummock)
    sizes = {}
    for max_epoch in (1, 2, 3, 4, None):
        total = 0
        for vn in range(256):
            after, jdone, pdone = None, False, False
            while not jdone:
                jrows, jdone = jt.scan_vnode_after(vn, after, 7, max_epoch)
                prow, pdone = pt.scan_vnode_after(vn, after, 7, max_epoch)
                assert prow == jrows and pdone == jdone, (vn, max_epoch)
                total += len(jrows)
                if jrows:
                    after = (jrows[-1][0],)
        sizes[max_epoch] = total
    # epoch 2 deletes 24 and inserts 30, epoch 3 writes back 3 of the
    # deleted keys, epoch 4 inserts 10
    assert sizes == {1: 120, 2: 126, 3: 129, 4: 139, None: 139}
    for k in (0, 3, 5, 11, 205, 303):
        assert pt.get_row((k,)) == jt.get_row((k,))
    assert list(pt.batch_iter()) == list(jt.batch_iter())


# ----------------------------------------------------- BackfillExecutor

class _Script:
    """Either engine's executor that yields a fixed message list."""

    def __init__(self, base, sch, msgs):
        ex = base()
        ex.schema, ex.identity = sch, "Script"

        async def execute():
            for m in msgs:
                yield m
                await asyncio.sleep(0)
        ex.execute = execute
        self.ex = ex


def _engine(engine):
    if engine == "jax":
        sch = jschema(*[(n, getattr(JDT, t)) for n, t in SCAN_SCHEMA])
        return dict(sch=sch, mem=JMem, T=JStateTable, S=JStorage,
                    BF=JBackfill, progress=j_progress_schema, kw={},
                    bar=lambda c, p, k=JKind.CHECKPOINT: JBarrier(
                        JEpochPair(c, p), k),
                    initial=JKind.INITIAL, base=JExecutor,
                    chunk=lambda rows: JChunk.from_numpy(
                        sch, [np.asarray([r[0] for r in rows]),
                              np.asarray([r[1] for r in rows])],
                        capacity=16))
    sch = schema(*[(n, getattr(DT, t)) for n, t in SCAN_SCHEMA])
    return dict(sch=sch, mem=PMem, T=PStateTable, S=PStorage, BF=PBackfill,
                progress=p_progress_schema, kw={"device": "cpu"},
                bar=lambda c, p, k=PKind.CHECKPOINT: PBarrier(
                    PEpochPair(c, p), k),
                initial=PKind.INITIAL, base=PExecutor,
                chunk=lambda rows: chunk_from_numpy(
                    sch, [np.asarray([r[0] for r in rows] + [0] * (16 - len(
                        rows))), np.asarray([r[1] for r in rows] + [0] * (
                            16 - len(rows)))],
                    np.zeros(16), np.arange(16) < len(rows), device="cpu"))


def _run_backfill(e, store, up, msgs, batch_rows, progress=True):
    """(executor, rows out between barriers as a list of Counters)."""
    st = (e["T"](store, table_id=99,
                 schema=e["progress"](e["sch"], (0,)), pk_indices=(0,))
          if progress else None)
    bf = e["BF"](_Script(e["base"], e["sch"], msgs).ex,
                 e["S"].for_state_table(up), state_table=st,
                 batch_rows=batch_rows, chunk_capacity=64, **e["kw"])

    async def go():
        out = [Counter()]
        async for m in bf.execute():
            if hasattr(m, "epoch"):
                out.append(Counter())
            elif hasattr(m, "ops"):
                out[-1].update(r for _, r in m.to_rows())
        return out
    return bf, asyncio.run(go())


def _upstream(e, store, n_rows):
    t = e["T"](store, table_id=7, schema=e["sch"], pk_indices=(0,))
    t.init_epoch(1)
    t.write_chunk_rows([(0, (k, 10 * k)) for k in range(n_rows)])
    t.commit(2)
    store.sync(1)
    return t


def test_backfill_resume_mid_scan_matches_jax():
    """Three barriers of 100 rows, killed, a new incarnation resumes
    from the persisted progress: in both engines the same rows per
    barrier, every upstream row exactly once, the same progress row."""
    results = {}
    for engine in ("jax", "port"):
        e = _engine(engine)
        store = e["mem"]()
        up = _upstream(e, store, 500)
        bar, init = e["bar"], e["initial"]
        bf1, out1 = _run_backfill(e, store, up, [
            bar(2, 1, init), bar(3, 2), bar(4, 3), bar(5, 4)], 100)
        assert not bf1.finished and sum(sum(c.values()) for c in out1) == 300
        store.sync(5)
        bf2, out2 = _run_backfill(e, store, up, [
            bar(6, 5, init), bar(7, 6), bar(8, 7), bar(9, 8)], 100)
        assert bf2.finished
        store.sync(9)
        progress = list(store.iter_range(b"", b""))
        results[engine] = (out1, out2, progress,
                           (bf2.vnode, bf2.last_pk, bf2.snapshot_rows_total))
    assert results["port"] == results["jax"]
    out1, out2 = results["port"][:2]
    rows = sum(out1 + out2, Counter())
    assert rows == Counter((k, 10 * k) for k in range(500))


def test_backfill_live_filter_matches_jax():
    """Live chunks before and after the first snapshot batch: a row the
    scan covered passes, one ahead of it is dropped, in both engines
    alike; watermark-free, no duplicate across snapshot and live."""
    cols = _hazard_columns(3)
    keys = [int(x) for x in cols["k"][4:40]] + [100000, 7, -3]
    results = {}
    for engine in ("jax", "port"):
        e = _engine(engine)
        store = e["mem"]()
        up = _upstream(e, store, 200)
        bar, init, chunk = e["bar"], e["initial"], e["chunk"]
        msgs = [bar(2, 1, init), chunk([(k, 999) for k in keys[:12]]),
                bar(3, 2), chunk([(k, 1) for k in keys[12:24]]),
                chunk([(k, 2) for k in keys[24:]]), bar(4, 3),
                chunk([(k, 3) for k in keys[:16]]), bar(5, 4)]
        bf, out = _run_backfill(e, store, up, msgs, 40, progress=False)
        results[engine] = (out, bf.vnode, bf.last_pk)
    assert results["port"] == results["jax"]
    out = results["port"][0]
    assert sum(out[0].values()) == 0           # before any scan: nothing
    live = [r for c in out for r in c if r[1] in (1, 2, 3)]
    assert 0 < len(live) < len(keys)
