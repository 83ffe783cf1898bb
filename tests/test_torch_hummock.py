"""The port's durable store against the JAX package's: the same writes
give byte-equal SSTs, manifests and catalogs; a LocalFs directory one
engine wrote opens in the other with equal contents; and the port passes
the JAX package's overlay-and-reopen, compaction and crash-atomic sync
cases (tests/test_hummock.py) and its in-order commit and
crash-with-in-flight-uploads cases (tests/test_checkpoint_pipeline.py),
the latter over a slow in-memory object store with q5's executors on the
CPU."""

import asyncio
import json
import time
from collections import Counter

import numpy as np
import pytest

from risingwave_tpu.state.hummock import HummockStateStore as JaxHummock
from risingwave_tpu.state.object_store import (
    InMemObjectStore as JaxInMem, LocalFsObjectStore as JaxLocalFs)
from risingwave_tpu.state.sstable import build_sstable as jax_build_sstable
from risingwave_tpu.state.store import WriteBatch as JaxBatch


@pytest.fixture(autouse=True, scope="module")
def _port():
    """Import torch and the port when these tests run, not at
    collection."""
    global H, InMem, LocalFs, WriteBatch, build_sstable
    from risingwave_tpu_torch.state import (
        HummockStateStore as H, InMemObjectStore as InMem,
        LocalFsObjectStore as LocalFs, WriteBatch)
    from risingwave_tpu_torch.state.sstable import build_sstable


def _kv(rng, n):
    """n random (key, value | None) puts, keys of random length."""
    out = {}
    for _ in range(n):
        k = bytes(rng.integers(0, 256, rng.integers(1, 12), dtype=np.uint8))
        out[k] = (None if rng.random() < 0.2 else
                  bytes(rng.integers(0, 256, rng.integers(0, 20),
                                     dtype=np.uint8)))
    return out


def _write(store, batch_cls, epochs):
    for e, puts in epochs:
        store.ingest_batch(batch_cls(7, e, dict(puts)))
        store.sync(e)


def _objects(objs) -> dict:
    return {p: objs.read(p) for p in objs.list("")}


@pytest.mark.parametrize("n_epochs", [3, 11])
def test_same_writes_give_byte_equal_objects(n_epochs):
    """SSTs and the MANIFEST (through compaction when L0 passes its
    threshold, at 11 epochs) are the same bytes in both engines."""
    rng = np.random.default_rng(n_epochs)
    epochs = [(e << 16, _kv(rng, 40)) for e in range(1, n_epochs + 1)]
    jo, po = JaxInMem(), InMem()
    _write(JaxHummock(jo), JaxBatch, epochs)
    _write(H(po), WriteBatch, epochs)
    assert _objects(po) == _objects(jo)
    assert json.loads(po.read("MANIFEST")[4:-4])["format"] == 1
    ents = sorted(_kv(rng, 30).items())
    assert build_sstable(9, ents) == jax_build_sstable(9, ents)


def test_cross_engine_open(tmp_path):
    """A LocalFs directory the JAX store wrote opens in the port and vice
    versa, with equal contents and committed epochs."""
    rng = np.random.default_rng(5)
    epochs = [(e << 16, _kv(rng, 30)) for e in range(1, 12)]
    _write(JaxHummock(JaxLocalFs(str(tmp_path / "j"))), JaxBatch, epochs)
    _write(H(LocalFs(str(tmp_path / "p"))), WriteBatch, epochs)
    pj = H.open(LocalFs(str(tmp_path / "j")))
    jp = JaxHummock.open(JaxLocalFs(str(tmp_path / "p")))
    jj = JaxHummock.open(JaxLocalFs(str(tmp_path / "j")))
    want = list(jj.iter_range(b"", b""))
    assert want and list(pj.iter_range(b"", b"")) == want
    assert list(jp.iter_range(b"", b"")) == want
    assert pj.committed_epoch() == jp.committed_epoch() == 11 << 16


def _batch(epoch, table_id=1, **kv):
    puts = {k.encode(): (v.encode() if v is not None else None)
            for k, v in kv.items()}
    return WriteBatch(table_id, epoch, puts)


def test_hummock_overlay_and_reopen():
    objs = InMem()
    st = H(objs)
    st.ingest_batch(_batch(1, a="1", b="1"))
    st.sync(1)
    st.ingest_batch(_batch(2, a="2", c="2"))
    st.sync(2)
    st.ingest_batch(_batch(3, b=None))
    st.sync(3)
    assert st.get(b"a") == b"2" and st.get(b"b") is None
    assert st.get(b"c") == b"2"
    assert list(st.iter_range(b"", b"")) == [(b"a", b"2"), (b"c", b"2")]
    assert st.committed_epoch() == 3
    st.ingest_batch(_batch(4, d="4"))
    assert st.get(b"d") == b"4"
    st2 = H.open(objs)
    assert st2.get(b"d") is None
    assert st2.get(b"a") == b"2" and st2.get(b"b") is None
    assert st2.committed_epoch() == 3


def test_hummock_compaction_drops_tombstones_and_obsolete_objects():
    objs = InMem()
    st = H(objs)
    n = H.L0_COMPACT_THRESHOLD + 1
    for e in range(1, n + 1):
        kv = {f"k{e:03d}": str(e)}
        if e == 2:
            kv["k001"] = None
        st.ingest_batch(_batch(e, **kv))
        st.sync(e)
    assert st._l1 is not None and st._l0 == []
    assert st.get(b"k001") is None
    assert len(objs.list("ssts/")) == 1
    st2 = H.open(objs)
    assert st2.get(b"k003") == b"3"
    assert len(list(st2.iter_range(b"", b""))) == n - 1


def test_hummock_sync_is_crash_atomic():
    objs = InMem()
    st = H(objs)
    st.ingest_batch(_batch(1, a="1"))
    st.sync(1)
    sst_id = st._next_sst_id
    objs.upload(f"ssts/{sst_id:010d}.sst", build_sstable(2, [(b"z", b"2")]))
    st2 = H.open(objs)
    assert st2.get(b"z") is None and st2.committed_epoch() == 1


def test_local_fs_sweeps_stale_tmp_and_refuses_escapes(tmp_path):
    import os
    objs = LocalFs(str(tmp_path))
    objs.upload("ssts/a.sst", b"x")
    stale = tmp_path / "ssts" / "b.sst.tmp"
    stale.write_bytes(b"torn")
    os.utime(stale, (0, 0))
    LocalFs(str(tmp_path))
    assert not stale.exists() and objs.list("") == ["ssts/a.sst"]
    with pytest.raises(ValueError):
        objs.upload("../x", b"")


# --------------------------------------------------- the pipeline (q5 core)

class SlowObjectStore:
    """A fixed delay on every SST upload: sealed-but-uncommitted windows
    become observable."""

    def __init__(self, inner, delay_s: float):
        self._inner = inner
        self.delay_s = delay_s

    def upload(self, name, data):
        if name.startswith("ssts/"):
            time.sleep(self.delay_s)
        return self._inner.upload(name, data)

    def __getattr__(self, name):
        return getattr(self._inner, name)


SLIDE_US, SIZE_US, INTER_US = 2_000_000, 10_000_000, 50_000


def _build_q5(store):
    from risingwave_tpu_torch.common.types import DataType, schema
    from risingwave_tpu_torch.connectors.nexmark import (
        NexmarkConfig, NexmarkGenerator)
    from risingwave_tpu_torch.expr.agg import count_star
    from risingwave_tpu_torch.state import StateTable
    from risingwave_tpu_torch.stream import (
        HashAggExecutor, HopWindowExecutor, MaterializeExecutor,
        SourceExecutor)
    barrier_q = asyncio.Queue()
    gen = NexmarkGenerator("bid", chunk_size=128,
                           cfg=NexmarkConfig(inter_event_us=INTER_US),
                           device="cpu")
    offsets = StateTable(store, table_id=1, schema=schema(
        ("source_id", DataType.INT64), ("offset", DataType.INT64)),
        pk_indices=[0])
    src = SourceExecutor(1, gen, barrier_q, state_table=offsets)
    hop = HopWindowExecutor(src, time_col=5, window_slide_us=SLIDE_US,
                            window_size_us=SIZE_US)
    agg_table = StateTable(store, table_id=2, schema=schema(
        ("auction", DataType.INT64), ("ws", DataType.TIMESTAMP),
        ("count", DataType.INT64), ("_row_count", DataType.INT64)),
        pk_indices=[0, 1])
    agg = HashAggExecutor(hop, group_key_indices=[0, hop.window_start_idx],
                          agg_calls=[count_star(append_only=True)],
                          capacity=1 << 12, state_table=agg_table,
                          device="cpu")
    mv = StateTable(store, table_id=3, schema=agg.schema,
                    pk_indices=list(agg.pk_indices))
    return barrier_q, gen, MaterializeExecutor(agg, mv), mv


def _oracle_q5(offset):
    from risingwave_tpu_torch.connectors.nexmark import (
        NexmarkConfig, NexmarkGenerator)
    regen = NexmarkGenerator("bid", chunk_size=128,
                             cfg=NexmarkConfig(inter_event_us=INTER_US),
                             device="cpu")
    expect = Counter()
    while regen.offset < offset:
        cols, _ = regen.next_chunk().to_numpy()
        for a, t in zip(cols[0].tolist(), cols[5].tolist()):
            base = (t // SLIDE_US) * SLIDE_US
            for k in range(SIZE_US // SLIDE_US):
                ws = base - k * SLIDE_US
                if t < ws + SIZE_US:
                    expect[(a, ws)] += 1
    return dict(expect)


def _start(store, max_inflight):
    from risingwave_tpu_torch.meta import BarrierCoordinator
    from risingwave_tpu_torch.stream import Actor
    barrier_q, gen, mat, mv = _build_q5(store)
    coord = BarrierCoordinator(store, checkpoint_max_inflight=max_inflight)
    coord.register_source(barrier_q)
    coord.register_actor(1)
    return coord, Actor(1, mat, None, coord).spawn(), gen, mv


def test_pipelined_run_commits_in_order_and_converges():
    """Over a slow object store the uploads overlap the stream, manifest
    swaps land strictly in epoch order, and the drained result equals
    the exactly-once oracle."""
    async def go():
        store = H(SlowObjectStore(InMem(), delay_s=0.02))
        coord, task, gen, mv = _start(store, 2)
        await coord.run_rounds(1)
        saw = 0
        for _ in range(5):
            b = await coord.inject_barrier()
            await coord.wait_collected(b)
            saw = max(saw, coord._inflight)
        await coord.stop_all({1})
        await task
        commits = coord.committed_epochs
        assert saw >= 1, "uploads never overlapped the stream"
        assert commits == sorted(set(commits)) and len(commits) == 7
        assert store.committed_epoch() == commits[-1] and not store._sealed
        assert coord.upload_overlap_pct() is not None
        got = {(r[0], r[1]): r[2] for _, r in mv.iter_all()}
        assert got == _oracle_q5(gen.offset)
    asyncio.run(go())


def test_crash_with_inflight_uploads_recovers_exactly_once():
    """A crash while sealed epochs sit in the uploader: the next
    incarnation opens at the last MANIFEST, and re-running converges to
    the exactly-once oracle."""
    async def go():
        objs = InMem()
        store = H(SlowObjectStore(objs, delay_s=0.02))
        coord, task, _, _ = _start(store, 2)
        await coord.run_rounds(1)
        for _ in range(3):
            b = await coord.inject_barrier()
            await coord.wait_collected(b)
        task.cancel()
        try:
            await task
        except (asyncio.CancelledError, Exception):
            pass
        await coord.abort_uploads()
        committed = store.committed_epoch()
        store2 = H.open(objs)
        assert store2.committed_epoch() == committed
        # in-process recovery: dropping the uncommitted epochs leaves the
        # old handle reading what a reopened one reads
        store.reset_uncommitted()
        assert not store._sealed and not store._shared
        assert list(store.iter_range(b"", b"")) == \
            list(store2.iter_range(b"", b""))
        coord2, task2, gen2, mv2 = _start(store2, 2)
        await coord2.run_rounds(3)
        await coord2.stop_all({1})
        await task2
        assert gen2.offset > 0
        got = {(r[0], r[1]): r[2] for _, r in mv2.iter_all()}
        assert got == _oracle_q5(gen2.offset)
    asyncio.run(go())


def test_unconfirmed_batches_restage_and_confirm():
    """A handle that does not own the manifest keeps what it commits
    until a commit is confirmed; restaging puts the unconfirmed batches
    back in the shared buffer (and out of L0), as JAX's handle does."""
    for Store, Batch, Objs in ((H, WriteBatch, InMem),
                               (JaxHummock, JaxBatch, JaxInMem)):
        st = Store(Objs())
        st.manifest_owner = False
        for e in (1, 2):
            st.ingest_batch(Batch(1, e, {b"k%d" % e: b"v"}))
            b = st.seal(e)
            st.upload_sealed(b)
            st.commit_sealed(b)
        assert [b.seal_epoch for b in st._unconfirmed] == [1, 2]
        st.confirm_committed(1)
        assert [b.seal_epoch for b in st._unconfirmed] == [2]
        st.restage_unconfirmed()
        assert sorted(st._shared) == [2] and len(st._l0) == 1
        assert st.get(b"k2") == b"v" and not st.objects.exists("MANIFEST")


def test_state_table_batch_writes_and_reads_match_jax():
    """write_chunk_columns (the port's numpy encode, the JAX package's
    native or per-row codec) stages the same bytes; get_rows, the
    deferred flush and discard_staged_tables agree."""
    from risingwave_tpu.common import DataType as JDT, schema as jschema
    from risingwave_tpu.state import StateTable as JaxTable
    from risingwave_tpu_torch.common import DataType, schema
    from risingwave_tpu_torch.state import StateTable
    rng = np.random.default_rng(3)
    n = 200
    cols = [rng.integers(-1 << 40, 1 << 40, n), rng.integers(0, 9, n),
            rng.integers(-5, 5, n)]
    ops = rng.integers(0, 4, n).astype(np.int8)
    vis = rng.random(n) < 0.8
    out = []
    for T, sch, S, B, dt in (
            (StateTable, schema, H, WriteBatch, DataType),
            (JaxTable, jschema, JaxHummock, JaxBatch, JDT)):
        store = S((InMem if S is H else JaxInMem)())
        tabs = []
        for tid, kind in ((5, dt.INT64), (6, dt.INT32)):
            t = T(store, tid, sch(("a", dt.INT64), ("b", kind),
                                  ("c", dt.INT64)), pk_indices=[1, 0])
            t.init_epoch(1)
            t.write_chunk_columns(ops, [c.astype(t.schema[i].data_type
                                                 .np_dtype)
                                        for i, c in enumerate(cols)], vis)
            tabs.append(t)
        rows = [tabs[0].get_rows([(int(b), int(a)) for a, b in
                                  zip(cols[0][:20], cols[1][:20])])]
        store.defer_enabled = True
        for t in tabs:
            store.defer_flush(1, (None, lambda _, t=t: t.commit(2)),
                              table_id=t.table_id)
        store.discard_staged_tables([6])
        store.sync(1)
        rows.append(tabs[0].get_rows([(int(b), int(a)) for a, b in
                                      zip(cols[0][:20], cols[1][:20])]))
        out.append((rows, list(store.iter_range(b"", b""))))
    assert out[0] == out[1]
    kv = out[0][1]
    assert kv and {int.from_bytes(k[:4], "big") for k, _ in kv} == {5}
