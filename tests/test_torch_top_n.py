"""The port's retractable top-N (plain versions of kernels K19-K21 and
K7/K11 on the CPU) against the JAX package's RetractableTopNExecutor.

Inputs come from a numpy seed: inserts, deletes (some missing), U-/U+
pairs, pk runs inside one chunk (insert then delete, two updates of one
pk), group keys, int and float order keys ASC and DESC (NaN, -0.0, +0.0,
a subnormal, inf), NULL order values, many ties at the limit, offsets.

Lockstep: the same chunks go through both executors' apply and, after
every chunk, their barrier flush; the store (khash, columns, valids, n),
the error counters, the last top set and the flush's output chunk (every
row: columns, valids, ops, visibility) must be equal, exactly, through
`interop.top_n_state_to_numpy`. A store that overflows counts the same
dropped rows. `interop.top_n_state_from_numpy` starts a port executor
from a JAX executor's mid-stream state.

Stream: both executors driven by the same message scripts through their
barrier loops, with the watchdog growing a 2^8-slot store past 0.7
occupancy; the per-barrier changelogs are equal as multisets.

Durable: q5_topn's shape at a small size (128-bid chunks, `auction %
64`) through both sessions on Hummock stores, epochs from a counter:
every state table's bytes equal after every barrier; a store the JAX
session wrote and abandoned recovers in the port to JAX's MV."""

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
from risingwave_tpu.stream.retract_top_n import (
    RetractableTopNExecutor as JaxTopN)
from risingwave_tpu.stream.sorted_store import (
    segment_starts as jax_segment_starts)
from risingwave_tpu.stream.source import SourceExecutor as JaxSource

INS, DEL, UD, UI = 0, 1, 2, 3
CHUNK = 64
FLOATS = [np.nan, -0.0, 0.0, 1.5, -2.25, 1e-310, np.inf, 1.5, -np.nan]


@pytest.fixture(autouse=True, scope="module")
def _port():
    """Import torch and the port when these tests run, not at
    collection."""
    global torch, DataType, schema, EpochPair, chunk_from_numpy, pmsg
    global PortTopN, interop, sorted_store, port_bm, PortSession, H
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
    from risingwave_tpu_torch.stream import message as pmsg
    from risingwave_tpu_torch.stream import sorted_store
    from risingwave_tpu_torch.stream.retract_top_n import (
        RetractableTopNExecutor as PortTopN)
    from risingwave_tpu_torch.stream.source import (
        SourceExecutor as PortSource)


class _Scripted:
    def __init__(self, sch, msgs=()):
        self.schema = sch
        self.pk_indices = (3,)
        self._msgs = list(msgs)

    async def execute(self):
        for m in self._msgs:
            yield m
            await asyncio.sleep(0)


def _schema(port: bool):
    dt = DataType if port else JDT
    mk = schema if port else jschema
    return mk(("g", dt.INT64), ("v", dt.INT64), ("f", dt.FLOAT64),
              ("pk", dt.INT64))


def _stream(seed: int, n_chunks: int, n_groups: int = 3,
            miss: bool = True):
    """Chunks of (op, g, v, f, pk, v_valid, f_valid) rows."""
    rng = np.random.default_rng(seed)
    live: dict = {}
    next_pk = 0
    out = []

    def fresh(g=None):
        return (int(rng.integers(0, n_groups)) if g is None else g,
                int(rng.integers(0, 6)),
                float(FLOATS[int(rng.integers(0, len(FLOATS)))]),
                bool(rng.random() < 0.9), bool(rng.random() < 0.9))

    for _ in range(n_chunks):
        rows = []
        while len(rows) < CHUNK - 4:
            r = rng.random()
            if live and r < 0.2:
                pk = int(rng.choice(list(live)))
                g, v, f, vv, fv = live.pop(pk)
                rows.append((DEL, g, v, f, pk, vv, fv))
            elif live and r < 0.45:
                pk = int(rng.choice(list(live)))
                old = live[pk]
                new = fresh(old[0])
                rows += [(UD, old[0], *old[1:3], pk, *old[3:]),
                         (UI, new[0], *new[1:3], pk, *new[3:])]
                live[pk] = new
                if rng.random() < 0.2:        # a second update, same pk
                    new2 = fresh(old[0])
                    rows += [(UD, new[0], *new[1:3], pk, *new[3:]),
                             (UI, new2[0], *new2[1:3], pk, *new2[3:])]
                    live[pk] = new2
            elif r < 0.5:
                # insert then delete of one pk inside the chunk
                row = fresh()
                rows += [(INS, *row[:3], next_pk, *row[3:]),
                         (DEL, *row[:3], next_pk, *row[3:])]
                next_pk += 1
            elif miss and r < 0.52:
                row = fresh()
                rows.append((DEL, *row[:3], 10**9 + next_pk, *row[3:]))
                next_pk += 1
            else:
                row = fresh()
                live[next_pk] = row
                rows.append((INS, *row[:3], next_pk, *row[3:]))
                next_pk += 1
        out.append(rows[:CHUNK])
    return out, live


def _arrays(rows, cap=CHUNK):
    n = len(rows)
    g = np.zeros(cap, np.int64)
    v = np.zeros(cap, np.int64)
    f = np.zeros(cap, np.float64)
    pk = np.zeros(cap, np.int64)
    ops = np.zeros(cap, np.int8)
    vv = np.ones(cap, bool)
    fv = np.ones(cap, bool)
    for i, r in enumerate(rows):
        ops[i], g[i], v[i], f[i], pk[i], vv[i], fv[i] = r
    vis = np.arange(cap) < n
    return [g, v, f, pk], ops, vis, [None, vv, fv, None]


def _jchunk(rows):
    arrays, ops, vis, valids = _arrays(rows)
    ch = JChunk.from_numpy(_schema(False), arrays, ops=ops,
                           capacity=len(vis), valids=valids)
    return ch.with_vis(np.asarray(vis))


def _pchunk(rows):
    arrays, ops, vis, valids = _arrays(rows)
    return chunk_from_numpy(_schema(True), arrays, ops, vis, valids,
                            device="cpu")


# JAX executors by configuration: cases that share one reuse its
# compiled programs, from empty state
_JAX: dict = {}


def _jax_topn(**kw):
    key = repr(sorted(kw.items()))
    ex = _JAX.get(key)
    if ex is None:
        ex = _JAX[key] = JaxTopN(_Scripted(_schema(False)), **kw)
    C = ex.capacity
    ex.khash = jnp.full(C, np.iinfo(np.int64).max, dtype=jnp.int64)
    ex.cols = tuple(jnp.zeros(C, dtype=c.dtype) for c in ex.cols)
    ex.valids = tuple(jnp.zeros(C, dtype=bool) for _ in ex.valids)
    ex.n = jnp.int32(0)
    ex.top_hash = jnp.full(C, np.iinfo(np.int64).max, dtype=jnp.int64)
    ex.top_cols = tuple(jnp.zeros(C, dtype=c.dtype) for c in ex.top_cols)
    ex.top_valids = tuple(jnp.zeros(C, dtype=bool) for _ in ex.top_valids)
    ex.top_n = jnp.int32(0)
    ex._errs_dev = jnp.zeros(2, dtype=jnp.int32)
    return ex


def _jax_state(ex) -> dict:
    return dict(khash=np.asarray(ex.khash),
                cols=[np.asarray(c) for c in ex.cols],
                valids=[np.asarray(v) for v in ex.valids],
                n=int(np.asarray(ex.n)),
                top_hash=np.asarray(ex.top_hash),
                top_cols=[np.asarray(c) for c in ex.top_cols],
                top_valids=[np.asarray(v) for v in ex.top_valids],
                top_n=int(np.asarray(ex.top_n)),
                errs=[int(x) for x in np.asarray(ex._errs_dev)])


def _assert_state_equal(got: dict, want: dict, where: str):
    for k in ("n", "top_n", "errs"):
        assert got[k] == want[k], f"{k} differs {where}"
    for k in ("khash", "top_hash"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=where)
    for k in ("cols", "valids", "top_cols", "top_valids"):
        for a, b in zip(got[k], want[k]):
            # bit for bit (NaN payloads and -0.0 included)
            np.testing.assert_array_equal(
                a.view(np.int64) if a.dtype == np.float64 else a,
                b.view(np.int64) if b.dtype == np.float64 else b,
                err_msg=f"{k} {where}")


CONFIGS = {
    "asc_group": dict(group_key_indices=(0,), order_col=1, limit=3,
                      capacity=256),
    # a 64-slot store the stream overfills: rows dropped, counted alike
    "desc_int_offset": dict(group_key_indices=(), order_col=1, limit=4,
                            offset=2, descending=True, capacity=64),
    "float_desc_then_int": dict(group_key_indices=(0,),
                                order_specs=[(2, True), (1, False)],
                                limit=2, capacity=256),
    "float_asc": dict(group_key_indices=(), order_col=2, limit=5,
                      capacity=256),
}


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_apply_and_flush_lockstep_match_jax(case):
    kw = CONFIGS[case]
    jx = _jax_topn(**kw)
    px = PortTopN(_Scripted(_schema(True)), device="cpu", **kw)
    chunks, _ = _stream(sorted(CONFIGS).index(case), 6)
    for i, rows in enumerate(chunks):
        jc, pc = _jchunk(rows), _pchunk(rows)
        jx.on_chunk(jc)
        px.on_chunk(pc)
        jout = jx.flush()
        pout = px.flush()
        _assert_state_equal(interop.top_n_state_to_numpy(px),
                            _jax_state(jx), f"after chunk {i}")
        np.testing.assert_array_equal(pout.ops.numpy(), np.asarray(jout.ops))
        np.testing.assert_array_equal(pout.vis.numpy(), np.asarray(jout.vis))
        for a, b in zip(pout.columns, jout.columns):
            np.testing.assert_array_equal(a.valid_mask().numpy(),
                                          np.asarray(b.valid_mask()))
            x, y = a.data.numpy(), np.asarray(b.data)
            if x.dtype == np.float64:
                x, y = x.view(np.int64), y.view(np.int64)
            np.testing.assert_array_equal(x, y)
    st = _jax_state(jx)
    if case == "desc_int_offset":
        assert st["errs"][0] > 0          # the store overflowed
    assert st["errs"][1] > 0 and st["top_n"] > 0


def test_state_carried_from_jax_continues_alike():
    """A port executor started from a JAX executor's mid-stream state
    (interop.top_n_state_from_numpy) goes on exactly as JAX does."""
    kw = CONFIGS["asc_group"]
    jx = _jax_topn(**kw)
    chunks, _ = _stream(7, 6)
    for rows in chunks[:3]:
        jx.on_chunk(_jchunk(rows))
        jx.flush()
    px = PortTopN(_Scripted(_schema(True)), device="cpu", **kw)
    st = _jax_state(jx)
    interop.top_n_state_from_numpy(px, **st)
    _assert_state_equal(interop.top_n_state_to_numpy(px), st, "carried")
    for i, rows in enumerate(chunks[3:]):
        jx.on_chunk(_jchunk(rows))
        px.on_chunk(_pchunk(rows))
        jout, pout = jx.flush(), px.flush()
        _assert_state_equal(interop.top_n_state_to_numpy(px),
                            _jax_state(jx), f"after chunk {i}")
        assert _changelog(pout) == _changelog(jout)


def test_card_references_match_jax():
    """The whole-step plain versions chip_smoke.py holds the card against
    (`sorted_store_apply_plain`, `topn_flush_plain`, torch's sorts
    throughout) equal JAX's `sorted_store_apply` (the executor's apply)
    and `_flush_impl`."""
    from risingwave_tpu_torch.stream.retract_top_n import topn_flush_plain
    kw = CONFIGS["float_desc_then_int"]
    jx = _jax_topn(**kw)
    px = PortTopN(_Scripted(_schema(True)), device="cpu", **kw)
    chunks, _ = _stream(9, 3)
    for rows in chunks:
        jx.on_chunk(_jchunk(rows))
        px.store = sorted_store.sorted_store_apply_plain(
            px.store, px._errs_dev, _pchunk(rows), (3,))
        jout = jx.flush()
        out = topn_flush_plain(px.store, px.order_specs,
                               px.group_key_indices, px.offset, px.limit,
                               px.top_hash, px.top_cols, px.top_valids,
                               px.top_n)
        (px.top_hash, px.top_cols, px.top_valids, px.top_n) = out[:4]
        _assert_state_equal(interop.top_n_state_to_numpy(px),
                            _jax_state(jx), "plain references")
        np.testing.assert_array_equal(out[7].numpy(), np.asarray(jout.vis))


def test_segment_starts_matches_jax():
    g = np.sort(np.random.default_rng(3).integers(0, 9, 300))
    jn, js = jax_segment_starts(jnp.asarray(g))
    pn, ps = sorted_store.segment_starts(torch.from_numpy(g))
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


def test_float_stream_key_raises():
    sch = schema(("f", DataType.FLOAT64), ("v", DataType.INT64))
    ch = chunk_from_numpy(sch, [np.zeros(4), np.zeros(4, np.int64)],
                          np.zeros(4, np.int8), np.ones(4, bool),
                          device="cpu")
    from risingwave_tpu_torch.stream.sorted_join import empty_sorted_side
    st = empty_sorted_side(8, [torch.float64, torch.int64], "cpu")
    errs = torch.zeros(3, dtype=torch.int32)
    for apply in (sorted_store.sorted_store_apply,
                  sorted_store.sorted_store_apply_plain):
        with pytest.raises(NotImplementedError, match="float stream-key"):
            apply(st, errs, ch, (0,))


# ---------------------------------------------------------------- stream

def _changelog(chunk) -> Counter:
    acc = Counter()
    for op, vals in chunk.to_rows():
        key = tuple("nan" if isinstance(x, float) and x != x else x
                    for x in vals)
        acc[(op, key)] += 1
    return acc


def _per_barrier(msgs, chunk_cls) -> list:
    out, cur = [], Counter()
    for m in msgs:
        if isinstance(m, chunk_cls):
            cur += _changelog(m)
        elif type(m).__name__ == "Barrier":
            out.append(cur)
            cur = Counter()
    return out


def _script(chunks, port: bool, per_barrier: int = 2):
    msg = pmsg if port else jmsg
    ep = EpochPair if port else JEpochPair
    mk = _pchunk if port else _jchunk
    msgs = [msg.Barrier(ep(1 << 16, 0), msg.BarrierKind.INITIAL)]
    e = 1 << 16
    for i, rows in enumerate(chunks):
        msgs.append(mk(rows))
        if i % per_barrier == per_barrier - 1:
            msgs.append(msg.Barrier(ep(e + (1 << 16), e),
                                    msg.BarrierKind.CHECKPOINT))
            e += 1 << 16
    return msgs


async def _drain(ex) -> list:
    return [m async for m in ex.execute()]


def test_barrier_loop_with_growth_matches_jax():
    """Through the barrier loop with the watchdog on: a 2^8-slot store
    grows (0.7 occupancy) to 2^9 in both engines; per-barrier changelogs
    equal as multisets, the final store equal."""
    kw = dict(group_key_indices=(0,), order_specs=[(1, True), (2, False)],
              limit=3, offset=1, capacity=256)
    chunks, _ = _stream(11, 14, n_groups=4, miss=False)
    jx = JaxTopN(_Scripted(_schema(False), _script(chunks, False)), **kw)
    px = PortTopN(_Scripted(_schema(True), _script(chunks, True)),
                  device="cpu", **kw)
    jmsgs = asyncio.run(_drain(jx))
    pmsgs = asyncio.run(_drain(px))
    jlog = _per_barrier(jmsgs, JChunk)
    plog = _per_barrier(pmsgs, type(_pchunk([])))
    assert len(plog) == len(jlog) == 8
    assert plog == jlog
    assert px.capacity == jx.capacity == 512
    _assert_state_equal(interop.top_n_state_to_numpy(px), _jax_state(jx),
                        "at the end")


def test_watchdog_fails_stop_on_delete_miss():
    chunks = [[(INS, 0, 1, 1.0, 1, True, True),
               (DEL, 0, 1, 1.0, 99, True, True)]]
    px = PortTopN(_Scripted(_schema(True), _script(chunks, True, 1)),
                  device="cpu", group_key_indices=(), order_col=1, limit=1,
                  capacity=256)
    with pytest.raises(RuntimeError, match="1 deletes matched no row"):
        asyncio.run(_drain(px))


# --------------------------------------------------------------- durable

CS, PER, ROUNDS, CRASH_AT = 128, 256, 6, 3


def _durable_ddl():
    """q5_topn's shape at a small size (bench.py's _q5_topn_ddl()
    statements, durable, a 64-key group space)."""
    return [
        "SET streaming_watchdog = 0",
        "SET streaming_agg_capacity = 256",
        "SET streaming_top_n_capacity = 256",
        ("CREATE SOURCE bid WITH (connector='nexmark', table='bid', "
         f"chunk_size={CS}, rate_limit={PER}, inter_event_us=2, "
         "emit_watermarks=1)"),
        ("CREATE MATERIALIZED VIEW q5t AS SELECT auction % 64 AS a, "
         "count(*) AS n FROM bid GROUP BY auction % 64 "
         "ORDER BY n DESC LIMIT 10"),
    ]


@pytest.fixture(scope="module")
def det_epochs():
    """Epochs from a counter in both engines (tests/test_torch_durable.py's
    fixture of the same name)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_bm, port_bm):
            mp.setattr(mod, "next_epoch", lambda prev: prev + (1 << 16))
        yield


def _walk_source(dep, cls):
    for roots in dep.roots.values():
        for r in roots:
            node = r
            while node is not None:
                if isinstance(node, cls):
                    return node
                node = getattr(node, "input", None)


async def _paced(s, source_cls, start, stop):
    dep = s.catalog.mvs["q5t"].deployment
    src = _walk_source(dep, source_cls)
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
    return sorted(r for _, r in s.catalog.mvs["q5t"].table.iter_all())


@pytest.fixture(scope="module")
def jax_durable(det_epochs, tmp_path_factory):
    """One JAX session over ROUNDS barriers: the store bytes after each
    and the MV; and a copy of its object store as it stood after barrier
    CRASH_AT (every upload drained), a store abandoned there."""
    path = str(tmp_path_factory.mktemp("jt_full"))
    part_dir = str(tmp_path_factory.mktemp("jt_part") / "store")

    async def go():
        s = JaxSession(store=JaxH(JaxLocalFs(path)))
        for st in _durable_ddl():
            await s.execute(st)
        snaps = await _paced(s, JaxSource, 1, CRASH_AT + 1)
        shutil.copytree(path, part_dir)
        snaps += await _paced(s, JaxSource, CRASH_AT + 1, ROUNDS + 1)
        return snaps, _mv(s)

    return dict(full=asyncio.run(go()), part_dir=part_dir)


def _recount_top(n_bids: int) -> list:
    """The top 10 of count(*) per auction % 64 over the first n bids,
    ties by the port's key hash of the group, as (a, n) rows sorted."""
    import chip_smoke
    return sorted(chip_smoke.q5_topn_recount(n_bids, 64, 10, "cpu",
                                             inter_event_us=2))


def test_durable_top_n_state_equals_jax_after_every_barrier(jax_durable,
                                                            tmp_path):
    snaps, mv = jax_durable["full"]

    async def go():
        s = PortSession(device="cpu", store=H(LocalFs(str(tmp_path))))
        for st in _durable_ddl():
            await s.execute(st)
        got = await _paced(s, PortSource, 1, ROUNDS + 1)
        return got, _mv(s)

    got, pmv = asyncio.run(go())
    assert len(got) == len(snaps) == ROUNDS
    for r, (a, b) in enumerate(zip(got, snaps)):
        tables = {int.from_bytes(k[:4], "big") for k, _ in b}
        # source offsets, agg, top-N input rows, the MV
        assert tables == {1, 2, 3, 4}, tables
        assert a == b, f"state differs after barrier {r + 1}"
    # the hot auctions leave fewer than 10 groups this early
    assert pmv == mv == _recount_top(ROUNDS * PER) and len(mv) >= 5


def test_store_written_by_jax_recovers_in_port(jax_durable, tmp_path):
    """JAX ran CRASH_AT barriers and was abandoned; the port recovers its
    store (the top-N re-applies its stored rows and seeds its baseline)
    and runs to the end: the MV equals JAX's uninterrupted run; so does
    the port's own crash and recovery."""
    _, mv = jax_durable["full"]

    async def resume(path):
        s = PortSession(device="cpu", store=H.open(LocalFs(path)))
        await s.recover()
        await _paced(s, PortSource, CRASH_AT + 1, ROUNDS + 1)
        return _mv(s)

    assert asyncio.run(resume(jax_durable["part_dir"])) == mv

    async def first():
        s = PortSession(device="cpu", store=H(LocalFs(str(tmp_path))))
        for st in _durable_ddl():
            await s.execute(st)
        await _paced(s, PortSource, 1, CRASH_AT + 1)
        await s.crash()

    asyncio.run(first())
    assert asyncio.run(resume(str(tmp_path))) == mv
