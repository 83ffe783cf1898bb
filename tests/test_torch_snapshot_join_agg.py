"""The port's SnapshotJoinAggExecutor (kernels K14-K16's plain versions,
K5's tree walk and K11's plain sort on the CPU) against the JAX
package's executor on the same chunk sequences.

Both executors take their arguments from their own planner, bound from
the same SQL over the tpch sources, so the expressions and aggregate
calls are each package's own. Chunks come from a numpy seed: visible and
invisible rows, NULL join keys, NULL aggregate arguments, repeated part
keys. Strings are dictionary ids of each package's own dictionary, so
the part rows are encoded per package.

Lockstep tests call the executors' append and flush programs directly
and compare, after every append, the stores slot for slot with the
counts and error counters, and at every barrier the 2-row diff chunk
(data where valid, validity, ops, visibility) and the previous-emission
state. Stream tests run both executors' `execute()` over scripted
inputs and compare the changelog per barrier.

Float results are compared within a relative 1e-15: XLA folds a
division by a constant (q17's `/ 7.0`) into a multiplication by its
reciprocal, one ulp off the IEEE quotient that the port computes (as
numpy does; tests/test_torch_q17_pipeline.py holds the port's q17 value
to a numpy recount exactly). Everything else is exact.
"""

import asyncio

import numpy as np
import pytest

from risingwave_tpu.common import StreamChunk as JChunk
from risingwave_tpu.common.epoch import EpochPair as JEpochPair
from risingwave_tpu.common.types import GLOBAL_DICT as JDICT
from risingwave_tpu.connectors.tpch import TPCH_SCHEMAS as JSCHEMAS
from risingwave_tpu.frontend import Session as JaxSession
from risingwave_tpu.frontend import sql as jsql
from risingwave_tpu.frontend.binder import StreamPlanner as JaxPlanner
from risingwave_tpu.stream import message as jmsg
from risingwave_tpu.stream.snapshot_join_agg import (
    SnapshotJoinAggExecutor as JaxSJA)

CAP = 32            # chunk capacity
INS, DEL = 0, 1

SOURCES = [
    "SET streaming_durability = 0",
    ("CREATE SOURCE part WITH (connector='tpch', table='part', "
     "chunk_size=32, primary_key='p_partkey')"),
    ("CREATE SOURCE lineitem WITH (connector='tpch', table='lineitem', "
     "chunk_size=32)"),
]

JOIN = ("FROM lineitem L JOIN part P ON P.p_partkey = L.l_partkey ")
QUERIES = {
    # TPC-H q17 (bench.py's text)
    "q17": ("SELECT sum(L.l_extendedprice) / 7.0 AS avg_yearly " + JOIN +
            "JOIN (SELECT l_partkey AS agg_partkey, "
            "0.2 * avg(l_quantity) AS avg_quantity "
            "FROM lineitem GROUP BY l_partkey) A "
            "ON A.agg_partkey = L.l_partkey "
            "AND L.l_quantity < A.avg_quantity "
            "WHERE P.p_brand = 'Brand#23' AND P.p_container = 'MED BOX'"),
    # every aggregate kind at both levels, a fact filter, no dim filter
    "kinds": ("SELECT count(*) AS n, count(L.l_orderkey) AS c, "
              "sum(L.l_extendedprice) AS s, avg(L.l_quantity) AS a, "
              "min(L.l_quantity) AS mn, max(L.l_extendedprice) AS mx " +
              JOIN +
              "JOIN (SELECT l_partkey AS k, min(l_quantity) AS mq, "
              "max(l_quantity) AS xq, sum(l_extendedprice) AS se "
              "FROM lineitem GROUP BY l_partkey) A "
              "ON A.k = L.l_partkey AND L.l_quantity <= A.xq "
              "AND L.l_quantity >= A.mq + 1 AND L.l_extendedprice < A.se "
              "WHERE L.l_orderkey > 2"),
    # tests/test_snapshot_join_agg.py's group-existence shape
    "sub_where": ("SELECT count(*) AS n " + JOIN +
                  "JOIN (SELECT l_partkey AS k, count(l_quantity) AS c "
                  "FROM lineitem WHERE l_quantity > 40 "
                  "GROUP BY l_partkey) A "
                  "ON A.k = L.l_partkey AND L.l_quantity < A.c + 100"),
    # equi link only
    "no_residue": ("SELECT sum(L.l_quantity) AS sq, max(L.l_orderkey) AS mo "
                   + JOIN +
                   "JOIN (SELECT l_partkey AS k, count(*) AS n "
                   "FROM lineitem GROUP BY l_partkey) A "
                   "ON A.k = L.l_partkey"),
}


@pytest.fixture(autouse=True, scope="module")
def _port():
    """Import torch and the port when these tests run, not at collection:
    an xdist worker then runs the JAX tests before them without torch
    (the sharded-join recovery tests abort more often with it loaded)."""
    global torch, PDICT, PSCHEMAS, PortSession, psql, PortPlanner, pmsg
    global PortSJA, EpochPair, chunk_from_numpy
    import torch
    from risingwave_tpu_torch.common.epoch import EpochPair
    from risingwave_tpu_torch.common.types import GLOBAL_DICT as PDICT
    from risingwave_tpu_torch.connectors.tpch import TPCH_SCHEMAS as PSCHEMAS
    from risingwave_tpu_torch.frontend import Session as PortSession
    from risingwave_tpu_torch.frontend import sql as psql
    from risingwave_tpu_torch.frontend.binder import (
        StreamPlanner as PortPlanner)
    from risingwave_tpu_torch.interop import chunk_from_numpy
    from risingwave_tpu_torch.stream import message as pmsg
    from risingwave_tpu_torch.stream.snapshot_join_agg import (
        SnapshotJoinAggExecutor as PortSJA)


class _Scripted:
    def __init__(self, sch, msgs=()):
        self.schema = sch
        self.pk_indices = ()
        self._msgs = list(msgs)

    def fence_tokens(self):
        return []

    async def execute(self):
        for m in self._msgs:
            yield m
            await asyncio.sleep(0)


def _node_args(query: str, port: bool, sets=()) -> dict:
    """The snapshot_join_agg node's arguments as the package's planner
    binds them."""
    async def go():
        s = PortSession(device="cpu") if port else JaxSession()
        for stmt in SOURCES + list(sets):
            await s.execute(stmt)
        mod, planner = (psql, PortPlanner) if port else (jsql, JaxPlanner)
        st = mod.parse(f"CREATE MATERIALIZED VIEW v AS {query}")
        plan = planner(s.catalog, config=s.config).plan_select(st.select)
        for f in plan.graph.fragments.values():
            n = f.root
            while n.kind != "snapshot_join_agg" and n.inputs \
                    and hasattr(n.inputs[0], "kind"):
                n = n.inputs[0]
            if n.kind == "snapshot_join_agg":
                return dict(n.args)
        raise AssertionError("no snapshot_join_agg node")
    return asyncio.run(go())


def _executors(query, capacity=256, dim_capacity=64, watchdog=1,
               fact_msgs=(), dim_msgs=()):
    """(JAX executor, port executor) for `query`; each side's inputs
    replay the given (JAX, port) message lists."""
    out = []
    for port in (False, True):
        a = _node_args(query, port)
        a.pop("durable")
        a.update(capacity=capacity, dim_capacity=dim_capacity,
                 watchdog_interval=watchdog)
        sch = PSCHEMAS if port else JSCHEMAS
        k = 1 if port else 0
        fact = _Scripted(sch["lineitem"], [m[k] for m in fact_msgs])
        dim = _Scripted(sch["part"], [m[k] for m in dim_msgs])
        if port:
            out.append(PortSJA(fact, dim, device="cpu", **a))
        else:
            out.append(JaxSJA(fact, dim, **a))
    return tuple(out)


# ------------------------------------------------------------ the data

BRANDS = ["Brand#23", "Brand#11", "Brand#42"]
CONTAINERS = ["MED BOX", "SM CASE"]


def _li_arrays(rng, n, null_share=0.1, keys=12, delete_at=None):
    """A lineitem chunk: (arrays, ops, vis, valids) over CAP rows, n of
    them visible; NULL part keys, order keys and quantities."""
    ok = rng.integers(0, 8, CAP)
    pk = rng.integers(1, keys + 1, CAP)
    q = rng.integers(1, 51, CAP)
    ep = q * rng.integers(900, 1100, CAP)
    ops = np.zeros(CAP, np.int8)
    if delete_at is not None:
        ops[delete_at] = DEL
    vis = np.zeros(CAP, bool)
    vis[rng.permutation(CAP)[:n]] = True
    if delete_at is not None:
        vis[delete_at] = True
    valids = [rng.random(CAP) > null_share, rng.random(CAP) > null_share,
              rng.random(CAP) > null_share, None]
    return [ok, pk, q, ep], ops, vis, valids


def _part_arrays(rng, lo, n, null_key=False):
    """Part rows with keys lo+1 .. lo+n (unique), brands and containers
    as strings."""
    keys = np.arange(lo + 1, lo + n + 1)
    brand = [BRANDS[i] for i in rng.integers(0, len(BRANDS), n)]
    cont = [CONTAINERS[i] for i in rng.integers(0, len(CONTAINERS), n)]
    price = rng.integers(900, 1100, n)
    kv = np.ones(n, bool)
    if null_key:
        kv[0] = False
    return keys, brand, cont, price, kv


def _chunk_pair(table, arrays, ops, vis, valids):
    """The same chunk for each package (rows beyond vis invisible)."""
    js = JChunk.from_numpy(JSCHEMAS[table], arrays, ops=ops,
                           capacity=len(vis), valids=valids)
    jc = js.with_vis(np.asarray(vis))
    pc = chunk_from_numpy(PSCHEMAS[table], arrays, ops, vis, valids,
                          device="cpu")
    return jc, pc


def _part_pair(keys, brand, cont, price, kv):
    n = len(keys)
    pad = lambda a: np.concatenate([a, np.zeros(CAP - n, a.dtype)])
    vis = np.arange(CAP) < n
    ops = np.zeros(CAP, np.int8)
    valids = [pad(kv), None, None, None]
    out = []
    for d, table in ((JDICT, JSCHEMAS), (PDICT, PSCHEMAS)):
        arrays = [pad(keys), pad(np.asarray([d.get_or_insert(b)
                                             for b in brand])),
                  pad(np.asarray([d.get_or_insert(c) for c in cont])),
                  pad(price)]
        if table is JSCHEMAS:
            js = JChunk.from_numpy(table["part"], arrays, ops=ops,
                                   capacity=CAP, valids=valids)
            out.append(js.with_vis(np.asarray(vis)))
        else:
            out.append(chunk_from_numpy(table["part"], arrays, ops, vis,
                                        valids, device="cpu"))
    return tuple(out)


def _script(seed, rounds=4, n_keys=12, deletes=False):
    """[("f" | "d", (jax chunk, port chunk)) | ("b",)] steps."""
    rng = np.random.default_rng(seed)
    steps, parts = [], 0
    for r in range(rounds):
        if parts < n_keys:
            take = min(5, n_keys - parts)
            steps.append(("d", _part_pair(*_part_arrays(
                rng, parts, take, null_key=r == 1))))
            parts += take
        for _ in range(2):
            da = int(rng.integers(0, CAP)) if deletes and r == 2 else None
            steps.append(("f", _chunk_pair("lineitem", *_li_arrays(
                rng, int(rng.integers(CAP // 2, CAP + 1)), keys=n_keys + 2,
                delete_at=da))))
        steps.append(("b",))
    return steps


# ------------------------------------------------------------ lockstep

def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_stores_equal(je, pe):
    assert int(_np(je._fn)) == int(pe._fn)
    assert int(_np(je._dn)) == int(pe._dn)
    np.testing.assert_array_equal(_np(je._errs), _np(pe._errs))
    for a, b in zip(je._fcols, pe._fcols):
        np.testing.assert_array_equal(_np(a), _np(b))
    for a, b in zip(je._fvalids, pe._fvalids):
        np.testing.assert_array_equal(_np(a), _np(b))
    np.testing.assert_array_equal(_np(je._dkeys), _np(pe._dkeys))


def _assert_values_equal(j, p):
    """Exact, floats within a relative 1e-15 (see the module doc)."""
    j, p = np.asarray(j), np.asarray(p)
    assert j.dtype == p.dtype
    if p.dtype.kind == "f":
        np.testing.assert_allclose(p, j, rtol=1e-15, atol=0)
    else:
        np.testing.assert_array_equal(p, j)


def _assert_diff_equal(jo, po):
    np.testing.assert_array_equal(_np(jo.ops), _np(po.ops))
    np.testing.assert_array_equal(_np(jo.vis), _np(po.vis))
    for jc, pc in zip(jo.columns, po.columns):
        jv, pv = _np(jc.valid_mask()), _np(pc.valid_mask())
        np.testing.assert_array_equal(jv, pv)
        _assert_values_equal(_np(jc.data)[jv], _np(pc.data)[pv])


def _jax_step(je, step):
    if step[0] == "f":
        (je._fcols, je._fvalids, je._fn, je._errs) = je._append_fact(
            je._fcols, je._fvalids, je._fn, je._errs, step[1][0])
    elif step[0] == "d":
        je._dkeys, je._dn, je._errs = je._append_dim(
            je._dkeys, je._dn, je._errs, step[1][0])
    else:
        je._prev, je._prev_valid, je._emitted, out = je._flush(
            je._fcols, je._fvalids, je._fn, je._dkeys, je._dn, je._prev,
            je._prev_valid, je._emitted)
        return out


def _port_step(pe, step):
    if step[0] == "f":
        pe._append_fact(step[1][1])
    elif step[0] == "d":
        pe._append_dim(step[1][1])
    else:
        return pe._flush()


def _lockstep(je, pe, steps):
    """Run both; return the port's visible emissions."""
    emitted = []
    for st in steps:
        jo, po = _jax_step(je, st), _port_step(pe, st)
        _assert_stores_equal(je, pe)
        if st[0] == "b":
            _assert_diff_equal(jo, po)
            for a, b, av, bv in zip(je._prev, pe._prev, je._prev_valid,
                                    pe._prev_valid):
                assert bool(_np(av)) == bool(bv)
                if bool(bv):
                    _assert_values_equal(_np(a), _np(b))
            emitted += po.to_rows()
    return emitted


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_lockstep_matches_jax(query):
    je, pe = _executors(QUERIES[query])
    rows = _lockstep(je, pe, _script(hash(query) % 1000))
    assert pe.errs() == [0, 0, 0]
    # the diffs were not all empty: the first emission is an Insert
    assert rows and rows[0][0] == INS


def test_overflow_and_retraction():
    """Fact and dim overflow (errs[0], errs[1]) and retractions (errs[2],
    one a chunk of round 2) count alike in both engines, the counts stop
    at capacity, and both watchdogs raise. (Growth: the stream test.)
    The port refuses state tables."""
    steps = _script(7, rounds=3, deletes=True)
    je, pe = _executors(QUERIES["no_residue"], capacity=64, dim_capacity=8)
    _lockstep(je, pe, steps)
    errs = pe.errs()
    assert errs[0] > 0 and errs[1] == 3 and errs[2] == 2
    assert int(pe._fn) == 64 and int(pe._dn) == 8
    for ex in (je, pe):
        with pytest.raises(RuntimeError, match="fact store overflow"):
            ex._check_watchdog()
    pe._errs[:2] = 0
    with pytest.raises(RuntimeError, match="retractions"):
        pe._check_watchdog()
    # durable state (persist, recover) is not ported: refused, not faked
    a = _node_args(QUERIES["no_residue"], True)
    a.pop("durable")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        PortSJA(_Scripted(PSCHEMAS["lineitem"]), _Scripted(PSCHEMAS["part"]),
                device="cpu", state_tables=(object(), object()), **a)


# -------------------------------------------------------------- stream

def _messages(steps):
    """Per-input (JAX, port) message pairs with barriers on both
    inputs."""
    fact, dim = [], []
    epoch = 0
    for st in [("b",)] + list(steps):
        if st[0] == "b":
            prev, epoch = epoch, epoch + 1
            kind = "INITIAL" if prev == 0 else "CHECKPOINT"
            pair = (jmsg.Barrier(JEpochPair(epoch, prev),
                                 getattr(jmsg.BarrierKind, kind)),
                    pmsg.Barrier(EpochPair(epoch, prev),
                                 getattr(pmsg.BarrierKind, kind)))
            fact.append(pair)
            dim.append(pair)
        else:
            (fact if st[0] == "f" else dim).append(st[1])
    return fact, dim


def _run(ex):
    """The chunks yielded between barriers, per barrier."""
    async def go():
        logs, cur = [], []
        async for m in ex.execute():
            if hasattr(m, "to_rows"):
                cur.append(m)
            elif hasattr(m, "epoch"):
                logs.append(cur)
                cur = []
        return logs
    return asyncio.run(go())


def test_stream_changelog_per_barrier():
    """execute() of both engines in transfer-free mode (watchdog off, so
    growth runs at 0.9 of capacity on the host's upper bound, here
    twice): the same chunk, or none, at every barrier. A barrier after
    only invisible rows is dirty but changes nothing: both rows of its
    chunk invisible."""
    steps = _script(11, rounds=4)
    blank = _li_arrays(np.random.default_rng(3), 0)
    steps += [("f", _chunk_pair("lineitem", *blank)), ("b",), ("b",)]
    fact, dim = _messages(steps)
    je, pe = _executors(QUERIES["q17"], capacity=64, watchdog=None,
                        fact_msgs=fact, dim_msgs=dim)
    jl, pl = _run(je), _run(pe)
    assert [len(x) for x in pl] == [len(x) for x in jl] \
        == [0, 1, 1, 1, 1, 1, 0]
    for jb, pb in zip(jl, pl):
        for jo, po in zip(jb, pb):
            _assert_diff_equal(jo, po)
    assert pe.capacity == je.capacity == 256
    assert _np(pl[5][0].vis).tolist() == [False, False]


@pytest.mark.parametrize("kind,ret", [("SUM", "FLOAT64"), ("SUM", "INT64"),
                                      ("COUNT", "INT64"), ("MIN", "INT64"),
                                      ("MAX", "INT64"), ("MIN", "FLOAT64")])
def test_agg_specs_at_store_capacity(kind, ret):
    """expr/agg.py's partial and emit at num_segments = C, as the flush
    calls them: SUM with a FLOAT64 result over an INT64 argument (avg's
    sum half), COUNT over a column, append-only MIN and MAX, against
    the JAX package's AggSpec on the same values, signs and sorted
    segments (most segments empty)."""
    import jax.numpy as jnp
    from risingwave_tpu.common.types import DataType as JDT
    from risingwave_tpu.expr.agg import AggCall as JCall, AggKind as JKind
    from risingwave_tpu_torch.common.types import DataType
    from risingwave_tpu_torch.expr.agg import AggCall, AggKind
    C = 256
    rng = np.random.default_rng(4)
    vals = rng.integers(-1000, 1000, C)
    if ret == "FLOAT64" and kind != "SUM":
        vals = vals / 8.0
    signs = rng.integers(0, 2, C).astype(np.int32)
    segs = np.sort(rng.integers(0, 40, C)).astype(np.int32)
    j = JCall(JKind[kind], 0, JDT[ret], True).spec()
    p = AggCall(AggKind[kind], 0, DataType[ret], True).spec()
    jo = np.asarray(j.emit(j.partial(jnp.asarray(vals), jnp.asarray(signs),
                                     jnp.asarray(segs), C)))
    po = p.emit(p.partial(torch.from_numpy(vals), torch.from_numpy(signs),
                          torch.from_numpy(segs).to(torch.int64), C)).numpy()
    assert po.dtype == jo.dtype and po.shape == (C,)
    np.testing.assert_array_equal(po, jo)


def test_kernel_argument_tables():
    """The per-call tables the K15 and K16 wrappers pass their kernels
    (built on any device; the kernels run only on the card): kind codes,
    argument widths and float flags, state and result types, for
    COUNT(*), COUNT over a float column, SUM FLOAT64 over INT64, MIN
    over INT32 and MAX over FLOAT64; an integer SUM of a float column is
    refused."""
    from risingwave_tpu_torch.common.types import DataType as D
    from risingwave_tpu_torch.expr.agg import AggCall, AggKind as K
    from risingwave_tpu_torch.stream import snapshot_join_agg as sja
    n, dev = 8, torch.device("cpu")
    cols = [torch.zeros(n, dtype=torch.int64),
            torch.zeros(n, dtype=torch.float64),
            torch.zeros(n, dtype=torch.int32)]
    valids = [torch.ones(n, dtype=torch.bool), None,
              torch.ones(n, dtype=torch.bool)]
    calls = [AggCall(K.COUNT, None, D.INT64, True),
             AggCall(K.COUNT, 1, D.INT64, True),
             AggCall(K.SUM, 0, D.FLOAT64, True),
             AggCall(K.MIN, 2, D.INT32, True),
             AggCall(K.MAX, 1, D.FLOAT64, True)]
    kinds, args, widths, floats, vs, states, rets = sja._call_tables(
        calls, cols, valids, n, dev)
    assert kinds == [0, 0, 1, 2, 3]
    assert args[0] is None and args[1] is cols[1] and vs[1] is None
    assert widths == [8, 8, 8, 4, 8] and floats == [0, 1, 0, 0, 1]
    assert states == [torch.int64, torch.int64, torch.float64, torch.int64,
                      torch.float64]
    assert rets == [torch.int64, torch.int64, torch.float64, torch.int32,
                    torch.float64]
    with pytest.raises(NotImplementedError, match="float column"):
        sja._call_tables([AggCall(K.SUM, 1, D.INT64, True)], cols, valids,
                         n, dev)
