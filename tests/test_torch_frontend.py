"""The port's SQL frontend against the JAX package's: the parser gives
the same AST for bench.py's DDL, the planner gives the same fragments,
node kinds and executor arguments for bench_q8's statements and for
tests/test_wm_derivation.py's q8 view, for bench_q17's statements and
tests/test_tpch_q17.py's view (the fused snapshot join-agg), what the
port cannot plan yet raises BindError, and chip_smoke.py's q8 and q17
statements are bench.py's.

WHERE (Nexmark q2, a filter over an aggregating subquery, the pushdown
below an inner join) and ORDER BY ... LIMIT (bench.py's q5_topn on one
device) plan as JAX's binder plans them, and q5_topn and q2 run through
both sessions to the same MV. LEFT, RIGHT and FULL outer joins,
temporal joins and `col OP now()` filters plan as JAX's binder plans
them and run through both sessions to the same MV; JAX's refusals of
them stay refusals in JAX's words.

bench.py is read as source (its DDL lists evaluated from the syntax
tree), never imported."""

import ast
import asyncio
import enum
import pathlib
from collections import Counter

import numpy as np
import pytest

from risingwave_tpu.frontend import Session as JaxSession
from risingwave_tpu.frontend import sql as jsql
from risingwave_tpu.frontend.binder import StreamPlanner as JaxPlanner
from risingwave_tpu.plan.graph import Exchange as JExchange

ROOT = pathlib.Path(__file__).resolve().parent.parent
W = 10_000_000


@pytest.fixture(autouse=True, scope="module")
def _port():
    """Import torch and the port when these tests run, not at collection:
    an xdist worker then runs the JAX tests before them without torch
    (the sharded-join recovery tests abort more often with it loaded)."""
    global psql, PortSession, PortPlanner, PExchange, BindError, chip_smoke
    import chip_smoke
    from risingwave_tpu_torch.frontend import BindError, Session as PortSession
    from risingwave_tpu_torch.frontend import sql as psql
    from risingwave_tpu_torch.frontend.binder import (
        StreamPlanner as PortPlanner)
    from risingwave_tpu_torch.plan.graph import Exchange as PExchange


def bench_ddl(func: str, **names) -> list:
    """The first `ddl = [...]` list of bench.py's function `func`,
    evaluated with bench.py's W and the given local names."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    fn = next(n for n in tree.body if isinstance(
        n, (ast.FunctionDef, ast.AsyncFunctionDef)) and n.name == func)
    assign = next(n for n in ast.walk(fn) if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "ddl")
    code = compile(ast.Expression(assign.value), "bench.py", "eval")
    return eval(code, {"W": W, **names})


def bench_returned_ddl(func: str) -> list:
    """The list literal bench.py's function `func` returns."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == func)
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
    return eval(compile(ast.Expression(ret.value), "bench.py", "eval"),
                {"W": W})


def bench_q17_ddl(func: str = "bench_q17") -> list:
    """bench_q17's statement list (the `for stmt in [...]` loop), with
    the function's own CS; or another function's such list."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    fn = next(n for n in tree.body if isinstance(
        n, ast.AsyncFunctionDef) and n.name == func)
    names = {n.targets[0].id: ast.literal_eval(n.value)
             for n in fn.body if isinstance(n, ast.Assign)
             and isinstance(n.targets[0], ast.Name)
             and isinstance(n.value, ast.Constant)}
    loop = next(n for n in ast.walk(fn) if isinstance(n, ast.For)
                and isinstance(n.iter, ast.List))
    code = compile(ast.Expression(loop.iter), "bench.py", "eval")
    return eval(code, {"W": W, **names})


def bench_q17_other_statements() -> list:
    """The string constants bench_q17 executes outside that list."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    fn = next(n for n in tree.body if isinstance(
        n, ast.AsyncFunctionDef) and n.name == "bench_q17")
    return [n.args[0].value for n in ast.walk(fn)
            if isinstance(n, ast.Call) and getattr(n.func, "attr", "")
            == "execute" and n.args and isinstance(n.args[0], ast.Constant)]


# tests/test_tpch_q17.py's view, over bench_q17's sources
Q17_MV = (
    "CREATE MATERIALIZED VIEW q17 AS "
    "SELECT sum(L.l_extendedprice) / 7.0 AS avg_yearly "
    "FROM lineitem L "
    "JOIN part P ON P.p_partkey = L.l_partkey "
    "JOIN (SELECT l_partkey AS agg_partkey, "
    "             0.2 * avg(l_quantity) AS avg_quantity "
    "      FROM lineitem GROUP BY l_partkey) A "
    "  ON A.agg_partkey = L.l_partkey "
    " AND L.l_quantity < A.avg_quantity "
    "WHERE P.p_brand = 'Brand#23' AND P.p_container = 'MED BOX'")


BENCH_DDL = {
    "q1": lambda: bench_ddl("bench_q1"),
    "q17": bench_q17_ddl,
    "q5": lambda: bench_ddl("_q5_ddl", cs=131072),
    "q5_mesh": lambda: bench_ddl("_q5_ddl", cs=32768),
    "q7": lambda: bench_ddl("_q7_ddl", cs=131072),
    "q7d": lambda: bench_ddl("bench_q7d"),
    "q7_kill": lambda: bench_q17_ddl("bench_q7_kill"),
    "q8": lambda: bench_ddl("bench_q8"),
    "q5_topn": lambda: bench_returned_ddl("_q5_topn_ddl"),
}

BID_SOURCE = ("CREATE SOURCE bid WITH (connector='nexmark', table='bid', "
              "chunk_size=131072, emit_watermarks=1)")
# WHERE over an aggregating subquery: update pairs cross the filter
WHERE_AGG_DDL = [
    "SET streaming_durability = 0",
    BID_SOURCE,
    ("CREATE MATERIALIZED VIEW m AS SELECT auction, n FROM "
     "(SELECT auction, count(*) AS n FROM bid GROUP BY auction) C "
     "WHERE n % 2 = 0"),
]
# WHERE over an inner join: one conjunct a side is pushed below it, the
# cross-side one stays above
WHERE_JOIN_DDL = [
    "SET streaming_durability = 0",
    *(f"CREATE SOURCE {t} WITH (connector='nexmark', table='{t}', "
      f"chunk_size=1024, primary_key='id')" for t in ("person", "auction")),
    ("CREATE MATERIALIZED VIEW m AS SELECT P.id, A.id AS aid, A.reserve "
     "FROM person P JOIN auction A ON P.id = A.seller "
     "WHERE A.reserve % 7 = 1 AND P.id % 2 = 0 AND A.reserve > P.id"),
]

WM_Q8_DDL = [
    "SET streaming_durability = 0",
    "SET streaming_join_capacity = 8192",
    "SET streaming_join_match_factor = 16",
    *(f"CREATE SOURCE {t} WITH (connector='nexmark', table='{t}', "
      f"chunk_size={cs}, rate_limit={cs}, inter_event_us=2000, "
      f"emit_watermarks=1)" for t, cs in (("person", 256),
                                          ("auction", 768))),
    (f"CREATE MATERIALIZED VIEW q8 AS "
     f"SELECT P.id AS pid, A.id AS aid "
     f"FROM TUMBLE(person, date_time, {W}) P "
     f"JOIN TUMBLE(auction, date_time, {W}) A "
     f"ON P.id = A.seller AND P.window_start = A.window_start"),
]


@pytest.mark.parametrize("query", sorted(BENCH_DDL))
def test_parse_gives_jax_ast(query):
    ddl = BENCH_DDL[query]()
    assert len(ddl) >= 3
    for stmt in ddl:
        assert repr(psql.parse(stmt)) == repr(jsql.parse(stmt))


def _value_sig(v):
    """Comparable form of a node argument: expressions by their repr,
    aggregate calls by their fields, enums by value, watermark
    transforms by kind and window."""
    if isinstance(v, enum.Enum):
        return v.value
    if hasattr(v, "preceding") and hasattr(v, "offset"):
        return ("window", v.kind, v.arg, v.preceding, v.name, v.offset)
    if hasattr(v, "kind") and hasattr(v, "append_only"):
        return ("agg", v.kind.value, v.arg, v.ret_type.value,
                v.append_only)
    if isinstance(v, dict):
        return {k: _value_sig(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v).__name__, tuple(_value_sig(x) for x in v)
    if hasattr(v, "ret_type"):
        return "expr", repr(v), v.ret_type.value
    if hasattr(v, "size") and callable(v):
        return type(v).__name__, v.size
    return v


# sorted-join arguments of the JAX planner's mesh placement, which the
# port does not plan (ROADMAP A9)
JAX_ONLY_ARGS = {"mesh_devices", "mesh_shuffle", "mesh_shuffle_slack",
                 "mesh_shuffle_adaptive", "mesh_chain"}


def _node_sig(n, exchange_cls, strip=()):
    if isinstance(n, exchange_cls):
        return ("exchange", n.upstream)
    args = {k: _value_sig(v) for k, v in n.args.items() if k not in strip}
    return (n.kind, args, tuple(_node_sig(i, exchange_cls, strip)
                                for i in n.inputs))


def _graph_sig(graph, exchange_cls, strip=()):
    return {fid: (f.dispatch, f.parallelism, tuple(f.dist_key_indices),
                  _node_sig(f.root, exchange_cls, strip))
            for fid, f in graph.fragments.items()}


def _plans(ddl):
    """(JAX plan, port plan) of the last statement after running the
    others in a session of each engine."""
    *setup, last = ddl

    async def jax_plan():
        s = JaxSession()
        for stmt in setup:
            await s.execute(stmt)
        st = jsql.parse(last)
        p = JaxPlanner(s.catalog, config=s.config)
        return (p.plan_sink(st.select, st.options)
                if isinstance(st, jsql.CreateSink) else
                p.plan_select(st.select))

    async def port_plan():
        s = PortSession(device="cpu")
        for stmt in setup:
            await s.execute(stmt)
        st = psql.parse(last)
        p = PortPlanner(s.catalog, config=s.config)
        return (p.plan_sink(st.select, st.options)
                if isinstance(st, psql.CreateSink) else
                p.plan_select(st.select))

    return asyncio.run(jax_plan()), asyncio.run(port_plan())


# tests/test_outer_join_sql.py's sources and views, a RIGHT join, the
# temporal joins and NOW() filters of tests/test_missing_executors.py
OUTER_SOURCES = [
    "SET streaming_durability = 0",
    "SET streaming_join_capacity = 4096",
    "SET streaming_agg_capacity = 1024",
    ("CREATE SOURCE auction WITH (connector='nexmark', table='auction', "
     "chunk_size=256, rate_limit=512)"),
    ("CREATE SOURCE person WITH (connector='nexmark', table='person', "
     "chunk_size=128, rate_limit=256)"),
]
TEMPORAL_SOURCES = [
    "SET streaming_durability = 0",
    "SET streaming_join_capacity = 4096",
    ("CREATE SOURCE bid WITH (connector='nexmark', table='bid', "
     "chunk_size=128, rate_limit=128)"),
    ("CREATE SOURCE auction WITH (connector='nexmark', table='auction', "
     "primary_key='id', chunk_size=64, rate_limit=64)"),
]
OUTER_VIEWS = {
    "left": (OUTER_SOURCES, (
        "SELECT A.id, P.name FROM auction A "
        "LEFT OUTER JOIN person P ON A.seller = P.id AND A.category = 10")),
    "full": (OUTER_SOURCES, (
        "SELECT A.id, P.id AS pid FROM auction A "
        "FULL OUTER JOIN person P ON A.seller = P.id AND A.category = 10")),
    "right": (OUTER_SOURCES, (
        "SELECT A.id, P.id AS pid, P.name FROM auction A "
        "RIGHT JOIN person P ON A.seller = P.id AND A.reserve % 3 = 0")),
    # a LEFT join of a retracting aggregate: degrees fall and rise
    "left_agg": (OUTER_SOURCES, (
        "SELECT P.id, S.n FROM person P LEFT JOIN "
        "(SELECT seller, count(*) AS n FROM auction WHERE category = 10 "
        "GROUP BY seller) S ON P.id = S.seller")),
    "temporal": (TEMPORAL_SOURCES, (
        "SELECT B.auction, B.price, A.category FROM bid B "
        "JOIN auction A FOR SYSTEM_TIME AS OF PROCTIME() "
        "ON B.auction = A.id")),
    "temporal_left": (TEMPORAL_SOURCES, (
        "SELECT B.auction, B.price, A.category FROM bid B "
        "LEFT JOIN auction A FOR SYSTEM_TIME AS OF PROCTIME() "
        "ON B.auction = A.id")),
    # the generator's event time is 2017 (1.5e15 us) and the epoch clock
    # counts from 2022 (~1.5e14 us): every row passes > now(), none < now()
    "now_gt": (TEMPORAL_SOURCES[:1] + TEMPORAL_SOURCES[3:], (
        "SELECT id, expires FROM auction WHERE expires > now()")),
    "now_lt": (TEMPORAL_SOURCES[:1] + TEMPORAL_SOURCES[3:], (
        "SELECT id, expires FROM auction WHERE now() > expires")),
    # a static conjunct grafts first; bid is keyless (a row id first)
    "now_keyless": (TEMPORAL_SOURCES[:3], (
        "SELECT auction, price FROM bid "
        "WHERE date_time >= now() AND price % 2 = 0")),
}


def _outer_ddl(view: str) -> list:
    src, select = OUTER_VIEWS[view]
    return src + ["CREATE MATERIALIZED VIEW m AS " + select]


# the window and global-aggregate statements the JAX package's goldens
# run (tests/test_over_window_sql.py:48, tests/test_nexmark_queries.py:86,
# tests/test_eowc_over_window.py:15), over two watermarked sources
WINDOW_SOURCES = [
    "SET streaming_durability = 0",
    "SET streaming_join_capacity = 4096",
    "SET streaming_agg_capacity = 1024",
    "SET streaming_over_window_capacity = 4096",
    *(f"CREATE SOURCE {t} WITH (connector='nexmark', table='{t}', "
      f"chunk_size=256, rate_limit=512, emit_watermarks=1)"
      for t in ("auction", "bid")),
]
WINDOW_VIEWS = {
    "q6": "CREATE MATERIALIZED VIEW m AS " + (
        "SELECT Q.seller, Q.id, "
        "avg(Q.final) OVER (PARTITION BY Q.seller ORDER BY Q.id "
        "ROWS BETWEEN 9 PRECEDING AND CURRENT ROW) AS avgf "
        "FROM (SELECT max(B.price) AS final, A.seller, A.id "
        "      FROM auction A JOIN bid B ON A.id = B.auction "
        "        AND B.date_time BETWEEN A.date_time AND A.expires "
        "      GROUP BY A.id, A.seller) Q"),
    "q4": "CREATE MATERIALIZED VIEW m AS " + (
        "SELECT Q.category, AVG(Q.final) AS avg "
        "FROM (SELECT MAX(B.price) AS final, A.category "
        "      FROM auction A, bid B "
        "      WHERE A.id = B.auction "
        "        AND B.date_time BETWEEN A.date_time AND A.expires "
        "      GROUP BY A.id, A.category) Q "
        "GROUP BY Q.category"),
    "eowc": "CREATE MATERIALIZED VIEW m AS " + (
        "SELECT auction, date_time, price, "
        "row_number() OVER (PARTITION BY auction ORDER BY date_time) AS rn, "
        "sum(price) OVER (PARTITION BY auction ORDER BY date_time) AS sp "
        "FROM bid EMIT ON WINDOW CLOSE"),
    "general": "CREATE MATERIALIZED VIEW m AS " + (
        "SELECT auction, date_time, price, "
        "row_number() OVER (PARTITION BY auction ORDER BY date_time) AS rn, "
        "sum(price) OVER (PARTITION BY auction ORDER BY date_time) AS sp "
        "FROM bid"),
    "gagg": ("CREATE MATERIALIZED VIEW m AS SELECT count(*), sum(price), "
             "max(price) FROM bid"),
    "gagg_q6": ("CREATE MATERIALIZED VIEW m AS SELECT avg(Q.final), "
                "count(*) FROM (SELECT max(B.price) AS final, A.seller, "
                "A.id FROM auction A JOIN bid B ON A.id = B.auction "
                "AND B.date_time BETWEEN A.date_time AND A.expires "
                "GROUP BY A.id, A.seller) Q"),
}


def _q5c_ddl(watermarks: bool = False, durable: bool = False) -> list:
    """The canonical Nexmark q5 (chip_smoke.Q5C_SELECT) at a small
    geometry: 1024-bid chunks, one bid every 2 ms, 2048 bids a
    barrier (the rate limit makes the barriers' contents deterministic),
    4096-slot aggs and join sides. With `watermarks` the source emits
    them and the watchdog is on (the reference finding's shape)."""
    ddl = chip_smoke.q5c_ddl(1024, durable_=int(durable), agg_cap=4096,
                             join_cap=4096)
    src = "inter_event_us=2000, rate_limit=2048"
    if watermarks:
        src += ", emit_watermarks=1"
        ddl = [st for st in ddl if "streaming_watchdog" not in st]
    return [st.replace("inter_event_us=2)", src + ")") for st in ddl]


def _q5_mv_ddl() -> list:
    """bench.py's _q5_ddl() as an MV at 1024-bid chunks, 2048 bids a
    barrier and a 4096-slot agg."""
    return [st.replace("CREATE SINK", "CREATE MATERIALIZED VIEW")
              .replace(" WITH (connector='blackhole_device')", "")
              .replace("chunk_size=131072", "chunk_size=1024, rate_limit=2048")
              .replace(f"{1 << 20}", "4096")
            for st in BENCH_DDL["q5"]()]


def _window_ddl(view: str, durable: bool = False) -> list:
    ddl = WINDOW_SOURCES + [WINDOW_VIEWS[view]]
    if durable:
        ddl[0] = "SET streaming_durability = 1"
    return ddl


PLANNED_DDL = {
    "q8": BENCH_DDL["q8"], "q8_mv": lambda: WM_Q8_DDL,
    "q1": BENCH_DDL["q1"], "q17": BENCH_DDL["q17"],
    "q17_mv": lambda: BENCH_DDL["q17"]()[:-1] + [Q17_MV],
    "q7": BENCH_DDL["q7"], "q7d": BENCH_DDL["q7d"],
    "q7_kill": BENCH_DDL["q7_kill"],
    "q5_topn": lambda: chip_smoke.Q5T_DDL,
    "q5_topn_durable_mv": lambda: [
        st.replace("SET streaming_durability = 0",
                   "SET streaming_durability = 1")
          .replace("CREATE SINK", "CREATE MATERIALIZED VIEW")
          .replace(" WITH (connector='blackhole_device')", "")
        for st in chip_smoke.Q5T_DDL],
    "q2": lambda: chip_smoke.Q2_DDL,
    "q5": BENCH_DDL["q5"],
    "q5c": lambda: _q5c_ddl(),
    "q5c_watermarked": lambda: _q5c_ddl(watermarks=True),
    "q5c_durable": lambda: _q5c_ddl(durable=True),
    "where_agg": lambda: WHERE_AGG_DDL,
    "where_join": lambda: WHERE_JOIN_DDL,
    **{f"window_{v}": (lambda v=v: _window_ddl(v)) for v in WINDOW_VIEWS},
    **{f"window_{v}_durable": (lambda v=v: _window_ddl(v, True))
       for v in ("q6", "eowc", "gagg")},
    **{f"outer_{v}": (lambda v=v: _outer_ddl(v)) for v in OUTER_VIEWS},
    # the WHERE sink the port refused before it planned filters
    "where_sink": lambda: [
        "SET streaming_durability = 0", BID_SOURCE,
        ("CREATE SINK s AS SELECT auction FROM bid WHERE price > 10 "
         "WITH (connector='blackhole_device')")],
}


@pytest.mark.parametrize("query", list(PLANNED_DDL))
def test_planner_gives_jax_fragments_and_arguments(query):
    ddl = PLANNED_DDL[query]()
    jp, pp = _plans(ddl)
    js = _graph_sig(jp.graph, JExchange, strip=JAX_ONLY_ARGS)
    ps = _graph_sig(pp.graph, PExchange)
    assert ps == js
    assert pp.mv_fragment == jp.mv_fragment
    assert pp.pk_indices == jp.pk_indices
    assert pp.append_only == jp.append_only
    assert [(f.name, f.data_type.value) for f in pp.schema] == \
        [(f.name, f.data_type.value) for f in jp.schema]
    if query.startswith("q8"):
        # the join the issue planned with the JAX session: five
        # fragments, two-column keys, pair cleaning on window_start
        join = pp.graph.fragments[5].root
        while join.kind != "sorted_join":
            join = join.inputs[0]
        a = join.args
        assert (a["left_key_indices"], a["right_key_indices"]) == \
            ([0, 1], [1, 2])
        assert a["clean_specs"] == (("pair", 1, 1), ("pair", 2, 1))
        assert a["append_only"] == (True, True)
        assert a["capacity"] == (1 << 19 if query == "q8" else 8192)
        # bench's sources declare primary_key='id': a person row is
        # unique per join key, so probing the person side needs only
        # min(2, mf) slots a row; the view's keyless sources get row ids
        assert a["match_factors"] == ((2, 2) if query == "q8" else (16, 16))
        assert a["durable"] is False
    if query.startswith("q17"):
        # one fused executor fed by the two tpch sources (through their
        # no_op fragments), as JAX's binder lowers it
        kinds = {f.fid: f.root.kind for f in pp.graph.fragments.values()}
        fused = [f for f in pp.graph.fragments.values()
                 if (f.root.kind == "snapshot_join_agg"
                     or f.root.inputs and getattr(f.root.inputs[0], "kind",
                                                  None)
                     == "snapshot_join_agg")]
        assert len(fused) == 1 and "sorted_join" not in kinds.values()
        node = fused[0].root
        if node.kind != "snapshot_join_agg":
            node = node.inputs[0]
        a = node.args
        assert (a["fact_key"], a["dim_key"]) == (1, 0)
        assert [c.kind.value for c in a["sub_agg_calls"]] == ["sum", "count"]
        assert repr(a["residue"]) == "less_than($2, $4)"
        assert a["capacity"] == 1 << 20 and a["dim_capacity"] == 1 << 16
        assert a["watchdog_interval"] is None and a["durable"] is False
    if query.startswith("q7"):
        # the source broadcast to the TUMBLE projection and the bids; the
        # max agg (hash dispatch on window_end, cleaning on it) and the
        # sorted join, durable unless q7's volatile statements say not
        def node_of(kind):
            for f in pp.graph.fragments.values():
                n = f.root
                while getattr(n, "kind", None) not in (kind, None):
                    n = n.inputs[0] if n.inputs else None
                if getattr(n, "kind", None) == kind:
                    return f, n
        frag, agg = node_of("hash_agg")
        a = agg.args
        assert frag.dispatch == "hash" and frag.parallelism == 1
        assert a["cleaning_watermark_col"] == 0
        assert a["durable"] is (query != "q7")
        assert [c.kind.value for c in a["agg_calls"]] == ["max"]
        assert a["capacity"] == 1 << 13
        _, join = node_of("sorted_join")
        assert join.args["durable"] is (query != "q7")
        assert join.args["clean_specs"] == (("band", 3, 1, -W, None),
                                            ("band", 1, 3, 0, 1))
    kinds = [n.kind for f in pp.graph.fragments.values()
             for n in _nodes(f.root, PExchange)]
    if query.startswith("q5_topn"):
        # source -> project(auction % 65536) -> hash_agg -> the top-N, a
        # singleton ranking n DESC over the agg's changelog
        top = next(n for f in pp.graph.fragments.values()
                   for n in _nodes(f.root, PExchange)
                   if n.kind == "retract_top_n")
        a = top.args
        assert a["order_specs"] == [(1, True)] and a["limit"] == 10
        assert a["pk_indices"] == [0] and a["group_key_indices"] == ()
        assert a["capacity"] == 1 << 17
        assert a["durable"] is (query != "q5_topn")
        assert a["watchdog_interval"] is None
    if query in ("q2", "where_agg", "where_sink"):
        assert kinds.count("filter") == 1
    if query == "where_join":
        # one conjunct pushed to each side, the cross-side one above
        join = next(n for f in pp.graph.fragments.values()
                    for n in _nodes(f.root, PExchange)
                    if n.kind == "sorted_join")
        assert kinds.count("filter") == 3
        assert "sorted_join" in [n.kind for n in _nodes(
            next(f for f in pp.graph.fragments.values()
                 if any(x.kind == "filter" and x.inputs
                        and getattr(x.inputs[0], "kind", None)
                        == "sorted_join"
                        for x in _nodes(f.root, PExchange))).root,
            PExchange)]
        assert join.args["left_key_indices"] == [0]


def _nodes(n, exchange_cls) -> list:
    if isinstance(n, exchange_cls):
        return []
    out = [n]
    for i in n.inputs:
        out += _nodes(i, exchange_cls)
    return out


@pytest.mark.parametrize("sql", [
    # bool_and / bool_or, approx_count_distinct and MVs over MVs plan
    # since they were ported; these shapes are still refused: the hash
    # join (inner joins on FLOAT64 keys, here of an MV with itself),
    # parallelism > 1, the mesh, a batch SELECT
    lambda: [("CREATE MATERIALIZED VIEW m0 AS SELECT auction, avg(price) "
              "AS ap FROM bid GROUP BY auction"),
             ("CREATE MATERIALIZED VIEW m AS SELECT X.auction FROM m0 X "
              "JOIN m0 Y ON X.ap = Y.ap")],
    lambda: ("CREATE MATERIALIZED VIEW m AS SELECT X.auction FROM "
             "(SELECT auction, avg(price) AS ap FROM bid GROUP BY auction) X"
             " JOIN (SELECT auction, avg(price) AS ap FROM bid "
             "GROUP BY auction) Y ON X.ap = Y.ap"),
    lambda: ("CREATE MATERIALIZED VIEW m AS SELECT X.a FROM "
             "(SELECT auction AS a, 0.908 * price AS p FROM bid) X JOIN "
             "(SELECT id, 1.0 * reserve AS r FROM auction) Y ON X.p = Y.r"),
    lambda: ["SET streaming_parallelism = 2",
             ("CREATE MATERIALIZED VIEW m AS SELECT auction, count(*) AS n "
              "FROM bid GROUP BY auction")],
    lambda: "SET streaming_parallelism_devices = 8",
    lambda: "SELECT count(*) FROM bid",
])
def test_unported_sql_raises_bind_error(sql):
    async def go():
        s = PortSession(device="cpu")
        await s.execute("SET streaming_durability = 0")
        for t in ("bid", "person", "auction"):
            await s.execute(f"CREATE SOURCE {t} WITH (connector='nexmark',"
                            f" table='{t}', chunk_size=64)")
        stmts = sql()
        stmts = [stmts] if isinstance(stmts, str) else stmts
        for stmt in stmts[:-1]:
            await s.execute(stmt)
        n_mvs = len(s.catalog.mvs)
        with pytest.raises(BindError, match="not ported yet"):
            await s.execute(stmts[-1])
        assert len(s.catalog.mvs) == n_mvs and not s.catalog.sinks
        if n_mvs:
            await s.shutdown()
    asyncio.run(go())


@pytest.mark.parametrize("case", ["keyless", "varchar", "no_limit",
                                  "no_order"])
def test_top_n_refusals_are_jaxs(case):
    """The binder's own refusals, in JAX's words and in both engines: a
    top-N over a keyless stream (bid has no stream key), streaming ORDER
    BY over VARCHAR, ORDER BY without LIMIT and LIMIT without ORDER
    BY."""
    sql = {
        "keyless": ("CREATE MATERIALIZED VIEW m AS SELECT auction, price "
                    "FROM bid ORDER BY price LIMIT 3"),
        "varchar": ("CREATE MATERIALIZED VIEW m AS SELECT channel, "
                    "count(*) AS n FROM bid GROUP BY channel "
                    "ORDER BY channel LIMIT 3"),
        "no_limit": ("CREATE MATERIALIZED VIEW m AS SELECT auction, "
                     "count(*) AS n FROM bid GROUP BY auction ORDER BY n"),
        "no_order": ("CREATE MATERIALIZED VIEW m AS SELECT auction, "
                     "count(*) AS n FROM bid GROUP BY auction LIMIT 3"),
    }[case]
    match = {"keyless": "keyless stream", "varchar": "over VARCHAR",
             "no_limit": "needs a LIMIT", "no_order": "needs ORDER BY"}

    async def go(session, err):
        s = session()
        await s.execute("SET streaming_durability = 0")
        await s.execute("CREATE SOURCE bid WITH (connector='nexmark', "
                        "table='bid', chunk_size=64)")
        with pytest.raises(err, match=match[case]):
            await s.execute(sql)
    from risingwave_tpu.frontend.binder import BindError as JaxBindError
    asyncio.run(go(JaxSession, JaxBindError))
    asyncio.run(go(lambda: PortSession(device="cpu"), BindError))


def test_mesh_top_n_raises():
    """streaming_parallelism_devices: 1 is accepted, the mesh refused."""
    async def go():
        s = PortSession(device="cpu")
        assert await s.execute("SET streaming_parallelism_devices = 1") == 1
        assert await s.execute(
            "SET streaming_top_n_capacity = 4096") == 4096
        with pytest.raises(BindError, match="not ported yet"):
            await s.execute("SET streaming_parallelism_devices = 8")
        assert s.config["streaming_parallelism_devices"] == 1
    asyncio.run(go())


def test_durable_state_and_batch_select_raise():
    """The default (durable) state plans and runs; batch SELECT and the
    stuck-barrier watchdog's setting stay refused."""
    async def go():
        s = PortSession(device="cpu")
        await s.execute("CREATE SOURCE bid WITH (connector='nexmark', "
                        "table='bid', chunk_size=64)")
        # the default is durable (JAX's): the plan carries state tables
        assert s.config["streaming_durability"] == 1
        assert await s.execute("SET streaming_durability = 1") == 1
        await s.execute("CREATE SINK k AS SELECT auction FROM bid "
                        "WITH (connector='blackhole_device')")
        await s.tick(2)
        assert s.coord.committed_epochs
        assert s._ddl_log[-1]["kind"] == "sink"
        assert s._ddl_log[-1]["config"]["streaming_durability"] == 1
        with pytest.raises(BindError, match="not ported yet"):
            await s.execute("SELECT * FROM bid")
        # bench_q17's stuck-barrier watchdog setting (ROADMAP A5): refused,
        # never accepted as a no-op
        with pytest.raises(BindError, match="unknown session variable"):
            await s.execute("SET barrier_stall_threshold_ms = 15000")
        assert await s.execute("SET streaming_durability = 0") == 0
        assert await s.execute("SET streaming_agg_capacity = 64") == 64
        assert await s.execute("SET checkpoint_max_inflight = 0") == 0
        assert not s.coord.pipelined
        await s.shutdown()
    asyncio.run(go())


def test_config_defaults_are_jaxs():
    """A session starts from the JAX package's variables and defaults, in
    its order (each catalog entry records them); every variable the port
    can SET is one of them."""
    from risingwave_tpu_torch.frontend.session import JAX_CONFIG_DEFAULTS
    jax_defaults = [(k, v) for k, (v, _) in JaxSession.CONFIG_VARS.items()]
    assert list(JAX_CONFIG_DEFAULTS.items()) == jax_defaults
    assert list(PortSession(device="cpu").config.items()) == jax_defaults
    assert set(PortSession.CONFIG_VARS) <= set(JAX_CONFIG_DEFAULTS)


def test_chip_smoke_q7_statements_are_bench_q7s():
    """chip_smoke's q7 lists are bench.py's _q7_ddl(), bench_q7d and
    bench_q7_kill statements (bench_q7_kill's watchdog SET stays out)."""
    assert chip_smoke.Q7_DDL == BENCH_DDL["q7"]()
    assert chip_smoke.Q7D_DDL == BENCH_DDL["q7d"]()
    assert chip_smoke.Q7K_DDL == BENCH_DDL["q7_kill"]()
    assert f"chunk_size={chip_smoke.Q7D_CHUNK}," in chip_smoke.Q7D_DDL[6]
    assert f"chunk_size={chip_smoke.Q7K_CHUNK}," in chip_smoke.Q7K_DDL[6]


def test_chip_smoke_q5_statements_are_bench_q5s():
    """chip_smoke's q5_sql list is bench.py's _q5_ddl(), verbatim, and
    its canonical q5 keeps bench's SETs and source (no watermarks) and
    adds the join's capacity."""
    assert chip_smoke.Q5_SQL_DDL == BENCH_DDL["q5"]()
    ddl = chip_smoke.q5c_ddl()
    assert ddl[:3] == BENCH_DDL["q5"]()[:3]
    assert ddl[3] == f"SET streaming_join_capacity = {1 << 20}"
    assert ddl[4] == BENCH_DDL["q5"]()[3].replace(", emit_watermarks=1", "")


@pytest.fixture(scope="module")
def q5_jax_mvs():
    """The JAX session's MVs of the canonical q5 and of _q5_ddl() as an
    MV after 6 barriers, and the barrier at which the watermarked
    canonical q5 fail-stops with its cause (one JAX session each, run
    once for the module)."""
    async def failing(engine):
        s = (JaxSession() if engine == "jax"
             else PortSession(device="cpu"))
        for stmt in _q5c_ddl(watermarks=True):
            await s.execute(stmt)
        dep = s.catalog.mvs["q5c"].deployment
        for k in range(1, 7):
            try:
                if engine == "jax":
                    await s.tick(1, max_recoveries=0)
                else:
                    await s.tick(1)
            except RuntimeError:
                causes = sorted(str(t.exception()) for t in dep.tasks
                                if t.done() and t.exception() is not None)
                if engine == "port":
                    await s.crash()
                return k, causes
        return None, []

    return dict(q5c=_mv_rows("jax", _q5c_ddl(), "q5c", 6),
                q5=_mv_rows("jax", _q5_mv_ddl(), "q5", 6),
                failing=asyncio.run(failing("jax")), failing_fn=failing)


def test_q5c_and_q5_through_sql_match_jax(q5_jax_mvs):
    """The canonical q5 (HOP through SQL, a retractable MAX over a COUNT's
    changelog, a join of two retracting aggregates with the residue num
    >= maxn) and bench.py's _q5_ddl() as an MV run through both
    sessions to the same rows."""
    got = _mv_rows("port", _q5c_ddl(), "q5c", 6)
    assert got == q5_jax_mvs["q5c"] and len(got) >= 10
    got = _mv_rows("port", _q5_mv_ddl(), "q5", 6)
    assert got == q5_jax_mvs["q5"] and len(got) >= 100


def test_watermarked_q5c_fail_stops_like_jax(q5_jax_mvs):
    """With the source's watermarks, the aggregates pass each watermark
    on before the barrier flush that retracts the rows below it, the
    join's pair cleaning has evicted them, and both engines fail-stop
    at the same barrier with the join's changelog inconsistency (the
    reference finding; ROADMAP's operational notes)."""
    k, causes = asyncio.run(q5_jax_mvs["failing_fn"]("port"))
    jk, jcauses = q5_jax_mvs["failing"]
    assert k is not None and k == jk
    assert causes == jcauses
    assert any("changelog inconsistency" in c for c in causes)


def test_chip_smoke_q5t_statements_are_bench_q5_topns():
    """chip_smoke's q5_topn list is bench.py's _q5_topn_ddl() with one
    line changed: the 8-device mesh SET becomes 1."""
    bench = BENCH_DDL["q5_topn"]()
    assert len(chip_smoke.Q5T_DDL) == len(bench)
    diff = [(a, b) for a, b in zip(chip_smoke.Q5T_DDL, bench) if a != b]
    assert diff == [("SET streaming_parallelism_devices = 1",
                     "SET streaming_parallelism_devices = 8")]
    assert f"chunk_size={chip_smoke.Q5T_CHUNK}," in chip_smoke.Q5T_DDL[5]
    assert f"inter_event_us={chip_smoke.Q5T_INTER_US}," in \
        chip_smoke.Q5T_DDL[5]


def _mv_rows(engine: str, ddl: list, name: str, rounds: int) -> list:
    async def go():
        s = (JaxSession() if engine == "jax"
             else PortSession(device="cpu"))
        for stmt in ddl:
            await s.execute(stmt)
        await s.tick(rounds)
        rows = sorted(r for _, r in s.catalog.mvs[name].table.iter_all())
        await s.shutdown() if engine == "port" else None
        return rows
    return asyncio.run(go())


def test_q5_topn_and_q2_runs_match_jax():
    """q5_topn's statements as an MV (256-bid chunks, 4096-slot agg and
    store) and q2's as an MV (row ids dropped) run through both sessions
    to the same rows."""
    q5t = [st.replace("CREATE SINK", "CREATE MATERIALIZED VIEW")
             .replace(" WITH (connector='blackhole_device')", "")
             .replace("chunk_size=32768", "chunk_size=256, rate_limit=256")
             .replace(f"{1 << 18}", "4096").replace(f"{1 << 17}", "4096")
           for st in chip_smoke.Q5T_DDL]
    got, want = (_mv_rows(e, q5t, "q5t", 4) for e in ("port", "jax"))
    # this early the hot auctions leave fewer than 10 groups
    assert got == want and len(got) >= 5
    q2 = [st.replace("CREATE SINK", "CREATE MATERIALIZED VIEW")
            .replace(" WITH (connector='blackhole_device')", "")
            .replace("chunk_size=131072", "chunk_size=4096, rate_limit=8192")
          for st in chip_smoke.Q2_DDL]
    got, want = (_mv_rows(e, q2, "q2", 4) for e in ("port", "jax"))
    assert sorted(r[:2] for r in got) == sorted(r[:2] for r in want)
    assert got and all(r[0] % 123 == 0 for r in got)


def test_chip_smoke_q8_statements_are_bench_q8s():
    assert chip_smoke.Q8_DDL == BENCH_DDL["q8"]()
    assert chip_smoke.W == W
    assert chip_smoke.q8_ddl() == chip_smoke.Q8_DDL
    assert f"chunk_size={chip_smoke.Q8_PERSON_CHUNK}," in chip_smoke.Q8_DDL[4]
    assert f"chunk_size={chip_smoke.Q8_AUCTION_CHUNK}," in \
        chip_smoke.Q8_DDL[5]


def test_chip_smoke_q17_statements_are_bench_q17s():
    """chip_smoke drives bench_q17's list verbatim; the one statement
    bench_q17 runs outside it sets the JAX coordinator's stuck-barrier
    watchdog, which the port leaves out (and refuses)."""
    assert chip_smoke.Q17_DDL == BENCH_DDL["q17"]()
    assert chip_smoke.q17_ddl() == chip_smoke.Q17_DDL
    assert bench_q17_other_statements() == [
        "SET barrier_stall_threshold_ms = 15000"]
    assert chip_smoke.Q17_CS == 8192 and chip_smoke.Q17_QUOTA_CHUNKS == 64


@pytest.mark.parametrize("case", ["fuse_off", "no_dim_pk", "no_group_by",
                                  "left_join"])
def test_declined_q17_fusion_raises(case):
    """Where the snapshot join-agg fusion declines, JAX plans a changelog
    join cascade under a global aggregate. The port plans the same
    fragments now that it has the simple agg (fuse_off, no_dim_pk) and
    outer joins (left_join: a LEFT join of part under the aggregate),
    and raises JAX's own BindError where JAX does (no_group_by)."""
    ddl = BENCH_DDL["q17"]()
    last = ddl[-1]
    if case == "fuse_off":
        ddl.insert(-1, "SET streaming_snapshot_fuse = 0")
    elif case == "no_dim_pk":
        ddl[4] = ddl[4].replace(", primary_key='p_partkey'", "")
    elif case == "no_group_by":
        last = last.replace(" FROM lineitem GROUP BY l_partkey",
                            " FROM lineitem")
    else:
        last = last.replace("JOIN part P", "LEFT JOIN part P")
    ddl[-1] = last

    if case in ("fuse_off", "no_dim_pk", "left_join"):
        jp, pp = _plans(ddl)
        assert _graph_sig(pp.graph, PExchange) == _graph_sig(
            jp.graph, JExchange, strip=JAX_ONLY_ARGS)
        kinds = [n.kind for f in pp.graph.fragments.values()
                 for n in _nodes(f.root, PExchange)]
        assert "simple_agg" in kinds and "snapshot_join_agg" not in kinds
        return
    match = "must appear in GROUP BY"

    async def go():
        s = PortSession(device="cpu")
        for stmt in ddl[:-1]:
            await s.execute(stmt)
        with pytest.raises(BindError, match=match):
            await s.execute(ddl[-1])
        assert not s.catalog.sinks
    asyncio.run(go())


def _flow_sources(dep) -> list:
    """The source executors of a deployment (either engine's)."""
    found, seen = [], set()

    def walk(ex):
        if ex is None or id(ex) in seen:
            return
        seen.add(id(ex))
        if hasattr(ex, "connector") and hasattr(ex, "rate_limit"):
            found.append(ex)
        for attr in ("input", "left", "right"):
            walk(getattr(ex, attr, None))
        for x in getattr(ex, "inputs", None) or ():
            walk(x)
    for a in dep.actors:
        walk(a.consumer)
    return found


async def paced_ticks(s, name: str, rounds: int) -> None:
    """`rounds` barriers, each once every source of flow `name` emitted
    its rate limit of rows since the last: the same rows reach either
    engine before each barrier, whatever the host's pace."""
    dep = s.catalog.mvs[name].deployment
    srcs = _flow_sources(dep)
    for k in range(1, rounds + 1):
        while any(x.connector.offset < k * x.rate_limit for x in srcs):
            for t in dep.tasks:
                if t.done():
                    t.result()      # a dead actor raises here
            await asyncio.sleep(0.001)
        await s.tick(1)


def _view_rows(engine: str, view: str, rounds: int = 4) -> Counter:
    """The view's MV rows as committed at the last of `rounds` paced
    barriers (`paced_ticks`), the row id (a column the plan appends,
    derived from the wall clock) dropped."""
    async def go():
        s = (JaxSession() if engine == "jax"
             else PortSession(device="cpu"))
        for stmt in _window_ddl(view):
            await s.execute(stmt)
        await paced_ticks(s, "m", rounds)
        mv = s.catalog.mvs["m"]
        keep = [j for j, f in enumerate(mv.schema)
                if f.name not in ("_row_id", "_sk7")]
        rows = Counter(tuple(r[j] for j in keep)
                       for r in _committed_rows(mv))
        if engine == "port":
            await s.shutdown()
        return rows
    return asyncio.run(go())


@pytest.mark.parametrize("view", sorted(WINDOW_VIEWS))
def test_window_and_global_agg_views_match_jax(view):
    """q6, q4, the EOWC body (and without EOWC) and the two global
    aggregates run through both sessions to the same MV."""
    got, want = _view_rows("port", view), _view_rows("jax", view)
    assert got == want and sum(got.values()) >= (1 if "gagg" in view
                                                 or view == "q4" else 10)


def test_remaining_window_and_agg_refusals():
    """The sharded over-window (the mesh planner) and the stateless simple
    agg (planned only on the mesh path) raise "not ported yet"; EOWC's
    own refusals are JAX's in both engines."""
    from risingwave_tpu_torch.common import DataType, schema
    from risingwave_tpu_torch.expr.agg import count_star
    from risingwave_tpu_torch.plan.build import BUILDERS

    async def catalog():
        s = PortSession(device="cpu")
        for stmt in WINDOW_SOURCES:
            await s.execute(stmt)
        return s
    s = asyncio.run(catalog())
    st = psql.parse(WINDOW_VIEWS["q6"])
    planner = PortPlanner(s.catalog, config={
        **s.config, "streaming_parallelism_devices": 4})
    with pytest.raises(BindError, match="sharded over-window"):
        planner.plan_select(st.select)
    assert "stateless_simple_agg" not in BUILDERS
    graph = PortPlanner(s.catalog, config=s.config).plan_select(
        psql.parse(WINDOW_VIEWS["gagg"]).select).graph
    agg = next(f for f in graph.fragments.values()
               if f.root.inputs and getattr(f.root.inputs[0], "kind", None)
               == "simple_agg")
    agg.root.inputs[0].kind = "stateless_simple_agg"
    from risingwave_tpu_torch.meta import BarrierCoordinator
    from risingwave_tpu_torch.plan.build import BuildEnv, build_graph
    from risingwave_tpu_torch.state import MemoryStateStore
    store = MemoryStateStore()
    with pytest.raises(NotImplementedError, match="not ported yet"):
        build_graph(graph, BuildEnv(store, BarrierCoordinator(store), "cpu"))
    del schema, DataType, count_star

    from risingwave_tpu.frontend.binder import BindError as JaxBindError
    body = WINDOW_VIEWS["eowc"]
    bad = {
        "lead": body.replace("row_number()", "lead(price)"),
        "desc": body.replace("ORDER BY date_time) AS rn",
                             "ORDER BY date_time DESC) AS rn").replace(
            "ORDER BY date_time) AS sp", "ORDER BY date_time DESC) AS sp"),
        "unwatermarked": body.replace("ORDER BY date_time", "ORDER BY price"),
    }
    for name, sql in bad.items():
        for session, err in ((JaxSession, JaxBindError),
                             (lambda: PortSession(device="cpu"), BindError)):
            async def go():
                s2 = session()
                for stmt in WINDOW_SOURCES:
                    await s2.execute(stmt)
                with pytest.raises(err, match="EMIT ON WINDOW CLOSE"):
                    await s2.execute(sql)
            asyncio.run(go())


def test_q1_statements_run_through_the_session():
    """bench_q1's statements, with a smaller chunk, plan and run end to
    end through the port's session into the device blackhole sink."""
    ddl = [st.replace("chunk_size=131072", "chunk_size=1024")
           for st in BENCH_DDL["q1"]()]

    async def go():
        s = PortSession(device="cpu")
        for stmt in ddl:
            await s.execute(stmt)
        await s.tick(3)
        sink = s.catalog.sinks["q1"]
        chunks = sink.executor.chunks
        await s.shutdown()
        return chunks, [(f.name, f.data_type.value) for f in sink.schema]

    chunks, sch = asyncio.run(go())
    assert chunks >= 3
    assert sch == [("auction", "int64"), ("bidder", "int64"),
                   ("price", "float64"), ("date_time", "timestamp")]


@pytest.mark.parametrize("query", ["q8", "q8_mv", "q17", "q7d",
                                   "q7_kill", "q5_topn_durable_mv",
                                   "where_agg", "where_join",
                                   "window_q6_durable",
                                   "window_eowc_durable",
                                   "window_gagg_durable", "outer_full",
                                   "outer_temporal_left",
                                   "outer_now_keyless"])
def test_plan_ids_and_schemas_match_jax(query):
    """The deterministic actor/table ids and the planner-level fragment
    schemas of a plan agree with the JAX package's."""
    from risingwave_tpu.plan.build import (
        assign_graph_ids as jax_ids, infer_fragment_schemas as jax_schemas)
    from risingwave_tpu_torch.plan.build import (
        assign_graph_ids, infer_fragment_schemas)
    jp, pp = _plans(PLANNED_DDL[query]())
    assert assign_graph_ids(pp.graph, 10, 100) == jax_ids(jp.graph, 10, 100)

    def sig(schemas):
        return {fid: [(f.name, f.data_type.value) for f in sch]
                for fid, sch in schemas.items()}

    try:
        want = sig(jax_schemas(jp.graph))
    except NotImplementedError:
        # JAX's schema rules stop at the over-window kinds: the schemas
        # of the executors JAX's builder makes from the plan instead
        from risingwave_tpu.meta import BarrierCoordinator as JaxCoord
        from risingwave_tpu.plan.build import BuildEnv as JaxEnv
        from risingwave_tpu.plan.build import build_graph as jax_build
        from risingwave_tpu.state import MemoryStateStore as JaxStore
        js = JaxStore()
        dep = jax_build(jp.graph, JaxEnv(js, JaxCoord(js)))
        want = sig({fid: roots[0].schema
                    for fid, roots in dep.roots.items()})
    assert sig(infer_fragment_schemas(pp.graph)) == want


@pytest.mark.parametrize("query", ["q7d", "q7_kill"])
def test_durable_q7_state_tables_match_jax(query):
    """Durable q7's built state tables (ids, schemas, pks), as each
    engine's builder makes them from its own plan, agree."""
    from risingwave_tpu.plan.build import BuildEnv as JaxEnv
    from risingwave_tpu.plan.build import build_graph as jax_build
    from risingwave_tpu.meta import BarrierCoordinator as JaxCoord
    from risingwave_tpu.state import MemoryStateStore as JaxStore
    from risingwave_tpu_torch.meta import BarrierCoordinator
    from risingwave_tpu_torch.plan.build import BuildEnv, build_graph
    from risingwave_tpu_torch.state import MemoryStateStore
    jp, pp = _plans(BENCH_DDL[query]())
    js = JaxStore()
    jdep = jax_build(jp.graph, JaxEnv(js, JaxCoord(js)))
    ps = MemoryStateStore()
    pdep = build_graph(pp.graph, BuildEnv(ps, BarrierCoordinator(ps), "cpu"))

    def tables(dep):
        out = {}

        def walk(ex, seen):
            if ex is None or id(ex) in seen:
                return
            seen.add(id(ex))
            sts = list(getattr(ex, "state_tables", None) or ())
            for attr in ("state_table", "table"):
                if getattr(ex, attr, None) is not None:
                    sts.append(getattr(ex, attr))
            for t in sts:
                if t is not None and hasattr(t, "table_id"):
                    out[t.table_id] = (
                        [(f.name, f.data_type.value) for f in t.schema],
                        tuple(t.pk_indices), tuple(t.dist_key_indices))
            for attr in ("input", "inputs"):
                v = getattr(ex, attr, None)
                for c in (v if isinstance(v, (list, tuple)) else [v]):
                    if hasattr(c, "execute"):
                        walk(c, seen)

        seen = set()
        for roots in dep.roots.values():
            for r in roots:
                walk(r, seen)
        return out

    want = tables(jdep)
    assert tables(pdep) == want and len(want) == (5 if query == "q7_kill"
                                                  else 4)


def _outer_rows(engine: str, view: str, rounds: int = 4) -> Counter:
    """The view's MV rows as committed at the last of `rounds` paced
    barriers (`paced_ticks`), the row id (a column the plan appends,
    derived from the wall clock) dropped, VARCHAR ids decoded (each
    engine's dictionary numbers strings in its own insertion order)."""
    async def go():
        s = (JaxSession() if engine == "jax"
             else PortSession(device="cpu"))
        for stmt in _outer_ddl(view):
            await s.execute(stmt)
        await paced_ticks(s, "m", rounds)
        rows = _decoded_rows(s, engine, "m")
        if engine == "port":
            await s.shutdown()
        return rows
    return asyncio.run(go())


@pytest.mark.parametrize("view", sorted(OUTER_VIEWS))
def test_outer_temporal_and_now_views_match_jax(view):
    """LEFT, FULL and RIGHT joins (tests/test_outer_join_sql.py's goldens
    and a RIGHT join), a LEFT join of a retracting aggregate, temporal
    joins (inner and left) and NOW() dynamic filters run through both
    sessions to the same MV."""
    got, want = _outer_rows("port", view), _outer_rows("jax", view)
    assert got == want
    n = sum(got.values())
    if view == "now_lt":
        assert n == 0
    else:
        assert n >= 10
    if view in ("left", "full", "right", "left_agg", "temporal_left"):
        assert any(None in r for r in got), "no NULL-padded rows"


@pytest.mark.parametrize("case", ["temporal_right", "temporal_retracting",
                                  "outer_float_keys"])
def test_outer_and_temporal_refusals_are_jaxs(case):
    """The binder's own refusals, in JAX's words and in both engines: a
    temporal RIGHT join, a temporal join over a retracting stream side,
    an outer join on FLOAT64 keys."""
    sql = {
        "temporal_right": (
            "CREATE MATERIALIZED VIEW m AS SELECT B.auction FROM bid B "
            "RIGHT JOIN auction A FOR SYSTEM_TIME AS OF PROCTIME() "
            "ON B.auction = A.id"),
        "temporal_retracting": (
            "CREATE MATERIALIZED VIEW m AS SELECT C.auction FROM "
            "(SELECT auction, count(*) AS n FROM bid GROUP BY auction) C "
            "JOIN auction A FOR SYSTEM_TIME AS OF PROCTIME() "
            "ON C.auction = A.id"),
        "outer_float_keys": (
            "CREATE MATERIALIZED VIEW m AS SELECT X.auction FROM "
            "(SELECT auction, avg(price) AS ap FROM bid GROUP BY auction) X"
            " LEFT JOIN (SELECT auction, avg(price) AS ap FROM bid "
            "GROUP BY auction) Y ON X.ap = Y.ap"),
    }[case]
    match = {"temporal_right": "INNER or LEFT",
             "temporal_retracting": "append-only stream side",
             "outer_float_keys": "integer-comparable keys"}[case]

    async def go(session, err):
        s = session()
        for stmt in TEMPORAL_SOURCES:
            await s.execute(stmt)
        with pytest.raises(err, match=match):
            await s.execute(sql)
    from risingwave_tpu.frontend.binder import BindError as JaxBindError
    asyncio.run(go(JaxSession, JaxBindError))
    asyncio.run(go(lambda: PortSession(device="cpu"), BindError))


# The rest of the expression registry, bool_and / bool_or and
# approx_count_distinct (chip_smoke's views, small chunks): Nexmark q3,
# q14 (without the count_char UDF), the q15 shape (22 agg calls) and
# RisingWave's whole q15 (76), the acd views (grouped and global) and
# the string functions
BREADTH_SOURCES = [
    "SET streaming_durability = 0",
    "SET streaming_join_capacity = 4096",
    "SET streaming_agg_capacity = 4096",
    *(f"CREATE SOURCE {t} WITH (connector='nexmark', table='{t}', "
      f"chunk_size=256, rate_limit=512)"
      for t in ("bid", "person", "auction")),
]


def _breadth_views():
    return {"q3": chip_smoke.Q3_SELECT, "q14": chip_smoke.Q14_SELECT,
            "q15": chip_smoke.Q15_SELECT,
            "q15_wide": chip_smoke.Q15_WIDE_SELECT,
            "acd": chip_smoke.ACD_SELECT,
            "acd_global": chip_smoke.ACD_GLOBAL_SELECT,
            "strings": chip_smoke.STRINGS_SELECT}


def _decoded_rows(s, engine: str, name: str) -> Counter:
    """An MV's rows with VARCHAR ids decoded by the engine's dictionary
    and the row id the plan appends dropped."""
    if engine == "jax":
        from risingwave_tpu.common.types import GLOBAL_DICT as d
    else:
        from risingwave_tpu_torch.common.types import GLOBAL_DICT as d
    mv = s.catalog.mvs[name]
    keep = [j for j, f in enumerate(mv.schema)
            if not f.name.startswith("_")]
    text = {j for j, f in enumerate(mv.schema)
            if f.data_type.value == "varchar"}
    return Counter(tuple(d.decode(r[j]) if j in text and r[j] is not None
                         else r[j] for j in keep) for r in _committed_rows(mv))


def _committed_rows(mv) -> list:
    """An MV's rows as committed at the last barrier, in either engine
    (a source runs on past the barrier, into the MV's mem-table)."""
    t = mv.table
    return [t._serde.decode(v) for vn in np.flatnonzero(t.vnode_bitmap)
            for _, v in t.store.iter_range(*t.vnode_key_range(int(vn)))]


def _breadth_rows(engine: str, view: str, rounds: int = 4) -> Counter:
    async def go():
        s = (JaxSession() if engine == "jax"
             else PortSession(device="cpu"))
        for stmt in BREADTH_SOURCES:
            await s.execute(stmt)
        await s.execute("CREATE MATERIALIZED VIEW m AS "
                        + _breadth_views()[view])
        await paced_ticks(s, "m", rounds)
        rows = _decoded_rows(s, engine, "m")
        if engine == "port":
            await s.shutdown()
        return rows
    return asyncio.run(go())


@pytest.mark.parametrize("view", ["q3", "q14", "q15", "q15_wide", "acd",
                                  "acd_global", "strings"])
def test_breadth_views_match_jax(view):
    """Each view through both sessions to the same MV (strings decoded);
    the counts exact, the HLL estimates bit for bit. q15_wide is
    RisingWave's q15 with its eight distinct counts: 76 agg calls, past
    one launch of K4, K27 and K18 on the card."""
    got, want = _breadth_rows("port", view), _breadth_rows("jax", view)
    assert got == want
    assert sum(got.values()) >= (1 if view.startswith("q15")
                                 or view == "acd_global" else 5)
    if view == "q14":
        kinds = {r[3] for r in got}
        assert kinds <= {"dayTime", "nightTime", "otherTime"} and kinds
    if view == "acd":
        assert any(r[3] is True for r in got) and any(r[4] is False
                                                       for r in got)


@pytest.mark.parametrize("agg", ["approx_count_distinct", "bool_or"])
def test_breadth_aggregates_plan_as_jax(agg):
    """The lowering: bool_or as two COUNTs and a CASE, approx_count_
    distinct as a COUNT, 8 HLL register words and `case(count > 0,
    hll_estimate(...))`; fragments and arguments equal JAX's."""
    ddl = BREADTH_SOURCES[:1] + [BREADTH_SOURCES[3]] + [
        f"CREATE MATERIALIZED VIEW m AS SELECT auction, {agg}("
        + ("bidder" if agg != "bool_or" else "price > 10")
        + ") AS x FROM bid GROUP BY auction"]
    jp, pp = _plans(ddl)
    assert _graph_sig(pp.graph, PExchange) == _graph_sig(
        jp.graph, JExchange, strip=JAX_ONLY_ARGS)
    calls = [n.args["agg_calls"] for f in pp.graph.fragments.values()
             for n in _nodes(f.root, PExchange) if n.kind == "hash_agg"][0]
    want = 9 if agg == "approx_count_distinct" else 2
    assert len(calls) == want


def test_acd_over_a_retracting_input_is_refused_like_jax():
    """approx_count_distinct over an aggregate's changelog: JAX's binder
    refuses it in its own words, and so does the port's."""
    sql = ("CREATE MATERIALIZED VIEW m AS SELECT approx_count_distinct(n) "
           "AS d FROM (SELECT auction, count(*) AS n FROM bid "
           "GROUP BY auction) C")
    from risingwave_tpu.frontend.binder import BindError as JaxBindError

    async def go(session, err):
        s = session()
        for stmt in BREADTH_SOURCES[:1] + [BREADTH_SOURCES[3]]:
            await s.execute(stmt)
        with pytest.raises(err, match="needs an append-only input"):
            await s.execute(sql)
    asyncio.run(go(JaxSession, JaxBindError))
    asyncio.run(go(lambda: PortSession(device="cpu"), BindError))


# ---- Queue C: integer conditions, boolean arithmetic, the q17 fusion

def _queue_c_rows(engine: str, view: str) -> Counter:
    """A Queue C view over 4 paced barriers of 512 bids (256-bid
    chunks), its row id dropped."""
    async def go():
        s = (JaxSession() if engine == "jax"
             else PortSession(device="cpu"))
        for stmt in BREADTH_SOURCES[:1] + [BREADTH_SOURCES[3]]:
            await s.execute(stmt)
        await s.execute("CREATE MATERIALIZED VIEW m AS "
                        + chip_smoke.QUEUE_C_SELECTS[view])
        await paced_ticks(s, "m", 4)
        rows = _decoded_rows(s, engine, "m")
        if engine == "port":
            await s.shutdown()
        return rows
    return asyncio.run(go())


@pytest.mark.parametrize("view", ["case_int", "case_int_no_else",
                                  "bool_arith"])
def test_queue_c_views_match_jax(view):
    """An integer CASE condition (with and without ELSE) holds where the
    low bit of its value is set, as JAX ANDs it bitwise with its
    validity; boolean arithmetic promotes as jnp does. Each view through
    both sessions to the same MV."""
    got, want = _queue_c_rows("port", view), _queue_c_rows("jax", view)
    assert got == want and sum(got.values()) == 2048
    if view == "case_int":
        assert {r[1] for r in got} == {0, 1}
    if view == "bool_arith":
        assert 2 in {r[1] for r in got} <= {1, 2}


def test_integer_where_keeps_the_low_bit_rows():
    """`WHERE auction`: JAX's filter keeps, on the device, the rows whose
    auction has its low bit set (int64 `vis & (data & valid)`; the
    executor's lockstep case is tests/test_torch_filter.py's `int_x`),
    and so does the port: its MV holds exactly the odd auctions' bids.
    JAX's MV does not: its host path reads the int64 visibility as row
    indices (`np.asarray(vis)` as an index in StreamChunk.to_rows), so
    each 256-bid chunk lands as its rows 0 and 1 (ROADMAP accepted
    difference 9). The port does not copy that."""
    got, want = (_queue_c_rows("port", "where_int"),
                 _queue_c_rows("jax", "where_int"))
    auction, price = chip_smoke._bid_prefix(2048, chip_smoke.NexmarkConfig(),
                                            "cpu", [0, 2])
    odd = auction % 2 == 1
    assert got == Counter(zip(auction[odd].tolist(), price[odd].tolist()))
    assert 0 < sum(got.values()) < 2048
    at01 = {(int(auction[i]), int(price[i])) for j in range(0, 2048, 256)
            for i in (j, j + 1)}
    assert set(want) <= at01 and want != got


@pytest.mark.parametrize("where", ["outer", "sub"])
def test_q17_fusion_of_a_distinct_count_is_accepted_difference_8(where):
    """JAX's q17 fusion maps every aggregate other than count, avg and
    sum to MAX (ROADMAP accepted difference 8): approx_count_distinct
    added to q17's outer SELECT fuses there as MAX of its argument, and
    in the subquery as a third sub call. The port declines the fusion
    for it, so it never computes a MAX where the SQL asks for a
    distinct count: the outer form raises JAX's own cascade refusal,
    the subquery form plans the cascade (hash_agg, sorted_join,
    simple_agg)."""
    from risingwave_tpu.expr.agg import AggKind as JAggKind
    ddl = BENCH_DDL["q17"]()
    if where == "outer":
        ddl[-1] = ddl[-1].replace(
            "AS avg_yearly ",
            "AS avg_yearly, approx_count_distinct(L.l_orderkey) AS d ")
    else:
        ddl[-1] = ddl[-1].replace(
            "AS avg_quantity ",
            "AS avg_quantity, approx_count_distinct(l_orderkey) AS dq ")
    assert "approx_count_distinct" in ddl[-1]

    async def jax_plan():
        s = JaxSession()
        for stmt in ddl[:-1]:
            await s.execute(stmt)
        st = jsql.parse(ddl[-1])
        return JaxPlanner(s.catalog, config=s.config).plan_sink(
            st.select, st.options)
    jp = asyncio.run(jax_plan())
    (fused,) = [n for f in jp.graph.fragments.values()
                for n in _nodes(f.root, JExchange)
                if n.kind == "snapshot_join_agg"]
    if where == "outer":
        kinds = [c.kind for c in fused.args["final_agg_calls"]]
        assert kinds == [JAggKind.SUM, JAggKind.MAX], kinds
    else:
        kinds = [c.kind for c in fused.args["sub_agg_calls"]]
        assert kinds == [JAggKind.SUM, JAggKind.COUNT, JAggKind.MAX], kinds

    async def port():
        s = PortSession(device="cpu")
        for stmt in ddl[:-1]:
            await s.execute(stmt)
        st = psql.parse(ddl[-1])
        return PortPlanner(s.catalog, config=s.config).plan_sink(
            st.select, st.options)
    if where == "outer":
        with pytest.raises(BindError, match="needs an append-only input"):
            asyncio.run(port())
        return
    pp = asyncio.run(port())
    kinds = {n.kind for f in pp.graph.fragments.values()
             for n in _nodes(f.root, PExchange)}
    assert {"hash_agg", "sorted_join", "simple_agg"} <= kinds
    assert "snapshot_join_agg" not in kinds


# ---- MV-on-MV and sink-from-MV

MVMV_SOURCES = [
    "SET streaming_durability = 0",
    "SET streaming_agg_capacity = 4096",
    ("CREATE SOURCE bid WITH (connector='nexmark', table='bid', "
     "chunk_size=256, rate_limit=512)"),
]
MVMV_RATE = 512


def _mvmv_consumers():
    return [f"CREATE MATERIALIZED VIEW mv_hot AS {chip_smoke.MVMV_HOT_SELECT}",
            f"CREATE MATERIALIZED VIEW mv_hist AS "
            f"{chip_smoke.MVMV_HIST_SELECT}",
            chip_smoke.MVMV_SINK]


@pytest.mark.parametrize("which", [0, 1, 2])
def test_mv_on_mv_plans_as_jax(which):
    """A filter and an aggregate over an MV and a sink from it: a
    stream_scan fragment (broadcast) under the same nodes and
    arguments as JAX's, with JAX's state-table ids (the backfill's
    progress table included: durable in a volatile session)."""
    from risingwave_tpu.plan.build import assign_graph_ids as jax_ids
    from risingwave_tpu_torch.plan.build import assign_graph_ids
    ddl = MVMV_SOURCES + [
        f"CREATE MATERIALIZED VIEW mv_agg AS {chip_smoke.MVMV_AGG_SELECT}",
        _mvmv_consumers()[which]]
    jp, pp = _plans(ddl)
    assert _graph_sig(pp.graph, PExchange) == _graph_sig(
        jp.graph, JExchange, strip=JAX_ONLY_ARGS)
    kinds = [n.kind for f in pp.graph.fragments.values()
             for n in _nodes(f.root, PExchange)]
    assert "stream_scan" in kinds and "nexmark_source" not in kinds
    assert assign_graph_ids(pp.graph, 10, 20) == jax_ids(jp.graph, 10, 20)
    assert pp.pk_indices == tuple(jp.pk_indices)


class _Recorder:
    """Every message a blackhole sink consumes, per engine: its chunks'
    visible (op, row) pairs and a marker at each barrier."""

    def __init__(self, mp, cls, chunk_cls, barrier_cls):
        self.log = []
        orig = cls.execute
        log = self.log

        async def execute(ex):
            async for msg in orig(ex):
                if isinstance(msg, chunk_cls):
                    log.extend(msg.to_rows())
                elif isinstance(msg, barrier_cls):
                    log.append(None)
                yield msg
        mp.setattr(cls, "execute", execute)

    def net(self, barriers: int) -> Counter:
        """The net rows (inserts minus deletes) before barrier
        `barriers`."""
        out, seen = Counter(), 0
        for m in self.log:
            if m is None:
                seen += 1
                if seen == barriers:
                    break
                continue
            op, row = m
            out[row] += 1 if op in (0, 3) else -1
        return +out


async def _wait_offset(s, name, rows):
    """Until every source of flow `name` emitted `rows` rows (each
    stops at its rate limit until the next barrier)."""
    flows = {**s.catalog.mvs, **s.catalog.sinks}
    dep = flows[name].deployment
    srcs = _flow_sources(dep)
    while any(x.connector.offset < rows for x in srcs):
        for t in dep.tasks:
            if t.done():
                t.result()
        await asyncio.sleep(0.001)


def _mvmv_run(engine, mp, batch_rows=16, before=3, after=9):
    """mv_agg over paced bids; after `before` barriers, mv_hot, mv_hist
    and the sink from mv_agg, each brought up by a barrier of its own
    at a known offset, with backfills of `batch_rows` rows a barrier;
    then `after` paced barriers. Returns, after each barrier from the
    consumers' first, the committed rows of the three MVs, the sink's
    net rows and whether the backfills had finished."""
    if engine == "jax":
        from risingwave_tpu.common.chunk import StreamChunk as C
        from risingwave_tpu.stream import Barrier as B
        from risingwave_tpu.stream.backfill import BackfillExecutor as BF
        from risingwave_tpu.stream.sink import (
            DeviceBlackholeSinkExecutor as Sink)
    else:
        from risingwave_tpu_torch.common.chunk import StreamChunk as C
        from risingwave_tpu_torch.stream import Barrier as B
        from risingwave_tpu_torch.stream.backfill import (
            BackfillExecutor as BF)
        from risingwave_tpu_torch.stream.sink import (
            DeviceBlackholeSinkExecutor as Sink)
    init = BF.__init__

    def small(self, *a, **kw):
        kw["batch_rows"] = batch_rows
        init(self, *a, **kw)
    mp.setattr(BF, "__init__", small)
    rec = _Recorder(mp, Sink, C, B)

    async def go():
        s = JaxSession() if engine == "jax" else PortSession(device="cpu")
        for stmt in MVMV_SOURCES:
            await s.execute(stmt)
        await s.execute("CREATE MATERIALIZED VIEW mv_agg AS "
                        + chip_smoke.MVMV_AGG_SELECT)
        k = 0
        for k in range(1, before + 1):
            await _wait_offset(s, "mv_agg", k * MVMV_RATE)
            await s.tick(1)
        snaps = []

        def snap():
            snaps.append(dict(
                {n: Counter(tuple(r) for r in
                            _committed_rows(s.catalog.mvs[n]))
                 for n in s.catalog.mvs},
                finished=[bf.finished for d in s.catalog.mvs.values()
                          for bf in _backfills(d.deployment, BF)]))
        for stmt in _mvmv_consumers():
            k += 1
            await _wait_offset(s, "mv_agg", k * MVMV_RATE)
            await s.execute(stmt)
            snap()
        sink_at = k
        for k in range(k + 1, k + after + 1):
            await _wait_offset(s, "mv_agg", k * MVMV_RATE)
            await s.tick(1)
            snap()
        with pytest.raises(Exception, match="cannot drop"):
            await s.drop_mv("mv_agg")
        await s.drop_all()
        return snaps, rec.net(k - sink_at + 1)
    return asyncio.run(go())


def _backfills(dep, cls) -> list:
    out = []
    for a in dep.actors:
        ex = a.consumer
        while ex is not None:
            if isinstance(ex, cls):
                out.append(ex)
            ex = getattr(ex, "input", None)
    return out


def test_mv_on_mv_and_sink_match_jax_at_every_barrier(monkeypatch):
    """mv_hot (a filter), mv_hist (an aggregate over mv_agg's retracting
    changelog, which a row applied twice would break) and a sink from
    mv_agg, created while bids flow and backfilled 16 rows a barrier:
    after every barrier, during the backfill and after it, the
    committed rows of every MV equal JAX's; once the backfills end the
    consumers equal a recount over mv_agg; the sink's net rows equal
    JAX's; DROP of mv_agg is refused while it has dependents, and
    drop_all drops in reverse order."""
    with monkeypatch.context() as mp:
        got, gsink = _mvmv_run("port", mp)
    with monkeypatch.context() as mp:
        want, wsink = _mvmv_run("jax", mp)
    assert len(got) == len(want) == 12
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, f"MVs differ after consumer barrier {i}"
    during = [sn for sn in got if not all(sn["finished"])]
    assert len(during) >= 3, "the backfill ended too soon to test it"
    last = got[-1]
    assert all(last["finished"])
    hot, hist = chip_smoke.mvmv_recount(list(last["mv_agg"]))
    assert last["mv_hot"] == hot and sum(hot.values()) >= 5
    assert last["mv_hist"] == hist
    assert gsink == wsink and len(gsink) >= 10
