"""Nexmark q8 end to end through each engine's own SQL session: the
port's (plain PyTorch versions of the kernels on the CPU) against the
JAX package's and a numpy recount.

1. tests/test_wm_derivation.py's q8 view at its geometry (256/768-row
   chunks, inter_event_us=2000, join capacity 8192, match factor 16, 8
   ticks): the port's view, read from its state table, must equal the
   JAX session's query result and the recount of the committed prefixes
   exactly.
2. bench_q8's statements (chip_smoke.Q8_DDL) at 128/384-row chunks and
   match factor 2, through chip_smoke.q8_run as the card runs them: a
   person chunk that reaches the join after the auctions of its event
   time overflows the person side's match buffer (2 x chunk rows), which
   the join counts in errs[0]. Both engines must satisfy the identity the
   card's q8_check gates: every output key at most its recount, the
   total shortfall equal to errs[0], errs[1] == errs[2] == 0. Once at
   bench's equal event-time spans (whether the buffer overflows depends
   on how the actors interleave) and once with the auction source twice
   as far ahead in event time, where it must overflow.
"""

import asyncio
from collections import Counter

import numpy as np
import pytest

from risingwave_tpu.frontend import Session as JaxSession
from risingwave_tpu.state.storage_table import StorageTable
from risingwave_tpu.stream.source import SourceExecutor as JSource
from risingwave_tpu.stream.sorted_join import SortedJoinExecutor as JJoin

W = 10_000_000
# tests/test_wm_derivation.py's q8 view (as tests/test_torch_frontend.py
# plans it), volatile state
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


@pytest.fixture(autouse=True, scope="module")
def _port():
    """Import torch and the port when these tests run, not at collection:
    an xdist worker then runs the JAX tests before them without torch
    (the sharded-join recovery tests abort more often with it loaded)."""
    global chip_smoke, NexmarkConfig, PortSession, PSource
    import chip_smoke
    from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig
    from risingwave_tpu_torch.frontend import Session as PortSession
    from risingwave_tpu_torch.stream import SourceExecutor as PSource


def _jax_sources(dep):
    found = {}
    for roots in dep.roots.values():
        for r in roots:
            if isinstance(r, JSource):
                found[r.connector.table] = r
    return found


def _jax_join(dep):
    for roots in dep.roots.values():
        for r in roots:
            node = r
            while node is not None:
                if isinstance(node, JJoin):
                    return node
                node = getattr(node, "input", None)
    raise AssertionError("no sorted join")


def _recount_pairs(n_person, n_auction, ie):
    """(pid, aid) rows of q8 over the prefixes, from the plain
    generators."""
    import torch
    from risingwave_tpu_torch.connectors.nexmark import (
        gen_auction_columns_plain, gen_person_columns_plain, vocab_ids)
    cfg = NexmarkConfig(inter_event_us=ie)
    v = {k: torch.tensor(x, dtype=torch.int32) for k, x in vocab_ids().items()}
    p = gen_person_columns_plain(0, n_person, cfg, v, "cpu")
    a = gen_auction_columns_plain(0, n_auction, cfg, v, "cpu")
    persons = {(int(i), int(t) // W) for i, t in zip(p[0], p[6])}
    out = Counter()
    for aid, seller, t in zip(a[0].tolist(), a[7].tolist(), a[5].tolist()):
        if (seller, t // W) in persons:
            out[(seller, aid)] += 1
    return out


def test_q8_view_matches_jax_and_recount():
    async def jax_run():
        s = JaxSession()
        for stmt in WM_Q8_DDL:
            await s.execute(stmt)
        await s.tick(8)
        dep = s.catalog.mvs["q8"].deployment
        offs = {t: int(list(StorageTable.for_state_table(
            src.state_table).batch_iter())[0][1])
            for t, src in _jax_sources(dep).items()}
        rows = Counter(s.query("SELECT pid, aid FROM q8"))
        errs = [int(x) for x in np.asarray(_jax_join(dep)._errs_dev)]
        await s.drop_all()
        return rows, offs, errs

    async def port_run():
        s = PortSession(device="cpu")
        for stmt in WM_Q8_DDL:
            await s.execute(stmt)
        await s.tick(8)
        dep = s.catalog.mvs["q8"].deployment
        offs = {src.connector.table: src.state_table.get_row((0,))[1]
                for src in dep.executors(PSource)}
        rows = Counter((r[0], r[1]) for r in s.mv_rows("q8"))
        from risingwave_tpu_torch.stream import SortedJoinExecutor
        join = dep.executors(SortedJoinExecutor)[0]
        errs, live = join.errs(), int(join.sides[0].n + join.sides[1].n)
        await s.drop_all()
        return rows, offs, errs, live

    jax_rows, jax_offs, jax_errs = asyncio.run(jax_run())
    rows, offs, errs, live = asyncio.run(port_run())
    assert offs == jax_offs == {"person": 8 * 256, "auction": 8 * 768}
    want = _recount_pairs(offs["person"], offs["auction"], 2000)
    assert rows == jax_rows == want
    assert sum(want.values()) > 1000
    assert errs == jax_errs == [0, 0, 0]
    # the pair cleaning evicted: far fewer live rows than ingested
    assert live < (offs["person"] + offs["auction"]) // 2


def _jax_identity(person_chunk, auction_chunk, rounds):
    """bench_q8's statements (chunk sizes swapped, the sink a view so
    the rows can be read, rate limits for one chunk a barrier) through
    the JAX session; stopped, then held to the recount. Returns errs."""
    ddl = chip_smoke.q8_ddl(person_chunk, auction_chunk)
    ddl = [st.replace("emit_watermarks=1)", f"emit_watermarks=1, "
                      f"rate_limit={cs})")
           for st, cs in zip(ddl, [0] * 4 + [person_chunk, auction_chunk,
                                             0])]
    ddl[-1] = ddl[-1].replace("CREATE SINK", "CREATE MATERIALIZED VIEW") \
        .replace(" WITH (connector='blackhole_device')", "")
    ddl.insert(2, "SET streaming_join_capacity = 16384")

    async def go():
        s = JaxSession()
        for stmt in ddl:
            await s.execute(stmt)
        await s.tick(rounds - 1)
        mv = s.catalog.mvs["q8"]
        srcs = _jax_sources(mv.deployment)
        join = _jax_join(mv.deployment)
        await s.drop_all()
        rows = list(StorageTable.for_state_table(mv.table).batch_iter())
        offs = {t: x.connector.offset for t, x in srcs.items()}
        return rows, offs, [int(x) for x in np.asarray(join._errs_dev)]

    rows, offs, errs = asyncio.run(go())
    cfg = NexmarkConfig(inter_event_us=chip_smoke.Q8_INTER_US)
    pid = np.array([r[0] for r in rows], np.int64)
    ws = np.array([r[1] for r in rows], np.int64)
    got = np.unique(chip_smoke.q8_keys(pid, ws, cfg), return_counts=True)
    want = chip_smoke.q8_recount(offs["person"], offs["auction"], cfg,
                                 "cpu")
    short, over = chip_smoke.q8_shortfall(got, want)
    assert over == 0 and errs[1] == errs[2] == 0
    assert short == errs[0]
    assert int(want[1].sum()) > 0
    return errs


def _port_identity(person_chunk, auction_chunk, rounds):
    r = chip_smoke.q8_run("cpu", rounds, person_chunk, auction_chunk,
                          sets=("SET streaming_join_capacity = 16384",),
                          collect=rounds * auction_chunk)
    cfg = NexmarkConfig(inter_event_us=chip_smoke.Q8_INTER_US)
    want = chip_smoke.q8_recount(r["persons"], r["auctions"], cfg, "cpu")
    got = chip_smoke.q8_sink_counts(r["sink"], cfg)
    assert r["persons"] == rounds * person_chunk
    assert r["auctions"] == rounds * auction_chunk
    gate = chip_smoke.q8_check_gates(r, want, got, exact=False)
    assert gate["rows"] > 0
    return gate["join_errs"]


@pytest.mark.parametrize("auction_chunk", [384, 768])
def test_q8_bench_geometry_shortfall_identity(auction_chunk):
    rounds = 6
    errs = _port_identity(128, auction_chunk, rounds)
    jax_errs = _jax_identity(128, auction_chunk, rounds)
    if auction_chunk == 768:
        # auctions run ahead: every person chunk after the first finds
        # ~3 stored auctions a person, past its 256-slot buffer
        assert errs[0] > 0 and jax_errs[0] > 0
