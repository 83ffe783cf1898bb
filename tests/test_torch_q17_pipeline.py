"""TPC-H q17 end to end through each engine's own SQL session: the port's
(plain PyTorch versions of the kernels on the CPU) against the JAX
package's and a recount.

bench.py's bench_q17 statements (chip_smoke.Q17_DDL, volatile state,
transfer-free watchdog) at small sizes: 512-row lineitem chunks, 16 a
barrier, one 1024-row part chunk a barrier, a 4096-slot fact store that
grows three times over 3 barriers (to 32768 slots). Both engines are
paced by rows (a barrier once each source has emitted its quota, the
last the Stop), so
every barrier closes the same prefixes in both. The per-barrier
changelog of the fused executor must be equal (float values within a
relative 1e-15: XLA folds `/ 7.0` into a multiplication by 1/7, one ulp
off the IEEE quotient the port computes), and the port's value after
every barrier must equal, exactly, the oracle of tests/test_tpch_q17.py
re-implemented over the port's generator.
"""

import asyncio

import numpy as np
import pytest

from risingwave_tpu.frontend import Session as JaxSession
from risingwave_tpu.stream.snapshot_join_agg import (
    SnapshotJoinAggExecutor as JaxSJA)
from risingwave_tpu.stream.source import SourceExecutor as JSource

LI_CHUNK, PART_CHUNK, CAPACITY, ROUNDS = 512, 1024, 4096, 3


@pytest.fixture(autouse=True, scope="module")
def _port():
    """Import torch and the port when these tests run, not at collection:
    an xdist worker then runs the JAX tests before them without torch
    (the sharded-join recovery tests abort more often with it loaded)."""
    global chip_smoke, PDICT
    import chip_smoke
    from risingwave_tpu_torch.common.types import GLOBAL_DICT as PDICT


def _walk(dep, cls):
    out = []
    for roots in dep.roots.values():
        for r in roots:
            node = r
            while node is not None:
                if isinstance(node, cls):
                    out.append(node)
                for x in getattr(node, "inputs", ()):
                    if isinstance(x, cls):
                        out.append(x)
                node = getattr(node, "input", None)
    return out


def _jax_run(rounds):
    """bench_q17's statements (sizes swapped) through the JAX session,
    paced like chip_smoke.q17_run; returns the fused executor's output
    chunks, one per barrier that saw rows, as visible (op, row) lists."""
    ddl = chip_smoke.q17_ddl(LI_CHUNK, PART_CHUNK, CAPACITY)

    async def go():
        s = JaxSession()
        for stmt in ddl:
            await s.execute(stmt)
        dep = s.catalog.sinks["q17"].deployment
        gens = {x.connector.table: x.connector
                for x in _walk(dep, JSource)}
        ex = _walk(dep, JaxSJA)[0]
        outs = []
        flush = ex._flush

        def recording_flush(*a):
            res = flush(*a)
            outs.append(res[3].to_rows())
            return res
        ex._flush = recording_flush
        for r in range(1, rounds + 1):
            while (gens["lineitem"].offset < r * 16 * LI_CHUNK
                   or gens["part"].offset < r * PART_CHUNK):
                for t in dep.tasks:
                    if t.done():
                        t.result()
                await asyncio.sleep(0)
            if r < rounds:
                b = await s.coord.inject_barrier()
                await s.coord.wait_collected(b)
            else:
                await s.coord.stop_all({a.actor_id for a in dep.actors})
        await asyncio.gather(*dep.tasks)
        return outs, [int(x) for x in np.asarray(ex._errs)], ex.capacity

    return asyncio.run(go())


def _oracle(part_n, li_n):
    """tests/test_tpch_q17.py's _oracle over the port's generator, with
    brand and container compared as strings."""
    p = chip_smoke.tpch_prefix("part", part_n, "cpu")
    li = chip_smoke.tpch_prefix("lineitem", li_n, "cpu")
    parts_ok = {int(k) for k, b, c in zip(p[0], p[1], p[2])
                if PDICT.decode(int(b)) == "Brand#23"
                and PDICT.decode(int(c)) == "MED BOX"}
    by_part: dict[int, list] = {}
    for pk, q, ep in zip(li[1], li[2], li[3]):
        by_part.setdefault(int(pk), []).append((int(q), int(ep)))
    total, n = 0, 0
    for pk, rows in by_part.items():
        if pk not in parts_ok:
            continue
        thr = 0.2 * (sum(q for q, _ in rows) / len(rows))
        sel = [ep for q, ep in rows if q < thr]
        total += sum(sel)
        n += len(sel)
    return total / 7.0 if n else None


def test_q17_changelog_matches_jax_and_oracle():
    r, values = chip_smoke.q17_check_run("cpu", ROUNDS, LI_CHUNK,
                                         PART_CHUNK, CAPACITY)
    assert r["ex"].errs() == [0, 0, 0] and r["ex"].capacity == 32768
    port = [o.to_rows() for o in r["outs"]]
    jax_outs, jax_errs, jax_cap = _jax_run(ROUNDS)
    assert jax_errs == [0, 0, 0] and jax_cap == r["ex"].capacity
    assert len(port) == len(jax_outs) == ROUNDS
    for p, j in zip(port, jax_outs):
        assert [op for op, _ in p] == [op for op, _ in j]
        for (_, pv), (_, jv) in zip(p, j):
            assert (pv[0] is None) == (jv[0] is None)
            if pv[0] is not None:
                assert pv[0] == pytest.approx(jv[0], rel=1e-15, abs=0)
    # the oracle, exactly, at the last barrier (chip_smoke's numpy
    # recount held every barrier inside q17_check_run)
    want = _oracle(ROUNDS * PART_CHUNK, ROUNDS * 16 * LI_CHUNK)
    assert want is not None and values[-1] == want
    assert values[0] is None or values[0] != values[-1]


def test_q17_plan_runs_through_session_with_bench_statements():
    """chip_smoke's statements are bench_q17's (held against bench.py in
    tests/test_torch_frontend.py); at a small size they run through the
    session into the device blackhole sink, every flush counted."""
    r = chip_smoke.q17_run("cpu", 2, li_chunk=256, part_chunk=256,
                           capacity=1 << 13)
    ex = r["ex"]
    assert ex.errs() == [0, 0, 0]
    assert int(ex._fn) == 2 * 16 * 256 and r["parts"] == 2 * 256
    assert r["measured_rows"] == 16 * 256 and len(r["barrier_lat_s"]) == 1
    want = chip_smoke.q17_recount(int(ex._fn), r["parts"], "cpu")
    got = float(ex._prev[0]) if bool(ex._prev_valid[0]) else None
    assert got == want
