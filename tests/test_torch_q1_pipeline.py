"""Nexmark q1 (a stateless Project) end to end on the port, against the
JAX package: tests/test_q1_pipeline.py::test_q1_end_to_end's pipeline
(source -> Project -> RowIdGen -> MV under the barrier coordinator) with
the price converted by `multiply` of a cast and a float literal, kernel
K5's plain version on the CPU.

q1: SELECT auction, bidder, 0.908 * price, date_time FROM bid.
Both MVs hold the same rows (row ids aside: they carry each run's
barrier epochs); integers compare exactly and the float64 price within a
relative 1e-12, the tolerance of the JAX test (its XLA multiply may
differ from numpy's in the last ulp)."""

import asyncio

import numpy as np
import pytest

from risingwave_tpu.common import DataType as JDT
from risingwave_tpu.common import schema as jschema
from risingwave_tpu.connectors import NexmarkGenerator as JaxGenerator
from risingwave_tpu.expr import call as jcall, col as jcol, lit as jlit
from risingwave_tpu.expr.ir import FuncCall as JFuncCall
from risingwave_tpu.meta import BarrierCoordinator as JaxCoordinator
from risingwave_tpu.state import (
    MemoryStateStore as JaxStore, StateTable as JaxTable,
)
from risingwave_tpu.stream import (
    Actor as JActor, MaterializeExecutor as JMat, ProjectExecutor as JProject,
    RowIdGenExecutor as JRowId, SourceExecutor as JSource,
)


@pytest.fixture(autouse=True, scope="module")
def _port():
    """Import torch and the port when these tests run, not at collection:
    an xdist worker then runs the JAX tests before them without torch
    (the sharded-join recovery tests abort more often with it loaded)."""
    global port
    import risingwave_tpu_torch.common as common
    import risingwave_tpu_torch.connectors.nexmark as nexmark
    import risingwave_tpu_torch.expr as expr
    import risingwave_tpu_torch.expr.ir as ir
    import risingwave_tpu_torch.meta as meta
    import risingwave_tpu_torch.state as state
    import risingwave_tpu_torch.stream as stream
    port = dict(DataType=common.DataType, schema=common.schema,
                Generator=nexmark.NexmarkGenerator, call=expr.call,
                col=expr.col, lit=expr.lit, FuncCall=ir.FuncCall,
                Coordinator=meta.BarrierCoordinator,
                Store=state.MemoryStateStore, Table=state.StateTable,
                Actor=stream.Actor, Mat=stream.MaterializeExecutor,
                Project=stream.ProjectExecutor, RowId=stream.RowIdGenExecutor,
                Source=stream.SourceExecutor)


def _q1(m, **gen_kw):
    """test_q1_pipeline.build_q1 over either package's classes `m`."""
    DT, col = m["DataType"], m["col"]
    store = m["Store"]()
    barrier_q = asyncio.Queue()
    gen = m["Generator"]("bid", chunk_size=64, **gen_kw)
    offsets = m["Table"](store, table_id=1, schema=m["schema"](
        ("source_id", DT.INT64), ("offset", DT.INT64)), pk_indices=[0])
    src = m["Source"](1, gen, barrier_q, state_table=offsets)
    price = m["call"]("multiply", m["FuncCall"]("cast", (col(2, DT.INT64),),
                                                DT.FLOAT64), m["lit"](0.908))
    proj = m["Project"](src, [col(0), col(1, DT.INT64), price,
                              col(5, DT.TIMESTAMP)],
                        names=["auction", "bidder", "price", "date_time"])
    rid = m["RowId"](proj)
    mv = m["Table"](store, table_id=2, schema=rid.schema,
                    pk_indices=rid.pk_indices)
    mat = m["Mat"](rid, mv)
    coord = m["Coordinator"](store, checkpoint_frequency=1)
    coord.register_source(barrier_q)
    coord.register_actor(1)

    async def go():
        task = m["Actor"](1, mat, None, coord).spawn()
        await coord.run_rounds(3)
        await coord.stop_all({1})
        await task
    asyncio.run(go())
    return gen, mv, offsets, coord


def _rows(mv):
    """MV rows without the row id, in a fixed order."""
    return sorted(tuple(r[:4]) for _, r in mv.iter_all())


def test_q1_end_to_end_matches_jax():
    gen, mv, offsets, coord = _q1(port, device="cpu")
    jax_m = dict(DataType=JDT, schema=jschema, Generator=JaxGenerator,
                 call=jcall, col=jcol, lit=jlit, FuncCall=JFuncCall,
                 Coordinator=JaxCoordinator, Store=JaxStore, Table=JaxTable,
                 Actor=JActor, Mat=JMat, Project=JProject, RowId=JRowId,
                 Source=JSource)
    jgen, jmv, _, _ = _q1(jax_m)
    rows = list(mv.iter_all())
    # every generated chunk was materialized and committed, once
    assert len(rows) == gen.offset > 0
    assert len({r[4] for _, r in rows}) == len(rows)      # unique row ids
    got, want = _rows(mv), _rows(jmv)
    n = min(gen.offset, jgen.offset)
    assert n > 0
    # the runs may stop at different offsets: compare the common prefix,
    # keyed by (auction, bidder, date_time), exact but for the price
    common = set((a, b, t) for a, b, _, t in got) & \
        set((a, b, t) for a, b, _, t in want)
    g = sorted(r for r in got if (r[0], r[1], r[3]) in common)
    w = sorted(r for r in want if (r[0], r[1], r[3]) in common)
    assert len(g) == len(w) >= n // 2
    assert [(r[0], r[1], r[3]) for r in g] == [(r[0], r[1], r[3]) for r in w]
    np.testing.assert_allclose([r[2] for r in g], [r[2] for r in w],
                               rtol=1e-12)
    # against numpy: 0.908 * the generated price
    regen = port["Generator"]("bid", chunk_size=64, device="cpu")
    expected = []
    while regen.offset < gen.offset:
        cols, _ = regen.next_chunk().to_numpy()
        expected.extend((cols[2] * 0.908).tolist())
    np.testing.assert_allclose(sorted(r[2] for r in got), sorted(expected),
                               rtol=1e-12)
    # offsets committed for recovery; barrier latency recorded
    off = offsets.get_row((0,))
    assert off is not None and off[1] == gen.offset
    assert len(coord.latencies_ns) >= 4
