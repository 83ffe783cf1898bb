"""The port's FilterExecutor (kernel K5's and kernel K22's plain versions
on the CPU) against the JAX package's.

Chunks from a numpy seed hold Inserts, Deletes and U-/U+ pairs whose
old and new rows fall on either side of the predicate (both pass, both
fail, only the old, only the new), NULL predicate inputs, invisible
rows, and an UpdateInsert at row 0 and an UpdateDelete at row N-1, whose
partners are read with jnp.roll's wrap-around. The output ops and
visibility must equal JAX's on every row, and the columns pass through
unchanged."""

import numpy as np
import pytest

from risingwave_tpu.common import DataType as JDT
from risingwave_tpu.common import StreamChunk as JChunk
from risingwave_tpu.common.types import schema as jschema
from risingwave_tpu.expr import call as jcall, col as jcol, lit as jlit
from risingwave_tpu.stream.project import FilterExecutor as JaxFilter

N = 128
INS, DEL, UD, UI = 0, 1, 2, 3


@pytest.fixture(autouse=True, scope="module")
def _port():
    """Import torch and the port when these tests run, not at
    collection."""
    global torch, DataType, schema, call, col, lit, chunk_from_numpy
    global PortFilter, project
    import torch
    from risingwave_tpu_torch.common import DataType, schema
    from risingwave_tpu_torch.expr import call, col, lit
    from risingwave_tpu_torch.interop import chunk_from_numpy
    from risingwave_tpu_torch.stream import project
    from risingwave_tpu_torch.stream.project import (
        FilterExecutor as PortFilter)


class _Input:
    def __init__(self, sch):
        self.schema = sch
        self.pk_indices = (0,)


def _chunk_arrays(seed: int):
    """(arrays, ops, vis, valids): pk, x (int64, some NULL), y float64;
    update pairs at (2j, 2j+1) plus the row 0 / row N-1 wrap case."""
    rng = np.random.default_rng(seed)
    pk = np.arange(N, dtype=np.int64)
    x = rng.integers(-300, 300, N)
    y = rng.integers(-40, 40, N) / 4.0
    ops = rng.choice([INS, DEL], N).astype(np.int8)
    for j in range(1, N // 2 - 1):
        if rng.random() < 0.6:
            ops[2 * j], ops[2 * j + 1] = UD, UI
            pk[2 * j + 1] = pk[2 * j]
    # the ends: row 0 an UpdateInsert, row N-1 an UpdateDelete
    ops[0], ops[N - 1] = UI, UD
    vis = rng.random(N) < 0.9
    xv = rng.random(N) < 0.85
    return [pk, x, y], ops, vis, [None, xv, None]


def _exprs(call, col, lit, DT):
    x, y = col(1, DT.INT64), col(2, DT.FLOAT64)
    return {
        # q2's predicate
        "q2_mod": call("equal", call("modulus", x, lit(3)), lit(0)),
        "gt": call("greater_than", x, lit(10)),
        "float_and_null": call("and", call("less_than", y, lit(2.5)),
                               call("is_not_null", x)),
        "or_kleene": call("or", call("greater_than", x, lit(250)),
                          call("less_than", x, lit(-250))),
    }


@pytest.mark.parametrize("pred", ["q2_mod", "gt", "float_and_null",
                                  "or_kleene"])
@pytest.mark.parametrize("seed", [0, 1])
def test_filter_matches_jax(pred, seed):
    arrays, ops, vis, valids = _chunk_arrays(seed)
    jsch = jschema(("pk", JDT.INT64), ("x", JDT.INT64), ("y", JDT.FLOAT64))
    psch = schema(("pk", DataType.INT64), ("x", DataType.INT64),
                  ("y", DataType.FLOAT64))
    jc = JChunk.from_numpy(jsch, arrays, ops=ops, capacity=N,
                           valids=valids).with_vis(np.asarray(vis))
    pc = chunk_from_numpy(psch, arrays, ops, vis, valids, device="cpu")
    jf = JaxFilter(_Input(jsch), _exprs(jcall, jcol, jlit, JDT)[pred])
    pf = PortFilter(_Input(psch), _exprs(call, col, lit, DataType)[pred])
    jo = jf._step_impl(jc)
    po = pf.map_chunk(pc)
    np.testing.assert_array_equal(po.ops.numpy(), np.asarray(jo.ops))
    np.testing.assert_array_equal(po.vis.numpy(), np.asarray(jo.vis))
    for a, b in zip(po.columns, pc.columns):
        assert a.data is b.data
    # the case the fix-up exists for: pairs that cross the predicate
    got = po.ops.numpy()
    changed = (got != ops)
    assert changed.any() and set(got[changed]) <= {INS, DEL}


def test_fixup_plain_wraps_at_both_ends():
    """Row 0 (UpdateInsert) pairs with row N-1 and row N-1 (UpdateDelete)
    with row 0, as jnp.roll reads them."""
    ops = torch.tensor([UI, INS, DEL, UD], dtype=torch.int8)
    vis = torch.ones(4, dtype=torch.bool)
    # row 0 passes, row 3 fails: row 0 becomes an Insert, row 3 hidden
    data = torch.tensor([True, True, False, False])
    o, v = project.filter_fixup_plain(data, None, ops, vis)
    assert o.tolist() == [INS, INS, DEL, UD]
    assert v.tolist() == [True, True, False, False]
    # row 3 passes, row 0 fails (NULL): row 3 becomes a Delete
    data = torch.tensor([True, False, True, True])
    valid = torch.tensor([False, True, True, True])
    o, v = project.filter_fixup_plain(data, valid, ops, vis)
    assert o.tolist() == [UI, INS, DEL, DEL]
    assert v.tolist() == [False, False, True, True]
