"""Differential tests of the port's small copies against the JAX package:
op signs and chunk compaction, host vnodes and crc32, memcomparable and
value encoding, and the state table's keys and reads over the in-memory
store."""

import jax.numpy as jnp
import numpy as np
import pytest

from risingwave_tpu.common import DataType as JDT, StreamChunk as JChunk
from risingwave_tpu.common import chunk as jchunk
from risingwave_tpu.common import vnode as jvnode
from risingwave_tpu.common.types import schema as jschema
from risingwave_tpu.state import serde as jserde
from risingwave_tpu.state.state_table import StateTable as JTable
from risingwave_tpu.state.store import MemoryStateStore as JStore


@pytest.fixture(autouse=True, scope="module")
def _port():
    """Import torch and the port when these tests run, not at collection:
    an xdist worker then runs the JAX tests before them without torch
    (the sharded-join recovery tests abort more often with it loaded)."""
    global torch, DataType, schema, pchunk, pvnode, chunk_from_numpy
    global chunk_to_numpy, pserde, PTable, PStore
    import torch
    from risingwave_tpu_torch.common import DataType, schema
    from risingwave_tpu_torch.common import chunk as pchunk
    from risingwave_tpu_torch.common import vnode as pvnode
    from risingwave_tpu_torch.interop import chunk_from_numpy, chunk_to_numpy
    from risingwave_tpu_torch.state import serde as pserde
    from risingwave_tpu_torch.state.state_table import StateTable as PTable
    from risingwave_tpu_torch.state.store import MemoryStateStore as PStore


COLS = [("a", "INT64"), ("b", "INT32"), ("c", "FLOAT64"), ("d", "BOOLEAN"),
        ("e", "TIMESTAMP")]


def _schemas():
    return (jschema(*[(n, getattr(JDT, t)) for n, t in COLS]),
            schema(*[(n, getattr(DataType, t)) for n, t in COLS]))


def _rows(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(-10**12, 10**12, n), rng.integers(-99, 99, n),
            rng.normal(size=n), rng.random(n) < 0.5,
            rng.integers(0, 10**15, n)]


def test_op_sign_and_compact_match_jax():
    jsch, psch = _schemas()
    arrays = _rows(1, 64)
    rng = np.random.default_rng(2)
    ops = rng.integers(0, 4, 64).astype(np.int8)
    vis = rng.random(64) < 0.6
    np.testing.assert_array_equal(
        pchunk.op_sign(torch.from_numpy(ops)).numpy(),
        np.asarray(jchunk.op_sign(jnp.asarray(ops))))
    jc = JChunk.from_numpy(jsch, arrays, ops=ops, capacity=64).with_vis(vis)
    pc = chunk_from_numpy(psch, arrays, ops, vis, device="cpu")
    jout = jc.compact()
    p_arrays, p_ops, p_vis, _ = chunk_to_numpy(pc.compact())
    np.testing.assert_array_equal(p_vis, np.asarray(jout.vis))
    n = int(vis.sum())
    np.testing.assert_array_equal(p_ops[:n], np.asarray(jout.ops)[:n])
    for pa, jcol in zip(p_arrays, jout.columns):
        np.testing.assert_array_equal(pa[:n], np.asarray(jcol.data)[:n])
    assert pc.to_rows() == jc.to_rows()


@pytest.mark.parametrize("dtypes", [(np.int64,), (np.int32, np.int64),
                                    (np.bool_, np.int16, np.float64)])
def test_host_vnodes_and_crc32_match_jax(dtypes):
    rng = np.random.default_rng(3)
    cols = [rng.integers(-1000, 1000, 500).astype(d) for d in dtypes]
    np.testing.assert_array_equal(pvnode.compute_vnodes_numpy(cols),
                                  jvnode.compute_vnodes_numpy(cols))
    np.testing.assert_array_equal(pvnode.crc32_numpy(cols),
                                  jvnode.crc32_numpy(cols))


def test_serde_bytes_match_jax():
    jsch, psch = _schemas()
    arrays = _rows(4, 50)
    for r in range(50):
        row = tuple(a[r].item() for a in arrays)
        row = row[:2] + (None,) + row[3:] if r % 7 == 0 else row
        jt, pt = jsch.data_types, psch.data_types
        desc = [bool(r % 2), False, True, False, bool(r % 3)]
        assert pserde.encode_memcomparable(row, pt, desc) == \
            jserde.encode_memcomparable(row, jt, desc)
        enc = pserde.RowSerde(psch).encode(row)
        assert enc == jserde.RowSerde(jsch).encode(row)
        assert pserde.RowSerde(psch).decode(enc) == \
            jserde.RowSerde(jsch).decode(enc)


def test_state_table_matches_jax():
    """Same writes, same commits: the two stores hold the same bytes and
    the tables read back the same rows."""
    jsch, psch = _schemas()
    jstore, pstore = JStore(), PStore()
    jt = JTable(jstore, 7, jsch, pk_indices=[0, 1])
    pt = PTable(pstore, 7, psch, pk_indices=[0, 1])
    arrays = _rows(5, 120)
    rows = [tuple(a[r].item() for a in arrays) for r in range(120)]
    epoch = 1 << 16
    for t in (jt, pt):
        t.init_epoch(epoch)
    for b in range(3):
        batch = rows[b * 40:(b + 1) * 40]
        ops = [(0 if i % 5 else 1, row) for i, row in enumerate(batch)]
        for t, st in ((jt, jstore), (pt, pstore)):
            t.write_chunk_rows(ops)
            t.delete(rows[b])
            t.commit(epoch + b + 1)
            st.sync(epoch + b)
    assert list(pstore.iter_range(b"", b"\xff" * 8)) == \
        list(jstore.iter_range(b"", b"\xff" * 8))
    assert list(pt.iter_all()) == list(jt.iter_all())
    for r in rows[:10]:
        assert pt.get_row(r[:2]) == jt.get_row(r[:2])
