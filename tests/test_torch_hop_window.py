"""Differential tests: the port's HOP window (plain PyTorch version of
kernel K2 on the CPU) against the JAX package's `_step_impl`, exactly,
including a slide that does not divide the size, pre-epoch (negative)
timestamps, NULL masks, output pruning and watermark mapping."""

import numpy as np
import pytest

from risingwave_tpu.common import DataType as JDT, StreamChunk as JChunk
from risingwave_tpu.common.types import schema as jschema
from risingwave_tpu.stream.hop_window import HopWindowExecutor as JaxHop
from risingwave_tpu.stream.message import Watermark as JWatermark


@pytest.fixture(autouse=True, scope="module")
def _port():
    """Import torch and the port when these tests run, not at collection:
    an xdist worker then runs the JAX tests before them without torch
    (the sharded-join recovery tests abort more often with it loaded)."""
    global DataType, schema, chunk_from_numpy, chunk_to_numpy
    global HopWindowExecutor, Watermark
    from risingwave_tpu_torch.common import DataType, schema
    from risingwave_tpu_torch.interop import chunk_from_numpy, chunk_to_numpy
    from risingwave_tpu_torch.stream.hop_window import HopWindowExecutor
    from risingwave_tpu_torch.stream.message import Watermark


class _Input:
    def __init__(self, sch):
        self.schema = sch
        self.pk_indices = ()


COLS = [("auction", "INT64"), ("channel", "VARCHAR"), ("flag", "BOOLEAN"),
        ("date_time", "TIMESTAMP")]


def _inputs(seed, cap, negative):
    rng = np.random.default_rng(seed)
    lo = -30_000_000 if negative else 1_500_000_000_000_000
    ts = np.sort(rng.integers(lo, lo + 60_000_000, size=cap))
    arrays = [rng.integers(1000, 1100, size=cap),
              rng.integers(0, 50, size=cap).astype(np.int32),
              rng.integers(0, 2, size=cap).astype(bool), ts]
    ops = rng.integers(0, 4, size=cap).astype(np.int8)
    vis = rng.random(cap) < 0.8
    valid = rng.random(cap) < 0.9
    return arrays, ops, vis, [None, valid, None, None]


@pytest.mark.parametrize("slide,size", [(2_000_000, 10_000_000),
                                        (3_000_000, 10_000_000),
                                        (7, 5)])
@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("output_indices", [None, (0, 4), (3, 1, 5, 4)])
def test_hop_expand_matches_jax(slide, size, negative, output_indices):
    cap = 96
    arrays, ops, vis, valids = _inputs(11, cap, negative)
    jsch = jschema(*[(n, getattr(JDT, t)) for n, t in COLS])
    psch = schema(*[(n, getattr(DataType, t)) for n, t in COLS])
    jhop = JaxHop(_Input(jsch), time_col=3, window_slide_us=slide,
                  window_size_us=size, output_indices=output_indices)
    phop = HopWindowExecutor(_Input(psch), time_col=3, window_slide_us=slide,
                             window_size_us=size,
                             output_indices=output_indices)
    jc = JChunk.from_numpy(jsch, arrays, ops=ops, capacity=cap,
                           valids=valids).with_vis(vis)
    pc = chunk_from_numpy(psch, arrays, ops, vis, valids,
                          device="cpu")
    jout = jhop._step_impl(jc)
    pout = phop.map_chunk(pc)
    assert phop.schema.names == jhop.schema.names
    assert (phop.window_start_idx, phop.window_end_idx) == \
        (jhop.window_start_idx, jhop.window_end_idx)
    p_arrays, p_ops, p_vis, p_valids = chunk_to_numpy(pout)
    assert np.array_equal(p_ops, np.asarray(jout.ops))
    assert np.array_equal(p_vis, np.asarray(jout.vis))
    for pa, pv, jcol in zip(p_arrays, p_valids, jout.columns):
        assert pa.dtype == np.asarray(jcol.data).dtype
        assert np.array_equal(pa, np.asarray(jcol.data))
        assert (pv is None) == (jcol.valid is None)
        if pv is not None:
            assert np.array_equal(pv, np.asarray(jcol.valid))


@pytest.mark.parametrize("output_indices", [None, (0, 4), (3, 0)])
@pytest.mark.parametrize("col,val", [(3, 1_500_000_012_345_678),
                                     (3, -7_000_001), (0, 42), (1, 5)])
def test_hop_watermark_mapping_matches_jax(output_indices, col, val):
    jsch = jschema(*[(n, getattr(JDT, t)) for n, t in COLS])
    psch = schema(*[(n, getattr(DataType, t)) for n, t in COLS])
    kw = dict(time_col=3, window_slide_us=3_000_000,
              window_size_us=10_000_000, output_indices=output_indices)
    jw = JaxHop(_Input(jsch), **kw).map_watermark(
        JWatermark(col, JDT.TIMESTAMP, val))
    pw = HopWindowExecutor(_Input(psch), **kw).map_watermark(
        Watermark(col, DataType.TIMESTAMP, val))
    if jw is None:
        assert pw is None
    else:
        assert (pw.col_idx, pw.val) == (jw.col_idx, jw.val)
