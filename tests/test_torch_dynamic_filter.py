"""Differential tests of the port's Now and DynamicFilter executors
against the JAX package's.

Lockstep: the same chunks go through both dynamic filters' store apply,
then both flush against the same rhs: the plain version of kernel K29
(predicate, row hashes, sort, membership diff) against JAX's
`_flush_impl`. After every flush the store, the emitted set and the
2C-row output (ops, vis, every column and valid mask) are equal slot
for slot, read through `interop`. Cases: the four ops over an int64
column, with retractions and NULL filter values; a float64 column with
NaN, +-0, subnormals and infinities; an rhs retracted to none (the
sentinel flush).

Stream: NowExecutor's changelog is JAX's for the same barriers, and a
dynamic filter driven through barrier alignment (rhs rows, a retracted
rhs, key and non-key watermarks) emits JAX's per-barrier changelogs as
multisets and JAX's watermarks (non-key ones dropped, key ones capped at
the rhs for > and >=)."""

import asyncio
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest

from risingwave_tpu.common import StreamChunk as JChunk
from risingwave_tpu.common import DataType as JDT
from risingwave_tpu.common.epoch import EpochPair as JEpochPair
from risingwave_tpu.common.types import schema as jschema
from risingwave_tpu.stream.dynamic import (
    DynamicFilterExecutor as JaxDynf, NowExecutor as JaxNow)

INS, DEL, UD, UI = 0, 1, 2, 3
CAP = 16
C = 64


@pytest.fixture(autouse=True, scope="module")
def _port():
    """Import torch and the port when these tests run, not at collection:
    an xdist worker then runs the JAX tests before them without torch."""
    global torch, Scripted, DataType, schema, EpochPair, chunk_from_numpy
    global pmsg
    global PortDynf, PortNow, dynamic_filter_state_to_numpy
    import torch
    from chip_smoke import Scripted
    from risingwave_tpu_torch.common import DataType, schema
    from risingwave_tpu_torch.common.epoch import EpochPair
    from risingwave_tpu_torch.interop import (
        chunk_from_numpy, dynamic_filter_state_to_numpy)
    from risingwave_tpu_torch.stream import message as pmsg
    from risingwave_tpu_torch.stream.dynamic import (
        DynamicFilterExecutor as PortDynf, NowExecutor as PortNow)


def _schemas(port: bool, vtype: str):
    dt = DataType if port else JDT
    mk = schema if port else jschema
    return (mk(("id", dt.INT64), ("v", getattr(dt, vtype))),
            mk(("now", dt.TIMESTAMP)))


def _arrays(rows, vtype, valid=None, cap=CAP):
    n = len(rows)
    ids = np.zeros(cap, np.int64)
    v = np.zeros(cap, np.float64 if vtype == "FLOAT64" else np.int64)
    ops = np.zeros(cap, np.int8)
    ids[:n] = [r[1] for r in rows]
    v[:n] = [r[2] for r in rows]
    ops[:n] = [r[0] for r in rows]
    vv = None
    if valid is not None:
        vv = np.ones(cap, bool)
        vv[:n] = valid
    return [ids, v], ops, np.arange(cap) < n, [None, vv]


def _jchunk(sch, arrays, ops, vis, valids):
    ch = JChunk.from_numpy(sch, arrays, ops=ops, capacity=len(vis),
                           valids=valids)
    return ch.with_vis(np.asarray(vis))


def _pair(op, vtype):
    lj, rj = _schemas(False, vtype)
    lp, rp = _schemas(True, vtype)
    jd = JaxDynf(Scripted(lj, pk=(0,)), Scripted(rj), key_col=1, op=op,
                 capacity=C)
    pd = PortDynf(Scripted(lp, pk=(0,)), Scripted(rp), key_col=1, op=op,
                  capacity=C, device="cpu")
    return jd, pd


def _assert_equal(jd, pd):
    p = dynamic_filter_state_to_numpy(pd)
    np.testing.assert_array_equal(np.asarray(jd.khash), p["khash"])
    assert int(np.asarray(jd.n)) == p["n"]
    assert int(np.asarray(jd.em_n)) == p["em_n"]
    np.testing.assert_array_equal(np.asarray(jd.em_hash), p["em_hash"])
    for a, b in zip(list(jd.cols) + list(jd.em_cols),
                    p["cols"] + p["em_cols"]):
        np.testing.assert_array_equal(np.asarray(a), b)
    for a, b in zip(list(jd.valids) + list(jd.em_valids),
                    p["valids"] + p["em_valids"]):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert np.asarray(jd._errs_dev).tolist() == p["errs"]


def _lockstep(op, vtype, steps):
    """steps: ("c", rows[, valid]) applies a chunk; ("f", rhs) flushes
    against rhs. Returns the number of visible rows each flush emitted."""
    jd, pd = _pair(op, vtype)
    lj = _schemas(False, vtype)[0]
    lp = _schemas(True, vtype)[0]
    emitted = []
    for st in steps:
        if st[0] == "c":
            a = _arrays(st[1], vtype, st[2] if len(st) > 2 else None)
            (jd.khash, jd.cols, jd.valids, jd.n, jd._errs_dev) = jd._apply(
                jd.khash, jd.cols, jd.valids, jd.n, jd._errs_dev,
                _jchunk(lj, *a))
            pd._apply(chunk_from_numpy(lp, *a, device="cpu"))
        else:
            (jd.em_hash, jd.em_cols, jd.em_valids, jd.em_n, jcols, jops,
             jvis) = jd._flush(jd.khash, jd.cols, jd.valids, jd.n,
                               jd.em_hash, jd.em_cols, jd.em_valids,
                               jd.em_n, jnp.int64(st[1]))
            out = pd._flush(st[1])
            np.testing.assert_array_equal(np.asarray(jvis), out.vis.numpy())
            np.testing.assert_array_equal(np.asarray(jops), out.ops.numpy())
            for a, b in zip(jcols, out.columns):
                np.testing.assert_array_equal(np.asarray(a.data),
                                              b.data.numpy())
                np.testing.assert_array_equal(np.asarray(a.valid_mask()),
                                              b.valid_mask().numpy())
            emitted.append(int(out.vis.sum()))
        _assert_equal(jd, pd)
    return emitted


INT_STEPS = [
    ("c", [(INS, i, 10 * i) for i in range(12)]),
    ("f", 45),
    # a NULL filter value never passes; a retraction and an update
    ("c", [(INS, 20, 70), (DEL, 3, 30), (UD, 7, 70), (UI, 7, 5)],
     [False, True, True, True]),
    ("f", 45),
    ("f", 80),
    ("f", -5),
    ("f", (1 << 63) - 1),                # the sentinels of a retraction
    ("f", -(1 << 63)),
]

FLOAT_STEPS = [
    ("c", [(INS, 0, float("nan")), (INS, 1, 0.0), (INS, 2, -0.0),
           (INS, 3, 5e-324), (INS, 4, -5e-324), (INS, 5, float("inf")),
           (INS, 6, float("-inf")), (INS, 7, 1.5), (INS, 8, -1.5),
           (INS, 9, 2.0 ** 62)]),
    ("f", 0),
    ("f", 1),
    ("f", -1),
    ("c", [(DEL, 1, 0.0), (UD, 5, float("inf")), (UI, 5, 7.25)]),
    ("f", 0),
    ("f", 1 << 62),
    ("f", (1 << 63) - 1),
]


@pytest.mark.parametrize("op", ["greater_than", "greater_than_or_equal",
                                "less_than", "less_than_or_equal"])
@pytest.mark.parametrize("vtype", ["INT64", "FLOAT64"])
def test_flush_lockstep(op, vtype):
    emitted = _lockstep(op, vtype, INT_STEPS if vtype == "INT64"
                        else FLOAT_STEPS)
    assert sum(emitted) > 0


def _barrier(mod, pair, curr, prev):
    kind = mod.BarrierKind.INITIAL if prev == 0 else \
        mod.BarrierKind.CHECKPOINT
    return mod.Barrier(pair(curr, prev), kind)


def test_now_executor_matches_jax():
    """The same barriers give the same one-row changelog (an Insert, then
    Delete(old) + Insert(new) at each later epoch, nothing for an epoch
    that did not advance its millisecond)."""
    epochs = [(5 << 16, 0), ((5 << 16) + 1, 5 << 16),
              (9 << 16, (5 << 16) + 1), (12 << 16, 9 << 16)]

    def run(port):
        from risingwave_tpu.stream import message as jmod
        mod, pair = (pmsg, EpochPair) if port else (jmod, JEpochPair)

        async def go():
            q = asyncio.Queue()
            for c, p in epochs:
                q.put_nowait(_barrier(mod, pair, c, p))
            ex = PortNow(q, device="cpu") if port else JaxNow(q)
            out, n = [], 0
            async for m in ex.execute():
                if hasattr(m, "to_rows"):
                    out.append(m.to_rows())
                else:
                    n += 1
                    if n == len(epochs):
                        break
            return out
        return asyncio.run(go())
    assert run(True) == run(False)
    assert run(True)[-1] == [(DEL, (9000,)), (INS, (12000,))]


def _stream(port, op, left_script, right_script):
    """Drive a dynamic filter over scripted inputs; scripts hold ("c",
    rows), ("wm", col, val) and ("b", curr). Returns (changelog per
    barrier as multisets, watermarks as (col, val))."""
    if port:
        mod, pair = pmsg, EpochPair
    else:
        from risingwave_tpu.stream import message as mod
        pair = JEpochPair
    lsch, rsch = _schemas(port, "INT64")

    def msgs(script, sch, right):
        out, prev = [], 0
        for item in script:
            if item[0] == "c":
                if right:
                    n = len(item[1])
                    a = ([np.asarray([r[1] for r in item[1]] + [0] * (4 - n),
                                     np.int64)],
                         np.asarray([r[0] for r in item[1]] + [0] * (4 - n),
                                    np.int8), np.arange(4) < n, [None])
                else:
                    a = _arrays(item[1], "INT64")
                out.append(chunk_from_numpy(sch, *a, device="cpu") if port
                           else _jchunk(sch, *a))
            elif item[0] == "wm":
                dt = DataType.INT64 if port else JDT.INT64
                out.append(mod.Watermark(item[1], dt, item[2]))
            else:
                out.append(_barrier(mod, pair, item[1], prev))
                prev = item[1]
        return out

    cls, kw = (PortDynf, {"device": "cpu"}) if port else (JaxDynf, {})
    ex = cls(Scripted(lsch, msgs(left_script, lsch, False), pk=(0,)),
             Scripted(rsch, msgs(right_script, rsch, True)),
             key_col=1, op=op, capacity=C, **kw)

    async def go():
        logs, wms, c = [], [], Counter()
        async for m in ex.execute():
            if hasattr(m, "to_rows"):
                for o, vals in m.to_rows():
                    c[(1 if o in (INS, UI) else -1, vals)] += 1
            elif hasattr(m, "epoch"):
                logs.append(c)
                c = Counter()
            else:
                wms.append((m.col_idx, m.val))
        return logs, wms
    return asyncio.run(go())


@pytest.mark.parametrize("op", ["greater_than", "less_than_or_equal"])
def test_stream_changelog_and_watermarks(op):
    left = [("b", 1), ("c", [(INS, i, 10 * i) for i in range(8)]),
            ("wm", 1, 35), ("wm", 0, 3), ("b", 2),
            ("c", [(DEL, 2, 20), (INS, 9, 90)]), ("wm", 1, 80), ("b", 3),
            ("b", 4), ("b", 5)]
    right = [("b", 1), ("c", [(INS, 25)]), ("b", 2),
             ("c", [(DEL, 25), (INS, 55)]), ("b", 3),
             ("c", [(DEL, 55)]), ("b", 4), ("c", [(INS, 5)]), ("b", 5)]
    got = _stream(True, op, left, right)
    want = _stream(False, op, left, right)
    assert got == want
    logs, wms = got
    assert sum(len(c) for c in logs) > 0
    # the non-key watermark (col 0) never passes; > caps the key's at
    # the rhs (35 -> 25, 80 -> 55); <= forwards none
    assert wms == ([(1, 25), (1, 55)] if op == "greater_than" else [])
