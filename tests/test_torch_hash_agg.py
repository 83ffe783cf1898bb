"""Differential tests: the port's HashAggExecutor (plain PyTorch versions
of kernels K3 and K4 on the CPU) against the JAX package's, fed the same
scripted stream of chunks, watermarks and barriers. Per-barrier
changelogs compare as multisets of (op, row): the flush emits in slot
order, and both sides must emit the same rows.

Float SUM inputs are multiples of 1/4 with small magnitude, so every sum
is exact whatever the order of addition and the comparison stays exact.
The stream mixes inserts and deletes, cleans state by watermark, and is
sized to force barrier-time rebuilds and growth."""

import asyncio
from collections import Counter

import numpy as np
import pytest

from risingwave_tpu.common import StreamChunk as JChunk
from risingwave_tpu.common import DataType as JDT
from risingwave_tpu.common.epoch import EpochPair as JEpochPair
from risingwave_tpu.common.types import schema as jschema
from risingwave_tpu.expr import agg as jagg
from risingwave_tpu.stream.hash_agg import HashAggExecutor as JaxAgg
from risingwave_tpu.stream import message as jmsg


@pytest.fixture(autouse=True, scope="module")
def _port():
    """Import torch and the port when these tests run, not at collection:
    an xdist worker then runs the JAX tests before them without torch
    (the sharded-join recovery tests abort more often with it loaded)."""
    global DataType, schema, EpochPair, pagg, agg_state_from_numpy
    global chunk_from_numpy, pmsg, PortAgg, evict_keys_plain
    from risingwave_tpu_torch.common import DataType, schema
    from risingwave_tpu_torch.common.epoch import EpochPair
    from risingwave_tpu_torch.expr import agg as pagg
    from risingwave_tpu_torch.interop import (
        agg_state_from_numpy, chunk_from_numpy)
    from risingwave_tpu_torch.stream import message as pmsg
    from risingwave_tpu_torch.stream.hash_agg import HashAggExecutor as PortAgg
    from risingwave_tpu_torch.stream.hash_agg import evict_keys_plain


COLS = [("k", "INT64"), ("ws", "TIMESTAMP"), ("v", "INT64"),
        ("f", "FLOAT64"), ("s", "INT32")]


class _Scripted:
    """An executor whose stream is a fixed list of messages."""

    def __init__(self, sch, msgs):
        self.schema = sch
        self.pk_indices = ()
        self._msgs = msgs

    async def execute(self):
        for m in self._msgs:
            yield m
            await asyncio.sleep(0)


def make_script(seed, n_epochs=8, cap=64, keys_per_epoch=24,
                with_watermarks=True):
    """[("chunk", arrays, ops, vis) | ("wm", val) | ("barrier",)]."""
    rng = np.random.default_rng(seed)
    script = [("barrier",)]
    live = []          # (k, ws, v, f, s) rows inserted so far
    for e in range(n_epochs):
        base_ws = e * 10
        for _ in range(3):
            n_del = min(len(live), cap // 4)
            dels = [live.pop(rng.integers(len(live))) for _ in range(n_del)
                    if live and rng.random() < 0.5]
            n_ins = cap - len(dels)
            ins = list(zip(
                rng.integers(0, keys_per_epoch // 3, n_ins).tolist(),
                (base_ws + rng.integers(0, 3, n_ins) * 10).tolist(),
                rng.integers(-1000, 1000, n_ins).tolist(),
                (rng.integers(-400, 400, n_ins) / 4).tolist(),
                rng.integers(-50, 50, n_ins).tolist()))
            rows = dels + ins
            ops = np.asarray([1] * len(dels) + [0] * len(ins), np.int8)
            live.extend(ins)
            arrays = [np.asarray([r[j] for r in rows]) for j in range(5)]
            vis = rng.random(cap) < 0.9
            script.append(("chunk", arrays, ops, vis))
        if with_watermarks and e >= 2:
            wm = (e - 1) * 10
            script.append(("wm", wm))
            live = [r for r in live if r[1] >= wm]
        script.append(("barrier",))
    return script


def _messages(script, sch, chunk_cls, barrier_mod, epoch_cls, dt_ts,
              from_numpy):
    out = []
    prev = 0
    for i, item in enumerate(script):
        if item[0] == "chunk":
            _, arrays, ops, vis = item
            out.append(from_numpy(sch, arrays, ops, vis))
        elif item[0] == "wm":
            out.append(barrier_mod.Watermark(1, dt_ts, item[1]))
        else:
            curr = (i + 1) << 16
            kind = (barrier_mod.BarrierKind.INITIAL if prev == 0
                    else barrier_mod.BarrierKind.CHECKPOINT)
            out.append(barrier_mod.Barrier(epoch_cls(curr, prev), kind))
            prev = curr
    return out


def _jax_chunk(sch, arrays, ops, vis):
    return JChunk.from_numpy(sch, arrays, ops=ops,
                             capacity=len(vis)).with_vis(np.asarray(vis))


def _port_chunk(sch, arrays, ops, vis):
    return chunk_from_numpy(sch, arrays, ops, vis, device="cpu")


def _agg_calls(mod, dt):
    return [mod.count_star(), mod.agg_sum(2), mod.agg_sum(3, dt.FLOAT64),
            mod.agg_min(4, dt.INT64, append_only=True),
            mod.agg_max(2, dt.INT64, append_only=True), mod.agg_sum(4)]


async def _changelogs(agg, snapshot_at=None):
    """Per-barrier changelog multisets; optionally the raw state arrays
    right after barrier number `snapshot_at`."""
    logs, cur, n_barriers, snap = [], Counter(), 0, None
    async for msg in agg.execute():
        if hasattr(msg, "to_rows"):
            cur.update(msg.to_rows())
        elif hasattr(msg, "epoch"):
            logs.append(cur)
            cur = Counter()
            if n_barriers == snapshot_at:
                st = agg.state
                snap = dict(
                    table_keys=[np.asarray(k) for k in st.table.keys],
                    occupied=np.asarray(st.table.occupied),
                    agg_states=[np.asarray(a) for a in st.agg_states],
                    row_count=np.asarray(st.row_count),
                    dirty=np.asarray(st.dirty),
                    prev_exists=np.asarray(st.prev_exists),
                    prev_emit=[np.asarray(a) for a in st.prev_emit],
                    capacity=agg.capacity)
            n_barriers += 1
    return logs, snap


def _build(script, capacity, watchdog, clean):
    jsch = jschema(*[(n, getattr(JDT, t)) for n, t in COLS])
    psch = schema(*[(n, getattr(DataType, t)) for n, t in COLS])
    jin = _Scripted(jsch, _messages(script, jsch, JChunk, jmsg, JEpochPair,
                                    JDT.TIMESTAMP, _jax_chunk))
    pin = _Scripted(psch, _messages(script, psch, None, pmsg, EpochPair,
                                    DataType.TIMESTAMP, _port_chunk))
    kw = dict(capacity=capacity, watchdog_interval=watchdog,
              cleaning_watermark_col=1 if clean else None)
    jax_agg = JaxAgg(jin, [0, 1], _agg_calls(jagg, JDT), **kw)
    port_agg = PortAgg(pin, [0, 1], _agg_calls(pagg, DataType),
                       device="cpu", **kw)
    return jax_agg, port_agg, psch


@pytest.mark.parametrize("watchdog", [1, None])
@pytest.mark.parametrize("clean", [True, False])
@pytest.mark.parametrize("keys_per_epoch", [24, 60])
def test_changelogs_match_jax(watchdog, clean, keys_per_epoch):
    script = make_script(seed=17, with_watermarks=clean,
                         keys_per_epoch=keys_per_epoch)
    jax_agg, port_agg, _ = _build(script, 64, watchdog, clean)
    jlogs, _ = asyncio.run(_changelogs(jax_agg))
    plogs, _ = asyncio.run(_changelogs(port_agg))
    assert len(plogs) == len(jlogs) == 9
    for b, (p, j) in enumerate(zip(plogs, jlogs)):
        assert p == j, f"barrier {b}"
    assert sum(len(x) for x in plogs) > 100
    assert port_agg.capacity == jax_agg.capacity
    assert port_agg.rebuilds == jax_agg.rebuilds
    if watchdog == 1:
        # barrier-time growth happened (twice or more at 60 keys/epoch)
        assert port_agg.rebuilds >= (2 if keys_per_epoch == 60 else 1)
        assert port_agg.capacity > 64


def test_state_carried_over_from_jax():
    """Fill the JAX agg over the first barriers, carry its state into the
    port through interop, feed both the rest, compare changelogs."""
    script = make_script(seed=23)
    jax_agg, _, _ = _build(script, 64, 1, True)
    k = 4
    jlogs, snap = asyncio.run(_changelogs(jax_agg, snapshot_at=k))
    # the suffix after barrier k, opened by a fresh first barrier
    idx = [i for i, m in enumerate(script) if m[0] == "barrier"][k]
    suffix = [("barrier",)] + script[idx + 1:]
    _, port_agg, _ = _build(suffix, snap["capacity"], 1, True)
    port_agg.capacity = snap.pop("capacity")
    port_agg.state = agg_state_from_numpy(**snap, device="cpu")
    plogs, _ = asyncio.run(_changelogs(port_agg))
    assert plogs[1:] == jlogs[k + 1:]
    assert sum(len(x) for x in plogs) > 20


@pytest.mark.parametrize("wm", [0, 25, 60])
def test_evict_keys_and_evict_match_jax(wm):
    """Watermark cleaning's two programs on a carried-over state: the
    compacted keys of live groups below the watermark, then the zeroing."""
    script = make_script(seed=29, with_watermarks=False)
    jax_agg, port_agg, _ = _build(script, 64, 1, True)
    # the state after the last barrier, which is jax_agg.state too
    _, snap = asyncio.run(_changelogs(jax_agg, snapshot_at=8))
    port_agg.capacity = snap.pop("capacity")
    port_agg.state = agg_state_from_numpy(**snap, device="cpu")
    jkeys, jn = jax_agg._evict_keys_impl(jax_agg.state, wm)
    # the port's evict-keys program is K18's evict entry; its plain
    # version takes the cleaning key's position
    pkeys, pn = evict_keys_plain(port_agg.state,
                                 port_agg.cleaning_watermark_key, wm)
    assert int(pn) == int(jn)
    for p, j in zip(pkeys, jkeys):
        np.testing.assert_array_equal(p.numpy()[:int(pn)],
                                      np.asarray(j)[:int(jn)])
    jst = jax_agg._evict_impl(jax_agg.state, wm)
    port_agg._evict_impl(port_agg.state, wm)
    pst = port_agg.state
    np.testing.assert_array_equal(pst.row_count.numpy(),
                                  np.asarray(jst.row_count))
    np.testing.assert_array_equal(pst.dirty.numpy(), np.asarray(jst.dirty))
    np.testing.assert_array_equal(pst.prev_exists.numpy(),
                                  np.asarray(jst.prev_exists))
    for p, j in zip(pst.agg_states + pst.prev_emit,
                    jst.agg_states + jst.prev_emit):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
