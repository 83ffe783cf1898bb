"""Carry chunks and device state in and out of the port as numpy arrays.

Takes and returns numpy only, so state built elsewhere (for example by
the JAX package, read there with `np.asarray`) can continue in the port:
the same arrays, the same slots, the same counts. Like every entry
point of the port, each constructor puts its tensors on "cuda" unless
the caller names another device, and raises when there is no card.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .common.chunk import Column, StreamChunk
from .common.types import Schema
from .device import DEFAULT_DEVICE, resolve_device
from .ops.hash_table import HashTable
from .stream.hash_agg import AggState
from .stream.hash_join import HashJoinSideState
from .stream.sorted_join import SortedSideState


def _t(a: np.ndarray, device: torch.device) -> torch.Tensor:
    # a private copy: the port updates state tensors in place
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def chunk_from_numpy(schema: Schema, arrays: Sequence[np.ndarray],
                     ops: np.ndarray, vis: np.ndarray,
                     valids: Optional[Sequence[Optional[np.ndarray]]] = None,
                     device=DEFAULT_DEVICE) -> StreamChunk:
    """A chunk holding exactly these full-capacity arrays (invisible rows
    included), cast to the schema's dtypes."""
    device = resolve_device(device)
    valids = valids or [None] * len(arrays)
    cols = tuple(
        Column(_t(np.asarray(a, dtype=f.data_type.np_dtype), device),
               None if v is None else _t(np.asarray(v, dtype=bool), device))
        for a, v, f in zip(arrays, valids, schema))
    return StreamChunk(cols, _t(np.asarray(ops, dtype=np.int8), device),
                       _t(np.asarray(vis, dtype=bool), device), schema)


def chunk_to_numpy(chunk: StreamChunk):
    """(arrays, ops, vis, valids) of the full capacity."""
    arrays = [c.data.cpu().numpy() for c in chunk.columns]
    valids = [None if c.valid is None else c.valid.cpu().numpy()
              for c in chunk.columns]
    return arrays, chunk.ops.cpu().numpy(), chunk.vis.cpu().numpy(), valids


def hash_table_from_numpy(keys: Sequence[np.ndarray], occupied: np.ndarray,
                          device=DEFAULT_DEVICE) -> HashTable:
    device = resolve_device(device)
    return HashTable(tuple(_t(np.asarray(k), device) for k in keys),
                     _t(np.asarray(occupied, dtype=bool), device))


def agg_state_from_numpy(table_keys: Sequence[np.ndarray],
                         occupied: np.ndarray,
                         agg_states: Sequence[np.ndarray],
                         row_count: np.ndarray, dirty: np.ndarray,
                         prev_exists: np.ndarray,
                         prev_emit: Sequence[np.ndarray],
                         device=DEFAULT_DEVICE) -> AggState:
    """The port's AggState from the arrays of a hash agg's state (the
    JAX package's `AggState` fields, same layout)."""
    device = resolve_device(device)
    return AggState(
        table=hash_table_from_numpy(table_keys, occupied, device),
        agg_states=tuple(_t(np.asarray(a), device) for a in agg_states),
        row_count=_t(np.asarray(row_count, dtype=np.int64), device),
        dirty=_t(np.asarray(dirty, dtype=bool), device),
        prev_exists=_t(np.asarray(prev_exists, dtype=bool), device),
        prev_emit=tuple(_t(np.asarray(a), device) for a in prev_emit),
    )



def sorted_side_from_numpy(khash: np.ndarray, cols: Sequence[np.ndarray],
                           valids: Sequence[np.ndarray], degree: np.ndarray,
                           n: int, device=DEFAULT_DEVICE) -> SortedSideState:
    """The port's SortedSideState from the arrays of one sorted-join side
    (the JAX package's `SortedSideState` fields, same layout)."""
    device = resolve_device(device)
    return SortedSideState(
        khash=_t(np.asarray(khash, dtype=np.int64), device),
        cols=tuple(_t(np.asarray(c), device) for c in cols),
        valids=tuple(_t(np.asarray(v, dtype=bool), device) for v in valids),
        degree=_t(np.asarray(degree, dtype=np.int32), device),
        n=_t(np.asarray(n, dtype=np.int32), device))


def sorted_side_to_numpy(st: SortedSideState) -> dict:
    """The arrays of a side store, for comparison or carrying out."""
    return dict(khash=st.khash.cpu().numpy(),
                cols=[c.cpu().numpy() for c in st.cols],
                valids=[v.cpu().numpy() for v in st.valids],
                degree=st.degree.cpu().numpy(), n=int(st.n))


def hash_join_side_from_numpy(table_keys: Sequence[np.ndarray],
                              occupied: np.ndarray, head: np.ndarray,
                              rows: Sequence[np.ndarray],
                              valids: Sequence[np.ndarray], next: np.ndarray,
                              live: np.ndarray, dirty: np.ndarray, top: int,
                              device=DEFAULT_DEVICE) -> HashJoinSideState:
    """The port's HashJoinSideState from the arrays of one hash-join
    side (the JAX package's `JoinSideState` fields, same layout)."""
    device = resolve_device(device)
    return HashJoinSideState(
        key_table=hash_table_from_numpy(table_keys, occupied, device),
        head=_t(np.asarray(head, dtype=np.int32), device),
        rows=tuple(_t(np.asarray(r), device) for r in rows),
        valids=tuple(_t(np.asarray(v, dtype=bool), device) for v in valids),
        next=_t(np.asarray(next, dtype=np.int32), device),
        live=_t(np.asarray(live, dtype=bool), device),
        dirty=_t(np.asarray(dirty, dtype=bool), device),
        top=_t(np.asarray(top, dtype=np.int32), device))


def hash_join_side_to_numpy(st: HashJoinSideState) -> dict:
    """The arrays of a hash-join side, keyed as the from_numpy
    arguments, for comparison or carrying out."""
    return dict(table_keys=[k.cpu().numpy() for k in st.key_table.keys],
                occupied=st.key_table.occupied.cpu().numpy(),
                head=st.head.cpu().numpy(),
                rows=[r.cpu().numpy() for r in st.rows],
                valids=[v.cpu().numpy() for v in st.valids],
                next=st.next.cpu().numpy(), live=st.live.cpu().numpy(),
                dirty=st.dirty.cpu().numpy(), top=int(st.top))


def top_n_state_from_numpy(ex, khash: np.ndarray, cols: Sequence[np.ndarray],
                           valids: Sequence[np.ndarray], n: int,
                           top_hash: np.ndarray,
                           top_cols: Sequence[np.ndarray],
                           top_valids: Sequence[np.ndarray], top_n: int,
                           errs: Optional[Sequence[int]] = None) -> None:
    """Install a retractable top-N's state in the port's executor `ex`
    (on its device): the sorted store (khash, cols, valids, n) and the
    last emitted top set (top_hash, top_cols, top_valids, top_n), the
    JAX package's `RetractableTopNExecutor` fields, same layout; `errs`
    in the JAX package's [row overflow, delete miss] order."""
    dev = ex.device
    C = len(khash)
    dts = [f.data_type.np_dtype for f in ex.schema]
    ex.capacity = C
    ex.store = sorted_side_from_numpy(
        khash, [np.asarray(c, dtype=dt) for c, dt in zip(cols, dts)],
        valids, np.zeros(C, dtype=np.int32), n, dev)
    ex._spare = None
    ex.top_hash = _t(np.asarray(top_hash, dtype=np.int64), dev)
    ex.top_cols = tuple(_t(np.asarray(c, dtype=dt), dev)
                        for c, dt in zip(top_cols, dts))
    ex.top_valids = tuple(_t(np.asarray(v, dtype=bool), dev)
                          for v in top_valids)
    ex.top_n = _t(np.asarray(top_n, dtype=np.int32), dev)
    if errs is not None:
        ex._errs_dev = _t(np.asarray([0, errs[1], errs[0]], dtype=np.int32),
                          dev)


def top_n_state_to_numpy(ex) -> dict:
    """A retractable top-N's store and last top set as numpy arrays,
    with `errs` in the JAX package's [row overflow, delete miss]
    order."""
    st = ex.store
    return dict(khash=st.khash.cpu().numpy(),
                cols=[c.cpu().numpy() for c in st.cols],
                valids=[v.cpu().numpy() for v in st.valids], n=int(st.n),
                top_hash=ex.top_hash.cpu().numpy(),
                top_cols=[c.cpu().numpy() for c in ex.top_cols],
                top_valids=[v.cpu().numpy() for v in ex.top_valids],
                top_n=int(ex.top_n), errs=ex.errs())


def over_window_state_from_numpy(ex, khash: np.ndarray,
                                 cols: Sequence[np.ndarray],
                                 valids: Sequence[np.ndarray], n: int,
                                 em_hash: np.ndarray,
                                 em_cols: Sequence[np.ndarray],
                                 em_valids: Sequence[np.ndarray], em_n: int,
                                 errs: Optional[Sequence[int]] = None
                                 ) -> None:
    """Install a general over-window's state in the port's executor `ex`
    (on its device): the sorted store (khash, cols, valids, n) and the
    last emitted rows (em_hash, em_cols, em_valids, em_n), the JAX
    package's `GeneralOverWindowExecutor` fields, same layout; `errs` in
    the JAX package's [row overflow, delete miss] order."""
    dev = ex.device
    C = len(khash)
    dts = [f.data_type.np_dtype for f in ex.schema]
    ex.capacity = C
    ex.store = sorted_side_from_numpy(
        khash, [np.asarray(c, dtype=dt) for c, dt in zip(cols, dts)],
        valids, np.zeros(C, dtype=np.int32), n, dev)
    ex._spare = None
    ex.em_hash = _t(np.asarray(em_hash, dtype=np.int64), dev)
    ex.em_cols = tuple(_t(np.asarray(c, dtype=dt), dev)
                       for c, dt in zip(em_cols, dts))
    ex.em_valids = tuple(_t(np.asarray(v, dtype=bool), dev)
                         for v in em_valids)
    ex.em_n = _t(np.asarray(em_n, dtype=np.int32), dev)
    if errs is not None:
        ex._errs_dev = _t(np.asarray([0, errs[1], errs[0]], dtype=np.int32),
                          dev)


def over_window_state_to_numpy(ex) -> dict:
    """A general over-window's store and last emitted rows as numpy
    arrays, with `errs` in the JAX package's [row overflow, delete miss]
    order."""
    st = ex.store
    return dict(khash=st.khash.cpu().numpy(),
                cols=[c.cpu().numpy() for c in st.cols],
                valids=[v.cpu().numpy() for v in st.valids], n=int(st.n),
                em_hash=ex.em_hash.cpu().numpy(),
                em_cols=[c.cpu().numpy() for c in ex.em_cols],
                em_valids=[v.cpu().numpy() for v in ex.em_valids],
                em_n=int(ex.em_n), errs=ex.errs())


def eowc_frontier_from_numpy(ex, emitted_to: int, wm_pending: int) -> None:
    """Install an EOWC over-window's emission frontier and pending
    watermark (the JAX package's `_emitted_to`, `_wm_pending`)."""
    ex._emitted_to = int(emitted_to)
    ex._wm_pending = int(wm_pending)


def eowc_frontier_to_numpy(ex) -> dict:
    return dict(emitted_to=int(ex._emitted_to),
                wm_pending=int(ex._wm_pending))


def simple_agg_state_from_numpy(ex, states: Sequence[np.ndarray],
                                row_count: int,
                                prev_emit: Optional[Sequence[np.ndarray]],
                                emitted: bool) -> None:
    """Install a SimpleAgg's state in the port's executor `ex`: one
    scalar a call, the row count, and the last emission (the JAX
    package's `states`, `row_count`, `_prev_emit`, `_emitted`)."""
    dev = ex.device
    ex.states = tuple(
        torch.tensor(np.asarray(v).item(), dtype=s.state_dtype, device=dev)
        for v, s in zip(states, ex.specs))
    ex.row_count = torch.tensor(int(row_count), dtype=torch.int64,
                                device=dev)
    ex._prev_emit = (None if prev_emit is None
                     else tuple(np.asarray(v) for v in prev_emit))
    ex._emitted = bool(emitted)


def simple_agg_state_to_numpy(ex) -> dict:
    return dict(states=[st.cpu().numpy() for st in ex.states],
                row_count=int(ex.row_count),
                prev_emit=(None if ex._prev_emit is None
                           else [np.asarray(v) for v in ex._prev_emit]),
                emitted=bool(ex._emitted))


def dynamic_filter_state_from_numpy(ex, khash: np.ndarray,
                                    cols: Sequence[np.ndarray],
                                    valids: Sequence[np.ndarray], n: int,
                                    em_hash: np.ndarray,
                                    em_cols: Sequence[np.ndarray],
                                    em_valids: Sequence[np.ndarray],
                                    em_n: int, rhs: Optional[int] = None,
                                    errs: Optional[Sequence[int]] = None
                                    ) -> None:
    """Install a dynamic filter's state in the port's executor `ex`: the
    sorted store, the last emitted (passing) set and the rhs scalar, the
    JAX package's `DynamicFilterExecutor` fields (khash, cols, valids,
    n, em_*, _rhs), same layout; `errs` in its [row overflow, delete
    miss] order."""
    over_window_state_from_numpy(ex, khash, cols, valids, n, em_hash,
                                 em_cols, em_valids, em_n, errs)
    ex._rhs = rhs


def dynamic_filter_state_to_numpy(ex) -> dict:
    """A dynamic filter's store, last emitted set, rhs and errs as numpy
    arrays and host values."""
    return dict(over_window_state_to_numpy(ex), rhs=ex._rhs)


def hll_registers_from_words(words: Sequence[np.ndarray]) -> np.ndarray:
    """8 packed HLL word lanes [G] (int64, the agg's HLL_REG state) ->
    registers [G, 64]: lane L's byte b is register 8L + b."""
    return np.stack([(np.asarray(w, np.int64) >> (8 * b)) & 255
                     for w in words for b in range(8)], axis=-1)


def hll_words_from_registers(regs: np.ndarray) -> list:
    """Registers [G, 64] (each < 256) -> the 8 packed word lanes [G]."""
    regs = np.asarray(regs, np.int64)
    return [np.bitwise_or.reduce(
        [regs[:, 8 * L + b] << (8 * b) for b in range(8)])
        for L in range(8)]
