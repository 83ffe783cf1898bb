"""Now and DynamicFilter executors (port of
risingwave_tpu/stream/dynamic.py).

Reference: now.rs (a barrier-driven one-row changelog of the epoch's
timestamp) and dynamic_filter.rs (filter a stream against a CHANGING
scalar, the right side, a one-row stream such as NOW(); when the scalar
moves, rows crossing the boundary emit Deletes and Inserts).

The left rows live in the dense sorted store of stream/sorted_store.py
(stream-key hash order; a chunk's apply is K11 passes, kernel K19 and
kernel K7), and each barrier's flush recomputes `col OP rhs` over the
whole store and emits the membership diff against the last passing set:

  1. kernel K29's first entry (`csrc/dynamic_filter.cu`): the predicate
     over live rows with a valid filter column, and the row hash of
     every passing row over its (value, valid) lanes (the sentinel
     elsewhere), with the passing count;
  2. a stable sort of those hashes (kernel K11), carrying the slot order;
  3. K29's second entry: membership of each set in the other by binary
     search over hashes alone, as the reference's `member` compares, and
     the 2C-row chunk: Deletes of the rows that left the passing set,
     then Inserts of the rows that joined it.

Retractions and updates of left rows fall out of the same diff. The
rhs is a host scalar: an insert sets it, a delete of the current value
clears it (no rhs row: nothing passes, and a flush against a sentinel no
row passes empties the emitted set).

Left out of this slice: durable state (the JAX executor has none
either) and the memory manager's accounting.
"""

from __future__ import annotations

import asyncio
import ctypes
from typing import Optional, Sequence

import torch

from ..common.chunk import (
    Column, StreamChunk, OP_DELETE, OP_INSERT, OP_UPDATE_INSERT,
)
from ..common.epoch import EPOCH_PHYSICAL_SHIFT
from ..common.types import DataType, Field, Schema
from ..device import resolve_device
from ..expr.program import TYPE_CODES
from ..ops import kernels
from ..ops.sort import stable_sort
from ..utils.d2h import as_i64_lanes
from .align import LEFT, RIGHT, barrier_align
from .executor import Executor
from .message import Barrier, BarrierKind, Watermark
from .retract_top_n import topn_diff_plain
from .sorted_join import (
    HASH_BITS, HSENTINEL, MAX_STORE_COLS, SortedSideState, _Buffers,
    empty_sorted_side, key_hash,
)
from .sorted_store import GrowableSortedStore, sorted_store_apply

_P = ctypes.c_void_p
_PP = ctypes.POINTER(_P)
_PI = ctypes.POINTER(ctypes.c_int)
_L = ctypes.c_longlong
_I = ctypes.c_int
INT64_MAX = (1 << 63) - 1
INT64_MIN = -(1 << 63)
OPS = ("greater_than", "greater_than_or_equal", "less_than",
       "less_than_or_equal")
# the smallest normal float64 and float32: XLA's CPU compare takes
# values below them as zero
_TINY = {torch.float64: 2.2250738585072014e-308,
         torch.float32: 1.1754943508222875e-38}

# K29. Replaces stream/dynamic.py:DynamicFilterExecutor._flush_impl (127).
K_DYNF = kernels.register(kernels.CudaKernel(
    "dynamic_filter",
    replaces="risingwave_tpu/stream/dynamic.py:127",
    functions={
        "rw_dynf_hash": [_L, _I, _PP, _PP, _PI, _I, _I, _L, _P, _P, _P,
                         _P],
        "rw_dynf_diff": [_L, _P, _P, _P, _P, _P, _I, _PP, _PP, _PP, _PP,
                         _PP, _PP, _PI, _P, _P, _P]}))


# ------------------------------------------------------------------ K29

def _passing_plain(x: torch.Tensor, op: str, rhs: int) -> torch.Tensor:
    """`x OP rhs` as the reference computes it: integers as int64, floats
    as float64 against the rhs converted to float64, with subnormals as
    zero (XLA's CPU compare); NaN fails every OP."""
    if x.is_floating_point():
        tiny = _TINY[x.dtype]
        x = torch.where(x.abs() < tiny, 0.0, x).to(torch.float64)
        y = torch.tensor(rhs, dtype=torch.int64).to(torch.float64).item()
    else:
        x, y = x.to(torch.int64), rhs
    if op == "greater_than":
        return x > y
    if op == "greater_than_or_equal":
        return x >= y
    if op == "less_than":
        return x < y
    return x <= y


def dynf_hash_plain(store: SortedSideState, key_col: int, op: str,
                    rhs: int):
    """Plain PyTorch version of kernel K29's first entry: (rhash int64
    [C], the row hash of each live row whose filter column is valid and
    passes, the sentinel elsewhere; the passing count, int32)."""
    C = store.capacity
    live = torch.arange(C, device=store.khash.device) < store.n
    passing = _passing_plain(store.cols[key_col], op, rhs) & live \
        & store.valids[key_col]
    lanes = []
    for c, v in zip(store.cols, store.valids):
        lanes.append(torch.where(v, as_i64_lanes(c), 0))
        lanes.append(v.to(torch.int64))
    rhash = torch.where(passing, key_hash(lanes), HSENTINEL)
    return rhash, passing.sum(dtype=torch.int32)


def dynf_hash(store: SortedSideState, key_col: int, op: str, rhs: int):
    """Kernel K29's first entry on a CUDA device, the plain version on
    the CPU."""
    dev = store.khash.device
    if dev.type == "cpu":
        return dynf_hash_plain(store, key_col, op, rhs)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    C = store.capacity
    if not 1 <= len(store.cols) <= MAX_STORE_COLS:
        raise ValueError(f"K29 hashes 1..{MAX_STORE_COLS} row columns")
    for c in store.cols:
        if c.dtype not in TYPE_CODES or not c.is_contiguous():
            raise ValueError(f"K29 does not take {c.dtype} columns")
    rhash = torch.empty(C, dtype=torch.int64, device=dev)
    n_new = torch.empty((), dtype=torch.int32, device=dev)
    K_DYNF.launches += 1
    K_DYNF.call("rw_dynf_hash", C, len(store.cols),
                kernels.ptr_array(store.cols),
                kernels.ptr_array(store.valids),
                kernels.int_array(TYPE_CODES[c.dtype] for c in store.cols),
                key_col, OPS.index(op), int(rhs), kernels.ptr(store.n),
                kernels.ptr(rhash), kernels.ptr(n_new),
                kernels.stream_of(rhash))
    return rhash, n_new


def dynf_diff(store: SortedSideState, new_hash, src, n_new, em_hash,
              em_cols, em_valids, em_n):
    """Kernel K29's second entry on a CUDA device, the plain version (the
    top-N's, the same function) on the CPU: (out columns, out valids,
    ops, vis) of the 2C-row changelog."""
    dev = store.khash.device
    if dev.type == "cpu":
        return topn_diff_plain(store, new_hash, src, n_new, em_hash,
                               em_cols, em_valids, em_n)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    C = store.capacity
    K = len(store.cols)
    if not 1 <= K <= MAX_STORE_COLS or len(em_cols) != K:
        raise ValueError(f"K29 takes 1..{MAX_STORE_COLS} like columns")
    for t in (new_hash, src, em_hash, *em_cols, *em_valids,
              *store.cols, *store.valids):
        if t.shape != (C,) or not t.is_contiguous() or t.device != dev:
            raise ValueError("K29 takes contiguous tensors of the store's "
                             "capacity")
    out_cols = tuple(torch.empty(2 * C, dtype=c.dtype, device=dev)
                     for c in store.cols)
    out_valids = tuple(torch.empty(2 * C, dtype=torch.bool, device=dev)
                       for _ in store.cols)
    ops = torch.empty(2 * C, dtype=torch.int8, device=dev)
    vis = torch.empty(2 * C, dtype=torch.bool, device=dev)
    P = kernels.ptr_array
    K_DYNF.launches += 1
    K_DYNF.call("rw_dynf_diff", C, kernels.ptr(em_hash), kernels.ptr(em_n),
                kernels.ptr(new_hash), kernels.ptr(n_new), kernels.ptr(src),
                K, P(store.cols), P(store.valids), P(em_cols), P(em_valids),
                P(out_cols), P(out_valids),
                kernels.int_array(c.element_size() for c in store.cols),
                kernels.ptr(ops), kernels.ptr(vis), kernels.stream_of(ops))
    return out_cols, out_valids, ops, vis


def dynf_flush(store: SortedSideState, key_col: int, op: str, rhs: int,
               em_hash, em_cols, em_valids, em_n, plain: bool = False):
    """The barrier flush: (new emitted hash, cols, valids, count; the
    output chunk's columns, valids, ops, vis). The new set's columns and
    valids are views of the output's second half. `plain`: every step's
    plain version (torch's sort included), on any device."""
    C = store.capacity
    if plain:
        rhash, n_new = dynf_hash_plain(store, key_col, op, rhs)
        new_hash, src = torch.sort(rhash, stable=True)
        out = topn_diff_plain(store, new_hash, src, n_new, em_hash,
                              em_cols, em_valids, em_n)
    else:
        rhash, n_new = dynf_hash(store, key_col, op, rhs)
        new_hash, src = stable_sort(rhash, HASH_BITS)
        out = dynf_diff(store, new_hash, src, n_new, em_hash, em_cols,
                        em_valids, em_n)
    out_cols, out_valids, ops, vis = out
    return (new_hash, tuple(c[C:] for c in out_cols),
            tuple(v[C:] for v in out_valids), n_new,
            out_cols, out_valids, ops, vis)


# ------------------------------------------------------------ executors

class NowExecutor(Executor):
    """One-row changelog of the epoch's physical timestamp (µs), updated
    at every barrier (now.rs): Delete(old) + Insert(new)."""

    def __init__(self, barrier_queue: asyncio.Queue, name: str = "now",
                 device="cuda"):
        self.device = resolve_device(device)
        self.barrier_queue = barrier_queue
        self.schema = Schema((Field(name, DataType.TIMESTAMP),))
        self.pk_indices = ()
        self.identity = "Now"
        self._last: Optional[int] = None

    @staticmethod
    def _epoch_us(epoch: int) -> int:
        return (epoch >> EPOCH_PHYSICAL_SHIFT) * 1000   # physical ms -> us

    def _chunk(self, rows) -> StreamChunk:
        cap = 4
        ops = torch.zeros(cap, dtype=torch.int8)
        vals = torch.zeros(cap, dtype=torch.int64)
        for i, (op, v) in enumerate(rows):
            ops[i], vals[i] = op, v
        vis = torch.arange(cap) < len(rows)
        dev = self.device
        return StreamChunk((Column(vals.to(dev)),), ops.to(dev), vis.to(dev),
                           self.schema)

    async def execute(self):
        while True:
            barrier: Barrier = await self.barrier_queue.get()
            ts = self._epoch_us(barrier.epoch.curr)
            if self._last is None:
                yield self._chunk([(OP_INSERT, ts)])
                self._last = ts
            elif ts > self._last:
                yield self._chunk([(OP_DELETE, self._last),
                                   (OP_INSERT, ts)])
                self._last = ts
            yield barrier
            if barrier.is_stop_any():
                return


class DynamicFilterExecutor(GrowableSortedStore, Executor):
    """left WHERE left[key_col] OP right_scalar, right_scalar changing."""

    _SECONDARY = ("em_hash", "em_cols", "em_valids")

    def __init__(self, left: Executor, right: Executor, key_col: int,
                 op: str = "greater_than", capacity: int = 1 << 14,
                 pk_indices: Optional[Sequence[int]] = None,
                 watchdog_interval: Optional[int] = 1, device="cuda"):
        if op not in OPS:
            raise ValueError(f"unknown dynamic filter op {op!r}")
        self.device = resolve_device(device)
        self.inputs = (left, right)
        self.schema = left.schema
        self.pk_indices = tuple(
            pk_indices if pk_indices is not None
            else (left.pk_indices or range(len(left.schema))))
        self.key_col = key_col
        self.op = op
        self.capacity = capacity
        self.identity = f"DynamicFilter(${key_col} {op} <rhs>)"
        self._col_dtypes = tuple(f.data_type.torch_dtype
                                 for f in left.schema)
        C, dev = capacity, self.device
        self.store = empty_sorted_side(C, self._col_dtypes, dev)
        # last emitted (passing) set: its sorted row hashes and rows
        self.em_hash = torch.full((C,), HSENTINEL, dtype=torch.int64,
                                  device=dev)
        self.em_cols = tuple(torch.zeros(C, dtype=dt, device=dev)
                             for dt in self._col_dtypes)
        self.em_valids = tuple(torch.zeros(C, dtype=torch.bool, device=dev)
                               for _ in self._col_dtypes)
        self.em_n = torch.zeros((), dtype=torch.int32, device=dev)
        # K7's error layout [unused, delete miss, row overflow]
        self._errs_dev = torch.zeros(3, dtype=torch.int32, device=dev)
        self._spare: Optional[SortedSideState] = None
        self._bufs = _Buffers(dev)
        self._rhs: Optional[int] = None      # host scalar (one rhs row)
        self._dirty = False
        if watchdog_interval not in (None, 1):
            raise ValueError("watchdog_interval must be 1 or None")
        self.watchdog_interval = watchdog_interval

    def errs(self) -> list[int]:
        """[row overflow, delete miss] (one fetch), the JAX package's
        layout."""
        e = [int(x) for x in self._errs_dev.cpu()]
        return [e[2], e[1]]

    def fence_tokens(self) -> list:
        return [self.store.n, self.em_n]

    def _apply(self, chunk: StreamChunk) -> None:
        spare = None
        if self.device.type == "cuda":
            if self._spare is None:
                self._spare = empty_sorted_side(
                    self.capacity, self._col_dtypes, self.device)
            spare = self._spare
        new = sorted_store_apply(self.store, self._errs_dev, chunk,
                                 self.pk_indices, spare, self._bufs)
        old = self.store
        self.store = new
        if self.device.type == "cuda":
            self._spare = old

    def _flush(self, rhs: int) -> StreamChunk:
        (self.em_hash, self.em_cols, self.em_valids, self.em_n,
         out_cols, out_valids, ops, vis) = dynf_flush(
            self.store, self.key_col, self.op, rhs, self.em_hash,
            self.em_cols, self.em_valids, self.em_n)
        return StreamChunk(tuple(Column(c, v) for c, v in
                                 zip(out_cols, out_valids)),
                           ops, vis, self.schema)

    def _check_watchdog(self) -> None:
        vals = torch.cat([self._errs_dev,
                          self.store.n.view(1)]).cpu().tolist()
        if vals[2] or vals[1]:
            raise RuntimeError(f"dynamic filter state errors "
                               f"{[vals[2], vals[1]]}")
        self._maybe_grow(vals[3])

    async def execute(self):
        first = True
        async for kind, s, msg in barrier_align(*self.inputs):
            if kind == "chunk":
                if s == RIGHT:
                    # the one-row dynamic side, in changelog order: an
                    # insert sets the scalar, a delete of the CURRENT
                    # value clears it (no rhs row: nothing passes)
                    for op, vals in msg.to_rows():
                        if op in (OP_INSERT, OP_UPDATE_INSERT):
                            self._rhs = vals[0]
                        elif vals[0] == self._rhs:
                            self._rhs = None
                else:
                    self._apply(msg)
                self._dirty = True
            elif kind == "barrier":
                barrier: Barrier = msg
                if first or barrier.kind is BarrierKind.INITIAL:
                    first = False
                    yield barrier
                    continue
                if self._dirty and self._rhs is None \
                        and int(self.em_n) != 0:
                    # rhs retracted: the passing set empties (a sentinel
                    # no row passes)
                    yield self._flush(INT64_MAX if self.op.startswith(
                        "greater") else INT64_MIN)
                    self._dirty = False
                if self._dirty and self._rhs is not None:
                    yield self._flush(int(self._rhs))
                    self._dirty = False
                if self.watchdog_interval:
                    self._check_watchdog()
                yield barrier
            else:
                wm: Watermark = msg
                if s != LEFT or wm.col_idx != self.key_col:
                    # non-key watermarks are dropped: any threshold move
                    # deletes rows below an already-forwarded watermark
                    continue
                if self.op in ("greater_than", "greater_than_or_equal") \
                        and self._rhs is not None:
                    # capped at the rhs: a rising threshold later deletes
                    # rows in (old rhs, new rhs]
                    yield Watermark(wm.col_idx, wm.data_type,
                                    min(wm.val, self._rhs))
