"""Retractable (group) top-N — full-input sorted state, per-barrier diff
(port of risingwave_tpu/stream/retract_top_n.py).

The whole live input lives in the dense sorted store of
stream/sorted_store.py, keyed by a hash of the row key (the stream key;
retractions address rows by it); a chunk's apply is K11 passes, kernel
K19 and kernel K7. At each barrier the flush:

  1. keys: kernel K20's first entry (`csrc/top_n_rank.cu`) maps every
     order key to an int64 that sorts as the reference's does and makes
     the group key (the group columns' hash for live slots, int64 max
     for dead ones);
  2. lexsorts the slots by (group key, order keys, row-key hash): K11
     passes over the whole capacity, as the reference sorts it;
  3. rank: K20's second entry ranks each slot within its group's run,
     selects ranks in [offset, offset + limit) and writes their full-row
     hashes (the sentinel elsewhere);
  4. sorts those hashes (K11), carrying the slot order;
  5. diff: kernel K21 (`csrc/top_n_diff.cu`) tests membership in the last
     emitted set and back by binary search and writes the 2C-row output:
     Deletes of the rows that left the top set, then Inserts of the rows
     that joined it. A retracted top row is refilled from below: rank
     promotion pulls the next row in and the diff emits it.

Durable state (`state_table`, over the input schema and stream key):
every input chunk of an epoch is written to the table at the barrier,
as the reference persists every input row; recovery re-applies the
stored rows and runs one flush whose output is discarded, to seed the
diff's baseline with the top set the MV already holds.

Ties at the limit are broken by the row-key hash (the least significant
lexsort key), so which of several equal rows is emitted is the
reference's choice, row for row.

Left out of this slice: the memory manager's accounting
(`state_bytes`) and the sharded variant (ROADMAP Queue A step 9).
"""

from __future__ import annotations

import ctypes
import time
from typing import Optional, Sequence

import torch

from ..common.chunk import Column, StreamChunk, OP_DELETE, OP_INSERT
from ..device import resolve_device
from ..expr.program import TYPE_CODES
from ..ops import kernels
from ..ops.sort import (
    lexsort_plain, order_key_plain, stable_lexsort, stable_sort,
)
from ..state.storage_table import rows_to_columns
from .executor import Executor, StatefulUnaryExecutor
from .message import Barrier, Watermark
from .sorted_join import (
    HASH_BITS, HSENTINEL, MAX_COLS, SortedSideState, _Buffers,
    empty_sorted_side, key_hash,
)
from .sorted_store import GrowableSortedStore, sorted_store_apply

_P = ctypes.c_void_p
_PP = ctypes.POINTER(_P)
_PI = ctypes.POINTER(ctypes.c_int)
_L = ctypes.c_longlong
INT64_MAX = (1 << 63) - 1
MAX_ORDER, MAX_GROUP = 4, 4           # csrc/top_n_rank.cu

# K20. Replaces stream/retract_top_n.py:_flush_impl (118), its keys,
# run starts, ranks, selection and row hashes (121-150).
K_RANK = kernels.register(kernels.CudaKernel(
    "top_n_rank",
    replaces="risingwave_tpu/stream/retract_top_n.py:118",
    functions={
        "rw_topn_keys": [ctypes.c_int, _PP, _PI, _PI, _PP, ctypes.c_int,
                         _PP, _PI, _P, _L, _P, _P, _P],
        "rw_topn_rank": [_P, _P, _P, _L, ctypes.c_int, _PP, _PI, _L, _L,
                         _P, _P, _P]}))

# K21. Replaces stream/retract_top_n.py:_flush_impl's membership diff
# and output chunk (154-183).
K_DIFF = kernels.register(kernels.CudaKernel(
    "top_n_diff",
    replaces="risingwave_tpu/stream/retract_top_n.py:154",
    functions={"rw_topn_diff": [_L, _P, _P, _P, _P, _P, ctypes.c_int, _PP,
                                _PP, _PP, _PP, _PP, _PP, _PI, _P, _P, _P]}))


# ------------------------------------------------------------------ K20

def topn_keys_plain(store: SortedSideState, order_specs, group_idx):
    """Plain PyTorch version of kernel K20's keys entry: (order keys,
    most significant first, as int64; the group key)."""
    C = store.capacity
    dev = store.khash.device
    okeys = [order_key_plain(store.cols[c], d) for c, d in order_specs]
    live = torch.arange(C, device=dev) < store.n
    g = (key_hash([store.cols[i] for i in group_idx]) if group_idx
         else torch.zeros(C, dtype=torch.int64, device=dev))
    return okeys, torch.where(live, g, INT64_MAX)


def topn_keys(store: SortedSideState, order_specs, group_idx):
    """Kernel K20's keys entry on a CUDA device, the plain version on
    the CPU. On the card also returns the zeroed top-set count the rank
    entry adds to (None on the CPU)."""
    dev = store.khash.device
    if dev.type == "cpu":
        return (*topn_keys_plain(store, order_specs, group_idx), None)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not 1 <= len(order_specs) <= MAX_ORDER \
            or len(group_idx) > MAX_GROUP:
        raise ValueError(f"K20 takes 1..{MAX_ORDER} order keys and at most "
                         f"{MAX_GROUP} group keys")
    C = store.capacity
    ocols = [store.cols[c] for c, _ in order_specs]
    gcols = [store.cols[i] for i in group_idx]
    for c in ocols + gcols:
        if c.dtype not in TYPE_CODES or not c.is_contiguous():
            raise ValueError(f"K20 does not take {c.dtype} columns")
    okeys = [torch.empty(C, dtype=torch.int64, device=dev) for _ in ocols]
    gkey = torch.empty(C, dtype=torch.int64, device=dev)
    n_top = torch.empty((), dtype=torch.int32, device=dev)
    K_RANK.launches += 1
    K_RANK.call("rw_topn_keys", len(ocols), kernels.ptr_array(ocols),
                kernels.int_array(TYPE_CODES[c.dtype] for c in ocols),
                kernels.int_array(int(d) for _, d in order_specs),
                kernels.ptr_array(okeys), len(gcols),
                kernels.ptr_array(gcols),
                kernels.int_array(TYPE_CODES[c.dtype] for c in gcols),
                kernels.ptr(store.n), C, kernels.ptr(gkey),
                kernels.ptr(n_top), kernels.stream_of(gkey))
    return okeys, gkey, n_top


def topn_order(store: SortedSideState, okeys, gkey, plain: bool = False):
    """The flush's lexsort: slots by (group key, order keys, row-key
    hash), dead slots last. K11 passes on the card (`plain`: torch's
    argsorts on any device)."""
    keys = [store.khash] + list(reversed(okeys)) + [gkey]
    if plain or store.khash.device.type == "cpu":
        return lexsort_plain(keys)
    return stable_lexsort(keys, [HASH_BITS] + [64] * len(okeys)
                          + [HASH_BITS])


def topn_rank_plain(store: SortedSideState, order: torch.Tensor,
                    gkey: torch.Tensor, offset: int, limit: int):
    """Plain PyTorch version of kernel K20's rank entry: (topk int64 [C]
    — the full-row hash of each sorted slot in the top set, the sentinel
    elsewhere — and the count, int32)."""
    C = store.capacity
    dev = store.khash.device
    s_g = gkey[order]
    new_run = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                         s_g[1:] != s_g[:-1]])
    pos = torch.arange(C, device=dev)
    run_start = torch.cummax(torch.where(new_run, pos, 0), 0).values
    rank = pos - run_start
    s_live = order < store.n
    in_top = s_live & (rank >= offset) & (rank < offset + limit)
    rhash = key_hash([c[order] for c in store.cols])
    topk = torch.where(in_top, rhash, HSENTINEL)
    return topk, in_top.sum(dtype=torch.int32)


def topn_rank(store: SortedSideState, order: torch.Tensor,
              gkey: torch.Tensor, offset: int, limit: int,
              n_top: Optional[torch.Tensor] = None):
    """Kernel K20's rank entry on a CUDA device (adding into `n_top`,
    which the keys entry zeroed), the plain version on the CPU."""
    dev = store.khash.device
    if dev.type == "cpu":
        return topn_rank_plain(store, order, gkey, offset, limit)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    C = store.capacity
    if not 1 <= len(store.cols) <= MAX_COLS:
        raise ValueError(f"K20 hashes 1..{MAX_COLS} row columns")
    if n_top is None:
        n_top = torch.zeros((), dtype=torch.int32, device=dev)
    for t in (order, gkey):
        if t.dtype != torch.int64 or t.shape != (C,) \
                or not t.is_contiguous():
            raise ValueError("K20 takes contiguous int64 order and group "
                             "keys of the store's capacity")
    topk = torch.empty(C, dtype=torch.int64, device=dev)
    K_RANK.launches += 1
    K_RANK.call("rw_topn_rank", kernels.ptr(order), kernels.ptr(gkey),
                kernels.ptr(store.n), C, len(store.cols),
                kernels.ptr_array(store.cols),
                kernels.int_array(TYPE_CODES[c.dtype] for c in store.cols),
                offset, limit, kernels.ptr(topk), kernels.ptr(n_top),
                kernels.stream_of(topk))
    return topk, n_top


# ------------------------------------------------------------------ K21

def topn_diff_plain(store: SortedSideState, new_hash, src, n_top,
                    top_hash, top_cols, top_valids, top_n):
    """Plain PyTorch version of kernel K21: (out columns, out valids,
    ops, vis) of the 2C-row changelog — the old set's rows as Deletes,
    then the new set's (the store gathered through `src`) as Inserts,
    visible where a row left or joined the set."""
    C = store.capacity
    dev = store.khash.device
    ar = torch.arange(C, device=dev)

    def member(a_hash, a_n, b_hash):
        i = torch.searchsorted(b_hash, a_hash).clamp(0, C - 1)
        return (ar < a_n) & (b_hash[i] == a_hash)

    emit_del = (ar < top_n) & ~member(top_hash, top_n, new_hash)
    emit_ins = (ar < n_top) & ~member(new_hash, n_top, top_hash)
    out_cols = tuple(torch.cat([tc, c[src]])
                     for tc, c in zip(top_cols, store.cols))
    out_valids = tuple(torch.cat([tv, v[src]])
                       for tv, v in zip(top_valids, store.valids))
    ops = torch.cat([torch.full((C,), OP_DELETE, dtype=torch.int8,
                                device=dev),
                     torch.full((C,), OP_INSERT, dtype=torch.int8,
                                device=dev)])
    return out_cols, out_valids, ops, torch.cat([emit_del, emit_ins])


def topn_diff(store: SortedSideState, new_hash, src, n_top, top_hash,
              top_cols, top_valids, top_n):
    """Kernel K21 on a CUDA device, the plain version on the CPU. Same
    contract as `topn_diff_plain`; the outputs are fresh tensors."""
    dev = store.khash.device
    if dev.type == "cpu":
        return topn_diff_plain(store, new_hash, src, n_top, top_hash,
                               top_cols, top_valids, top_n)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    C = store.capacity
    K = len(store.cols)
    if not 1 <= K <= MAX_COLS or len(top_cols) != K:
        raise ValueError(f"K21 takes 1..{MAX_COLS} like columns")
    for t in (new_hash, src, top_hash, *top_cols, *top_valids,
              *store.cols, *store.valids):
        if t.shape != (C,) or not t.is_contiguous() or t.device != dev:
            raise ValueError("K21 takes contiguous tensors of the store's "
                             "capacity")
    out_cols = tuple(torch.empty(2 * C, dtype=c.dtype, device=dev)
                     for c in store.cols)
    out_valids = tuple(torch.empty(2 * C, dtype=torch.bool, device=dev)
                       for _ in store.cols)
    ops = torch.empty(2 * C, dtype=torch.int8, device=dev)
    vis = torch.empty(2 * C, dtype=torch.bool, device=dev)
    P = kernels.ptr_array
    K_DIFF.launches += 1
    K_DIFF.call("rw_topn_diff", C, kernels.ptr(top_hash),
                kernels.ptr(top_n), kernels.ptr(new_hash),
                kernels.ptr(n_top), kernels.ptr(src), K, P(store.cols),
                P(store.valids), P(top_cols), P(top_valids), P(out_cols),
                P(out_valids),
                kernels.int_array(c.element_size() for c in store.cols),
                kernels.ptr(ops), kernels.ptr(vis), kernels.stream_of(ops))
    return out_cols, out_valids, ops, vis


# ---------------------------------------------------------------- flush

def topn_flush(store: SortedSideState, order_specs, group_idx,
               offset: int, limit: int, top_hash, top_cols, top_valids,
               top_n):
    """The barrier flush: (new top hash, cols, valids, count; the output
    chunk's columns, valids, ops, vis). The new set's columns and valids
    are views of the output's second half."""
    C = store.capacity
    okeys, gkey, n_top = topn_keys(store, order_specs, group_idx)
    order = topn_order(store, okeys, gkey)
    topk, n_top = topn_rank(store, order, gkey, offset, limit, n_top)
    new_hash, src = stable_sort(topk, HASH_BITS, order)
    out_cols, out_valids, ops, vis = topn_diff(
        store, new_hash, src, n_top, top_hash, top_cols, top_valids, top_n)
    return (new_hash, tuple(c[C:] for c in out_cols),
            tuple(v[C:] for v in out_valids), n_top,
            out_cols, out_valids, ops, vis)


def topn_flush_plain(store: SortedSideState, order_specs, group_idx,
                     offset: int, limit: int, top_hash, top_cols,
                     top_valids, top_n):
    """`topn_flush` with every step's plain version (torch's sorts
    included), on any device: what a card run is held against."""
    C = store.capacity
    okeys, gkey = topn_keys_plain(store, order_specs, group_idx)
    order = topn_order(store, okeys, gkey, plain=True)
    topk, n_top = topn_rank_plain(store, order, gkey, offset, limit)
    new_hash, torder = torch.sort(topk, stable=True)
    src = order[torder]
    out_cols, out_valids, ops, vis = topn_diff_plain(
        store, new_hash, src, n_top, top_hash, top_cols, top_valids, top_n)
    return (new_hash, tuple(c[C:] for c in out_cols),
            tuple(v[C:] for v in out_valids), n_top,
            out_cols, out_valids, ops, vis)


# ------------------------------------------------------------- executor

class RetractableTopNExecutor(GrowableSortedStore, StatefulUnaryExecutor):
    """Output: the rows whose rank within their group (by the order
    specs) falls in [offset, offset+limit), maintained incrementally
    under inserts AND retractions."""

    def __init__(self, input: Executor,
                 group_key_indices: Sequence[int],
                 order_col=None, limit: int = 0, offset: int = 0,
                 descending: bool = False,
                 order_specs: Optional[Sequence[tuple]] = None,
                 capacity: int = 1 << 14,
                 state_table=None,
                 pk_indices: Optional[Sequence[int]] = None,
                 watchdog_interval: Optional[int] = 1,
                 device="cuda"):
        self.device = resolve_device(device)
        self.input = input
        self.schema = input.schema
        self.pk_indices = tuple(
            pk_indices if pk_indices is not None
            else (input.pk_indices or range(len(input.schema))))
        self.group_key_indices = tuple(group_key_indices)
        # order_specs: [(col, descending)] most significant first;
        # (order_col, descending) is the single-key shorthand
        if order_specs is None:
            if order_col is None:
                raise ValueError("a top-N needs an order column")
            order_specs = [(order_col, descending)]
        self.order_specs = tuple((int(c), bool(d)) for c, d in order_specs)
        self.limit = limit
        self.offset = offset
        self.capacity = capacity
        self.identity = (f"RetractTopN(g={self.group_key_indices}, "
                         f"by={self.order_specs}, k={limit})")
        self._col_dtypes = tuple(f.data_type.torch_dtype
                                 for f in input.schema)
        C = capacity
        dev = self.device
        # dense store sorted by row-key hash
        self.store = empty_sorted_side(C, self._col_dtypes, dev)
        # last emitted top set: its sorted full-row hashes and rows
        self.top_hash = torch.full((C,), HSENTINEL, dtype=torch.int64,
                                   device=dev)
        self.top_cols = tuple(torch.zeros(C, dtype=dt, device=dev)
                              for dt in self._col_dtypes)
        self.top_valids = tuple(torch.zeros(C, dtype=torch.bool, device=dev)
                                for _ in self._col_dtypes)
        self.top_n = torch.zeros((), dtype=torch.int32, device=dev)
        # K7's error layout [unused, delete miss, row overflow]
        self._errs_dev = torch.zeros(3, dtype=torch.int32, device=dev)
        # second store K7 writes into (CUDA only; made at first use)
        self._spare: Optional[SortedSideState] = None
        self._bufs = _Buffers(dev)
        # every input chunk of the epoch, written to the state table at
        # the barrier (the reference's TopN table holds all input rows)
        self._epoch_chunks: list[StreamChunk] = []
        self.persist_rows = 0           # rows the persists wrote
        self.persist_s = 0.0            # host seconds in persist
        self._init_stateful(state_table, watchdog_interval)

    def errs(self) -> list[int]:
        """[row overflow, delete miss] (one fetch), the JAX package's
        layout."""
        e = [int(x) for x in self._errs_dev.cpu()]
        return [e[2], e[1]]

    # ------------------------------------------------------------- apply
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

    def on_chunk(self, chunk: StreamChunk) -> None:
        self._apply(chunk)
        if self.state_table is not None:
            self._epoch_chunks.append(chunk)
        return None

    # ------------------------------------------------------------- flush
    def _flush(self):
        (self.top_hash, self.top_cols, self.top_valids, self.top_n,
         out_cols, out_valids, ops, vis) = topn_flush(
            self.store, self.order_specs, self.group_key_indices,
            self.offset, self.limit, self.top_hash, self.top_cols,
            self.top_valids, self.top_n)
        return out_cols, out_valids, ops, vis

    def flush(self) -> Optional[StreamChunk]:
        out_cols, out_valids, ops, vis = self._flush()
        return StreamChunk(tuple(Column(c, v) for c, v in
                                 zip(out_cols, out_valids)),
                           ops, vis, self.schema)

    # -------------------------------------------------------- durability
    def persist(self, barrier: Barrier, flushed) -> None:
        if self.state_table is None:
            return
        t0 = time.perf_counter()
        for c in self._epoch_chunks:
            vis = c.vis.cpu().numpy()
            if vis.any():
                self.persist_rows += int(vis.sum())
                self.state_table.write_chunk_columns(
                    c.ops.cpu().numpy(),
                    [col.data.cpu().numpy() for col in c.columns], vis)
        self._epoch_chunks = []
        self.state_table.commit(barrier.epoch.curr)
        self.persist_s += time.perf_counter() - t0

    def recover_state(self, epoch: int) -> None:
        rows = [r for _, r in self.state_table.iter_all()]
        if not rows:
            return
        self._presize_for(len(rows))
        cap = 1 << max(6, (len(rows) - 1).bit_length())
        dev = self.device
        for ofs in range(0, len(rows), cap):
            part = rows[ofs:ofs + cap]
            arrays, valids = rows_to_columns(self.schema, part)
            m = len(part)
            cols = []
            for a, v, dt in zip(arrays, valids, self._col_dtypes):
                data = torch.zeros(cap, dtype=dt, device=dev)
                data[:m] = torch.from_numpy(a).to(dev)
                valid = None
                if not v.all():
                    valid = torch.zeros(cap, dtype=torch.bool, device=dev)
                    valid[:m] = torch.from_numpy(v).to(dev)
                cols.append(Column(data, valid))
            vis = torch.arange(cap, device=dev) < m
            ops = torch.full((cap,), OP_INSERT, dtype=torch.int8,
                             device=dev)
            self._apply(StreamChunk(tuple(cols), ops, vis, self.schema))
        # seed the diff's baseline: the downstream MV holds exactly the
        # top set of this recovered (checkpoint-consistent) store, so
        # compute it once and discard the output; without this, rows that
        # left the top set across the rebuild would never get a Delete
        self._flush()

    # ---------------------------------------------------------- watchdog
    _SECONDARY = ("top_hash", "top_cols", "top_valids")

    def check_watchdog(self) -> None:
        vals = torch.cat([self._errs_dev,
                          self.store.n.view(1)]).cpu().tolist()
        if vals[2]:
            raise RuntimeError(
                f"retractable TopN overflow ({vals[2]} rows dropped; "
                f"capacity {self.capacity})")
        if vals[1]:
            raise RuntimeError(
                f"retractable TopN: {vals[1]} deletes matched no row")
        self._maybe_grow(vals[3])

    def fence_tokens(self) -> list:
        return [self.store.n, self.top_n] + super().fence_tokens()

    def map_watermark(self, wm: Watermark) -> Optional[Watermark]:
        return None          # ranks can change; no watermark survives

