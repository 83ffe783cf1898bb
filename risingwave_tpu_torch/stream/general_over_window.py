"""General (retraction-capable) over-window: window functions over a
changing input (port of risingwave_tpu/stream/general_over_window.py).

The full input lives in the dense sorted store of stream/sorted_store.py,
keyed by a hash of the stream key (retractions address rows by it); a
chunk's apply is K11 passes, kernel K19 and kernel K7. At each barrier
the flush recomputes every window function over the whole store and
diffs the result against the last emitted rows:

  1. keys: kernel K20's first entry (`csrc/top_n_rank.cu`) maps each
     ORDER BY column to an int64 that sorts as the reference's does and
     makes the partition key (the PARTITION BY columns' hash for live
     slots, int64 max for dead ones);
  2. lexsorts the slots by (partition key, order keys): K11 passes over
     the whole capacity. The reference's least significant key, the
     store position, needs no pass: the sorts are stable and start from
     the store's order;
  3. window scan: kernel K23 (`csrc/window_scan.cu`) gathers the input
     columns into that order and computes every window function with
     segmented scans and binary searches over the partition runs;
  4. diff: kernel K24 (`csrc/window_diff.cu`) hashes every computed row,
     K11 sorts the hashes, K24 tests membership in the last emitted set
     and back (first candidate of equal hash, every lane compared) and
     writes the 2C-row changelog: Deletes of rows whose outputs changed
     or that left, then Inserts of the rows that are new.

Window functions (WindowSpec.kind): row_number, rank, dense_rank; sum,
count, avg over UNBOUNDED PRECEDING .. CURRENT ROW or `ROWS BETWEEN n
PRECEDING AND CURRENT ROW`; lag, lead (an offset >= 1) and first_value.
All evaluate in ROW order, ties broken by store position.

Sums: K23 and its plain version take prefix sums that restart at each
partition start, where the reference subtracts global prefix sums. For
integer-valued arguments the two are equal; for other finite float
arguments they differ by rounding (the tests state the tolerance). A
NaN or an inf argument stays in its own partition here, where the
reference's global sums turn every later partition's sums and avgs to
NaN (ROADMAP Queue C).

Durable state (`state_table`, over the input schema and stream key):
every input chunk of an epoch is written at the barrier; recovery
re-applies the stored rows and runs one flush whose output is dropped,
to seed the diff's baseline with the rows the MV already holds.

Left out of this slice: the memory manager's accounting (`state_bytes`)
and the sharded variant (ROADMAP Queue A step 9); float32 columns (the
kernels' column tables take integers, bools and float64).
"""

from __future__ import annotations

import ctypes
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from ..common.chunk import Column, StreamChunk, OP_DELETE, OP_INSERT
from ..common.types import DataType, Field, Schema
from ..device import resolve_device
from ..expr.program import TYPE_CODES
from ..ops import kernels
from ..ops.sort import lexsort_plain, stable_lexsort, stable_sort
from ..state.storage_table import rows_to_chunk
from ..utils.d2h import as_i64_lanes
from .executor import Executor, StatefulUnaryExecutor
from .message import Barrier, Watermark
from .retract_top_n import topn_keys, topn_keys_plain
from .sorted_join import (
    HASH_BITS, HSENTINEL, SortedSideState, _Buffers, empty_sorted_side,
    key_hash,
)
from .sorted_store import (GrowableSortedStore, segment_starts,
                           sorted_store_apply)

_P = ctypes.c_void_p
_PP = ctypes.POINTER(_P)
_PI = ctypes.POINTER(ctypes.c_int)
_PL = ctypes.POINTER(ctypes.c_longlong)
_L = ctypes.c_longlong
_I = ctypes.c_int

WINDOW_KINDS = ("row_number", "rank", "dense_rank", "sum", "count", "avg",
                "lag", "lead", "first_value")
_KIND_CODES = {k: i for i, k in enumerate(WINDOW_KINDS)}
MAX_COLS, MAX_WINDOWS, MAX_ORDER = 16, 8, 4      # csrc/window_scan.cu
MAX_ROW_COLS = 24                                # csrc/window_diff.cu
_TIES, _VALUE, _COUNT = 0, 1, 2                  # scan lane kinds

# K23. Replaces stream/general_over_window.py:_compute_windows (144)
# after its lexsort (162-248) and eowc_over_window.py:_flush_eowc_impl's
# ripeness mask (67-79).
K_SCAN = kernels.register(kernels.CudaKernel(
    "window_scan",
    replaces="risingwave_tpu/stream/general_over_window.py:144",
    functions={
        "rw_window_scan": [
            _P, _P, _P, _L, _I, _PP, _PP, _PI, _PI, _PP, _PP, _I, _PI, _I,
            _PI, _PI, _PL, _PL, _PI, _PI, _PP, _PP, _I, _PI, _PI, _PI, _PI,
            _P, _P, _P, _P, _P, _I, _L, _L, _P, _P],
        "rw_window_scan_blocks": [_L]}))

# K24. Replaces stream/general_over_window.py:_flush_impl (250), its
# row hashes, `member` and the 2C-row output chunk (264-320).
K_DIFF = kernels.register(kernels.CudaKernel(
    "window_diff",
    replaces="risingwave_tpu/stream/general_over_window.py:250",
    functions={
        "rw_window_hash": [_L, _P, _P, _I, _PP, _PP, _PI, _PI, _P, _P],
        "rw_window_diff": [_L, _P, _P, _P, _P, _P, _I, _PP, _PP, _PP, _PP,
                           _PP, _PP, _PI, _PI, _P, _P, _P]}))


@dataclass(frozen=True)
class WindowSpec:
    """One window function call (reference: WindowFuncCall)."""

    kind: str         # row_number|rank|dense_rank|sum|count|avg|
    #                     lag|lead|first_value
    arg: Optional[int] = None       # input column (None for rank family)
    preceding: Optional[int] = None  # None = UNBOUNDED PRECEDING
    name: str = ""
    offset: int = 1                 # lag/lead row offset

    def ret_type(self, in_schema: Schema) -> DataType:
        if self.kind in ("row_number", "rank", "dense_rank", "count"):
            return DataType.INT64
        if self.kind == "avg":
            return DataType.FLOAT64
        if self.kind in ("lag", "lead", "first_value"):
            # row values pass through unchanged (no promotion)
            return in_schema[self.arg].data_type
        # sum promotes: a narrow-int running sum would wrap when cast back
        if in_schema[self.arg].data_type.is_float:
            return DataType.FLOAT64
        return DataType.INT64


def check_windows(windows: Sequence[WindowSpec]) -> None:
    for w in windows:
        if w.kind not in WINDOW_KINDS:
            raise ValueError(f"unknown window function {w.kind!r}")
        if w.preceding is not None and w.kind not in ("sum", "count", "avg"):
            raise ValueError("bounded frames support sum/count/avg")
        if w.kind in ("lag", "lead") and w.offset < 1:
            raise ValueError("lag/lead offset must be >= 1")


def _ret_dtype(w: WindowSpec, col_dtypes) -> torch.dtype:
    if w.kind in ("row_number", "rank", "dense_rank", "count"):
        return torch.int64
    if w.kind in ("lag", "lead", "first_value"):
        return col_dtypes[w.arg]
    if w.kind == "avg" or col_dtypes[w.arg].is_floating_point:
        return torch.float64
    return torch.int64


# ------------------------------------------------------------ keys, sort

def window_keys(store: SortedSideState, order_specs, partition_by):
    """(order keys most significant first, the partition key): K20's
    first entry on a CUDA device, its plain version on the CPU."""
    okeys, gkey, _ = topn_keys(store, order_specs, partition_by)
    return okeys, gkey


def window_order(store: SortedSideState, okeys, gkey,
                 plain: bool = False) -> torch.Tensor:
    """The flush's lexsort: slots by (partition key, order keys), dead
    slots last, ties in store order. K11 passes on the card (`plain`:
    torch's argsorts on any device)."""
    keys = list(reversed(okeys)) + [gkey]
    if plain or store.khash.device.type == "cpu":
        return lexsort_plain(keys)
    return stable_lexsort(keys, [64] * len(okeys) + [HASH_BITS])


# ------------------------------------------------------------------ K23

def _segmented_cumsum(x: torch.Tensor, run_start: torch.Tensor):
    """Inclusive prefix sums that restart at each run start, by doubling
    steps that add only within the run: no value reaches another run (a
    NaN or an inf stays in its partition), and the result is the same
    from run to run."""
    C = x.shape[0]
    pos = torch.arange(C, device=x.device)
    d = 1
    while d < C:
        prev = torch.cat([torch.zeros(d, dtype=x.dtype, device=x.device),
                          x[:-d]])
        x = torch.where(pos - d >= run_start, prev + x, x)
        d *= 2
    return x


def window_scan_plain(store: SortedSideState, order: torch.Tensor,
                      gkey: torch.Tensor, order_specs,
                      windows: Sequence[WindowSpec], ripe=None):
    """Plain PyTorch version of kernel K23: (full columns, full valids,
    ripe mask or None) in the sorted order —
    the input columns gathered, then one column a window function.
    `ripe` = (order column, lo, hi) asks for the EOWC mask live & lo <
    value <= hi."""
    C = store.capacity
    dev = store.khash.device
    cols, valids = store.cols, store.valids
    live = torch.arange(C, device=dev) < store.n
    s_live = live[order]
    s_g = gkey[order]
    new_run, run_start = segment_starts(s_g)
    pos = torch.arange(C, device=dev)
    tie_new = new_run.clone()
    for c, _ in order_specs:
        sv = cols[c][order]
        if sv.is_floating_point():
            # the reference's CPU compares subnormals as zero
            sv = torch.where(sv.abs() < 2.2250738585072014e-308, 0.0, sv)
        tie_new |= torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                              sv[1:] != sv[:-1]])
    tie_start = torch.cummax(torch.where(tie_new, pos, 0), 0).values
    _, rev_start = segment_starts(s_g.flip(0))
    run_end = (C - 1) - rev_start.flip(0)
    idx_in_part = pos - run_start
    col_dtypes = [c.dtype for c in cols]
    outs, out_valids = [], []
    for w in windows:
        if w.kind == "row_number":
            outs.append(idx_in_part + 1)
            out_valids.append(s_live)
            continue
        if w.kind == "rank":
            outs.append(tie_start - run_start + 1)
            out_valids.append(s_live)
            continue
        if w.kind == "dense_rank":
            dcs = torch.cumsum(tie_new.to(torch.int64), 0)
            outs.append(dcs - dcs[run_start] + 1)
            out_valids.append(s_live)
            continue
        if w.kind in ("lag", "lead", "first_value"):
            raw = cols[w.arg][order]
            rawv = valids[w.arg][order]
            if w.kind == "first_value":
                src = run_start
                in_part = torch.ones(C, dtype=torch.bool, device=dev)
            elif w.kind == "lag":
                src = pos - w.offset
                in_part = src >= run_start
            else:
                src = pos + w.offset
                in_part = src <= run_end
            srcc = src.clamp(0, C - 1)
            outs.append(raw[srcc])
            out_valids.append(s_live & in_part & rawv[srcc])
            continue
        av = cols[w.arg][order]
        avalid = valids[w.arg][order] & s_live
        if w.kind == "count":
            x = avalid.to(torch.int64)
        elif av.is_floating_point() or w.kind == "avg":
            x = torch.where(avalid, av.to(torch.float64), 0.0)
        else:
            x = torch.where(avalid, av.to(torch.int64), 0)
        seg = _segmented_cumsum(x, run_start)
        lo = pos - ((w.preceding if w.preceding is not None else 0) + 1)
        in_frame = lo >= run_start
        lo_c = lo.clamp(0, C - 1)
        if w.preceding is not None:
            seg = seg - torch.where(in_frame, seg[lo_c],
                                    torch.zeros((), dtype=seg.dtype,
                                                device=dev))
        if w.kind in ("avg", "sum"):
            cseg = _segmented_cumsum(avalid.to(torch.int64), run_start)
            if w.preceding is not None:
                cseg = cseg - torch.where(in_frame, cseg[lo_c], 0)
            outs.append(seg / cseg.clamp(min=1) if w.kind == "avg" else seg)
            out_valids.append(s_live & (cseg > 0))
        else:
            outs.append(seg)
            out_valids.append(s_live)
    full_cols = [c[order] for c in cols] + [
        o.to(_ret_dtype(w, col_dtypes)) for o, w in zip(outs, windows)]
    full_valids = [v[order] for v in valids] + list(out_valids)
    ripe_mask = None
    if ripe is not None:
        rc, lo_v, hi_v = ripe
        oval = cols[rc][order]
        ripe_mask = s_live & (oval > lo_v) & (oval <= hi_v)
    return full_cols, full_valids, ripe_mask


def _scan_lanes(windows: Sequence[WindowSpec], col_dtypes):
    """Scan lanes of kernel K23: lane 0 the tie starts; a value lane and
    a valid-count lane for each sum/avg, a count lane for each count.
    Returns (lanes [(is_f64, segmented, what, arg)], value lane and
    count lane of each window, -1 for none)."""
    lanes = [(0, 0, _TIES, 0)]
    vl, cl = [], []
    for w in windows:
        if w.kind in ("sum", "avg"):
            f64 = int(col_dtypes[w.arg].is_floating_point or w.kind == "avg")
            lanes.append((f64, 1, _VALUE, w.arg))
            vl.append(len(lanes) - 1)
            lanes.append((0, 1, _COUNT, w.arg))
            cl.append(len(lanes) - 1)
        elif w.kind == "count":
            lanes.append((0, 1, _COUNT, w.arg))
            vl.append(len(lanes) - 1)
            cl.append(-1)
        else:
            vl.append(-1)
            cl.append(-1)
    return lanes, vl, cl


def window_scan(store: SortedSideState, order: torch.Tensor,
                gkey: torch.Tensor, order_specs,
                windows: Sequence[WindowSpec], ripe=None):
    """Kernel K23 on a CUDA device, the plain version on the CPU. Same
    contract as `window_scan_plain`; the outputs are fresh tensors."""
    dev = store.khash.device
    if dev.type == "cpu":
        return window_scan_plain(store, order, gkey, order_specs, windows,
                                 ripe)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    C = store.capacity
    cols, valids = store.cols, store.valids
    if not 1 <= len(cols) <= MAX_COLS or len(windows) > MAX_WINDOWS \
            or not 1 <= len(order_specs) <= MAX_ORDER:
        raise ValueError(f"K23 takes 1..{MAX_COLS} columns, at most "
                         f"{MAX_WINDOWS} windows and 1..{MAX_ORDER} order "
                         "keys")
    for t in (*cols, *valids):
        if t.shape != (C,) or not t.is_contiguous() or t.device != dev:
            raise ValueError("K23 takes contiguous store columns")
        if t.dtype not in TYPE_CODES:
            raise ValueError(f"K23 does not take {t.dtype} columns")
    for t in (order, gkey):
        if t.dtype != torch.int64 or t.shape != (C,) \
                or not t.is_contiguous():
            raise ValueError("K23 takes contiguous int64 order and "
                             "partition keys of the store's capacity")
    col_dtypes = [c.dtype for c in cols]
    lanes, vl, cl = _scan_lanes(windows, col_dtypes)
    i64 = dict(dtype=torch.int64, device=dev)
    s_cols = [torch.empty(C, dtype=c.dtype, device=dev) for c in cols]
    s_valids = [torch.empty(C, dtype=torch.bool, device=dev) for _ in cols]
    w_cols = [torch.empty(C, dtype=_ret_dtype(w, col_dtypes), device=dev)
              for w in windows]
    w_valids = [torch.empty(C, dtype=torch.bool, device=dev)
                for _ in windows]
    L = len(lanes)
    nb = K_SCAN.lib().rw_window_scan_blocks(C)
    s_gkey = torch.empty(C, **i64)
    local = torch.empty(L * C, **i64)
    agg_v = torch.empty(L * nb, **i64)
    agg_f = torch.empty(L * nb, dtype=torch.uint8, device=dev)
    carry = torch.empty(L * nb, **i64)
    ripe_mask, ripe_col, lo, hi = None, -1, 0, 0
    if ripe is not None:
        ripe_col, lo, hi = ripe
        if cols[ripe_col].is_floating_point() \
                or cols[ripe_col].dtype == torch.bool:
            raise ValueError("K23's ripeness takes an integer column")
        ripe_mask = torch.empty(C, dtype=torch.bool, device=dev)
    P, IA = kernels.ptr_array, kernels.int_array
    LA = lambda vals: (ctypes.c_longlong * max(1, len(vals)))(*vals)
    K_SCAN.launches += 1
    K_SCAN.call(
        "rw_window_scan", kernels.ptr(order), kernels.ptr(gkey),
        kernels.ptr(store.n), C, len(cols), P(cols), P(valids),
        IA(TYPE_CODES[c.dtype] for c in cols),
        IA(c.element_size() for c in cols), P(s_cols), P(s_valids),
        len(order_specs), IA(c for c, _ in order_specs), len(windows),
        IA(_KIND_CODES[w.kind] for w in windows),
        IA(-1 if w.arg is None else w.arg for w in windows),
        LA([-1 if w.preceding is None else w.preceding for w in windows]),
        LA([w.offset for w in windows]), IA(vl), IA(cl), P(w_cols),
        P(w_valids), L, IA(x[0] for x in lanes), IA(x[1] for x in lanes),
        IA(x[2] for x in lanes), IA(x[3] for x in lanes),
        kernels.ptr(s_gkey), kernels.ptr(local), kernels.ptr(agg_v),
        kernels.ptr(agg_f), kernels.ptr(carry), ripe_col, lo, hi,
        kernels.ptr_or_null(ripe_mask), kernels.stream_of(order))
    return s_cols + w_cols, s_valids + w_valids, ripe_mask


# ------------------------------------------------------------------ K24

def _row_lanes(cols, valids) -> list[torch.Tensor]:
    """Two lanes a column: the value (floats by their float64 bits, 0
    where NULL) and the valid bit."""
    out = []
    for c, v in zip(cols, valids):
        out.append(torch.where(v, as_i64_lanes(c), 0))
        out.append(v.to(torch.int64))
    return out


def window_hash_plain(full_cols, full_valids, order: torch.Tensor,
                      n: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K24's hash entry: each sorted row's full
    hash, the sentinel for dead rows."""
    live = order < n
    return torch.where(live, key_hash(_row_lanes(full_cols, full_valids)),
                       HSENTINEL)


def window_hash(full_cols, full_valids, order: torch.Tensor,
                n: torch.Tensor) -> torch.Tensor:
    """K24's hash entry on a CUDA device, the plain version on the CPU."""
    dev = order.device
    if dev.type == "cpu":
        return window_hash_plain(full_cols, full_valids, order, n)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    C = order.shape[0]
    _check_rows(full_cols, full_valids, C)
    rhash = torch.empty(C, dtype=torch.int64, device=dev)
    K_DIFF.launches += 1
    K_DIFF.call("rw_window_hash", C, kernels.ptr(order), kernels.ptr(n),
                len(full_cols), kernels.ptr_array(full_cols),
                kernels.ptr_array(full_valids),
                kernels.int_array(TYPE_CODES[c.dtype] for c in full_cols),
                kernels.int_array(c.element_size() for c in full_cols),
                kernels.ptr(rhash), kernels.stream_of(rhash))
    return rhash


def _check_rows(cols, valids, C: int, extra=()) -> None:
    if not 1 <= len(cols) <= MAX_ROW_COLS:
        raise ValueError(f"K24 takes 1..{MAX_ROW_COLS} columns")
    for t in (*cols, *valids, *extra):
        if t.shape != (C,) or not t.is_contiguous():
            raise ValueError("K24 takes contiguous columns of one length")
    for c in cols:
        if c.dtype not in TYPE_CODES:
            raise ValueError(f"K24 does not take {c.dtype} columns")


def window_diff_plain(full_cols, full_valids, new_hash, rorder, n_new,
                      em_hash, em_cols, em_valids, em_n):
    """Plain PyTorch version of K24's diff entry: (out columns, out
    valids, ops, vis) of the 2C-row changelog — the last emitted rows as
    Deletes, then the new rows (the computed rows through rorder) as
    Inserts, visible where a row left or is new."""
    C = new_hash.shape[0]
    dev = new_hash.device
    ar = torch.arange(C, device=dev)
    new_cols = [c[rorder] for c in full_cols]
    new_valids = [v[rorder] for v in full_valids]
    new_lanes = _row_lanes(new_cols, new_valids)
    em_lanes = _row_lanes(em_cols, em_valids)

    def member(a_hash, a_n, a_lanes, b_hash, b_lanes):
        i = torch.searchsorted(b_hash, a_hash).clamp(0, C - 1)
        same = b_hash[i] == a_hash
        for la, lb in zip(a_lanes, b_lanes):
            same = same & (lb[i] == la)
        return (ar < a_n) & same

    emit_del = (ar < em_n) & ~member(em_hash, em_n, em_lanes, new_hash,
                                     new_lanes)
    emit_ins = (ar < n_new) & ~member(new_hash, n_new, new_lanes, em_hash,
                                      em_lanes)
    out_cols = tuple(torch.cat([e, c]) for e, c in zip(em_cols, new_cols))
    out_valids = tuple(torch.cat([e, v])
                       for e, v in zip(em_valids, new_valids))
    ops = torch.cat([torch.full((C,), OP_DELETE, dtype=torch.int8,
                                device=dev),
                     torch.full((C,), OP_INSERT, dtype=torch.int8,
                                device=dev)])
    return out_cols, out_valids, ops, torch.cat([emit_del, emit_ins])


def window_diff(full_cols, full_valids, new_hash, rorder, n_new, em_hash,
                em_cols, em_valids, em_n):
    """K24's diff entry on a CUDA device, the plain version on the CPU.
    Same contract as `window_diff_plain`; the outputs are fresh."""
    dev = new_hash.device
    if dev.type == "cpu":
        return window_diff_plain(full_cols, full_valids, new_hash, rorder,
                                 n_new, em_hash, em_cols, em_valids, em_n)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    C = new_hash.shape[0]
    K = len(full_cols)
    if len(em_cols) != K or len(em_valids) != K or len(full_valids) != K:
        raise ValueError("K24 diffs like row sets")
    _check_rows(full_cols, full_valids, C,
                (*em_cols, *em_valids, new_hash, rorder, em_hash))
    for a, b in zip(full_cols, em_cols):
        if a.dtype != b.dtype:
            raise ValueError("K24 diffs like row sets")
    out_cols = tuple(torch.empty(2 * C, dtype=c.dtype, device=dev)
                     for c in full_cols)
    out_valids = tuple(torch.empty(2 * C, dtype=torch.bool, device=dev)
                       for _ in full_cols)
    ops = torch.empty(2 * C, dtype=torch.int8, device=dev)
    vis = torch.empty(2 * C, dtype=torch.bool, device=dev)
    P = kernels.ptr_array
    K_DIFF.launches += 1
    K_DIFF.call("rw_window_diff", C, kernels.ptr(em_hash),
                kernels.ptr(em_n), kernels.ptr(new_hash),
                kernels.ptr(n_new), kernels.ptr(rorder), K, P(full_cols),
                P(full_valids), P(em_cols), P(em_valids), P(out_cols),
                P(out_valids),
                kernels.int_array(TYPE_CODES[c.dtype] for c in full_cols),
                kernels.int_array(c.element_size() for c in full_cols),
                kernels.ptr(ops), kernels.ptr(vis), kernels.stream_of(ops))
    return out_cols, out_valids, ops, vis


# ---------------------------------------------------------------- flush

def over_window_flush(store: SortedSideState, partition_by, order_specs,
                      windows, em_hash, em_cols, em_valids, em_n,
                      plain: bool = False):
    """The barrier flush: (new emitted hash, cols, valids, count; the
    output chunk's columns, valids, ops, vis). The new set's columns and
    valids are views of the output's second half. `plain`: every step's
    plain version (torch's sorts included), what a card run is held
    against."""
    C = store.capacity
    if plain:
        okeys, gkey = topn_keys_plain(store, order_specs, partition_by)
        order = window_order(store, okeys, gkey, plain=True)
        full_cols, full_valids, _ = window_scan_plain(
            store, order, gkey, order_specs, windows)
        rhash = window_hash_plain(full_cols, full_valids, order, store.n)
        new_hash, rorder = torch.sort(rhash, stable=True)
        diff = window_diff_plain
    else:
        okeys, gkey = window_keys(store, order_specs, partition_by)
        order = window_order(store, okeys, gkey)
        full_cols, full_valids, _ = window_scan(
            store, order, gkey, order_specs, windows)
        rhash = window_hash(full_cols, full_valids, order, store.n)
        new_hash, rorder = stable_sort(rhash, HASH_BITS)
        diff = window_diff
    n_new = store.n.clone()
    out_cols, out_valids, ops, vis = diff(
        full_cols, full_valids, new_hash, rorder, n_new, em_hash, em_cols,
        em_valids, em_n)
    return (new_hash, tuple(c[C:] for c in out_cols),
            tuple(v[C:] for v in out_valids), n_new,
            out_cols, out_valids, ops, vis)


# ------------------------------------------------------------- executor

class GeneralOverWindowExecutor(GrowableSortedStore, StatefulUnaryExecutor):
    """Output: the input columns ++ one column a window function, kept
    up to date under inserts AND retractions (each changed row as a
    Delete of its old values and an Insert of its new ones)."""

    def __init__(self, input: Executor,
                 partition_by: Sequence[int],
                 order_specs: Sequence[tuple],     # [(col, desc)]
                 windows: Sequence[WindowSpec],
                 capacity: int = 1 << 14,
                 state_table=None,
                 pk_indices: Optional[Sequence[int]] = None,
                 watchdog_interval: Optional[int] = 1,
                 device="cuda"):
        self.device = resolve_device(device)
        self.input = input
        in_schema = input.schema
        self.partition_by = tuple(partition_by)
        self.order_specs = tuple((int(c), bool(d)) for c, d in order_specs)
        self.windows = tuple(windows)
        check_windows(self.windows)
        self.schema = Schema(tuple(in_schema) + tuple(
            Field(w.name or f"w{j}", w.ret_type(in_schema))
            for j, w in enumerate(self.windows)))
        self.in_width = len(in_schema)
        self.pk_indices = tuple(
            pk_indices if pk_indices is not None
            else (input.pk_indices or range(len(in_schema))))
        self.capacity = capacity
        self.identity = (f"GeneralOverWindow(p={self.partition_by}, "
                         f"o={self.order_specs}, "
                         f"f={[w.kind for w in self.windows]})")
        self._col_dtypes = tuple(f.data_type.torch_dtype for f in in_schema)
        out_dtypes = tuple(f.data_type.torch_dtype for f in self.schema)
        C = capacity
        dev = self.device
        self.store = empty_sorted_side(C, self._col_dtypes, dev)
        # previously emitted (input ++ outputs) set for the barrier diff
        self.em_hash = torch.full((C,), HSENTINEL, dtype=torch.int64,
                                  device=dev)
        self.em_cols = tuple(torch.zeros(C, dtype=dt, device=dev)
                             for dt in out_dtypes)
        self.em_valids = tuple(torch.zeros(C, dtype=torch.bool, device=dev)
                               for _ in out_dtypes)
        self.em_n = torch.zeros((), dtype=torch.int32, device=dev)
        # K7's error layout [unused, delete miss, row overflow]
        self._errs_dev = torch.zeros(3, dtype=torch.int32, device=dev)
        self._spare: Optional[SortedSideState] = None
        self._bufs = _Buffers(dev)
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
        (self.em_hash, self.em_cols, self.em_valids, self.em_n,
         out_cols, out_valids, ops, vis) = over_window_flush(
            self.store, self.partition_by, self.order_specs, self.windows,
            self.em_hash, self.em_cols, self.em_valids, self.em_n)
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

    def _replay_stored_rows(self) -> bool:
        """Re-apply the state table's rows; False when it holds none."""
        rows = [r for _, r in self.state_table.iter_all()]
        if not rows:
            return False
        self._presize_for(len(rows))
        in_schema = Schema(tuple(self.schema)[:self.in_width])
        cap = 1 << max(6, (len(rows) - 1).bit_length())
        for ofs in range(0, len(rows), cap):
            self._apply(rows_to_chunk(in_schema, rows[ofs:ofs + cap], cap,
                                      self.device))
        return True

    def recover_state(self, epoch: int) -> None:
        if self._replay_stored_rows():
            # seed the diff's baseline: the downstream MV holds exactly
            # the outputs of this recovered store
            self._flush()

    # ---------------------------------------------------------- watchdog
    _SECONDARY = ("em_hash", "em_cols", "em_valids")

    def check_watchdog(self) -> None:
        vals = torch.cat([self._errs_dev,
                          self.store.n.view(1)]).cpu().tolist()
        if vals[2]:
            raise RuntimeError(
                f"over-window store overflow ({vals[2]} rows dropped; "
                f"capacity {self.capacity})")
        if vals[1]:
            raise RuntimeError(
                f"over-window: {vals[1]} deletes matched no row")
        self._maybe_grow(vals[3])

    def fence_tokens(self) -> list:
        return [self.store.n, self.em_n] + super().fence_tokens()

    def map_watermark(self, wm: Watermark) -> Optional[Watermark]:
        return None      # any row's outputs can change retroactively
