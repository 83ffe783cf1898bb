"""EMIT ON WINDOW CLOSE over-window: append-only final rows (port of
risingwave_tpu/stream/eowc_over_window.py).

Rows wait in the general over-window's sorted store until the
partition's ORDER BY column passes the watermark; then their window
values are final (frames end at CURRENT ROW and later rows sort strictly
after the frontier), so each row emits exactly once, as an Insert, with
no retraction downstream.

At a barrier after the watermark moved, the flush recomputes the whole
store as the general flush does (K20's keys, K11's lexsort, kernel K23's
window scan), and K23 also writes the ripeness mask: rows whose order
value lies in (emitted frontier, watermark] are the output's visible
Inserts. No diff and no kernel of its own. The frontier is durable (a
one-row state table), so recovery neither re-emits nor drops.

Scope as the reference's: `lead` is refused (a row's lead needs rows
that an unbounded stream cannot finalize), the leading ORDER BY column
must be ascending, and the store keeps full history (unbounded frames
need every predecessor).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..common.chunk import Column, StreamChunk, OP_INSERT
from .executor import Executor
from .general_over_window import (
    GeneralOverWindowExecutor, WindowSpec, window_keys, window_order,
    window_scan,
)
from .message import Barrier, Watermark
from .sorted_join import NO_WATERMARK


def eowc_flush(store, partition_by, order_specs, windows, eowc_col: int,
               lo: int, hi: int):
    """(out columns, out valids, ops, vis) of the EOWC flush: every
    sorted row with its window values, visible where it ripened."""
    okeys, gkey = window_keys(store, order_specs, partition_by)
    order = window_order(store, okeys, gkey)
    full_cols, full_valids, ripe = window_scan(
        store, order, gkey, order_specs, windows, ripe=(eowc_col, lo, hi))
    ops = torch.full((store.capacity,), OP_INSERT, dtype=torch.int8,
                     device=store.khash.device)
    return full_cols, full_valids, ops, ripe


class EowcOverWindowExecutor(GeneralOverWindowExecutor):
    def __init__(self, input: Executor,
                 partition_by: Sequence[int],
                 order_specs: Sequence[tuple],
                 windows: Sequence[WindowSpec],
                 capacity: int = 1 << 14,
                 state_table=None,
                 frontier_table=None,
                 pk_indices: Optional[Sequence[int]] = None,
                 watchdog_interval: Optional[int] = 1,
                 device="cuda"):
        if any(w.kind == "lead" for w in windows):
            raise ValueError("EMIT ON WINDOW CLOSE cannot finalize lead()")
        if not order_specs or order_specs[0][1]:
            raise ValueError("EOWC needs the watermarked ORDER BY column "
                             "ascending")
        super().__init__(input, partition_by, order_specs, windows,
                         capacity=capacity, state_table=state_table,
                         pk_indices=pk_indices,
                         watchdog_interval=watchdog_interval, device=device)
        self.identity = "Eowc" + self.identity
        self.eowc_col = order_specs[0][0]
        self.frontier_table = frontier_table
        self._wm_pending = NO_WATERMARK
        self._emitted_to = NO_WATERMARK

    # ------------------------------------------------------------- flush
    def flush(self) -> Optional[StreamChunk]:
        if self._wm_pending <= self._emitted_to:
            return None
        cols, valids, ops, vis = eowc_flush(
            self.store, self.partition_by, self.order_specs, self.windows,
            self.eowc_col, self._emitted_to, self._wm_pending)
        self._emitted_to = self._wm_pending
        return StreamChunk(tuple(Column(c, v) for c, v in zip(cols, valids)),
                           ops, vis, self.schema)

    # ----------------------------------------------------------- durable
    def persist(self, barrier: Barrier, flushed) -> None:
        super().persist(barrier, flushed)
        if self.frontier_table is not None:
            self.frontier_table.write_chunk_rows(
                [(int(OP_INSERT), (0, int(self._emitted_to)))])
            self.frontier_table.commit(barrier.epoch.curr)

    def recover_state(self, epoch: int) -> None:
        if self.frontier_table is not None:
            self.frontier_table.init_epoch(epoch)
            row = self.frontier_table.get_row((0,))
            if row is not None:
                self._emitted_to = int(row[1])
                self._wm_pending = max(self._wm_pending, self._emitted_to)
        # the input rows only: the EOWC output has no diff baseline
        self._replay_stored_rows()

    # --------------------------------------------------------- watermark
    def map_watermark(self, wm: Watermark):
        if wm.col_idx == self.eowc_col:
            if wm.val > self._wm_pending:
                self._wm_pending = wm.val
                # a watermark alone ripens buffered rows: force the
                # barrier flush even with no data this epoch
                self._applied_since_flush = True
            # the order column keeps its output position; emitted rows
            # never precede the forwarded frontier
            return Watermark(wm.col_idx, wm.data_type, wm.val)
        return None
