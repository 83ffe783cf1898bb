"""Dense sorted row store — the state layout of retraction-capable
executors that hold their FULL input (port of
risingwave_tpu/stream/sorted_store.py; the retractable top-N uses it).

Rows live in a dense prefix [0, n) of fixed-capacity tensors sorted by a
63-bit hash of the STREAM KEY (retractions address rows by it). The store
is a `SortedSideState` (the sorted join's side layout; its degree column
stays 0), so one chunk's apply is the sorted join's own-side update:

  netting   the sorted join's `net_pk_runs`: rows grouped by pk (a
            stable lexsort, K11 passes), then kernel K19
            (`csrc/pk_net.cu`): the pk hash of every row, the run flags
            (the first delete and the last insert of each pk run
            survive) and the insert hashes;
  sort      the insert hashes (K11);
  merge     kernel K7 (`csrc/sorted_join_merge.cu`): delete victims by
            exact (hash, pk) match, the lowest position winning, and the
            stable merge-insert (state rows before new rows of equal
            hash) into the second store, which is then swapped in.

Errors accumulate on the device in K7's layout [unused, delete miss,
row overflow].

Left out of this slice: `state_bytes` (the memory manager's accounting
is not ported) and stream keys with float columns (they raise: the
netting sort would need an order-keeping map of floats).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..common.chunk import StreamChunk
from ..ops.sort import stable_sort
from .sorted_join import (
    HASH_BITS, MAX_KEYS, NO_WATERMARK, SortedSideState, _Buffers,
    grow_sorted_arrays, merge, merge_plain, net_pk_runs, net_pk_runs_plain,
)


def _check_pk(chunk: StreamChunk, pk_idx: Sequence[int]) -> None:
    if not 1 <= len(pk_idx) <= MAX_KEYS:
        raise NotImplementedError(
            f"the sorted store takes 1..{MAX_KEYS} stream-key columns")
    for p in pk_idx:
        if chunk.columns[p].data.is_floating_point():
            raise NotImplementedError(
                "a float stream-key column in the sorted store is not "
                "ported yet")


def sorted_store_apply(store: SortedSideState, errs: torch.Tensor,
                       chunk: StreamChunk, pk_idx: Sequence[int],
                       spare: Optional[SortedSideState] = None,
                       bufs: Optional[_Buffers] = None) -> SortedSideState:
    """Insert/retract the chunk's rows into the sorted dense store.
    Returns the new store (on the card: `spare`, overwritten); adds the
    delete misses to errs[1] and the dropped rows to errs[2] in place
    (K7's error layout)."""
    _check_pk(chunk, pk_idx)
    h, is_ins, is_del, ins_h = net_pk_runs(chunk, chunk.vis, pk_idx, bufs)
    nh, iorder = stable_sort(ins_h, HASH_BITS)
    n_new = is_ins.sum(dtype=torch.int32)
    return merge(store, nh, iorder, n_new, chunk.columns, is_del, h,
                 2 * chunk.capacity, tuple(pk_idx), None, NO_WATERMARK,
                 errs, spare, bufs)


def sorted_store_apply_plain(store: SortedSideState, errs: torch.Tensor,
                             chunk: StreamChunk, pk_idx: Sequence[int]
                             ) -> SortedSideState:
    """`sorted_store_apply` with every step's plain version (torch's
    sorts included), on any device."""
    _check_pk(chunk, pk_idx)
    h, is_ins, is_del, ins_h = net_pk_runs_plain(chunk, chunk.vis, pk_idx)
    nh, iorder = torch.sort(ins_h, stable=True)
    return merge_plain(store, nh, iorder, is_ins.sum(dtype=torch.int32),
                       chunk.columns, is_del, h, 2 * chunk.capacity,
                       tuple(pk_idx), None, NO_WATERMARK, errs)


def segment_starts(sorted_group_ids: torch.Tensor):
    """For an array sorted by group id: (new_run mask, run_start
    positions broadcast per element) — the segmented-scan primitives."""
    C = sorted_group_ids.shape[0]
    dev = sorted_group_ids.device
    new_run = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                         sorted_group_ids[1:] != sorted_group_ids[:-1]])
    pos = torch.arange(C, device=dev)
    run_start = torch.cummax(torch.where(new_run, pos, 0), 0).values
    return new_run, run_start


class GrowableSortedStore:
    """Mixin for executors holding the dense sorted store (`store`, a
    SortedSideState) plus one same-capacity secondary (the last-emitted
    set): doubles both at 0.7 occupancy instead of fail-stopping, and
    pre-sizes before a recovery replay so state that grew past the
    constructor capacity recovers. Subclasses set _SECONDARY to the
    (hash, cols, valids) attribute names."""

    _SECONDARY: tuple = ()

    def _grow_to(self, new_c: int) -> None:
        st = self.store
        kh, cols, valids = grow_sorted_arrays(st.khash, st.cols, st.valids,
                                              new_c)
        degree = torch.cat([st.degree, torch.zeros(
            new_c - st.capacity, dtype=torch.int32, device=st.khash.device)])
        self.store = SortedSideState(kh, cols, valids, degree, st.n)
        self._spare = None
        h, c, v = self._SECONDARY
        kh2, c2, v2 = grow_sorted_arrays(
            getattr(self, h), getattr(self, c), getattr(self, v), new_c)
        setattr(self, h, kh2)
        setattr(self, c, c2)
        setattr(self, v, v2)
        self.capacity = new_c

    def _maybe_grow(self, n_live: int) -> None:
        if n_live > 0.7 * self.capacity:
            self._grow_to(self.capacity * 2)

    def _presize_for(self, n_rows: int) -> None:
        """Before a recovery replay: make room for every persisted row
        (the store may have grown past the constructor capacity before
        the crash)."""
        c = self.capacity
        while n_rows > 0.7 * c:
            c *= 2
        if c != self.capacity:
            self._grow_to(c)

