#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--host-profile | --mvmv-sizing]

Drives the port (`risingwave_tpu_torch`, never the JAX package) through
its Nexmark and TPC-H paths and holds every hand-written kernel against its
plain PyTorch version on the card:
  q5 — bid source -> HOP(2 s, 10 s) -> count(*) GROUP BY (auction,
       window_start) with watermark state cleaning;
  q7 — one bid source broadcast to a TUMBLE(10 s) projection -> MAX(price)
       GROUP BY window_end and to the bids, joined back on price = max
       with a band condition (sorted join), five actors as the JAX
       planner deploys bench.py's _q7_ddl();
  q8 — bench.py's bench_q8 statements, verbatim, through the port's own
       SQL Session: persons and auctions, each TUMBLE(10 s)-projected,
       joined on (id = seller, window_start) with pair cleaning;
  q17 — bench.py's bench_q17 statements, verbatim, through the Session:
       TPC-H lineitem x part x (0.2 * avg(l_quantity) per part), a global
       sum, lowered to the fused snapshot join-agg executor;
  q1 — bench.py's bench_q1 statements through the Session;
  q7d — bench.py's bench_q7d statements, verbatim, through the Session
       on a Hummock store over a local-fs object store (durable state,
       two checkpoints in flight), and bench_q7_kill's as an MV with a
       crash and a recovery;
  q5_topn — bench.py's _q5_topn_ddl() on one device through the Session:
       count(*) per auction % 65536 -> ORDER BY n DESC LIMIT 10 (the
       retractable top-N over the agg's changelog), also durable with a
       crash and a recovery;
  q2 — Nexmark q2 (a WHERE filter) through the Session;
  q6 / q4 — Nexmark q6 (AVG of the last 10 final prices per seller, a
       window function over the MAX agg's changelog of an auction x bid
       band join) and q4 (AVG of the finals per category), as the JAX
       package's goldens write them, through the Session; the EOWC body
       of tests/test_eowc_over_window.py; global aggregates;
  q5c — RisingWave's own Nexmark q5 (Q5C_SELECT) through the Session:
       count(*) per (auction, HOP window), the max of a second such
       count per window over its changelog (a retractable MAX: top-K
       value buffers), the two joined on the window with num >= maxn;
       and bench.py's _q5_ddl() verbatim (HOP through SQL).
  outer joins, temporal joins, NOW() — LEFT/FULL/RIGHT joins of auctions
       and persons (degrees and NULL-padded rows), a temporal join of
       bids against auctions, `expires > now()` dynamic filters, through
       the Session, and a durable LEFT join with a crash;
  the expression registry, HLL — Nexmark q3, q14 and the q15 shape,
       approx_count_distinct / bool_and / bool_or per auction and
       globally, string functions over persons, through the Session, and
       a durable approx_count_distinct with a crash;
  MV-on-MV — MVs and a sink over an MV while it grows (backfill);
  the hash join — inner joins on FLOAT64 keys (Nexmark q20's join, a
       retracting side, durable with a crash) through the Session.
Phases, one JSON line each:

  1. device: the card, torch/CUDA versions, the kernels' build time;
  2. each kernel vs its plain version at its path's shapes (K1-K4 at
     q5's, K5-K8 at q7's, K3/K4 and K11 again at q7's agg and join
     shapes), with CUDA-event timings, the plain and library times and
     the least time the card could take (bound);
  3. q5 end to end at full width (131072-row chunks, a 2^20-slot agg,
     barriers paced by row count) into the device blackhole sink, five
     times from fresh state to show the spread: every q5 kernel launched
     in each run (K12 in the agg's barrier flush), no overflow, the live
     groups equal a host recount;
  4. a short full-width q5 run under torch.profiler: device busy time by
     kernel, and the device's idle share against phase 3's unprofiled
     median wall; then q5 into a materialized view at a small size: the
     MV equals a host recount;
  5. q7 at bench.py's width (131072-bid chunks, inter_event_us=250, 20 s
     watermark lag, a 2^19-row join and an 8192-slot agg, 14 barriers of
     8 chunks) into the device blackhole sink, five times: every q7
     kernel launched (K11 sorts the join's rows), no match or row
     overflow, and exactly the delete misses that this geometry's band
     cleaning causes (q7_delete_misses, which the CPU tests hold against
     the JAX executor); bids/s, barrier latency, peak memory; then a
     short profiled q7 run for the idle share;
  6. q7_check: bench's _q7_ddl() statements through
     Session(device="cuda") at one barrier per 32768-bid chunk into a
     device sink that keeps the output rows; its net output must equal
     the hand wiring's at the same geometry and a numpy recount, every
     error counter 0;
  6a. kernels_q7d: K17 (the join's snapshot diff) and K18 (the agg's
     persist view and eviction keys) against their plain versions,
     exactly, on the state a bench_q7d run holds (both join sides at
     2^18 slots against their snapshots from the barrier before, the
     2^13-slot agg) and on edge cases (an empty diff, every row changed,
     duplicate identical rows, NULL lanes, a float64 column, a full
     store, an eviction with nothing below the watermark);
  6b. q7d_full: bench_q7d's statements, verbatim, on a Hummock store
     over a local-fs object store in a temporary directory, 8 chunks of
     32768 bids a barrier, 8 barriers, five runs: committed epochs
     strictly increasing and drained, join errs [0, m, 0] with m =
     q7_delete_misses; bids/s, barrier p50/max, upload_overlap_pct, rows
     and bytes fetched per checkpoint, peak memory; alternating with the
     same statements at streaming_durability = 0 over a
     MemoryStateStore: the flush tax is the durable wall over the
     volatile one, within this call;
  6c. q7d_recover: bench_q7_kill's statements (an MV), one 8192-bid
     chunk a barrier: 30 barriers, crash(), HummockStateStore.open, a
     new Session, recover() (recovery_ms: from the store's opening to
     the first collected barrier), barriers to 491520 bids; the MV must equal an
     uninterrupted durable run's and the numpy recount;
  7. kernels_q8: K9-K12 against their plain versions at q8's shapes
     (98304-row person and 294912-row auction chunks; the join's hash
     sorts; a 16384-row netting lexsort; K12 over q5's 2^20 slots);
  8. q8_full: bench_q8's statements through Session(device="cuda"), a
     2^19-row join a side, match factor 2, 28 barriers each after one
     person chunk and one auction chunk (11.0 M events), five runs from
     fresh state: K5-K7 and K9-K11 launched, errs[1] == errs[2] == 0
     (errs[0], the person side's match-buffer overflow, is reported:
     bench's geometry drops matches in both engines when a person chunk
     reaches the join after its auctions); then q8_profile, the idle
     share of a short profiled run;
  9. q8_check: the same statements into a device sink that keeps the
     rows, 8 barriers: at match factor 2 every output key at most its
     numpy recount and the shortfall equal to errs[0]; at match factor 4
     the output equal to the recount with errs [0, 0, 0]; then 2
     barriers with auction chunks twice bench's, where the person side's
     buffer must overflow (errs[0] > 0) and the identity still hold;
 10. kernels_q17: K13-K16 against their plain versions (K13 at 1024-row
     part and 8192/131072-row lineitem chunks; K14-K16 on the 2^20-slot
     fact store at bench's end state, with NULL keys and a sub-WHERE
     plan, every flush step and the whole flush against the CPU's);
 11. q17_full: bench_q17's statements through Session(device="cuda"):
     one warmup barrier, then 64 x 8192 measured lineitem rows, five
     runs from fresh state: errs [0, 0, 0], K5, K11 and K13-K16
     launched; q17_profile, the idle share of a profiled run; q17_sf1,
     the same statements until TPC-H SF1's 6,001,215 lineitem rows (the
     store grows to 2^23 slots), the last value equal to a numpy
     recount; q17_check, a 2^17-slot store that grows, every barrier's
     value equal to the recount, and tests/test_snapshot_join_agg.py's
     shapes at small size;
 12. q1_full: bench_q1's statements through Session(device="cuda"), three
     runs (K1 and K5 launched), then a small run whose rows equal a
     numpy recount;
 13. kernels_topn: K19-K22 and K5's MOD_I/MOD_F against their plain
     versions, exactly: K19 on a 2^17-slot store at a q5_topn run's end
     state with a 2^19-row agg changelog chunk of 65536 U-/U+ pairs (and
     pk runs, deletes that miss, an overfull insert); K20/K21 on q5_topn's
     flush (ties at the limit, an empty old set) and on group keys, DESC
     int and float keys, NULLs, offsets and an empty store; K22 at q2's
     131072-row chunk with update pairs failing on either side and at
     rows 0 and N-1; MOD with negative operands, zero divisors and
     INT64_MIN % -1;
 14. q5_topn_full: bench.py's _q5_topn_ddl() on one device (Q5T_DDL)
     through Session(device="cuda"), 8 chunks of 32768 bids a barrier,
     16 barriers, five runs: every q5_topn kernel launched, the top-N's
     errs and the agg's overflow 0; bids/s and barrier p50; then
     q5_topn_profile, the device's idle share of a profiled run;
 15. q5_topn_check: the same statements as an MV, 12 barriers of 65536
     bids: after every barrier the MV equals the host recount (count per
     auction % 65536, ranked by n desc and the key hash of a), exactly;
 16. q2_full: Nexmark q2 (WHERE auction % 123 = 0) into the sink at
     131072-bid chunks, three runs; as an MV its rows equal a numpy
     recount; a WHERE over an aggregating subquery at 8192-bid barriers
     (update pairs cross the filter) equals the recount;
 17. topn_recover: q5_topn as a durable MV on a Hummock store, 8
     barriers, crash(), reopen, recover(), 8 more: the MV equals an
     uninterrupted durable run's and the recount;
 18. kernels_window: K23 (window scan), K24 (over-window diff) and K25
     (global agg apply) against their plain versions: K23/K24 on a
     q6-shaped store (270000 live rows in 2^19 slots) and on edge cases
     (NaN, +-0, subnormal and DESC float order keys, duplicate order
     keys, an all-NULL frame, lag/lead at partition edges, one partition
     of the whole store, many small ones, NaN and +-inf sum arguments
     kept in their partition), exact for integer arguments, float sums
     within a relative 1e-9, two K23 launches bit-identical; K25 on a
     131072-row chunk of retracting and append-only calls;
 19. q6_full: q6 into the device blackhole sink, 4 x 131072 bids and
     the auctions of their event time a barrier, 53 barriers (the
     over-window store past 2^18 live rows), two runs: every q6 kernel
     launched, errs 0; events/s, barrier p50 and max, store and emitted
     set rows and bytes, join sides' rows; q6_profile, the idle share;
 20. q6_check: q6 as an MV, one bid chunk a barrier, the store started
     at 2^14 slots with the watchdog on (it grows): the MV equals a numpy
     recount after every barrier; q4_full: q4 as an MV at q6_full's
     geometry, equal to the recount after every barrier;
 21. eowc_full: the EOWC body over bids (131072-bid chunks, 10
     barriers) into a sink that keeps the rows, beside the same body
     without EOWC: each EOWC row once, equal to the general
     over-window's rows up to the frontier and a numpy row_number and
     running sum per auction;
 22. global_agg: count/sum/max over bids at q1's geometry, and the avg
     and count of q6's finals (retracting input), each equal to the
     recount after every barrier;
 23. q6_recover: durable q6 as an MV, one 131072-bid chunk (and its
     auctions) a barrier, crash after 8 barriers, recover, on to 16:
     the MV equals the recount; recovery_ms;
 24. kernels_extrema: K26 (the retractable extremum's update, after two
     K11 passes) against its plain version on the MaxBids agg's shapes
     (a 2^21-row flush chunk of 300000 U-/U+ count pairs into 17 window
     groups of a 2^20-slot, K = 32 agg; int64 and float64) and on
     tests/test_torch_extrema.py's hazard chunks (NaN, +-0, subnormals,
     NULLs, deletes that miss, K = 2 spills and an emptied buffer);
     K27 (the hash agg's barrier flush after K12) on q5's, q7's and the
     MaxBids agg's flush shapes, every output row and the refreshed
     state; K18 on a COUNT and a retractable MAX's buffers (65 lanes),
     int64 and float64; all exact;
 25. q5c_full: the canonical q5 as an MV at 8 x 131072 bids a barrier,
     12 barriers (12.58 M bids, ~620k live groups in each 2^20-slot
     COUNT agg: no growth; a 2^20-row join), every q5c kernel launched,
     the join's errs [0, 0, 0], no agg overflow, the MV equal to a numpy
     recount (counts per (auction, window), the max per window, the
     rows at it); events/s, barrier p50/max, peak memory, the join's
     match slots; q5c_profile, the idle share of a short profiled run;
 26. q5c_check: one 131072-bid chunk a barrier, the MV equal to the
     recount after every barrier; q5c_recover: durable, crash after 8
     barriers, recover, on to 16, the MV equal to the recount; q5_sql:
     bench.py's _q5_ddl() verbatim through the Session beside the
     hand-wired q5, the live groups equal;
 27. kernels_outer: K28 (the outer join's match counts, degrees, net
     NULL-row transitions and NULL-padded segments, after K6 and the K5
     condition) against its plain version, exactly, as a LEFT, FULL and
     RIGHT apply of a 131072-row person chunk (U-/U+ pairs of one id,
     deletes, NULL ids) against the 2^22-row auction side (2^23 slots,
     match factor 64) and of an auction chunk against persons; K7 with
     match counts as degrees; K29 (the dynamic filter's flush) for the
     four ops, a retracted rhs, NULL and float keys, at the dynf shape;
 28. lj_full: auction LEFT OUTER JOIN person ON seller = id AND
     category = 10 through Session(device="cuda") into a device collect
     sink, 2^19 auctions and 2^17 persons a barrier (persons lag, so
     NULL rows are retracted), 9 barriers: the net output equals the
     numpy recount, errs [0, 0, 0], every outer-join kernel launched;
     events/s, barrier p50, the idle share of a short profiled run;
 29. lj_retract (a LEFT join of a retracting count per seller, exact
     after every barrier), fj_check (the FULL golden, right-only rows),
     tj_full (bid LEFT and INNER JOIN auction FOR SYSTEM_TIME AS OF
     PROCTIME(), 131072-bid chunks against 2^22 auctions: one row per
     bid, categories right);
 30. dynf: `expires > now()` over 2^22 auctions (every row passes) and
     `expires < now()` (none), then the dynamic filter with a scripted
     rhs stepping through the expires range in 16 barriers, each
     barrier's changelog equal to the rows that crossed;
 31. lj_recover: the LEFT join durable, crash after 4 barriers, recover
     (degrees rebuilt by replay), on to 8: the MV equals an
     uninterrupted run's and the recount, NULL rows at the crash
     matched after it;
 32. kernels_hll: K30 (the HLL register update) against its plain
     version on a 131072-row chunk into 1 slot (q15's day) and into
     2^20 slots, int64 and float64 values with NULLs, deletes and
     invisible rows, and the simple agg's one-group form, exactly;
     kernels_wide: K27, K18, K4 (one COUNT over a boolean column) and
     K25 at 22 calls, exactly; kernels_expr: K5's new opcodes on a
     131072-row list of hazard columns (NaN, +-inf, +-0, ties,
     out-of-range casts and shifts, four centuries of timestamps,
     strings, real HLL words), split into several launches, exact but
     the transcendental functions (within 2 ulp);
 33. q3_full (RisingWave's q3 at q8's chunks, the MV equal to the
     recount after every barrier), q14_full (into the sink, then an MV
     checked after every barrier), q15_full (22 agg calls, estimates
     bit-equal to hll_estimate_numpy), acd_full (a 2^20-slot agg, 12
     barriers, checked at 6 and 12; the global form every barrier),
     strings_full (decoded) and acd_recover (durable, crash after 4
     barriers); rates from an unchecked run, idle shares from a
     profiled one;
 34. queue_c: an integer CASE condition (with and without ELSE), an
     integer WHERE and boolean arithmetic through Session(device="cuda"),
     each MV equal to the numpy recount (a condition holds where its low
     bit is set); kernels_expr also holds K5's Queue C list and its mask
     mode, and the K22 block integer predicates, against their plain
     versions;
 35. kernels_backfill: K31's two entries (the device vnode and the
     backfill's live-side filter) against their plain versions and
     numpy, bit for bit, over ten key sets and 266 frontiers;
     mvmv_full: mv_agg over 131072-bid chunks to 2^18 auctions, then
     mv_hot, mv_hist and a sink over it while bids flow: rates,
     backfill rows/s, barriers to finish, p50/max during and after, the
     idle share of a profiled rerun, then K31 checked and timed on the
     live chunks its backfills filtered (kernels_backfill_path);
     mvmv_check: after every barrier the
     consumers equal the recount over mv_agg's covered rows; DROP of
     mv_agg refused while read; mvmv_recover: durable, crash in the
     middle of the backfill, recover, resume from the progress rows;
 36. kernels_hash_join: K3 on float64 hazard keys and over poisoned
     scratch buffers (scripts/k3_float_fault.py, also in queue_c);
     extra figures at larger shapes than the path's: K32 (the hash
     join's probe) on a 131072-row bid chunk probing 2^21 auctions and
     an auction chunk probing the 2^21-row bid side's chains, K33's
     insert of a bid chunk and its 131072 deletes, K34's keep, dirty
     and evict packs of the 2^21-row side, each against its plain
     version, exactly (output rows as multisets, chains as sets per
     key); hj_full: Nexmark q20's join keyed by FLOAT64 through
     Session(device="cuda"), paced by a ramp while the rebuilds double
     the executor's default capacities, to 2^21 live bid rows, its net
     output equal to the numpy recount; hj_retract (each auction's max
     price, a FLOAT64-keyed agg, joined to its auction; exact after
     every barrier); kernels_hash_join_path: K32, K3, K33 and K34 on
     the chunks and rehashes hj_full's and hj_retract's joins applied
     (recorded in their unprofiled runs), against their plain versions
     and the path's own output and state, and timed there for the
     kernels line; hj_recover (durable, crash after 4 barriers,
     recover, on to 8: the MV equal to the recount);
 37. the kernels line: launches on the first run of each kernel's own
     slice's path (q5 for K1-K4 and K12, q7 for K5-K8, q8 for K9-K11,
     q17 for K13-K16, q7d for K17-K18, q5_topn for K19-K21, q2 for K22,
     q6 for K23-K24, the global agg for K25, q5c for K26-K27, lj_full
     for K28, dynf for K29, acd_full for K30, mvmv_full for K31,
     hj_full for K32-K34), error, times, bounds. K27
     runs in every hash agg's flush, so every earlier path drives it
     too.
With --host-profile, phase 4 also runs q5 under cProfile and lists the
host functions with the most own time. With --mvmv-sizing the script
builds the kernels and runs only mvmv_full at the sizes of MVMV_SIZES
(`mvmv_sizing`), and prints neither the kernels line nor the last.
The last line is {"ok": true, "device": {...}}. Any failed phase exits
non-zero before it. Without a CUDA device the script exits 2.
"""

from __future__ import annotations

import asyncio
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch

from risingwave_tpu_torch.common.chunk import Column, StreamChunk, op_sign
from risingwave_tpu_torch.common.types import GLOBAL_DICT, DataType
from risingwave_tpu_torch.common.types import schema as make_schema
from risingwave_tpu_torch.connectors import tpch
from risingwave_tpu_torch.connectors.tpch import TpchGenerator
from risingwave_tpu_torch.connectors.nexmark import (
    BID_PROPORTION, FIRST_AUCTION_ID, TOTAL_PROPORTION, NexmarkConfig,
    NexmarkGenerator,
    gen_auction_columns, gen_auction_columns_plain, gen_bid_columns,
    gen_bid_columns_plain, gen_person_columns, gen_person_columns_plain,
    vocab_ids,
)
from risingwave_tpu_torch.expr import ExprProgram, FuncCall, call, col, lit
from risingwave_tpu_torch.expr.agg import (
    AggCall, AggKind, agg_max, agg_min, agg_sum, count_star,
)
from risingwave_tpu_torch.expr.transforms import (
    TumbleEndTransform, TumbleStartTransform,
)
from risingwave_tpu_torch.frontend import Session
from risingwave_tpu_torch.frontend.binder import StreamPlanner
from risingwave_tpu_torch.frontend.sql import parse as sql_parse
from risingwave_tpu_torch.meta import BarrierCoordinator
from risingwave_tpu_torch.ops import hash_table as ht
from risingwave_tpu_torch.ops import kernels
from risingwave_tpu_torch.ops.sort import (
    stable_lexsort, stable_sort, stable_sort_plain,
)
from risingwave_tpu_torch.plan.graph import Exchange
from risingwave_tpu_torch.state import (
    HummockStateStore, LocalFsObjectStore, MemoryStateStore, StateTable,
)
from risingwave_tpu_torch.stream import (
    Actor, BroadcastDispatcher, Channel, ChannelInput,
    DeviceBlackholeSinkExecutor, Executor, HashAggExecutor,
    HashJoinExecutor, HopWindowExecutor, MaterializeExecutor, NoOpExecutor, ProjectExecutor,
    GeneralOverWindowExecutor, RetractableTopNExecutor, RowIdGenExecutor,
    SimpleAggExecutor, SimpleDispatcher, SnapshotJoinAggExecutor,
    SortedJoinExecutor, SourceExecutor,
)
from risingwave_tpu_torch.stream import snapshot_join_agg as sja
from risingwave_tpu_torch.stream.hash_agg import (
    AggState, agg_apply, agg_apply_plain, agg_flush, agg_flush_plain,
    persist_pack, persist_pack_plain,
)
from risingwave_tpu_torch.ops.extrema import (
    extrema_apply, extrema_apply_plain, extrema_empty,
)
from risingwave_tpu_torch.stream.hop_window import (
    hop_expand, hop_expand_plain,
)
from risingwave_tpu_torch.stream.row_id import row_ids, row_ids_plain
from risingwave_tpu_torch.stream.sorted_join import (
    HSENTINEL, NO_WATERMARK, SortedSideState, _Buffers, copy_side,
    empty_sorted_side, key_hash, merge, merge_plain, net_pk_runs,
    net_pk_runs_plain, outer_apply, outer_apply_plain, outer_segments,
    pack_diff_plain, probe, probe_plain, snapshot_diff, store_from_rows,
)
from risingwave_tpu_torch.stream.dynamic import (
    INT64_MAX, INT64_MIN, OPS, DynamicFilterExecutor, dynf_flush,
)
from risingwave_tpu_torch.interop import chunk_from_numpy
from risingwave_tpu_torch.stream.project import (
    filter_fixup, filter_fixup_plain,
)
from risingwave_tpu_torch.stream.retract_top_n import (
    topn_diff, topn_diff_plain, topn_flush, topn_flush_plain, topn_keys,
    topn_keys_plain, topn_order, topn_rank, topn_rank_plain,
)
from risingwave_tpu_torch.stream.sorted_join import HASH_BITS
from risingwave_tpu_torch.stream.general_over_window import (
    WindowSpec, _ret_dtype, over_window_flush, window_diff,
    window_diff_plain, window_hash, window_hash_plain, window_keys,
    window_order, window_scan, window_scan_plain,
)
from risingwave_tpu_torch.stream.simple_agg import (
    simple_agg_apply, simple_agg_apply_plain,
)
from risingwave_tpu_torch.stream.sorted_store import (
    sorted_store_apply, sorted_store_apply_plain,
)
from risingwave_tpu_torch.utils import d2h
from risingwave_tpu_torch.common.vnode import (
    backfill_filter, backfill_filter_plain, compute_vnodes,
    compute_vnodes_numpy, compute_vnodes_plain,
)
from risingwave_tpu_torch.frontend.binder import BindError
from risingwave_tpu_torch.stream.backfill import BackfillExecutor
from risingwave_tpu_torch.stream.message import BarrierKind, ThrottleMutation
from risingwave_tpu_torch.stream import hash_join as hj

SLIDE_US = 2_000_000
SIZE_US = 10_000_000
# What the JAX planner builds for bench.py's _q5_ddl() (read from its
# Session graph): HOP keeps (auction, window_start) — the planner's
# Project($0, $7) after an unpruned HOP, folded into output_indices —
# and the agg cleans state on window_start (its input column 1) in
# transfer-free watchdog mode (streaming_watchdog = 0).
Q5_OUTPUT_INDICES = (0, 7)
Q5_CLEANING_COL = 1
Q5_WATCHDOG = None

# H100 SXM peak device-memory rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12


# ------------------------------------------------------------ q5 wiring

def build_q5(device, chunk_size: int, capacity: int, inter_event_us: int,
             rows_per_barrier: int, materialize: bool):
    """Source -> HOP -> HashAgg -> (MV | device blackhole), wired like
    tests/test_q5_pipeline.py with the planner's q5 arguments."""
    store = MemoryStateStore()
    barrier_q: asyncio.Queue = asyncio.Queue()
    gen = NexmarkGenerator("bid", chunk_size=chunk_size,
                           cfg=NexmarkConfig(inter_event_us=inter_event_us),
                           device=device)
    src = SourceExecutor(1, gen, barrier_q, emit_watermarks=True,
                         rate_limit_rows_per_barrier=rows_per_barrier)
    hop = HopWindowExecutor(src, time_col=5, window_slide_us=SLIDE_US,
                            window_size_us=SIZE_US,
                            output_indices=Q5_OUTPUT_INDICES)
    agg = HashAggExecutor(hop, group_key_indices=[0, hop.window_start_idx],
                          agg_calls=[count_star(append_only=True)],
                          capacity=capacity,
                          cleaning_watermark_col=Q5_CLEANING_COL,
                          watchdog_interval=Q5_WATCHDOG, device=device)
    mv = None
    if materialize:
        mv = StateTable(store, table_id=3, schema=agg.schema,
                        pk_indices=list(agg.pk_indices))
        head = MaterializeExecutor(agg, mv)
    else:
        head = DeviceBlackholeSinkExecutor(agg)
    coord = BarrierCoordinator(store)
    coord.register_source(barrier_q)
    coord.register_actor(1)
    return dict(gen=gen, src=src, hop=hop, agg=agg, mv=mv, head=head,
                coord=coord, actors=[Actor(1, head, None, coord)])


async def drive_paced(pipe: dict, rows_per_barrier: int,
                      rounds: int) -> float:
    """Spawn the pipeline's actors, then the Initial barrier, then
    `rounds` barriers, each injected once the source has emitted exactly
    rows_per_barrier more rows (it parks at its rate limit); the last one
    is the Stop barrier, so no row follows it. Returns the wall seconds
    of the rounds."""
    coord, gen = pipe["coord"], pipe["gen"]
    tasks = [a.spawn() for a in pipe["actors"]]

    def check():
        for t in tasks:
            if t.done():
                t.result()

    b = await coord.inject_barrier(kind=BarrierKind.INITIAL)
    await coord.wait_collected(b)
    t0 = time.perf_counter()
    for r in range(1, rounds + 1):
        while gen.offset < r * rows_per_barrier:
            check()
            await asyncio.sleep(0)
        if r < rounds:
            b = await coord.inject_barrier()
            await coord.wait_collected(b)
        else:
            await coord.stop_all({a.actor_id for a in pipe["actors"]})
    wall = time.perf_counter() - t0
    await asyncio.gather(*tasks)
    return wall


def _bid_gid(k):
    return (k // 46) * 50 + 4 + k % 46


def first_bid_at_or_after(ts_us: int, cfg: NexmarkConfig) -> int:
    """Smallest bid index whose event time is >= ts_us (event time is
    monotone in the bid index)."""
    lo, hi = 0, 1
    while cfg.base_time_us + _bid_gid(hi) * cfg.inter_event_us < ts_us:
        hi *= 2
    while lo < hi:
        mid = (lo + hi) // 2
        if cfg.base_time_us + _bid_gid(mid) * cfg.inter_event_us < ts_us:
            lo = mid + 1
        else:
            hi = mid
    return lo


def recount_windows(start: int, end: int, cfg: NexmarkConfig, min_ws: int,
                    device, batch: int = 1 << 20) -> dict:
    """{(auction, window_start): count} over bids [start, end) for windows
    with window_start >= min_ws — a numpy recount of the generator's
    prefix, like bench.py's _numpy_q5. The bids come from the plain
    PyTorch generator (held bit-identical to the JAX package by the CPU
    tests)."""
    vocabs = {k: torch.tensor(v, dtype=torch.int32, device=device)
              for k, v in vocab_ids().items()}
    K = SIZE_US // SLIDE_US
    auctions, starts = [], []
    for off in range(start, end, batch):
        n = min(batch, end - off)
        cols = gen_bid_columns_plain(off, n, cfg, vocabs, device)
        auction = cols[0].cpu().numpy()
        ts = cols[5].cpu().numpy()
        base = (ts // SLIDE_US) * SLIDE_US
        for k in range(K):
            ws = base - k * SLIDE_US
            keep = (ts < ws + SIZE_US) & (ws >= min_ws)
            auctions.append(auction[keep])
            starts.append(ws[keep])
    a = np.concatenate(auctions or [np.empty(0, np.int64)])
    w = np.concatenate(starts or [np.empty(0, np.int64)])
    if a.size == 0:
        return {}
    # one int64 key per (auction, window): np.unique on it is much
    # faster than on rows
    w0 = int(w.min())
    widx = (w - w0) // SLIDE_US
    if int(widx.max()) >= 1 << 24 or int(a.min()) < 0 \
            or int(a.max()) >= 1 << 38:
        raise ValueError("recount key out of range")
    uniq, counts = np.unique((a << 24) | widx, return_counts=True)
    return {(int(u >> 24), w0 + int(u & ((1 << 24) - 1)) * SLIDE_US): int(c)
            for u, c in zip(uniq, counts)}


def live_groups(agg: HashAggExecutor) -> dict:
    st = agg.state
    live = (st.table.occupied & (st.row_count > 0)).cpu().numpy()
    a = st.table.keys[0].cpu().numpy()[live]
    w = st.table.keys[1].cpu().numpy()[live]
    c = st.row_count.cpu().numpy()[live]
    return {(int(x), int(y)): int(z) for x, y, z in zip(a, w, c)}


def mv_groups(mv: StateTable) -> dict:
    return {(row[0], row[1]): row[2] for _, row in mv.iter_all()}


# ------------------------------------------------------------ q7 wiring

Q7_W = 10_000_000           # TUMBLE window, microseconds
Q7_LAG_US = 20_000_000      # source watermark lag (bench.py's 2 * W)
Q7_JOIN_CAPACITY = 1 << 19
Q7_AGG_CAPACITY = 1 << 13
# What the JAX planner builds for bench.py's _q7_ddl() (read from its
# stream graph): the join's band cleaning specs, sides' append-only flags
# and match factors; the agg cleans on window_end in transfer-free mode.
Q7_CLEAN_SPECS = (("band", 3, 1, -Q7_W, None), ("band", 1, 3, 0, 1))


class DeviceCollectSinkExecutor(Executor):
    """Sink that appends every visible row, with its sign, to buffers on
    the device (no host sync per chunk); `rows()` copies them out once.
    Rows past `capacity` are counted in `dropped`, never written."""

    def __init__(self, input: Executor, capacity: int, device):
        self.input = input
        self.schema = input.schema
        self.pk_indices = getattr(input, "pk_indices", ())
        self.identity = "DeviceCollectSink"
        self.capacity = capacity
        dev = torch.device(device)
        self.count = torch.zeros((), dtype=torch.int64, device=dev)
        self.sign = torch.zeros(capacity + 1, dtype=torch.int8, device=dev)
        self.data = [torch.zeros(capacity + 1, dtype=f.data_type.torch_dtype,
                                 device=dev) for f in self.schema]
        self.valid = [torch.zeros(capacity + 1, dtype=torch.bool, device=dev)
                      for _ in self.schema]

    def _append(self, chunk: StreamChunk) -> None:
        vis = chunk.vis
        rank = self.count + torch.cumsum(vis.to(torch.int64), 0) - 1
        # the trash row `capacity` takes invisible and overflowing rows
        tgt = torch.where(vis & (rank < self.capacity), rank, self.capacity)
        self.sign[tgt] = op_sign(chunk.ops).to(torch.int8)
        for buf, vb, c in zip(self.data, self.valid, chunk.columns):
            buf[tgt] = c.data
            vb[tgt] = c.valid_mask()
        self.count += vis.sum()

    async def execute(self):
        async for msg in self.input.execute():
            if isinstance(msg, StreamChunk):
                self._append(msg)
            yield msg

    def arrays(self) -> tuple[list, np.ndarray, int]:
        """(kept columns as numpy arrays, their signs, rows that did not
        fit); NULL lanes hold 0."""
        n = int(self.count)
        k = min(n, self.capacity)
        return ([d[:k].cpu().numpy() for d in self.data],
                self.sign[:k].cpu().numpy(), n - k)

    def rows(self) -> tuple[Counter, int]:
        """(net multiset of rows, rows that did not fit)."""
        cols, sign, dropped = self.arrays()
        valid = [v[:sign.size].cpu().numpy() for v in self.valid]
        net: Counter = Counter()
        for r in range(sign.size):
            row = tuple(int(c[r]) if v[r] else None
                        for c, v in zip(cols, valid))
            net[row] += int(sign[r])
        return Counter({r: c for r, c in net.items() if c}), dropped


def build_q7(device, chunk_size: int, inter_event_us: int,
             rows_per_barrier: int, join_capacity: int = Q7_JOIN_CAPACITY,
             agg_capacity: int = Q7_AGG_CAPACITY, lag_us: int = Q7_LAG_US,
             collect: int = 0):
    """Nexmark q7 as the JAX planner deploys bench.py's _q7_ddl(): five
    fragments, one actor each.
      1 source (watermarks, lag), broadcast to 2 and 3;
      2 NoOp -> Project[$0,$1,$2,$5] -> RowIdGen   (join left, append-only)
      3 Project(+tumble_start, tumble_end of $5) -> Project[$8,$2];
      4 HashAgg(max(price) group by window_end, cleaning on it)
        -> Project[$1,$0]                           (join right, retracting)
      5 SortedJoin(price = maxprice, band condition) -> Project -> sink.
    The sink is the device blackhole, or with collect > 0 a device sink
    that keeps up to `collect` output rows."""
    store = MemoryStateStore()
    coord = BarrierCoordinator(store)
    barrier_q: asyncio.Queue = asyncio.Queue()
    coord.register_source(barrier_q)
    gen = NexmarkGenerator("bid", chunk_size=chunk_size,
                           cfg=NexmarkConfig(inter_event_us=inter_event_us),
                           device=device)
    src = SourceExecutor(1, gen, barrier_q, emit_watermarks=True,
                         watermark_lag_us=lag_us,
                         rate_limit_rows_per_barrier=rows_per_barrier)
    bid = src.schema
    TS, I64 = DataType.TIMESTAMP, DataType.INT64
    ch2, ch3, ch4, ch5l, ch5r = (Channel() for _ in range(5))

    def refs(sch, idx):
        return [col(i, sch[i].data_type) for i in idx]

    left = RowIdGenExecutor(ProjectExecutor(
        NoOpExecutor(ChannelInput(ch2, bid)), refs(bid, (0, 1, 2, 5)),
        names=["auction", "bidder", "price", "date_time"]), instance=2)
    tumble = ProjectExecutor(
        ChannelInput(ch3, bid),
        refs(bid, range(7)) + [
            call("tumble_start", col(5, TS), lit(Q7_W)),
            call("tumble_end", col(5, TS), lit(Q7_W))],
        names=list(bid.names) + ["window_start", "window_end"],
        watermark_transforms={5: [(7, TumbleStartTransform(Q7_W)),
                                  (8, TumbleEndTransform(Q7_W))]})
    windows = ProjectExecutor(tumble, refs(tumble.schema, (8, 2)),
                              names=["window_end", "a2"])
    agg = HashAggExecutor(
        ChannelInput(ch4, windows.schema), group_key_indices=[0],
        agg_calls=[agg_max(1, I64, append_only=True)],
        capacity=agg_capacity, cleaning_watermark_col=0,
        watchdog_interval=None, device=device)
    right = ProjectExecutor(agg, refs(agg.schema, (1, 0)),
                            names=["maxprice", "window_end"])
    cond = call("and",
                call("greater_than", col(3, TS),
                     call("subtract", col(6, TS), lit(Q7_W))),
                call("less_than_or_equal", col(3, TS), col(6, TS)))
    join = SortedJoinExecutor(
        ChannelInput(ch5l, left.schema), ChannelInput(ch5r, right.schema),
        left_key_indices=[2], right_key_indices=[0], left_pk_indices=[4],
        right_pk_indices=[1], capacity=join_capacity, match_factor=2,
        match_factors=(2, 2), condition=cond, append_only=(True, False),
        clean_specs=Q7_CLEAN_SPECS, watchdog_interval=None, device=device)
    out = ProjectExecutor(join, refs(join.schema, (0, 2, 1, 3, 4, 6)),
                          names=["auction", "price", "bidder", "date_time",
                                 "_sk4", "_sk6"])
    head = (DeviceCollectSinkExecutor(out, collect, device) if collect
            else DeviceBlackholeSinkExecutor(out))
    actors = [Actor(1, src, BroadcastDispatcher([ch2, ch3]), coord),
              Actor(2, left, SimpleDispatcher(ch5l), coord),
              Actor(3, windows, SimpleDispatcher(ch4), coord),
              Actor(4, right, SimpleDispatcher(ch5r), coord),
              Actor(5, head, None, coord)]
    for a in actors:
        coord.register_actor(a.actor_id)
    return dict(gen=gen, src=src, agg=agg, join=join, head=head,
                coord=coord, actors=actors)


def _bid_prefix(n_bids: int, cfg: NexmarkConfig, device, idx,
                batch: int = 1 << 20) -> list:
    """Columns `idx` of bids [0, n_bids) from the plain generator, as
    numpy arrays."""
    vocabs = {k: torch.tensor(v, dtype=torch.int32, device=device)
              for k, v in vocab_ids().items()}
    parts = []
    for off in range(0, n_bids, batch):
        cols = gen_bid_columns_plain(off, min(batch, n_bids - off), cfg,
                                     vocabs, device)
        parts.append([cols[i].cpu().numpy() for i in idx])
    return [np.concatenate(x) for x in zip(*parts)]


def q7_delete_misses(n_bids: int, per_barrier: int, cfg: NexmarkConfig,
                     device) -> int:
    """The delete misses q7's join counts over bids [0, n_bids) with a
    barrier every `per_barrier` bids. A window whose bids straddle a
    barrier is flushed by the agg at that barrier; when the join's clean
    bound (the left input's watermark, the epoch's last bid time minus
    the lag) passes the window's end before the agg's update for it
    arrives at the next barrier, the window's max row is evicted and the
    update's delete misses. So each straddling window whose max rises
    after the barrier is one miss, provided the join has read enough of
    the left input when the update arrives. It takes one message from
    each input in turn: when it is a whole epoch behind, it applies the
    update having read the left watermarks of only the first half of the
    epoch's chunks. The count is therefore exact when half a barrier
    spans more event time than the lag plus the window (60 s at q7's
    W = 10 s, lag 20 s), and 0 when a barrier spans less than the lag
    minus the window; in between it depends on how far the join is
    behind, and this raises. (tests/test_torch_q7_pipeline.py holds the
    count against the JAX executor at 8 chunks a barrier;
    tests/test_torch_durable.py shows the port's durable and volatile
    sessions and JAX's counting fewer misses at 4.)"""
    span = per_barrier * cfg.inter_event_us * TOTAL_PROPORTION \
        // BID_PROPORTION                    # bids are 46 of 50 events
    if span < Q7_LAG_US - Q7_W:
        # the clean bound never passes a window's end before its update
        return 0
    if span <= 2 * (Q7_LAG_US + Q7_W):
        raise ValueError(f"q7 misses at a {span / 1e6} s barrier depend on "
                         "how far the join is behind")
    return q7_rising_straddles(n_bids, per_barrier, cfg, device)


def q7_rising_straddles(n_bids: int, per_barrier: int, cfg: NexmarkConfig,
                        device) -> int:
    """The windows whose bids straddle a barrier (one every `per_barrier`
    bids) and whose max price rises after it: the most delete misses q7
    can count at that pacing."""
    price, ts = _bid_prefix(n_bids, cfg, device, (2, 5))
    end = ts - ts % Q7_W + Q7_W               # monotone in the bid index
    misses = 0
    for k in range(per_barrier, n_bids, per_barrier):
        if end[k - 1] != end[k]:
            continue
        lo = int(np.searchsorted(end, end[k], side="left"))
        hi = int(np.searchsorted(end, end[k], side="right"))
        misses += int(price[k:hi].max() > price[lo:k].max())
    return misses


def q7_recount(n_bids: int, cfg: NexmarkConfig, device,
               batch: int = 1 << 20) -> Counter:
    """q7's result over bids [0, n_bids), recounted with numpy like
    bench.py's _numpy_q7: each bid joins the window whose (end - W, end]
    holds its time, and is output when its price is that window's max
    (the max over the bids whose tumble window ends there). Rows are
    (auction, price, bidder, date_time, window_end)."""
    auction, bidder, price, ts = _bid_prefix(n_bids, cfg, device,
                                             (0, 1, 2, 5), batch)
    own_end = ts - ts % Q7_W + Q7_W
    ends, inv = np.unique(own_end, return_inverse=True)
    mx = np.full(ends.shape[0], np.iinfo(np.int64).min)
    np.maximum.at(mx, inv, price)
    join_end = np.where(ts % Q7_W == 0, ts, own_end)
    pos = np.searchsorted(ends, join_end)
    ok = (pos < ends.shape[0])
    ok[ok] &= ends[pos[ok]] == join_end[ok]
    ok[ok] &= mx[pos[ok]] == price[ok]
    return Counter(zip(auction[ok].tolist(), price[ok].tolist(),
                       bidder[ok].tolist(), ts[ok].tolist(),
                       join_end[ok].tolist()))


# ------------------------------------------------------------- K3 checks

def k3_invariants(before: ht.HashTable, key_cols, active, slots_k, n_k,
                  table_k, slots_p, n_p, table_p) -> dict:
    """What must hold between K3 and its plain version on the same input
    (K3 may order new keys differently inside a bucket). Raises on the
    first violation; returns the measured quantities."""
    S = ht.BUCKET_SLOTS
    B = before.capacity // S
    fill_k = table_k.occupied.view(B, S).sum(1)
    fill_p = table_p.occupied.view(B, S).sum(1)
    fill_diff = int((fill_k - fill_p).abs().max())
    if fill_diff:
        raise AssertionError(f"K3 per-bucket fill differs by {fill_diff}")

    def unresolved_keys(slots):
        bad = active & (slots < 0)
        if not bool(bad.any()):
            return 0
        ks = torch.stack([k[bad].to(torch.int64) for k in key_cols], 1)
        return int(torch.unique(ks, dim=0).shape[0])

    uk, up = unresolved_keys(slots_k), unresolved_keys(slots_p)
    if uk != up:
        raise AssertionError(f"K3 distinct unresolved keys {uk} != {up}")
    if (int(n_k) > 0) != (int(n_p) > 0):
        raise AssertionError(f"K3 n_unresolved {int(n_k)} vs {int(n_p)}")
    # rows with equal keys get equal slots
    ks = torch.stack([k.to(torch.int64) for k in key_cols], 1)[active]
    sl = slots_k[active].to(torch.int64)
    uniq, inv = torch.unique(ks, dim=0, return_inverse=True)
    smin = torch.full((uniq.shape[0],), 2**40,
                      device=sl.device).scatter_reduce(0, inv, sl, "amin")
    smax = torch.full((uniq.shape[0],), -2**40,
                      device=sl.device).scatter_reduce(0, inv, sl, "amax")
    if bool((smin != smax).any()):
        raise AssertionError("K3 gave rows with equal keys different slots")
    # existing keys keep their slot; resolved rows point at their key
    pre = ht.lookup(before, key_cols, active)
    had = pre >= 0
    if bool((slots_k[had] != pre[had]).any()):
        raise AssertionError("K3 moved an existing key")
    ok = active & (slots_k >= 0)
    for tk, k in zip(table_k.keys, key_cols):
        if bool((tk[slots_k[ok].long()] != k[ok]).any()):
            raise AssertionError("K3 slot does not hold its row's key")
    # the same keys land in the same buckets when nothing overflowed
    if int(n_p) == 0:
        def bucket_keys(table):
            occ = table.occupied
            idx = torch.nonzero(occ)[:, 0]
            cols = [idx // S] + [tk[idx].to(torch.int64) for tk in table.keys]
            return torch.unique(torch.stack(cols, 1), dim=0)
        bk, bp = bucket_keys(table_k), bucket_keys(table_p)
        if bk.shape != bp.shape or bool((bk != bp).any()):
            raise AssertionError("K3 placed keys in other buckets")
    return {"fill_diff": fill_diff, "unresolved_keys": uk,
            "n_unresolved_kernel": int(n_k), "n_unresolved_plain": int(n_p),
            "existing_rows": int(had.sum())}


# ------------------------------------------------------------- timing

# cycles the card sleeps while the host queues a timed batch (~0.1 s)
GATE_CYCLES = 200_000_000


def time_ms(fn, setup=None, reps: int = 20,
            warmup: int = 3) -> tuple[float, bool]:
    """(median device time of fn() in ms, whether the host queued every
    call ahead of the card), by CUDA events around each call.

    The card first sleeps (torch.cuda._sleep) while the host queues all
    reps, so the events bracket device work only, not the host's launch
    latency: a 10 us kernel behind 50 us of Python would otherwise time
    as 50 us. setup() runs before each call, outside its events. If the
    host could not queue everything before the sleep ended (a plain
    version that syncs, say), the time includes host waits and the flag
    is False."""
    for _ in range(warmup):
        if setup:
            setup()
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    gate = torch.cuda.Event()
    torch.cuda._sleep(GATE_CYCLES)
    gate.record()
    for s, e in zip(starts, ends):
        if setup:
            setup()
        s.record()
        fn()
        e.record()
    ahead = not gate.query()
    torch.cuda.synchronize()
    return (statistics.median(s.elapsed_time(e)
                              for s, e in zip(starts, ends)), ahead)


def timings(kernel_fn, plain_fn, setup=None, library_fn=None) -> dict:
    """Kernel, plain and library times, with the queued-ahead flags."""
    ms, k_ok = time_ms(kernel_fn, setup)
    plain_ms, p_ok = time_ms(plain_fn, setup, reps=5)
    library_ms, l_ok = (time_ms(library_fn) if library_fn is not None
                        else (None, None))
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                queued_ahead={"ms": k_ok, "plain_ms": p_ok,
                              "library_ms": l_ok})


def max_diff(xs, ys) -> int:
    """Largest absolute difference between paired integer tensors."""
    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
               for x, y in zip(xs, ys))


def bytes_bound_ms(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


_T0 = time.monotonic()


def emit(obj) -> None:
    """Print obj as a JSON line; a phase's line also gets at_s, the
    seconds since the script started (so each phase's share of the run
    is the difference of two lines)."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.monotonic() - _T0}
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


# ------------------------------------------------------------- phases

def phase_kernels(dev, n: int = 131072, C: int = 1 << 20) -> dict:
    """Each kernel against its plain version at q5's shapes (bids per
    chunk n, agg capacity C)."""
    cfg = NexmarkConfig(inter_event_us=2)
    gen = NexmarkGenerator("bid", chunk_size=n, cfg=cfg, device=dev)
    vocabs = gen.vocabs
    res = {}

    # ---- K1: bid columns at offsets 0 and ~1e12, and with runtime
    # moduli that are not q5's
    err = 0
    odd = NexmarkConfig(inter_event_us=50_000, in_flight_auctions=97,
                        num_active_people=1009)
    for off, c in ((0, cfg), (10**12 + 7, cfg), (987_654_321, odd)):
        err = max(err, max_diff(gen_bid_columns(off, n, c, vocabs, dev),
                                gen_bid_columns_plain(off, n, c, vocabs,
                                                      dev)))
    if err:
        raise AssertionError(f"K1 differs from plain by {err}")
    off = 10**9
    res["nexmark_bid"] = dict(
        max_abs_err=err,
        **timings(lambda: gen_bid_columns(off, n, cfg, vocabs, dev),
                  lambda: gen_bid_columns_plain(off, n, cfg, vocabs, dev)),
        bound_ms=bytes_bound_ms(n * (4 * 8 + 3 * 4)), bound_by="bytes")
    emit({"phase": "kernel", "name": "nexmark_bid", **res["nexmark_bid"]})

    # ---- K2: hop expansion of a bid chunk with q5's pruning; a slide
    # that does not divide the size; every column (int32 dictionary ids)
    # with a NULL mask and invisible rows
    chunk = gen.next_chunk()
    g = torch.Generator(device="cpu").manual_seed(3)
    cols_nulls = list(chunk.columns)
    cols_nulls[3] = Column(cols_nulls[3].data,
                           (torch.rand(n, generator=g) < 0.7).to(dev))
    vis_some = (torch.rand(n, generator=g) < 0.9).to(dev)
    err = 0
    for columns, vis_in, slide, out_idx in (
            (chunk.columns, chunk.vis, SLIDE_US, Q5_OUTPUT_INDICES),
            (chunk.columns, chunk.vis, 3_000_000, Q5_OUTPUT_INDICES),
            (cols_nulls, vis_some, SLIDE_US, tuple(range(9)))):
        K = math.ceil(SIZE_US / slide)
        hop_args = (columns, chunk.ops, vis_in, 5, slide, SIZE_US, K,
                    out_idx)
        a, b = hop_expand(*hop_args), hop_expand_plain(*hop_args)
        err = max(err, max_diff(
            [c.data for c in a[0]] + [c.valid for c in a[0]
                                      if c.valid is not None] + [a[1], a[2]],
            [c.data for c in b[0]] + [c.valid for c in b[0]
                                      if c.valid is not None] + [b[1], b[2]]))
    if err:
        raise AssertionError(f"K2 differs from plain by {err}")
    K = SIZE_US // SLIDE_US
    args = (chunk.columns, chunk.ops, chunk.vis, 5, SLIDE_US, SIZE_US, K,
            Q5_OUTPUT_INDICES)
    res["hop_window"] = dict(
        max_abs_err=err,
        **timings(lambda: hop_expand(*args), lambda: hop_expand_plain(*args)),
        bound_ms=bytes_bound_ms(n * (8 + 8 + 1 + 1) + K * n * (8 + 8 + 1 + 1)),
        bound_by="bytes")
    emit({"phase": "kernel", "name": "hop_window", **res["hop_window"]})

    # ---- K3: into a 2^20 table pre-filled to ~0.5 load
    cols, ops, vis = hop_expand(*args)
    key_cols = [cols[0].data.contiguous(), cols[1].data.contiguous()]
    base = ht.HashTable.empty(C, [torch.int64, torch.int64], dev)
    g = torch.Generator(device="cpu").manual_seed(5)
    pre = torch.randint(0, 1 << 40, (C // 2,), generator=g).to(dev)
    ht.lookup_or_insert_plain(base, [pre, pre ^ 0x5555], torch.ones(
        C // 2, dtype=torch.bool, device=dev))
    checks = []

    def clone(t: ht.HashTable) -> ht.HashTable:
        return ht.HashTable(tuple(k.clone() for k in t.keys),
                            t.occupied.clone())

    def run_case(before, kc, act):
        tk, tp = clone(before), clone(before)
        _, sk, nk = ht.lookup_or_insert(tk, kc, act)
        _, sp, np_ = ht.lookup_or_insert_plain(tp, kc, act)
        checks.append(k3_invariants(before, kc, act, sk, nk, tk, sp, np_, tp))
        return tk

    after = run_case(base, key_cols, vis)    # the chunk's keys are new
    run_case(after, key_cols, vis)           # now every key exists
    # forced overflow: 4096 distinct keys into 1024 slots
    small = ht.HashTable.empty(1024, [torch.int64, torch.int64], dev)
    ov = torch.arange(4096, device=dev, dtype=torch.int64)
    run_case(small, [ov, ov * 3], torch.ones(4096, dtype=torch.bool,
                                             device=dev))
    if not checks[2]["n_unresolved_kernel"]:
        raise AssertionError("K3 forced-overflow case reported no overflow")
    # int64 + int32 keys with negatives, some rows inactive
    mixed = ht.HashTable.empty(4096, [torch.int64, torch.int32], dev)
    ka = torch.randint(-50, 50, (20000,), generator=g).to(dev)
    kb = torch.randint(-3, 4, (20000,), generator=g,
                       dtype=torch.int32).to(dev)
    run_case(mixed, [ka, kb], (torch.rand(20000, generator=g) < 0.8).to(dev))
    work = clone(base)

    def restore():
        for a, b in zip(work.keys, base.keys):
            a.copy_(b)
        work.occupied.copy_(base.occupied)

    N = key_cols[0].shape[0]
    ks = torch.stack(key_cols, 1)[vis]
    n_distinct = int(torch.unique(ks, dim=0).shape[0])
    k3_bytes = (N * (8 + 8 + 1) + N * 4 + n_distinct * 2 * 16 * (8 + 8 + 1)
                + n_distinct * (8 + 8 + 1))
    res["hash_table"] = dict(
        max_abs_err=max(c["fill_diff"] for c in checks),
        **timings(lambda: ht.lookup_or_insert(work, key_cols, vis),
                  lambda: ht.lookup_or_insert_plain(work, key_cols, vis),
                  setup=restore),
        bound_ms=bytes_bound_ms(k3_bytes), bound_by="bytes",
        distinct_keys=n_distinct, checks=checks)
    emit({"phase": "kernel", "name": "hash_table", **res["hash_table"]})

    # ---- K4: apply the chunk's slots to a zeroed 2^20 count state
    t3 = clone(base)
    _, slots, n_un = ht.lookup_or_insert(t3, key_cols, vis)
    spec = count_star(append_only=True).spec()

    def fresh_state():
        return AggState(
            table=t3, agg_states=(spec.init_state(C, dev),),
            row_count=torch.zeros(C, dtype=torch.int64, device=dev),
            dirty=torch.zeros(C, dtype=torch.bool, device=dev),
            prev_exists=torch.zeros(C, dtype=torch.bool, device=dev),
            prev_emit=(torch.zeros(C, dtype=torch.int64, device=dev),))

    sk, sp = fresh_state(), fresh_state()
    ovk = torch.zeros((), dtype=torch.int32, device=dev)
    ovp = torch.zeros((), dtype=torch.int32, device=dev)
    inputs = [(None, None)]
    agg_apply(sk, [spec], slots, ops, inputs, n_un, ovk)
    agg_apply_plain(sp, [spec], slots, ops, inputs, n_un, ovp)
    err = max(int((sk.row_count - sp.row_count).abs().max()),
              int((sk.agg_states[0] - sp.agg_states[0]).abs().max()),
              int((sk.dirty != sp.dirty).sum()), int((ovk - ovp).abs()))
    err = max(err, k4_all_kinds_err(dev))
    if err:
        raise AssertionError(f"K4 differs from plain by {err}")
    st = fresh_state()
    ov = torch.zeros((), dtype=torch.int32, device=dev)

    def zero():
        st.row_count.zero_()
        st.agg_states[0].zero_()
        st.dirty.zero_()

    seg = torch.where(slots >= 0, slots, C).long()
    signs = torch.where(slots >= 0, 1, 0).to(torch.int64)
    rc_pad = torch.zeros(C + 1, dtype=torch.int64, device=dev)
    n_slots = int(torch.unique(slots[slots >= 0]).shape[0])
    res["hash_agg"] = dict(
        max_abs_err=err,
        **timings(lambda: agg_apply(st, [spec], slots, ops, inputs, n_un, ov),
                  lambda: agg_apply_plain(st, [spec], slots, ops, inputs,
                                          n_un, ov),
                  setup=zero,
                  library_fn=lambda: rc_pad.index_add_(0, seg, signs)),
        bound_ms=bytes_bound_ms(N * (4 + 1) + n_slots * (16 + 16 + 1)),
        bound_by="bytes", touched_slots=n_slots)
    emit({"phase": "kernel", "name": "hash_agg", **res["hash_agg"]})
    return res


def k4_all_kinds_err(dev) -> int:
    """K4 vs plain with every agg kind, NULLs and deletes (float SUM
    within a relative 1e-12: atomics add in another order)."""
    from risingwave_tpu_torch.expr.agg import agg_max, agg_min, agg_sum
    C, N = 4096, 65536
    g = torch.Generator(device="cpu").manual_seed(9)
    slots = torch.randint(-1, 64, (N,), generator=g).to(torch.int32).to(dev)
    ops = torch.randint(0, 4, (N,), generator=g).to(torch.int8).to(dev)
    iv = torch.randint(-10**6, 10**6, (N,), generator=g).to(dev)
    fv = (torch.rand(N, generator=g, dtype=torch.float64) * 100).to(dev)
    valid = (torch.rand(N, generator=g) < 0.8).to(dev)
    calls = [count_star(), agg_sum(0), agg_sum(1, DataType.FLOAT64),
             agg_min(0, append_only=True), agg_max(1, DataType.FLOAT64,
                                                   append_only=True),
             agg_sum(2)]
    specs = [c.spec() for c in calls]
    i32 = iv.to(torch.int32)
    inputs = [(None, None), (iv, valid), (fv, None), (iv, valid), (fv, None),
              (i32, None)]
    n_un = torch.tensor(3, dtype=torch.int32, device=dev)
    states = []
    for fn in (agg_apply, agg_apply_plain):
        st = AggState(
            table=ht.HashTable.empty(C, [torch.int64], dev),
            agg_states=tuple(s.init_state(C, dev) for s in specs),
            row_count=torch.zeros(C, dtype=torch.int64, device=dev),
            dirty=torch.zeros(C, dtype=torch.bool, device=dev),
            prev_exists=torch.zeros(C, dtype=torch.bool, device=dev),
            prev_emit=())
        ov = torch.zeros((), dtype=torch.int32, device=dev)
        fn(st, specs, slots, ops, inputs, n_un, ov)
        states.append((st, ov))
    (a, oa), (b, ob) = states
    err = int((a.row_count - b.row_count).abs().max())
    err = max(err, int((a.dirty != b.dirty).sum()), int((oa - ob).abs()))
    for j, (x, y) in enumerate(zip(a.agg_states, b.agg_states)):
        if x.dtype == torch.float64 and j == 2:
            rel = ((x - y).abs() / y.abs().clamp(min=1e-300)).max()
            if float(rel) > 1e-12:
                err = max(err, 1)
        else:
            err = max(err, int((x != y).sum()))
    return err


# ---------------------------------------------------------- q7 kernels

def exact_err(xs, ys) -> int:
    """0 when every paired tensor is bit-identical (floats compared as
    their bits), else the largest absolute difference, at least 1."""
    err = 0
    for x, y in zip(xs, ys):
        if x is None and y is None:
            continue
        if x is None or y is None or x.shape != y.shape \
                or x.dtype != y.dtype:
            return max(err, 1)
        if x.dtype == torch.float64:
            x, y = x.view(torch.int64), y.view(torch.int64)
        ne = x != y
        if bool(ne.any()):
            d = (x.double() - y.double()).abs().max()
            err = max(err, 1, int(d))
    return err


def columns_err(xs, ys) -> int:
    return exact_err([c.data for c in xs] + [c.valid for c in xs],
                     [c.data for c in ys] + [c.valid for c in ys])


def store_err(a: SortedSideState, b: SortedSideState) -> int:
    return exact_err([a.khash, a.degree, a.n, *a.cols, *a.valids],
                     [b.khash, b.degree, b.n, *b.cols, *b.valids])


def _store_row_bytes(st: SortedSideState) -> int:
    return 8 + 4 + sum(c.element_size() + 1 for c in st.cols)


def k5_mixed_err(dev, n: int) -> int:
    """K5 against the tree walk over every ported function: NULLs,
    negative timestamps, int32 wrap, int/float promotion, Kleene logic."""
    g = torch.Generator().manual_seed(11)
    TS, I64, I32, F64, B = (DataType.TIMESTAMP, DataType.INT64,
                            DataType.INT32, DataType.FLOAT64,
                            DataType.BOOLEAN)
    a = torch.randint(-10**6, 10**6, (n,), generator=g)
    c = torch.randint(-2**31, 2**31, (n,), generator=g).to(torch.int32)
    f = torch.randint(-4000, 4000, (n,), generator=g) / 8.0
    p = torch.rand(n, generator=g) < 0.5
    ts = torch.randint(-50_000_000, 50_000_000, (n,), generator=g)

    def null():
        return (torch.rand(n, generator=g) < 0.8).to(dev)

    cols = [Column(a.to(dev), null()), Column(c.to(dev), null()),
            Column(f.to(dev).double(), null()), Column(p.to(dev), null()),
            Column(ts.to(dev), null())]
    ca, cc, cf, cp, cts = (col(0, I64), col(1, I32), col(2, F64),
                           col(3, B), col(4, TS))
    exprs = [call("add", ca, cf), call("multiply", cc, cc),
             call("subtract", ca, lit(7)), call("less_than", ca, cf),
             call("and", cp, call("greater_than", ca, lit(0))),
             call("or", cp, lit(None, B)), call("not", cp),
             call("is_null", cf), call("tumble_start", cts, lit(Q7_W)),
             call("tumble_end", cts, lit(7_000_000)),
             FuncCall("cast", (cf,), I64), FuncCall("cast", (ca,), F64),
             FuncCall("cast", (ca,), I32), FuncCall("cast", (ca,), B)]
    err = 0
    for at in (0, 7):                  # two launches within K5's limits
        prog = ExprProgram(exprs[at:at + 7])
        err = max(err, columns_err(prog.eval(cols), prog.eval_plain(cols)))
    return err


def phase_kernels_q7(dev, n: int = 131072, join_cap: int = Q7_JOIN_CAPACITY,
                     agg_cap: int = Q7_AGG_CAPACITY) -> dict:
    """K5-K8 against their plain versions at q7's shapes (bids per chunk
    n, join capacity join_cap, agg capacity agg_cap), plus K3/K4 at the
    agg's shape and the two plain-torch sorts (B6) of the join."""
    cfg = NexmarkConfig(inter_event_us=250)
    gen = NexmarkGenerator("bid", chunk_size=n, cfg=cfg, device=dev)
    gen.seek(40 * n)
    prev_chunk = gen.next_chunk()
    chunk = gen.next_chunk()
    res = {}
    TS = DataType.TIMESTAMP
    M = 2 * n
    on_card = torch.device(dev).type == "cuda"

    # ---- K8: row ids of a chunk
    base = (2 << 55) | (1_000_000_000 << 15)
    err = exact_err([row_ids(base, n, dev)], [row_ids_plain(base, n, dev)])
    if err:
        raise AssertionError(f"K8 differs from plain by {err}")
    res["row_id"] = dict(
        max_abs_err=err,
        **timings(lambda: row_ids(base, n, dev),
                  lambda: row_ids_plain(base, n, dev),
                  library_fn=lambda: torch.arange(
                      base, base + n, dtype=torch.int64, device=dev)),
        bound_ms=bytes_bound_ms(n * 8), bound_by="bytes")
    emit({"phase": "kernel", "name": "row_id", **res["row_id"]})

    # ---- K5: q7's TUMBLE projection, every function with NULLs, and
    # the band condition in mask mode over a [2n] match buffer
    tumble = ExprProgram([call("tumble_start", col(5, TS), lit(Q7_W)),
                          call("tumble_end", col(5, TS), lit(Q7_W))])
    err = columns_err(tumble.eval(chunk.columns)[0:2],
                      tumble.eval_plain(chunk.columns)[0:2])
    err = max(err, k5_mixed_err(dev, n))
    g = torch.Generator().manual_seed(13)
    t3 = torch.randint(0, 40_000_000, (M,), generator=g).to(dev)
    t6 = (t3.cpu() + torch.randint(-15_000_000, 15_000_000, (M,),
                                   generator=g)).to(dev)
    band_cols = [Column(torch.zeros(M, dtype=torch.int64, device=dev))] * 3
    band_cols += [Column(t3, (torch.rand(M, generator=g) < 0.9).to(dev)),
                  Column(torch.zeros(M, dtype=torch.int64, device=dev)),
                  Column(torch.zeros(M, dtype=torch.int64, device=dev)),
                  Column(t6, (torch.rand(M, generator=g) < 0.9).to(dev))]
    band = ExprProgram([call("and",
                             call("greater_than", col(3, TS),
                                  call("subtract", col(6, TS), lit(Q7_W))),
                             call("less_than_or_equal", col(3, TS),
                                  col(6, TS)))])
    start = (torch.rand(M, generator=g) < 0.7).to(dev)
    mk, mp = start.clone(), start.clone()
    band.and_into(band_cols, mk)
    band.and_into_plain(band_cols, mp)
    err = max(err, exact_err([mk], [mp]))
    if err:
        raise AssertionError(f"K5 differs from plain by {err}")
    res["expr_eval"] = dict(
        max_abs_err=err,
        **timings(lambda: tumble.eval(chunk.columns),
                  lambda: tumble.eval_plain(chunk.columns)),
        bound_ms=bytes_bound_ms(n * 8 + 2 * n * 8), bound_by="bytes")
    emit({"phase": "kernel", "name": "expr_eval", **res["expr_eval"]})

    # ---- the join's two sides as the pipeline holds them: a left store
    # of the previous chunk's bids, a right store of (max price, window)
    # rows whose prices are the chunk's
    def left_cols(ch, first_id):
        c = ch.columns
        return [c[0].data, c[1].data, c[2].data, c[5].data,
                row_ids_plain(first_id, ch.capacity, dev)]

    lcols = left_cols(chunk, 1 << 40)
    left_store = store_from_rows(left_cols(prev_chunk, 0), join_cap)
    n_right = max(16, n // 512)
    pick = torch.randint(0, n, (n_right,), generator=g).to(dev)
    right_store = store_from_rows(
        [lcols[2][pick], (torch.arange(n_right, device=dev) + 1) * Q7_W],
        join_cap)

    # ---- K6: left chunk probing the right store; a right flush chunk
    # probing the left store; a hot key past the match buffer
    def probe_case(key_cols, active, is_ins, ops, other, other_key_idx,
                   own, m):
        ek = torch.zeros(3, dtype=torch.int32, device=dev)
        ep = torch.zeros(3, dtype=torch.int32, device=dev)
        a = probe(key_cols, active, is_ins, ops, other, other_key_idx, own,
                  m, ek, _Buffers(torch.device(dev)))
        b = probe_plain(key_cols, active, is_ins, ops, other, other_key_idx,
                        own, m, ep)
        e = exact_err([*a[:2], a[4], a[5], ek], [*b[:2], b[4], b[5], ep])
        e = max(e, columns_err(a[2] + a[3], b[2] + b[3]))
        return e, int(b[5].sum()), int(ep[0])

    own_l = [Column(x) for x in lcols]
    vis = chunk.vis
    err, matches, _ = probe_case([lcols[2]], vis, vis, chunk.ops,
                                 right_store, (0,), own_l, M)
    nr = 2 * agg_cap
    rk = lcols[2][:nr].clone()
    rops = torch.tensor([2, 3], dtype=torch.int8).repeat(nr // 2).to(dev)
    ract = (torch.rand(nr, generator=g) < 0.9).to(dev)
    own_r = [Column(rk), Column(lcols[3][:nr].clone())]
    e2, _, _ = probe_case([rk], ract, ract, rops, left_store, (2,), own_r,
                          2 * nr)
    hot_store = store_from_rows(
        [torch.full((3000,), 7, dtype=torch.int64, device=dev),
         torch.arange(3000, dtype=torch.int64, device=dev)], 4096)
    hk = torch.full((100,), 7, dtype=torch.int64, device=dev)
    hv = torch.ones(100, dtype=torch.bool, device=dev)
    e3, _, hot_over = probe_case(
        [hk], hv, hv, torch.zeros(100, dtype=torch.int8, device=dev),
        hot_store, (0,), [Column(hk)], 200 * 1000)
    err = max(err, e2, e3)
    if err or hot_over != 100 * 3000 - 200 * 1000:
        raise AssertionError(f"K6 differs from plain by {err} "
                             f"(hot-key overflow {hot_over})")
    errs = torch.zeros(3, dtype=torch.int32, device=dev)
    bufs = _Buffers(torch.device(dev))
    pargs = ([lcols[2]], vis, vis, chunk.ops, right_store, (0,), own_l, M)
    # what K6 must move on this data: per chunk row its key, active,
    # is_ins and op in and h/ins_h/lo/offs out; the chunk rows that match
    # (plus row N-1, which the unused slots gather) and the other side's
    # rows they match, each read once; the [M] buffer written once. The
    # binary searches touch a few KB of the other side's khash: not
    # counted.
    live_r = right_store.cols[0][: int(right_store.n)]
    own_rows = int((vis & torch.isin(lcols[2], live_r)).sum()) + 1
    oth_rows = int(torch.isin(live_r, lcols[2][vis]).sum())
    own_row_b = sum(c.element_size() for c in lcols)
    oth_row_b = sum(c.element_size() + 1 for c in right_store.cols)
    k6_bytes = (n * (8 + 1 + 1 + 1) + n * 4 * 8 + own_rows * own_row_b
                + oth_rows * oth_row_b + M * (own_row_b + oth_row_b + 2))
    res["sorted_join_probe"] = dict(
        max_abs_err=err,
        **timings(lambda: probe(*pargs, errs, bufs),
                  lambda: probe_plain(*pargs, errs)),
        bound_ms=bytes_bound_ms(k6_bytes), bound_by="bytes",
        matches=matches, matched_rows=(own_rows - 1, oth_rows),
        hot_key_overflow=hot_over)
    emit({"phase": "kernel", "name": "sorted_join_probe",
          **res["sorted_join_probe"]})

    # ---- K7: the chunk merged into the left store with inline eviction;
    # a retracting right side (update pairs, deletes of absent rows);
    # row overflow; eviction alone
    def merge_case(own, nh, iorder, n_new, cols, is_del, h, m, match,
                   clean, wm):
        ek = torch.zeros(3, dtype=torch.int32, device=dev)
        ep = torch.zeros(3, dtype=torch.int32, device=dev)
        spare = empty_sorted_side(own.capacity,
                                  [c.dtype for c in own.cols], dev)
        # a used second store: its stale rows must be cleared
        spare.khash.fill_(5)
        spare.degree.fill_(9)
        for c, v in zip(spare.cols, spare.valids):
            c.fill_(3)
            v.fill_(True)
        spare.n.fill_(own.capacity)
        a = merge(own, nh, iorder, n_new, cols, is_del, h, m, match, clean,
                  wm, ek, spare if on_card else None,
                  _Buffers(torch.device(dev)))
        b = merge_plain(own, nh, iorder, n_new, cols, is_del, h, m, match,
                        clean, wm, ep)
        return max(store_err(a, b), exact_err([ek], [ep])), ep

    lkh = key_hash([lcols[2]])
    nh, iorder = torch.sort(lkh, stable=True)
    n_new = torch.tensor(n, dtype=torch.int32, device=dev)
    chunk_cols = [Column(x) for x in lcols]
    wm = int(left_store.cols[3][: int(left_store.n)].median())
    err, _ = merge_case(left_store, nh, iorder, n_new, chunk_cols, None,
                        None, M, (2, 4), 3, wm)
    # right side: update pairs on stored windows, deletes of absent ones
    rs = right_store
    nrs = int(rs.n)
    pk = torch.cat([rs.cols[1][:nrs], rs.cols[1][:nrs],
                    rs.cols[1][:nrs] + 1])
    price = torch.cat([rs.cols[0][:nrs], rs.cols[0][:nrs] + 1,
                       rs.cols[0][:nrs]])
    uops = torch.cat([torch.full((nrs,), 2, dtype=torch.int8),
                      torch.full((nrs,), 3, dtype=torch.int8),
                      torch.full((nrs,), 1, dtype=torch.int8)]).to(dev)
    order = torch.arange(3 * nrs, device=dev).view(3, nrs).t().reshape(-1)
    rchunk = StreamChunk((Column(price[order]), Column(pk[order])),
                         uops[order],
                         torch.ones(3 * nrs, dtype=torch.bool, device=dev),
                         None)
    _, is_ins, is_del, _ = net_pk_runs(rchunk, rchunk.vis, (1,))
    rh = key_hash([rchunk.columns[0].data])
    rnh, rio = torch.sort(torch.where(is_ins, rh, HSENTINEL), stable=True)
    e2, rerrs = merge_case(rs, rnh, rio, is_ins.sum(dtype=torch.int32),
                           list(rchunk.columns), is_del, rh, 6 * nrs,
                           (0, 1), 1, 2 * Q7_W)
    small = store_from_rows([lcols[2][:40], lcols[3][:40]], 64)
    e3, oerrs = merge_case(small, nh[:32], torch.arange(32, device=dev),
                           torch.tensor(32, dtype=torch.int32, device=dev),
                           [Column(lcols[2][:32]), Column(lcols[3][:32])],
                           None, None, 64, (0,), None, NO_WATERMARK)
    empty = torch.empty(0, dtype=torch.int64, device=dev)
    e4, _ = merge_case(left_store, empty, empty,
                       torch.zeros((), dtype=torch.int32, device=dev), (),
                       None, None, 1, (), 3, wm)
    err = max(err, e2, e3, e4)
    merrs = [int(x) for x in (rerrs + oerrs).cpu()]
    # misses: the deletes of absent windows and the update pairs of the
    # windows that the inline eviction removed first
    want_miss = nrs + int((rs.cols[1][:nrs] < 2 * Q7_W).sum())
    if err or merrs[1] != want_miss or merrs[2] != 8:
        raise AssertionError(f"K7 differs from plain by {err} "
                             f"(errs {merrs})")
    spare = empty_sorted_side(join_cap, [c.dtype for c in lcols], dev)
    errs = torch.zeros(3, dtype=torch.int32, device=dev)
    margs = (left_store, nh, iorder, n_new, chunk_cols, None, None, M,
             (2, 4), 3, wm)
    out = merge_plain(*margs, errs.clone())
    n_live, n_after = int(left_store.n), int(out.n)
    k7_bytes = (n_live * _store_row_bytes(left_store)
                + n * (8 + 8 + sum(c.element_size() for c in lcols))
                + n_after * _store_row_bytes(left_store))
    res["sorted_join_merge"] = dict(
        max_abs_err=err,
        **timings(lambda: merge(*margs, errs, spare if on_card else None,
                                bufs),
                  lambda: merge_plain(*margs, errs)),
        bound_ms=bytes_bound_ms(k7_bytes), bound_by="bytes",
        rows_before=n_live, rows_after=n_after, errs=merrs)
    emit({"phase": "kernel", "name": "sorted_join_merge",
          **res["sorted_join_merge"]})

    # ---- K11 at q7's shapes: the join's sort of a bid chunk's hashes
    # and the right side's pk-run netting of an agg flush chunk, against
    # torch.sort
    ins_h = torch.where(vis, lkh, HSENTINEL)
    flush = StreamChunk(tuple(own_r), rops, ract, None)
    pk = flush.columns[1].data
    net_keys = [pk, (~ract).to(torch.uint8)]
    err = exact_err(list(stable_sort(ins_h, 63)),
                    list(stable_sort_plain(ins_h)))
    err = max(err, exact_err([stable_lexsort(net_keys, [64, 1])],
                             [stable_lexsort([k.cpu() for k in net_keys])
                              .to(dev)]))
    if err:
        raise AssertionError(f"K11 at q7's shapes differs by {err}")
    res["k11_at_q7"] = dict(
        max_abs_err=err, sort_rows=n, net_rows=nr,
        sort=timings(lambda: stable_sort(ins_h, 63),
                     lambda: stable_sort_plain(ins_h)),
        net=timings(lambda: net_pk_runs(flush, ract, (1,)),
                    lambda: [torch.argsort(k, stable=True)
                             for k in net_keys]))
    emit({"phase": "k11_at_q7", **res["k11_at_q7"]})

    # ---- K3/K4 at the agg's shape: window_end keys of one chunk (a few
    # windows, one hot) into an 8192-slot table, MAX(price)
    wend = tumble.eval(chunk.columns)[1].data.contiguous()
    base_t = ht.HashTable.empty(agg_cap, [torch.int64], dev)
    work = ht.HashTable(tuple(k.clone() for k in base_t.keys),
                        base_t.occupied.clone())
    tk, tp = (ht.HashTable(tuple(k.clone() for k in base_t.keys),
                           base_t.occupied.clone()) for _ in range(2))
    _, sk, nk = ht.lookup_or_insert(tk, [wend], vis)
    _, sp, np_ = ht.lookup_or_insert_plain(tp, [wend], vis)
    inv = k3_invariants(base_t, [wend], vis, sk, nk, tk, sp, np_, tp)

    def restore():
        work.keys[0].copy_(base_t.keys[0])
        work.occupied.copy_(base_t.occupied)

    spec = agg_max(1, DataType.INT64, append_only=True).spec()

    def fresh():
        return AggState(
            table=tk, agg_states=(spec.init_state(agg_cap, dev),),
            row_count=torch.zeros(agg_cap, dtype=torch.int64, device=dev),
            dirty=torch.zeros(agg_cap, dtype=torch.bool, device=dev),
            prev_exists=torch.zeros(agg_cap, dtype=torch.bool, device=dev),
            prev_emit=(torch.zeros(agg_cap, dtype=torch.int64,
                                   device=dev),))

    inputs = [(chunk.columns[2].data, None)]
    sa, sb = fresh(), fresh()
    ova = torch.zeros((), dtype=torch.int32, device=dev)
    ovb = torch.zeros((), dtype=torch.int32, device=dev)
    agg_apply(sa, [spec], sk, chunk.ops, inputs, nk, ova)
    agg_apply_plain(sb, [spec], sk, chunk.ops, inputs, nk, ovb)
    k4_err = exact_err([sa.row_count, sa.agg_states[0], sa.dirty, ova],
                       [sb.row_count, sb.agg_states[0], sb.dirty, ovb])
    if k4_err or inv["fill_diff"]:
        raise AssertionError(f"K3/K4 at q7's shape differ: {k4_err}, {inv}")
    st = fresh()
    ov = torch.zeros((), dtype=torch.int32, device=dev)

    def zero():
        st.row_count.zero_()
        st.agg_states[0].fill_(spec.init)
        st.dirty.zero_()

    n_groups = int(torch.unique(wend).shape[0])
    res["agg_at_q7"] = dict(
        groups=n_groups, k3_checks=inv, k4_max_abs_err=k4_err,
        hash_table=timings(lambda: ht.lookup_or_insert(work, [wend], vis),
                           lambda: ht.lookup_or_insert_plain(work, [wend],
                                                             vis),
                           setup=restore),
        hash_agg=timings(lambda: agg_apply(st, [spec], sk, chunk.ops, inputs,
                                           nk, ov),
                         lambda: agg_apply_plain(st, [spec], sk, chunk.ops,
                                                 inputs, nk, ov),
                         setup=zero),
        hash_table_bound_ms=bytes_bound_ms(
            n * (8 + 1 + 4) + n_groups * 2 * 16 * (8 + 1)),
        hash_agg_bound_ms=bytes_bound_ms(n * (4 + 1 + 8)
                                         + n_groups * (16 + 8 + 1)))
    emit({"phase": "agg_at_q7", **res["agg_at_q7"]})
    return res


# -------------------------------------------------------------- q7 runs

def q7_full_run(dev, chunk: int, per_barrier: int, rounds: int,
                want_misses: int) -> dict:
    """One full-width q7 run from fresh state: counts set to 0 just
    before the drive and read just after. The join must count exactly
    `want_misses` delete misses (q7_delete_misses) and nothing else."""
    q7 = build_q7(dev, chunk, 250, per_barrier)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    wall = asyncio.run(drive_paced(q7, per_barrier, rounds))
    launches = {k.name: k.launches for k in kernels.KERNELS.values()}
    torch.cuda.synchronize()
    errs = q7["join"].errs()
    overflow = q7["agg"].overflow()
    if errs != [0, want_misses, 0] or overflow:
        raise AssertionError(f"q7: join errs {errs} (want [0, "
                             f"{want_misses}, 0]), agg overflow {overflow}")
    missing = [k for k in Q7_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on q7: {missing}")
    coord = q7["coord"]
    return dict(
        bids=q7["gen"].offset, wall_s=wall,
        bids_per_s=q7["gen"].offset / wall,
        barrier_p50_s=coord.barrier_latency_percentile(0.5),
        barrier_max_s=coord.barrier_latency_percentile(1.0),
        join_errs=errs, agg_overflow=overflow,
        left_rows=int(q7["join"].sides[0].n),
        right_rows=int(q7["join"].sides[1].n),
        sink_chunks=q7["head"].chunks,
        mem_peak_bytes=torch.cuda.max_memory_allocated(dev),
        launches=launches)


Q7_KERNELS = ("nexmark_bid", "expr_eval", "row_id", "hash_table",
              "hash_agg", "sorted_join_probe", "sorted_join_merge",
              "radix_sort", "compact")


def phase_q7_full(dev, repeats: int = 5) -> dict:
    """q7 at bench.py's width into the device blackhole sink, `repeats`
    times: the first run's launches feed the kernels line."""
    chunk = 131072
    per_barrier, rounds = 8 * chunk, 14
    want_misses = q7_delete_misses(per_barrier * rounds, per_barrier,
                                   NexmarkConfig(inter_event_us=250), dev)
    runs = [q7_full_run(dev, chunk, per_barrier, rounds, want_misses)
            for _ in range(repeats)]
    first = runs[0]
    rates = [r["bids_per_s"] for r in runs]
    return dict(
        bids=first["bids"], barriers=rounds, chunks=first["bids"] // chunk,
        repeats=repeats, wall_s=statistics.median(r["wall_s"] for r in runs),
        bids_per_s=statistics.median(rates), bids_per_s_min=min(rates),
        bids_per_s_max=max(rates), want_delete_misses=want_misses,
        barrier_p50_s=statistics.median(r["barrier_p50_s"] for r in runs),
        barrier_max_s=statistics.median(r["barrier_max_s"] for r in runs),
        runs=[{k: r[k] for k in ("wall_s", "bids_per_s", "barrier_p50_s",
                                 "barrier_max_s", "join_errs",
                                 "mem_peak_bytes")} for r in runs],
        **{k: first[k] for k in ("join_errs", "agg_overflow", "left_rows",
                                 "right_rows", "sink_chunks",
                                 "mem_peak_bytes", "launches")})


def phase_q7_profile(dev, full: dict, rounds: int = 3) -> dict:
    """Where q7's time goes: a fresh full-width run of a few barriers
    under torch.profiler; the idle share against phase q7_full's
    unprofiled median wall per chunk."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    chunk = 131072
    per_barrier = 8 * chunk
    q7 = build_q7(dev, chunk, 250, per_barrier)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = asyncio.run(drive_paced(q7, per_barrier, rounds))
        torch.cuda.synchronize()
    kev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict = {}
    for e in kev:
        name = e.name[:60]
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + e.time_range.elapsed_us(), c + 1)
    busy_s = sum(t for t, _ in by_name.values()) / 1e6
    chunks = q7["gen"].offset // chunk
    busy_per_chunk = busy_s / chunks
    wall_per_chunk = full["wall_s"] / full["chunks"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:16]
    return dict(
        rounds=rounds, chunks=chunks, wall_s=wall, device_busy_s=busy_s,
        device_busy_per_chunk_s=busy_per_chunk,
        unprofiled_wall_per_chunk_s=wall_per_chunk,
        device_idle_share=(1 - busy_per_chunk / wall_per_chunk)
        if kev else None,
        device_idle_share_profiled=(1 - busy_s / wall) if kev else None,
        device_events=len(kev),
        top_kernels=[{"name": nm, "ms": t / 1e3, "count": c}
                     for nm, (t, c) in top])


# ------------------------------------------------------------ q8 (SQL)

W = 10_000_000              # bench.py's TUMBLE window, microseconds
# bench.py's bench_q8 statements, verbatim (tests/test_torch_frontend.py
# holds them against bench.py's source)
Q8_DDL = [
    "SET streaming_durability = 0",
    "SET streaming_watchdog = 0",
    f"SET streaming_join_capacity = {1 << 19}",
    "SET streaming_join_match_factor = 2",
    ("CREATE SOURCE person WITH (connector='nexmark', table='person', primary_key='id', "
     "chunk_size=98304, inter_event_us=100, emit_watermarks=1)"),
    ("CREATE SOURCE auction WITH (connector='nexmark', primary_key='id', "
     "table='auction', chunk_size=294912, inter_event_us=100, "
     "emit_watermarks=1)"),
    ("CREATE SINK q8 AS "
     "SELECT P.id, P.window_start "
     f"FROM TUMBLE(person, date_time, {W}) P "
     f"JOIN TUMBLE(auction, date_time, {W}) A "
     "ON P.id = A.seller AND P.window_start = A.window_start "
     "WITH (connector='blackhole_device')"),
]
Q8_PERSON_CHUNK, Q8_AUCTION_CHUNK, Q8_INTER_US = 98304, 294912, 100
Q8_KERNELS = ("nexmark_person", "nexmark_auction", "expr_eval",
              "sorted_join_probe", "sorted_join_merge", "radix_sort")


def q8_ddl(person_chunk: int = Q8_PERSON_CHUNK,
           auction_chunk: int = Q8_AUCTION_CHUNK) -> list:
    """Q8_DDL, with other chunk sizes when asked (the CPU rehearsals)."""
    return [st.replace(f"chunk_size={Q8_PERSON_CHUNK},",
                       f"chunk_size={person_chunk},")
            .replace(f"chunk_size={Q8_AUCTION_CHUNK},",
                     f"chunk_size={auction_chunk},") for st in Q8_DDL]


def q8_run(dev, rounds: int, person_chunk: int = Q8_PERSON_CHUNK,
           auction_chunk: int = Q8_AUCTION_CHUNK, sets=(),
           collect: int = 0) -> dict:
    """bench_q8's statements through the port's Session on `dev` (chunk
    sizes swapped in when they are not bench's), then `sets`. Barriers
    are paced by rows: each of `rounds` barriers follows one person
    chunk and one auction chunk (equal event-time spans), the last is
    the Stop barrier. The sources are throttled to one chunk a barrier
    before the sink is created. Counts are set to 0 just before CREATE
    SINK (which starts the flow) and read just after the Stop. With
    collect > 0 a device sink keeping up to `collect` rows is attached
    to the sink fragment by a session build hook."""
    on_card = torch.device(dev).type == "cuda"

    async def go():
        s = Session(device=dev)
        ddl = q8_ddl(person_chunk, auction_chunk)
        for stmt in ddl[:-1]:
            await s.execute(stmt)
        for stmt in sets:
            await s.execute(stmt)
        s.throttle_source("person", person_chunk)
        s.throttle_source("auction", auction_chunk)
        held = {}
        if collect:
            def attach(name, dep, fid):
                root = dep.roots[fid][0]
                actor = next(a for a in dep.actors if a.consumer is root)
                actor.consumer = held["sink"] = DeviceCollectSinkExecutor(
                    root, collect, dev)
            s.build_hooks.append(attach)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        await s.execute(ddl[-1])
        dep = s.catalog.sinks["q8"].deployment
        gens = {x.connector.table: x.connector
                for x in dep.executors(SourceExecutor)}
        join = dep.executors(SortedJoinExecutor)[0]
        coord = s.coord

        def check():
            for t in dep.tasks:
                if t.done():
                    t.result()

        t0 = time.perf_counter()
        for r in range(1, rounds + 1):
            while (gens["person"].offset < r * person_chunk
                   or gens["auction"].offset < r * auction_chunk):
                check()
                await asyncio.sleep(0)
            if r < rounds:
                b = await coord.inject_barrier()
                await coord.wait_collected(b)
            else:
                await coord.stop_all({a.actor_id for a in dep.actors})
        wall = time.perf_counter() - t0
        await asyncio.gather(*dep.tasks)
        launches = {k.name: k.launches for k in kernels.KERNELS.values()}
        if on_card:
            torch.cuda.synchronize()
        s.catalog.sinks.pop("q8")
        return dict(persons=gens["person"].offset,
                    auctions=gens["auction"].offset, wall_s=wall,
                    join=join, sink=held.get("sink"), coord=coord,
                    launches=launches,
                    mem_peak_bytes=(torch.cuda.max_memory_allocated(dev)
                                    if on_card else None))

    return asyncio.run(go())


def q8_keys(pid: np.ndarray, ws: np.ndarray, cfg: NexmarkConfig):
    """One int64 key per (person id, window_start): id << 24 | window
    index counted from the window of the generator's time origin."""
    ws0 = cfg.base_time_us - cfg.base_time_us % W
    widx = (ws - ws0) // W
    if widx.size and (int(widx.min()) < 0 or int(widx.max()) >= 1 << 24
                      or int(pid.min()) < 0 or int(pid.max()) >= 1 << 38):
        raise ValueError("q8 key out of range")
    return (pid.astype(np.int64) << 24) | widx


def q8_recount(n_person: int, n_auction: int, cfg: NexmarkConfig, device,
               batch: int = 1 << 20) -> tuple[np.ndarray, np.ndarray]:
    """q8's result over persons [0, n_person) and auctions [0,
    n_auction), recounted with numpy from the plain generators: per
    (P.id, P.window_start) key (q8_keys), the number of auctions whose
    seller is P.id in the same TUMBLE window — one output row each.
    Returns (sorted keys, counts), keys with a count of 0 left out."""
    vocabs = {k: torch.tensor(v, dtype=torch.int32, device=device)
              for k, v in vocab_ids().items()}

    def cols(gen, n, idx):
        parts = []
        for off in range(0, n, batch):
            c = gen(off, min(batch, n - off), cfg, vocabs, device)
            parts.append([c[i].cpu().numpy() for i in idx])
        if not parts:
            return [np.empty(0, np.int64) for _ in idx]
        return [np.concatenate(x) for x in zip(*parts)]

    pid, pdt = cols(gen_person_columns_plain, n_person, (0, 6))
    seller, adt = cols(gen_auction_columns_plain, n_auction, (7, 5))
    pk = q8_keys(pid, pdt - pdt % W, cfg)
    ak, ac = np.unique(q8_keys(seller, adt - adt % W, cfg),
                       return_counts=True)
    pos = np.searchsorted(ak, pk).clip(max=max(ak.size - 1, 0))
    hit = ak[pos] == pk if ak.size else np.zeros(pk.size, bool)
    order = np.argsort(pk[hit])
    return pk[hit][order], ac[pos[hit]][order]


def q8_sink_counts(sink: "DeviceCollectSinkExecutor", cfg: NexmarkConfig):
    """(sorted keys, counts) of the rows a q8 device sink kept (the
    output is append-only: every row is an insert)."""
    cols, sign, dropped = sink.arrays()
    if dropped:
        raise AssertionError(f"q8 sink dropped {dropped} rows")
    if sign.size and int(sign.min()) != 1:
        raise AssertionError("q8 output holds retractions")
    return np.unique(q8_keys(cols[0], cols[1], cfg), return_counts=True)


def q8_shortfall(got, want) -> tuple[int, int]:
    """(rows the output lacks against the recount, keys where it has
    more than the recount or a key the recount lacks)."""
    gk, gc = got
    wk, wc = want
    pos = np.searchsorted(wk, gk).clip(max=max(wk.size - 1, 0))
    known = (wk[pos] == gk) if wk.size else np.zeros(gk.size, bool)
    over = int((~known).sum()) + int((gc[known] > wc[pos[known]]).sum())
    return int(wc.sum()) - int(gc.sum()), over


def phase_kernels_q8(dev) -> dict:
    """K9-K12 against their plain versions at q8's shapes (and K12 at
    q5's agg capacity), with the library yardsticks."""
    cfg = NexmarkConfig(inter_event_us=Q8_INTER_US)
    vocabs = {k: torch.tensor(v, dtype=torch.int32, device=dev)
              for k, v in vocab_ids().items()}
    res = {}
    odd = NexmarkConfig(inter_event_us=50_000, num_active_people=1009,
                        base_time_us=1_234_567)
    for name, gen, plain, n, row_b in (
            ("nexmark_person", gen_person_columns, gen_person_columns_plain,
             Q8_PERSON_CHUNK, 2 * 8 + 6 * 4),
            ("nexmark_auction", gen_auction_columns,
             gen_auction_columns_plain, Q8_AUCTION_CHUNK, 7 * 8 + 3 * 4)):
        err = 0
        for off, c in ((0, cfg), (10**12 + 7, cfg), (987_654_321, odd)):
            err = max(err, exact_err(gen(off, n, c, vocabs, dev),
                                     plain(off, n, c, vocabs, dev)))
        if err:
            raise AssertionError(f"{name} differs from plain by {err}")
        off = 28 * n
        res[name] = dict(
            max_abs_err=err,
            **timings(lambda g=gen, n=n: g(off, n, cfg, vocabs, dev),
                      lambda g=plain, n=n: g(off, n, cfg, vocabs, dev)),
            bound_ms=bytes_bound_ms(n * row_b), bound_by="bytes", rows=n)
        emit({"phase": "kernel", "name": name, **res[name]})

    # ---- K11: the join's sorts at q8's shapes (the 63-bit hashes of the
    # auction chunk's (seller, window_start) and the person chunk's
    # (id, window_start)), keys with many ties and negatives, extreme
    # int64, tiny and empty inputs; then a 16384-row netting lexsort
    a = gen_auction_columns_plain(0, Q8_AUCTION_CHUNK, cfg, vocabs, dev)
    p = gen_person_columns_plain(0, Q8_PERSON_CHUNK, cfg, vocabs, dev)
    a_h = key_hash([a[7], a[5] - a[5] % W])
    p_h = key_hash([p[0], p[6] - p[6] % W])
    g = torch.Generator().manual_seed(17)
    ext = torch.tensor([-(1 << 63), (1 << 63) - 1, 0, -1, 1],
                       dtype=torch.int64)
    cases = [(a_h, 63), (p_h, 63),
             (torch.randint(-1000, 1000, (294912,), generator=g).to(dev), 64),
             (ext[torch.randint(0, 5, (70000,), generator=g)].to(dev), 64),
             (torch.randint(0, 2, (5000,), generator=g).to(dev), 1),
             (torch.randint(0, 1 << 20, (100000,), generator=g).to(dev), 20),
             (torch.randint(-5, 5, (3,), generator=g).to(dev), 64),
             (torch.empty(0, dtype=torch.int64, device=dev), 64)]
    err = 0
    for keys, bits in cases:
        ks, kp = stable_sort(keys, bits)
        ps, pp = stable_sort_plain(keys)
        err = max(err, exact_err([ks, kp], [ps, pp]))
    # netting lexsort: a retracting side's 16384-row chunk grouped by a
    # pk with runs, NULL-key rows last
    nr = 16384
    pk_col = torch.randint(0, nr // 4, (nr,), generator=g).to(dev)
    act = (torch.rand(nr, generator=g) < 0.9).to(dev)
    lex_keys = [pk_col, (~act).to(torch.uint8)]
    lex_bits = [64, 1]
    err = max(err, exact_err(
        [stable_lexsort(lex_keys, lex_bits)],
        [stable_lexsort([k.cpu() for k in lex_keys]).to(dev)]))
    if err:
        raise AssertionError(f"K11 differs from plain by {err}")
    n = Q8_AUCTION_CHUNK
    res["radix_sort"] = dict(
        max_abs_err=err,
        **timings(lambda: stable_sort(a_h, 63),
                  lambda: stable_sort_plain(a_h),
                  library_fn=lambda: torch.sort(a_h, stable=True)),
        bound_ms=bytes_bound_ms(n * 24), bound_by="bytes", rows=n,
        person_side=dict(
            rows=Q8_PERSON_CHUNK,
            **timings(lambda: stable_sort(p_h, 63),
                      lambda: stable_sort_plain(p_h)),
            bound_ms=bytes_bound_ms(Q8_PERSON_CHUNK * 24)),
        netting_lexsort=dict(
            rows=nr,
            **timings(lambda: stable_lexsort(lex_keys, lex_bits),
                      lambda: [torch.argsort(k, stable=True)
                               for k in lex_keys]),
            bound_ms=bytes_bound_ms(nr * (8 + 1 + 8))))
    emit({"phase": "kernel", "name": "radix_sort", **res["radix_sort"]})

    # ---- K12: masks of q5's agg capacity at several densities, all
    # false, all true, a length that is not a multiple of a block
    C = 1 << 20
    masks = [(torch.rand(C, generator=g) < d).to(dev)
             for d in (0.3, 0.0, 1.0, 0.01)]
    masks.append((torch.rand(1000003, generator=g) < 0.5).to(dev))
    err = 0
    for m in masks:
        sk, nk = ht.compact_mask(m)
        sp, np_ = ht.compact_mask_plain(m)
        err = max(err, exact_err([sk, nk], [sp, np_]))
    if err:
        raise AssertionError(f"K12 differs from plain by {err}")
    m = masks[0]
    res["compact"] = dict(
        max_abs_err=err,
        **timings(lambda: ht.compact_mask(m),
                  lambda: ht.compact_mask_plain(m),
                  library_fn=lambda: torch.nonzero(m)),
        bound_ms=bytes_bound_ms(C * 9), bound_by="bytes", slots=C,
        set_share=float(m.float().mean()))
    emit({"phase": "kernel", "name": "compact", **res["compact"]})
    return res


def q8_check_gates(r: dict, want, got, exact: bool) -> dict:
    errs = r["join"].errs()
    short, over = q8_shortfall(got, want)
    if errs[1] or errs[2] or over:
        raise AssertionError(f"q8: join errs {errs}, {over} keys above "
                             f"the recount")
    if short != errs[0]:
        raise AssertionError(f"q8: output lacks {short} rows against the "
                             f"recount, the join dropped {errs[0]}")
    if exact and (short or errs != [0, 0, 0]):
        raise AssertionError(f"q8 differs from the recount: {short} rows "
                             f"short, errs {errs}")
    return dict(join_errs=errs, shortfall=short, rows=int(want[1].sum()),
                keys=int(want[0].size))


def phase_q8_full(dev, repeats: int = 5, rounds: int = 28) -> dict:
    """bench_q8's statements through the port's Session at bench's
    width, `repeats` runs from fresh state: every q8 kernel launched,
    errs[1] == errs[2] == 0 (errs[0], the match-buffer overflow, is
    reported: it is bench geometry's semantics in both engines)."""
    runs = []
    for _ in range(repeats):
        r = q8_run(dev, rounds)
        errs = r["join"].errs()
        if errs[1] or errs[2]:
            raise AssertionError(f"q8: join errs {errs}")
        missing = [k for k in Q8_KERNELS if r["launches"][k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on q8: {missing}")
        events = r["persons"] + r["auctions"]
        runs.append(dict(
            events=events, wall_s=r["wall_s"],
            events_per_s=events / r["wall_s"],
            barrier_p50_s=r["coord"].barrier_latency_percentile(0.5),
            barrier_max_s=r["coord"].barrier_latency_percentile(1.0),
            join_errs=errs, left_rows=int(r["join"].sides[0].n),
            right_rows=int(r["join"].sides[1].n),
            mem_peak_bytes=r["mem_peak_bytes"], launches=r["launches"]))
    first = runs[0]
    rates = [x["events_per_s"] for x in runs]
    return dict(
        persons=rounds * Q8_PERSON_CHUNK, auctions=rounds * Q8_AUCTION_CHUNK,
        events=first["events"], barriers=rounds, repeats=repeats,
        wall_s=statistics.median(x["wall_s"] for x in runs),
        events_per_s=statistics.median(rates), events_per_s_min=min(rates),
        events_per_s_max=max(rates),
        barrier_p50_s=statistics.median(x["barrier_p50_s"] for x in runs),
        barrier_max_s=statistics.median(x["barrier_max_s"] for x in runs),
        runs=[{k: x[k] for k in ("wall_s", "events_per_s", "barrier_p50_s",
                                 "barrier_max_s", "join_errs", "left_rows",
                                 "right_rows", "mem_peak_bytes")}
              for x in runs],
        launches=first["launches"])


def phase_q8_profile(dev, full: dict, rounds: int = 6) -> dict:
    """Where q8's time goes: a fresh run of a few barriers under
    torch.profiler; the idle share against phase q8_full's unprofiled
    median wall per chunk pair."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        r = q8_run(dev, rounds)
        torch.cuda.synchronize()
    kev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict = {}
    for e in kev:
        name = e.name[:60]
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + e.time_range.elapsed_us(), c + 1)
    busy_s = sum(t for t, _ in by_name.values()) / 1e6
    busy_per_pair = busy_s / rounds
    wall_per_pair = full["wall_s"] / full["barriers"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:16]
    return dict(
        rounds=rounds, wall_s=r["wall_s"], device_busy_s=busy_s,
        device_busy_per_chunk_pair_s=busy_per_pair,
        unprofiled_wall_per_chunk_pair_s=wall_per_pair,
        device_idle_share=(1 - busy_per_pair / wall_per_pair)
        if kev else None,
        device_idle_share_profiled=(1 - busy_s / r["wall_s"])
        if kev else None,
        device_events=len(kev),
        top_kernels=[{"name": nm, "ms": t / 1e3, "count": c}
                     for nm, (t, c) in top])


def phase_q8_check(dev, rounds: int = 8, ahead_rounds: int = 2) -> dict:
    """The correctness gate: bench_q8's statements again, a device sink
    that keeps the rows attached to the session's deployment. At match
    factor 2 (bench's) the output must be a sub-multiset of the numpy
    recount short by exactly the matches the join counted as dropped;
    at match factor 4 (M = 393216 >= the matches a chunk pair holds) it
    must equal the recount with errs [0, 0, 0]. A third run makes the
    overflow certain: auction chunks twice bench's (twice the person
    chunk's event time, a 2^20-row join so the auctions held ahead fit),
    so every person chunk after the first finds its ~277 k auctions
    already stored, past its 196608-slot buffer; errs[0] must be > 0
    and the identity must hold."""
    cfg = NexmarkConfig(inter_event_us=Q8_INTER_US)
    out = {}
    for mf in (2, 4):
        sets = (f"SET streaming_join_match_factor = {mf}",) if mf != 2 \
            else ()
        r = q8_run(dev, rounds, sets=sets,
                   collect=rounds * Q8_AUCTION_CHUNK)
        want = q8_recount(r["persons"], r["auctions"], cfg, dev)
        got = q8_sink_counts(r["sink"], cfg)
        out[f"match_factor_{mf}"] = dict(
            persons=r["persons"], auctions=r["auctions"],
            **q8_check_gates(r, want, got, exact=mf == 4))
    ahead = 2 * Q8_AUCTION_CHUNK
    r = q8_run(dev, ahead_rounds, auction_chunk=ahead,
               sets=(f"SET streaming_join_capacity = {1 << 20}",),
               collect=ahead_rounds * ahead)
    want = q8_recount(r["persons"], r["auctions"], cfg, dev)
    got = q8_sink_counts(r["sink"], cfg)
    gate = q8_check_gates(r, want, got, exact=False)
    if gate["join_errs"][0] == 0:
        raise AssertionError("q8 auctions-ahead run dropped no match")
    out["auctions_ahead"] = dict(persons=r["persons"],
                                 auctions=r["auctions"], **gate)
    return dict(barriers=rounds, **out)


# ----------------------------------------------------------- q17 (SQL)

Q17_CS = 8192               # bench.py's lineitem chunk
Q17_PER_BARRIER = 16 * Q17_CS   # the DDL's rate_limit: 16 chunks a barrier
Q17_PART_CHUNK = 1024
Q17_QUOTA_CHUNKS = 64       # bench.py's measured quota
TPCH_SF1_LINEITEM = 6_001_215
# bench.py's bench_q17 statements, verbatim (tests/test_torch_frontend.py
# holds them against bench.py's source). bench_q17 runs one more
# statement first, SET barrier_stall_threshold_ms = 15000, for the JAX
# coordinator's stuck-barrier watchdog, which the port has not (ROADMAP
# A5) and refuses: it is left out here.
Q17_DDL = [
    "SET streaming_durability = 0",
    "SET streaming_watchdog = 0",
    f"SET streaming_join_capacity = {1 << 20}",
    f"SET streaming_agg_capacity = {1 << 16}",
    ("CREATE SOURCE part WITH (connector='tpch', table='part', "
     "chunk_size=1024, rate_limit=1024, primary_key='p_partkey')"),
    ("CREATE SOURCE lineitem WITH (connector='tpch', "
     f"table='lineitem', chunk_size={Q17_CS}, rate_limit={16 * Q17_CS})"),
    ("CREATE SINK q17 AS "
     "SELECT sum(L.l_extendedprice) / 7.0 AS avg_yearly "
     "FROM lineitem L "
     "JOIN part P ON P.p_partkey = L.l_partkey "
     "JOIN (SELECT l_partkey AS agg_partkey, "
     "             0.2 * avg(l_quantity) AS avg_quantity "
     "      FROM lineitem GROUP BY l_partkey) A "
     "  ON A.agg_partkey = L.l_partkey "
     " AND L.l_quantity < A.avg_quantity "
     "WHERE P.p_brand = 'Brand#23' AND P.p_container = 'MED BOX' "
     "WITH (connector='blackhole_device')"),
]
Q17_KERNELS = ("tpch", "snapshot_append", "segment_agg", "snapshot_final",
               "expr_eval", "radix_sort")


def q17_ddl(li_chunk: int = Q17_CS, part_chunk: int = Q17_PART_CHUNK,
            capacity: int = 1 << 20) -> list:
    """Q17_DDL with other chunk sizes or fact capacity when asked (the
    check phase and the CPU rehearsals); the rate limits stay 16
    lineitem chunks and one part chunk a barrier."""
    out = []
    for st in Q17_DDL:
        st = st.replace(f"chunk_size={Q17_CS}, rate_limit={16 * Q17_CS}",
                        f"chunk_size={li_chunk}, rate_limit={16 * li_chunk}")
        st = st.replace("chunk_size=1024, rate_limit=1024",
                        f"chunk_size={part_chunk}, rate_limit={part_chunk}")
        st = st.replace(f"streaming_join_capacity = {1 << 20}",
                        f"streaming_join_capacity = {capacity}")
        out.append(st)
    return out


def q17_run(dev, rounds: int, li_chunk: int = Q17_CS,
            part_chunk: int = Q17_PART_CHUNK, capacity: int = 1 << 20,
            collect: bool = False, ddl=None) -> dict:
    """bench_q17's statements through the port's Session on `dev`. Each
    of `rounds` barriers is injected once the lineitem source has emitted
    16 more chunks and the part source one more (the DDL's rate limits);
    the last is the Stop barrier, so barrier r closes exactly r x 16
    lineitem chunks and r part chunks. Barrier 1 is bench's warmup: the
    wall and the barrier latencies cover barriers 2..rounds. Counts are
    set to 0 just before CREATE SINK (which starts the flow) and read
    just after the Stop. With `collect` a device sink keeping every
    emitted row replaces the blackhole (a session build hook), and the
    sink's row count, the executor's fact count and its output chunk
    are kept at each barrier. `ddl` replaces the statements (other
    shapes)."""
    on_card = torch.device(dev).type == "cuda"
    per_li = 16 * li_chunk

    async def go():
        s = Session(device=dev)
        stmts = ddl if ddl is not None else q17_ddl(li_chunk, part_chunk,
                                                    capacity)
        for stmt in stmts[:-1]:
            await s.execute(stmt)
        held = {}
        if collect:
            def attach(name, dep, fid):
                root = dep.roots[fid][0]
                actor = next(a for a in dep.actors if a.consumer is root)
                actor.consumer = held["sink"] = DeviceCollectSinkExecutor(
                    root, 4 * rounds + 4, dev)
            s.build_hooks.append(attach)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        await s.execute(stmts[-1])
        name = next(iter(s.catalog.sinks or s.catalog.mvs))
        flow = (s.catalog.sinks or s.catalog.mvs)[name]
        dep = flow.deployment
        gens = {x.connector.table: x.connector
                for x in dep.executors(SourceExecutor)}
        ex = dep.executors(SnapshotJoinAggExecutor)[0]
        coord = s.coord
        fns, outs = [], []
        if collect:
            flush = ex._flush

            def recording_flush():
                fns.append(ex._fn.clone())
                outs.append(flush())
                return outs[-1]
            ex._flush = recording_flush

        def check():
            for t in dep.tasks:
                if t.done():
                    t.result()

        marks, lat, t0 = [], [], None
        for r in range(1, rounds + 1):
            while (gens["lineitem"].offset < r * per_li
                   or gens["part"].offset < r * part_chunk):
                check()
                await asyncio.sleep(0)
            tb = time.perf_counter()
            if r < rounds:
                b = await coord.inject_barrier()
                await coord.wait_collected(b)
            else:
                await coord.stop_all({a.actor_id for a in dep.actors})
            if r > 1:
                lat.append(time.perf_counter() - tb)
            else:
                t0 = time.perf_counter()
            if collect:
                marks.append(held["sink"].count.clone())
        wall = time.perf_counter() - (t0 if t0 is not None else 0.0)
        await asyncio.gather(*dep.tasks)
        launches = {k.name: k.launches for k in kernels.KERNELS.values()}
        if on_card:
            torch.cuda.synchronize()
        (s.catalog.sinks or s.catalog.mvs).pop(name)
        return dict(
            lineitem=gens["lineitem"].offset, parts=gens["part"].offset,
            measured_rows=(rounds - 1) * per_li, wall_s=wall,
            barrier_lat_s=lat, ex=ex, sink=held.get("sink"),
            marks=[int(m) for m in marks], fns=[int(f) for f in fns],
            outs=outs, launches=launches,
            mem_peak_bytes=(torch.cuda.max_memory_allocated(dev)
                            if on_card else None))

    return asyncio.run(go())


def tpch_prefix(table: str, n: int, device, batch: int = 1 << 21):
    """The first n rows of a tpch table as numpy arrays, from the plain
    generator (on `device`, in batches)."""
    ids = tpch.vocab_ids()
    b = torch.tensor(ids["tpch_brand"], dtype=torch.int64, device=device)
    c = torch.tensor(ids["tpch_container"], dtype=torch.int64,
                     device=device)
    parts = []
    for off in range(0, n, batch):
        cols = tpch.gen_tpch_columns_plain(table, off, min(batch, n - off),
                                           b, c, device)
        parts.append([x.cpu().numpy() for x in cols])
    if not parts:
        return [np.empty(0, np.int64) for _ in range(4)]
    return [np.concatenate(x) for x in zip(*parts)]


def q17_recount(n_li: int, n_part: int, device, li=None, part=None):
    """q17 over lineitem rows [0, n_li) and parts [0, n_part), recounted
    with numpy: per part key the threshold 0.2 * (sum(q) / count(q)) in
    float64 (as the plan computes it: a float64 sum of integers, exact),
    the rows with q below it whose part has brand 'Brand#23' and
    container 'MED BOX', sum(extendedprice) / 7.0. None when no row
    qualifies (SQL's NULL sum). `li`/`part` are prefixes to slice."""
    li = li if li is not None else tpch_prefix("lineitem", n_li, device)
    part = part if part is not None else tpch_prefix("part", n_part, device)
    pk, q, ep = li[1][:n_li], li[2][:n_li], li[3][:n_li]
    keys, brand, cont = part[0][:n_part], part[1][:n_part], part[2][:n_part]
    ids = tpch.vocab_ids()
    want_b = ids["tpch_brand"][tpch.BRANDS.index("Brand#23")]
    want_c = ids["tpch_container"][tpch.CONTAINERS.index("MED BOX")]
    top = int(max(pk.max(initial=0), keys.max(initial=0))) + 1
    ok = np.zeros(top, bool)
    ok[keys[(brand == want_b) & (cont == want_c)]] = True
    s = np.bincount(pk, weights=q.astype(np.float64), minlength=top)
    cnt = np.bincount(pk, minlength=top)
    with np.errstate(invalid="ignore", divide="ignore"):
        thr = 0.2 * (s / cnt)
    sel = ok[pk] & (q < thr[pk])
    if not sel.any():
        return None
    return int(ep[sel].sum()) / 7.0


def q17_emitted(r: dict) -> list:
    """The value the sink holds after each barrier (the last U+ or
    Insert so far), None for a NULL; from the collecting sink."""
    sink = r["sink"]
    cols, sign, dropped = sink.arrays()
    if dropped:
        raise AssertionError(f"q17 sink dropped {dropped} rows")
    valid = sink.valid[0][:sign.size].cpu().numpy()
    out, cur, at = [], None, 0
    for m in r["marks"]:
        for i in range(at, m):
            if sign[i] > 0:
                cur = float(cols[0][i]) if valid[i] else None
        at = m
        out.append(cur)
    return out


def q17_gates(r: dict) -> dict:
    errs = r["ex"].errs()
    if errs != [0, 0, 0]:
        raise AssertionError(f"q17: snapshot errs {errs}")
    missing = [k for k in Q17_KERNELS if r["launches"][k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on q17: {missing}")
    return dict(errs=errs)


def phase_kernels_q17(dev) -> dict:
    """K13-K16 against their plain versions at q17's shapes: K13 at
    1024-row part and 8192/131072-row lineitem chunks; K14-K16 on the
    2^20-slot fact store at bench's end state (655360 rows, 5 barriers of
    16 chunks, and 5120 parts into 2^16 dim slots), built by the port's
    executor from bench_q17's plan, with a variant holding NULL keys and
    a sub-WHERE plan over the same store; then every flush step, kernel
    against plain, and the whole flush against the CPU's."""
    res = {}
    ids = tpch.vocab_ids()
    bids = torch.tensor(ids["tpch_brand"], dtype=torch.int64, device=dev)
    cids = torch.tensor(ids["tpch_container"], dtype=torch.int64,
                        device=dev)
    # ---- K13
    err = 0
    for table, n, offs in (("part", 1024, (0, 1000, 10**12 + 7)),
                           ("lineitem", Q17_CS, (0, 5_999_872, 10**12 + 3)),
                           ("lineitem", 131072, (0, 987_654_321))):
        for off in offs:
            err = max(err, exact_err(
                tpch.gen_tpch_columns(table, off, n, bids, cids, dev),
                tpch.gen_tpch_columns_plain(table, off, n, bids, cids,
                                            dev)))
    if err:
        raise AssertionError(f"K13 differs from plain by {err}")
    off = 64 * Q17_CS
    res["tpch"] = dict(
        max_abs_err=err,
        **timings(lambda: tpch.gen_tpch_columns("lineitem", off, Q17_CS,
                                                bids, cids, dev),
                  lambda: tpch.gen_tpch_columns_plain("lineitem", off,
                                                      Q17_CS, bids, cids,
                                                      dev)),
        bound_ms=bytes_bound_ms(Q17_CS * 32), bound_by="bytes",
        rows=Q17_CS,
        part=dict(rows=1024, **timings(
            lambda: tpch.gen_tpch_columns("part", 0, 1024, bids, cids, dev),
            lambda: tpch.gen_tpch_columns_plain("part", 0, 1024, bids, cids,
                                                dev)),
            bound_ms=bytes_bound_ms(1024 * 32)))
    emit({"phase": "kernel", "name": "tpch", **res["tpch"]})

    # ---- K14: bench's end state, every append checked against plain
    args = q17_node_args(dev)
    ex = q17_executor(args, dev)
    li_gen = TpchGenerator("lineitem", chunk_size=Q17_CS, device=dev)
    part_gen = TpchGenerator("part", chunk_size=1024, device=dev)
    err = 0

    def store_copy():
        return ([c.clone() for c in ex._fcols],
                [v.clone() for v in ex._fvalids], ex._fn.clone(),
                ex._errs.clone(), ex._dkeys.clone(), ex._dn.clone())

    for b in range(5):
        chunks = [("d", part_gen.next_chunk())] + [
            ("f", li_gen.next_chunk()) for _ in range(16)]
        for side, ch in chunks:
            fc, fv, fn, er, dk, dn = store_copy()
            if side == "f":
                sja.append_rows_plain(fc, fv, fn, er,
                                      [c.data for c in ch.columns],
                                      [c.valid for c in ch.columns],
                                      ch.vis, ch.ops, (), 0)
                ex._append_fact(ch)
                err = max(err, exact_err([*fc, *fv, fn, er],
                                         [*ex._fcols, *ex._fvalids, ex._fn,
                                          ex._errs]))
            else:
                kcol = ch.columns[ex.dim_key]
                p = ex._dim_prog.eval(list(ch.columns))[0]
                sja.append_rows_plain([dk], [None], dn, er, [kcol.data],
                                      [None], ch.vis, ch.ops,
                                      [kcol.valid, p.data, p.valid], 1)
                ex._append_dim(ch)
                err = max(err, exact_err([dk, dn, er],
                                         [ex._dkeys, ex._dn, ex._errs]))
    if err or ex.errs() != [0, 0, 0]:
        raise AssertionError(f"K14 differs from plain by {err}, errs "
                             f"{ex.errs()}")
    err = max(err, k14_edge_err(dev))
    if err:
        raise AssertionError(f"K14 differs from plain by {err} at the edges")
    fn0 = int(ex._fn)
    ch = li_gen.next_chunk()
    fc, fv, fn_t, er = ([c.clone() for c in ex._fcols],
                        [v.clone() for v in ex._fvalids],
                        ex._fn.clone(), ex._errs.clone())
    src = [c.data for c in ch.columns]

    def reset():
        fn_t.fill_(fn0)

    def lib_append():
        take = ch.vis & ((ch.ops == 0) | (ch.ops == 3))
        sel = torch.nonzero(take).squeeze(1)
        dest = fn0 + torch.arange(sel.shape[0], device=dev)
        for d, s_ in zip(fc, src):
            d.index_copy_(0, dest, s_.index_select(0, sel))

    res["snapshot_append"] = dict(
        max_abs_err=err,
        **timings(lambda: sja.append_rows(fc, fv, fn_t, er, src,
                                          [None] * 4, ch.vis, ch.ops),
                  lambda: sja.append_rows_plain(fc, fv, fn_t, er, src,
                                                [None] * 4, ch.vis, ch.ops,
                                                (), 0),
                  setup=reset, library_fn=lib_append),
        bound_ms=bytes_bound_ms(Q17_CS * (1 + 1 + 4 * 8 + 4 * 9)),
        bound_by="bytes", rows=Q17_CS, store_rows=fn0,
        store_slots=ex.capacity)
    emit({"phase": "kernel", "name": "snapshot_append",
          **res["snapshot_append"]})

    # ---- K15, K16: every flush step against plain, on the bench state,
    # on a copy with NULL keys, and under a sub-WHERE plan
    null_valid = ex._fvalids[ex.fact_key].clone()
    null_valid[::97] = False
    sub_args = q17_node_args(dev, query=Q17_SUB_WHERE)
    sub_ex = q17_executor(sub_args, dev)
    steps = {}
    err15 = err16 = 0
    kinds_ex = q17_executor(q17_node_args(dev, query=Q17_KINDS), dev)
    for case, e, key_valid in (("bench", ex, None), ("null_keys", ex,
                                                     null_valid),
                               ("sub_where", sub_ex, None),
                               ("kinds", kinds_ex, None)):
        if e is not ex:
            e._fcols, e._fvalids, e._fn = ex._fcols, ex._fvalids, ex._fn
            e._dkeys, e._dn = ex._dkeys, ex._dn
        e15, e16, st = flush_steps_err(e, key_valid)
        err15, err16 = max(err15, e15), max(err16, e16)
        steps[case] = st
    f_err, f_rel = float_aggs_err(ex, steps["bench"])
    if err15 or err16 or f_err or f_rel > 1e-12:
        raise AssertionError(f"K15/K16 differ from plain by {err15}, "
                             f"{err16}; float64 aggregates {f_err}, sums "
                             f"relative {f_rel}")
    st = steps["bench"]
    C, Cd = ex.capacity, ex.dim_capacity
    seg = (st["sfk"], st["order"], ex._fn, None, ex.sub_agg_calls,
           st["cols_s"], st["valids_s"])
    g64 = st["gid"].to(torch.int64)
    qv = st["cols_s"][2].to(torch.float64)
    ones = torch.ones(C, dtype=torch.int64, device=dev)

    def lib_reduce():
        torch.zeros(C, dtype=torch.float64, device=dev).index_add_(0, g64,
                                                                   qv)
        torch.zeros(C, dtype=torch.int64, device=dev).index_add_(0, g64,
                                                                 ones)

    res["segment_agg"] = dict(
        max_abs_err=err15,
        **timings(lambda: sja.segment_reduce(*seg),
                  lambda: sja.segment_reduce_plain(*seg),
                  library_fn=lib_reduce),
        # in: sorted keys, order, the quantity and its validity; out:
        # gid, gexists, each call's value and validity
        bound_ms=bytes_bound_ms(C * ((8 + 8 + 8 + 1) + 4 + 1
                                     + 2 * (8 + 1))),
        bound_by="bytes", slots=C, live_rows=fn0,
        groups=int(st["gid"][fn0 - 1]) + 1, float_sum_rel_err=f_rel,
        keys=dict(**timings(
            lambda: sja.sort_keys(ex._fcols[ex.fact_key],
                                  ex._fvalids[ex.fact_key], ex._fn),
            lambda: sja.sort_keys_plain(ex._fcols[ex.fact_key],
                                        ex._fvalids[ex.fact_key], ex._fn)),
            bound_ms=bytes_bound_ms(C * (8 + 1 + 8))),
        take=dict(**timings(
            lambda: sja.take_rows(st["take_in"][0], st["take_in"][1],
                                  st["order"]),
            lambda: sja.take_rows_plain(st["take_in"][0], st["take_in"][1],
                                        st["order"])),
            bound_ms=bytes_bound_ms(C * (8 + 2 * 2 * (8 + 1)))),
        take_by_gid=dict(**timings(
            lambda: sja.take_rows(st["items"][0], st["items"][1],
                                  st["gid"]),
            lambda: sja.take_rows_plain(st["items"][0], st["items"][1],
                                        st["gid"])),
            bound_ms=bytes_bound_ms(C * (4 + 2 * (8 + 1)))))
    emit({"phase": "kernel", "name": "segment_agg", **res["segment_agg"]})

    fin = (st["sfk"], st["order"], ex._fn, st["sd"], ex._dn, None,
           st["gid"], st["preds"], ex.final_agg_calls, st["cols_s"],
           st["valids_s"])
    res_p = st["preds"][0]
    diff_k = ([p.clone() for p in st["prev"]],
              [p.clone() for p in st["prev_valid"]], st["emitted"].clone())
    diff_p = ([p.clone() for p in st["prev"]],
              [p.clone() for p in st["prev_valid"]], st["emitted"].clone())

    def lib_final():
        pos = torch.searchsorted(st["sd"], st["sfk"])
        m = (st["sd"][pos.clamp(max=Cd - 1)] == st["sfk"]) \
            & (pos < ex._dn) & res_p.data & (st["order"] < ex._fn)
        return torch.where(m, st["cols_s"][3], 0).sum()

    res["snapshot_final"] = dict(
        max_abs_err=err16,
        **timings(lambda: sja.final_reduce(*fin),
                  lambda: sja.final_reduce_plain(*fin),
                  library_fn=lib_final),
        bound_ms=bytes_bound_ms(C * (8 + 8 + 2 + 8 + 1) + Cd * 8),
        bound_by="bytes", slots=C, dim_slots=Cd,
        dim_rows=int(ex._dn), value=steps["bench"]["value"],
        # the diff updates its previous state in place, so repeated
        # calls keep diffing against the last value
        diff=dict(**timings(lambda: sja.final_diff(st["cur"], *diff_k),
                            lambda: sja.final_diff_plain(st["cur"],
                                                         *diff_p))))
    emit({"phase": "kernel", "name": "snapshot_final",
          **res["snapshot_final"]})
    # the whole flush on the card against the CPU's plain flush, and the
    # value against the numpy recount
    want = q17_recount(fn0, int(part_gen.offset), dev)
    cpu = q17_executor(args, "cpu")
    cpu._fcols = tuple(c.cpu() for c in ex._fcols)
    cpu._fvalids = tuple(v.cpu() for v in ex._fvalids)
    cpu._fn, cpu._dkeys, cpu._dn = (ex._fn.cpu(), ex._dkeys.cpu(),
                                    ex._dn.cpu())
    card_out, cpu_out = ex._flush(), cpu._flush()
    err = columns_err(card_out.columns, [Column(c.data.to(dev),
                                                c.valid.to(dev))
                                         for c in cpu_out.columns])
    got = float(card_out.columns[0].data[1])
    if err or want is None or got != want:
        raise AssertionError(f"q17 flush: card vs CPU err {err}, value "
                             f"{got} vs recount {want}")
    res["snapshot_final"]["flush_vs_cpu_err"] = err
    return res


def k14_edge_err(dev) -> int:
    """K14 against its plain version where the bench state never goes:
    invisible rows, retractions, NULL cells, a store that overflows on
    the second chunk, extra masks and an int32 key widened into an int64
    store (the dim side's form)."""
    g = torch.Generator().manual_seed(23)
    n, C = Q17_CS, Q17_CS
    cols = [torch.randint(-1 << 40, 1 << 40, (n,), generator=g).to(dev)
            for _ in range(3)]
    cols.append(torch.randint(-1 << 30, 1 << 30, (n,), generator=g,
                              dtype=torch.int32).to(dev))
    valids = [None, (torch.rand(n, generator=g) < 0.8).to(dev), None,
              (torch.rand(n, generator=g) < 0.9).to(dev)]
    vis = (torch.rand(n, generator=g) < 0.9).to(dev)
    ops = torch.where(torch.rand(n, generator=g) < 0.05, 1, 0).to(
        torch.int8).to(dev)
    mask = (torch.rand(n, generator=g) < 0.7).to(dev)
    err = 0
    for dtypes, masks in (([torch.int64] * 3 + [torch.int32], ()),
                          ([torch.int64] * 4, (mask, valids[1], None))):
        dst = [[torch.zeros(C, dtype=d, device=dev) for d in dtypes]
               for _ in range(2)]
        dvs = [[torch.zeros(C, dtype=torch.bool, device=dev)
                for _ in dtypes] for _ in range(2)]
        counts = [torch.tensor(1000, dtype=torch.int32, device=dev)
                  for _ in range(2)]
        errs = [torch.zeros(3, dtype=torch.int32, device=dev)
                for _ in range(2)]
        for _ in range(2):
            sja.append_rows(dst[0], dvs[0], counts[0], errs[0], cols,
                            valids, vis, ops, masks)
            sja.append_rows_plain(dst[1], dvs[1], counts[1], errs[1], cols,
                                  valids, vis, ops, masks, 0)
        err = max(err, exact_err([*dst[0], *dvs[0], counts[0], errs[0]],
                                 [*dst[1], *dvs[1], counts[1], errs[1]]))
        if int(errs[0][0]) == 0 or int(errs[0][2]) == 0:
            raise AssertionError("K14 edge case neither overflowed nor "
                                 "retracted")
    return err


def float_aggs_err(ex, st) -> tuple[int, float]:
    """K15's and K16's float64 paths, which q17's integer columns never
    reach (the CAS-based MIN/MAX, sums of general floats), on the bench
    state: extendedprice / 7.0 per row. Returns (the largest difference
    of everything but the float sums, which must be 0; the sums' largest
    relative difference, within 1e-12: other summation orders)."""
    x = st["cols_s"][3].to(torch.float64) / 7.0
    xv = st["valids_s"][3]
    F = DataType.FLOAT64
    calls = [AggCall(AggKind.SUM, 0, F, True), AggCall(AggKind.MIN, 0, F, True),
             AggCall(AggKind.MAX, 0, F, True),
             AggCall(AggKind.COUNT, 0, DataType.INT64, True)]
    seg = (st["sfk"], st["order"], ex._fn, None, calls, [x], [xv])
    gid, outs, gex = sja.segment_reduce(*seg)
    gid_p, outs_p, gex_p = sja.segment_reduce_plain(*seg)
    fin = (st["sfk"], st["order"], ex._fn, st["sd"], ex._dn, None, gid,
           st["preds"], calls, [x], [xv])
    fo, fo_p = sja.final_reduce(*fin), sja.final_reduce_plain(*fin)
    err = max(exact_err([gid, gex], [gid_p, gex_p]),
              columns_err(outs[1:] + fo[1:], outs_p[1:] + fo_p[1:]),
              exact_err([outs[0].valid, fo[0].valid],
                        [outs_p[0].valid, fo_p[0].valid]))
    rel = 0.0
    for a, b in ((outs[0].data, outs_p[0].data), (fo[0].data, fo_p[0].data)):
        d = (a - b).abs() / b.abs().clamp(min=1e-300)
        rel = max(rel, float(d.max()))
    return err, rel


# every aggregate kind at both levels and a fact filter, over bench's
# sources (tests/test_torch_snapshot_join_agg.py's "kinds")
Q17_KINDS = (
    "SELECT count(*) AS n, count(L.l_orderkey) AS c, "
    "sum(L.l_extendedprice) AS s, avg(L.l_quantity) AS a, "
    "min(L.l_quantity) AS mn, max(L.l_extendedprice) AS mx "
    "FROM lineitem L JOIN part P ON P.p_partkey = L.l_partkey "
    "JOIN (SELECT l_partkey AS k, min(l_quantity) AS mq, "
    "max(l_quantity) AS xq, sum(l_extendedprice) AS se "
    "FROM lineitem GROUP BY l_partkey) A "
    "ON A.k = L.l_partkey AND L.l_quantity <= A.xq "
    "AND L.l_quantity >= A.mq + 1 AND L.l_extendedprice < A.se "
    "WHERE L.l_orderkey > 2")


# TPC-H q17's shape with a WHERE inside the subquery, whose group
# existence decides membership (tests/test_snapshot_join_agg.py)
Q17_SUB_WHERE = (
    "SELECT count(*) AS n, sum(L.l_extendedprice) AS s "
    "FROM lineitem L JOIN part P ON P.p_partkey = L.l_partkey "
    "JOIN (SELECT l_partkey AS k, count(l_quantity) AS c, "
    "avg(l_quantity) AS a FROM lineitem WHERE l_quantity > 48 "
    "GROUP BY l_partkey) A "
    "ON A.k = L.l_partkey AND L.l_quantity < A.a + A.c "
    "WHERE P.p_brand = 'Brand#23'")


def q17_node_args(dev, query=None) -> dict:
    """The snapshot_join_agg node's arguments as the port's planner binds
    bench_q17's statements (or `query` over the same sources)."""
    async def go():
        s = Session(device=dev)
        for stmt in Q17_DDL[:-1]:
            await s.execute(stmt)
        last = Q17_DDL[-1] if query is None else (
            f"CREATE SINK q AS {query} WITH (connector='blackhole_device')")
        st = sql_parse(last)
        plan = StreamPlanner(s.catalog, config=s.config).plan_sink(
            st.select, st.options)
        for f in plan.graph.fragments.values():
            n = f.root
            while n.kind != "snapshot_join_agg" and n.inputs \
                    and not isinstance(n.inputs[0], Exchange):
                n = n.inputs[0]
            if n.kind == "snapshot_join_agg":
                return dict(n.args)
        raise AssertionError("no snapshot_join_agg node")
    return asyncio.run(go())


class _Schema:
    def __init__(self, sch):
        self.schema = sch
        self.pk_indices = ()


def q17_executor(args: dict, dev) -> SnapshotJoinAggExecutor:
    a = {k: v for k, v in args.items() if k != "durable"}
    return SnapshotJoinAggExecutor(_Schema(tpch.LINEITEM_SCHEMA),
                                   _Schema(tpch.PART_SCHEMA), device=dev,
                                   **a)


def flush_steps_err(ex, key_valid=None):
    """Every K15/K16 step of ex's flush on the card against its plain
    version on the same inputs (with `key_valid` replacing the fact
    key's validity). Returns (K15 err, K16 err, the step inputs)."""
    kv = ex._fvalids[ex.fact_key] if key_valid is None else key_valid
    fk = ex._fcols[ex.fact_key]
    skey = sja.sort_keys(fk, kv, ex._fn)
    e15 = exact_err([skey], [sja.sort_keys_plain(fk, kv, ex._fn)])
    sfk, order = stable_sort(skey)
    used = ex._used
    take_in = ([ex._fcols[i] for i in used], [ex._fvalids[i] for i in used])
    cu, vu = sja.take_rows(*take_in, order)
    cp, vp = sja.take_rows_plain(*take_in, order)
    e15 = max(e15, exact_err(cu + vu, cp + vp))
    cols_s, valids_s = list(ex._fcols), list(ex._fvalids)
    for i, c, v in zip(used, cu, vu):
        cols_s[i], valids_s[i] = c, v
    env = [Column(c, v) for c, v in zip(cols_s, valids_s)]
    sub_pred = (ex._sub_filter_prog.eval(env)[0]
                if ex._sub_filter_prog is not None else None)
    seg = (sfk, order, ex._fn, sub_pred, ex.sub_agg_calls, cols_s,
           valids_s)
    gid, outs, gex = sja.segment_reduce(*seg)
    gid_p, outs_p, gex_p = sja.segment_reduce_plain(*seg)
    e15 = max(e15, exact_err([gid, gex], [gid_p, gex_p]),
              columns_err(outs, outs_p))
    items = ex._sub_items_prog.eval(outs)
    it_in = ([c.data for c in items], [c.valid for c in items])
    rd, rv = sja.take_rows(*it_in, gid)
    pd, pv = sja.take_rows_plain(*it_in, gid)
    e15 = max(e15, exact_err(rd + rv, pd + pv))
    row_sub = [Column(d, v) for d, v in zip(rd, rv)]
    preds = []
    if ex._residue_prog is not None:
        preds.append(ex._residue_prog.eval(env + row_sub)[0])
    if ex._fact_filter_prog is not None:
        preds.append(ex._fact_filter_prog.eval(env)[0])
    dkey = sja.sort_keys(ex._dkeys, None, ex._dn)
    e16 = exact_err([dkey], [sja.sort_keys_plain(ex._dkeys, None, ex._dn)])
    sd, _ = stable_sort(dkey)
    fin = (sfk, order, ex._fn, sd, ex._dn,
           gex if ex.sub_filter is not None else None, gid, preds,
           ex.final_agg_calls, cols_s, valids_s)
    fo = sja.final_reduce(*fin)
    e16 = max(e16, columns_err(fo, sja.final_reduce_plain(*fin)))
    cur = ex._final_prog.eval(fo)
    dev = sfk.device
    prev = [torch.full((), 3, dtype=p.dtype, device=dev) for p in ex._prev]
    prev_valid = [torch.ones((), dtype=torch.bool, device=dev)
                  for _ in ex._prev]
    for emitted in (False, True):
        em = torch.tensor(emitted, device=dev)
        a = [p.clone() for p in prev], [v.clone() for v in prev_valid], \
            em.clone()
        b = [p.clone() for p in prev], [v.clone() for v in prev_valid], \
            em.clone()
        ca, oa, va = sja.final_diff(cur, *a)
        cb, ob, vb = sja.final_diff_plain(cur, *b)
        e16 = max(e16, columns_err(ca, cb), exact_err(
            [oa, va, *a[0], *a[1], a[2]], [ob, vb, *b[0], *b[1], b[2]]))
    value = None
    if bool(cur[0].valid_mask()[0]):
        value = float(cur[0].data[0])
    return e15, e16, dict(sfk=sfk, order=order, gid=gid, cols_s=cols_s,
                          valids_s=valids_s, take_in=take_in, items=it_in,
                          preds=preds, sd=sd, cur=cur, prev=prev,
                          prev_valid=prev_valid,
                          emitted=torch.tensor(True, device=dev),
                          value=value)


def q17_summary(runs: list, rows_key: str = "measured_rows") -> dict:
    rates = [r[rows_key] / r["wall_s"] for r in runs]
    lat = [x for r in runs for x in r["barrier_lat_s"]]
    return dict(
        repeats=len(runs),
        wall_s=statistics.median(r["wall_s"] for r in runs),
        lineitem_rows_per_s=statistics.median(rates),
        lineitem_rows_per_s_min=min(rates),
        lineitem_rows_per_s_max=max(rates),
        barrier_p50_s=statistics.median(lat) if lat else None,
        barrier_max_s=max(lat) if lat else None,
        mem_peak_bytes=max(r["mem_peak_bytes"] for r in runs),
        runs=[dict(wall_s=r["wall_s"], rows_per_s=rt,
                   barrier_p50_s=statistics.median(r["barrier_lat_s"]),
                   barrier_max_s=max(r["barrier_lat_s"]),
                   mem_peak_bytes=r["mem_peak_bytes"])
              for r, rt in zip(runs, rates)])


def phase_q17_full(dev, repeats: int = 5) -> dict:
    """bench_q17's statements through Session(device="cuda") at bench's
    quota: one warmup barrier, then 64 x 8192 measured lineitem rows (4
    barriers of 16 chunks), `repeats` runs from fresh state; every q17
    kernel launched, errs [0, 0, 0]; the plan holds the fused executor."""
    rounds = 1 + Q17_QUOTA_CHUNKS * Q17_CS // Q17_PER_BARRIER
    runs = []
    for _ in range(repeats):
        r = q17_run(dev, rounds)
        q17_gates(r)
        ex = r["ex"]
        runs.append(dict(
            {k: r[k] for k in ("lineitem", "parts", "measured_rows",
                               "wall_s", "barrier_lat_s", "mem_peak_bytes",
                               "launches")},
            fact_rows=int(ex._fn), fact_slots=ex.capacity,
            dim_rows=int(ex._dn), errs=ex.errs(),
            executor=type(ex).__name__))
        # a run's stores are freed before the next run starts
        del r, ex
    first = runs[0]
    return dict(
        barriers=rounds, **{k: first[k] for k in (
            "lineitem", "parts", "measured_rows", "fact_rows", "fact_slots",
            "dim_rows", "errs", "executor")},
        **q17_summary(runs), launches=first["launches"])


def phase_q17_profile(dev, full: dict) -> dict:
    """Where q17's time goes: a fresh run of bench's quota under
    torch.profiler; the idle share against phase q17_full's unprofiled
    median wall per measured barrier."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rounds = full["barriers"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        r = q17_run(dev, rounds)
        torch.cuda.synchronize()
    kev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict = {}
    for e in kev:
        name = e.name[:60]
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + e.time_range.elapsed_us(), c + 1)
    busy_s = sum(t for t, _ in by_name.values()) / 1e6
    # the warmup barrier's device work is in the window too: per barrier
    busy_per_barrier = busy_s / rounds
    wall_per_barrier = full["wall_s"] / (rounds - 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:16]
    return dict(
        rounds=rounds, wall_s=r["wall_s"], device_busy_s=busy_s,
        device_busy_per_barrier_s=busy_per_barrier,
        unprofiled_wall_per_barrier_s=wall_per_barrier,
        device_idle_share=(1 - busy_per_barrier / wall_per_barrier)
        if kev else None,
        device_events=len(kev),
        top_kernels=[{"name": nm, "ms": t / 1e3, "count": c}
                     for nm, (t, c) in top])


def phase_q17_sf1(dev) -> dict:
    """The same statements until the lineitem offset reaches TPC-H SF1's
    lineitem count (6,001,215): the fact store grows from 2^20 to 2^23
    slots. The last emitted value must equal the numpy recount exactly;
    the last flush is timed again alone by CUDA events."""
    rounds = -(-TPCH_SF1_LINEITEM // Q17_PER_BARRIER)
    r = q17_run(dev, rounds)
    q17_gates(r)
    ex = r["ex"]
    n_li, n_part = int(ex._fn), r["parts"]
    if n_li != rounds * Q17_PER_BARRIER or ex.capacity != 1 << 23:
        raise AssertionError(f"q17 sf1: {n_li} rows in {ex.capacity} slots")
    got = float(ex._prev[0]) if bool(ex._prev_valid[0]) else None
    want = q17_recount(n_li, n_part, dev)
    if got != want:
        raise AssertionError(f"q17 sf1: emitted {got}, recount {want}")
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    s.record()
    ex._flush()
    e.record()
    torch.cuda.synchronize()
    return dict(
        barriers=rounds, lineitem=n_li, parts=n_part,
        fact_slots=ex.capacity, value=got, recount=want,
        last_flush_ms=s.elapsed_time(e), errs=ex.errs(),
        **q17_summary([r]))


def phase_q17_check(dev) -> dict:
    """Correctness: bench_q17's statements with a 2^17-slot fact store
    (it grows to 2^20 over 8 barriers), into a device sink that keeps
    rows: at every barrier the emitted value equals the numpy recount
    over the rows the executor held at its flush (r x 16 chunks) and the
    part prefix (r chunks), errs [0, 0, 0]. Then the shapes of
    tests/test_snapshot_join_agg.py (sub WHERE, no residue, MIN), once
    each at small size, against their numpy recounts."""
    rounds = 8
    r, got = q17_check_run(dev, rounds, capacity=1 << 17)
    q17_gates(r)
    if r["ex"].capacity < 1 << 19:
        raise AssertionError(f"q17 check: the store grew only to "
                             f"{r['ex'].capacity} slots")
    return dict(barriers=rounds, capacity=r["ex"].capacity, values=got,
                errs=r["ex"].errs(), shapes=q17_shapes(dev))


def q17_check_run(dev, rounds: int, li_chunk: int = Q17_CS,
                  part_chunk: int = Q17_PART_CHUNK,
                  capacity: int = 1 << 20):
    """q17_run into a collecting sink; the executor must flush exactly
    r x 16 lineitem chunks at barrier r, and the value the sink holds
    after each barrier must equal the numpy recount over those rows and
    r part chunks. Returns (the run, the values)."""
    r = q17_run(dev, rounds, li_chunk, part_chunk, capacity, collect=True)
    per_li = 16 * li_chunk
    want_fns = [k * per_li for k in range(1, rounds + 1)]
    if r["fns"] != want_fns:
        raise AssertionError(f"q17 check: flush counts {r['fns']}, "
                             f"want {want_fns}")
    li = tpch_prefix("lineitem", want_fns[-1], dev)
    part = tpch_prefix("part", rounds * part_chunk, dev)
    got = q17_emitted(r)
    want = [q17_recount(n, (k + 1) * part_chunk, dev, li, part)
            for k, n in enumerate(want_fns)]
    if got != want:
        raise AssertionError(f"q17 check: emitted {got}, recount {want}")
    return r, got


# tests/test_snapshot_join_agg.py's shapes, each with a numpy recount
# over (lineitem columns, part columns, brand id of 'Brand#23')
def _shape_sub_where(li, part, wb):
    pk, q = li[1], li[2]
    seen = set(part[0].tolist())
    high = Counter(p for p, x in zip(pk.tolist(), q.tolist()) if x > 48)
    n = sum(1 for p, x in zip(pk.tolist(), q.tolist())
            if p in seen and p in high and x < high[p] + 100)
    return (n,)


def _shape_min(li, part, wb):
    pk, q = li[1].tolist(), li[2].tolist()
    ok = {k for k, b in zip(part[0].tolist(), part[1].tolist()) if b == wb}
    mq: dict = {}
    for p, x in zip(pk, q):
        if x > 3:
            mq[p] = min(mq.get(p, 10**9), x)
    n = sq = 0
    for p, x in zip(pk, q):
        if p in ok and p in mq and x <= mq[p]:
            n += 1
            sq += x
    return (n, sq if n else None)


def _shape_no_residue(li, part, wb):
    pk, q = li[1].tolist(), li[2].tolist()
    ok = {k for k, b in zip(part[0].tolist(), part[1].tolist()) if b == wb}
    rows = [x for p, x in zip(pk, q) if p in ok]
    return (sum(rows) if rows else None, max(rows) if rows else None)


Q17_SHAPES = {
    "sub_where": (
        "SELECT count(*) AS n FROM lineitem L "
        "JOIN part P ON P.p_partkey = L.l_partkey "
        "JOIN (SELECT l_partkey AS k, count(l_quantity) AS c "
        "      FROM lineitem WHERE l_quantity > 48 GROUP BY l_partkey) A "
        "  ON A.k = L.l_partkey AND L.l_quantity < A.c + 100",
        _shape_sub_where),
    "min": (
        "SELECT count(L.l_extendedprice) AS n, sum(L.l_quantity) AS sq "
        "FROM lineitem L "
        "JOIN part P ON P.p_partkey = L.l_partkey "
        "JOIN (SELECT l_partkey AS k, min(l_quantity) AS mq "
        "      FROM lineitem WHERE l_quantity > 3 GROUP BY l_partkey) A "
        "  ON A.k = L.l_partkey AND L.l_quantity <= A.mq "
        "WHERE P.p_brand = 'Brand#23'", _shape_min),
    "no_residue": (
        "SELECT sum(L.l_quantity) AS sq, max(L.l_quantity) AS mq "
        "FROM lineitem L JOIN part P ON P.p_partkey = L.l_partkey "
        "JOIN (SELECT l_partkey AS k, count(*) AS n FROM lineitem "
        "      GROUP BY l_partkey) A ON A.k = L.l_partkey "
        "WHERE P.p_brand = 'Brand#23'", _shape_no_residue),
}


def q17_shapes(dev, rounds: int = 3, li_chunk: int = 512,
               part_chunk: int = 256) -> dict:
    """Each of Q17_SHAPES through the session (512-row lineitem chunks,
    16 a barrier, 256-row part chunks) into a collecting sink; the final
    row must equal its recount."""
    out = {}
    wb = tpch.vocab_ids()["tpch_brand"][tpch.BRANDS.index("Brand#23")]
    for name, (query, recount) in Q17_SHAPES.items():
        ddl = q17_ddl(li_chunk, part_chunk)[:-1] + [
            f"CREATE SINK q17 AS {query} WITH (connector='blackhole_device')"]
        r = q17_run(dev, rounds, li_chunk, part_chunk, collect=True,
                    ddl=ddl)
        if r["ex"].errs() != [0, 0, 0]:
            raise AssertionError(f"q17 shape {name}: errs {r['ex'].errs()}")
        sink = r["sink"]
        cols, sign, _ = sink.arrays()
        valid = [v[:sign.size].cpu().numpy() for v in sink.valid]
        last = max(i for i in range(sign.size) if sign[i] > 0)
        got = tuple(int(c[last]) if v[last] else None
                    for c, v in zip(cols, valid))
        n_li = rounds * 16 * li_chunk
        want = recount(tpch_prefix("lineitem", n_li, dev),
                       tpch_prefix("part", rounds * part_chunk, dev), wb)
        if got != want or not any(want):
            raise AssertionError(f"q17 shape {name}: {got} vs {want}")
        out[name] = list(got)
    return out


# ------------------------------------------------------------- q1 (SQL)

# bench.py's bench_q1 statements, verbatim
Q1_DDL = [
    "SET streaming_durability = 0",
    "SET streaming_watchdog = 0",
    ("CREATE SOURCE bid WITH (connector='nexmark', table='bid', "
     "chunk_size=131072)"),
    ("CREATE SINK q1 AS SELECT auction, bidder, "
     "price * 0.908 AS price, date_time FROM bid "
     "WITH (connector='blackhole_device')"),
]
Q1_KERNELS = ("nexmark_bid", "expr_eval")


def q1_run(dev, rounds: int, chunk: int = 131072, per_barrier: int = 8,
           collect: int = 0) -> dict:
    """bench_q1's statements (chunk size swapped in when not bench's)
    through the port's Session: the bid source throttled to
    `per_barrier` chunks a barrier before the sink starts, each of
    `rounds` barriers injected once it has emitted them, the last the
    Stop. With collect > 0 a device sink keeps up to that many rows."""
    async def go():
        s = Session(device=dev)
        ddl = [st.replace("chunk_size=131072", f"chunk_size={chunk}")
               for st in Q1_DDL]
        for stmt in ddl[:-1]:
            await s.execute(stmt)
        s.throttle_source("bid", per_barrier * chunk)
        held = {}
        if collect:
            def attach(name, dep, fid):
                root = dep.roots[fid][0]
                actor = next(a for a in dep.actors if a.consumer is root)
                actor.consumer = held["sink"] = DeviceCollectSinkExecutor(
                    root, collect, dev)
            s.build_hooks.append(attach)
        kernels.reset_launch_counts()
        await s.execute(ddl[-1])
        dep = s.catalog.sinks["q1"].deployment
        gen = dep.executors(SourceExecutor)[0].connector
        t0 = time.perf_counter()
        for r in range(1, rounds + 1):
            while gen.offset < r * per_barrier * chunk:
                for t in dep.tasks:
                    if t.done():
                        t.result()
                await asyncio.sleep(0)
            if r < rounds:
                b = await s.coord.inject_barrier()
                await s.coord.wait_collected(b)
            else:
                await s.coord.stop_all({a.actor_id for a in dep.actors})
        wall = time.perf_counter() - t0
        await asyncio.gather(*dep.tasks)
        launches = {k.name: k.launches for k in kernels.KERNELS.values()}
        s.catalog.sinks.pop("q1")
        return dict(bids=gen.offset, wall_s=wall, launches=launches,
                    sink=held.get("sink"), coord=s.coord)

    return asyncio.run(go())


def q1_check(dev, chunk: int = 1024, per: int = 2, rounds: int = 4) -> int:
    """bench_q1's statements at `chunk`-bid chunks into a sink that keeps
    the rows: every row an insert, equal to the numpy recount of the
    projection (price * 0.908 in float64). Returns the rows checked."""
    r = q1_run(dev, rounds, chunk, per, collect=rounds * per * chunk)
    cols, sign, dropped = r["sink"].arrays()
    n = r["bids"]
    vocabs = {k: torch.tensor(v, dtype=torch.int32, device=dev)
              for k, v in vocab_ids().items()}
    bid = [c.cpu().numpy() for c in gen_bid_columns_plain(
        0, n, NexmarkConfig(), vocabs, dev)]
    want = [bid[0], bid[1], bid[2].astype(np.float64) * 0.908, bid[5]]
    ok = (not dropped and n == rounds * per * chunk and sign.size == n
          and (sign == 1).all()
          and all(np.array_equal(g, w) for g, w in zip(cols, want)))
    if not ok:
        raise AssertionError("q1 output differs from the numpy recount")
    return n


def phase_q1_full(dev, repeats: int = 3, rounds: int = 8) -> dict:
    """bench_q1's statements through Session(device="cuda"), `repeats`
    runs of `rounds` barriers of 8 x 131072 bids: K1 and K5 launched;
    then 4 barriers at 1024-bid chunks into a sink that keeps the rows,
    which must equal a numpy recount (price * 0.908 in float64)."""
    runs = []
    for _ in range(repeats):
        r = q1_run(dev, rounds)
        missing = [k for k in Q1_KERNELS if r["launches"][k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on q1: {missing}")
        runs.append(dict(bids=r["bids"], wall_s=r["wall_s"],
                         bids_per_s=r["bids"] / r["wall_s"],
                         barrier_p50_s=r["coord"].barrier_latency_percentile(
                             0.5),
                         launches=r["launches"]))
    n = q1_check(dev)
    rates = [x["bids_per_s"] for x in runs]
    return dict(barriers=rounds, bids=runs[0]["bids"], repeats=repeats,
                bids_per_s=statistics.median(rates),
                bids_per_s_min=min(rates), bids_per_s_max=max(rates),
                barrier_p50_s=statistics.median(x["barrier_p50_s"]
                                                for x in runs),
                check_rows=n, launches=runs[0]["launches"])


def q5_full_run(dev, cfg: NexmarkConfig, chunk: int, cap: int,
                per_barrier: int, rounds: int) -> dict:
    """One full-width q5 run from fresh state, checked: counts set to 0
    just before the drive and read just after."""
    q5 = build_q5(dev, chunk, cap, cfg.inter_event_us, per_barrier,
                  materialize=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    wall = asyncio.run(drive_paced(q5, per_barrier, rounds))
    launches = {k.name: k.launches for k in kernels.KERNELS.values()}
    torch.cuda.synchronize()
    agg, coord, gen = q5["agg"], q5["coord"], q5["gen"]
    overflow = agg.overflow()
    if overflow:
        raise AssertionError(f"q5 device overflow {overflow}")
    missing = [k for k in Q5_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on q5: {missing}")
    t0 = time.perf_counter()
    got = live_groups(agg)
    lo = first_bid_at_or_after(agg.cleaned_below, cfg)
    want = recount_windows(lo, gen.offset, cfg, agg.cleaned_below, dev)
    recount_s = time.perf_counter() - t0
    if got != want:
        diff = set(got.items()) ^ set(want.items())
        raise AssertionError(
            f"q5 live groups differ from the recount: {len(got)} vs "
            f"{len(want)} groups, {len(diff)} differing entries")
    return dict(
        bids=gen.offset, wall_s=wall, bids_per_s=gen.offset / wall,
        barrier_p50_s=coord.barrier_latency_percentile(0.5),
        barrier_p99_s=coord.barrier_latency_percentile(0.99),
        live_groups=len(got), cleaned_below=agg.cleaned_below,
        overflow=overflow, rebuilds=agg.rebuilds, recount_s=recount_s,
        mem_allocated_bytes=torch.cuda.memory_allocated(dev),
        mem_peak_bytes=torch.cuda.max_memory_allocated(dev),
        launches=launches)


Q5_KERNELS = ("nexmark_bid", "hop_window", "hash_table", "hash_agg",
              "compact")
# the path whose run gives each kernel's launches in the kernels line:
# the slice that ported it (K12 closes q5's flush compaction)
KERNEL_PATH = {"nexmark_bid": "q5", "hop_window": "q5", "hash_table": "q5",
               "hash_agg": "q5", "compact": "q5", "expr_eval": "q7",
               "row_id": "q7", "sorted_join_probe": "q7",
               "sorted_join_merge": "q7", "nexmark_person": "q8",
               "nexmark_auction": "q8", "radix_sort": "q8", "tpch": "q17",
               "snapshot_append": "q17", "segment_agg": "q17",
               "snapshot_final": "q17", "snapshot_diff": "q7d",
               "persist_view": "q7d", "pk_net": "q5t",
               "top_n_rank": "q5t", "top_n_diff": "q5t",
               "filter_ops": "q2", "window_scan": "q6",
               "window_diff": "q6", "simple_agg": "gagg",
               "extrema_update": "q5c", "agg_flush": "q5c",
               "outer_join": "lj", "dynamic_filter": "dynf",
               "hll_update": "acd", "backfill_filter": "mvmv",
               "hash_join_probe": "hj", "hash_join_update": "hj",
               "hash_join_pack": "hj"}


def phase_q5_full(dev, repeats: int = 5) -> dict:
    """q5 at full width into the device blackhole sink, `repeats` times
    on the same data: the first run's launches feed the kernels line,
    the medians and the min..max of the runs are the phase's numbers."""
    chunk, cap = 131072, 1 << 20
    per_barrier, rounds = 32 * chunk, 14
    cfg = NexmarkConfig(inter_event_us=2)
    runs = [q5_full_run(dev, cfg, chunk, cap, per_barrier, rounds)
            for _ in range(repeats)]
    first = runs[0]

    def spread(key):
        vals = [r[key] for r in runs]
        return statistics.median(vals), min(vals), max(vals)

    (rate, rate_lo, rate_hi) = spread("bids_per_s")
    return dict(
        bids=first["bids"], hop_rows=first["bids"] * (SIZE_US // SLIDE_US),
        barriers=rounds, chunks=first["bids"] // chunk, repeats=repeats,
        wall_s=spread("wall_s")[0], bids_per_s=rate,
        bids_per_s_min=rate_lo, bids_per_s_max=rate_hi,
        barrier_p50_s=spread("barrier_p50_s")[0],
        barrier_p99_s=spread("barrier_p99_s")[0],
        runs=[{k: r[k] for k in ("wall_s", "bids_per_s", "barrier_p50_s",
                                 "barrier_p99_s", "mem_peak_bytes")}
              for r in runs],
        **{k: first[k] for k in ("live_groups", "cleaned_below", "overflow",
                                 "rebuilds", "recount_s",
                                 "mem_allocated_bytes", "mem_peak_bytes",
                                 "launches")})


def phase_q5_profile(dev, full: dict, rounds: int = 4,
                     host: bool = False) -> dict:
    """Where q5's time goes: a fresh full-width run of a few barriers
    under torch.profiler. Device busy = the sum of kernel times on the
    card (one stream, so they do not overlap). The idle share is 1 -
    device busy per chunk over phase 3's unprofiled median wall per
    chunk; the share against the profiled run's own wall (which the
    profiler stretches) is kept beside it. Kernel names are cut to 60
    characters."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    chunk = 131072
    per_barrier = 32 * chunk
    q5 = build_q5(dev, chunk, 1 << 20, 2, per_barrier, materialize=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = asyncio.run(drive_paced(q5, per_barrier, rounds))
        torch.cuda.synchronize()
    kev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict = {}
    for e in kev:
        name = e.name[:60]
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + e.time_range.elapsed_us(), c + 1)
    busy_s = sum(t for t, _ in by_name.values()) / 1e6
    chunks = q5["gen"].offset // chunk
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    busy_per_chunk = busy_s / chunks
    wall_per_chunk = full["wall_s"] / full["chunks"]
    return dict(
        rounds=rounds, chunks=chunks, wall_s=wall, device_busy_s=busy_s,
        device_busy_per_chunk_s=busy_per_chunk,
        unprofiled_wall_per_chunk_s=wall_per_chunk,
        device_idle_share=(1 - busy_per_chunk / wall_per_chunk)
        if kev else None,
        device_idle_share_profiled=(1 - busy_s / wall) if kev else None,
        device_events=len(kev),
        top_kernels=[{"name": n, "ms": t / 1e3, "count": c}
                     for n, (t, c) in top],
        **({"host_top": host_profile(dev, rounds)} if host else {}))


def host_profile(dev, rounds: int) -> list:
    """The host's share: the same run under cProfile, the functions with
    the most own time (cProfile slows every Python call, so read the
    order, not the absolute times)."""
    import cProfile
    import pstats
    chunk = 131072
    per_barrier = 32 * chunk
    q5 = build_q5(dev, chunk, 1 << 20, 2, per_barrier, materialize=False)
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    asyncio.run(drive_paced(q5, per_barrier, rounds))
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:12]
    return [{"fn": f"{os.path.basename(f)}:{line}({name})",
             "tottime_s": tt, "ncalls": nc}
            for (f, line, name), (_, nc, tt, _, _) in rows]


def phase_q5_mv(dev) -> dict:
    """test_q5_core_end_to_end's shape on the card, into an MV."""
    chunk, per_barrier, rounds = 128, 512, 4
    cfg = NexmarkConfig(inter_event_us=50_000)
    q5 = build_q5(dev, chunk, 1 << 12, 50_000, per_barrier,
                  materialize=True)
    asyncio.run(drive_paced(q5, per_barrier, rounds))
    got = mv_groups(q5["mv"])
    want = recount_windows(0, q5["gen"].offset, cfg, -(1 << 62), dev)
    if got != want:
        raise AssertionError(f"q5 MV differs from the recount: {len(got)} "
                             f"vs {len(want)} groups")
    if len(got) <= 20:
        raise AssertionError("q5 MV: windows did not roll")
    return dict(groups=len(got), bids=q5["gen"].offset)


# ------------------------------------------------- q7 and q7d (SQL)

# bench.py's _q7_ddl() statements, verbatim (cs = 131072)
Q7_DDL = [
    "SET streaming_durability = 0",
    "SET streaming_watchdog = 0",
    f"SET streaming_join_capacity = {1 << 19}",
    "SET streaming_join_match_factor = 2",
    f"SET streaming_agg_capacity = {1 << 13}",
    ("CREATE SOURCE bid WITH (connector='nexmark', table='bid', "
     f"chunk_size=131072, inter_event_us=250, emit_watermarks=1, "
     f"watermark_lag_us={2 * W})"),
    ("CREATE SINK q7 AS "
     "SELECT B.auction, B.price, B.bidder, B.date_time "
     "FROM bid B JOIN ("
     "  SELECT max(price) AS maxprice, window_end "
     f"  FROM TUMBLE(bid, date_time, {W}) GROUP BY window_end) B1 "
     "ON B.price = B1.maxprice "
     f"AND B.date_time > B1.window_end - {W} "
     "AND B.date_time <= B1.window_end "
     "WITH (connector='blackhole_device')"),
]
# bench.py's bench_q7d statements, verbatim: durable q7 as a sink over a
# Hummock store on a local-fs object store, two checkpoints in flight
Q7D_DDL = [
    "SET streaming_durability = 1",
    "SET streaming_watchdog = 0",
    "SET checkpoint_max_inflight = 2",
    f"SET streaming_join_capacity = {1 << 18}",
    "SET streaming_join_match_factor = 2",
    f"SET streaming_agg_capacity = {1 << 13}",
    ("CREATE SOURCE bid WITH (connector='nexmark', table='bid', "
     f"chunk_size=32768, inter_event_us=250, emit_watermarks=1, "
     f"watermark_lag_us={2 * W})"),
    ("CREATE SINK q7 AS "
     "SELECT B.auction, B.price, B.bidder, B.date_time "
     "FROM bid B JOIN ("
     "  SELECT max(price) AS maxprice, window_end "
     f"  FROM TUMBLE(bid, date_time, {W}) GROUP BY window_end) B1 "
     "ON B.price = B1.maxprice "
     f"AND B.date_time > B1.window_end - {W} "
     "AND B.date_time <= B1.window_end "
     "WITH (connector='blackhole_device')"),
]
# bench.py's bench_q7_kill statement list, verbatim: the same shape as a
# materialized view, 8192-bid chunks, a 65536-row rate limit
Q7K_DDL = [
    "SET streaming_durability = 1",
    "SET streaming_watchdog = 0",
    "SET checkpoint_max_inflight = 2",
    f"SET streaming_join_capacity = {1 << 18}",
    "SET streaming_join_match_factor = 2",
    f"SET streaming_agg_capacity = {1 << 13}",
    ("CREATE SOURCE bid WITH (connector='nexmark', table='bid', "
     f"chunk_size=8192, inter_event_us=250, emit_watermarks=1, "
     f"watermark_lag_us={2 * W}, rate_limit=65536)"),
    ("CREATE MATERIALIZED VIEW q7 AS "
     "SELECT B.auction, B.price, B.bidder, B.date_time "
     "FROM bid B JOIN ("
     "  SELECT max(price) AS maxprice, window_end "
     f"  FROM TUMBLE(bid, date_time, {W}) GROUP BY window_end) B1 "
     "ON B.price = B1.maxprice "
     f"AND B.date_time > B1.window_end - {W} "
     "AND B.date_time <= B1.window_end"),
]
Q7D_CHUNK = 32768
# 8 chunks a barrier: 262144 bids, 71.2 s of event time, more than twice
# the lag plus the window, where q7_delete_misses' model is exact
Q7D_CHUNKS_PER_BARRIER = 8
Q7D_ROUNDS = 8
Q7K_CHUNK = 8192               # q7d_recover: one chunk a barrier (2.23 s)
Q7D_KERNELS = Q7_KERNELS + ("snapshot_diff", "persist_view")


def with_chunk(ddl: list, old: int, new: int) -> list:
    """A statement list with another chunk size (the CPU rehearsals)."""
    return [st.replace(f"chunk_size={old},", f"chunk_size={new},")
            for st in ddl]


def volatile(ddl: list) -> list:
    """The same statements with device-resident state only."""
    return [st.replace("SET streaming_durability = 1",
                       "SET streaming_durability = 0") for st in ddl]


def null_first(row: tuple) -> tuple:
    """A sort key of a row with NULLs (None) in it: a NULL before every
    value; rows without one sort as they are."""
    return tuple((v is not None, v) for v in row)


def session_run(dev, ddl: list, rounds: int, per_barrier: int,
                name: str = "q7", store=None, collect: int = 0,
                recover_to: int = 0, crash: bool = False, on_flow=None,
                on_barrier=None, pace=None, on_build=None) -> dict:
    """The statements `ddl` through the port's Session on `dev`, flow
    `name` (a sink or an MV; over `store`, a MemoryStateStore when None,
    or a function that opens the store, called on the clock of
    recovery_ms). Each source is paced by a schedule of cumulative rows
    at barriers 1, 2, ...: `pace` ({nexmark table: rows a barrier, or
    the cumulative rows at barriers 1..rounds, the last held after}; a
    constant p is the schedule k * p, and equal event-time spans for two
    sources) or else `per_barrier` a barrier. A build hook sets each
    source's limit for the first interval before it starts, and each
    barrier carries the next interval's limits as a ThrottleMutation,
    which the sources take with it. Barrier k follows every source's
    offset reaching base + its schedule at k, for k in 1..rounds (base
    0); the last is the Stop barrier, or with `crash` the session
    crashes there instead. With `recover_to`, the session replays the
    store's catalog (`recover()`, timed from the store's opening, or
    the session's construction, to its first collected barrier) instead
    of running `ddl`, base is the recovered offset and barriers run on
    until barrier `recover_to` counted from the start (constant paces
    only). Counts are set to 0 just before the flow starts and read just
    after the last barrier. `on_build(deployment)` runs in the build
    hook, before the flow starts; `on_flow(session, deployment)` once
    the flow exists; `on_barrier(k, session, rows)` after each collected
    barrier, with rows ({nexmark table: rows}) each source emitted
    before it. With `collect`, a DeviceCollectSinkExecutor of that many
    rows replaces the flow's root. The flow's first join, agg, top-N,
    over-window and simple agg executor (None where it has none) come
    back with the run's figures."""
    pace = pace or {}
    on_card = torch.device(dev).type == "cuda"

    def goal(table, k):
        p = pace.get(table, per_barrier)
        if isinstance(p, int):
            return k * p
        return p[min(k, len(p)) - 1] if k else 0

    async def go():
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        d2h.STATS.update(fetches=0, bytes=0)
        held = {}

        def attach(_name, dep, fid):
            for src_ in dep.executors(SourceExecutor):
                src_.rate_limit = goal(src_.connector.table, 1)
            if on_build is not None:
                on_build(dep)
            if collect:
                root = dep.roots[fid][0]
                actor = next(a for a in dep.actors if a.consumer is root)
                actor.consumer = held["sink"] = DeviceCollectSinkExecutor(
                    root, collect, dev)

        t_open = time.perf_counter()
        s = Session(device=dev, store=store() if callable(store) else store)
        s.build_hooks.append(attach)
        recovery_s = None
        if recover_to:
            await s.recover()
            if on_card:
                torch.cuda.synchronize()
            recovery_s = time.perf_counter() - t_open
        else:
            for stmt in ddl:
                await s.execute(stmt)
        flows = {**s.catalog.sinks, **s.catalog.mvs}
        dep = flows[name].deployment
        srcs = dep.executors(SourceExecutor)
        gen = srcs[0].connector
        paced = [x.connector for x in srcs]
        bases = [0] * len(srcs)
        n_rounds = rounds
        if recover_to:
            bases = [x.state_table.get_row((0,))[1] for x in srcs]
            n_rounds = recover_to - bases[0] // goal(paced[0].table, 1)
        base = bases[0]

        def first(cls):
            found = dep.executors(cls)
            return found[0] if found else None

        join = first(SortedJoinExecutor) or first(HashJoinExecutor)
        agg = first(HashAggExecutor)
        top = first(RetractableTopNExecutor)
        ow, sagg = first(GeneralOverWindowExecutor), first(SimpleAggExecutor)
        if on_flow is not None:
            on_flow(s, dep)
        coord = s.coord

        def check():
            for t in dep.tasks:
                if t.done():
                    t.result()

        t0 = time.perf_counter()
        for k in range(1, n_rounds + 1):
            while any(g.offset < b + goal(g.table, k)
                      for g, b in zip(paced, bases)):
                check()
                await asyncio.sleep(0)
            if k < n_rounds or crash:
                b = await coord.inject_barrier(ThrottleMutation(tuple(
                    (x.source_id, goal(g.table, k + 1) - goal(g.table, k))
                    for x, g in zip(srcs, paced))))
                await coord.wait_collected(b)
                if on_barrier is not None:
                    # the rows before this barrier (a source may have
                    # begun the next interval already)
                    on_barrier(k, s, {g.table: b0 + goal(g.table, k)
                                      for g, b0 in zip(paced, bases)})
            else:
                await coord.stop_all({a.actor_id for a in dep.actors})
        wall = time.perf_counter() - t0
        inflight = coord._inflight
        if crash:
            await s.crash()
        else:
            await asyncio.gather(*dep.tasks)
        launches = {k.name: k.launches for k in kernels.KERNELS.values()}
        if on_card:
            torch.cuda.synchronize()
        mv = s.catalog.mvs.get(name)
        out = dict(
            bids=gen.offset, base=base, barriers=n_rounds, wall_s=wall,
            offsets={g.table: g.offset for g in paced},
            inflight_at_end=inflight, join=join, agg=agg, top=top, ow=ow,
            sagg=sagg,
            sink=held.get("sink"), coord=coord, session=s,
            launches=launches, recovery_s=recovery_s,
            mv=(sorted(mv.table.iter_committed(), key=null_first)
                if mv is not None else None),
            d2h_fetches=d2h.STATS["fetches"], d2h_bytes=d2h.STATS["bytes"],
            persist_rows=sum(e.persist_rows for e in (join, agg, top, ow)
                             if e is not None),
            mem_peak_bytes=(torch.cuda.max_memory_allocated(dev)
                            if on_card else None))
        s.catalog.sinks.pop(name, None)
        s.catalog.mvs.pop(name, None)
        return out

    return asyncio.run(go())


def mv_counter(rows) -> Counter:
    """q7 MV rows (auction, price, bidder, date_time, _row_id, window_end)
    as q7_recount's rows."""
    return Counter((r[0], r[1], r[2], r[3], r[5]) for r in rows)


def q7d_full_run(dev, per_barrier: int, rounds: int, want_misses: int,
                 chunk: int = Q7D_CHUNK) -> dict:
    """One bench_q7d run from fresh state on a Hummock store over a
    local-fs object store in a temporary directory."""
    with tempfile.TemporaryDirectory(prefix="q7d_") as d:
        store = HummockStateStore(LocalFsObjectStore(d))
        r = session_run(dev, with_chunk(Q7D_DDL, Q7D_CHUNK, chunk), rounds,
                        per_barrier, store=store)
        coord, errs = r["coord"], r["join"].errs()
        ce = coord.committed_epochs
        drained = (coord._inflight == 0 and not store._sealed
                   and not store._shared and not store._deferred)
        if errs != [0, want_misses, 0] or r["agg"].overflow():
            raise AssertionError(
                f"q7d: join errs {errs} (want [0, {want_misses}, 0]), agg "
                f"overflow {r['agg'].overflow()}")
        if len(ce) != rounds or any(a >= b for a, b in zip(ce, ce[1:])) \
                or not drained or store.committed_epoch() != ce[-1]:
            raise AssertionError(f"q7d: committed epochs {ce} not strictly "
                                 f"increasing to the end, drained "
                                 f"{drained}")
        missing = [k for k in Q7D_KERNELS if r["launches"][k] == 0]
        if missing and torch.device(dev).type == "cuda":
            raise AssertionError(f"kernels never launched on q7d: {missing}")
        phases = coord.upload_phases
        return dict(
            bids=r["bids"], wall_s=r["wall_s"],
            bids_per_s=r["bids"] / r["wall_s"],
            barrier_p50_s=coord.barrier_latency_percentile(0.5),
            barrier_max_s=coord.barrier_latency_percentile(1.0),
            committed_epochs=len(ce), drained=drained,
            upload_overlap_pct=coord.upload_overlap_pct(),
            upload_busy_s=coord.upload_busy_ns / 1e9,
            backpressure_s=coord.backpressure_wait_ns / 1e9,
            seal_ms_p50=statistics.median(p[0] for p in phases) / 1e6,
            upload_ms_p50=statistics.median(p[1] for p in phases) / 1e6,
            commit_ms_p50=statistics.median(p[2] for p in phases) / 1e6,
            rows_fetched_per_ckpt=r["persist_rows"] / len(ce),
            bytes_fetched_per_ckpt=r["d2h_bytes"] / len(ce),
            fetches_per_ckpt=r["d2h_fetches"] / len(ce),
            sst_bytes=sum(os.path.getsize(os.path.join(dp, f))
                          for dp, _, fs in os.walk(d) for f in fs),
            join_errs=errs, mem_peak_bytes=r["mem_peak_bytes"],
            launches=r["launches"])


def phase_q7d_full(dev, repeats: int = 5, chunk: int = Q7D_CHUNK,
                   per_chunks: int = Q7D_CHUNKS_PER_BARRIER,
                   rounds: int = Q7D_ROUNDS) -> dict:
    """bench_q7d's statements verbatim, `repeats` runs, each from fresh
    state: `per_chunks` 32768-bid chunks a barrier, `rounds` barriers;
    then the same statements with streaming_durability = 0 over a
    MemoryStateStore, as many times, alternating, for the flush tax
    (the durable wall over the volatile wall, within this call)."""
    per_barrier = per_chunks * chunk
    want = q7_delete_misses(per_barrier * rounds, per_barrier,
                            NexmarkConfig(inter_event_us=250), dev)
    runs, vol = [], []
    for _ in range(repeats):
        runs.append(q7d_full_run(dev, per_barrier, rounds, want, chunk))
        v = session_run(dev,
                        volatile(with_chunk(Q7D_DDL, Q7D_CHUNK, chunk)),
                        rounds, per_barrier)
        if v["join"].errs() != [0, want, 0]:
            raise AssertionError(f"volatile q7 at q7d's chunking: join errs "
                                 f"{v['join'].errs()}")
        vol.append(dict(wall_s=v["wall_s"],
                        bids_per_s=v["bids"] / v["wall_s"],
                        barrier_p50_s=v["coord"].barrier_latency_percentile(
                            0.5)))
    first = runs[0]
    med = statistics.median
    d_wall = med(r["wall_s"] for r in runs)
    v_wall = med(v["wall_s"] for v in vol)
    keys = ("wall_s", "bids_per_s", "barrier_p50_s", "barrier_max_s",
            "upload_overlap_pct", "rows_fetched_per_ckpt",
            "bytes_fetched_per_ckpt", "mem_peak_bytes")
    return dict(
        chunk=chunk, chunks_per_barrier=per_chunks, barriers=rounds,
        bids=first["bids"], repeats=repeats, want_delete_misses=want,
        wall_s=d_wall, bids_per_s=med(r["bids_per_s"] for r in runs),
        barrier_p50_s=med(r["barrier_p50_s"] for r in runs),
        barrier_max_s=med(r["barrier_max_s"] for r in runs),
        volatile_wall_s=v_wall,
        volatile_bids_per_s=med(v["bids_per_s"] for v in vol),
        volatile_barrier_p50_s=med(v["barrier_p50_s"] for v in vol),
        flush_tax=d_wall / v_wall,
        runs=[{k: r[k] for k in keys} for r in runs], volatile_runs=vol,
        **{k: first[k] for k in (
            "committed_epochs", "drained", "upload_overlap_pct",
            "upload_busy_s", "backpressure_s", "seal_ms_p50",
            "upload_ms_p50", "commit_ms_p50", "rows_fetched_per_ckpt",
            "bytes_fetched_per_ckpt", "fetches_per_ckpt", "sst_bytes",
            "join_errs", "mem_peak_bytes", "launches")})


def phase_q7d_recover(dev, r1: int = 30, r2: int = 30,
                      chunk: int = Q7K_CHUNK) -> dict:
    """bench_q7_kill's statements (the MV) on a Hummock store, paced at
    one chunk a barrier (2.23 s of event time, under the lag minus the
    window, where q7_delete_misses models 0 misses): r1 barriers, then
    crash() (uploads in flight are abandoned), HummockStateStore.open
    on the directory, a new Session, recover() (recovery_ms: from the
    store's opening to the new session's first collected barrier), then barriers from the
    recovered offset to (r1 + r2) * chunk (r2, plus the epochs the crash
    dropped), then Stop. The MV must equal an
    uninterrupted durable run's to the same offset and the numpy
    recount; the join counts no error in either."""
    ddl = with_chunk(Q7K_DDL, Q7K_CHUNK, chunk)
    n = (r1 + r2) * chunk
    cfg = NexmarkConfig(inter_event_us=250)
    model = q7_delete_misses(n, chunk, cfg, dev)
    with tempfile.TemporaryDirectory(prefix="q7k_") as d1, \
            tempfile.TemporaryDirectory(prefix="q7k_") as d2:
        whole = session_run(dev, ddl, r1 + r2, chunk,
                            store=HummockStateStore(LocalFsObjectStore(d1)))
        a = session_run(dev, ddl, r1, chunk, crash=True,
                        store=HummockStateStore(LocalFsObjectStore(d2)))
        b = session_run(dev, ddl, 0, chunk, recover_to=r1 + r2,
                        store=lambda: HummockStateStore.open(
                            LocalFsObjectStore(d2)))
    want = q7_recount(n, cfg, dev)
    errs = [whole["join"].errs(), b["join"].errs()]
    if model != 0 or errs != [[0, 0, 0], [0, 0, 0]]:
        raise AssertionError(f"q7d_recover: model misses {model}, join "
                             f"errs {errs}")
    if whole["bids"] != n or b["bids"] != n:
        raise AssertionError(f"q7d_recover: offsets {whole['bids']}, "
                             f"{b['bids']} (want {n})")
    # row ids come from the barriers' epochs (the wall clock), so the
    # runs are compared on every other column, with multiplicity
    if mv_counter(b["mv"]) != mv_counter(whole["mv"]) \
            or mv_counter(b["mv"]) != want:
        raise AssertionError(
            f"q7d_recover: recovered MV ({len(b['mv'])} rows) differs from "
            f"the uninterrupted run's ({len(whole['mv'])}) or the recount "
            f"({sum(want.values())})")
    if len(want) < 10:
        raise AssertionError("q7d_recover: too few output rows to mean much")
    return dict(
        chunk=chunk, barriers_before_crash=r1, bids=n,
        uploads_in_flight_at_crash=a["inflight_at_end"],
        recovered_offset=b["base"], barriers_after_recovery=b["barriers"],
        recovery_ms=b["recovery_s"] * 1e3, mv_rows=len(b["mv"]),
        recount_rows=sum(want.values()), model_delete_misses=model,
        join_errs=errs, launches=b["launches"])


def q7d_capture(dev, rounds: int = 6) -> dict:
    """Real q7d state for the kernel checks: bench_q7d's statements at
    q7d_full's pacing, and at the last barrier each join side as it is
    and as of the barrier before (the diff's inputs), and the agg state
    before its persist."""
    cap: dict = {}

    def on_flow(s, dep):
        join = dep.executors(SortedJoinExecutor)[0]
        agg = dep.executors(HashAggExecutor)[0]
        diff_write, persist = join._persist_diff_write, agg._persist

        def rec_diff(st, cur, snap):
            side = 0 if st is join.state_tables[0] else 1
            cap[side] = (copy_side(None, cur), copy_side(None, snap))
            return diff_write(st, cur, snap)

        def rec_persist(barrier):
            a = agg.state
            cap["agg"] = AggState(
                ht.HashTable(tuple(k.clone() for k in a.table.keys),
                             a.table.occupied.clone()),
                tuple(x.clone() for x in a.agg_states), a.row_count.clone(),
                a.dirty.clone(), a.prev_exists.clone(),
                tuple(x.clone() for x in a.prev_emit))
            cap["wm"] = agg._pending_clean_wm
            return persist(barrier)

        join._persist_diff_write = rec_diff
        agg._persist = rec_persist

    with tempfile.TemporaryDirectory(prefix="q7d_") as d:
        session_run(dev, Q7D_DDL, rounds,
                    Q7D_CHUNKS_PER_BARRIER * Q7D_CHUNK,
                    store=HummockStateStore(LocalFsObjectStore(d)),
                    on_flow=on_flow)
    return cap


def side_store(dev, C: int, n: int, seed: int, dtypes, null_p: float = 0.0,
               dup_every: int = 0) -> SortedSideState:
    """A side store of capacity C with n live rows of random content:
    khash in [0, 2^62), columns of `dtypes`, NULL lanes with probability
    null_p, and every dup_every-th row a copy of the row before."""
    g = torch.Generator().manual_seed(seed)
    kh = torch.randint(0, 1 << 62, (C,), generator=g)
    cols, valids = [], []
    for dt in dtypes:
        if dt.is_floating_point:
            c = torch.randn(C, generator=g, dtype=torch.float64).to(dt) * 1e3
        else:
            c = torch.randint(-(1 << 40), 1 << 40, (C,), generator=g).to(dt)
        cols.append(c)
        valids.append(torch.rand(C, generator=g) >= null_p)
    if dup_every:
        src = torch.arange(C) - (torch.arange(C) % dup_every == dup_every - 1
                                 ).to(torch.int64)
        kh = kh[src]
        cols = [c[src] for c in cols]
        valids = [v[src] for v in valids]
    return SortedSideState(kh.to(dev), tuple(c.to(dev) for c in cols),
                           tuple(v.to(dev) for v in valids),
                           torch.zeros(C, dtype=torch.int32, device=dev),
                           torch.tensor(n, dtype=torch.int32, device=dev))


def mutate(st: SortedSideState, seed: int, frac: float) -> SortedSideState:
    """A copy of `st` with a fraction of its rows' first column changed
    and its rows rolled by one slot (a diff against it has both deletes
    and inserts)."""
    g = torch.Generator().manual_seed(seed)
    out = copy_side(None, st)
    C = st.capacity
    hit = (torch.rand(C, generator=g) < frac).to(st.khash.device)
    c0 = out.cols[0]
    out.cols[0].copy_(torch.where(hit, c0 + 1, c0))
    return SortedSideState(out.khash.roll(1), tuple(c.roll(1)
                                                    for c in out.cols),
                           tuple(v.roll(1) for v in out.valids),
                           out.degree, out.n)


def diff_err(cur, snap) -> tuple[int, int, int]:
    """K17 against its plain version on one pair: (max abs error over the
    counts and the counted rows, deletes, inserts)."""
    pk, ck = snapshot_diff(cur, snap)
    pp, cp = pack_diff_plain(cur, snap)
    nd, ni = (int(x) for x in cp)
    K = len(cur.cols)
    n = (nd + ni) * K
    err = max(exact_err([ck], [cp]), exact_err([pk[:n]], [pp[:n]]))
    return err, nd, ni


def phase_kernels_q7d(dev) -> dict:
    """K17 and K18 against their plain versions, exactly: on q7d's state
    (both join sides at C = 2^18 as a bench_q7d run holds them at a
    barrier, each against its snapshot from the barrier before, and the
    2^13-slot agg before its persist) and on edge cases."""
    cap = q7d_capture(dev)
    res = {}
    # ---- K17
    cases = {}
    for side in (0, 1):
        cur, snap = cap[side]
        cases[f"q7d_side{side}"] = (cur, snap)
    C = 1 << 14
    i64, f64 = torch.int64, torch.float64
    base = side_store(dev, C, C // 2, 1, (i64, i64, i64))
    cases["empty_diff"] = (base, copy_side(None, base))
    cases["all_changed"] = (base, side_store(dev, C, C // 2, 2,
                                             (i64, i64, i64)))
    dup = side_store(dev, C, C, 3, (i64, i64), dup_every=2)
    cases["duplicates"] = (dup, mutate(dup, 4, 0.1))
    nul = side_store(dev, C, C // 2, 5, (i64, i64, i64), null_p=0.3)
    cases["nulls"] = (nul, mutate(nul, 6, 0.1))
    flt = side_store(dev, C, C // 2, 7, (i64, f64))
    cases["float64"] = (flt, mutate(flt, 8, 0.1))
    full = side_store(dev, C, C, 9, (i64, i64, torch.int32))
    cases["full_store"] = (full, mutate(full, 10, 0.05))
    errs = {}
    for name, (cur, snap) in cases.items():
        errs[name] = diff_err(cur, snap)
        if errs[name][0]:
            raise AssertionError(f"K17 differs from plain on {name}: "
                                 f"{errs[name]}")
    if errs["empty_diff"][1:] != (0, 0) or errs["all_changed"][1] == 0:
        raise AssertionError(f"K17 edge cases did not bite: {errs}")
    cur, snap = cases["q7d_side0"]
    nd, ni = errs["q7d_side0"][1:]
    K = len(cur.cols)
    # what the diff must move: each side's live rows (slots < n) read
    # once, lanes and valid bits, and the changed rows and counts written
    row_bytes = sum(t.element_size()
                    for t in (cur.khash, *cur.cols, *cur.valids))
    live = int(cur.n) + int(snap.n)
    res["snapshot_diff"] = dict(
        max_abs_err=max(e[0] for e in errs.values()),
        cases={k: {"deletes": v[1], "inserts": v[2]}
               for k, v in errs.items()},
        **timings(lambda: snapshot_diff(cur, snap),
                  lambda: pack_diff_plain(cur, snap)),
        bound_ms=bytes_bound_ms(live * row_bytes + 2 * 4
                                + (nd + ni) * K * 8 + 16),
        bound_by="bytes")
    emit({"phase": "kernel", "name": "snapshot_diff",
          **res["snapshot_diff"]})
    # ---- K18
    st, wm = cap["agg"], cap["wm"]
    j = 0
    errs18 = {}

    def k18_err(state, jj, w):
        bk, ck = persist_pack(state, jj, w)
        bp, cp = persist_pack_plain(state, jj, w)
        nd, nev = (int(x) for x in cp)
        wp = 2 + len(state.table.keys) + len(state.agg_states) + 1
        n = nd * wp + nev * len(state.table.keys)
        return max(exact_err([ck], [cp]), exact_err([bk[:n]], [bp[:n]])), \
            nd, nev

    errs18["q7d_agg"] = k18_err(st, j if wm is not None else None, wm)
    wend = st.table.keys[0]
    occ = st.table.occupied
    lo = int(wend[occ].min()) if bool(occ.any()) else 0
    errs18["evict_none_below"] = k18_err(st, j, lo)
    errs18["evict_all"] = k18_err(st, j, 1 << 62)
    if any(e[0] for e in errs18.values()) or \
            errs18["evict_none_below"][2] != 0:
        raise AssertionError(f"K18 differs from plain: {errs18}")
    Ca = st.table.capacity
    nd = errs18["q7d_agg"][1]
    wp = 2 + len(st.table.keys) + len(st.agg_states) + 1
    cols = list(st.table.keys) + list(st.agg_states) + [st.row_count]
    # what the persist entry must move: the dirty byte of every slot, the
    # columns and prev_exists of the dirty rows, the packed rows and the
    # counts
    row_bytes = sum(c.element_size() for c in cols) \
        + st.prev_exists.element_size()

    def library():
        sel = torch.nonzero(st.dirty).squeeze(1)
        return [c.index_select(0, sel) for c in cols]

    res["persist_view"] = dict(
        max_abs_err=max(e[0] for e in errs18.values()),
        cases={k: {"dirty": v[1], "evicted": v[2]}
               for k, v in errs18.items()},
        **timings(lambda: persist_pack(st, None, None),
                  lambda: persist_pack_plain(st, None, None),
                  library_fn=library),
        bound_ms=bytes_bound_ms(Ca * st.dirty.element_size()
                                + nd * row_bytes + nd * wp * 8 + 16),
        bound_by="bytes")
    emit({"phase": "kernel", "name": "persist_view", **res["persist_view"]})
    return res


def phase_q7_check(dev, chunk: int = 32768, rounds: int = 40) -> dict:
    """The correctness gate: bench's _q7_ddl() statements through
    Session(device="cuda") with inter_event_us=250, one barrier per chunk
    of `chunk` bids (8.9 s of event time, under the lag minus the window,
    so the band cleaning never evicts a bid before its window's max
    arrives), into a device sink that keeps the output rows. Its net
    output must equal build_q7's hand wiring at the same geometry and a
    numpy recount; every error counter must be 0."""
    r = session_run(dev, with_chunk(Q7_DDL, 131072, chunk), rounds, chunk,
                    collect=1 << 16)
    got, dropped = r["sink"].rows()
    got = Counter({(x[0], x[1], x[2], x[3], x[5]): c
                   for x, c in got.items()})
    q7 = build_q7(dev, chunk, 250, chunk, collect=1 << 16)
    asyncio.run(drive_paced(q7, chunk, rounds))
    hand, hand_dropped = q7["head"].rows()
    hand = Counter({(x[0], x[1], x[2], x[3], x[5]): c
                    for x, c in hand.items()})
    want = q7_recount(r["bids"], NexmarkConfig(inter_event_us=250), dev)
    errs = [r["join"].errs(), q7["join"].errs()]
    overflow = [r["agg"].overflow(), q7["agg"].overflow()]
    if dropped or hand_dropped or errs != [[0, 0, 0]] * 2 or any(overflow):
        raise AssertionError(f"q7 check: dropped {dropped}/{hand_dropped}, "
                             f"join errs {errs}, agg overflow {overflow}")
    if got != hand or got != want:
        raise AssertionError(
            f"q7 output differs: session {sum(got.values())} rows, hand "
            f"wiring {sum(hand.values())}, recount {sum(want.values())}")
    if len(want) < 10:
        raise AssertionError("q7 check: too few output rows to mean much")
    return dict(bids=r["bids"], barriers=rounds, rows=len(want),
                output_changes=int(r["sink"].count), join_errs=errs[0],
                agg_overflow=overflow[0])


# ------------------------------------------------------- q5_topn and q2

# bench.py's _q5_topn_ddl() on one device: its mesh SET (8 devices)
# becomes 1, the rest verbatim
Q5T_DDL = [
    "SET streaming_parallelism_devices = 1",
    "SET streaming_durability = 0",
    "SET streaming_watchdog = 0",
    f"SET streaming_agg_capacity = {1 << 18}",
    f"SET streaming_top_n_capacity = {1 << 17}",
    ("CREATE SOURCE bid WITH (connector='nexmark', table='bid', "
     "chunk_size=32768, inter_event_us=2, emit_watermarks=1)"),
    ("CREATE SINK q5t AS SELECT auction % 65536 AS a, count(*) AS n "
     "FROM bid GROUP BY auction % 65536 "
     "ORDER BY n DESC LIMIT 10 "
     "WITH (connector='blackhole_device')"),
]
Q5T_CHUNK = 32768
Q5T_INTER_US = 2
Q5T_KERNELS = ("nexmark_bid", "expr_eval", "hash_table", "hash_agg",
               "compact", "radix_sort", "pk_net", "sorted_join_merge",
               "top_n_rank", "top_n_diff")


def q5_topn_recount(n_bids: int, modulus: int = 65536, limit: int = 10,
                    device="cpu", inter_event_us: int = Q5T_INTER_US,
                    auction=None) -> list:
    """The top `limit` (a, n) of count(*) per auction % modulus over bids
    [0, n_bids), ranked by (n desc, the port's key hash of a asc), as the
    top-N ranks them; from the plain generator unless `auction` (the
    bids' auction column) is given."""
    if auction is None:
        (auction,) = _bid_prefix(n_bids, NexmarkConfig(
            inter_event_us=inter_event_us), device, [0])
    a = np.remainder(np.asarray(auction[:n_bids]), modulus)
    counts = np.bincount(a, minlength=modulus)
    keys = np.flatnonzero(counts)
    n = counts[keys]
    kh = key_hash([torch.from_numpy(keys.astype(np.int64))]).numpy()
    top = np.lexsort((kh, -n))[:limit]
    return [(int(keys[i]), int(n[i])) for i in top]


# Nexmark q2 in Beam's form, as a sink at q7's chunk size
Q2_DDL = [
    "SET streaming_durability = 0",
    ("CREATE SOURCE bid WITH (connector='nexmark', table='bid', "
     "chunk_size=131072, inter_event_us=250, emit_watermarks=1)"),
    ("CREATE SINK q2 AS SELECT auction, price FROM bid "
     "WHERE auction % 123 = 0 WITH (connector='blackhole_device')"),
]
Q2_CHUNK = 131072
Q2_KERNELS = ("nexmark_bid", "expr_eval", "filter_ops")
# a WHERE over an aggregating subquery: every count update crosses
# `n % 2 = 0`, so update pairs reach the filter with one side failing
Q2_AGG_MV = ("CREATE MATERIALIZED VIEW q2 AS SELECT auction, n FROM "
             "(SELECT auction, count(*) AS n FROM bid GROUP BY auction) C "
             "WHERE n % 2 = 0")


def as_mv(ddl: list) -> list:
    """A sink statement list as the same query into an MV."""
    return [st.replace("CREATE SINK", "CREATE MATERIALIZED VIEW")
              .replace(" WITH (connector='blackhole_device')", "")
            for st in ddl]


def durable(ddl: list) -> list:
    return [st.replace("SET streaming_durability = 0",
                       "SET streaming_durability = 1") for st in ddl]


def mv_rows_now(s, name: str) -> list:
    return sorted(r for _, r in s.catalog.mvs[name].table.iter_all())


def q5t_store(dev, C: int = 1 << 17, groups: int = 65536, seed: int = 0):
    """A top-N store as a q5_topn run holds it: `groups` rows (a, n),
    a = 0..groups-1, counts with many ties, in C slots; and the chunk
    schema."""
    rng = np.random.default_rng(seed)
    sch = make_schema(("a", DataType.INT64), ("n", DataType.INT64))
    a = np.arange(groups, dtype=np.int64)
    n = 1 + rng.geometric(0.05, groups).astype(np.int64)
    ch = chunk_from_numpy(sch, [np.resize(a, C), np.resize(n, C)],
                          np.zeros(C, np.int8), np.arange(C) < groups,
                          device=dev)
    st = empty_sorted_side(C, [torch.int64, torch.int64], dev)
    errs = torch.zeros(3, dtype=torch.int32, device=dev)
    st = sorted_store_apply_plain(st, errs, ch, (0,))
    return st, sch, (a, n)


def q5t_changelog(dev, sch, a, n, N: int = 1 << 19, pairs: int = 65536,
                  seed: int = 1, runs: int = 0, misses: int = 0,
                  inserts: int = 0):
    """A hash agg's flush chunk at q5_topn's shape: `pairs` U-/U+ pairs
    (rows 2j, 2j+1) of existing groups, in N rows; `runs` groups get a
    second pair (a pk run), `misses` pairs retract absent groups, and
    `inserts` new groups arrive as Inserts."""
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(a), pairs, replace=False)
    rows = []
    for j, i in enumerate(pick):
        new = n[i] + int(rng.integers(1, 4))
        rows += [(2, a[i], n[i]), (3, a[i], new)]
        if j < runs:
            rows += [(2, a[i], new), (3, a[i], new + 1)]
    for m in range(misses):
        rows += [(2, 10**9 + m, 5), (3, 10**9 + m, 6)]
    for m in range(inserts):
        rows.append((0, 2 * 10**9 + m, 1))
    if len(rows) > N:
        raise ValueError("changelog larger than its chunk")
    ops = np.zeros(N, np.int8)
    ca = np.zeros(N, np.int64)
    cn = np.zeros(N, np.int64)
    arr = np.asarray(rows, dtype=np.int64)
    ops[:len(rows)], ca[:len(rows)], cn[:len(rows)] = arr.T
    return chunk_from_numpy(sch, [ca, cn], ops, np.arange(N) < len(rows),
                            device=dev)


def store_exact_err(a: SortedSideState, b: SortedSideState) -> int:
    return exact_err([a.khash, *a.cols, *a.valids, a.n.view(1)],
                     [b.khash, *b.cols, *b.valids, b.n.view(1)])


def topn_random_store(dev, C: int, n_rows: int, seed: int):
    """A store of (g, v, f, pk) rows for the edge cases: 4 groups, int
    order values with ties, float values with NaN, -0.0, +0.0, a
    subnormal and inf, NULL lanes."""
    rng = np.random.default_rng(seed)
    sch = make_schema(("g", DataType.INT64), ("v", DataType.INT64),
                      ("f", DataType.FLOAT64), ("pk", DataType.INT64))
    floats = np.array([np.nan, -0.0, 0.0, 1.5, -2.25, 1e-310, np.inf, 7.0])
    g = rng.integers(0, 4, C)
    v = rng.integers(0, 6, C)
    f = floats[rng.integers(0, len(floats), C)]
    pk = np.arange(C, dtype=np.int64)
    ch = chunk_from_numpy(sch, [g, v, f, pk], np.zeros(C, np.int8),
                          np.arange(C) < n_rows,
                          [None, rng.random(C) < 0.9, rng.random(C) < 0.9,
                           None], device=dev)
    st = empty_sorted_side(C, [torch.int64, torch.int64, torch.float64,
                               torch.int64], dev)
    errs = torch.zeros(3, dtype=torch.int32, device=dev)
    return sorted_store_apply_plain(st, errs, ch, (3,)), sch


def empty_top(st: SortedSideState):
    C = st.capacity
    dev = st.khash.device
    return (torch.full((C,), HSENTINEL, dtype=torch.int64, device=dev),
            tuple(torch.zeros(C, dtype=c.dtype, device=dev)
                  for c in st.cols),
            tuple(torch.zeros(C, dtype=torch.bool, device=dev)
                  for _ in st.cols),
            torch.zeros((), dtype=torch.int32, device=dev))


def flush_err(st, specs, groups, offset, limit, top) -> tuple:
    """(max error of the card flush against the plain one, rows deleted,
    rows inserted, the card flush's new top set)."""
    a = topn_flush(st, specs, groups, offset, limit, *top)
    b = topn_flush_plain(st, specs, groups, offset, limit, *top)
    err = exact_err([a[0], a[3].view(1), *a[1], *a[2], *a[4], *a[5], a[6],
                     a[7]],
                    [b[0], b[3].view(1), *b[1], *b[2], *b[4], *b[5], b[6],
                     b[7]])
    C = st.capacity
    return err, int(a[7][:C].sum()), int(a[7][C:].sum()), a[:4]


def phase_kernels_topn(dev) -> dict:
    """K19-K22 and K5's MOD opcodes against their plain versions on the
    card, exactly, at q5_topn's and q2's shapes and on edge cases."""
    res = {}
    smi = nvidia_smi_line()
    i64 = torch.int64
    # ---- K19 on a 2^17-slot store at a q5_topn run's end state, with a
    # 2^19-row agg changelog chunk of 65536 U-/U+ pairs
    st, sch, (a, n) = q5t_store(dev)
    cl = q5t_changelog(dev, sch, a, n)
    order = stable_lexsort([cl.columns[0].data, (~cl.vis).to(torch.uint8)],
                           [64, 1])
    got = [t.clone() for t in net_pk_runs(cl, cl.vis, (0,), order=order)]
    want = net_pk_runs_plain(cl, cl.vis, (0,), order)
    err19 = exact_err(got, want)
    cases = {}
    edge = {"q5t": cl,
            "pk_runs": q5t_changelog(dev, sch, a, n, runs=4096, seed=2),
            "misses": q5t_changelog(dev, sch, a, n, pairs=4096, misses=64,
                                    seed=3),
            "overfull": q5t_changelog(dev, sch, a, n, pairs=1024,
                                      inserts=70000, seed=4)}
    for name, ch in edge.items():
        e_card = torch.zeros(3, dtype=torch.int32, device=dev)
        e_plain = torch.zeros(3, dtype=torch.int32, device=dev)
        spare = empty_sorted_side(st.capacity, [i64, i64], dev)
        new_card = sorted_store_apply(st, e_card, ch, (0,), spare)
        new_plain = sorted_store_apply_plain(st, e_plain, ch, (0,))
        cases[name] = dict(err=max(store_exact_err(new_card, new_plain),
                                   exact_err([e_card], [e_plain])),
                           errs=e_card.tolist(), n=int(new_card.n))
    if any(c["err"] for c in cases.values()) or err19:
        raise AssertionError(f"K19 differs from plain: {err19}, {cases}")
    if cases["misses"]["errs"][1] != 64 or cases["overfull"]["errs"][2] <= 0 \
            or cases["q5t"]["errs"] != [0, 0, 0]:
        raise AssertionError(f"K19 edge cases did not bite: {cases}")
    N = cl.capacity
    res["pk_net"] = dict(
        max_abs_err=err19, cases=cases, rows=N,
        **timings(lambda: net_pk_runs(cl, cl.vis, (0,), order=order),
                  lambda: net_pk_runs_plain(cl, cl.vis, (0,), order)),
        # order, vis, ops and the pk read, h, ins_h and two flags written
        bound_ms=bytes_bound_ms(N * (8 + 1 + 1 + 8 + 8 + 8 + 2)),
        bound_by="bytes")
    emit({"phase": "kernel", "name": "pk_net", "nvidia_smi": smi,
          **res["pk_net"]})

    # ---- K20 / K21: q5_topn's flush on the store after that chunk, ties
    # at the limit; the first flush runs against an empty old set
    specs, limit = [(1, True)], 10
    e = torch.zeros(3, dtype=torch.int32, device=dev)
    st2 = sorted_store_apply_plain(st, e, cl, (0,))
    fcases = {}
    err, nd, ni, top = flush_err(st, specs, (), 0, limit, empty_top(st))
    fcases["q5t_empty_old"] = dict(err=err, deletes=nd, inserts=ni)
    err, nd, ni, top2 = flush_err(st2, specs, (), 0, limit, top)
    fcases["q5t"] = dict(err=err, deletes=nd, inserts=ni)
    rs, _ = topn_random_store(dev, 1 << 12, 3000, 5)
    rs2, _ = topn_random_store(dev, 1 << 12, 2500, 6)
    for name, sp, gk, off, lim in (
            ("group_desc_int_float", [(1, True), (2, False)], (0,), 1, 3),
            ("float_desc", [(2, True)], (), 0, 7),
            ("group_float_asc_null", [(2, False), (1, True)], (0,), 2, 5)):
        err, nd, ni, t = flush_err(rs, sp, gk, off, lim, empty_top(rs))
        err2, nd2, ni2, _ = flush_err(rs2, sp, gk, off, lim, t)
        fcases[name] = dict(err=max(err, err2), deletes=nd2, inserts=ni2)
    es = empty_sorted_side(1 << 10, [i64, i64], dev)
    err, nd, ni, _ = flush_err(es, specs, (), 0, limit, empty_top(es))
    fcases["empty_store"] = dict(err=err, deletes=nd, inserts=ni)
    if any(c["err"] for c in fcases.values()):
        raise AssertionError(f"K20/K21 differ from plain: {fcases}")
    if fcases["q5t_empty_old"]["inserts"] != limit \
            or fcases["empty_store"]["inserts"] != 0:
        raise AssertionError(f"K20/K21 edge cases did not bite: {fcases}")
    C = st2.capacity
    okeys, gkey, n_top = topn_keys(st2, specs, ())
    order2 = topn_order(st2, okeys, gkey)
    topk, n_top = topn_rank(st2, order2, gkey, 0, limit, n_top)
    n_sel = int(n_top)

    def k20():
        ok, gk, nt = topn_keys(st2, specs, ())
        return topn_rank(st2, order2, gk, 0, limit, nt)

    def k20_plain():
        ok, gk = topn_keys_plain(st2, specs, ())
        return topn_rank_plain(st2, order2, gk, 0, limit)

    res["top_n_rank"] = dict(
        max_abs_err=max(c["err"] for c in fcases.values()),
        cases=fcases, slots=C, selected=n_sel,
        **timings(k20, k20_plain),
        # keys: the order column read, the order key and the group key
        # written; rank: the order and the group keys read, the selected
        # rows' two columns read, topk written
        bound_ms=bytes_bound_ms(C * (8 + 8 + 8) + C * (8 + 8 + 8)
                                + n_sel * 16),
        bound_by="bytes")
    emit({"phase": "kernel", "name": "top_n_rank", "nvidia_smi": smi,
          **res["top_n_rank"]})
    new_hash, src = stable_sort(topk, HASH_BITS, order2)
    th, tc, tv, tn = top
    K = len(st2.cols)
    res["top_n_diff"] = dict(
        max_abs_err=max(c["err"] for c in fcases.values()), slots=C,
        **timings(lambda: topn_diff(st2, new_hash, src, n_top, th, tc, tv,
                                    tn),
                  lambda: topn_diff_plain(st2, new_hash, src, n_top, th, tc,
                                          tv, tn)),
        # 2C output rows (K columns, K valid bytes, op, vis) written; the
        # old set's C rows and the store's C gathered rows read with src;
        # the visible candidates' hashes read for the searches
        bound_ms=bytes_bound_ms(2 * C * (9 * K + 2) + 2 * C * 9 * K + 8 * C
                                + 8 * (int(tn) + n_sel)),
        bound_by="bytes")
    emit({"phase": "kernel", "name": "top_n_diff", "nvidia_smi": smi,
          **res["top_n_diff"]})

    # ---- K22 at q2's chunk: update pairs with either or both sides
    # failing, rows 0 and N-1
    Nf = Q2_CHUNK
    rng = np.random.default_rng(7)
    ops = rng.choice([0, 1], Nf).astype(np.int8)
    pair = rng.random(Nf // 2) < 0.6
    for j in np.flatnonzero(pair):
        ops[2 * j], ops[2 * j + 1] = 2, 3
    ops[0], ops[Nf - 1] = 3, 2
    cond = torch.from_numpy(rng.random(Nf) < 0.5).to(dev)
    valid = torch.from_numpy(rng.random(Nf) < 0.9).to(dev)
    ops_t = torch.from_numpy(ops).to(dev)
    vis = torch.from_numpy(rng.random(Nf) < 0.95).to(dev)
    err22 = 0
    # and integer predicates (Queue C 2): a row passes where the low bit
    # of its value is set
    irng = np.random.default_rng(71)
    preds = [cond] + [torch.from_numpy(irng.integers(-1000, 1000, Nf).astype(
        dt)).to(dev) for dt in (np.int64, np.int32)]
    for pred in preds:
        for v in (valid, None):
            err22 = max(err22, exact_err(
                filter_fixup(pred, v, ops_t, vis),
                filter_fixup_plain(pred, v, ops_t, vis)))
    fixed = int((filter_fixup(cond, valid, ops_t, vis)[0] != ops_t).sum())
    if err22 or fixed == 0:
        raise AssertionError(f"K22 differs from plain ({err22}) or fixed "
                             f"no pair ({fixed})")
    res["filter_ops"] = dict(
        max_abs_err=err22, rows=Nf, ops_fixed=fixed,
        **timings(lambda: filter_fixup(cond, valid, ops_t, vis),
                  lambda: filter_fixup_plain(cond, valid, ops_t, vis)),
        bound_ms=bytes_bound_ms(Nf * 6), bound_by="bytes")
    emit({"phase": "kernel", "name": "filter_ops", "nvidia_smi": smi,
          **res["filter_ops"]})

    # ---- K5's MOD_I / MOD_F: negative operands, zero divisors,
    # INT64_MIN % -1, floats of both signs
    Nm = Q2_CHUNK
    am = rng.integers(-10**6, 10**6, Nm)
    am[::5] = np.iinfo(np.int64).min
    zm = rng.integers(-3, 4, Nm)
    fm = rng.integers(-4000, 4000, Nm) / 8.0
    cols = [Column(torch.from_numpy(x).to(dev)) for x in (am, zm, fm)]
    exprs = [call("modulus", col(0), col(1)),
             call("modulus", col(2), col(1)),
             call("modulus", col(2), lit(-2.5)),
             call("equal", call("modulus", col(0), lit(123)), lit(0))]
    prog = ExprProgram(exprs)
    outs, plain = prog.eval(cols), prog.eval_plain(cols)
    def lanes(c):      # floats compared by their bits
        d = c.data
        return [d.view(torch.int64) if d.is_floating_point() else d,
                c.valid_mask()]

    errm = max(exact_err(lanes(o), lanes(p)) for o, p in zip(outs, plain))
    if errm:
        raise AssertionError(f"K5 MOD opcodes differ from plain: {errm}")
    one = ExprProgram([exprs[0]])
    safe = torch.where(cols[1].data == 0, 1, cols[1].data)
    emit({"phase": "k5_mod", "nvidia_smi": smi, "max_abs_err": errm,
          "rows": Nm,
          **timings(lambda: one.eval(cols), lambda: one.eval_plain(cols),
                    library_fn=lambda: torch.remainder(cols[0].data, safe)),
          "bound_ms": bytes_bound_ms(Nm * (8 + 8 + 8 + 1)),
          "bound_by": "bytes"})
    return res


def q5t_summary(runs: list) -> dict:
    med = statistics.median
    return dict(
        repeats=len(runs), bids=runs[0]["bids"],
        wall_s=med(r["wall_s"] for r in runs),
        bids_per_s=med(r["bids"] / r["wall_s"] for r in runs),
        bids_per_s_min=min(r["bids"] / r["wall_s"] for r in runs),
        bids_per_s_max=max(r["bids"] / r["wall_s"] for r in runs),
        barrier_p50_s=med(r["coord"].barrier_latency_percentile(0.5)
                          for r in runs),
        barrier_p99_s=med(r["coord"].barrier_latency_percentile(0.99)
                          for r in runs),
        mem_peak_bytes=runs[0]["mem_peak_bytes"],
        launches=runs[0]["launches"])


def phase_q5_topn_full(dev, repeats: int = 5, per_chunks: int = 8,
                       rounds: int = 16) -> dict:
    """Q5T_DDL (bench's q5_topn on one device) into the device blackhole
    sink, `per_chunks` 32768-bid chunks a barrier, `rounds` barriers,
    `repeats` runs from fresh state: every q5_topn kernel launched, the
    top-N's errs and the agg's overflow 0."""
    per = per_chunks * Q5T_CHUNK
    runs = []
    for _ in range(repeats):
        r = session_run(dev, Q5T_DDL, rounds, per, name="q5t")
        errs, ovf = r["top"].errs(), r["agg"].overflow()
        if errs != [0, 0] or ovf:
            raise AssertionError(f"q5_topn: top-N errs {errs}, agg "
                                 f"overflow {ovf}")
        missing = [k for k in Q5T_KERNELS if r["launches"][k] == 0]
        if missing and torch.device(dev).type == "cuda":
            raise AssertionError(f"kernels never launched on q5_topn: "
                                 f"{missing}")
        r["live_groups"] = int(r["top"].store.n)
        runs.append(r)
    return dict(chunk=Q5T_CHUNK, chunks_per_barrier=per_chunks,
                barriers=rounds, live_groups=runs[0]["live_groups"],
                runs=[{"wall_s": r["wall_s"],
                       "bids_per_s": r["bids"] / r["wall_s"]}
                      for r in runs], **q5t_summary(runs))


def phase_q5_topn_profile(dev, full: dict, rounds: int = 6) -> dict:
    """Where q5_topn's time goes: a fresh run of a few barriers under
    torch.profiler; the idle share against q5_topn_full's unprofiled
    median wall per barrier."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    per = full["chunks_per_barrier"] * Q5T_CHUNK
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        r = session_run(dev, Q5T_DDL, rounds, per, name="q5t")
        torch.cuda.synchronize()
    kev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict = {}
    for e in kev:
        name = e.name[:60]
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + e.time_range.elapsed_us(), c + 1)
    busy_s = sum(t for t, _ in by_name.values()) / 1e6
    busy_per_barrier = busy_s / rounds
    wall_per_barrier = full["wall_s"] / full["barriers"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:16]
    return dict(
        rounds=rounds, wall_s=r["wall_s"], device_busy_s=busy_s,
        device_busy_per_barrier_s=busy_per_barrier,
        unprofiled_wall_per_barrier_s=wall_per_barrier,
        device_idle_share=(1 - busy_per_barrier / wall_per_barrier)
        if kev else None,
        device_events=len(kev),
        top_kernels=[{"name": nm, "ms": t / 1e3, "count": c}
                     for nm, (t, c) in top])


def phase_q5_topn_check(dev, per_chunks: int = 2, rounds: int = 12) -> dict:
    """The correctness gate: Q5T_DDL as an MV; after every barrier the MV
    must equal the host recount (count per auction % 65536 over the bids
    the source emitted, ranked by (n desc, key hash of a asc), the first
    10), exactly."""
    per = per_chunks * Q5T_CHUNK
    (auction,) = _bid_prefix(per * rounds, NexmarkConfig(
        inter_event_us=Q5T_INTER_US), dev, [0])
    checked = []

    def on_barrier(k, s, rows):
        bids = rows["bid"]
        got = mv_rows_now(s, "q5t")
        want = sorted(q5_topn_recount(bids, auction=auction))
        if got != want:
            raise AssertionError(f"q5_topn_check: barrier {k}: MV {got} "
                                 f"!= recount {want}")
        checked.append(bids)

    r = session_run(dev, as_mv(Q5T_DDL), rounds, per, name="q5t",
                    on_barrier=on_barrier)
    want = sorted(q5_topn_recount(r["bids"], auction=auction))
    if r["mv"] != want or r["top"].errs() != [0, 0]:
        raise AssertionError(f"q5_topn_check: final MV {r['mv']} != "
                             f"{want}, errs {r['top'].errs()}")
    # ties at the limit: how many groups share the 10th count
    tenth = want[-1][1] if len(want) == 10 else None
    counts = np.bincount(np.remainder(auction[:r["bids"]], 65536))
    return dict(barriers_checked=len(checked), bids=r["bids"],
                mv_rows=len(r["mv"]), live_groups=int(r["top"].store.n),
                groups_tied_at_10th=(int((np.sort(counts)[::-1] ==
                                          sorted(n for _, n in want)[0])
                                         .sum()) if tenth else None),
                top=r["mv"])


def q2_recount(n_bids: int, dev) -> Counter:
    auction, price = _bid_prefix(n_bids, NexmarkConfig(inter_event_us=250),
                                 dev, [0, 2])
    keep = np.remainder(auction, 123) == 0
    return Counter(zip(auction[keep].tolist(), price[keep].tolist()))


def phase_q2_full(dev, repeats: int = 3, per_chunks: int = 8,
                  rounds: int = 8) -> dict:
    """Nexmark q2 (Q2_DDL) into the device blackhole sink, `repeats`
    runs: bids/s; then as an MV, whose rows must equal a numpy recount;
    then a WHERE over an aggregating subquery (Q2_AGG_MV) at one 8192-bid
    chunk a barrier, where count updates cross the predicate as U-/U+
    pairs: its MV must equal the recount's groups with an even count."""
    per = per_chunks * Q2_CHUNK
    runs = []
    for _ in range(repeats):
        r = session_run(dev, Q2_DDL, rounds, per, name="q2")
        missing = [k for k in Q2_KERNELS if r["launches"][k] == 0]
        if missing and torch.device(dev).type == "cuda":
            raise AssertionError(f"kernels never launched on q2: {missing}")
        runs.append(r)
    mv = session_run(dev, as_mv(Q2_DDL), 4, 2 * Q2_CHUNK, name="q2")
    want = q2_recount(mv["bids"], dev)
    got = Counter((a, p) for a, p, _rid in mv["mv"])
    if got != want or not want:
        raise AssertionError(f"q2 MV ({sum(got.values())} rows) differs "
                             f"from the recount ({sum(want.values())})")
    agg_ddl = [Q2_DDL[0], Q2_DDL[1].replace("chunk_size=131072",
                                            "chunk_size=8192"), Q2_AGG_MV]
    ag = session_run(dev, agg_ddl, 12, 8192, name="q2")
    (auction,) = _bid_prefix(ag["bids"], NexmarkConfig(inter_event_us=250),
                             dev, [0])
    ids, counts = np.unique(auction, return_counts=True)
    want_agg = sorted((int(i), int(c)) for i, c in zip(ids, counts)
                      if c % 2 == 0)
    if ag["mv"] != want_agg or ag["agg"].overflow():
        raise AssertionError(f"q2 WHERE over an agg: MV "
                             f"({len(ag['mv'])} rows) differs from the "
                             f"recount ({len(want_agg)})")
    med = statistics.median
    return dict(
        chunk=Q2_CHUNK, chunks_per_barrier=per_chunks, barriers=rounds,
        repeats=repeats, bids=runs[0]["bids"],
        wall_s=med(r["wall_s"] for r in runs),
        bids_per_s=med(r["bids"] / r["wall_s"] for r in runs),
        bids_per_s_min=min(r["bids"] / r["wall_s"] for r in runs),
        bids_per_s_max=max(r["bids"] / r["wall_s"] for r in runs),
        barrier_p50_s=med(r["coord"].barrier_latency_percentile(0.5)
                          for r in runs),
        mv_rows=sum(got.values()), agg_mv_rows=len(ag["mv"]),
        agg_groups=len(ids), launches=runs[0]["launches"])


def phase_topn_recover(dev, r1: int = 8, r2: int = 8) -> dict:
    """Q5T_DDL as a durable MV on a Hummock store over a local-fs object
    store, one 32768-bid chunk a barrier: r1 barriers, crash(),
    HummockStateStore.open, a new Session, recover() (recovery_ms from
    the opening to the first collected barrier), barriers to (r1 + r2)
    chunks; the MV must equal an uninterrupted durable run's and the
    recount. The uninterrupted run's wall over the same statements'
    volatile wall (same chunking and pacing) is the flush tax; the
    top-N's own persist (every input row, as the reference) is timed."""
    ddl = durable(as_mv(Q5T_DDL))
    n = (r1 + r2) * Q5T_CHUNK
    with tempfile.TemporaryDirectory(prefix="q5t_") as d1, \
            tempfile.TemporaryDirectory(prefix="q5t_") as d2:
        whole = session_run(dev, ddl, r1 + r2, Q5T_CHUNK, name="q5t",
                            store=HummockStateStore(LocalFsObjectStore(d1)))
        a = session_run(dev, ddl, r1, Q5T_CHUNK, name="q5t", crash=True,
                        store=HummockStateStore(LocalFsObjectStore(d2)))
        b = session_run(dev, ddl, 0, Q5T_CHUNK, name="q5t",
                        recover_to=r1 + r2,
                        store=lambda: HummockStateStore.open(
                            LocalFsObjectStore(d2)))
    vol = session_run(dev, as_mv(Q5T_DDL), r1 + r2, Q5T_CHUNK,
                      name="q5t")
    want = sorted(q5_topn_recount(n, device=dev))
    if whole["bids"] != n or b["bids"] != n:
        raise AssertionError(f"topn_recover: offsets {whole['bids']}, "
                             f"{b['bids']} (want {n})")
    if b["mv"] != whole["mv"] or b["mv"] != want or vol["mv"] != want:
        raise AssertionError(f"topn_recover: recovered MV {b['mv']} != "
                             f"uninterrupted {whole['mv']} / recount {want}")
    return dict(
        chunk=Q5T_CHUNK, barriers_before_crash=r1, bids=n,
        recovered_offset=b["base"], barriers_after_recovery=b["barriers"],
        recovery_ms=b["recovery_s"] * 1e3, mv_rows=len(b["mv"]),
        durable_bids_per_s=whole["bids"] / whole["wall_s"],
        durable_barrier_p50_s=whole["coord"].barrier_latency_percentile(
            0.5),
        volatile_bids_per_s=vol["bids"] / vol["wall_s"],
        flush_tax=whole["wall_s"] / vol["wall_s"],
        top_n_rows_persisted=whole["top"].persist_rows,
        top_n_persist_s=whole["top"].persist_s,
        launches=b["launches"])


# ------------------------------------------- window functions, global aggs

# Nexmark q6 and q4 as the JAX package's goldens write them
# (tests/test_over_window_sql.py:48, tests/test_nexmark_queries.py:86)
Q6_INNER = ("(SELECT max(B.price) AS final, A.seller, A.id "
            "      FROM auction A JOIN bid B ON A.id = B.auction "
            "        AND B.date_time BETWEEN A.date_time AND A.expires "
            "      GROUP BY A.id, A.seller) Q")
Q6_SELECT = ("SELECT Q.seller, Q.id, "
             "avg(Q.final) OVER (PARTITION BY Q.seller ORDER BY Q.id "
             "ROWS BETWEEN 9 PRECEDING AND CURRENT ROW) AS avgf "
             f"FROM {Q6_INNER}")
Q4_SELECT = ("SELECT Q.category, AVG(Q.final) AS avg "
             "FROM (SELECT MAX(B.price) AS final, A.category "
             "      FROM auction A, bid B "
             "      WHERE A.id = B.auction "
             "        AND B.date_time BETWEEN A.date_time AND A.expires "
             "      GROUP BY A.id, A.category) Q "
             "GROUP BY Q.category")
# tests/test_eowc_over_window.py:15
EOWC_BODY = (
    "SELECT auction, date_time, price, "
    "row_number() OVER (PARTITION BY auction ORDER BY date_time) AS rn, "
    "sum(price) OVER (PARTITION BY auction ORDER BY date_time) AS sp "
    "FROM bid")
GAGG_SELECT = "SELECT count(*), sum(price), max(price) FROM bid"
GAGG_Q6_SELECT = f"SELECT avg(Q.final), count(*) FROM {Q6_INNER}"
Q6_CHUNK = 131072
Q6_INTER_US = 250
# auctions a barrier spanning the event time of one bid chunk (3 auction
# and 46 bid events in every 50), rounded up: auctions run ahead
Q6_AUCTIONS = -(-Q6_CHUNK * 3 // 46)
Q6_KERNELS = ("nexmark_bid", "nexmark_auction", "row_id",
              "sorted_join_probe", "sorted_join_merge", "radix_sort",
              "pk_net", "expr_eval", "hash_table", "hash_agg", "compact",
              "top_n_rank", "window_scan", "window_diff")
Q4_KERNELS = ("nexmark_bid", "nexmark_auction", "row_id",
              "sorted_join_probe", "sorted_join_merge", "radix_sort",
              "expr_eval", "hash_table", "hash_agg", "compact")
EOWC_KERNELS = ("nexmark_bid", "row_id", "radix_sort", "pk_net",
                "sorted_join_merge", "top_n_rank", "window_scan")
GAGG_KERNELS = ("nexmark_bid", "simple_agg")


def window_ddl(select: str, name: str, *, bid_chunk: int = Q6_CHUNK,
               chunks: int = 1, inter_us: int = Q6_INTER_US,
               ow_cap: int = 1 << 19, join_cap: int = 1 << 20,
               agg_cap: int = 1 << 20, watchdog: int = 0,
               durable_: int = 0, sink: bool = True,
               auction: bool = True) -> list:
    """A two-source (auction, bid) statement list at q6's geometry:
    `chunks` bid chunks a barrier and the auctions of the same event
    time (one auction chunk), watermarks on both, the capacities
    pre-sized; `select` into a device blackhole sink or an MV."""
    a_chunk = -(-bid_chunk * chunks * 3 // 46)
    ddl = [f"SET streaming_durability = {durable_}",
           f"SET streaming_watchdog = {watchdog}",
           f"SET streaming_join_capacity = {join_cap}",
           f"SET streaming_agg_capacity = {agg_cap}",
           f"SET streaming_over_window_capacity = {ow_cap}"]
    if auction:
        ddl.append("CREATE SOURCE auction WITH (connector='nexmark', "
                   f"table='auction', chunk_size={a_chunk}, "
                   f"inter_event_us={inter_us}, emit_watermarks=1)")
    ddl.append("CREATE SOURCE bid WITH (connector='nexmark', table='bid', "
               f"chunk_size={bid_chunk}, inter_event_us={inter_us}, "
               "emit_watermarks=1)")
    if sink:
        ddl.append(f"CREATE SINK {name} AS {select} "
                   "WITH (connector='blackhole_device')")
    else:
        ddl.append(f"CREATE MATERIALIZED VIEW {name} AS {select}")
    return ddl


def window_pace(bid_chunk: int, chunks: int) -> dict:
    return {"bid": bid_chunk * chunks,
            "auction": -(-bid_chunk * chunks * 3 // 46)}


def _auction_prefix(n: int, cfg: NexmarkConfig, device, idx,
                    batch: int = 1 << 20) -> list:
    """Columns `idx` of auctions [0, n) from the plain generator."""
    vocabs = {k: torch.tensor(v, dtype=torch.int32, device=device)
              for k, v in vocab_ids().items()}
    parts = []
    for off in range(0, n, batch):
        cols = gen_auction_columns_plain(off, min(batch, n - off), cfg,
                                         vocabs, device)
        parts.append([cols[i].cpu().numpy() for i in idx])
    return [np.concatenate(x) for x in zip(*parts)]


class WindowRecount:
    """numpy recount of q6 / q4 / the global avg from the port's plain
    generators, advanced barrier by barrier: the best (max) qualifying
    price per auction over the bids so far (the band B.date_time in
    [A.date_time, A.expires]; auctions run ahead in event time, so every
    bid's auction is in the prefix)."""

    def __init__(self, n_auctions: int, n_bids: int, device,
                 inter_us: int = Q6_INTER_US):
        cfg = NexmarkConfig(inter_event_us=inter_us)
        (self.aid, self.adt, self.aexp, self.seller,
         self.category) = _auction_prefix(n_auctions, cfg, device,
                                          [0, 5, 6, 7, 8])
        self.bauc, self.price, self.bdt = _bid_prefix(n_bids, cfg, device,
                                                      [0, 2, 5])
        self.best = np.full(n_auctions, -1, dtype=np.int64)
        self.bids = 0
        self.auctions = 0

    def advance(self, n_bids: int, n_auctions: int) -> None:
        ai = self.bauc[self.bids:n_bids] - 1000
        ok = (ai >= 0) & (ai < n_auctions)
        a = np.clip(ai, 0, len(self.aid) - 1)
        dt = self.bdt[self.bids:n_bids]
        ok &= (self.adt[a] <= dt) & (dt <= self.aexp[a])
        np.maximum.at(self.best, ai[ok], self.price[self.bids:n_bids][ok])
        self.bids, self.auctions = n_bids, n_auctions

    def _finals(self):
        ids = np.flatnonzero(self.best >= 0)
        return ids, self.best[ids]

    def q6(self) -> Counter:
        """(seller, id, avg of the last 10 finals by id) rows."""
        ids, fin = self._finals()
        sel = self.seller[ids]
        o = np.lexsort((self.aid[ids], sel))
        s, f, aid = sel[o], fin[o], self.aid[ids][o]
        n = len(s)
        pos = np.arange(n)
        start = np.zeros(n, dtype=np.int64)
        if n:
            new = np.r_[True, s[1:] != s[:-1]]
            start = np.maximum.accumulate(np.where(new, pos, 0))
        cs = np.cumsum(f)
        lo = pos - 10
        base = np.where(lo >= start, cs[np.maximum(lo, 0)],
                        np.where(start > 0, cs[np.maximum(start - 1, 0)],
                                 0))
        cnt = np.minimum(pos - start + 1, 10)
        avg = (cs - base) / cnt
        return Counter(zip(s.tolist(), aid.tolist(), avg.tolist()))

    def q4(self) -> list:
        """(category, avg of finals) rows, sorted."""
        ids, fin = self._finals()
        cat = self.category[ids]
        out = []
        for c in np.unique(cat):
            m = cat == c
            out.append((int(c), float(fin[m].sum()) / int(m.sum())))
        return sorted(out)

    def avg_count(self) -> list:
        ids, fin = self._finals()
        if not len(ids):
            return []
        return [(float(fin.sum()) / len(ids), len(ids))]


def window_store(dev, C: int, n_rows: int, seed: int, parts: int = 7,
                 null_part: bool = True):
    """An over-window store of (p, o, t, v, f, pk) rows for the edge
    cases: `parts` partitions (partition 0 with v all NULL), a float
    order column with NaN, -0.0, +0.0, a subnormal, inf and repeats, an
    int order column of many duplicates, NULL lanes."""
    rng = np.random.default_rng(seed)
    sch = make_schema(("p", DataType.INT64), ("o", DataType.FLOAT64),
                      ("t", DataType.INT64), ("v", DataType.INT64),
                      ("f", DataType.FLOAT64), ("pk", DataType.INT64))
    floats = np.array([np.nan, -0.0, 0.0, 1.5, -2.25, 1e-310, np.inf,
                       7.0, -np.inf, 3.0])
    p = rng.integers(0, parts, C)
    o = floats[rng.integers(0, len(floats), C)]
    t = rng.integers(0, 9, C)
    v = rng.integers(-1000, 1000, C)
    f = rng.integers(-4000, 4000, C) / 8.0 + rng.random(C) * 1e-3
    pk = rng.permutation(C).astype(np.int64)
    vv = rng.random(C) < 0.9
    if null_part:
        vv &= p != 0
    ch = chunk_from_numpy(sch, [p, o, t, v, f, pk], np.zeros(C, np.int8),
                          np.arange(C) < n_rows,
                          [None, rng.random(C) < 0.95, None, vv,
                           rng.random(C) < 0.9, None], device=dev)
    st = empty_sorted_side(C, [torch.int64, torch.float64, torch.int64,
                               torch.int64, torch.float64, torch.int64],
                           dev)
    errs = torch.zeros(3, dtype=torch.int32, device=dev)
    return sorted_store_apply_plain(st, errs, ch, (5,)), sch


def q6_store(dev, C: int, n_rows: int, seed: int = 0, sellers: int = 60000):
    """A store as q6's over-window holds it: (final, seller, id) rows,
    ids unique, sellers skewed, integer prices; pk (id, seller)."""
    rng = np.random.default_rng(seed)
    sch = make_schema(("final", DataType.INT64), ("seller", DataType.INT64),
                      ("id", DataType.INT64))
    fin = rng.integers(100, 1000, C) * 10 ** rng.integers(0, 5, C)
    sel = 1000 + np.minimum(rng.geometric(2.0 / sellers, C), sellers)
    aid = 1000 + rng.permutation(C).astype(np.int64)
    ch = chunk_from_numpy(sch, [fin, sel, aid], np.zeros(C, np.int8),
                          np.arange(C) < n_rows, device=dev)
    st = empty_sorted_side(C, [torch.int64] * 3, dev)
    errs = torch.zeros(3, dtype=torch.int32, device=dev)
    return sorted_store_apply_plain(st, errs, ch, (2, 1)), sch


def _lane_err(a: torch.Tensor, b: torch.Tensor, va, vb) -> float:
    """Largest difference of two window columns where valid (floats by
    value, NaN equal to NaN, an inf to itself; integers exactly), inf
    where the valids differ."""
    if not torch.equal(va, vb):
        return math.inf
    if a.is_floating_point():
        same = (torch.isnan(a) & torch.isnan(b)) | (a == b)
        d = torch.where(va & ~same, (a - b).abs(), 0.0)
        d = torch.where(torch.isnan(d), math.inf, d)
        return float(d.max()) if d.numel() else 0.0
    return float(torch.where(va, (a.to(torch.int64) - b.to(torch.int64))
                             .abs(), 0).max())


def window_scan_err(st, order, gkey, specs, windows, ripe=None) -> dict:
    """K23 against its plain version on the same order: the largest
    error of the gathered columns (exact), of integer-valued windows
    (exact) and of float-argument sums and avgs (relative to the
    largest partial sum's magnitude); and whether two launches agree
    bit for bit."""
    a = window_scan(st, order, gkey, specs, windows, ripe)
    b = window_scan_plain(st, order, gkey, specs, windows, ripe)
    a2 = window_scan(st, order, gkey, specs, windows, ripe)
    nin = len(st.cols)
    exact = 0.0
    for x, y, vx, vy in zip(a[0][:nin], b[0][:nin], a[1][:nin], b[1][:nin]):
        xx = x.view(torch.int64) if x.dtype == torch.float64 else x
        yy = y.view(torch.int64) if y.dtype == torch.float64 else y
        exact = max(exact, float(exact_err([xx, vx], [yy, vy])))
    rel = 0.0
    for w, x, y, vx, vy in zip(windows, a[0][nin:], b[0][nin:], a[1][nin:],
                               b[1][nin:]):
        if w.kind in ("lag", "lead", "first_value") \
                and x.dtype == torch.float64:
            exact = max(exact, float(exact_err(
                [torch.where(vx, x.view(torch.int64), 0), vx],
                [torch.where(vy, y.view(torch.int64), 0), vy])))
        elif x.is_floating_point() and st.cols[w.arg].is_floating_point():
            scale = float(torch.where(vy, y.abs(), 0.0).nan_to_num(
                posinf=0.0).max()) + 1.0
            rel = max(rel, _lane_err(x, y, vx, vy) / scale)
        else:
            exact = max(exact, _lane_err(x, y, vx, vy))
    if ripe is not None:
        exact = max(exact, float(exact_err([a[2]], [b[2]])))
    same = all(torch.equal(x.view(torch.int64) if x.dtype == torch.float64
                           else x,
                           y.view(torch.int64) if y.dtype == torch.float64
                           else y)
               for x, y in zip(a[0] + a[1], a2[0] + a2[1]))
    return dict(exact_err=exact, float_rel_err=rel, deterministic=same)


def flush_pair_err(st, parts, specs, windows, em) -> tuple:
    """(max error of the card flush against the plain flush, exactly,
    rows deleted, rows inserted, the card flush's new emitted set)."""
    a = over_window_flush(st, parts, specs, windows, *em)
    b = over_window_flush(st, parts, specs, windows, *em, plain=True)

    def flat(r):
        return ([r[0], r[3].view(1)]
                + [c.view(torch.int64) if c.dtype == torch.float64 else c
                   for c in r[4]] + list(r[5]) + [r[6], r[7]])
    C = st.capacity
    return (exact_err(flat(a), flat(b)), int(a[7][:C].sum()),
            int(a[7][C:].sum()), a[:4])


def empty_emitted(st, windows):
    C = st.capacity
    dev = st.khash.device
    col_dtypes = [c.dtype for c in st.cols]
    dts = col_dtypes + [_ret_dtype(w, col_dtypes) for w in windows]
    return (torch.full((C,), HSENTINEL, dtype=torch.int64, device=dev),
            tuple(torch.zeros(C, dtype=d, device=dev) for d in dts),
            tuple(torch.zeros(C, dtype=torch.bool, device=dev) for _ in dts),
            torch.zeros((), dtype=torch.int32, device=dev))


W_EDGE_A = (WindowSpec("row_number"), WindowSpec("rank"),
            WindowSpec("dense_rank"), WindowSpec("sum", 3),
            WindowSpec("count", 3), WindowSpec("avg", 3),
            WindowSpec("lag", 3, offset=2), WindowSpec("lead", 4))
W_EDGE_B = (WindowSpec("sum", 4, preceding=3), WindowSpec("avg", 4),
            WindowSpec("count", 4, preceding=4),
            WindowSpec("sum", 3, preceding=2), WindowSpec("first_value", 1),
            WindowSpec("lag", 4), WindowSpec("avg", 3, preceding=0),
            WindowSpec("lead", 3, offset=3))
# integer arguments only: the flush compares whole rows exactly
W_EDGE_C = (WindowSpec("sum", 3, preceding=2),
            WindowSpec("count", 4, preceding=4),
            WindowSpec("avg", 3, preceding=0), WindowSpec("first_value", 1),
            WindowSpec("lag", 4), WindowSpec("lead", 3, offset=3),
            WindowSpec("dense_rank"))
# sums over the float order column: NaN and +-inf arguments
W_EDGE_D = (WindowSpec("sum", 1), WindowSpec("avg", 1, preceding=2),
            WindowSpec("sum", 1, preceding=0), WindowSpec("count", 1),
            WindowSpec("avg", 1))
Q6_WINDOWS = (WindowSpec("avg", 0, preceding=9),)


def phase_kernels_window(dev, C: int = 1 << 19,
                         n_rows: int = 270000) -> dict:
    """K23-K25 against their plain versions on the card: K23 and K24 on
    a q6-shaped store of `n_rows` live rows in C slots (avg of the last
    10 finals per seller) and on edge cases; K25 at a 131072-row chunk
    of every call kind q1's and q6's global aggregates use."""
    res = {}
    smi = nvidia_smi_line()
    st, _ = q6_store(dev, C, n_rows)
    parts, specs = (1,), ((2, False),)
    okeys, gkey = window_keys(st, specs, parts)
    order = window_order(st, okeys, gkey)
    q6e = window_scan_err(st, order, gkey, specs, Q6_WINDOWS)
    cases = {"q6": q6e}
    small, _ = window_store(dev, 1 << 13, 6000, 3)
    edge = {
        "float_keys_asc": ((0,), ((1, False),)),
        "float_keys_desc_then_int": ((0,), ((1, True), (2, False))),
        "dup_int_keys": ((0,), ((2, False),)),
        "one_partition": ((), ((2, True), (1, False))),
        "small_partitions": ((3,), ((2, False),)),
    }
    for name, (pb, sp) in edge.items():
        ok_, gk_ = window_keys(small, sp, pb)
        od_ = window_order(small, ok_, gk_)
        for tag, ws in (("a", W_EDGE_A), ("b", W_EDGE_B), ("d", W_EDGE_D)):
            cases[f"{name}_{tag}"] = window_scan_err(
                small, od_, gk_, sp, ws, ripe=(2, 2, 6))
    bad = {k: c for k, c in cases.items()
           if c["exact_err"] or c["float_rel_err"] > 1e-9
           or not c["deterministic"]}
    if bad:
        raise AssertionError(f"K23 differs from plain: {bad}")
    # the all-NULL partition's sums really are NULL, lag/lead edges hit
    ok_, gk_ = window_keys(small, ((2, False),), (0,))
    full, valids, _ = window_scan(small, window_order(small, ok_, gk_), gk_,
                                  ((2, False),), W_EDGE_A)
    nin = len(small.cols)
    live = torch.arange(small.capacity, device=dev) < small.n
    p0 = full[0] == 0
    if bool((valids[nin + 3] & p0).any()) or not bool(
            (live & ~valids[nin + 6]).any()):
        raise AssertionError("K23 edge cases did not bite")
    # a NaN or inf argument stays in its partition: finite sums follow
    # the first non-finite one in sorted order
    ok_, gk_ = window_keys(small, ((2, False),), (3,))
    full, valids, _ = window_scan(small, window_order(small, ok_, gk_), gk_,
                                  ((2, False),), W_EDGE_D)
    s0, v0 = full[nin], valids[nin]
    bad = torch.nonzero(v0 & ~torch.isfinite(s0)).flatten()
    if not len(bad) or not bool((v0 & torch.isfinite(s0))[bad[0]:].any()):
        raise AssertionError("K23's non-finite sums did not bite")

    L = 1 + 2 * sum(w.kind in ("sum", "avg") for w in Q6_WINDOWS)
    K, n_live = len(st.cols), int(st.n)
    # per live row (dead slots sort last, nothing reads their outputs):
    # order and partition key read, K columns (8 B + valid) read and
    # written sorted, each window column (8 B + valid) written
    bytes23 = n_live * (8 + 8 + 2 * K * 9 + 9 * len(Q6_WINDOWS))
    lane = torch.zeros(C, dtype=torch.int64, device=dev)
    res["window_scan"] = dict(
        max_abs_err=q6e["exact_err"], float_rel_err=max(
            c["float_rel_err"] for c in cases.values()),
        cases=cases, slots=C, live=n_live, scan_lanes=L,
        **timings(lambda: window_scan(st, order, gkey, specs, Q6_WINDOWS),
                  lambda: window_scan_plain(st, order, gkey, specs,
                                            Q6_WINDOWS),
                  library_fn=lambda: torch.cumsum(lane, 0)),
        bound_ms=bytes_bound_ms(bytes23), bound_by="bytes")
    emit({"phase": "kernel", "name": "window_scan", "nvidia_smi": smi,
          **{k: v for k, v in res["window_scan"].items() if k != "cases"},
          "cases": cases})

    # ---- K24: q6's flush against an empty and then a changed emitted
    # set; the edge stores likewise
    fcases = {}
    em0 = empty_emitted(st, Q6_WINDOWS)
    err, nd, ni, em1 = flush_pair_err(st, parts, specs, Q6_WINDOWS, em0)
    fcases["q6_first"] = dict(err=err, deletes=nd, inserts=ni)
    st2 = mutate_finals(st, 0.02, seed=5)
    err, nd2, ni2, em2 = flush_pair_err(st2, parts, specs, Q6_WINDOWS, em1)
    fcases["q6_changed"] = dict(err=err, deletes=nd2, inserts=ni2)
    err, nd3, ni3, _ = flush_pair_err(st2, parts, specs, Q6_WINDOWS, em2)
    fcases["q6_unchanged"] = dict(err=err, deletes=nd3, inserts=ni3)
    small2, _ = window_store(dev, 1 << 13, 5000, 4)
    for name, (pb, sp) in edge.items():
        for tag, ws in (("a", W_EDGE_A), ("c", W_EDGE_C)):
            e0 = empty_emitted(small, ws)
            err, _, _, e1 = flush_pair_err(small, pb, sp, ws, e0)
            err2, nd_, ni_, _ = flush_pair_err(small2, pb, sp, ws, e1)
            fcases[f"{name}_{tag}"] = dict(err=max(err, err2), deletes=nd_,
                                           inserts=ni_)
    if any(c["err"] for c in fcases.values()):
        raise AssertionError(f"K24 differs from plain: {fcases}")
    if ni != int(st.n) or nd != 0 or nd3 or ni3 or not nd2 or not ni2:
        raise AssertionError(f"K24 cases did not bite: {fcases}")
    okeys2, gkey2 = window_keys(st2, specs, parts)
    order2 = window_order(st2, okeys2, gkey2)
    full, fvalids, _ = window_scan(st2, order2, gkey2, specs, Q6_WINDOWS)
    n2 = st2.n
    rhash = window_hash(full, fvalids, order2, n2)
    new_hash, rorder = stable_sort(rhash, HASH_BITS)
    eh, ec, ev, en = em1

    def k24():
        window_hash(full, fvalids, order2, n2)
        return window_diff(full, fvalids, new_hash, rorder, n2, eh, ec, ev,
                           en)

    def k24_plain():
        window_hash_plain(full, fvalids, order2, n2)
        return window_diff_plain(full, fvalids, new_hash, rorder, n2, eh,
                                 ec, ev, en)

    Kf, new_n, old_n = len(full), int(n2), int(en)
    # over live rows: hash, the new rows (8 B + valid a column) and the
    # order read, the hash written; diff, the new hashes, rorder and
    # rows and the old set's hashes and rows read, the next set and the
    # deleted rows written, an op and a vis byte for each of 2C rows
    bytes24 = (new_n * (Kf * 9 + 8 + 8) + new_n * (8 + 8 + Kf * 9)
               + old_n * (8 + Kf * 9) + (new_n + nd2) * Kf * 9
               + 2 * C * 2)
    res["window_diff"] = dict(
        max_abs_err=max(c["err"] for c in fcases.values()), cases=fcases,
        slots=C, live_new=new_n, live_old=old_n, deletes=nd2,
        **timings(k24, k24_plain),
        bound_ms=bytes_bound_ms(bytes24), bound_by="bytes")
    emit({"phase": "kernel", "name": "window_diff", "nvidia_smi": smi,
          **res["window_diff"]})

    # ---- K25 at a 131072-row chunk: retracting ops, NULLs, every kind
    N = Q6_CHUNK
    rng = np.random.default_rng(9)
    sch = make_schema(("v", DataType.INT64), ("w", DataType.INT32),
                      ("f", DataType.FLOAT64), ("g", DataType.FLOAT64))
    v = rng.integers(100, 10 ** 7, N)
    w = rng.integers(-5, 5, N).astype(np.int32)
    f = rng.integers(-10 ** 6, 10 ** 6, N).astype(np.float64)
    g = rng.random(N) * 1e3 - 500.0
    ops = rng.choice([0, 1, 2, 3], N).astype(np.int8)
    ch = chunk_from_numpy(sch, [v, w, f, g], ops, rng.random(N) < 0.97,
                          [None, rng.random(N) < 0.9, rng.random(N) < 0.9,
                           None], device=dev)
    ao = np.zeros(N, np.int8)                       # append-only inserts
    ch_ao = chunk_from_numpy(sch, [v, w, f, g], ao, rng.random(N) < 0.97,
                             [None, rng.random(N) < 0.9,
                              rng.random(N) < 0.9, None], device=dev)
    calls = [AggCall(AggKind.COUNT, None, DataType.INT64),
             AggCall(AggKind.COUNT, 1, DataType.INT64),
             AggCall(AggKind.SUM, 0, DataType.INT64),
             AggCall(AggKind.SUM, 0, DataType.FLOAT64),
             AggCall(AggKind.SUM, 1, DataType.INT64),
             AggCall(AggKind.SUM, 2, DataType.FLOAT64),
             AggCall(AggKind.SUM, 3, DataType.FLOAT64)]
    ao_calls = [AggCall(AggKind.MAX, 0, DataType.INT64, True),
                AggCall(AggKind.MIN, 1, DataType.INT32, True),
                AggCall(AggKind.MAX, 2, DataType.FLOAT64, True),
                AggCall(AggKind.MIN, 3, DataType.FLOAT64, True),
                AggCall(AggKind.COUNT, 1, DataType.INT64, True)]
    errs25 = {}
    for tag, cl, chunk_ in (("retracting", calls, ch),
                            ("append_only", ao_calls, ch_ao)):
        specs_ = [c.spec() for c in cl]
        init = [torch.full((), s.init, dtype=s.state_dtype, device=dev)
                for s in specs_]
        rc = torch.zeros((), dtype=torch.int64, device=dev)
        pa, prc = simple_agg_apply_plain(specs_, init, rc, chunk_)
        ka, krc = simple_agg_apply(specs_, [x.clone() for x in init],
                                   rc.clone(), chunk_)
        ka2, _ = simple_agg_apply(specs_, [x.clone() for x in init],
                                  rc.clone(), chunk_)
        e_int, e_rel = 0, 0.0
        for x, y, x2 in zip(ka, pa, ka2):
            if not torch.equal(x, x2):
                raise AssertionError("K25 differs between two launches")
            if x.is_floating_point():
                e_rel = max(e_rel, float((x - y).abs())
                            / (1.0 + float(y.abs())))
            else:
                e_int = max(e_int, int((x - y).abs()))
        e_int = max(e_int, int((krc - prc).abs()))
        errs25[tag] = dict(int_err=e_int, float_rel_err=e_rel,
                           row_count=int(krc))
    if any(e["int_err"] or e["float_rel_err"] > 1e-9
           for e in errs25.values()):
        raise AssertionError(f"K25 differs from plain: {errs25}")
    specs_ = [c.spec() for c in calls]
    st25 = [torch.full((), s.init, dtype=s.state_dtype, device=dev)
            for s in specs_]
    rc25 = torch.zeros((), dtype=torch.int64, device=dev)
    sgn = torch.where(ch.vis, op_sign(ch.ops), 0).to(torch.int64)
    vcol = ch.columns[0].data
    res["simple_agg"] = dict(
        max_abs_err=max(e["int_err"] for e in errs25.values()),
        float_rel_err=max(e["float_rel_err"] for e in errs25.values()),
        cases=errs25, rows=N, calls=len(calls),
        **timings(lambda: simple_agg_apply(specs_, st25, rc25, ch),
                  lambda: simple_agg_apply_plain(specs_, st25, rc25, ch),
                  library_fn=lambda: torch.sum(vcol * sgn)),
        # ops and vis read; three 8-byte argument columns, an int32 one
        # and two valid masks
        bound_ms=bytes_bound_ms(N * (2 + 8 * 3 + 4 + 2)), bound_by="bytes")
    emit({"phase": "kernel", "name": "simple_agg", "nvidia_smi": smi,
          **res["simple_agg"]})
    return res


def mutate_finals(st: SortedSideState, frac: float, seed: int):
    """q6's store after some auctions' max price rose (the finals column
    changed in place, ids and sellers kept)."""
    rng = np.random.default_rng(seed)
    n = int(st.n)
    pick = torch.from_numpy(rng.choice(n, max(1, int(n * frac)),
                                       replace=False)).to(st.khash.device)
    fin = st.cols[0].clone()
    fin[pick] += 1000
    return SortedSideState(st.khash, (fin,) + tuple(st.cols[1:]), st.valids,
                           st.degree, st.n)


def window_summary(runs: list) -> dict:
    """Medians over runs; events are every source's rows."""
    med = statistics.median
    rates = [sum(r["offsets"].values()) / r["wall_s"] for r in runs]
    return dict(
        repeats=len(runs), offsets=runs[0]["offsets"],
        wall_s=med(r["wall_s"] for r in runs),
        events_per_s=med(rates), events_per_s_min=min(rates),
        events_per_s_max=max(rates),
        barrier_p50_s=med(r["coord"].barrier_latency_percentile(0.5)
                          for r in runs),
        barrier_max_s=max(r["coord"].barrier_latency_percentile(1.0)
                          for r in runs),
        mem_peak_bytes=runs[0]["mem_peak_bytes"],
        launches=runs[0]["launches"])


def phase_q6_full(dev, repeats: int = 2, chunks: int = 4,
                  rounds: int = 53, bid_chunk: int = Q6_CHUNK) -> dict:
    """q6 through Session(device=...) into the device blackhole sink,
    `chunks` bid chunks and the auctions of the same event time a
    barrier, `rounds` barriers, `repeats` runs from fresh state: every
    q6 kernel launched, the join's and the over-window's errs 0, the
    over-window store at 2^18 live rows or more at the end on the card;
    events (bids + auctions) / s, barrier p50 / max, the join sides' and
    the store's and emitted set's rows and bytes."""
    on_card = torch.device(dev).type == "cuda"
    runs = []
    for _ in range(repeats):
        r = session_run(dev, window_ddl(Q6_SELECT, "q6", bid_chunk=bid_chunk,
                                        chunks=chunks), rounds, 0,
                        name="q6", pace=window_pace(bid_chunk, chunks))
        ow, join = r["ow"], r["join"]
        if ow.errs() != [0, 0] or join.errs()[1:] != [0, 0]:
            raise AssertionError(f"q6: over-window errs {ow.errs()}, join "
                                 f"errs {join.errs()}")
        missing = [k for k in Q6_KERNELS if r["launches"][k] == 0]
        if missing and on_card:
            raise AssertionError(f"kernels never launched on q6: {missing}")
        r["ow_live"] = int(ow.store.n)
        r["join_live"] = [int(s_.n) for s_ in join.sides]
        runs.append(r)
    live = runs[0]["ow_live"]
    if on_card and live < (1 << 18):
        raise AssertionError(f"q6 store holds {live} rows, under 2^18")
    ow = runs[0]["ow"]
    return dict(
        bid_chunk=bid_chunk, chunks_per_barrier=chunks, barriers=rounds,
        inter_event_us=Q6_INTER_US, ow_live_rows=live,
        ow_capacity=ow.capacity, ow_store_bytes=ow.capacity * _store_row_bytes(ow.store),
        emitted_rows=int(ow.em_n),
        emitted_bytes=ow.capacity * (8 + sum(c.element_size() + 1
                                             for c in ow.em_cols)),
        join_live_rows=runs[0]["join_live"],
        join_errs=runs[0]["join"].errs(),
        agg_groups=int((runs[0]["agg"].state.row_count > 0).sum()),
        runs=[{"wall_s": r["wall_s"], "events_per_s":
               sum(r["offsets"].values()) / r["wall_s"]} for r in runs],
        **window_summary(runs))


def phase_q6_profile(dev, full: dict, rounds: int = 6) -> dict:
    """The device's idle share on q6: a short fresh run under
    torch.profiler against q6_full's unprofiled wall per barrier."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    chunks = full["chunks_per_barrier"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        r = session_run(dev, window_ddl(Q6_SELECT, "q6", chunks=chunks),
                        rounds, 0, name="q6",
                        pace=window_pace(Q6_CHUNK, chunks))
        torch.cuda.synchronize()
    kev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict = {}
    for e in kev:
        t, c = by_name.get(e.name[:60], (0.0, 0))
        by_name[e.name[:60]] = (t + e.time_range.elapsed_us(), c + 1)
    busy = sum(t for t, _ in by_name.values()) / 1e6 / rounds
    wall = full["wall_s"] / full["barriers"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:16]
    return dict(rounds=rounds, wall_s=r["wall_s"],
                device_busy_per_barrier_s=busy,
                unprofiled_wall_per_barrier_s=wall,
                device_idle_share=(1 - busy / wall) if kev else None,
                top_kernels=[{"name": nm, "ms": t / 1e3, "count": c}
                             for nm, (t, c) in top])


def window_check_run(dev, select: str, name: str, rounds: int,
                     check, chunks: int = 1, bid_chunk: int = Q6_CHUNK,
                     **ddl_kw) -> dict:
    """`select` as an MV at q6's geometry; after every barrier
    `check(k, rows, recount)` holds the MV against a WindowRecount
    advanced to the rows the sources emitted before it."""
    pace = window_pace(bid_chunk, chunks)
    rc = WindowRecount(pace["auction"] * rounds, pace["bid"] * rounds, dev)
    checked = []

    def on_barrier(k, s, rows):
        rc.advance(rows["bid"], rows["auction"])
        check(k, mv_rows_now(s, name), rc)
        checked.append(k)

    r = session_run(dev, window_ddl(select, name, bid_chunk=bid_chunk,
                                    chunks=chunks, sink=False, **ddl_kw),
                    rounds, 0, name=name, pace=pace, on_barrier=on_barrier)
    r["checked"] = len(checked)
    r["recount"] = rc
    return r


def _q6_check(k, rows, rc):
    got = Counter((s_, i, a) for s_, i, a in rows)
    want = rc.q6()
    if got != want:
        raise AssertionError(f"q6_check: barrier {k}: MV "
                             f"({sum(got.values())} rows) != recount "
                             f"({sum(want.values())}); "
                             f"{list((got - want).items())[:3]} / "
                             f"{list((want - got).items())[:3]}")


def phase_q6_check(dev, rounds: int = 12) -> dict:
    """q6 as an MV, one bid chunk (and its auctions) a barrier, the
    over-window store started at 2^14 slots with the watchdog on: after
    every barrier the MV equals the numpy recount exactly (integer
    prices: the avgs compare exactly), and the store grew."""
    r = window_check_run(dev, Q6_SELECT, "q6", rounds, _q6_check,
                         ow_cap=1 << 14, watchdog=1)
    ow = r["ow"]
    if r["checked"] < rounds - 1 or ow.capacity <= (1 << 14) \
            or ow.errs() != [0, 0]:
        raise AssertionError(f"q6_check: {r['checked']} barriers checked, "
                             f"capacity {ow.capacity}, errs {ow.errs()}")
    return dict(barriers_checked=r["checked"], mv_rows=len(r["mv"]),
                ow_live_rows=int(ow.store.n), ow_capacity=ow.capacity,
                grew_from=1 << 14, offsets=r["offsets"])


def phase_q4_full(dev, chunks: int = 4, rounds: int = 53) -> dict:
    """q4 at q6_full's geometry as an MV: after every barrier the MV (one
    row a category) equals the recount's AVG of the finals exactly."""
    def check(k, rows, rc):
        want = rc.q4()
        if sorted(rows) != want:
            raise AssertionError(f"q4: barrier {k}: MV {sorted(rows)} != "
                                 f"recount {want}")

    r = window_check_run(dev, Q4_SELECT, "q4", rounds, check, chunks=chunks)
    missing = [k for k in Q4_KERNELS if r["launches"][k] == 0]
    if missing and torch.device(dev).type == "cuda":
        raise AssertionError(f"kernels never launched on q4: {missing}")
    if r["checked"] < rounds - 1 or not r["mv"]:
        raise AssertionError(f"q4: {r['checked']} barriers checked")
    return dict(barriers_checked=r["checked"], categories=len(r["mv"]),
                mv=r["mv"], auctions_with_bids=int(
                    (r["recount"].best >= 0).sum()),
                **window_summary([r]))


def eowc_recount(auction, dt, price, upto=None) -> np.ndarray:
    """(auction, date_time, price, row_number, running sum) rows of the
    bids with date_time <= upto, ordered by (auction, date_time): bid
    times are unique, so ROW order has no ties."""
    keep = slice(None) if upto is None else dt <= upto
    a, t, p = auction[keep], dt[keep], price[keep]
    o = np.lexsort((t, a))
    a, t, p = a[o], t[o], p[o]
    n = len(a)
    pos = np.arange(n)
    new = np.r_[True, a[1:] != a[:-1]] if n else np.zeros(0, bool)
    start = np.maximum.accumulate(np.where(new, pos, 0)) if n else pos
    cs = np.cumsum(p)
    base = np.where(start > 0, cs[np.maximum(start - 1, 0)], 0)
    return np.stack([a, t, p, pos - start + 1, cs - base], axis=1)


def _rows_sorted(cols) -> np.ndarray:
    m = np.stack([np.asarray(c, dtype=np.int64) for c in cols], axis=1)
    return m[np.lexsort(m.T[::-1])] if len(m) else m



def phase_eowc_full(dev, rounds: int = 10, bid_chunk: int = Q6_CHUNK,
                    cap: int = 1 << 21) -> dict:
    """tests/test_eowc_over_window.py's SQL_BODY with EMIT ON WINDOW
    CLOSE over bids at q1's chunking (131072-bid chunks, one a barrier,
    `rounds` barriers, a watermark lag of a third of a chunk's event
    time, 0.47 s, so rows stay open), into a
    device sink that keeps the rows; beside it the same body without
    EOWC (the general over-window). Every EOWC row is an Insert and
    appears once; its rows equal the general's rows with date_time at
    or below the emitted frontier, and both equal a numpy row_number and
    running sum per auction."""
    lag_us = bid_chunk * 50 // 46 * 10 // 3

    def ddl(eowc: bool):
        d = window_ddl(EOWC_BODY + (" EMIT ON WINDOW CLOSE" if eowc else ""),
                       "ew", bid_chunk=bid_chunk, ow_cap=cap, auction=False,
                       inter_us=10)
        d[-2] = d[-2].replace("emit_watermarks=1",
                              f"emit_watermarks=1, watermark_lag_us="
                              f"{lag_us}")
        return d

    n = rounds * bid_chunk
    runs = {}
    for eowc in (True, False):
        r = session_run(dev, ddl(eowc), rounds, bid_chunk, name="ew",
                        collect=2 * n)
        missing = [k for k in EOWC_KERNELS if r["launches"][k] == 0]
        if missing and torch.device(dev).type == "cuda":
            raise AssertionError(f"kernels never launched on EOWC: "
                                 f"{missing}")
        runs[eowc] = r
    ew, gw = runs[True], runs[False]
    cols, sign, dropped = ew["sink"].arrays()
    gcols, gsign, gdropped = gw["sink"].arrays()
    if not (gsign != 0).all():
        raise AssertionError("general over-window: a row without a sign")
    if dropped or gdropped or not (sign == 1).all():
        raise AssertionError("EOWC: a Delete or dropped rows in the sink")
    # exactly once: the row ids are unique
    if len(np.unique(cols[5])) != len(cols[5]):
        raise AssertionError("EOWC emitted a row twice")
    ex = ew["ow"]
    frontier = ex._emitted_to
    auction, price, dt = _bid_prefix(n, NexmarkConfig(), dev, [0, 2, 5])
    want = eowc_recount(auction, dt, price, frontier)
    got = _rows_sorted(cols[:5])
    # the general over-window's net output, restricted to the frontier
    if (gsign == 1).all():
        g_all = _rows_sorted(gcols[:5])
    else:
        net: Counter = Counter()
        for r_, s_ in zip(map(tuple, np.stack(gcols[:6], axis=1).tolist()),
                          gsign.tolist()):
            net[r_] += s_
        if any(c < 0 for c in net.values()):
            raise AssertionError("general over-window: net negative rows")
        g_rows = [r_ for r_, c in net.items() if c > 0 for _ in range(c)]
        g_all = (_rows_sorted(list(zip(*g_rows))[:5]) if g_rows
                 else np.zeros((0, 5), np.int64))
    g_closed = g_all[g_all[:, 1] <= frontier]
    if not (np.array_equal(got, want) and np.array_equal(g_closed, want)
            and np.array_equal(g_all, eowc_recount(auction, dt, price))):
        raise AssertionError(
            f"EOWC: {len(got)} rows emitted, recount {len(want)}, general "
            f"closed prefix {len(g_closed)}")
    open_rows = int(ex.store.n) - len(got)
    if open_rows <= 0 or len(got) == 0:
        raise AssertionError("EOWC: the ripeness gate is vacuous")
    return dict(bid_chunk=bid_chunk, barriers=rounds, bids=n,
                emitted_rows=len(got), open_rows=open_rows,
                store_rows=int(ex.store.n), store_capacity=ex.capacity,
                store_bytes=ex.capacity * _store_row_bytes(ex.store),
                general_rows=len(g_all),
                eowc_bids_per_s=n / ew["wall_s"],
                general_bids_per_s=n / gw["wall_s"],
                eowc_barrier_p50_s=ew["coord"].barrier_latency_percentile(
                    0.5),
                general_barrier_p50_s=gw["coord"]
                .barrier_latency_percentile(0.5),
                launches=ew["launches"])


def phase_global_agg(dev, per_chunks: int = 8, rounds: int = 8,
                     q6_rounds: int = 8) -> dict:
    """The global aggregates: GAGG_SELECT over bids at q1's geometry
    (131072-bid chunks, `per_chunks` a barrier) as an MV, equal to the
    recount (count, sum, max of the bids so far) after every barrier;
    then GAGG_Q6_SELECT (avg and count of q6's finals, whose input
    retracts) at q6's geometry, equal to the recount after every
    barrier."""
    per = per_chunks * Q6_CHUNK
    (price,) = _bid_prefix(per * rounds, NexmarkConfig(), dev, [2])
    cs, cm = np.cumsum(price), np.maximum.accumulate(price)
    checked = []

    def on_barrier(k, s, rows):
        n = rows["bid"]
        got = mv_rows_now(s, "g")
        want = [(n, int(cs[n - 1]), int(cm[n - 1]))]
        if got != want:
            raise AssertionError(f"global agg: barrier {k}: {got} != {want}")
        checked.append(k)

    ddl = ["SET streaming_durability = 0", "SET streaming_watchdog = 0",
           ("CREATE SOURCE bid WITH (connector='nexmark', table='bid', "
            f"chunk_size={Q6_CHUNK})"),
           f"CREATE MATERIALIZED VIEW g AS {GAGG_SELECT}"]
    r = session_run(dev, ddl, rounds, per, name="g", on_barrier=on_barrier)
    missing = [k for k in GAGG_KERNELS if r["launches"][k] == 0]
    if missing and torch.device(dev).type == "cuda":
        raise AssertionError(f"kernels never launched on the global agg: "
                             f"{missing}")

    def check(k, rows, rc):
        want = rc.avg_count()
        if rows != want:
            raise AssertionError(f"global avg: barrier {k}: {rows} != "
                                 f"{want}")

    r2 = window_check_run(dev, GAGG_Q6_SELECT, "g2", q6_rounds, check)
    return dict(bid_chunk=Q6_CHUNK, chunks_per_barrier=per_chunks,
                barriers_checked=len(checked), bids=r["bids"],
                bids_per_s=r["bids"] / r["wall_s"],
                barrier_p50_s=r["coord"].barrier_latency_percentile(0.5),
                mv=r["mv"], avg_barriers_checked=r2["checked"],
                avg_mv=r2["mv"], launches=r["launches"])


def phase_q6_recover(dev, r1: int = 8, r2: int = 8,
                     bid_chunk: int = Q6_CHUNK) -> dict:
    """Durable q6 as an MV on a Hummock store over a local-fs object
    store, one `bid_chunk`-bid chunk (and its auctions) a barrier, q6's
    capacities: r1 barriers, crash(), HummockStateStore.open, a new
    Session, recover() (recovery_ms from the opening to the first
    collected barrier), on to r1 + r2 barriers: the MV must equal the
    numpy recount of the bids and auctions the sources emitted, as an
    uninterrupted run's."""
    pace = window_pace(bid_chunk, 1)
    ddl = window_ddl(Q6_SELECT, "q6", bid_chunk=bid_chunk, sink=False,
                     durable_=1)
    with tempfile.TemporaryDirectory(prefix="q6r_") as d:
        a = session_run(dev, ddl, r1, 0, name="q6", crash=True, pace=pace,
                        store=HummockStateStore(LocalFsObjectStore(d)))
        b = session_run(dev, ddl, 0, 0, name="q6", recover_to=r1 + r2,
                        pace=pace, store=lambda: HummockStateStore.open(
                            LocalFsObjectStore(d)))
    n_b, n_a = b["offsets"]["bid"], b["offsets"]["auction"]
    if n_b != (r1 + r2) * pace["bid"] or n_a != (r1 + r2) * pace["auction"]:
        raise AssertionError(f"q6_recover: offsets {b['offsets']}")
    rc = WindowRecount(n_a, n_b, dev)
    rc.advance(n_b, n_a)
    got = Counter(tuple(r_) for r_ in b["mv"])
    want = rc.q6()
    if got != want or not want:
        raise AssertionError(f"q6_recover: recovered MV ({len(b['mv'])} "
                             f"rows) != recount ({sum(want.values())})")
    return dict(bid_chunk=bid_chunk, barriers_before_crash=r1,
                barriers_after_recovery=b["barriers"],
                recovered_base=b["base"],
                recovery_ms=b["recovery_s"] * 1e3, mv_rows=len(b["mv"]),
                ow_live_rows_at_crash=int(a["ow"].store.n),
                ow_live_rows=int(b["ow"].store.n),
                ow_rows_persisted=a["ow"].persist_rows,
                ow_persist_s=a["ow"].persist_s,
                wall_s_before_crash=a["wall_s"], wall_s_after=b["wall_s"],
                launches=b["launches"])


# ------------------------------------ canonical q5 and the extrema (SQL)

# RisingWave's own Nexmark q5 (ci/scripts/sql/nexmark/q5.sql), HOP in
# integer microseconds as the JAX binder and bench.py write it: count
# per (auction, window), the max of a second such count per window over
# its changelog (a retractable MAX), joined on the window with num >=
# maxn
Q5C_SELECT = (
    "SELECT AuctionBids.auction, AuctionBids.num FROM ("
    " SELECT auction, count(*) AS num, window_start AS starttime"
    " FROM HOP(bid, date_time, 2000000, 10000000)"
    " GROUP BY window_start, auction) AS AuctionBids "
    "JOIN ("
    " SELECT max(CountBids.num) AS maxn, CountBids.starttime_c"
    " FROM (SELECT count(*) AS num, window_start AS starttime_c"
    " FROM HOP(bid, date_time, 2000000, 10000000)"
    " GROUP BY auction, window_start) AS CountBids"
    " GROUP BY CountBids.starttime_c) AS MaxBids "
    "ON AuctionBids.starttime = MaxBids.starttime_c"
    " AND AuctionBids.num >= MaxBids.maxn")
Q5C_CHUNK = 131072
Q5C_PER_BARRIER = 8 * Q5C_CHUNK
Q5C_ROUNDS = 12
# bench's _q5_ddl() SETs; the join is sized to hold AuctionBids' live
# groups (~620k at 12 barriers) without growth, as transfer-free mode
# (streaming_watchdog = 0) never grows it
Q5C_JOIN_CAPACITY = 1 << 20
Q5C_KERNELS = ("nexmark_bid", "hop_window", "hash_table", "hash_agg",
               "compact", "extrema_update", "agg_flush", "radix_sort",
               "pk_net", "sorted_join_probe", "sorted_join_merge",
               "expr_eval")
# bench.py's _q5_ddl() statements, verbatim (cs = 131072)
Q5_SQL_DDL = [
    "SET streaming_durability = 0",
    "SET streaming_watchdog = 0",
    f"SET streaming_agg_capacity = {1 << 20}",
    ("CREATE SOURCE bid WITH (connector='nexmark', table='bid', "
     "chunk_size=131072, inter_event_us=2, emit_watermarks=1)"),
    ("CREATE SINK q5 AS SELECT auction, window_start, count(*) AS n "
     "FROM HOP(bid, date_time, 2000000, 10000000) "
     "GROUP BY auction, window_start "
     "WITH (connector='blackhole_device')"),
]


def q5c_ddl(chunk: int = Q5C_CHUNK, durable_: int = 0,
            agg_cap: int = 1 << 20,
            join_cap: int = Q5C_JOIN_CAPACITY) -> list:
    return [
        f"SET streaming_durability = {durable_}",
        "SET streaming_watchdog = 0",
        f"SET streaming_agg_capacity = {agg_cap}",
        f"SET streaming_join_capacity = {join_cap}",
        ("CREATE SOURCE bid WITH (connector='nexmark', table='bid', "
         f"chunk_size={chunk}, inter_event_us=2)"),
        "CREATE MATERIALIZED VIEW q5c AS " + Q5C_SELECT,
    ]


class Q5cRecount:
    """The canonical q5's MV from the generator's prefix in numpy: counts
    per (auction, window) (recount_windows), the max per window, the
    rows (auction, num, window, window) with num >= the max."""

    def __init__(self, dev, cfg: NexmarkConfig):
        self.dev, self.cfg = dev, cfg
        self.n = 0
        self.counts: Counter = Counter()

    def advance(self, n: int) -> None:
        if n > self.n:
            self.counts.update(recount_windows(self.n, n, self.cfg,
                                               -(1 << 62), self.dev))
            self.n = n

    def rows(self) -> Counter:
        best: dict = {}
        for (a, w), c in self.counts.items():
            best[w] = max(best.get(w, 0), c)
        return Counter((a, c, w, w) for (a, w), c in self.counts.items()
                       if c >= best[w])


def _q5c_mv(rows) -> Counter:
    return Counter(tuple(r) for r in rows)


def extrema_edge_chunks(rng, dtype: str, C: int, n_chunks: int, N: int,
                        is_max: bool):
    """Seeded hazard chunks for a retractable MIN/MAX of C groups, as
    (values, valid, ops, slots): inserts, deletes of values inserted
    earlier (tracked or not), deletes of values never inserted, invisible
    rows (slot -1), NULLs, float values at the edges of XLA's CPU compare
    (NaN, +-0, subnormals, +-inf), and one group that gets many distinct
    values in one chunk. The last group gets three distinct values, then
    loses the best two: at K = 2 its buffer empties with a row left
    (underflow). The CPU tests and kernels_extrema share them."""
    pool = (np.array([np.nan, -0.0, 0.0, 5e-324, -5e-324, 2.2e-308, 1.0,
                      -1.0, 2.5, -2.5, np.inf, -np.inf, 7.0, 3.0])
            if dtype == "float64" else
            np.array([-(1 << 63), (1 << 63) - 1, -1, 0, 1, 2, 3, 5, 8, 13,
                      21, 34], dtype=np.int64))
    live: list = []
    out = []
    for c in range(n_chunks):
        vals = rng.choice(pool, N)
        seg = rng.integers(0, C - 1, N)
        if c % 3 == 1:
            # one group, many distinct values: past K in one chunk
            seg[: N // 2] = 0
        ops = np.zeros(N, np.int8)
        for i in range(N):
            r = rng.random()
            if live and r < 0.35:
                s_, v_ = live.pop(int(rng.integers(len(live))))
                seg[i], vals[i] = s_, v_
                ops[i] = rng.choice([1, 2])          # Delete, UpdateDelete
            elif r < 0.4:
                ops[i] = 1                           # delete never inserted
            else:
                ops[i] = rng.choice([0, 3])          # Insert, UpdateInsert
        valid = rng.random(N) > 0.1
        visible = rng.random(N) > 0.1
        three = np.array([1, 2, 3], dtype=vals.dtype)
        if c == n_chunks - 2:
            seg[:3], vals[:3], ops[:3] = C - 1, three, 0
            valid[:3] = visible[:3] = True
        if c == n_chunks - 1:
            seg[:2], ops[:2] = C - 1, 1
            vals[:2] = three[1:] if is_max else three[:2]
            valid[:2] = visible[:2] = True
        ins = (ops == 0) | (ops == 3)
        live += [(int(seg[i]), vals[i]) for i in range(N)
                 if ins[i] and valid[i] and visible[i] and seg[i] < C - 1]
        out.append((vals.astype(dtype), valid, ops,
                    np.where(visible, seg, -1).astype(np.int32)))
    return out


def extrema_state_err(a: tuple, b: tuple) -> int:
    """Cells (values by their bits, counts, lossy flags) that differ."""
    va, vb = (x[0].view(torch.int64) if x[0].dtype == torch.float64
              else x[0] for x in (a, b))
    return int((va != vb).sum()) + int((a[1] != b[1]).sum()) \
        + int((a[2] != b[2]).sum())


def maxbids_chunks(dev, C: int, N: int, groups: int, per_group: int,
                   pairs: int, seed: int = 0, float_: bool = False):
    """The MaxBids agg's inputs at q5c's shapes: a history chunk of
    `groups` window slots x `per_group` counts (Inserts), then a flush
    chunk of `pairs` U-/U+ pairs (a count v -> v + 1 of one auction), the
    rest of the N rows invisible. Returns (history, update), each
    (values, ops, slots)."""
    g = torch.Generator().manual_seed(seed)
    slots_g = torch.randperm(C, generator=g)[:groups].to(torch.int32)
    n_h = groups * per_group
    # geometric counts (p = 0.08), as HOP window counts of auctions run
    u = torch.rand(n_h, generator=g, dtype=torch.float64)
    hv = torch.clamp((torch.log(u) / math.log(1 - 0.08)).to(torch.int64)
                     + 1, max=400)
    hs = slots_g.repeat_interleave(per_group)
    pick = torch.randint(0, n_h, (pairs,), generator=g)
    old = hv[pick]
    us = hs[pick]
    uv = torch.stack([old, old + 1], 1).reshape(-1)
    uo = torch.tensor([2, 3], dtype=torch.int8).repeat(pairs)
    uslot = us.repeat_interleave(2)

    def padded(v, o, s):
        vals = torch.zeros(N, dtype=torch.int64)
        ops = torch.zeros(N, dtype=torch.int8)
        slots = torch.full((N,), -1, dtype=torch.int32)
        vals[:v.shape[0]], ops[:v.shape[0]], slots[:v.shape[0]] = v, o, s
        if float_:
            vals = vals.to(torch.float64) * 0.5
        return vals.to(dev), ops.to(dev), slots.to(dev)

    return (padded(hv, torch.zeros(n_h, dtype=torch.int8), hs),
            padded(uv, uo, uslot))


def _extrema_copy(st: tuple) -> tuple:
    return tuple(x.clone() for x in st)


def _extrema_restore(dst: tuple, src: tuple) -> None:
    for d, s in zip(dst, src):
        d.copy_(s)


def k26_edge_err(dev) -> int:
    """K26 against its plain version on the hazard chunks (int64 and
    float64, MAX and MIN, K = 2 and 32): state cells and error counts
    that differ, summed."""
    bad = 0
    C, N = 6, 48
    for dtype in ("int64", "float64"):
        tdt = torch.float64 if dtype == "float64" else torch.int64
        for is_max in (True, False):
            for K in (2, 32):
                rng = np.random.default_rng(K * 4 + is_max * 2
                                            + (dtype == "float64"))
                sk = extrema_empty(C, K, tdt, dev)
                sp = extrema_empty(C, K, tdt, dev)
                rc = torch.zeros(C, dtype=torch.int64, device=dev)
                for vals, valid, ops, slots in extrema_edge_chunks(
                        rng, dtype, C, 9, N, is_max):
                    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
                    v_, va_, o_, s_ = t(vals), t(valid), t(ops), t(slots)
                    ok = s_ >= 0
                    rc += torch.zeros(C + 1, dtype=torch.int64,
                                      device=dev).index_add_(
                        0, torch.where(ok, s_.to(torch.int64), C),
                        torch.where(ok, op_sign(o_), 0).to(torch.int64))[:C]
                    ek = torch.zeros((), dtype=torch.int32, device=dev)
                    ep = torch.zeros((), dtype=torch.int32, device=dev)
                    extrema_apply(sk, v_, va_, o_, s_, rc, is_max, ek)
                    extrema_apply_plain(sp, v_, va_, o_, s_, rc, is_max, ep)
                    torch.cuda.synchronize()
                    bad += extrema_state_err(sk, sp) + abs(int(ek) - int(ep))
    return bad


# float32's edge values as float64 state: zeros, float32 subnormals
# (which the cast to REAL flushes and the compare ties with zero), the
# smallest normal, NaN, infinities
F32_EDGE = torch.tensor([0.0, -0.0, 1e-40, -1e-40, 1e-39, 1.1754943508222875e-38,
                         float("nan"), float("inf"), float("-inf"), 1.5,
                         -2.0], dtype=torch.float64)


def agg_state_shape(dev, C: int, key_dtypes, specs, K: int, n_live: int,
                    n_dirty: int, seed: int) -> AggState:
    """A hash-agg state at a path's shape: n_live live groups with
    random keys and states, n_dirty of them dirty, prev_exists/prev_emit
    as a flush left them (random where dirty). A call with a REAL output
    draws its values from F32_EDGE."""
    g = torch.Generator().manual_seed(seed)

    def draw(sp, shape, lo, hi):
        if sp.call.ret_type is DataType.FLOAT32:
            return F32_EDGE[torch.randint(0, F32_EDGE.numel(), shape,
                                          generator=g)]
        return torch.randint(lo, hi, shape, generator=g).to(sp.state_dtype)

    perm = torch.randperm(C, generator=g)
    live = torch.zeros(C, dtype=torch.bool)
    live[perm[:n_live]] = True
    dirty = torch.zeros(C, dtype=torch.bool)
    dirty[perm[:n_dirty]] = True
    rc = torch.where(live, torch.randint(0, 4, (C,), generator=g), 0)
    keys = tuple(torch.where(live, torch.randint(0, 1 << 40, (C,),
                                                 generator=g), 0).to(dt)
                 for dt in key_dtypes)
    states, emits = [], []
    for sp in specs:
        if sp.call.retractable:
            v = draw(sp, (C, K), 1, 300)
            v = torch.sort(v, dim=1, descending=sp.call.kind is AggKind.MAX
                           ).values
            c = torch.randint(0, 3, (C, K), generator=g, dtype=torch.int32)
            c[:, 1:] *= (c[:, :1] > 0).to(torch.int32)
            c *= live[:, None].to(torch.int32)
            v = torch.where(c > 0, v, torch.zeros((), dtype=v.dtype))
            st = (v, c, live & (torch.rand(C, generator=g) < 0.1))
            cur = torch.where(c[:, 0] > 0, v[:, 0],
                              torch.tensor(sp.init, dtype=v.dtype))
        else:
            st = torch.where(live, draw(sp, (C,), 0, 50),
                             torch.zeros((), dtype=sp.state_dtype))
            cur = st
        cur = sp.emit(cur)
        noise = draw(sp, (C,), 0, 300).to(cur.dtype)
        emits.append(torch.where(dirty & (torch.rand(C, generator=g) < 0.5),
                                 noise, cur))
        states.append(st)
    prev = torch.where(dirty, torch.rand(C, generator=g) < 0.7, rc > 0)
    to = (lambda x: tuple(y.to(dev) for y in x) if isinstance(x, tuple)
          else x.to(dev))
    return AggState(ht.HashTable(tuple(k.to(dev) for k in keys),
                                 live.to(dev)),
                    tuple(to(s) for s in states), rc.to(dev),
                    dirty.to(dev), prev.to(dev).clone(),
                    tuple(e.to(dev) for e in emits))


def _agg_clone(st: AggState) -> AggState:
    cl = lambda x: (tuple(y.clone() for y in x)  # noqa: E731
                    if isinstance(x, tuple) else x.clone())
    return AggState(st.table, tuple(cl(a) for a in st.agg_states),
                    st.row_count, st.dirty.clone(), st.prev_exists.clone(),
                    tuple(p.clone() for p in st.prev_emit))


def _flush_restore(dst: AggState, src: AggState) -> None:
    dst.dirty.copy_(src.dirty)
    dst.prev_exists.copy_(src.prev_exists)
    for d, s in zip(dst.prev_emit, src.prev_emit):
        d.copy_(s)


def agg_flush_err(a, b, sa: AggState, sb: AggState) -> int:
    """Output lanes (all 2C rows) and refreshed state that differ, floats
    by their bits."""
    def bits(x):
        return {torch.float64: lambda: x.view(torch.int64),
                torch.float32: lambda: x.view(torch.int32)}.get(
                    x.dtype, lambda: x)()

    bad = 0
    for x, y in zip([a[1], a[2], *a[0], sa.dirty, sa.prev_exists,
                     *sa.prev_emit],
                    [b[1], b[2], *b[0], sb.dirty, sb.prev_exists,
                     *sb.prev_emit]):
        bad += int((bits(x) != bits(y)).sum())
    return bad


def flush_bytes(st: AggState, n_dirty: int) -> int:
    """What the flush must move: the dirty bits; per dirty slot its keys,
    row count, prev_exists, state (a buffer's head value and count) and
    prev_emit read, prev_exists, prev_emit and the dirty bit written;
    2C output rows of ops, vis, keys and values."""
    C = st.table.capacity
    key_b = sum(k.element_size() for k in st.table.keys)
    ret_b = sum(p.element_size() for p in st.prev_emit)
    state_b = sum(12 if isinstance(a, tuple) else 8 for a in st.agg_states)
    per_dirty = key_b + 8 + 1 + state_b + ret_b + (1 + ret_b + 1)
    return C + n_dirty * per_dirty + 2 * C * (2 + key_b + ret_b)


def phase_kernels_extrema(dev) -> dict:
    """K26 (extrema update), K27 (agg flush) and the extended K18 against
    their plain versions: K26 on the MaxBids agg's shapes (a 2^21-row
    flush chunk of U-/U+ count pairs into 17 window groups of a 2^20-slot,
    K = 32 agg, int64 and float64) and on the CPU tests' hazard chunks;
    K27 on q5's, q7's and the MaxBids agg's flush shapes; K18 on the
    MaxBids agg's buffers (65 lanes a call) beside a COUNT."""
    C, N, K = 1 << 20, 1 << 21, 32
    res = {}
    out = {}
    # ---- K26
    for float_ in (False, True):
        tdt = torch.float64 if float_ else torch.int64
        hist, upd = maxbids_chunks(dev, C, N, groups=17, per_group=36000,
                                   pairs=300_000, seed=1 + float_,
                                   float_=float_)
        base = extrema_empty(C, K, tdt, dev)
        rc = torch.zeros(C, dtype=torch.int64, device=dev)
        e0 = torch.zeros((), dtype=torch.int32, device=dev)
        hv, ho, hs = hist
        rc.index_add_(0, hs[hs >= 0].to(torch.int64),
                      torch.ones(int((hs >= 0).sum()), dtype=torch.int64,
                                 device=dev))
        extrema_apply_plain(base, hv, None, ho, hs, rc, True, e0)
        uv, uo, us = upd
        sk, sp = _extrema_copy(base), _extrema_copy(base)
        ek = torch.zeros((), dtype=torch.int32, device=dev)
        ep = torch.zeros((), dtype=torch.int32, device=dev)
        extrema_apply(sk, uv, None, uo, us, rc, True, ek)
        extrema_apply_plain(sp, uv, None, uo, us, rc, True, ep)
        torch.cuda.synchronize()
        err = extrema_state_err(sk, sp) + abs(int(ek) - int(ep))
        touched = int(torch.unique(us[us >= 0]).numel())
        visible = int((us >= 0).sum())
        # every row's slot; an applied row's op and value; the touched
        # groups' buffers read and written and their row counts; err
        n_bytes = (N * 4 + visible * (1 + 8)
                   + touched * (2 * (K * 12 + 1) + 8) + 4)
        st = _extrema_copy(base)
        errt = torch.zeros((), dtype=torch.int32, device=dev)
        tm = timings(
            lambda: extrema_apply(st, uv, None, uo, us, rc, True, errt),
            lambda: extrema_apply_plain(st, uv, None, uo, us, rc, True,
                                        errt),
            setup=lambda: _extrema_restore(st, base))
        out["k26_float64" if float_ else "k26_int64"] = dict(
            max_abs_err=err, errs=[int(ek), int(ep)], touched_groups=touched,
            visible_rows=visible, n_bytes=n_bytes,
            bound_ms=bytes_bound_ms(n_bytes), **tm)
        if not float_:
            res["extrema_update"] = dict(
                max_abs_err=err, bound_ms=bytes_bound_ms(n_bytes),
                bound_by="bytes", **{k: tm[k] for k in
                                     ("ms", "plain_ms", "library_ms")})
    edge = k26_edge_err(dev)
    out["k26_edge_err"] = edge
    res["extrema_update"]["max_abs_err"] += edge
    # ---- K27 on q5's, q7's and the MaxBids agg's flush shapes
    shapes = {
        "q5": (1 << 20, (torch.int64, torch.int64),
               [count_star(append_only=True)], 620_000, 200_000),
        "q7": (1 << 13, (torch.int64,),
               [agg_max(1, append_only=True)], 40, 8),
        "maxbids": (1 << 20, (torch.int64,), [agg_max(1)], 17, 6),
        # REAL outputs: float32 subnormals flushed and compared as XLA's
        # CPU does
        "real": (1 << 13, (torch.int64,),
                 [agg_sum(1, DataType.FLOAT32), agg_min(1, DataType.FLOAT32),
                  agg_max(1, DataType.FLOAT32, append_only=True)], 4000,
                 2000),
    }
    for name, (cap, kdts, calls, n_live, n_dirty) in shapes.items():
        specs = [c.spec() for c in calls]
        st0 = agg_state_shape(dev, cap, kdts, specs, K, n_live, n_dirty,
                              seed=len(name))
        sa, sb = _agg_clone(st0), _agg_clone(st0)
        a = agg_flush(sa, specs)
        b = agg_flush_plain(sb, specs)
        torch.cuda.synchronize()
        err = agg_flush_err(a, b, sa, sb)
        n_bytes = flush_bytes(st0, n_dirty)
        st = _agg_clone(st0)
        tm = timings(lambda: agg_flush(st, specs),
                     lambda: agg_flush_plain(st, specs),
                     setup=lambda: _flush_restore(st, st0))
        out[f"k27_{name}"] = dict(max_abs_err=err, n_bytes=n_bytes,
                                  bound_ms=bytes_bound_ms(n_bytes), **tm)
        if name == "q5":
            res["agg_flush"] = dict(
                max_abs_err=err, bound_ms=bytes_bound_ms(n_bytes),
                bound_by="bytes", **{k: tm[k] for k in
                                     ("ms", "plain_ms", "library_ms")})
        else:
            res["agg_flush"]["max_abs_err"] += err
    # ---- K18 over a COUNT and a retractable MAX's buffers
    specs = [count_star().spec(), agg_max(1).spec()]
    for float_ in (False, True):
        sp18 = ([count_star().spec(),
                 agg_max(1, DataType.FLOAT64).spec()] if float_ else specs)
        st = agg_state_shape(dev, C, (torch.int64,), sp18, K, 17, 6,
                             seed=18 + float_)
        bk, ck = persist_pack(st, None, None)
        bp, cp = persist_pack_plain(st, None, None)
        torch.cuda.synchronize()
        nd = int(cp[0])
        wp = 2 + 1 + 1 + (2 * K + 1) + 1
        err = int((ck != cp).sum()) + int(
            (bk[:nd * wp] != bp[:nd * wp]).sum())
        n_bytes = C + nd * (wp * 8 + wp * 8)
        # a retractable call's state is a tuple of [C, K] buffers
        cols18 = list(st.table.keys) + [st.row_count] + [
            t for a in st.agg_states
            for t in (a if isinstance(a, tuple) else (a,))]

        def library():
            # the dirty rows' lanes gathered: torch.nonzero + index_select
            sel = torch.nonzero(st.dirty).squeeze(1)
            return [c.index_select(0, sel) for c in cols18]

        tm = timings(lambda: persist_pack(st, None, None),
                     lambda: persist_pack_plain(st, None, None),
                     library_fn=library)
        out["k18_extrema_float64" if float_ else "k18_extrema"] = dict(
            max_abs_err=err, rows=nd, lanes=wp, n_bytes=n_bytes,
            bound_ms=bytes_bound_ms(n_bytes), **tm)
    bad = {k: v["max_abs_err"] for k, v in out.items()
           if isinstance(v, dict) and v["max_abs_err"]}
    if bad or edge:
        raise AssertionError(f"extrema kernels disagree with their plain "
                             f"versions: {bad}, edge {edge}")
    emit({"phase": "kernels_extrema", **out})
    return res


def q5c_summary(r: dict, recount: Counter, agg_cap: int) -> dict:
    join, coord = r["join"], r["coord"]
    errs = join.errs()
    if errs != [0, 0, 0]:
        raise AssertionError(f"q5c: join errs {errs}")
    # a side's chunk (an agg's flush, 2C rows) probes a buffer of its
    # match factor x 2C slots: op, emit, every column of both sides
    # with its validity byte
    slots = [f * 2 * agg_cap for f in join.match_factors]
    slot_bytes = 2 + sum(c.element_size() + 1
                         for side in join.sides for c in side.cols)
    got = _q5c_mv(r["mv"])
    if got != recount or not recount:
        raise AssertionError(
            f"q5c: MV ({sum(got.values())} rows) != recount "
            f"({sum(recount.values())}): {list((got - recount).items())[:3]}"
            f" / {list((recount - got).items())[:3]}")
    return dict(
        bids=r["bids"], barriers=r["barriers"], wall_s=r["wall_s"],
        events_per_s=r["bids"] / r["wall_s"],
        barrier_p50_s=coord.barrier_latency_percentile(0.5),
        barrier_max_s=coord.barrier_latency_percentile(1.0),
        mv_rows=len(r["mv"]), join_errs=errs,
        join_live_rows=[int(s_.n) for s_ in join.sides],
        match_slots=slots,
        match_buffer_bytes=[m * slot_bytes for m in slots],
        join_scratch_bytes=[sum(t.numel() * t.element_size()
                                for t in b._t.values())
                            for b in join._bufs],
        mem_peak_bytes=r["mem_peak_bytes"])


def phase_q5c_full(dev, rounds: int = Q5C_ROUNDS, chunk: int = Q5C_CHUNK,
                   agg_cap: int = 1 << 20) -> dict:
    """The canonical q5 through Session(device="cuda") into an MV, 8
    chunks of 131072 bids a barrier, `rounds` barriers: every q5c
    kernel launched, the join's errs [0, 0, 0], no agg overflow, the
    two COUNT aggs never past 0.7 of their 2^20 slots (no growth), the
    MV equal to the numpy recount; events/s, barrier p50/max, peak
    memory, the join's match buffers."""
    on_card = torch.device(dev).type == "cuda"
    held = {}
    r = session_run(dev, q5c_ddl(chunk, agg_cap=agg_cap), rounds,
                    8 * chunk, name="q5c",
                    on_flow=lambda s, dep: held.update(
                        aggs=dep.executors(HashAggExecutor)))
    missing = [k for k in Q5C_KERNELS if r["launches"][k] == 0]
    if missing and on_card:
        raise AssertionError(f"kernels never launched on q5c: {missing}")
    overflow = [a.overflow() for a in held["aggs"]]
    if any(overflow) or any(a.rebuilds for a in held["aggs"]):
        raise AssertionError(f"q5c: agg overflow {overflow}")
    rc = Q5cRecount(dev, NexmarkConfig(inter_event_us=2))
    t0 = time.perf_counter()
    rc.advance(r["bids"])
    recount_s = time.perf_counter() - t0
    out = q5c_summary(r, rc.rows(), agg_cap)
    groups = len(rc.counts)
    if groups > 0.7 * agg_cap:
        raise AssertionError(f"q5c: {groups} groups would grow the agg")
    out.update(live_groups_per_count_agg=groups, recount_s=recount_s,
               agg_overflow=overflow, launches=r["launches"])
    return out


def phase_q5c_profile(dev, full: dict, rounds: int = 4) -> dict:
    """The device's idle share on the canonical q5: a short fresh run
    under torch.profiler against q5c_full's unprofiled wall per
    barrier."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        r = session_run(dev, q5c_ddl(), rounds, Q5C_PER_BARRIER, name="q5c")
        torch.cuda.synchronize()
    kev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict = {}
    for e in kev:
        t, c = by_name.get(e.name[:60], (0.0, 0))
        by_name[e.name[:60]] = (t + e.time_range.elapsed_us(), c + 1)
    busy = sum(t for t, _ in by_name.values()) / 1e6 / rounds
    wall = full["wall_s"] / full["barriers"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:16]
    return dict(rounds=rounds, wall_s=r["wall_s"],
                device_busy_per_barrier_s=busy,
                unprofiled_wall_per_barrier_s=wall,
                device_idle_share=(1 - busy / wall) if kev else None,
                top_kernels=[{"name": nm, "ms": t / 1e3, "count": c}
                             for nm, (t, c) in top])


def phase_q5c_check(dev, rounds: int = 16, chunk: int = Q5C_CHUNK,
                    agg_cap: int = 1 << 20) -> dict:
    """The canonical q5 as an MV, one `chunk`-bid chunk a barrier: after
    every barrier the MV equals the numpy recount of the bids emitted
    before it."""
    rc = Q5cRecount(dev, NexmarkConfig(inter_event_us=2))
    checked = []

    def on_barrier(k, s, rows):
        rc.advance(rows["bid"])
        got = _q5c_mv(mv_rows_now(s, "q5c"))
        want = rc.rows()
        if got != want:
            raise AssertionError(
                f"q5c_check: barrier {k}: MV ({sum(got.values())} rows) != "
                f"recount ({sum(want.values())})")
        checked.append(k)

    r = session_run(dev, q5c_ddl(chunk, agg_cap=agg_cap), rounds, chunk,
                    name="q5c", on_barrier=on_barrier)
    if len(checked) < rounds - 1 or r["join"].errs() != [0, 0, 0]:
        raise AssertionError(f"q5c_check: {len(checked)} barriers checked, "
                             f"join errs {r['join'].errs()}")
    return dict(barriers_checked=len(checked), mv_rows=len(r["mv"]),
                bids=r["bids"])


def phase_q5c_recover(dev, r1: int = 8, r2: int = 8, chunk: int = Q5C_CHUNK,
                      agg_cap: int = 1 << 20) -> dict:
    """The canonical q5 as a durable MV on a Hummock store over a
    local-fs object store, one `chunk`-bid chunk a barrier: r1 barriers,
    crash(), HummockStateStore.open, a new Session, recover(), on to r1
    + r2 barriers: the MV equals the numpy recount, as an uninterrupted
    run's."""
    ddl = q5c_ddl(chunk, durable_=1, agg_cap=agg_cap)
    with tempfile.TemporaryDirectory(prefix="q5cr_") as d:
        a = session_run(dev, ddl, r1, chunk, name="q5c", crash=True,
                        store=HummockStateStore(LocalFsObjectStore(d)))
        b = session_run(dev, ddl, 0, chunk, name="q5c",
                        recover_to=r1 + r2, store=lambda: HummockStateStore
                        .open(LocalFsObjectStore(d)))
    if b["bids"] != (r1 + r2) * chunk:
        raise AssertionError(f"q5c_recover: {b['bids']} bids")
    rc = Q5cRecount(dev, NexmarkConfig(inter_event_us=2))
    rc.advance(b["bids"])
    got, want = _q5c_mv(b["mv"]), rc.rows()
    if got != want or not want or b["join"].errs() != [0, 0, 0]:
        raise AssertionError(f"q5c_recover: recovered MV ({len(b['mv'])} "
                             f"rows) != recount ({sum(want.values())}), "
                             f"join errs {b['join'].errs()}")
    return dict(barriers_before_crash=r1, barriers_after_recovery=b[
        "barriers"], recovered_base=b["base"],
        recovery_ms=b["recovery_s"] * 1e3, mv_rows=len(b["mv"]),
        persist_rows_before_crash=a["persist_rows"],
        wall_s_before_crash=a["wall_s"], wall_s_after=b["wall_s"],
        launches=b["launches"])


def phase_q5_sql(dev, per_chunks: int = 8, rounds: int = 6,
                 ddl=Q5_SQL_DDL, chunk: int = Q5C_CHUNK,
                 cap: int = 1 << 20) -> dict:
    """bench.py's _q5_ddl() verbatim through Session(device="cuda")
    beside the hand-wired q5 (build_q5) at the same geometry: the live
    groups of the two aggs are equal."""
    per = per_chunks * chunk
    r = session_run(dev, ddl, rounds, per, name="q5")
    got = live_groups(r["agg"])
    q5 = build_q5(dev, chunk, cap, 2, per, materialize=False)
    asyncio.run(drive_paced(q5, per, rounds))
    want = live_groups(q5["agg"])
    if got != want or not got or r["bids"] != q5["gen"].offset:
        raise AssertionError(f"q5_sql: {len(got)} groups vs the hand "
                             f"wiring's {len(want)}")
    return dict(bids=r["bids"], live_groups=len(got),
                cleaned_below=r["agg"].cleaned_below, wall_s=r["wall_s"],
                bids_per_s=r["bids"] / r["wall_s"], launches=r["launches"])



# ------------------------------------- outer and temporal joins, NOW()

OJ_CHUNK = 131072
LJ_AUCTIONS = 1 << 22            # lj_full: auctions over 8 barriers
LJ_BARRIERS = 8
LJ_JOIN_CAP = 1 << 23
OUTER_KERNELS = ("nexmark_auction", "nexmark_person", "sorted_join_probe",
                 "outer_join", "sorted_join_merge", "radix_sort",
                 "expr_eval")
DYNF_KERNELS = ("nexmark_auction", "pk_net", "radix_sort",
                "sorted_join_merge", "dynamic_filter")
LJ_SELECT = ("SELECT A.id, P.id AS pid FROM auction A "
             "LEFT OUTER JOIN person P ON A.seller = P.id "
             "AND A.category = 10")
FJ_SELECT = ("SELECT A.id, P.id AS pid FROM auction A "
             "FULL OUTER JOIN person P ON A.seller = P.id "
             "AND A.category = 10")
LJR_SELECT = ("SELECT P.id, S.n FROM person P LEFT JOIN "
              "(SELECT seller, count(*) AS n FROM auction "
              "WHERE category = 10 GROUP BY seller) S ON P.id = S.seller")
TJ_SELECT = ("SELECT B.auction, B.price, A.category FROM bid B "
             "{} JOIN auction A FOR SYSTEM_TIME AS OF PROCTIME() "
             "ON B.auction = A.id")


def outer_ddl(select: str, name: str, *, auction_chunk: int = 0,
              person_chunk: int = 0, bid_chunk: int = 0,
              join_cap: int = LJ_JOIN_CAP, durable_: int = 0,
              sink: bool = True, extra=()) -> list:
    """Persons, auctions (both keyed on id) and keyless bids (chunks of
    OJ_CHUNK rows unless given), and one flow over them: a blackhole
    sink (a phase replaces its root with a device collect sink) or an
    MV."""
    auction_chunk = auction_chunk or OJ_CHUNK
    person_chunk = person_chunk or OJ_CHUNK
    bid_chunk = bid_chunk or OJ_CHUNK
    body = (f"CREATE SINK {name} AS {select} "
            "WITH (connector='blackhole_device')" if sink
            else f"CREATE MATERIALIZED VIEW {name} AS {select}")
    return [
        f"SET streaming_durability = {durable_}",
        f"SET streaming_join_capacity = {join_cap}",
        *extra,
        ("CREATE SOURCE auction WITH (connector='nexmark', "
         f"table='auction', chunk_size={auction_chunk}, primary_key='id')"),
        ("CREATE SOURCE person WITH (connector='nexmark', "
         f"table='person', chunk_size={person_chunk}, primary_key='id')"),
        ("CREATE SOURCE bid WITH (connector='nexmark', table='bid', "
         f"chunk_size={bid_chunk})"),
        body]


def auction_cols_dev(n: int, dev, idx=(0, 6, 7, 8)) -> list:
    """Columns `idx` of auctions [0, n) on the card (plain generator)."""
    vocabs = {k: torch.tensor(v, dtype=torch.int32, device=dev)
              for k, v in vocab_ids().items()}
    parts = []
    for off in range(0, n, 1 << 21):
        cols = gen_auction_columns_plain(off, min(1 << 21, n - off),
                                         NexmarkConfig(), vocabs, dev)
        parts.append([cols[i] for i in idx])
    return [torch.cat(x) for x in zip(*parts)]


def sink_net(sink, key_fn):
    """The collect sink's rows as (sorted distinct int64 keys, net
    counts), zero counts dropped; key_fn(data, valid) -> int64 keys."""
    k = min(int(sink.count), sink.capacity)
    if int(sink.count) > sink.capacity:
        raise AssertionError(f"collect sink overflow: {int(sink.count)}")
    keys = key_fn([d[:k] for d in sink.data], [v[:k] for v in sink.valid])
    u, inv = torch.unique(keys, return_inverse=True)
    cnt = torch.zeros(u.shape[0], dtype=torch.int64, device=keys.device)
    cnt.index_add_(0, inv, sink.sign[:k].to(torch.int64))
    keep = cnt != 0
    return u[keep], cnt[keep]


def _id_key(d, v, i):
    """Column i as id - 1000 + 1, 0 for NULL (24 bits)."""
    return torch.where(v[i], d[i] - 999, 0)


def pair_keys(d, v):
    return (_id_key(d, v, 0) << 24) | _id_key(d, v, 1)


def lj_recount(n_auctions: int, n_persons: int, dev, full: bool = False):
    """Sorted keys of the LEFT (or FULL) join of auctions [0, n_auctions)
    and persons [0, n_persons) on seller = id AND category = 10, as
    pair_keys encodes (id, pid) rows."""
    aid, _, seller, cat = auction_cols_dev(n_auctions, dev)
    match = (cat == 10) & (seller - 1000 < n_persons)
    keys = ((aid - 999) << 24) | torch.where(match, seller - 999, 0)
    if full:
        pids = torch.arange(n_persons, device=dev) + 1000
        hit = torch.zeros(n_persons, dtype=torch.bool, device=dev)
        hit[(seller[match] - 1000)] = True
        keys = torch.cat([keys, pids[~hit] - 999])
    return torch.sort(keys).values


def profiled(fn):
    """fn() under torch.profiler with device activity only (host ops are
    not recorded, so the host runs near its own pace): (its result,
    device busy seconds, top kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict = {}
    for e in kev:
        t, c = by_name.get(e.name[:60], (0.0, 0))
        by_name[e.name[:60]] = (t + e.time_range.elapsed_us(), c + 1)
    busy = sum(t for t, _ in by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return out, busy, [{"name": nm, "ms": t / 1e3, "count": c}
                       for nm, (t, c) in top]


def run_figures(r: dict, events: int) -> dict:
    """events/s and barrier p50/max of an unprofiled run."""
    coord = r["coord"]
    return dict(events=events, barriers=r["barriers"], wall_s=r["wall_s"],
                events_per_s=events / r["wall_s"],
                barrier_p50_s=coord.barrier_latency_percentile(0.5),
                barrier_max_s=coord.barrier_latency_percentile(1.0),
                mem_peak_bytes=r["mem_peak_bytes"])


def run_twice(run) -> tuple:
    """run() unprofiled, for the phase's rates and barrier latencies and
    its checks; then run() again, of the same geometry and length, under
    `profiled`: the device busy time, the top kernels and the idle share
    (1 - busy / that profiled run's own wall). Returns (the first run,
    the profile's figures)."""
    r = run()
    pr, busy, top = profiled(run)
    if busy <= 0:
        raise AssertionError("the profiled run recorded no device time")
    return r, dict(device_busy_s=busy,
                   device_idle_share=1 - busy / pr["wall_s"],
                   profiled_wall_s=pr["wall_s"], profiled_top=top)


# ---- kernels_outer

def _apply_outer_case(dev, other, chunk_cols, ops, vis, key_valid, key_idx,
                      other_key_idx, mf, outer_own, outer_other, cond,
                      side):
    """K6 + K5 + K28 on the card against probe_plain + the plain
    condition + outer_apply_plain on the same inputs. Returns (error,
    visible rows per segment, the plain run's transitions)."""
    N = ops.shape[0]
    M = mf * N
    active = vis & key_valid
    null_key = vis & ~key_valid
    key_cols = [chunk_cols[i].data for i in key_idx]
    T = outer_segments(M, N, outer_own, outer_other)

    def side_copy():
        return SortedSideState(other.khash, other.cols, other.valids,
                               other.degree.clone(), other.n)

    def cond_cols(own_m, oth_m):
        cols = own_m + oth_m if side == 0 else oth_m + own_m
        return [Column(c.data[:M], None if c.valid is None
                       else c.valid[:M]) for c in cols]

    ok_, ek = side_copy(), torch.zeros(3, dtype=torch.int32, device=dev)
    _, _, own_m, oth_m, opsm, emit, src, pos = probe(
        key_cols, active, active, ops, ok_, other_key_idx, chunk_cols, M,
        ek, _Buffers(torch.device(dev)), rows=T, slots=True)
    if cond is not None:
        cond.and_into(cond_cols(own_m, oth_m), emit[:M])
    a = outer_apply(emit, src, pos, ops, active, null_key, ok_, chunk_cols,
                    own_m, oth_m, opsm, M, outer_own, outer_other, ek,
                    _Buffers(torch.device(dev)))
    op_, ep = side_copy(), torch.zeros(3, dtype=torch.int32, device=dev)
    _, _, own_p, oth_p, opsp, emitp, srcp, posp = probe_plain(
        key_cols, active, active, ops, op_, other_key_idx, chunk_cols, M,
        ep)
    if cond is not None:
        cond.and_into_plain(cond_cols(own_p, oth_p), emitp)
    b = outer_apply_plain(emitp, srcp, posp, ops, active, null_key, op_,
                          chunk_cols, own_p, oth_p, opsp, M, outer_own,
                          outer_other, ep)
    torch.cuda.synchronize()
    vis_a, vis_b = a[5], b[5]
    err = exact_err([a[0], a[1], vis_a, ek], [b[0], b[1], vis_b, ep])
    sel = vis_b
    err = max(err, int((a[4][sel] != b[4][sel]).sum()))
    for ca, cb in zip(a[2] + a[3], b[2] + b[3]):
        va, vb = ca.valid_mask()[sel], cb.valid_mask()[sel]
        err = max(err, int((va != vb).sum()),
                  int(((ca.data[sel] != cb.data[sel]) & vb).sum()))
    segs = [int(vis_b[:M].sum())]
    if outer_other:
        segs.append(int(vis_b[M:2 * M].sum()))
    if outer_own:
        segs.append(int(vis_b[T - N:].sum()))
    return err, segs, b


def outer_store(dev, n: int, C: int, seed: int):
    """The lj_full auction side at its end: n auctions (id, seller,
    category) keyed on seller in C slots, degrees 0-2 (a third 0)."""
    aid, _, seller, cat = auction_cols_dev(n, dev)
    st = store_from_rows([seller, aid, cat], C)
    g = torch.Generator(device="cpu").manual_seed(seed)
    deg = torch.randint(0, 3, (C,), generator=g).to(dev, torch.int32)
    st.degree.copy_(torch.where(torch.arange(C, device=dev) < st.n, deg, 0))
    return st


def person_chunk(dev, store: SortedSideState, N: int, seed: int,
                 null_p: float = 0.0):
    """N person rows (id) whose ids are sellers of the store, in U-/U+
    pairs of one id (a degree that falls and rises in the chunk),
    Deletes and Inserts; `null_p` of them with a NULL id."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    n = int(store.n)
    ids = store.cols[0][torch.randint(0, n, (N,), generator=g).to(dev)]
    ids[1::2] = ids[0::2]
    ops = torch.randint(0, 2, (N,), generator=g).to(torch.int8)
    ops[0::4], ops[1::4] = 2, 3            # U-/U+ pairs of one id
    key_valid = (torch.rand(N, generator=g) >= null_p).to(dev)
    return [Column(ids, key_valid)], ops.to(dev), \
        torch.ones(N, dtype=torch.bool, device=dev), key_valid


def phase_kernels_outer(dev, n: int = LJ_AUCTIONS, C: int = LJ_JOIN_CAP,
                        N: int = OJ_CHUNK) -> dict:
    """K28 (outer join degrees and NULL rows), K7 with degrees and K29
    (the dynamic filter's flush) against their plain versions on the
    card, exactly. K28 at lj_full's shapes: a person chunk (U-/U+ pairs,
    deletes, NULL ids) probing the 2^22-row auction side (2^23 slots,
    match factor 64) with the condition category = 10, as a LEFT, FULL
    and RIGHT join, and an auction chunk probing the person side."""
    res, out = {}, {}
    astore = outer_store(dev, n, C, seed=28)
    # the joined row is (seller, id, category | person id): category = 10
    cond = ExprProgram([call("equal", col(2, DataType.INT64), lit(10))])
    chunk_cols, ops, vis, kv = person_chunk(dev, astore, N, 1, 0.01)
    err_all = 0
    for name, oo, ot in (("left", False, True), ("full", True, True),
                         ("right", True, False)):
        err, segs, plain = _apply_outer_case(
            dev, astore, chunk_cols, ops, vis, kv, (0,), (0,), 64, oo, ot,
            cond, 1)
        out[f"k28_person_{name}"] = dict(max_abs_err=err,
                                         visible_rows=segs)
        err_all = max(err_all, err)
    # the auction side probing persons (ids 1000..): some sellers absent
    pids = torch.arange(1000, 1000 + (n // 3), device=dev)
    pstore = store_from_rows([pids], C >> 2)
    acols = auction_cols_dev(N, dev, (0, 6, 7, 8))
    akv = acols[2] % 97 != 0                     # NULL sellers
    a_chunk = [Column(acols[0]), Column(acols[2], akv), Column(acols[3])]
    aops = torch.zeros(N, dtype=torch.int8, device=dev)
    aops[1::5] = 1
    avis = torch.ones(N, dtype=torch.bool, device=dev)
    cond_l = ExprProgram([call("equal", col(2, DataType.INT64), lit(10))])
    for name, oo, ot in (("left", True, False), ("full", True, True)):
        err, segs, _ = _apply_outer_case(
            dev, pstore, a_chunk, aops, avis, akv, (1,), (0,), 2, oo, ot,
            cond_l, 0)
        out[f"k28_auction_{name}"] = dict(max_abs_err=err,
                                          visible_rows=segs)
        err_all = max(err_all, err)
    # ---- K28 timing: the LEFT join's person chunk (the lj_full path)
    M = 64 * N
    T = outer_segments(M, N, False, True)
    active = vis & kv
    null_key = vis & ~kv
    ek = torch.zeros(3, dtype=torch.int32, device=dev)
    deg0 = astore.degree.clone()
    _, _, own_m, oth_m, opsm, emit_k, src, pos = probe(
        [chunk_cols[0].data], active, active, ops, astore, (0,), chunk_cols,
        M, ek, _Buffers(torch.device(dev)), rows=T, slots=True)
    cond.and_into([Column(c.data[:M], c.valid[:M]) for c in oth_m + own_m],
                  emit_k[:M])
    emit0 = emit_k[:M].clone()
    _, _, own_p, oth_p, opsp, emitp, srcp, posp = probe_plain(
        [chunk_cols[0].data], active, active, ops, astore, (0,), chunk_cols,
        M, ek)
    cond.and_into_plain(oth_p + own_p, emitp)
    bufs = _Buffers(torch.device(dev))
    plain = outer_apply_plain(emitp, srcp, posp, ops, active, null_key,
                              astore, chunk_cols, own_p, oth_p, opsp, M,
                              False, True, ek)
    n_emit = int(emit0.sum())
    touched = int(torch.unique(posp[emitp]).numel())
    rows_hit = int(torch.unique(srcp[emitp]).numel())
    n_trans = int(plain[5][M:].sum())
    oth_row = sum(c.element_size() + 1 for c in astore.cols)
    # what this chunk needs: every slot's emit flag; the emitting slots'
    # chunk row and other-side row (src, pos); the op of each chunk row
    # that emits; the match counts written; the touched rows' degree
    # read and written; each transition row's other-side columns and
    # valids gathered and written, its own side's valid bytes (NULL) and
    # op; the transition segment's vis
    k28_bytes = (M + n_emit * 8 + rows_hit + N * 4 + touched * 8
                 + n_trans * (2 * oth_row + len(chunk_cols) + 1) + M)

    def restore():
        astore.degree.copy_(deg0)
        emit_k[:M].copy_(emit0)

    tm = timings(
        lambda: outer_apply(emit_k, src, pos, ops, active, null_key, astore,
                            chunk_cols, own_m, oth_m, opsm, M, False, True,
                            ek, bufs),
        lambda: outer_apply_plain(emitp, srcp, posp, ops, active, null_key,
                                  astore, chunk_cols, own_p, oth_p, opsp, M,
                                  False, True, ek),
        setup=restore)
    astore.degree.copy_(deg0)
    res["outer_join"] = dict(
        max_abs_err=err_all, bound_ms=bytes_bound_ms(k28_bytes),
        bound_by="bytes", **{k: tm[k] for k in
                             ("ms", "plain_ms", "library_ms")})
    out["k28_timing"] = dict(slots=M, emitting=n_emit, touched=touched,
                             chunk_rows_emitting=rows_hit,
                             transitions=n_trans, n_bytes=k28_bytes,
                             bound_ms=bytes_bound_ms(k28_bytes), **tm)
    # ---- K7 with degrees: auction chunk rows merged with match counts
    nh, iorder = torch.sort(key_hash([acols[2]]), stable=True)
    n_new = torch.tensor(N, dtype=torch.int32, device=dev)
    mcnt = torch.randint(0, 4, (N,), generator=torch.Generator(
        device="cpu").manual_seed(7)).to(dev, torch.int32)
    mcols = [Column(acols[2]), Column(acols[0]), Column(acols[3])]
    margs = (astore, nh, iorder, n_new, mcols, None, None, 2 * N, (0, 1),
             None, NO_WATERMARK)
    spare = empty_sorted_side(C, [c.dtype for c in astore.cols], dev)
    e7k = torch.zeros(3, dtype=torch.int32, device=dev)
    e7p = torch.zeros(3, dtype=torch.int32, device=dev)
    k7a = merge(*margs, e7k, spare, _Buffers(torch.device(dev)),
                match_cnt=mcnt)
    k7b = merge_plain(*margs, e7p, match_cnt=mcnt)
    torch.cuda.synchronize()
    e7 = max(store_err(k7a, k7b), exact_err([e7k], [e7p]))
    n_live, n_after = int(astore.n), int(k7b.n)
    k7_bytes = (n_live * _store_row_bytes(astore)
                + N * (8 + 8 + 4 + sum(c.data.element_size()
                                       for c in mcols))
                + n_after * _store_row_bytes(astore))
    b7 = _Buffers(torch.device(dev))
    tm7 = timings(lambda: merge(*margs, e7k, spare, b7, match_cnt=mcnt),
                  lambda: merge_plain(*margs, e7p, match_cnt=mcnt))
    out["k7_degrees"] = dict(max_abs_err=e7, rows_before=n_live,
                             rows_after=n_after,
                             bound_ms=bytes_bound_ms(k7_bytes), **tm7)
    # ---- K29: the four ops, a retracted rhs, NULL and float keys
    out.update(k29_checks(dev, n, C))
    res["dynamic_filter"] = out.pop("k29_row")
    bad = {k: v["max_abs_err"] for k, v in out.items()
           if isinstance(v, dict) and v.get("max_abs_err")}
    if bad or err_all or e7:
        raise AssertionError(f"outer kernels disagree with their plain "
                             f"versions: {bad}")
    emit({"phase": "kernels_outer", **out})
    return res


def k29_checks(dev, n: int, C: int) -> dict:
    """K29's flush against its plain version: a store of n auctions (all
    ten columns, as the dynf path stores them) in C slots, filtered on
    expires, an emitted set from a first flush, then each op at a second
    rhs; a retracted rhs (the sentinel); a float64 key with NaN, +-0,
    subnormals and infinities; NULL filter values."""
    acols = auction_cols_dev(n, dev, tuple(range(10)))
    aid, expires = acols[0], acols[6]
    g = torch.Generator(device="cpu").manual_seed(29)
    st = store_from_rows(acols, C)
    live = int(st.n)
    st.valids[6][:live] = (torch.rand(live, generator=g) > 0.01).to(dev)
    lo, hi = int(expires.min()), int(expires.max())
    out = {}

    def empty_em(store):
        return (torch.full((C,), HSENTINEL, dtype=torch.int64, device=dev),
                tuple(torch.zeros(C, dtype=c.dtype, device=dev)
                      for c in store.cols),
                tuple(torch.zeros(C, dtype=torch.bool, device=dev)
                      for _ in store.cols),
                torch.zeros((), dtype=torch.int32, device=dev))

    def case(store, op, rhs0, rhs1, kc=6):
        em = dynf_flush(store, kc, op, rhs0, *empty_em(store),
                        plain=True)[:4]
        a = dynf_flush(store, kc, op, rhs1, *em)
        b = dynf_flush(store, kc, op, rhs1, *em, plain=True)
        torch.cuda.synchronize()
        err = exact_err([a[0], a[3], a[6], a[7], *a[4], *a[5]],
                        [b[0], b[3], b[6], b[7], *b[4], *b[5]])
        return err, int(b[7].sum()), em

    mid1, mid2 = lo + (hi - lo) // 3, lo + 2 * (hi - lo) // 3
    for op in OPS:
        err, vis, _ = case(st, op, mid1, mid2)
        out[f"k29_{op}"] = dict(max_abs_err=err, visible_rows=vis)
    err, vis, _ = case(st, "greater_than", mid1, INT64_MAX)
    out["k29_retracted"] = dict(max_abs_err=err, visible_rows=vis)
    err, vis, _ = case(st, "less_than_or_equal", mid1, INT64_MIN)
    out["k29_retracted_le"] = dict(max_abs_err=err, visible_rows=vis)
    fx = (expires - lo).to(torch.float64) / 1e6 - 50.0
    edge = torch.tensor([float("nan"), 0.0, -0.0, 5e-324, -5e-324,
                         float("inf"), -float("inf"), 2.0 ** 62],
                        dtype=torch.float64, device=dev)
    reps = min(1024, n // 64)
    fx[: 8 * reps] = edge.repeat(reps)
    fst = store_from_rows([aid, fx], C)
    for op in ("greater_than", "less_than_or_equal"):
        err, vis, _ = case(fst, op, -10, 0, kc=1)
        out[f"k29_float_{op}"] = dict(max_abs_err=err, visible_rows=vis)
    # timing at the dynf shape (ten columns, 2^22 rows in 2^23 slots):
    # the set at one rhs, then a flush at a third of the range higher
    em = dynf_flush(st, 6, "greater_than", mid1, *empty_em(st),
                    plain=True)[:4]
    ref = dynf_flush(st, 6, "greater_than", mid2, *em, plain=True)
    old_n, new_n = int(em[3]), int(ref[3])
    n_del = int(ref[7][:C].sum())
    K = len(st.cols)
    row = sum(c.element_size() + 1 for c in st.cols)
    key_w = st.cols[6].element_size() + 1
    # what this flush needs: the filter column and its valid of every
    # live row; each passing row's columns and valids read, its hash and
    # its row in the new set (the output's second half) written; the old
    # set's hashes read for `member`; each row that left the set read
    # from the old set and written as a Delete; every output row's op
    # and vis
    k29_bytes = (live * key_w + new_n * (2 * row + 8) + old_n * 8
                 + n_del * 2 * row + 2 * C * 2)
    tm = timings(lambda: dynf_flush(st, 6, "greater_than", mid2, *em),
                 lambda: dynf_flush(st, 6, "greater_than", mid2, *em,
                                    plain=True))
    out["k29_timing"] = dict(slots=C, live=live, columns=K,
                             old_set=old_n, new_set=new_n,
                             deletes=n_del, n_bytes=k29_bytes,
                             bound_ms=bytes_bound_ms(k29_bytes), **tm)
    worst = max(v["max_abs_err"] for v in out.values()
                if "max_abs_err" in v)
    out["k29_row"] = dict(max_abs_err=worst,
                          bound_ms=bytes_bound_ms(k29_bytes),
                          bound_by="bytes",
                          **{k: tm[k] for k in ("ms", "plain_ms",
                                                "library_ms")})
    return out


# ---- lj_full, lj_retract, fj_check, lj_recover

def collect_join(dev, ddl, name, rounds, pace, collect, **kw):
    """session_run of a join flow into a device collect sink; the join's
    errs must be [0, 0, 0]."""
    r = session_run(dev, ddl, rounds, 0, name=name, pace=pace,
                    collect=collect, **kw)
    if r["join"] is not None and r["join"].errs() != [0, 0, 0]:
        raise AssertionError(f"{name}: join errs {r['join'].errs()}")
    return r


def phase_lj_full(dev, rounds: int = LJ_BARRIERS) -> dict:
    """auction A LEFT OUTER JOIN person P ON A.seller = P.id AND
    A.category = 10 through Session(device="cuda") at 2^22 auctions (8
    barriers of 2^19) and persons lagging at 0.75 of their event time:
    auctions whose seller arrives later emit a NULL-padded row that the
    person's arrival retracts (K28's transitions). The net output equals
    the numpy recount, one row per auction, NULL-padded and matched rows
    both present; errs [0, 0, 0]; every outer-join kernel launched."""
    per = LJ_AUCTIONS // rounds
    # the generator gives a person per three auctions of event time: at a
    # quarter of the auctions' count a barrier, persons lag, so an
    # auction's seller often arrives barriers after it
    pace = {"auction": per, "person": per // 4}
    ddl = outer_ddl(LJ_SELECT, "lj", auction_chunk=OJ_CHUNK,
                    person_chunk=OJ_CHUNK)
    r, prof = run_twice(lambda: collect_join(
        dev, ddl, "lj", rounds + 1, pace, 3 * LJ_AUCTIONS))
    missing = [k for k in OUTER_KERNELS if r["launches"][k] == 0]
    if missing and torch.device(dev).type == "cuda":
        raise AssertionError(f"kernels never launched on lj: {missing}")
    nA, nP = r["offsets"]["auction"], r["offsets"]["person"]
    keys, cnt = sink_net(r["sink"], pair_keys)
    want = lj_recount(nA, nP, dev)
    nulls = int(((keys & ((1 << 24) - 1)) == 0).sum())
    if not (bool((cnt == 1).all()) and torch.equal(keys, want)) \
            or not 0 < nulls < nA:
        raise AssertionError(f"lj_full: {keys.numel()} net rows against "
                             f"{want.numel()} recounted, {nulls} NULL")
    join = r["join"]
    emitted = int(r["sink"].count)
    return dict(run_figures(r, nA + nP), **prof, auctions=nA, persons=nP,
                net_rows=int(keys.numel()), null_rows=nulls,
                rows_emitted=emitted,
                retracted_null_rows=(emitted - nA) // 2,
                join_live_rows=[int(s_.n) for s_ in join.sides],
                join_errs=join.errs(), launches=r["launches"])


def phase_lj_retract(dev, rounds: int = 8, per: int = 65536) -> dict:
    """person P LEFT JOIN (SELECT seller, count(*) AS n FROM auction
    WHERE category = 10 GROUP BY seller) S ON P.id = S.seller: every
    count update is a U-/U+ pair, so a person's degree falls and rises
    inside one chunk. After every barrier of both runs (`run_twice`) the
    net output equals the recount (one row per person: its count, or
    NULL)."""
    pace = {"auction": per, "person": per // 4}     # persons lag
    ddl = outer_ddl(LJR_SELECT, "ljr", auction_chunk=per // 4,
                    person_chunk=per // 4)
    checked = []
    held = {}

    def keyf(d, v):
        return (_id_key(d, v, 0) << 24) | torch.where(v[1], d[1], 0)

    def on_barrier(k, s, rows):
        keys, cnt = sink_net(held["sink"], keyf)
        nA, nP = rows["auction"], rows["person"]
        _, _, seller, cat = auction_cols_dev(nA, dev)
        sel = seller[cat == 10] - 1000
        per_seller = torch.bincount(sel[sel < nP], minlength=nP)[:nP]
        want = (torch.arange(nP, device=dev) + 1) << 24 | per_seller
        if not (bool((cnt == 1).all())
                and torch.equal(keys, torch.sort(want).values)):
            raise AssertionError(f"lj_retract: barrier {k}: "
                                 f"{keys.numel()} rows against {nP}")
        checked.append(k)

    def on_flow(s, dep):
        held["sink"] = next(a.consumer for a in dep.actors
                            if isinstance(a.consumer,
                                          DeviceCollectSinkExecutor))

    r, prof = run_twice(lambda: collect_join(
        dev, ddl, "ljr", rounds + 1, pace, 1 << 22, on_flow=on_flow,
        on_barrier=on_barrier))
    if len(checked) < 2 * rounds:
        raise AssertionError(f"lj_retract: {len(checked)} barriers checked")
    return dict(run_figures(r, sum(r["offsets"].values())), **prof,
                barriers_checked=len(checked), launches=r["launches"])


def phase_fj_check(dev, rounds: int = 8, per: int = 1 << 17) -> dict:
    """The FULL join of tests/test_outer_join_sql.py's golden (auction A
    FULL OUTER JOIN person P ON A.seller = P.id AND A.category = 10):
    most persons have no category-10 auction, so right-only NULL rows
    are many (at least a third of the persons). Exact against the
    recount."""
    pace = {"auction": per, "person": per // 4}     # persons lag
    ddl = outer_ddl(FJ_SELECT, "fj", auction_chunk=per // 2,
                    person_chunk=per // 4)
    r, prof = run_twice(lambda: collect_join(
        dev, ddl, "fj", rounds + 1, pace, 1 << 22))
    nA, nP = r["offsets"]["auction"], r["offsets"]["person"]
    keys, cnt = sink_net(r["sink"], pair_keys)
    want = lj_recount(nA, nP, dev, full=True)
    right_only = int((keys < (1 << 24)).sum())
    if not (bool((cnt == 1).all()) and torch.equal(keys, want)) \
            or right_only < nP // 3:
        raise AssertionError(f"fj_check: {keys.numel()} rows against "
                             f"{want.numel()}, {right_only} right-only")
    return dict(run_figures(r, nA + nP), **prof, auctions=nA,
                persons=nP, net_rows=int(keys.numel()),
                right_only_rows=right_only, launches=r["launches"])


def phase_tj_full(dev, rounds: int = 4) -> dict:
    """bid B LEFT JOIN auction A FOR SYSTEM_TIME AS OF PROCTIME() ON
    B.auction = A.id at 131072-bid chunks against 2^22 auctions (2^20 a
    barrier), then the inner form: exactly one output row per bid (LEFT;
    at most one, INNER), no retraction, every matched row's category the
    generator's."""
    cats = auction_cols_dev(LJ_AUCTIONS, dev, (8,))[0]
    out = {}
    for jt in ("LEFT", "INNER"):
        pace = {"auction": LJ_AUCTIONS // rounds, "bid": OJ_CHUNK}
        ddl = outer_ddl(TJ_SELECT.format(jt), "tj")
        r, prof = run_twice(lambda: collect_join(
            dev, ddl, "tj", rounds + 1, pace, 1 << 21))
        sink = r["sink"]
        k = int(sink.count)
        d, v = [x[:k] for x in sink.data], [x[:k] for x in sink.valid]
        nB = r["offsets"]["bid"]
        matched = v[2]
        got_cat = d[2][matched]
        want_cat = cats[d[0][matched] - 1000]
        if bool((sink.sign[:k] != 1).any()) or (
                k != nB if jt == "LEFT" else k > nB) \
                or not torch.equal(got_cat, want_cat) \
                or int(matched.sum()) == 0:
            raise AssertionError(f"tj_full {jt}: {k} rows for {nB} bids, "
                                 f"{int(matched.sum())} matched")
        out[jt.lower()] = dict(run_figures(r, sum(r["offsets"].values())),
                               **prof, bids=nB, rows=k,
                               matched=int(matched.sum()),
                               launches=r["launches"])
    return out


def phase_lj_recover(dev, r1: int = 4, r2: int = 4,
                     per: int = 1 << 15) -> dict:
    """The LEFT join as a durable MV (ids only) on a Hummock store over a
    local-fs object store, persons lagging: crash at barrier r1,
    HummockStateStore.open, a new Session, recover() (both sides'
    degrees rebuilt by replay), on to r1 + r2 barriers: the MV equals an
    uninterrupted durable run's and the recount, and rows NULL-padded at
    the crash carry their match after it (their NULL rows were
    retracted through the rebuilt degrees)."""
    pace = {"auction": per, "person": per // 8}     # persons lag
    ddl = outer_ddl(LJ_SELECT, "lj", auction_chunk=per // 2,
                    person_chunk=per // 8, durable_=1, sink=False,
                    join_cap=1 << 20)

    def mv_keys(rows):
        a = torch.tensor([[x if x is not None else 0 for x in r[:2]]
                          for r in rows], dtype=torch.int64, device=dev)
        ok = torch.tensor([r[1] is not None for r in rows], device=dev)
        return torch.sort(((a[:, 0] - 999) << 24)
                          | torch.where(ok, a[:, 1] - 999, 0)).values

    with tempfile.TemporaryDirectory(prefix="ljr_") as d:
        a = session_run(dev, ddl, r1, 0, name="lj", crash=True, pace=pace,
                        store=HummockStateStore(LocalFsObjectStore(d)))
        b = session_run(dev, ddl, 0, 0, name="lj", pace=pace,
                        recover_to=r1 + r2, store=lambda: HummockStateStore
                        .open(LocalFsObjectStore(d)))
    with tempfile.TemporaryDirectory(prefix="lju_") as d:
        u = session_run(dev, ddl, r1 + r2, 0, name="lj", pace=pace,
                        store=HummockStateStore(LocalFsObjectStore(d)))
    got, ref = mv_keys(b["mv"]), mv_keys(u["mv"])
    want = lj_recount(b["offsets"]["auction"], b["offsets"]["person"], dev)
    null_then = {r[0] for r in a["mv"] if r[1] is None}
    fixed = sum(1 for r in b["mv"] if r[1] is not None and r[0] in null_then)
    if not (torch.equal(got, ref) and torch.equal(got, want)) or not fixed \
            or b["join"].errs() != [0, 0, 0]:
        raise AssertionError(f"lj_recover: {got.numel()} MV rows, "
                             f"uninterrupted {ref.numel()}, recount "
                             f"{want.numel()}, {fixed} NULL rows fixed")
    return dict(run_figures(b, sum(b["offsets"].values())),
                barriers_before_crash=r1,
                barriers_after_recovery=b["barriers"],
                recovery_ms=b["recovery_s"] * 1e3, mv_rows=len(b["mv"]),
                null_rows_at_crash=len(null_then),
                null_rows_matched_after_recovery=fixed,
                launches=b["launches"])


# ---- dynf

DYNF_GT = "SELECT id, expires FROM auction WHERE expires > now()"
DYNF_LT = "SELECT id, expires FROM auction WHERE expires < now()"


class Scripted(Executor):
    """A scripted input: its messages in order (the CPU tests feed JAX's
    executors and the port's with it too)."""

    def __init__(self, sch, msgs=(), pk=()):
        self.schema = sch
        self.pk_indices = pk
        self._msgs = list(msgs)
        self.identity = "Scripted"

    async def execute(self):
        for m in self._msgs:
            yield m
            await asyncio.sleep(0)


def phase_dynf(dev, rounds: int = 4, steps: int = 16) -> dict:
    """`WHERE expires > now()` through Session(device="cuda") over 2^22
    auctions (2^20 a barrier; the generator's event time, 2017 in unix
    us, is above the epoch clock's now, which counts from 2022: every
    row passes and each barrier's flush recomputes the whole store),
    net output equal to every auction's (id, expires); `< now()` over
    2^20 auctions: nothing passes. Then the executor over the 2^22
    auctions with a scripted rhs stepping through their expires range in
    `steps` barriers: each barrier's changelog equals the recount of the
    rows that crossed."""
    from risingwave_tpu_torch.common.epoch import EpochPair
    from risingwave_tpu_torch.stream.message import Barrier
    out = {}
    cap = ["SET streaming_dynamic_filter_capacity = 8388608"]

    def id_key(d, v):
        return d[0] - 1000

    for name, sel, n in (("gt", DYNF_GT, LJ_AUCTIONS),
                         ("lt", DYNF_LT, LJ_AUCTIONS // 4)):
        pace = {"auction": n // rounds}
        ddl = outer_ddl(sel, "dynf", extra=cap)
        r, prof = run_twice(lambda: session_run(
            dev, ddl, rounds + 1, 0, name="dynf", pace=pace,
            collect=2 * n))
        missing = [k for k in DYNF_KERNELS if r["launches"][k] == 0]
        nA = r["offsets"]["auction"]
        keys, cnt = sink_net(r["sink"], id_key)
        ok = (torch.equal(keys, torch.arange(nA, device=dev))
              and bool((cnt == 1).all())) if name == "gt" \
            else keys.numel() == 0
        if not ok or (missing and name == "gt"
                      and torch.device(dev).type == "cuda"):
            raise AssertionError(f"dynf {name}: {keys.numel()} rows for "
                                 f"{nA} auctions; unlaunched {missing}")
        out[name] = dict(run_figures(r, nA), **prof, auctions=nA,
                         net_rows=int(keys.numel()),
                         launches=r["launches"])
        if name == "gt":
            launches = r["launches"]
    # the executor with a scripted rhs
    n = LJ_AUCTIONS
    aid, expires = auction_cols_dev(n, dev, (0, 6))
    lo, hi = int(expires.min()), int(expires.max())
    rhs = [lo - 1] + [lo + (hi - lo) * k // steps
                      for k in range(1, steps + 1)]
    lsch = make_schema(("id", DataType.INT64), ("expires", DataType.INT64))
    rsch = make_schema(("now", DataType.TIMESTAMP))
    e0 = 1 << 16

    def barrier(k):
        return Barrier(EpochPair(e0 * (k + 2), e0 * (k + 1) if k else 0),
                       BarrierKind.INITIAL if k == 0
                       else BarrierKind.CHECKPOINT)

    def rchunk(rows):
        ops = torch.zeros(4, dtype=torch.int8)
        vals = torch.zeros(4, dtype=torch.int64)
        for i, (o, v_) in enumerate(rows):
            ops[i], vals[i] = o, v_
        return StreamChunk((Column(vals.to(dev)),), ops.to(dev),
                           (torch.arange(4) < len(rows)).to(dev), rsch)

    left, right = [barrier(0)], [barrier(0)]
    for off in range(0, n, OJ_CHUNK):
        left.append(StreamChunk(
            (Column(aid[off:off + OJ_CHUNK]),
             Column(expires[off:off + OJ_CHUNK])),
            torch.zeros(OJ_CHUNK, dtype=torch.int8, device=dev),
            torch.ones(OJ_CHUNK, dtype=torch.bool, device=dev), lsch))
    right.append(rchunk([(0, rhs[0])]))
    for k in range(1, steps + 2):
        left.append(barrier(k))
        right.append(barrier(k))
        if k <= steps:
            right.append(rchunk([(1, rhs[k - 1]), (0, rhs[k])]))
    ex = DynamicFilterExecutor(Scripted(lsch, left, (0,)),
                               Scripted(rsch, right), 1, "greater_than",
                               capacity=1 << 23, device=dev)

    async def go():
        logs, cur = [], []
        async for m in ex.execute():
            if isinstance(m, StreamChunk):
                cur.append(m)
            else:
                logs.append(cur)
                cur = []
        return logs

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    logs = asyncio.run(go())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    checked = 0
    for k in range(1, steps + 2):
        chunks = logs[k]
        if k == 1:
            want_ins, want_del = expires > rhs[0], None
        else:
            want_ins = None
            want_del = (expires > rhs[k - 2]) & (expires <= rhs[k - 1])
        ids_ins, ids_del = [], []
        for c in chunks:
            ids = c.columns[0].data[c.vis]
            ins = op_sign(c.ops)[c.vis] > 0
            ids_ins.append(ids[ins])
            ids_del.append(ids[~ins])
        gi = torch.sort(torch.cat(ids_ins)).values if ids_ins else None
        gd = torch.sort(torch.cat(ids_del)).values if ids_del else None
        wi = aid[want_ins] if want_ins is not None else aid[:0]
        wd = aid[want_del] if want_del is not None else aid[:0]
        ok = ((gi if gi is not None else aid[:0]).numel() == wi.numel()
              and (gd if gd is not None else aid[:0]).numel()
              == wd.numel()
              and (gi is None or torch.equal(gi, torch.sort(wi).values))
              and (gd is None or torch.equal(gd, torch.sort(wd).values)))
        if not ok:
            raise AssertionError(f"dynf executor: barrier {k} differs")
        checked += 1
    out["scripted"] = dict(barriers_checked=checked, rows=n,
                           wall_s=wall, barrier_wall_s=wall / (steps + 1),
                           k29_launches=kernels.KERNELS[
                               "dynamic_filter"].launches)
    out["launches"] = launches
    return out


# ---- the rest of the expression registry, HLL, bool aggregates

# RisingWave's Nexmark q3 (ci/scripts/sql/nexmark/q3.sql), as the JAX
# package's golden writes it (tests/test_nexmark_queries.py:test_q3_golden)
Q3_SELECT = ("SELECT P.name, P.city, P.state, A.id "
             "FROM auction AS A JOIN person AS P ON A.seller = P.id "
             "WHERE A.category = 10 AND "
             "(P.state = 'OR' OR P.state = 'ID' OR P.state = 'CA')")
# RisingWave's q14 without the count_char UDF (the JAX package has no
# UDFs); EXTRACT(HOUR FROM ...) is written extract_hour(...)
Q14_SELECT = (
    "SELECT auction, bidder, 0.908 * price AS price, "
    "CASE WHEN extract_hour(date_time) >= 8 AND "
    "extract_hour(date_time) <= 18 THEN 'dayTime' "
    "WHEN extract_hour(date_time) <= 6 OR extract_hour(date_time) >= 20 "
    "THEN 'nightTime' ELSE 'otherTime' END AS bidTimeType, "
    "date_time, extra FROM bid "
    "WHERE 0.908 * price > 1000000 AND 0.908 * price < 50000000")
# Nexmark q15 as the JAX package's SQL can write it: count(CASE ... THEN
# 1 END) for count(*) FILTER (WHERE ...), approx_count_distinct for
# count(DISTINCT ...); 4 counts and two sketches are 22 agg calls
Q15_SELECT = (
    "SELECT date_trunc_day(date_time) AS day, count(*) AS total_bids, "
    "count(CASE WHEN price < 10000 THEN 1 END) AS rank1_bids, "
    "count(CASE WHEN price >= 10000 AND price < 1000000 THEN 1 END) "
    "AS rank2_bids, "
    "count(CASE WHEN price >= 1000000 THEN 1 END) AS rank3_bids, "
    "approx_count_distinct(bidder) AS total_bidders, "
    "approx_count_distinct(auction) AS total_auctions "
    "FROM bid GROUP BY date_trunc_day(date_time)")
# RisingWave's q15 whole: besides, each distinct count also per price
# rank (count(DISTINCT x) FILTER (WHERE ...) as approx_count_distinct of
# a CASE); 4 counts and eight sketches are 76 agg calls
Q15_RANKS = ("price < 10000", "price >= 10000 AND price < 1000000",
             "price >= 1000000")
Q15_WIDE_SELECT = (
    Q15_SELECT.split(" FROM bid")[0].replace(
        "approx_count_distinct(bidder) AS total_bidders, ",
        "approx_count_distinct(bidder) AS total_bidders, " + "".join(
            f"approx_count_distinct(CASE WHEN {r} THEN bidder END) AS "
            f"rank{k + 1}_bidders, " for k, r in enumerate(Q15_RANKS)))
    + "".join(f", approx_count_distinct(CASE WHEN {r} THEN auction END) "
              f"AS rank{k + 1}_auctions" for k, r in enumerate(Q15_RANKS))
    + " FROM bid GROUP BY date_trunc_day(date_time)")
# the binders take scalar functions over aggregates only as arithmetic,
# so coalesce and greatest run in a projection over the agg's output
ACD_INNER = ("SELECT auction, count(*) AS n, "
             "approx_count_distinct(bidder) AS nb, "
             "bool_and(price > 1000000) AS ba, "
             "bool_or(price > 50000000) AS bo, max(price) AS mx, "
             "min(price) AS mn FROM bid")
ACD_SELECT = ("SELECT auction, n, nb, ba, bo, coalesce(mx, 0) AS mx, "
              f"greatest(mn, 1) AS mn FROM ({ACD_INNER} GROUP BY auction) X")
ACD_GLOBAL_SELECT = ("SELECT count(*) AS n, "
                     "approx_count_distinct(bidder) AS nb, "
                     "bool_and(price > 1000000) AS ba, "
                     "bool_or(price > 50000000) AS bo FROM bid")
# LIKE is written as its registry function (neither parser takes the
# operator)
STRINGS_SELECT = ("SELECT id, lower(name) AS ln, upper(state) AS us, "
                  "length(email_address) AS el, "
                  "substr(credit_card, 1, 4) AS cc, "
                  "like(name, 'person_1%') AS p1 FROM person "
                  "WHERE like(city, '%a%') AND state IN ('OR', 'ID', 'CA')")


BREADTH_CHUNK = 131072
Q3_KERNELS = ("nexmark_person", "nexmark_auction", "expr_eval",
              "sorted_join_probe", "sorted_join_merge", "radix_sort",
              "filter_ops")
Q14_KERNELS = ("nexmark_bid", "expr_eval", "filter_ops")
ACD_KERNELS = ("nexmark_bid", "expr_eval", "hash_table", "hash_agg",
               "hll_update", "agg_flush", "compact")
GACD_KERNELS = ("nexmark_bid", "expr_eval", "simple_agg", "hll_update")
STRINGS_KERNELS = ("nexmark_person", "expr_eval", "filter_ops")
DAY_US = 86_400_000_000


def ulp_dist(x, y) -> torch.Tensor:
    """Distance in ulps between paired float64 values (tensors or numpy
    arrays): 0 where they are equal, both NaN, or both below the
    smallest normal (subnormals and zeros alike); INT64_MAX where only
    one is finite or the signs differ."""
    x = torch.as_tensor(x, dtype=torch.float64)
    y = torch.as_tensor(y, dtype=torch.float64)
    tiny = torch.finfo(torch.float64).tiny
    same = ((x == y) | (torch.isnan(x) & torch.isnan(y))
            | ((x.abs() < tiny) & (y.abs() < tiny)))
    ix, iy = x.view(torch.int64), y.view(torch.int64)
    near = torch.isfinite(x) & torch.isfinite(y) & ((ix < 0) == (iy < 0))
    # same-signed float bits are ordered: adjacent floats differ by 1
    d = torch.where(near, (ix - iy).abs(), torch.iinfo(torch.int64).max)
    return torch.where(same, 0, d)


def ulp_err(x: torch.Tensor, y: torch.Tensor) -> int:
    """Largest `ulp_dist` between paired float64 tensors."""
    d = ulp_dist(x, y)
    return int(d.max()) if d.numel() else 0


def expr_hazard_columns(dev, n: int, seed: int = 0) -> list:
    """a int64 (INT64_MIN/MAX among them), c int32, g float64 hazards
    (NaN, +-inf, +-0, ties, out-of-range for casts), sc shift counts past
    the width, t timestamps over four centuries (29 February, before
    1970), s VARCHAR ids of the person names, p/q booleans, w0-w7 the
    packed HLL words of real sketches; each nullable column with NULLs."""
    g = torch.Generator().manual_seed(seed)

    def null():
        return (torch.rand(n, generator=g) < 0.85).to(dev)

    a = torch.randint(-10 ** 6, 10 ** 6, (n,), generator=g)
    a[:4] = torch.tensor([INT64_MIN, INT64_MAX, 0, -1])
    c = torch.randint(-2 ** 31, 2 ** 31, (n,), generator=g).to(torch.int32)
    f = torch.randn(n, generator=g, dtype=torch.float64) * 1e4
    f[:16] = torch.tensor([math.nan, math.inf, -math.inf, 0.0, -0.0, 0.5,
                           -0.5, 2.5, -2.5, 0.49999999999999994, 1e19,
                           -1e19, 3e9, -3e9, 1e300, 7.0],
                          dtype=torch.float64)
    sc = torch.randint(-3, 70, (n,), generator=g)
    t = torch.randint(-200 * 365 * DAY_US, 200 * 365 * DAY_US, (n,),
                      generator=g)
    t[:3] = torch.tensor([-1, 951_782_400_000_000, -DAY_US])
    names = torch.tensor(vocab_ids()["name"], dtype=torch.int32)
    s = names[torch.randint(0, names.shape[0], (n,), generator=g)]
    p = torch.rand(n, generator=g) < 0.5
    q = torch.rand(n, generator=g) < 0.5
    # the words of sketches over 0..~2^20 values, as the agg keeps them
    from risingwave_tpu_torch.expr.hll import hll_update_plain
    words = [torch.zeros(n, dtype=torch.int64, device=dev)
             for _ in range(8)]
    vals = torch.randint(0, 1 << 40, (8 * n,), generator=g).to(dev)
    slots = (torch.arange(8 * n, device=dev) % n).to(torch.int32)
    hll_update_plain(words, vals, None,
                     torch.zeros(8 * n, dtype=torch.int8, device=dev),
                     slots=slots)
    return ([Column(a.to(dev), null()), Column(c.to(dev), null()),
             Column(f.to(dev), null()), Column(sc.to(dev)),
             Column(t.to(dev), null()), Column(s.to(dev), null()),
             Column(p.to(dev), null()), Column(q.to(dev), null())]
            + [Column(w.to(dev)) for w in words])


def expr_breadth_exprs() -> list:
    """Every registry entry K5 gained in this slice, as a list of
    projections over `expr_hazard_columns`."""
    I64, I32, F64, TS, VC, B = (DataType.INT64, DataType.INT32,
                                DataType.FLOAT64, DataType.TIMESTAMP,
                                DataType.VARCHAR, DataType.BOOLEAN)
    a, c, f, sc, t, s, p, q = (col(0, I64), col(1, I32), col(2, F64),
                               col(3, I64), col(4, TS), col(5, VC),
                               col(6, B), col(7, B))
    w = [col(8 + k, I64) for k in range(8)]
    hour = call("extract_hour", t)
    return [
        call("neg", a), call("neg", c), call("abs", a), call("abs", f),
        call("greatest", a, c, f), call("least", f, lit(-0.0)),
        call("case", p, a, q, c, lit(None)),
        call("case", call("and", call("greater_than_or_equal", hour,
                                      lit(8)),
                          call("less_than_or_equal", hour, lit(18))),
             lit("dayTime"), call("or", call("less_than_or_equal", hour,
                                             lit(6)),
                                  call("greater_than_or_equal", hour,
                                       lit(20))),
             lit("nightTime"), lit("otherTime")),
        call("coalesce", a, c, lit(0)), call("coalesce", lit(None), f),
        call("case", call("greater_than", a, lit(0)),
             call("hll_estimate", *w)),
        call("floor", f), call("ceil", f), call("round", f),
        call("trunc", f), call("sign", f), call("sign", a),
        call("sqrt", f), call("cbrt", f), call("exp", f), call("ln", f),
        call("log10", f), call("sin", f), call("cos", f), call("tan", f),
        call("atan", f), call("pow", f, c),
        call("bitwise_and", a, c), call("bitwise_or", a, c),
        call("bitwise_xor", a, c), call("bitwise_not", c),
        call("bitwise_shift_left", a, sc), call("bitwise_shift_right", a, sc),
        call("extract_year", t), call("extract_month", t),
        call("extract_day", t), hour, call("extract_minute", t),
        call("extract_second", t), call("extract_dow", t),
        call("extract_epoch", t), call("date_trunc_second", t),
        call("date_trunc_minute", t), call("date_trunc_hour", t),
        call("date_trunc_day", t), call("date_trunc_week", t),
        call("lower", s), call("upper", s), call("trim", s),
        call("ltrim", s), call("rtrim", s), call("reverse", s),
        call("md5", s), call("length", s), call("ascii", s),
        call("like", s, lit("person_1%")), call("starts_with", s, lit("pe")),
        call("ends_with", s, lit("9")), call("contains", s, lit("_2")),
        call("substr", s, lit(1), lit(4)),
        FuncCall("cast", (f,), I64), FuncCall("cast", (f,), I32),
    ]


def queue_c_exprs() -> list:
    """Integer CASE conditions (a row holds where the low bit is set)
    and booleans in arithmetic (promoted as jnp promotes them; two add
    as a logical or, multiply as a logical and), over
    `expr_hazard_columns`."""
    I64, I32, F64, B = (DataType.INT64, DataType.INT32, DataType.FLOAT64,
                        DataType.BOOLEAN)
    a, c, f, p, q = (col(0, I64), col(1, I32), col(2, F64), col(6, B),
                     col(7, B))
    return [call("case", a, lit(1), lit(0)), call("case", c, a),
            call("case", a, f, p, c, lit(None)),
            call("add", call("greater_than", a, lit(10)), lit(1)),
            call("add", p, q), call("multiply", p, q), call("add", p, c),
            call("subtract", c, p), call("add", p, f),
            call("divide", p, a), call("divide", c, q),
            call("modulus", a, p), call("modulus", p, c)]


def expr_outputs_err(exprs, got, want) -> tuple[int, int]:
    """(largest integer or bit difference outside the transcendental
    functions, largest ulp distance of those)."""
    ulp_fns = {"cbrt", "exp", "ln", "log10", "sin", "cos", "tan", "atan",
               "pow"}
    exact, ulps = 0, 0
    for e, x, y in zip(exprs, got, want):
        if not torch.equal(x.valid_mask(), y.valid_mask()):
            exact = max(exact, 1)
        v = x.valid_mask()
        if getattr(e, "name", None) in ulp_fns:
            ulps = max(ulps, ulp_err(x.data[v], y.data[v]))
        else:
            exact = max(exact, exact_err([x.data[v]], [y.data[v]]))
    return exact, ulps


def phase_kernels_expr(dev, n: int = 131072) -> dict:
    """K5 against its plain version (the tree walk on the card) on every
    opcode this slice added, over a 131072-row list of hazard columns:
    integers, strings, booleans and validity exact, floats bit for bit
    except the transcendental functions (libdevice's against PyTorch's
    CUDA ones, within 2 ulp). The list is past one launch's limits, so it
    also shows the split; timings are of the whole list."""
    cols = expr_hazard_columns(dev, n)
    exprs = expr_breadth_exprs()
    prog = ExprProgram(exprs)
    k5 = kernels.KERNELS["expr_eval"]
    before = k5.launches
    got = prog.eval(cols)
    torch.cuda.synchronize()
    launches = k5.launches - before
    want = prog.eval_plain(cols)
    exact, ulps = expr_outputs_err(exprs, got, want)
    if exact or ulps > 2:
        raise AssertionError(f"K5 breadth: exact err {exact}, {ulps} ulp")
    # q14's projection alone: one launch
    q14 = ExprProgram(exprs[7:8])
    one = exact_err([q14.eval(cols)[0].data], [want[7].data])
    if one:
        raise AssertionError("K5 q14 CASE differs")
    # Queue C: integer CASE conditions and booleans in arithmetic
    qc = queue_c_exprs()
    qprog = ExprProgram(qc)
    before = k5.launches
    qgot = qprog.eval(cols)
    torch.cuda.synchronize()
    qc_launches = k5.launches - before
    qerr, _ = expr_outputs_err(qc, qgot, qprog.eval_plain(cols))
    if qerr or not qc_launches:
        raise AssertionError(f"K5 Queue C differs: {qerr}")
    # K5's mask mode (a join condition): a bare boolean column, and
    # integer and float conditions, which hold where non-zero
    start = torch.rand(n, generator=torch.Generator().manual_seed(5)) < 0.7
    start = start.to(dev)
    for cond in (col(6, DataType.BOOLEAN), col(0, DataType.INT64),
                 col(2, DataType.FLOAT64)):
        mp = ExprProgram([cond])
        a, b = start.clone(), start.clone()
        mp.and_into(cols, a)
        mp.and_into_plain(cols, b)
        qerr = max(qerr, exact_err([a], [b]))
    if qerr:
        raise AssertionError(f"K5 mask mode differs: {qerr}")
    t = timings(lambda: prog.eval(cols), lambda: prog.eval_plain(cols))
    read = sum(c.data.numel() * c.data.element_size()
               + (c.valid.numel() if c.valid is not None else 0)
               for c in cols)
    written = sum(o.data.numel() * o.data.element_size()
                  + (o.valid.numel() if o.valid is not None else 0)
                  for o in got)
    out = dict(rows=n, expressions=len(exprs), launches_per_eval=launches,
               queue_c_expressions=len(qc), queue_c_launches=qc_launches,
               queue_c_err=qerr,
               max_abs_err=exact, max_ulp_err=ulps, bytes=read + written,
               bound_ms=bytes_bound_ms(read + written), bound_by="bytes",
               **t)
    emit({"phase": "kernel", "name": "expr_eval_breadth", **out})
    return out


def hll_case(dev, N: int, C: int, dtype, seed: int):
    """A chunk for K30: values of `dtype` with NULLs, ops with deletes,
    slots in [0, C) (C == 1: every row in slot 0, q15's day) with -1 for
    invisible rows; lanes holding a previous chunk's registers."""
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.float64:
        v = torch.randn(N, generator=g, dtype=torch.float64) * 1e6
        v[:4] = torch.tensor([math.nan, -0.0, 0.0, math.inf])
    else:
        v = torch.randint(0, 1 << 21, (N,), generator=g)
    valid = torch.rand(N, generator=g) < 0.9
    ops = torch.where(torch.rand(N, generator=g) < 0.95, 0, 1).to(torch.int8)
    slots = (torch.randint(0, C, (N,), generator=g) if C > 1
             else torch.zeros(N, dtype=torch.int64))
    slots = torch.where(torch.rand(N, generator=g) < 0.97, slots, -1)
    lanes = [torch.zeros(C, dtype=torch.int64, device=dev)
             for _ in range(8)]
    from risingwave_tpu_torch.expr.hll import hll_update_plain
    pv = torch.randint(0, 1 << 21, (N,), generator=g)
    slots = slots.to(torch.int32).to(dev)
    hll_update_plain(lanes, pv.to(dev), None,
                     torch.zeros(N, dtype=torch.int8, device=dev),
                     slots=slots)
    return v.to(dev), valid.to(dev), ops.to(dev), slots, lanes


HLL_TILES = (256, 512, 1024, 4096)   # K30 tiles timed beside the default


def phase_kernels_hll(dev, N: int = 131072) -> dict:
    """K30 against hll_update_plain on a 131072-row chunk into 1 slot
    (q15's day) and into a 2^20-slot table (per auction), over int64 and
    float64 values with NULLs, deletes and invisible rows: the 8 lanes
    exactly equal. Timed with the lanes restored before each call, at
    the wrapper's tile (H.ROWS_PER_BLOCK rows a block) and at each tile
    of HLL_TILES; the library call is torch's scatter_reduce(amax) over
    the unpacked registers with each row's register and rank given. The
    bound counts what this data needs: every row's slot, the op of the
    visible rows, the valid byte of the visible inserts, the value of
    the live rows, and each touched word read and written."""
    from risingwave_tpu_torch.expr import hll as H
    out = {}
    err = 0
    for C in (1, 1 << 20):
        for dt in (torch.int64, torch.float64):
            v, valid, ops, slots, lanes = hll_case(dev, N, C, dt, seed=C)
            a = [x.clone() for x in lanes]
            b = [x.clone() for x in lanes]
            H.hll_update(a, v, valid, ops, slots=slots)
            H.hll_update_plain(b, v, valid, ops, slots=slots)
            torch.cuda.synchronize()
            err = max(err, exact_err(a, b))
            # the simple agg's form: every visible row in one group
            one = [x[:1].clone() for x in lanes]
            two = [x[:1].clone() for x in lanes]
            vis = slots >= 0
            H.hll_update([x.view(()) for x in one], v, valid, ops, vis=vis)
            H.hll_update_plain([x.view(()) for x in two], v, valid, ops,
                               vis=vis)
            err = max(err, exact_err(one, two))
            if err:
                raise AssertionError(f"K30 differs (C={C}, {dt}): {err}")
            work = [x.clone() for x in lanes]

            def restore():
                for w_, l_ in zip(work, lanes):
                    w_.copy_(l_)

            live = (slots >= 0) & valid & ((ops == 0) | (ops == 3))
            bucket, rank = H.bucket_rank(v)
            regs = H.registers(lanes).reshape(-1).clone()
            idx = (slots.clamp(min=0).to(torch.int64) * 64 + bucket)[live]
            rk = rank[live]
            t = timings(
                lambda: H.hll_update(work, v, valid, ops, slots=slots),
                lambda: H.hll_update_plain(work, v, valid, ops,
                                           slots=slots),
                setup=restore,
                library_fn=lambda: regs.scatter_reduce_(0, idx, rk, "amax"))
            default = H.ROWS_PER_BLOCK
            tile_ms = {}
            for tile in HLL_TILES:
                H.ROWS_PER_BLOCK = tile
                try:
                    tile_ms[tile] = time_ms(
                        lambda: H.hll_update(work, v, valid, ops,
                                             slots=slots), restore)[0]
                finally:
                    H.ROWS_PER_BLOCK = default
            touched = torch.unique(
                slots[live].to(torch.int64) * 8 + (bucket[live] >> 3))
            vis = slots >= 0
            ins = vis & ((ops == 0) | (ops == 3))
            n_bytes = (4 * N + int(vis.sum()) + int(ins.sum())
                       + int(live.sum()) * v.element_size()
                       + int(touched.numel()) * 16)
            out[f"C{C}_{str(dt).split('.')[1]}"] = dict(
                rows=N, slots=C, live_rows=int(live.sum()),
                touched_words=int(touched.numel()), bytes=n_bytes,
                bound_ms=bytes_bound_ms(n_bytes), tile=default,
                tile_ms=tile_ms, **t)
    main = out["C1_int64"]
    res = dict(max_abs_err=err, ms=main["ms"], plain_ms=main["plain_ms"],
               library_ms=main["library_ms"], bound_ms=main["bound_ms"],
               bound_by="bytes", cases=out)
    emit({"phase": "kernel", "name": "hll_update", **res})
    return {"hll_update": res}


def q15_calls(n_sketches: int = 2) -> list:
    """The q15 agg's calls: four counts, then per sketch a count and its
    8 HLL register words (22 calls with two sketches, as q15_full writes
    it; 76 with RisingWave's eight distinct counts)."""
    calls = [count_star(True)] + [AggCall(AggKind.COUNT, 1 + k,
                                          DataType.INT64, True)
                                  for k in range(3)]
    for arg in range(4, 4 + n_sketches):
        calls.append(AggCall(AggKind.COUNT, arg, DataType.INT64, True))
        calls += [AggCall(AggKind.HLL_REG, arg, DataType.INT64, True,
                          lane=L) for L in range(8)]
    return calls


def wide_linear(dev, n_calls: int, N: int, seed: int):
    """n_calls linear agg calls, each over its own input column (call j
    reads column j): COUNT, SUM, MIN and MAX in turn, over int64 columns
    and float64 ones by turns of four, every third column with NULLs;
    so a kernel that reads one call's input or state for another's
    disagrees with its plain version. Call 0 counts a boolean column
    with NULLs, as bool_and's COUNT does."""
    g = torch.Generator().manual_seed(seed)
    kinds = (AggKind.COUNT, AggKind.SUM, AggKind.MIN, AggKind.MAX)
    specs, cols = [], []
    for j in range(n_calls):
        fl = (j // 4) % 2 == 1
        v = torch.randint(-1000, 1000, (N,), generator=g)
        v = v.to(torch.float64) * 0.25 if fl else v
        v = v > 0 if j == 0 else v
        valid = (torch.rand(N, generator=g) < 0.9).to(dev) if j % 3 == 0 \
            else None
        kind = kinds[j % 4]
        ret = DataType.INT64 if kind is AggKind.COUNT or not fl \
            else DataType.FLOAT64
        specs.append(AggCall(kind, j, ret, True).spec())
        cols.append(Column(v.to(dev), valid))
    return specs, cols


def phase_kernels_wide(dev, C: int = 1 << 20, N: int = 131072,
                       n_live: int = 400_000, n_dirty: int = 100_000) -> dict:
    """The kernels whose call lists this slice made unbounded, against
    their plain versions, exactly, at 22 calls (q15_full's agg) and at
    76 (RisingWave's q15 with its eight distinct counts, past one
    launch's limit, so split across launches): K27's flush and K18's
    persist view of a 2^20-slot state (n_dirty dirty of n_live live), K4
    on a 131072-row chunk and K25 on the same rows, each call over its
    own column."""
    out = {}
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    for n_sk, tag in ((2, ""), (8, "_76")):
        specs = [c.spec() for c in q15_calls(n_sk)]
        st = agg_state_shape(dev, C, (torch.int64,), specs, 0, n_live,
                             n_dirty, seed=5)
        a, b = _agg_clone(st), _agg_clone(st)
        err = agg_flush_err(agg_flush(a, specs), agg_flush_plain(b, specs),
                            a, b)
        w = _agg_clone(st)
        t = timings(lambda: agg_flush(w, specs),
                    lambda: agg_flush_plain(w, specs),
                    setup=lambda: _flush_restore(w, st))
        out["agg_flush" + tag] = dict(
            calls=len(specs), max_abs_err=err, bound_by="bytes",
            bound_ms=bytes_bound_ms(flush_bytes(st, n_dirty)), **t)
        (ba, ca), (bb, cb) = persist_pack(st, None, None), \
            persist_pack_plain(st, None, None)
        nd = int(ca[0])
        wp = 2 + 1 + len(specs) + 1
        err18 = exact_err([ca, ba[:nd * wp]], [cb, bb[:nd * wp]])
        t18 = timings(lambda: persist_pack(st, None, None),
                      lambda: persist_pack_plain(st, None, None))
        out["persist_view" + tag] = dict(
            calls=len(specs), columns=wp, dirty=nd, max_abs_err=err18,
            bound_by="bytes", bound_ms=bytes_bound_ms(C + nd * wp * 8 * 2),
            **t18)
        table = st.table
        del st, a, b, w
        n = len(specs)
        lin, cols = wide_linear(dev, n, N, seed=9 + n)
        g = torch.Generator().manual_seed(n)
        slots = torch.randint(0, C, (N,), generator=g).to(torch.int32).to(dev)
        ops = torch.where(torch.rand(N, generator=g) < 0.9, 0, 1).to(
            torch.int8).to(dev)
        inputs = [(c.data, c.valid) for c in cols]

        def state4():
            return AggState(table, tuple(sp.init_state(C, dev)
                                         for sp in lin),
                            torch.zeros(C, dtype=torch.int64, device=dev),
                            torch.zeros(C, dtype=torch.bool, device=dev),
                            None, None)

        s4a, s4b = state4(), state4()
        agg_apply(s4a, lin, slots, ops, inputs, zero, zero.clone())
        agg_apply_plain(s4b, lin, slots, ops, inputs, zero, zero.clone())
        err4 = exact_err([*s4a.agg_states, s4a.row_count, s4a.dirty],
                         [*s4b.agg_states, s4b.row_count, s4b.dirty])
        s4 = state4()
        one = torch.zeros(C, dtype=torch.int64, device=dev)
        v0 = cols[1].data
        t4 = timings(lambda: agg_apply(s4, lin, slots, ops, inputs, zero,
                                       zero.clone()),
                     lambda: agg_apply_plain(s4, lin, slots, ops, inputs,
                                             zero, zero.clone()),
                     library_fn=lambda: one.index_add_(0, slots.long(), v0))
        touched = int(torch.unique(slots).numel())
        # a COUNT reads only its valid bytes, the others value and valid
        in_bytes = sum((c.valid is not None)
                       + (lin[k].call.kind is not AggKind.COUNT)
                       * c.data.element_size() for k, c in enumerate(cols))
        out["hash_agg" + tag] = dict(
            calls=n, max_abs_err=err4, bound_by="bytes",
            bound_ms=bytes_bound_ms(N * (5 + in_bytes)
                                    + touched * (n * 16 + 17)), **t4)
        chunk = StreamChunk(tuple(cols), ops,
                            torch.ones(N, dtype=torch.bool, device=dev),
                            make_schema(*((f"c{j}", sp.call.ret_type
                                           if sp.call.kind is not
                                           AggKind.COUNT else DataType.INT64)
                                          for j, sp in enumerate(lin))))

        def sa_states():
            return tuple(torch.full((), sp.init, dtype=sp.state_dtype,
                                    device=dev) for sp in lin)

        rc0 = torch.zeros((), dtype=torch.int64, device=dev)
        ka, rca = simple_agg_apply(lin, sa_states(), rc0.clone(), chunk)
        kb, rcb = simple_agg_apply_plain(lin, sa_states(), rc0.clone(),
                                         chunk)
        err25 = exact_err([*ka, rca], [*kb, rcb])
        ss = sa_states()
        t25 = timings(lambda: simple_agg_apply(lin, ss, rc0, chunk),
                      lambda: simple_agg_apply_plain(lin, ss, rc0, chunk),
                      library_fn=lambda: v0.sum())
        out["simple_agg" + tag] = dict(
            calls=n, max_abs_err=err25, bound_by="bytes",
            bound_ms=bytes_bound_ms(N * (2 + in_bytes)), **t25)
    bad = {k: v["max_abs_err"] for k, v in out.items() if v["max_abs_err"]}
    if bad:
        raise AssertionError(f"wide-call kernels differ: {bad}")
    emit({"phase": "kernels_wide", **out})
    return out


def mv_committed(s, name: str) -> list:
    """An MV's rows as committed at the last barrier."""
    return list(s.catalog.mvs[name].table.iter_committed())


def _person_cols(n: int, dev, idx) -> list:
    vocabs = {k: torch.tensor(v, dtype=torch.int32, device=dev)
              for k, v in vocab_ids().items()}
    parts = []
    for off in range(0, n, 1 << 20):
        cols = gen_person_columns_plain(off, min(1 << 20, n - off),
                                        NexmarkConfig(), vocabs, dev)
        parts.append([cols[i].cpu().numpy() for i in idx])
    return [np.concatenate(x) for x in zip(*parts)]


def breadth_ddl(select: str, name: str, *, sink: bool = False,
                durable_: int = 0, agg_cap: int = 1 << 16,
                person_chunk: int = Q8_PERSON_CHUNK,
                auction_chunk: int = Q8_AUCTION_CHUNK,
                bid_chunk: int = BREADTH_CHUNK) -> list:
    return outer_ddl(select, name, auction_chunk=auction_chunk,
                     person_chunk=person_chunk, bid_chunk=bid_chunk,
                     join_cap=1 << 22, durable_=durable_, sink=sink,
                     extra=(f"SET streaming_agg_capacity = {agg_cap}",))


def need_launches(r: dict, names, what: str) -> None:
    """Every kernel of `names` launched in run `r` (on the card)."""
    missing = [k for k in names if r["launches"][k] == 0]
    if missing and r["mem_peak_bytes"] is not None:
        raise AssertionError(f"kernels never launched on {what}: {missing}")


def phase_q3_full(dev, rounds: int = 3) -> dict:
    """RisingWave's Nexmark q3 (Q3_SELECT) through Session(device="cuda")
    as an MV at q8's person and auction chunks (98304 persons and 294912
    auctions a barrier, equal event-time spans): after every barrier the
    MV equals the numpy recount (category-10 auctions joined to sellers
    in OR, ID or CA). Rates and p50 come from a second, unchecked run of
    the same geometry, the idle share from a third (`run_twice`)."""
    pace = {"person": Q8_PERSON_CHUNK, "auction": Q8_AUCTION_CHUNK}
    ddl = breadth_ddl(Q3_SELECT, "q3")
    states = {GLOBAL_DICT.get_or_insert(x) for x in ("OR", "ID", "CA")}
    checked = []

    def check(k, mv, rows):
        pid, nm, ct, st = _person_cols(rows["person"], dev, (0, 1, 4, 5))
        aid, seller, cat = _auction_prefix(rows["auction"], NexmarkConfig(),
                                           dev, (0, 7, 8))
        aid, seller = aid[cat == 10], seller[cat == 10]
        order = np.argsort(pid)
        at = np.minimum(np.searchsorted(pid[order], seller), len(pid) - 1)
        hit = pid[order][at] == seller
        p = order[at[hit]]
        keep = np.isin(st[p], list(states))
        p = p[keep]
        want = Counter(zip(nm[p].tolist(), ct[p].tolist(), st[p].tolist(),
                           aid[hit][keep].tolist()))
        got = Counter(tuple(r[:4]) for r in mv)
        if got != want or not want:
            raise AssertionError(f"q3: barrier {k}: {sum(got.values())} "
                                 f"rows, recount {sum(want.values())}")
        checked.append((k, sum(want.values())))

    c = session_run(dev, ddl, rounds, 0, name="q3", pace=pace,
                    on_barrier=lambda k, s, rows: check(
                        k, mv_committed(s, "q3"), rows))
    check(rounds, c["mv"], c["offsets"])
    r, prof = run_twice(lambda: session_run(dev, ddl, rounds, 0, name="q3",
                                            pace=pace))
    need_launches(r, Q3_KERNELS, "q3")
    return dict(run_figures(r, sum(r["offsets"].values())), **prof,
                barriers_checked=len(checked), rows=checked[-1][1],
                join_errs=c["join"].errs(), launches=r["launches"])


def q14_recount(n: int, dev) -> Counter:
    auction, bidder, price, dt, extra = _bid_prefix(
        n, NexmarkConfig(), dev, [0, 1, 2, 5, 6])
    p = 0.908 * price.astype(np.float64)
    keep = (p > 1000000) & (p < 50000000)
    hour = np.floor_divide(np.remainder(dt, DAY_US), 3_600_000_000)
    ids = [GLOBAL_DICT.get_or_insert(x)
           for x in ("dayTime", "nightTime", "otherTime")]
    kind = np.where((hour >= 8) & (hour <= 18), ids[0],
                    np.where((hour <= 6) | (hour >= 20), ids[1], ids[2]))
    return Counter(zip(auction[keep].tolist(), bidder[keep].tolist(),
                       p[keep].tolist(), kind[keep].tolist(),
                       dt[keep].tolist(), extra[keep].tolist()))


def phase_q14_full(dev, per_chunks: int = 8, rounds: int = 6) -> dict:
    """RisingWave's q14 (Q14_SELECT) into the device blackhole sink at
    131072-bid chunks, `per_chunks` a barrier, twice (rates and p50 from
    the first, the idle share from a profiled second); then as an MV, two
    chunks a barrier, equal to the numpy recount after every barrier."""
    per = per_chunks * BREADTH_CHUNK
    ddl = breadth_ddl(Q14_SELECT, "q14", sink=True)
    r, prof = run_twice(lambda: session_run(dev, ddl, rounds, per,
                                            name="q14"))
    need_launches(r, Q14_KERNELS, "q14")
    checked = []

    def check(k, mv, n):
        got = Counter(tuple(x[:6]) for x in mv)
        want = q14_recount(n, dev)
        if got != want or not want:
            raise AssertionError(f"q14: barrier {k}: {sum(got.values())} "
                                 f"rows, recount {sum(want.values())}")
        checked.append(k)

    c = session_run(dev, breadth_ddl(Q14_SELECT, "q14m"), 3,
                    2 * BREADTH_CHUNK, name="q14m",
                    on_barrier=lambda k, s, rows: check(
                        k, mv_committed(s, "q14m"), rows["bid"]))
    check(3, c["mv"], c["bids"])
    return dict(run_figures(r, r["bids"]), **prof,
                mv_barriers_checked=len(checked), launches=r["launches"])


def _hll_groups(vals, seg, n_groups, keep=None):
    """Per group the estimate over vals where keep (all rows when None),
    None for a group with no such row."""
    from risingwave_tpu_torch.expr.hll import hll_estimate_numpy
    keep = np.ones(len(vals), bool) if keep is None else keep
    est, ok = hll_estimate_numpy(vals, keep, seg, n_groups)
    return [int(e) if o else None for e, o in zip(est, ok)]


def q15_recount(n: int, dev, wide: bool = False) -> dict:
    auction, bidder, price, dt = _bid_prefix(n, NexmarkConfig(), dev,
                                             [0, 1, 2, 5])
    day = np.floor_divide(dt, DAY_US) * DAY_US
    days, seg = np.unique(day, return_inverse=True)
    G = len(days)
    cnt = np.bincount(seg, minlength=G)
    r1 = np.bincount(seg, weights=price < 10000, minlength=G)
    r2 = np.bincount(seg, weights=(price >= 10000) & (price < 1000000),
                     minlength=G)
    r3 = np.bincount(seg, weights=price >= 1000000, minlength=G)
    ranks = (price < 10000, (price >= 10000) & (price < 1000000),
             price >= 1000000)
    est = []
    for v in (bidder, auction):
        est.append(_hll_groups(v, seg, G))
        if wide:        # Q15_WIDE_SELECT's per-rank distinct counts
            est += [_hll_groups(v, seg, G, keep=r) for r in ranks]
    return {int(days[g]): (int(cnt[g]), int(r1[g]), int(r2[g]), int(r3[g]),
                           *(e[g] for e in est)) for g in range(G)}


def phase_q15_full(dev, per_chunks: int = 4, rounds: int = 6) -> dict:
    """Nexmark q15 as the JAX package's SQL writes it (Q15_SELECT: GROUP
    BY date_trunc_day, four counts, two approx_count_distinct: 22 agg
    calls; the 131072-row chunks land on one day's registers) as an MV:
    after every barrier the counts equal the recount exactly and the
    estimates equal hll_estimate_numpy's bit for bit. Rates from an
    unchecked run of the same geometry (`run_twice`). Then RisingWave's
    whole q15 (Q15_WIDE_SELECT, 76 agg calls) for 3 barriers, checked
    the same way."""
    per = per_chunks * BREADTH_CHUNK
    checked = []

    def check(k, mv, n):
        got = {r[0]: tuple(r[1:7]) for r in mv}
        want = q15_recount(n, dev)
        if got != want:
            raise AssertionError(f"q15: barrier {k}: {got} != {want}")
        checked.append(k)

    ddl = breadth_ddl(Q15_SELECT, "q15")
    c = session_run(dev, ddl, rounds, per, name="q15",
                    on_barrier=lambda k, s, rows: check(
                        k, mv_committed(s, "q15"), rows["bid"]))
    check(rounds, c["mv"], c["bids"])
    r, prof = run_twice(lambda: session_run(dev, ddl, rounds, per,
                                            name="q15"))
    need_launches(r, ACD_KERNELS, "q15")
    # RisingWave's whole q15: 76 calls, split across K4/K27 launches
    wide_checked = []

    def check_wide(k, mv, n):
        got = {r_[0]: tuple(r_[1:13]) for r_ in mv}
        want = q15_recount(n, dev, wide=True)
        if got != want:
            raise AssertionError(f"q15_wide: barrier {k}: {got} != {want}")
        wide_checked.append(k)

    wide_rounds = 3
    w = session_run(dev, breadth_ddl(Q15_WIDE_SELECT, "q15w"), wide_rounds,
                    per, name="q15w",
                    on_barrier=lambda k, s, rows: check_wide(
                        k, mv_committed(s, "q15w"), rows["bid"]))
    check_wide(wide_rounds, w["mv"], w["bids"])
    need_launches(w, ACD_KERNELS, "q15_wide")
    return dict(run_figures(r, r["bids"]), **prof,
                barriers_checked=len(checked),
                agg_calls=len(r["agg"].agg_calls), launches=r["launches"],
                wide=dict(agg_calls=len(w["agg"].agg_calls),
                          barriers_checked=len(wide_checked),
                          launches=w["launches"]))


def acd_recount(n: int, dev) -> Counter:
    auction, bidder, price = _bid_prefix(n, NexmarkConfig(), dev, [0, 1, 2])
    keys, seg = np.unique(auction, return_inverse=True)
    G = len(keys)
    cnt = np.bincount(seg, minlength=G)
    big = np.bincount(seg, weights=price > 1000000, minlength=G)
    huge = np.bincount(seg, weights=price > 50000000, minlength=G)
    mx = np.full(G, np.iinfo(np.int64).min)
    np.maximum.at(mx, seg, price)
    mn = np.full(G, np.iinfo(np.int64).max)
    np.minimum.at(mn, seg, price)
    est = _hll_groups(bidder, seg, G)
    return Counter((int(keys[g]), int(cnt[g]), int(est[g]),
                    bool(big[g] == cnt[g]), bool(huge[g] > 0), int(mx[g]),
                    int(max(mn[g], 1))) for g in range(G))


def phase_acd_full(dev, per_chunks: int = 2, rounds: int = 12,
                   check_at=(6,)) -> dict:
    """ACD_SELECT (approx_count_distinct, bool_and, bool_or, max, min per
    auction; coalesce and greatest above) as an MV on a 2^20-slot agg
    like q5's, 12 barriers of two 131072-bid chunks, equal to the numpy
    recount at barriers `check_at` and after the last (rates from an
    unchecked run of the same geometry, `run_twice`); then
    ACD_GLOBAL_SELECT through the simple agg, equal after every
    barrier."""
    per = per_chunks * BREADTH_CHUNK
    checked = []

    def check(k, mv, n):
        got = Counter(tuple(x[:7]) for x in mv)
        want = acd_recount(n, dev)
        if got != want:
            raise AssertionError(f"acd: barrier {k}: {len(got)} groups, "
                                 f"recount {len(want)}")
        checked.append(k)

    ddl = breadth_ddl(ACD_SELECT, "acd", agg_cap=1 << 20)
    c = session_run(dev, ddl, rounds, per, name="acd",
                    on_barrier=lambda k, s, rows: check(
                        k, mv_committed(s, "acd"), rows["bid"])
                    if k in check_at else None)
    check(rounds, c["mv"], c["bids"])
    r, prof = run_twice(lambda: session_run(dev, ddl, rounds, per,
                                            name="acd"))
    need_launches(r, ACD_KERNELS, "acd")
    gchecked = []

    def check_global(k, mv, n):
        (got,) = [tuple(x[:4]) for x in mv]
        _, bidder, price = _bid_prefix(n, NexmarkConfig(), dev, [0, 1, 2])
        est = _hll_groups(bidder, np.zeros(len(bidder), np.int64), 1)
        want = (len(price), int(est[0]), bool((price > 1000000).all()),
                bool((price > 50000000).any()))
        if got != want:
            raise AssertionError(f"global acd: barrier {k}: {got} != {want}")
        gchecked.append(k)

    g = session_run(dev, breadth_ddl(ACD_GLOBAL_SELECT, "gacd"), 6, per,
                    name="gacd", on_barrier=lambda k, s, rows: check_global(
                        k, mv_committed(s, "gacd"), rows["bid"]))
    check_global(6, g["mv"], g["bids"])
    need_launches(g, GACD_KERNELS, "the global acd")
    return dict(run_figures(r, r["bids"]), **prof, barriers_checked=checked,
                groups=len(r["mv"]), agg_calls=len(r["agg"].agg_calls),
                global_barriers_checked=len(gchecked),
                global_bids_per_s=g["bids"] / g["wall_s"],
                global_launches=g["launches"], launches=r["launches"])


def strings_recount(n: int, dev) -> Counter:
    pid, nm, em, cc, ct, st = _person_cols(n, dev, (0, 1, 2, 3, 4, 5))
    d = GLOBAL_DICT
    out = Counter()
    for i in range(n):
        city, state = d.decode(int(ct[i])), d.decode(int(st[i]))
        if "a" not in city or state not in ("OR", "ID", "CA"):
            continue
        name = d.decode(int(nm[i]))
        out[(int(pid[i]), name.lower(), state.upper(),
             len(d.decode(int(em[i]))), d.decode(int(cc[i]))[:4],
             name.startswith("person_1"))] += 1
    return out


def phase_strings_full(dev, rounds: int = 3) -> dict:
    """STRINGS_SELECT (lower, upper, length, substr, LIKE, IN) over
    131072-person chunks as an MV: after every barrier the decoded rows
    equal the recount over the decoded strings. Rates from an unchecked
    run of the same geometry (`run_twice`)."""
    checked = []

    def check(k, mv, n):
        d = GLOBAL_DICT
        got = Counter((r[0], d.decode(r[1]), d.decode(r[2]), r[3],
                       d.decode(r[4]), r[5]) for r in mv)
        want = strings_recount(n, dev)
        if got != want or not want:
            raise AssertionError(f"strings: barrier {k}: "
                                 f"{sum(got.values())} rows, recount "
                                 f"{sum(want.values())}")
        checked.append(k)

    ddl = breadth_ddl(STRINGS_SELECT, "strs", person_chunk=BREADTH_CHUNK)
    pace = {"person": BREADTH_CHUNK}
    c = session_run(dev, ddl, rounds, 0, name="strs", pace=pace,
                    on_barrier=lambda k, s, rows: check(
                        k, mv_committed(s, "strs"), rows["person"]))
    check(rounds, c["mv"], c["offsets"]["person"])
    r, prof = run_twice(lambda: session_run(dev, ddl, rounds, 0,
                                            name="strs", pace=pace))
    need_launches(r, STRINGS_KERNELS, "strings")
    return dict(run_figures(r, r["offsets"]["person"]), **prof,
                barriers_checked=len(checked), launches=r["launches"])


def phase_acd_recover(dev, r1: int = 4, r2: int = 4,
                      chunk: int = BREADTH_CHUNK) -> dict:
    """ACD_SELECT durable on a Hummock store over a local-fs object
    store, one 131072-bid chunk a barrier: r1 barriers, crash(), reopen,
    recover(), on to r1 + r2: the MV equals an uninterrupted durable
    run's and the recount."""
    ddl = breadth_ddl(ACD_SELECT, "acdr", durable_=1, agg_cap=1 << 20)
    with tempfile.TemporaryDirectory(prefix="acdr_") as d:
        a = session_run(dev, ddl, r1, chunk, name="acdr", crash=True,
                        store=HummockStateStore(LocalFsObjectStore(d)))
        b = session_run(dev, ddl, 0, chunk, name="acdr",
                        recover_to=r1 + r2, store=lambda: HummockStateStore
                        .open(LocalFsObjectStore(d)))
    with tempfile.TemporaryDirectory(prefix="acdu_") as d:
        u = session_run(dev, ddl, r1 + r2, chunk, name="acdr",
                        store=HummockStateStore(LocalFsObjectStore(d)))
    if b["bids"] != (r1 + r2) * chunk:
        raise AssertionError(f"acd_recover: {b['bids']} bids")
    got = Counter(tuple(x[:7]) for x in b["mv"])
    if got != Counter(tuple(x[:7]) for x in u["mv"]) \
            or got != acd_recount(b["bids"], dev):
        raise AssertionError("acd_recover: recovered MV differs")
    return dict(barriers_before_crash=r1,
                barriers_after_recovery=b["barriers"],
                recovered_base=b["base"], recovery_ms=b["recovery_s"] * 1e3,
                mv_rows=len(b["mv"]),
                persist_rows_before_crash=a["persist_rows"],
                launches=b["launches"])


# ---- Queue C's views: integer conditions and boolean arithmetic

# name -> SELECT over bid: an integer CASE condition (with and without
# ELSE), an integer WHERE predicate (both hold where the low bit is set,
# as the reference ANDs them bitwise) and boolean arithmetic
QUEUE_C_SELECTS = {
    "case_int": "SELECT auction, CASE WHEN auction THEN 1 ELSE 0 END AS p "
                "FROM bid",
    "case_int_no_else": "SELECT auction, CASE WHEN price THEN auction END "
                        "AS p FROM bid",
    "where_int": "SELECT auction, price FROM bid WHERE auction",
    "bool_arith": "SELECT auction, (price > 10) + 1 AS p FROM bid",
}


# ---- MV-on-MV: a retracting per-auction aggregate and two consumers

MVMV_AGG_SELECT = ("SELECT auction, count(*) AS cnt, max(price) AS mp, "
                   "sum(price) AS sp FROM bid GROUP BY auction")
MVMV_HOT_SELECT = "SELECT auction, cnt, mp FROM mv_agg WHERE cnt >= 3"
MVMV_HIST_SELECT = "SELECT cnt, count(*) AS n FROM mv_agg GROUP BY cnt"
MVMV_SINK = ("CREATE SINK mv_sink AS SELECT auction, cnt FROM mv_agg "
             "WITH (connector='blackhole_device')")


def mvmv_recount(agg_rows) -> tuple[Counter, Counter]:
    """(mv_hot's rows, mv_hist's rows) recounted from mv_agg's rows."""
    hot = Counter((a, c, m) for a, c, m, *_ in agg_rows if c >= 3)
    hist = Counter(c for _, c, *_ in agg_rows)
    return hot, Counter(hist.items())


# ---- kernels_backfill: K31's two entries

K31_INTS = {"i64": np.int64, "i32": np.int32, "i16": np.int16,
            "i8": np.int8}
K31_KEY_SETS = [("i64",), ("i32",), ("f64",), ("bool",), ("i16",), ("i8",),
                ("i64", "i32"), ("f64", "bool"), ("i32", "f64", "i16"),
                ("i64", "i8", "f64")]


def k31_columns(dev, n: int, types, seed: int) -> list:
    """Key columns of `types` on the card: negatives of every integer
    width (the vnode zero-extends them), the int64 limits, floats with
    -0.0, +0.0, NaNs of two payloads, infinities and ties, booleans."""
    rng = np.random.default_rng(seed)
    out = []
    for t in types:
        if t == "f64":
            a = rng.integers(-40, 40, n) / 4.0
            a[:8] = [0.0, -0.0, np.nan, np.inf, -np.inf, -0.0, 0.0, np.nan]
            a[8] = np.array([0x7FF8000000000001], np.int64).view(np.float64)[0]
        elif t == "bool":
            a = rng.random(n) < 0.5
        else:
            dt = K31_INTS[t]
            info = np.iinfo(dt)
            a = rng.integers(-1000, 1000, n).astype(dt)
            a[:4] = [info.min, info.max, 0, -1]
        out.append(torch.from_numpy(np.ascontiguousarray(a)).to(dev))
    return out


def backfill_filter_numpy(dist, pk, vals, cur, has_pk, vis) -> np.ndarray:
    """The live-side filter in numpy from compute_vnodes_numpy: the third
    reference beside the kernel and its plain version."""
    vn = compute_vnodes_numpy(dist).astype(np.int64)
    le = np.ones(len(vis), dtype=bool)
    for c, v in zip(reversed(pk), reversed(vals)):
        v = np.asarray(v).astype(c.dtype)
        with np.errstate(invalid="ignore"):
            le = (c < v) | ((c == v) & le)
    return vis & ((vn < cur) | ((vn == cur) & bool(has_pk) & le))


def k31_frontiers(dist_np, pk_np) -> list:
    """(cur vnode, last pk or None): the vnode edges 0, 255 and 256, and
    the vnodes of rows with their own pk (-0.0, NaN and the int limits
    among them), has_pk both ways."""
    vn = compute_vnodes_numpy(dist_np)
    out = [(0, None), (255, None), (256, None)]
    for r in (0, 1, 2, 3, 5, 8, 100, 4096):
        out.append((int(vn[r]), tuple(c[r].item() for c in pk_np)))
        out.append((int(vn[r]), None))
    return out


def k31_bytes(dist, pk, vis, cur, has_pk) -> int:
    """What the filter needs: every row's visibility read and written;
    the visible rows' distribution key; the pk columns beyond the
    distribution key for the visible rows on the frontier's vnode."""
    n = vis.shape[0]
    n_vis = int(vis.sum())
    out = 2 * n + n_vis * sum(c.element_size() for c in dist)
    extra = [c for c in pk if all(c is not d for d in dist)]
    if has_pk and extra:
        on = int(((compute_vnodes(dist) == cur) & vis).sum())
        out += on * sum(c.element_size() for c in extra)
    return out


def phase_kernels_backfill(dev, n: int = 131072) -> dict:
    """K31 against its plain version and against compute_vnodes_numpy
    (and a numpy form of the filter built on it), bit for bit: 131072-row
    chunks of one to three key columns of each type, frontiers at vnode
    edges, has_pk both ways, -0.0 and NaN pks, invisible rows. Timed at
    one int64 key (the MV-on-MV path's auction) over 131072 rows, 90%
    visible. The path's own chunks are checked and timed after
    mvmv_full (`phase_kernels_backfill_path`)."""
    err = 0
    cases = 0
    for j, types in enumerate(K31_KEY_SETS):
        cols = k31_columns(dev, n, types, seed=j)
        np_cols = [c.cpu().numpy() for c in cols]
        want = compute_vnodes_numpy(np_cols)
        got = compute_vnodes(cols)
        plain = compute_vnodes_plain(cols)
        torch.cuda.synchronize()
        err = max(err, int((got.cpu().numpy() != want).sum()),
                  exact_err([got], [plain]))
        vis_np = np.random.default_rng(100 + j).random(n) < 0.9
        vis = torch.from_numpy(vis_np).to(dev)
        for dist_n in sorted({1, len(cols)}):
            dist, dist_np = cols[:dist_n], np_cols[:dist_n]
            for cur, last in k31_frontiers(dist_np, np_cols):
                vals = last if last is not None else (0,) * len(cols)
                a = backfill_filter(dist, cols, vals, cur, last is not None,
                                    vis)
                b = backfill_filter_plain(dist, cols, vals, cur,
                                          last is not None, vis)
                c = backfill_filter_numpy(dist_np, np_cols, vals, cur,
                                          last is not None, vis_np)
                torch.cuda.synchronize()
                err = max(err, exact_err([a], [b]),
                          int((a.cpu().numpy() != c).sum()))
                cases += 1
        if err:
            raise AssertionError(f"K31 differs on {types}: {err}")
    (key,) = k31_columns(dev, n, ("i64",), seed=77)
    vis = torch.from_numpy(np.random.default_rng(78).random(n)
                           < 0.9).to(dev)
    cur = int(compute_vnodes([key])[n // 2])
    res = dict(max_abs_err=err, key_sets=len(K31_KEY_SETS),
               filter_cases=cases,
               **k31_timed([key], [key], (int(key[n // 2]),), cur, True,
                           vis))
    emit({"phase": "kernel", "name": "backfill_filter", **res})
    return {"backfill_filter": res}


def k31_timed(dist, pk, last, cur, has_pk, vis) -> dict:
    """Both entries timed on one chunk against their plain versions,
    with their byte bounds; `filter` is what the kernels line reports."""
    rows = vis.shape[0]
    t_v = timings(lambda: compute_vnodes(dist),
                  lambda: compute_vnodes_plain(dist))
    t_f = timings(
        lambda: backfill_filter(dist, pk, last, cur, has_pk, vis),
        lambda: backfill_filter_plain(dist, pk, last, cur, has_pk, vis))
    vb = rows * (4 + sum(c.element_size() for c in dist))
    fb = k31_bytes(dist, pk, vis, cur, has_pk)
    return dict(rows=rows, visible=int(vis.sum()),
                vnodes=dict(**t_v, bound_ms=bytes_bound_ms(vb)),
                filter=dict(**t_f, bytes=fb, bound_ms=bytes_bound_ms(fb)))


K31_KEEP = 6         # live chunks whose inputs k31_record keeps


def k31_record(bf, taps: dict) -> None:
    """Wrap backfill `bf`'s live-side filter: every call appends its
    chunk's length and (on the device, read later) visible count to
    taps["chunks"]; the first K31_KEEP calls at a frontier no kept call
    had also keep copies of the kernel's inputs, the frontier and its
    output."""
    inner = bf._filter_chunk

    def filtered(chunk):
        cur, last = bf.vnode, bf.last_pk
        out = inner(chunk)
        taps.setdefault("chunks", []).append(
            (chunk.vis.shape[0], chunk.vis.sum()))
        kept = taps.setdefault("kept", [])
        if len(kept) < K31_KEEP and all((k["cur"], k["last"]) != (cur, last)
                                        for k in kept):
            kept.append(dict(
                dist=[chunk.columns[i].data.clone() for i in bf._dist_idx],
                pk=[chunk.columns[i].data.clone() for i in bf.pk_indices],
                vis=chunk.vis.clone(), cur=cur, last=last,
                out=out.vis.clone()))
        return out
    bf._filter_chunk = filtered


def phase_kernels_backfill_path(dev, taps: dict) -> dict:
    """K31 on the live chunks mvmv_full's backfills filtered (mv_agg's
    flush chunks as the tap delivered them, `k31_record`): the path's
    own output, the kernel again, its plain version and the numpy form
    agree bit for bit at the frontier the backfill had, with has_pk
    false at that vnode, and at the vnode edges 0, 255 and 256 and rows'
    own pks (k31_frontiers). Timed on the kept chunk with the furthest
    frontier, at that frontier; its length and visible share are the
    path's, and those of every chunk filtered are summarized."""
    kept = taps.get("kept", [])
    if not kept:
        raise AssertionError("kernels_backfill: mvmv_full's backfills "
                             "filtered no live chunk")
    err, cases = 0, 0
    for c in kept:
        dist, pk, vis = c["dist"], c["pk"], c["vis"]
        dist_np = [x.cpu().numpy() for x in dist]
        pk_np = [x.cpu().numpy() for x in pk]
        vis_np = vis.cpu().numpy()
        err = max(err, exact_err([compute_vnodes(dist)],
                                 [compute_vnodes_plain(dist)]),
                  int((compute_vnodes(dist).cpu().numpy()
                       != compute_vnodes_numpy(dist_np)).sum()))
        fronts = [(c["cur"], c["last"]), (c["cur"], None)]
        fronts += k31_frontiers(dist_np, pk_np)
        for j, (cur, last) in enumerate(fronts):
            vals = last if last is not None else (0,) * len(pk)
            a = backfill_filter(dist, pk, vals, cur, last is not None, vis)
            b = backfill_filter_plain(dist, pk, vals, cur, last is not None,
                                      vis)
            n = backfill_filter_numpy(dist_np, pk_np, vals, cur,
                                      last is not None, vis_np)
            torch.cuda.synchronize()
            err = max(err, exact_err([a], [b]),
                      int((a.cpu().numpy() != n).sum()))
            if j == 0:
                err = max(err, exact_err([c["out"]], [b]))
            cases += 1
    if err:
        raise AssertionError(f"K31 differs on mvmv_full's chunks: {err}")
    lens = [n for n, _ in taps["chunks"]]
    shares = [int(v) / n for n, v in taps["chunks"]]
    c = max(kept, key=lambda x: (x["cur"], x["last"] is not None))
    vals = c["last"] if c["last"] is not None else (0,) * len(c["pk"])
    timed = k31_timed(c["dist"], c["pk"], vals, c["cur"],
                      c["last"] is not None, c["vis"])
    res = dict(max_abs_err=err, chunks_kept=len(kept), filter_cases=cases,
               chunks_filtered=len(lens), chunk_rows=sorted(set(lens)),
               visible_share_mean=statistics.fmean(shares),
               visible_share_min=min(shares), visible_share_max=max(shares),
               timed_frontier=dict(vnode=c["cur"],
                                   has_pk=c["last"] is not None),
               **timed)
    emit({"phase": "kernels_backfill_path", **res})
    f = res["filter"]
    return {"backfill_filter": dict(
        res, ms=f["ms"], plain_ms=f["plain_ms"], library_ms=None,
        bound_ms=f["bound_ms"], bound_by="bytes")}


# ---- queue_c: Queue C's views through Session(device="cuda")

QC_CHUNK = 32768
QC_KERNELS = {"case_int": ("nexmark_bid", "expr_eval"),
              "case_int_no_else": ("nexmark_bid", "expr_eval"),
              "where_int": ("nexmark_bid", "filter_ops"),
              "bool_arith": ("nexmark_bid", "expr_eval")}


def queue_c_recount(view: str, n: int, dev) -> Counter:
    auction, price = _bid_prefix(n, NexmarkConfig(), dev, [0, 2])
    a, p = auction.tolist(), price.tolist()
    if view == "case_int":
        return Counter((x, x & 1) for x in a)
    if view == "case_int_no_else":
        return Counter((x, x if y & 1 else None) for x, y in zip(a, p))
    if view == "where_int":
        return Counter((x, y) for x, y in zip(a, p) if x & 1)
    return Counter((x, 2 if y > 10 else 1) for x, y in zip(a, p))


def phase_queue_c(dev, rounds: int = 2) -> dict:
    """Each of Queue C's views (an integer CASE condition with and
    without ELSE, an integer WHERE, boolean arithmetic) through
    Session(device="cuda") as an MV over 32768-bid chunks, one a
    barrier: K5 and K22 take the integer conditions, and the MV equals
    the numpy recount (a condition holds where its low bit is set).
    Then K3's float64 keys against the plain version
    (`k3_float64_checks`)."""
    out = {}
    for view, select in QUEUE_C_SELECTS.items():
        ddl = breadth_ddl(select, "qc", bid_chunk=QC_CHUNK, sink=False)
        r = session_run(dev, ddl, rounds, QC_CHUNK, name="qc")
        got = Counter(tuple(x[:2]) for x in r["mv"])
        want = queue_c_recount(view, r["bids"], dev)
        if got != want or not want:
            raise AssertionError(f"queue_c {view}: {sum(got.values())} "
                                 f"rows, recount {sum(want.values())}")
        need_launches(r, QC_KERNELS[view], f"queue_c {view}")
        out[view] = dict(rows=sum(got.values()), bids=r["bids"],
                         launches={k: r["launches"][k]
                                   for k in QC_KERNELS[view]})
    # closed fault: K3 hashed and compared float64 keys by their bits
    out["k3_float64"] = k3_float64_checks(dev)
    return out


# ---- the MV-on-MV phases

MVMV_CHUNK = 131072
MVMV_KERNELS = ("nexmark_bid", "hash_table", "hash_agg", "agg_flush",
                "compact", "expr_eval", "filter_ops", "backfill_filter")


def mvmv_ddl(chunk: int, agg_cap: int, durable_: int = 0) -> list:
    return [f"SET streaming_durability = {durable_}",
            f"SET streaming_agg_capacity = {agg_cap}",
            ("CREATE SOURCE bid WITH (connector='nexmark', table='bid', "
             f"chunk_size={chunk})"),
            f"CREATE MATERIALIZED VIEW mv_agg AS {MVMV_AGG_SELECT}"]


MVMV_CONSUMERS = [
    f"CREATE MATERIALIZED VIEW mv_hot AS {MVMV_HOT_SELECT}",
    f"CREATE MATERIALIZED VIEW mv_hist AS {MVMV_HIST_SELECT}",
    MVMV_SINK]


def mvmv_agg_cap(rows: int) -> int:
    """mv_agg's slots: a power of two past twice its groups."""
    return 1 << max(17, (2 * rows - 1).bit_length())


def mvmv_barriers_for(rows: int, per: int, dev, max_barriers: int = 4096
                      ) -> int:
    """The fewest barriers of `per` bids after which mv_agg holds at
    least `rows` auctions (the distinct auction ids of the bids so far,
    marked in a bitmap on `dev`)."""
    cfg = NexmarkConfig()
    vocabs = {k: torch.tensor(v, dtype=torch.int32, device=dev)
              for k, v in vocab_ids().items()}
    seen = torch.zeros(1 << 20, dtype=torch.bool, device=dev)
    for k in range(1, max_barriers + 1):
        for off in range((k - 1) * per, k * per, 1 << 20):
            n = min(1 << 20, k * per - off)
            ids = (gen_bid_columns_plain(off, n, cfg, vocabs, dev)[0]
                   - FIRST_AUCTION_ID)
            top = int(ids.max()) + 1
            if top > seen.numel():
                seen = torch.cat([seen, torch.zeros(
                    max(top, 2 * seen.numel()) - seen.numel(),
                    dtype=torch.bool, device=dev)])
            seen[ids] = True
        if int(seen.sum()) >= rows:
            return k
    raise ValueError(f"{max_barriers} barriers of {per} bids hold fewer "
                     f"than {rows} auctions")


def mvmv_covered(agg_rows, bf) -> list:
    """mv_agg's rows that backfill `bf` has covered: vnode below its
    position, or on it with the pk at or before its last pk."""
    if bf.finished:
        return list(agg_rows)
    if not agg_rows:
        return []
    keys = np.asarray([r[0] for r in agg_rows], dtype=np.int64)
    vn = compute_vnodes_numpy([keys])
    last = None if bf.last_pk is None else bf.last_pk[0]
    return [r for r, v, k in zip(agg_rows, vn, keys)
            if v < bf.vnode or (v == bf.vnode and last is not None
                                and k <= last)]


def mvmv_run(dev, *, chunk: int, per: int, agg_cap: int, before: int,
             after: int, store=None, durable_: int = 0, batch_rows=None,
             on_barrier=None, crash_at=None, recover_at=None,
             k31_taps=None) -> dict:
    """mv_agg over bids paced `per` a barrier through Session(device=dev);
    after `before` barriers, mv_hot, mv_hist and the sink from mv_agg,
    each on a bring-up barrier of its own at a known offset; then
    `after` barriers. `batch_rows` sets the backfills' snapshot batch (a
    build hook). `on_barrier(k, s)` runs after every barrier from the
    consumers' first. With `crash_at` the session crashes after that
    barrier; with `recover_at` (the barrier it crashed after) a new
    session over `store` recovers, timed from the store's opening to
    its first collected barrier, and runs on to barrier before + 3 +
    after. With `k31_taps` (a dict) every live chunk a backfill filters
    is recorded there (`k31_record`). Launch counts are set to 0 just
    before the flow starts and read after the last barrier."""

    async def go():
        on_card = torch.device(dev).type == "cuda"
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()

        def hook(_name, dep, _fid):
            for src in dep.executors(SourceExecutor):
                src.rate_limit = per
            for bf in dep.executors(BackfillExecutor):
                if batch_rows:
                    bf.batch_rows = batch_rows
                if k31_taps is not None:
                    k31_record(bf, k31_taps)

        t_open = time.perf_counter()
        s = Session(device=dev, store=store() if callable(store) else store)
        s.build_hooks.append(hook)
        coord = s.coord
        recovery_s = None
        t0 = time.perf_counter()
        if recover_at is not None:
            await s.recover()
            if on_card:
                torch.cuda.synchronize()
            recovery_s = time.perf_counter() - t_open
        else:
            for st in mvmv_ddl(chunk, agg_cap, durable_):
                await s.execute(st)
        src = s.catalog.mvs["mv_agg"].deployment.executors(
            SourceExecutor)[0]
        # the barrier count so far: the recovered source's committed
        # offset (a checkpoint behind the crash may not have committed)
        k = (src.state_table.get_row((0,))[1] // per
             if recover_at is not None else 0)

        async def until(rows):
            while src.connector.offset < rows:
                for d in list(s.catalog.mvs.values()) + list(
                        s.catalog.sinks.values()):
                    for t in d.deployment.tasks:
                        if t.done():
                            t.result()
                await asyncio.sleep(0)

        async def barrier():
            nonlocal k
            k += 1
            await until(k * per)
            b = await coord.inject_barrier()
            await coord.wait_collected(b)

        if recover_at is None:
            for _ in range(before):
                await barrier()
        t_created = time.perf_counter()
        lat_from = len(coord.latencies_ns)
        if recover_at is None:
            for stmt in MVMV_CONSUMERS:
                k += 1
                await until(k * per)
                await s.execute(stmt)
                if on_barrier is not None:
                    on_barrier(k, s)
        bfs = [bf for d in list(s.catalog.mvs.values())
               + list(s.catalog.sinks.values())
               for bf in d.deployment.executors(BackfillExecutor)]
        done_at = done_t = done_lat = None
        stop = before + len(MVMV_CONSUMERS) + after
        while k < stop and not (crash_at is not None and k >= crash_at):
            await barrier()
            if on_barrier is not None:
                on_barrier(k, s)
            if done_at is None and all(bf.finished for bf in bfs):
                done_at, done_t = k, time.perf_counter()
                done_lat = len(coord.latencies_ns)
        wall = time.perf_counter() - t0
        if on_card:
            torch.cuda.synchronize()
        launches = {kk.name: kk.launches for kk in kernels.KERNELS.values()}
        lat = [x / 1e9 for x in coord.latencies_ns]
        during = lat[lat_from:done_lat] if done_lat else lat[lat_from:]
        post = lat[done_lat:] if done_lat else []
        agg_rows = sorted(s.catalog.mvs["mv_agg"].table.iter_committed())
        out = dict(
            bids=src.connector.offset, barriers=k, wall_s=wall,
            launches=launches, recovery_s=recovery_s,
            agg_rows=len(agg_rows),
            snapshot_rows=[bf.snapshot_rows_total for bf in bfs],
            finished=[bf.finished for bf in bfs],
            consumers_at=before, finished_at=done_at,
            backfill_s=(done_t - t_created) if done_t else None,
            barrier_p50_during_s=(statistics.median(during) if during
                                  else None),
            barrier_max_during_s=max(during) if during else None,
            barrier_p50_after_s=statistics.median(post) if post else None,
            barrier_max_after_s=max(post) if post else None,
            mem_peak_bytes=(torch.cuda.max_memory_allocated(dev)
                            if on_card else None))
        if crash_at is not None:
            await s.crash()
        else:
            out["mvs"] = {n: sorted(s.catalog.mvs[n].table.iter_committed())
                          for n in ("mv_agg", "mv_hot", "mv_hist")}
            out["agg_rows_list"] = agg_rows
            try:
                await s.drop_mv("mv_agg")
            except BindError as e:
                out["drop_refused"] = str(e)
            await s.drop_all()
            out["dropped"] = not s.catalog.mvs and not s.catalog.sinks
        return out

    return asyncio.run(go())


def mvmv_check_final(r: dict, what: str) -> None:
    """The backfills finished; mv_hot and mv_hist equal the recount over
    mv_agg; DROP of mv_agg was refused while it had dependents."""
    if not all(r["finished"]):
        raise AssertionError(f"{what}: the backfills did not finish")
    hot, hist = mvmv_recount(r["mvs"]["mv_agg"])
    if (Counter(tuple(x[:3]) for x in r["mvs"]["mv_hot"]) != hot
            or Counter(tuple(x[:2]) for x in r["mvs"]["mv_hist"]) != hist
            or not hot):
        raise AssertionError(f"{what}: mv_hot/mv_hist differ from the "
                             f"recount over mv_agg")
    if "drop_refused" not in r or not r["dropped"]:
        raise AssertionError(f"{what}: DROP of mv_agg with dependents was "
                             f"not refused, or drop_all left flows")


# mv_agg's rows when the consumers arrive: the largest power of two
# whose phase fits its share of the script's time (`--mvmv-sizing`)
MVMV_TARGET = 1 << 18


def phase_mvmv_full(dev, target_rows: int = MVMV_TARGET, per_chunks: int = 2,
                    after: int = 10, chunk: int = MVMV_CHUNK,
                    k31_taps=None) -> dict:
    """mv_agg (count, max, sum per auction: a retracting changelog keyed
    by auction) over 131072-bid chunks, `per_chunks` a barrier, through
    Session(device="cuda"); once it holds `target_rows` auctions, mv_hot
    (a filter), mv_hist (an aggregate over the retracting changelog) and
    a blackhole sink are created over it while the bids keep flowing,
    each backfilling 65536 rows a barrier (the default batch). Rates,
    backfill rows/s, barriers to finish and barrier p50/max during and
    after the backfill come from an unprofiled run; the device idle
    share and top device operations from a profiled second run of the
    same geometry (`run_twice`). The final MVs equal the recount over
    mv_agg, and DROP of mv_agg is refused while it has dependents. With
    `k31_taps` the unprofiled run records the live chunks the backfills
    filter (`k31_record`)."""
    per = per_chunks * chunk
    before = mvmv_barriers_for(target_rows, per, dev)
    agg_cap = mvmv_agg_cap(target_rows)
    runs = []

    def run():
        runs.append(1)
        return mvmv_run(dev, chunk=chunk, per=per, agg_cap=agg_cap,
                        before=before, after=after,
                        k31_taps=k31_taps if len(runs) == 1 else None)

    if torch.device(dev).type == "cuda":
        r, prof = run_twice(run)
    else:                      # a CPU rehearsal: nothing to profile
        r, prof = run(), {}
    mvmv_check_final(r, "mvmv_full")
    need_launches(r, MVMV_KERNELS, "mvmv")
    if r["finished_at"] is None:
        raise AssertionError("mvmv_full: the backfills did not finish")
    snap = sum(r["snapshot_rows"])
    return dict(
        bids=r["bids"], barriers=r["barriers"], wall_s=r["wall_s"],
        bids_per_s=r["bids"] / r["wall_s"], agg_capacity=agg_cap,
        agg_rows=r["agg_rows"], target_rows=target_rows,
        bids_per_barrier=per,
        consumers_at_barrier=before, snapshot_rows=r["snapshot_rows"],
        backfill_rows_per_s=snap / r["backfill_s"],
        backfill_s=r["backfill_s"],
        barriers_to_finish=r["finished_at"] - before,
        barrier_p50_during_s=r["barrier_p50_during_s"],
        barrier_max_during_s=r["barrier_max_during_s"],
        barrier_p50_after_s=r["barrier_p50_after_s"],
        barrier_max_after_s=r["barrier_max_after_s"],
        rows_to_columns=rows_to_columns_rate(r["agg_rows_list"]),
        mem_peak_bytes=r["mem_peak_bytes"], drop_refused=r["drop_refused"],
        **prof, launches=r["launches"])


MVMV_SIZES = ((1 << 17, 2), (1 << 18, 2), (1 << 18, 8), (1 << 19, 8),
              (1 << 20, 16))


def mvmv_sizing(dev, smi: str) -> None:
    """`--mvmv-sizing`: mvmv_full alone at each (mv_agg rows when the
    consumers arrive, 131072-bid chunks a barrier) of MVMV_SIZES, small
    to large, each line with the phase's seconds: the measurements
    MVMV_TARGET was chosen from. A size whose backfills do not finish
    within the phase's barriers is reported as failed."""
    for target, per_chunks in MVMV_SIZES:
        t0 = time.monotonic()
        try:
            r = phase_mvmv_full(dev, target_rows=target,
                                per_chunks=per_chunks)
            r.pop("launches")
        except AssertionError as e:
            r = dict(target_rows=target, bids_per_barrier=per_chunks
                     * MVMV_CHUNK, failed=str(e))
        emit({"phase": "mvmv_sizing", "nvidia_smi": smi,
              "phase_s": time.monotonic() - t0, **r})


def rows_to_columns_rate(rows: list) -> dict:
    """The host cost of the snapshot's row-to-column conversion, timed
    over mv_agg's rows (the backfill converts each snapshot row once)."""
    from risingwave_tpu_torch.state.storage_table import rows_to_columns
    sch = make_schema(("auction", DataType.INT64), ("cnt", DataType.INT64),
                      ("mp", DataType.INT64), ("sp", DataType.INT64))
    t0 = time.perf_counter()
    rows_to_columns(sch, rows)
    dt = time.perf_counter() - t0
    return dict(rows=len(rows), s=dt, rows_per_s=len(rows) / dt if dt
                else None)


def phase_mvmv_check(dev, target_rows: int = 1 << 14,
                     batch_rows: int = 4096, after: int = 6,
                     per: int = 32768) -> dict:
    """Paced barriers of one 32768-bid chunk: after every barrier from
    the consumers' creation on, mv_hot and mv_hist equal a numpy recount
    over the rows of mv_agg committed at that barrier that each backfill
    has covered (all of them once it finished): during the backfill
    (`batch_rows` rows a barrier, several barriers) and after it. DROP
    of mv_agg is refused while it has dependents; the dependents go,
    then mv_agg."""
    before = mvmv_barriers_for(target_rows, per, dev)
    checked = {"during": 0, "after": 0}

    def check(k, s):
        agg = sorted(s.catalog.mvs["mv_agg"].table.iter_committed())
        for name, is_hot in (("mv_hot", True), ("mv_hist", False)):
            if name not in s.catalog.mvs:
                continue
            (bf,) = s.catalog.mvs[name].deployment.executors(
                BackfillExecutor)
            hot, hist = mvmv_recount(mvmv_covered(agg, bf))
            rows = list(s.catalog.mvs[name].table.iter_committed())
            got = (Counter(tuple(x[:3]) for x in rows) if is_hot
                   else Counter(tuple(x[:2]) for x in rows))
            if got != (hot if is_hot else hist):
                raise AssertionError(
                    f"mvmv_check: {name} differs from the recount at "
                    f"barrier {k} (finished {bf.finished})")
            checked["after" if bf.finished else "during"] += 1

    r = mvmv_run(dev, chunk=per, per=per, agg_cap=1 << 16, before=before,
                 after=after, batch_rows=batch_rows, on_barrier=check)
    mvmv_check_final(r, "mvmv_check")
    if checked["during"] < 2 or checked["after"] < 2:
        raise AssertionError(f"mvmv_check: checks {checked}")
    return dict(agg_rows=r["agg_rows"], barriers=r["barriers"],
                checks=checked, batch_rows=batch_rows,
                finished_at=r["finished_at"], drop_refused=r["drop_refused"])


def phase_mvmv_recover(dev, target_rows: int = 1 << 13,
                       batch_rows: int = 2048, after: int = 8,
                       per: int = 32768) -> dict:
    """Durable (streaming_durability = 1, Hummock over a local-fs object
    store, integer columns only): the consumers backfill `batch_rows`
    rows a barrier; the session crashes two barriers into the backfill,
    a new one recovers and runs on. Each backfill resumes from its
    persisted progress row (rows re-read = its snapshot rows after
    recovery), and the MVs equal the recount over mv_agg."""
    before = mvmv_barriers_for(target_rows, per, dev)
    crash_at = before + len(MVMV_CONSUMERS) + 2
    kw = dict(chunk=per, per=per, agg_cap=1 << 15, before=before,
              after=after, durable_=1, batch_rows=batch_rows)
    with tempfile.TemporaryDirectory(prefix="mvmv_") as d:
        a = mvmv_run(dev, store=HummockStateStore(LocalFsObjectStore(d)),
                     crash_at=crash_at, **kw)
        if all(a["finished"]):
            raise AssertionError("mvmv_recover: the crash missed the "
                                 "backfill")
        b = mvmv_run(dev, store=lambda: HummockStateStore.open(
            LocalFsObjectStore(d)), recover_at=crash_at, **kw)
    mvmv_check_final(b, "mvmv_recover")
    if not all(b["finished"]):
        raise AssertionError("mvmv_recover: the backfills did not finish")
    return dict(agg_rows=b["agg_rows"], crash_at=crash_at,
                snapshot_rows_before_crash=a["snapshot_rows"],
                rows_reread=b["snapshot_rows"],
                recovery_ms=b["recovery_s"] * 1e3,
                finished_at=b["finished_at"], barriers=b["barriers"])


# ---- the hash join (inner joins on FLOAT64 keys)

# Nexmark q20's join keyed by FLOAT64: every bid with its auction
HJ_Q20_SELECT = (
    "SELECT B.auction, B.bidder, B.price, A.seller, A.reserve FROM "
    "(SELECT auction * 1.0 AS k, auction, bidder, price FROM bid) AS B "
    "JOIN (SELECT id * 1.0 AS k, id, seller, reserve FROM auction) AS A "
    "ON B.k = A.k")
# a retracting side: each auction's max price (a FLOAT64-keyed agg, one
# U-/U+ pair a rise) joined to its auction
HJ_RETRACT_SELECT = (
    "SELECT A.id, A.seller, M.mp FROM (SELECT k, max(price) AS mp FROM "
    "(SELECT auction * 1.0 AS k, price FROM bid) AS X GROUP BY k) AS M "
    "JOIN (SELECT id * 1.0 AS k, id, seller FROM auction) AS A "
    "ON M.k = A.k")
# a non-equi condition, boolean and int64 (`data & valid`: the low bit)
HJ_COND_SELECT = (
    "SELECT B.auction, B.price, A.reserve FROM "
    "(SELECT auction * 1.0 AS k, auction, price FROM bid) AS B JOIN "
    "(SELECT id * 1.0 AS k, id, reserve FROM auction) AS A "
    "ON B.k = A.k AND B.price > A.reserve")
HJ_INT_COND_SELECT = HJ_COND_SELECT.replace("B.price > A.reserve",
                                            "B.price - A.reserve")
HJ_KERNELS = ("nexmark_bid", "nexmark_auction", "expr_eval", "row_id",
              "radix_sort", "pk_net", "hash_table", "hash_join_probe",
              "hash_join_update", "hash_join_pack")
HJR_KERNELS = HJ_KERNELS + ("hash_agg", "agg_flush")
HJ_BID_CHUNK = 16384
HJ_AUCTION_CHUNK = 512
# hj_full's schedule, cumulative rows at barriers 1..7 (the SQL path
# keeps the executor's 2^14-key / 2^16-row capacities): the bid side
# fills to 3/4 of its row capacity a barrier, past the 0.7 line, so
# each barrier's rebuild doubles it, up to 2^21 live rows; the auction
# side (every row a new key) to 0.71875 of its key capacity a barrier,
# then past the largest auction id the bids name (136748)
HJ_BID_RAMP = (49152, 98304, 196608, 393216, 786432, 1572864, 1 << 21)
HJ_AUCTION_RAMP = (11776, 23552, 47104, 94208, 141312, 141312, 141312)


def hj_ddl(select: str, name: str, *, bid_chunk: int = HJ_BID_CHUNK,
           auction_chunk: int = HJ_AUCTION_CHUNK, durable_: int = 0,
           sink: bool = True, agg_cap: int = 1 << 16) -> list:
    """`outer_ddl`'s sources and one flow (a hash join needs no join
    capacity: the SQL path keeps the executor's defaults)."""
    return outer_ddl(select, name, auction_chunk=auction_chunk,
                     bid_chunk=bid_chunk, durable_=durable_, sink=sink,
                     extra=(f"SET streaming_agg_capacity = {agg_cap}",))


def bid_cols_dev(n: int, dev, idx=(0, 1, 2), start: int = 0) -> list:
    """Columns `idx` of bids [start, start + n) on the card (plain
    generator)."""
    vocabs = {k: torch.tensor(v, dtype=torch.int32, device=dev)
              for k, v in vocab_ids().items()}
    parts = []
    for off in range(start, start + n, 1 << 21):
        cols = gen_bid_columns_plain(off, min(1 << 21, start + n - off),
                                     NexmarkConfig(), vocabs, dev)
        parts.append([cols[i] for i in idx])
    return [torch.cat(x) for x in zip(*parts)]


def net_rows(sink, ncols: int) -> torch.Tensor:
    """The collect sink's rows (first `ncols` columns, NULL as 0) with
    a non-zero net count, one row per unit of count, sorted."""
    k = min(int(sink.count), sink.capacity)
    if int(sink.count) > sink.capacity:
        raise AssertionError(f"collect sink overflow: {int(sink.count)}")
    rows = torch.stack([torch.where(v[:k], d[:k].to(torch.int64), 0)
                        for d, v in zip(sink.data[:ncols],
                                        sink.valid[:ncols])], 1)
    u, inv = torch.unique(rows, dim=0, return_inverse=True)
    cnt = torch.zeros(u.shape[0], dtype=torch.int64, device=rows.device)
    cnt.index_add_(0, inv, sink.sign[:k].to(torch.int64))
    if bool((cnt < 0).any()):
        raise AssertionError("collect sink: a row retracted more often "
                             "than it was inserted")
    return torch.repeat_interleave(u, cnt, dim=0)


def sorted_rows(rows: torch.Tensor) -> torch.Tensor:
    u, c = torch.unique(rows, dim=0, return_counts=True)
    return torch.repeat_interleave(u, c, dim=0)


def hj_q20_recount(n_bids: int, n_auctions: int, dev) -> torch.Tensor:
    """HJ_Q20_SELECT's rows (auction, bidder, price, seller, reserve)
    over bids [0, n_bids) and auctions [0, n_auctions), sorted."""
    auction, bidder, price = bid_cols_dev(n_bids, dev)
    _, reserve, seller = auction_cols_dev(n_auctions, dev, (0, 4, 7))
    idx = auction - 1000
    hit = (idx >= 0) & (idx < n_auctions)
    i = idx[hit]
    return sorted_rows(torch.stack([auction[hit], bidder[hit], price[hit],
                                    seller[i], reserve[i]], 1))


def hj_retract_recount(n_bids: int, n_auctions: int, dev) -> torch.Tensor:
    """HJ_RETRACT_SELECT's rows (id, seller, max price) for auctions
    [0, n_auctions) with a bid among bids [0, n_bids), sorted."""
    auction, _, price = bid_cols_dev(n_bids, dev)
    _, seller = auction_cols_dev(n_auctions, dev, (0, 7))
    idx = auction - 1000
    hit = (idx >= 0) & (idx < n_auctions)
    mp = torch.full((n_auctions,), -1, dtype=torch.int64, device=dev)
    mp.scatter_reduce_(0, idx[hit], price[hit], "amax")
    has = mp >= 0
    ids = torch.arange(n_auctions, device=dev) + 1000
    return sorted_rows(torch.stack([ids[has], seller[has], mp[has]], 1))


def phase_hj_full(dev, taps: dict = None) -> dict:
    """Nexmark q20's join keyed by FLOAT64 (HJ_Q20_SELECT) through
    Session(device="cuda") into a device collect sink: bids in 16384-row
    chunks, auctions in 512-row chunks, paced by HJ_BID_RAMP and
    HJ_AUCTION_RAMP (a ramp, because the SQL path leaves the executor
    its 2^14-key / 2^16-row capacities and each barrier's inserts must
    fit them until the rebuilds have doubled them), to 2^21 live bid
    rows. Every bid meets its auction: the net output equals the numpy
    recount, errs [0, 0, 0, 0], every hash-join kernel launched, the
    rebuilds counted. Run twice (`run_twice`): rates and barrier
    latencies unprofiled, the idle share profiled. The unprofiled run
    records its join's work into `taps` (`hj_record`: the first and last
    bid chunk, the last auction chunk, each side's last rehash)."""
    rounds = len(HJ_BID_RAMP)
    pace = {"bid": list(HJ_BID_RAMP), "auction": list(HJ_AUCTION_RAMP)}
    ddl = hj_ddl(HJ_Q20_SELECT, "hj")
    keep = ({1, HJ_BID_RAMP[-1] // HJ_BID_CHUNK},
            {HJ_AUCTION_RAMP[-1] // HJ_AUCTION_CHUNK})

    def on_build(dep):
        if taps is not None and "applies" not in taps:
            hj_record(dep.executors(HashJoinExecutor)[0], taps, keep)

    def run():
        r = session_run(dev, ddl, rounds, 0, name="hj", pace=pace,
                        collect=1 << 22, on_build=on_build)
        if r["join"].errs() != [0, 0, 0, 0]:
            raise AssertionError(f"hj_full: join errs {r['join'].errs()}")
        return r

    r, prof = run_twice(run)
    need_launches(r, HJ_KERNELS, "hj_full")
    nB, nA = r["offsets"]["bid"], r["offsets"]["auction"]
    got = net_rows(r["sink"], 5)
    want = hj_q20_recount(nB, nA, dev)
    if got.shape != want.shape or not torch.equal(got, want) \
            or nB != HJ_BID_RAMP[-1]:
        raise AssertionError(f"hj_full: {got.shape[0]} net rows against "
                             f"{want.shape[0]} recounted ({nB} bids)")
    join = r["join"]
    live = [int(s_.live.sum()) for s_ in join.sides]
    if live[0] != nB or join.rebuilds < 8:
        raise AssertionError(f"hj_full: {live} live rows, "
                             f"{join.rebuilds} rebuilds")
    return dict(run_figures(r, nB + nA), **prof, bids=nB, auctions=nA,
                output_rows=int(got.shape[0]), join_live_rows=live,
                join_key_capacity=join.key_capacity,
                join_row_capacity=join.row_capacity,
                rebuilds=join.rebuilds, join_errs=join.errs(),
                launches=r["launches"])


def phase_hj_retract(dev, rounds: int = 8, per: int = 65536,
                     auctions: int = 4096, taps: dict = None) -> dict:
    """HJ_RETRACT_SELECT (each auction's max price, a FLOAT64-keyed agg
    whose every rise is a U-/U+ pair on one pk, joined to its auction)
    through Session(device="cuda"): after every barrier of both runs
    (`run_twice`) the net output equals the numpy recount; the join's
    deletes walk K33's chains (errs [0, 0, 0, 0]). The unprofiled run
    records the join's 3rd and 8th applies of the agg side into `taps`
    (`hj_record`)."""
    pace = {"bid": per, "auction": auctions}
    ddl = hj_ddl(HJ_RETRACT_SELECT, "hjr", bid_chunk=per // 4,
                 auction_chunk=1024, agg_cap=1 << 16)
    checked, held = [], {}

    def on_barrier(k, s, rows):
        got = net_rows(held["sink"], 3)
        want = hj_retract_recount(rows["bid"], rows["auction"], dev)
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"hj_retract: barrier {k}: "
                                 f"{got.shape[0]} rows against "
                                 f"{want.shape[0]}")
        checked.append(k)

    def on_flow(s, dep):
        held["sink"] = next(a.consumer for a in dep.actors
                            if isinstance(a.consumer,
                                          DeviceCollectSinkExecutor))

    def on_build(dep):
        if taps is not None and "applies" not in taps:
            hj_record(dep.executors(HashJoinExecutor)[0], taps,
                      ({3, 8}, set()))

    def run():
        r = session_run(dev, ddl, rounds + 1, 0, name="hjr", pace=pace,
                        collect=1 << 22, on_flow=on_flow,
                        on_barrier=on_barrier, on_build=on_build)
        if r["join"].errs() != [0, 0, 0, 0]:
            raise AssertionError(f"hj_retract: join errs "
                                 f"{r['join'].errs()}")
        return r

    r, prof = run_twice(run)
    need_launches(r, HJR_KERNELS, "hj_retract")
    if len(checked) < 2 * rounds:
        raise AssertionError(f"hj_retract: {len(checked)} barriers checked")
    emitted = int(r["sink"].count)
    return dict(run_figures(r, sum(r["offsets"].values())), **prof,
                barriers_checked=len(checked), rows_emitted=emitted,
                join_errs=r["join"].errs(), launches=r["launches"])


def phase_hj_recover(dev, r1: int = 4, r2: int = 4,
                     per: int = 16384) -> dict:
    """HJ_Q20_SELECT as a durable MV on a Hummock store over a local-fs
    object store (16384 bids and 1024 auctions a barrier): crash at
    barrier r1, HummockStateStore.open, a new Session, recover() (both
    sides re-applied from their state tables), on to r1 + r2 barriers:
    the MV equals an uninterrupted durable run's and the numpy
    recount."""
    pace = {"bid": per, "auction": per // 16}
    ddl = hj_ddl(HJ_Q20_SELECT, "hj", bid_chunk=per,
                 auction_chunk=per // 16, durable_=1, sink=False)

    def mv_rows(rows):
        return sorted_rows(torch.tensor([r[:5] for r in rows],
                                        dtype=torch.int64, device=dev))

    with tempfile.TemporaryDirectory(prefix="hjr_") as d:
        a = session_run(dev, ddl, r1, 0, name="hj", crash=True, pace=pace,
                        store=HummockStateStore(LocalFsObjectStore(d)))
        b = session_run(dev, ddl, 0, 0, name="hj", pace=pace,
                        recover_to=r1 + r2, store=lambda: HummockStateStore
                        .open(LocalFsObjectStore(d)))
    with tempfile.TemporaryDirectory(prefix="hju_") as d:
        u = session_run(dev, ddl, r1 + r2, 0, name="hj", pace=pace,
                        store=HummockStateStore(LocalFsObjectStore(d)))
    got, ref = mv_rows(b["mv"]), mv_rows(u["mv"])
    want = hj_q20_recount(b["offsets"]["bid"], b["offsets"]["auction"],
                          dev)
    if not (torch.equal(got, ref) and torch.equal(got, want)) \
            or not a["mv"] or b["join"].errs() != [0, 0, 0, 0]:
        raise AssertionError(f"hj_recover: {got.shape[0]} MV rows, "
                             f"uninterrupted {ref.shape[0]}, recount "
                             f"{want.shape[0]}")
    return dict(run_figures(b, sum(b["offsets"].values())),
                barriers_before_crash=r1,
                barriers_after_recovery=b["barriers"],
                recovery_ms=b["recovery_s"] * 1e3, mv_rows=len(b["mv"]),
                mv_rows_at_crash=len(a["mv"]), launches=b["launches"])


# ---- kernels_hash_join

def k3_float64_checks(dev) -> list:
    """K3 against its plain version on float64 hazard keys
    (scripts/k3_float_fault.py: one slot for -0.0 and +0.0, a slot per
    NaN row, the plain version's partition, buckets, key bits and
    fills), over an empty and a pre-filled table; then the same, and
    int64 keys half of which exist, with K3's scratch buffers poisoned
    before the call (`lookup_or_insert_stale`: K3 reads no entry it did
    not write in the same call); raises on a difference."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "k3_float_fault", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "scripts", "k3_float_fault.py"))
    k3f = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(k3f)
    out = [dict(k3f.k3_float_report(ht, torch.device(dev), prefill=p,
                                    stale=st), stale=st)
           for st in (None, *k3f.STALE) for p in (False, True)]
    if not all(r["ok"] for r in out):
        raise AssertionError(f"K3 float64: {out}")
    # integer keys over poisoned scratch: half the chunk's keys exist
    g = torch.Generator(device="cpu").manual_seed(34)
    pre = torch.randint(-(1 << 40), 1 << 40, (8192,), generator=g)
    keys = torch.cat([pre[:4096], torch.randint(1 << 41, 1 << 42, (4096,),
                                                generator=g)])
    keys = keys[torch.randperm(8192, generator=g)].to(dev)
    act = (torch.rand(8192, generator=g) < 0.8).to(dev)
    before = ht.HashTable.empty(1 << 15, [torch.int64], dev)
    ht.lookup_or_insert_plain(before, [pre.to(dev)], torch.ones(
        8192, dtype=torch.bool, device=dev))
    for st in k3f.STALE:
        tk = ht.HashTable(tuple(k.clone() for k in before.keys),
                          before.occupied.clone())
        tp = ht.HashTable(tuple(k.clone() for k in before.keys),
                          before.occupied.clone())
        _, sk, nk = k3f.lookup_or_insert_stale(ht, kernels, tk, [keys], act,
                                               st)
        _, sp, np_ = ht.lookup_or_insert_plain(tp, [keys], act)
        out.append(dict(k3_invariants(before, [keys], act, sk, nk, tk, sp,
                                      np_, tp), stale=st, key="int64"))
    return out


def hj_auction_side(dev, n: int, ck: int, cr: int):
    """The auction side of the q20 join at n auctions: (k, seller,
    reserve, row id), keyed on k = id * 1.0."""
    aid, reserve, seller = auction_cols_dev(n, dev, (0, 4, 7))
    rid = torch.arange(n, dtype=torch.int64, device=dev)
    return hj.side_from_rows([aid.double(), seller, reserve, rid], [0], ck,
                             cr)


def hj_bid_side(dev, n: int, ck: int, cr: int):
    """The bid side at n bids: (k, auction, bidder, price, row id)."""
    auction, bidder, price = bid_cols_dev(n, dev)
    rid = torch.arange(n, dtype=torch.int64, device=dev)
    return hj.side_from_rows([auction.double(), auction, bidder, price,
                              rid], [0], ck, cr)


def hj_clone(st):
    return hj.HashJoinSideState(
        ht.HashTable(tuple(k.clone() for k in st.key_table.keys),
                     st.key_table.occupied.clone()),
        st.head.clone(), tuple(r.clone() for r in st.rows),
        tuple(v.clone() for v in st.valids), st.next.clone(),
        st.live.clone(), st.dirty.clone(), st.top.clone())


def hj_restore(dst, src) -> None:
    for a, b in zip(dst.tensors(), src.tensors()):
        a.copy_(b)


def chain_slots(st) -> torch.Tensor:
    """Each row's chain, named by its key slot (-1 for a row on no
    chain), by pointer jumping to the chain's last row: two stores whose
    rows are equal have the same chains as sets per key iff these are
    equal."""
    CR = st.row_capacity
    rows = torch.arange(CR, device=st.next.device)
    tail = torch.where(st.next >= 0, st.next.long(), rows)
    for _ in range(40):
        nt = tail[tail]
        if torch.equal(nt, tail):
            break
        tail = nt
    else:
        raise AssertionError("a chain does not end")
    slot_of_tail = torch.full((CR + 1,), -1, dtype=torch.int64,
                              device=rows.device)
    heads = torch.nonzero(st.head >= 0)[:, 0]
    slot_of_tail[tail[st.head[heads].long()]] = heads
    return slot_of_tail[tail]


def hj_side_err(a, b) -> int:
    """Rows, valids, live, dirty, top and key table exactly, chains as
    sets per key: the count of differing elements."""
    err = int(a.top) != int(b.top)
    for x, y in zip([*a.rows, *a.valids, a.live, a.dirty,
                     a.key_table.occupied, *a.key_table.keys],
                    [*b.rows, *b.valids, b.live, b.dirty,
                     b.key_table.occupied, *b.key_table.keys]):
        if x.dtype == torch.float64:
            x, y = x.view(torch.int64), y.view(torch.int64)
        err += int((x != y).sum())
    return err + int((chain_slots(a) != chain_slots(b)).sum())


def probe_rows(own_m, oth_m, ops, vis) -> torch.Tensor:
    """A probe's visible output rows (op, then every column, floats by
    bits, NULL as 0), sorted."""
    cols = [ops.to(torch.int64)] + [
        torch.where(c.valid_mask(), c.data.view(torch.int64)
                    if c.data.dtype == torch.float64
                    else c.data.to(torch.int64), 0)
        for c in own_m + oth_m]
    return sorted_rows(torch.stack(cols, 1)[vis])


def _row_bytes(cols) -> int:
    return sum(c.element_size() for c in cols)


def k32_bytes(N: int, n_keys: int, n_match: int, own_b: int, oth_b: int,
              n_own: int, n_oth: int, M: int) -> int:
    """K32's bytes: the chunk's keys, ops and columns read; two buckets
    of occupancy and keys per distinct key; each match's stored row
    read (next, live, columns, valids) and its output row written (both
    sides' columns and valids, op); the vis bytes of all M slots."""
    return (N * (1 + 1 + own_b) + n_keys * 2 * 16 * 9
            + n_match * (5 + oth_b + n_oth)
            + n_match * (own_b + oth_b + n_own + n_oth + 1) + M)


def k33_insert_bytes(N: int, n_ins: int, row_b: int) -> int:
    """K33's insert: the mask and slot of every row; each inserted row
    read (columns, valids) and written with its next, live and dirty
    bytes, its key's head swapped (4 + 4 bytes)."""
    return N * (1 + 4) + n_ins * (2 * row_b + 2 + 4 + 8)


def k34_bytes(CR: int, n: int, row_b: int, n_cols: int, mode: int) -> int:
    """K34's pack: live and dirty of every row (and the cleaning column
    for an evict); each kept row read and written, with its valids,
    live and dirty (keep) or op (dirty)."""
    extra = (n_cols + 2 if mode == hj.PACK_KEEP
             else 1 if mode == hj.PACK_DIRTY else 0)
    return (CR * 2 + (CR * 8 if mode == hj.PACK_EVICT else 0)
            + n * row_b + n * (row_b + extra))


def pack_err(a, b, mode: int) -> int:
    """K34's pack against its plain version: the count, then the kept
    prefix of every output, exactly."""
    n_ = int(b[5])
    e = int(int(a[5]) != n_)
    pairs = list(zip(a[0], b[0]))
    if mode == hj.PACK_KEEP:
        pairs += list(zip(a[1], b[1]))
    if mode == hj.PACK_DIRTY:
        pairs.append((a[2], b[2]))
    for x, y in pairs:
        if x.dtype == torch.float64:
            x, y = x.view(torch.int64), y.view(torch.int64)
        e += int((x[:n_] != y[:n_]).sum())
    if mode == hj.PACK_KEEP:
        e += int((a[3] != b[3]).sum()) + int((a[4] != b[4]).sum())
    return e


def chain_walked(st, victims: torch.Tensor) -> int:
    """Rows a delete walks to reach each of `victims` (its place in its
    chain from the head, counted from 1), by pointer jumping."""
    rows = torch.arange(st.row_capacity, device=st.next.device)
    nxt = torch.where(st.next >= 0, st.next.long(), rows)
    depth = (st.next >= 0).long()        # rows after this one, so far
    for _ in range(40):
        nn = nxt[nxt]
        if torch.equal(nn, nxt):
            break
        depth = depth + depth[nxt]
        nxt = nn
    else:
        raise AssertionError("a chain does not end")
    slot = chain_slots(st)[victims]
    head_row = st.head[slot].long()
    return int((depth[head_row] - depth[victims] + 1).sum())


def clone_chunk(chunk: StreamChunk) -> StreamChunk:
    return StreamChunk(
        tuple(Column(c.data.clone(),
                     None if c.valid is None else c.valid.clone())
              for c in chunk.columns),
        chunk.ops.clone(), chunk.vis.clone(), chunk.schema)


def hj_record(join, taps: dict, keep: tuple) -> None:
    """Wrap hash join `join`'s chunk apply and rehash as the path runs
    them. Every apply appends (side, rows) to taps["applies"]; the
    applies whose ordinal on their side (from 1) is in keep[side] also
    keep copies of both sides before it, the chunk, the path's output
    and the own side after it (taps["kept"]). Each side's last rehash
    keeps its old side and the fresh one (taps["rehash"][side])."""
    inner_apply, inner_rehash = join._apply, join._rehash
    count = [0, 0]
    taps.update(applies=[], kept=[], rehash={},
                key_indices=join.key_indices,
                pk_indices=join.pk_indices_side,
                match_factor=join.match_factor,
                key_dtypes=join._key_dtypes, col_dtypes=join._col_dtypes)

    def apply(side, chunk):
        count[side] += 1
        rec = None
        if count[side] in keep[side]:
            rec = dict(side=side, ordinal=count[side],
                       own=hj_clone(join.sides[side]),
                       other=hj_clone(join.sides[1 - side]),
                       chunk=clone_chunk(chunk))
        out = inner_apply(side, chunk)
        taps["applies"].append((side, chunk.capacity))
        if rec is not None:
            cols, ops, vis = out
            rec.update(out=([Column(c.data.clone(), c.valid_mask().clone())
                             for c in cols], ops.clone(), vis.clone()),
                       own_after=hj_clone(join.sides[side]))
            taps["kept"].append(rec)
        return out

    def rehash(s, new_ck, new_cr):
        old = hj_clone(join.sides[s])
        inner_rehash(s, new_ck, new_cr)
        taps["rehash"][s] = dict(old=old, fresh=hj_clone(join.sides[s]))

    join._apply, join._rehash = apply, rehash


def hj_replay(taps: dict, rec: dict, bufs) -> dict:
    """One apply the path recorded (`hj_record`), again: K32 on the
    other side as it was, against its plain version and the path's own
    output (visible rows as multisets); K3's slots of the path (read
    from its table after the apply) against the plain K3's invariants;
    K33's deletes and inserts from the own side as it was, with the
    path's key table, against the plain versions and the path's own
    side after the apply (rows, valids, live, dirty, top and key table
    exactly, chains as sets per key), errs exactly. Returns the errors,
    counts and the inputs to time."""
    side = rec["side"]
    key_idx = taps["key_indices"][side]
    pk_idx = taps["pk_indices"][side]
    ch, other, own = rec["chunk"], rec["other"], rec["own"]
    dev = ch.vis.device
    key_cols = [ch.columns[i].data for i in key_idx]
    active = ch.vis
    for i in key_idx:
        if ch.columns[i].valid is not None:
            active = active & ch.columns[i].valid
    M = taps["match_factor"] * ch.capacity
    ek = torch.zeros(4, dtype=torch.int32, device=dev)
    ep = torch.zeros(4, dtype=torch.int32, device=dev)
    cols = list(ch.columns)
    k_out = hj.probe(other, key_cols, active, cols, ch.ops, M, ek, bufs)
    p_out = hj.probe_plain(other, key_cols, active, cols, ch.ops, M, ep)
    full, ops, vis = rec["out"]
    n_own = len(cols)
    own_m, oth_m = ((full[:n_own], full[n_own:]) if side == 0
                    else (full[len(full) - n_own:], full[:len(full) - n_own]))
    rk, rp = probe_rows(*k_out), probe_rows(*p_out)
    r_path = probe_rows(own_m, oth_m, ops, vis)
    e32 = (int(rk.shape != rp.shape or not torch.equal(rk, rp))
           + int(r_path.shape != rp.shape or not torch.equal(r_path, rp))
           + exact_err([ek], [ep]))
    n_match = int(p_out[3].sum())
    # K3: the path's slots, read from its table after the apply
    after = rec["own_after"]
    slots = ht.lookup(after.key_table, key_cols, active)
    tp = ht.HashTable(tuple(k.clone() for k in own.key_table.keys),
                      own.key_table.occupied.clone())
    _, sp, np_ = ht.lookup_or_insert_plain(tp, key_cols, active)
    k3 = k3_invariants(own.key_table, key_cols, active, slots,
                       torch.zeros((), dtype=torch.int32, device=dev),
                       after.key_table, sp, np_, tp)
    # K33 from the own side as it was, with the path's key table
    _, is_ins, is_del, _ = net_pk_runs(ch, active, pk_idx, bufs)
    base = hj_clone(own)
    base.key_table = ht.HashTable(tuple(k.clone()
                                        for k in after.key_table.keys),
                                  after.key_table.occupied.clone())
    pk_chunk = [ch.columns[p].data for p in pk_idx]
    data = [c.data for c in cols]
    valids = [c.valid_mask() for c in cols]
    wk, wp = hj_clone(base), hj_clone(base)
    ek.zero_()
    ep.zero_()
    hj.delete_rows(wk, pk_chunk, pk_idx, is_del, slots, ek)
    hj.delete_rows_plain(wp, pk_chunk, pk_idx, is_del, slots, ep)
    e33d = hj_side_err(wk, wp) + exact_err([ek], [ep])
    mid = hj_clone(wk)                    # after the deletes
    victims = torch.nonzero(base.live & ~mid.live)[:, 0]
    walked = chain_walked(base, victims) if victims.numel() else 0
    hj.insert_rows(wk, is_ins, slots, data, valids, errs=ek, bufs=bufs)
    hj.insert_rows_plain(wp, is_ins, slots, data, valids, errs=ep)
    e33 = (hj_side_err(wk, wp) + hj_side_err(wk, after)
           + exact_err([ek], [ep]))
    return dict(side=side, ordinal=rec["ordinal"], rows=ch.capacity,
                active=int(active.sum()), matches=n_match,
                distinct_keys=int(torch.unique(
                    torch.stack([k.view(torch.int64) if k.dtype ==
                                 torch.float64 else k.to(torch.int64)
                                 for k in key_cols], 1)[active],
                    dim=0).shape[0]),
                deletes=int(is_del.sum()), inserts=int(is_ins.sum()),
                chain_rows_walked=walked, e32=e32, e33=e33 + e33d,
                k3_existing_rows=k3["existing_rows"],
                args=dict(other=other, key_cols=key_cols, active=active,
                          cols=cols, ops=ch.ops, M=M, base=base, mid=mid,
                          pk_chunk=pk_chunk, pk_idx=pk_idx, is_del=is_del,
                          is_ins=is_ins, slots=slots, data=data,
                          valids=valids))


def hj_rehash_replay(taps: dict, s: int, bufs) -> dict:
    """Side s's last rehash on the path (`hj_record`), again: K34's keep
    pack of the old side against its plain version, exactly; the plain
    rehash (pack, K33's inserts into the path's fresh key table) against
    the path's fresh side (`hj_side_err`); K34's stats of the fresh side
    against the plain counts."""
    rec = taps["rehash"][s]
    old, fresh = rec["old"], rec["fresh"]
    a = hj.pack(old, hj.PACK_KEEP, bufs=bufs)
    b = hj.pack_plain(old, hj.PACK_KEEP)
    e = pack_err(a, b, hj.PACK_KEEP)
    cols, vals, _, live, dirty, n = b
    re = hj.empty_side(fresh.key_capacity, fresh.row_capacity,
                       taps["key_dtypes"], taps["col_dtypes"][s],
                       old.device)
    re.key_table = ht.HashTable(tuple(k.clone()
                                      for k in fresh.key_table.keys),
                                fresh.key_table.occupied.clone())
    slots = ht.lookup(re.key_table, [cols[i] for i in
                                     taps["key_indices"][s]], live)
    hj.insert_rows_plain(re, live, slots, cols, vals, dirty_vals=dirty)
    hj.insert_rows_plain(re, ~live & dirty, None, cols, None,
                         live_val=False)
    e += hj_side_err(re, fresh)
    e += exact_err([hj.side_stats(fresh)], [hj.side_stats_plain(fresh)])
    return dict(err=e, rows=int(n), old_row_capacity=old.row_capacity,
                old_key_capacity=old.key_capacity,
                row_capacity=fresh.row_capacity,
                key_capacity=fresh.key_capacity, old=old)


def phase_kernels_hash_join_path(dev, taps: dict, rtaps: dict) -> dict:
    """K32, K33 and K34 on the work hj_full's and hj_retract's joins did
    (`hj_record` in their unprofiled runs): each kept apply again from
    the sides as they were (`hj_replay`: the kernels, their plain
    versions and the path's own output and state agree) and each side's
    last rehash (`hj_rehash_replay`). The kernels line's rows are timed
    here: K32 and K33's insert on hj_full's last bid chunk (16384 rows
    probing the 141,312-row auction side, inserted into the bid side),
    K34's keep pack on the bid side's last rehash; extra figures: K32 on
    the last auction chunk (512 rows along the bid side's chains), K33's
    deletes on hj_retract's kept chunks (U- rows walking their chains)."""
    d = torch.device(dev)
    bufs = _Buffers(d)
    out, res = {}, {}
    err = 0
    reps = {}
    for name, t in (("hj_full", taps), ("hj_retract", rtaps)):
        if not t.get("kept"):
            raise AssertionError(f"kernels_hash_join_path: {name} kept no "
                                 "apply")
        reps[name] = [hj_replay(t, rec, bufs) for rec in t["kept"]]
        err += sum(r["e32"] + r["e33"] for r in reps[name])
        out[name] = dict(
            applies=len(t["applies"]),
            chunk_rows=sorted({n for _, n in t["applies"]}),
            kept=[{k: v for k, v in r.items() if k != "args"}
                  for r in reps[name]])
    rh = {s: hj_rehash_replay(taps, s, bufs) for s in sorted(taps["rehash"])}
    err += sum(r["err"] for r in rh.values())
    out["hj_full"]["rehash"] = {s: {k: v for k, v in r.items() if k != "old"}
                                for s, r in rh.items()}
    torch.cuda.synchronize()
    if err:
        raise AssertionError(f"hash join kernels differ on the path's own "
                             f"work: {out}")
    ek = torch.zeros(4, dtype=torch.int32, device=d)
    ep = torch.zeros(4, dtype=torch.int32, device=d)

    def k32_time(r):
        a = r["args"]
        tm = timings(lambda: hj.probe(a["other"], a["key_cols"],
                                      a["active"], a["cols"], a["ops"],
                                      a["M"], ek, bufs),
                     lambda: hj.probe_plain(a["other"], a["key_cols"],
                                            a["active"], a["cols"],
                                            a["ops"], a["M"], ep))
        n_bytes = k32_bytes(r["rows"], r["distinct_keys"], r["matches"],
                            _row_bytes([c.data for c in a["cols"]]),
                            _row_bytes(a["other"].rows), len(a["cols"]),
                            len(a["other"].rows), a["M"])
        return dict(tm, n_bytes=n_bytes, bound_ms=bytes_bound_ms(n_bytes))

    full = reps["hj_full"]
    last_bid = max((r for r in full if r["side"] == 0),
                   key=lambda r: r["ordinal"])
    last_auc = max((r for r in full if r["side"] == 1),
                   key=lambda r: r["ordinal"])
    t32 = k32_time(last_bid)
    out["k32_bid_chunk"] = dict(t32, rows=last_bid["rows"],
                                matches=last_bid["matches"],
                                other_rows=int(last_bid["args"]["other"]
                                               .live.sum()))
    out["k32_auction_chunk"] = dict(
        k32_time(last_auc), rows=last_auc["rows"],
        matches=last_auc["matches"],
        other_rows=int(last_auc["args"]["other"].live.sum()))
    res["hash_join_probe"] = dict(
        max_abs_err=err, ms=t32["ms"], plain_ms=t32["plain_ms"],
        bound_ms=t32["bound_ms"], bound_by="bytes", library_ms=None)
    # K33's insert of the last bid chunk, from the side after its deletes
    a = last_bid["args"]
    work = hj_clone(a["mid"])
    tmi = timings(lambda: hj.insert_rows(work, a["is_ins"], a["slots"],
                                         a["data"], a["valids"], errs=ek,
                                         bufs=bufs),
                  lambda: hj.insert_rows_plain(work, a["is_ins"], a["slots"],
                                               a["data"], a["valids"],
                                               errs=ep),
                  setup=lambda: hj_restore(work, a["mid"]))
    row_b = _row_bytes(work.rows) + len(work.rows)
    ib = k33_insert_bytes(last_bid["rows"], last_bid["inserts"], row_b)
    out["k33_insert"] = dict(tmi, rows=last_bid["rows"],
                             inserts=last_bid["inserts"], n_bytes=ib,
                             bound_ms=bytes_bound_ms(ib),
                             store_rows=int(a["mid"].live.sum()),
                             row_capacity=a["mid"].row_capacity)
    res["hash_join_update"] = dict(
        max_abs_err=err, ms=tmi["ms"], plain_ms=tmi["plain_ms"],
        bound_ms=bytes_bound_ms(ib), bound_by="bytes", library_ms=None)
    # K33's deletes on hj_retract's kept chunks
    out["k33_delete"] = []
    for r in reps["hj_retract"]:
        a = r["args"]
        work = hj_clone(a["base"])
        tmd = timings(lambda: hj.delete_rows(work, a["pk_chunk"], a["pk_idx"],
                                             a["is_del"], a["slots"], ek),
                      lambda: hj.delete_rows_plain(work, a["pk_chunk"],
                                                   a["pk_idx"], a["is_del"],
                                                   a["slots"], ep),
                      setup=lambda: hj_restore(work, a["base"]))
        pk_b = _row_bytes(a["pk_chunk"])
        db = (r["rows"] * (pk_b + 4 + 1 + 4)
              + r["chain_rows_walked"] * (4 + 1 + pk_b) + r["deletes"] * 2)
        out["k33_delete"].append(dict(tmd, rows=r["rows"],
                                      deletes=r["deletes"],
                                      chain_rows_walked=r["chain_rows_walked"],
                                      n_bytes=db,
                                      bound_ms=bytes_bound_ms(db)))
    # K34's keep pack of the bid side's last rehash
    old = rh[0]["old"]
    n_keep = rh[0]["rows"]
    pb = k34_bytes(old.row_capacity, n_keep, row_b, len(old.rows),
                   hj.PACK_KEEP)

    def library():
        idx = torch.nonzero(old.live | old.dirty)[:, 0]
        return [r_.index_select(0, idx) for r_ in old.rows]

    t34 = timings(lambda: hj.pack(old, hj.PACK_KEEP, bufs=bufs),
                  lambda: hj.pack_plain(old, hj.PACK_KEEP),
                  library_fn=library)
    out["k34_keep"] = dict(t34, rows=n_keep, row_capacity=old.row_capacity,
                           n_bytes=pb, bound_ms=bytes_bound_ms(pb))
    res["hash_join_pack"] = dict(
        max_abs_err=err, ms=t34["ms"], plain_ms=t34["plain_ms"],
        library_ms=t34["library_ms"], bound_ms=bytes_bound_ms(pb),
        bound_by="bytes")
    emit({"phase": "kernels_hash_join_path", **out})
    return res


def phase_kernels_hash_join(dev, n_side: int = 1 << 21,
                            N: int = 131072) -> None:
    """K32, K33 and K34 against their plain versions on the card at
    larger shapes than hj_full's (whose own work
    `phase_kernels_hash_join_path` checks and times for the kernels
    line), and K3's float64 mode (`k3_float64_checks`): a 131072-row bid
    chunk probing a 2^21-row auction side (2^22 keys and rows) and, the
    other way, a 131072-row auction chunk probing a 2^21-row bid side
    (its chains as long as an auction's bids); K33 inserting that bid
    chunk into the bid side and deleting 131072 of its rows; K34's keep,
    dirty and evict packs of the 2^21-row bid side. Exact: output rows
    as multisets, stores slot for slot (chains as sets per key), errs.
    Emits its figures; returns nothing."""
    out = {}
    d = torch.device(dev)
    out["k3_float64"] = k3_float64_checks(d)
    # ---- K32: a bid chunk probing the auction side
    aside = hj_auction_side(dev, n_side, 1 << 22, 1 << 22)
    auction, bidder, price = bid_cols_dev(N, dev)
    bcols = [Column(auction.double()), Column(auction), Column(bidder),
             Column(price),
             Column(torch.arange(N, dtype=torch.int64, device=dev))]
    bops = torch.zeros(N, dtype=torch.int8, device=dev)
    bops[1::7] = 1                               # a few Deletes
    bact = torch.ones(N, dtype=torch.bool, device=dev)
    M = 64 * N
    bufs = _Buffers(d)
    ek = torch.zeros(4, dtype=torch.int32, device=dev)
    ep = torch.zeros(4, dtype=torch.int32, device=dev)
    k_out = hj.probe(aside, [bcols[0].data], bact, bcols, bops, M, ek, bufs)
    p_out = hj.probe_plain(aside, [bcols[0].data], bact, bcols, bops, M, ep)
    rk, rp = probe_rows(*k_out), probe_rows(*p_out)
    e32 = (int(rk.shape != rp.shape or not torch.equal(rk, rp))
           + exact_err([ek], [ep]))
    n_match = int(k_out[3].sum())
    n_keys = int(torch.unique(auction).numel())
    b32 = k32_bytes(N, n_keys, n_match, _row_bytes([c.data for c in bcols]),
                    _row_bytes(aside.rows), len(bcols), len(aside.rows), M)
    tm = timings(lambda: hj.probe(aside, [bcols[0].data], bact, bcols, bops,
                                  M, ek, bufs),
                 lambda: hj.probe_plain(aside, [bcols[0].data], bact, bcols,
                                        bops, M, ep))
    out["k32_bid_chunk"] = dict(max_abs_err=e32, matches=n_match,
                                distinct_keys=n_keys, n_bytes=b32,
                                bound_ms=bytes_bound_ms(b32), **tm)
    del aside
    # ---- K32 the other way: auctions probing the bid side's chains
    bside = hj_bid_side(dev, n_side, 1 << 22, 1 << 22)
    aid, reserve, seller = auction_cols_dev(N, dev, (0, 4, 7))
    acols = [Column(aid.double()), Column(seller), Column(reserve),
             Column(torch.arange(N, dtype=torch.int64, device=dev))]
    aops = torch.zeros(N, dtype=torch.int8, device=dev)
    ek.zero_()
    ep.zero_()
    k_out = hj.probe(bside, [acols[0].data], bact, acols, aops, M, ek, bufs)
    p_out = hj.probe_plain(bside, [acols[0].data], bact, acols, aops, M, ep)
    rk, rp = probe_rows(*k_out), probe_rows(*p_out)
    e32b = (int(rk.shape != rp.shape or not torch.equal(rk, rp))
            + exact_err([ek], [ep]))
    ms_b, _ = time_ms(lambda: hj.probe(bside, [acols[0].data], bact, acols,
                                       aops, M, ek, bufs), reps=5)
    counts = torch.bincount(bside.rows[1][:n_side] - 1000)
    out["k32_auction_chunk"] = dict(
        max_abs_err=e32b, matches=int(k_out[3].sum()), ms=ms_b,
        longest_chain=int(counts.max()))
    # ---- K33: insert a bid chunk, delete stored bids
    nb_auction, nb_bidder, nb_price = bid_cols_dev(N, dev, start=n_side)
    icols = [nb_auction.double(), nb_auction, nb_bidder, nb_price,
             torch.arange(n_side, n_side + N, dtype=torch.int64,
                          device=dev)]
    ivalid = [bact] * len(icols)
    base = hj_clone(bside)
    _, islots, _ = ht.lookup_or_insert(base.key_table, [icols[0]], bact)
    sk, sp = hj_clone(base), hj_clone(base)
    ek.zero_()
    ep.zero_()
    hj.insert_rows(sk, bact, islots, icols, ivalid, errs=ek, bufs=bufs)
    hj.insert_rows_plain(sp, bact, islots, icols, ivalid, errs=ep)
    e33i = hj_side_err(sk, sp) + exact_err([ek], [ep])
    g = torch.Generator(device="cpu").manual_seed(33)
    victims = torch.randperm(n_side, generator=g)[:N].to(dev)
    dpk = [bside.rows[4][victims]]
    dkey = bside.rows[0][victims].contiguous()
    _, dslots, _ = ht.lookup_or_insert(base.key_table, [dkey], bact)
    dk, dp = hj_clone(base), hj_clone(base)
    hj.delete_rows(dk, dpk, (4,), bact, dslots, ek)
    hj.delete_rows_plain(dp, dpk, (4,), bact, dslots, ep)
    e33d = hj_side_err(dk, dp) + exact_err([ek], [ep])
    e33 = e33i + e33d
    work = hj_clone(base)
    row_b = _row_bytes(base.rows) + len(base.rows)
    k33i_bytes = k33_insert_bytes(N, N, row_b)
    tmi = timings(lambda: hj.insert_rows(work, bact, islots, icols, ivalid,
                                         errs=ek, bufs=bufs),
                  lambda: hj.insert_rows_plain(work, bact, islots, icols,
                                               ivalid, errs=ep),
                  setup=lambda: hj_restore(work, base))
    # a delete reads its pk, slot and mask, then its chain up to its
    # victim (next, live and pk a row: on average half of its key's
    # bids) and writes the victim's live and dirty bytes
    per_key = counts[(dkey.long() - 1000)].double()
    visited = int((per_key / 2).sum())
    k33d_bytes = N * (8 + 4 + 1 + 4) + visited * (4 + 1 + 8) + N * 2
    tmd = timings(lambda: hj.delete_rows(work, dpk, (4,), bact, dslots, ek),
                  lambda: hj.delete_rows_plain(work, dpk, (4,), bact,
                                               dslots, ep),
                  setup=lambda: hj_restore(work, base))
    out["k33_insert"] = dict(max_abs_err=e33i, rows=N, n_bytes=k33i_bytes,
                             bound_ms=bytes_bound_ms(k33i_bytes), **tmi)
    out["k33_delete"] = dict(max_abs_err=e33d, rows=N,
                             chain_rows_visited=visited,
                             n_bytes=k33d_bytes,
                             bound_ms=bytes_bound_ms(k33d_bytes), **tmd)
    # ---- K34: packs of the bid side after the insert and the deletes
    hj_restore(work, sk)
    hj.delete_rows(work, dpk, (4,), bact, dslots, ek)
    e34 = 0
    cases = {"keep": (hj.PACK_KEEP, None, None),
             "dirty": (hj.PACK_DIRTY, None, None),
             "evict": (hj.PACK_EVICT, 4, n_side // 2)}
    for name, (mode, col_, wm) in cases.items():
        a = hj.pack(work, mode, col_, wm, bufs)
        b = hj.pack_plain(work, mode, col_, wm)
        n_ = int(b[5])
        e = pack_err(a, b, mode)
        n_bytes = k34_bytes(work.row_capacity, n_, row_b, len(work.rows),
                            mode)
        mask = {hj.PACK_KEEP: lambda: work.live | work.dirty,
                hj.PACK_DIRTY: lambda: work.dirty,
                hj.PACK_EVICT: lambda: work.live & (work.rows[4] < wm)}[mode]

        def library():
            idx = torch.nonzero(mask())[:, 0]
            return [r.index_select(0, idx) for r in work.rows]

        tm4 = timings(lambda: hj.pack(work, mode, col_, wm, bufs),
                      lambda: hj.pack_plain(work, mode, col_, wm),
                      library_fn=library)
        out[f"k34_{name}"] = dict(max_abs_err=e, rows=n_, n_bytes=n_bytes,
                                  bound_ms=bytes_bound_ms(n_bytes), **tm4)
        e34 += e
    st_k, st_p = hj.side_stats(work), hj.side_stats_plain(work)
    e34 += exact_err([st_k], [st_p])
    torch.cuda.synchronize()
    if e32 or e32b or e33 or e34:
        raise AssertionError(f"hash join kernels disagree with their plain "
                             f"versions: K32 {e32}/{e32b}, K33 {e33i}/"
                             f"{e33d}, K34 {e34}")
    emit({"phase": "kernels_hash_join", **out})


def main(argv) -> int:
    unknown = [a for a in argv if a not in ("--host-profile",
                                            "--mvmv-sizing")]
    if unknown:
        print(f"chip_smoke: unknown arguments {unknown}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    build_s = kernels.build_all()
    logs = {k.name: [ln for ln in k.log_path.read_text().splitlines()
                     if "registers" in ln or "spill" in ln][:6]
            for k in kernels.KERNELS.values() if k.log_path.exists()}
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "build_s": build_s,
          "ptxas": logs})
    if "--mvmv-sizing" in argv:
        mvmv_sizing(dev, smi)
        return 0
    res = phase_kernels(dev)
    res.update(phase_kernels_q7(dev))
    q5 = phase_q5_full(dev)
    emit({"phase": "q5_full", "nvidia_smi": smi, **q5})
    emit({"phase": "q5_profile",
          **phase_q5_profile(dev, q5, host="--host-profile" in argv)})
    mv = phase_q5_mv(dev)
    emit({"phase": "q5_mv", **mv})
    q7 = phase_q7_full(dev)
    emit({"phase": "q7_full", "nvidia_smi": smi, **q7})
    emit({"phase": "q7_profile", **phase_q7_profile(dev, q7)})
    emit({"phase": "q7_check", **phase_q7_check(dev)})
    res.update(phase_kernels_q7d(dev))
    q7d = phase_q7d_full(dev)
    emit({"phase": "q7d_full", "nvidia_smi": smi, **q7d})
    emit({"phase": "q7d_recover", "nvidia_smi": smi,
          **phase_q7d_recover(dev)})
    res.update(phase_kernels_q8(dev))
    q8 = phase_q8_full(dev)
    emit({"phase": "q8_full", "nvidia_smi": smi, **q8})
    emit({"phase": "q8_profile", **phase_q8_profile(dev, q8)})
    emit({"phase": "q8_check", **phase_q8_check(dev)})
    res.update(phase_kernels_q17(dev))
    q17 = phase_q17_full(dev)
    emit({"phase": "q17_full", "nvidia_smi": smi, **q17})
    emit({"phase": "q17_profile", **phase_q17_profile(dev, q17)})
    emit({"phase": "q17_sf1", "nvidia_smi": smi, **phase_q17_sf1(dev)})
    emit({"phase": "q17_check", **phase_q17_check(dev)})
    emit({"phase": "q1_full", "nvidia_smi": smi, **phase_q1_full(dev)})
    res.update(phase_kernels_topn(dev))
    q5t = phase_q5_topn_full(dev)
    emit({"phase": "q5_topn_full", "nvidia_smi": smi, **q5t})
    emit({"phase": "q5_topn_profile", "nvidia_smi": smi,
          **phase_q5_topn_profile(dev, q5t)})
    emit({"phase": "q5_topn_check", "nvidia_smi": smi,
          **phase_q5_topn_check(dev)})
    q2 = phase_q2_full(dev)
    emit({"phase": "q2_full", "nvidia_smi": smi, **q2})
    emit({"phase": "topn_recover", "nvidia_smi": smi,
          **phase_topn_recover(dev)})
    res.update(phase_kernels_window(dev))
    q6 = phase_q6_full(dev)
    emit({"phase": "q6_full", "nvidia_smi": smi, **q6})
    emit({"phase": "q6_profile", "nvidia_smi": smi,
          **phase_q6_profile(dev, q6)})
    emit({"phase": "q6_check", "nvidia_smi": smi, **phase_q6_check(dev)})
    emit({"phase": "q4_full", "nvidia_smi": smi, **phase_q4_full(dev)})
    emit({"phase": "eowc_full", "nvidia_smi": smi, **phase_eowc_full(dev)})
    gagg = phase_global_agg(dev)
    emit({"phase": "global_agg", "nvidia_smi": smi, **gagg})
    emit({"phase": "q6_recover", "nvidia_smi": smi,
          **phase_q6_recover(dev)})
    res.update(phase_kernels_extrema(dev))
    q5c = phase_q5c_full(dev)
    emit({"phase": "q5c_full", "nvidia_smi": smi, **q5c})
    emit({"phase": "q5c_profile", "nvidia_smi": smi,
          **phase_q5c_profile(dev, q5c)})
    emit({"phase": "q5c_check", "nvidia_smi": smi, **phase_q5c_check(dev)})
    emit({"phase": "q5c_recover", "nvidia_smi": smi,
          **phase_q5c_recover(dev)})
    emit({"phase": "q5_sql", "nvidia_smi": smi, **phase_q5_sql(dev)})
    res.update(phase_kernels_outer(dev))
    lj = phase_lj_full(dev)
    emit({"phase": "lj_full", "nvidia_smi": smi, **lj})
    emit({"phase": "lj_retract", "nvidia_smi": smi,
          **phase_lj_retract(dev)})
    emit({"phase": "fj_check", "nvidia_smi": smi, **phase_fj_check(dev)})
    emit({"phase": "tj_full", "nvidia_smi": smi, **phase_tj_full(dev)})
    dynf = phase_dynf(dev)
    emit({"phase": "dynf", "nvidia_smi": smi, **dynf})
    emit({"phase": "lj_recover", "nvidia_smi": smi,
          **phase_lj_recover(dev)})
    res.update(phase_kernels_hll(dev))
    phase_kernels_wide(dev)
    emit({"phase": "kernels_expr", "nvidia_smi": smi,
          **phase_kernels_expr(dev)})
    emit({"phase": "q3_full", "nvidia_smi": smi, **phase_q3_full(dev)})
    emit({"phase": "q14_full", "nvidia_smi": smi, **phase_q14_full(dev)})
    emit({"phase": "q15_full", "nvidia_smi": smi, **phase_q15_full(dev)})
    acd = phase_acd_full(dev)
    emit({"phase": "acd_full", "nvidia_smi": smi, **acd})
    emit({"phase": "strings_full", "nvidia_smi": smi,
          **phase_strings_full(dev)})
    emit({"phase": "acd_recover", "nvidia_smi": smi,
          **phase_acd_recover(dev)})
    emit({"phase": "queue_c", "nvidia_smi": smi, **phase_queue_c(dev)})
    res.update(phase_kernels_backfill(dev))
    k31_taps = {}
    mvmv = phase_mvmv_full(dev, k31_taps=k31_taps)
    emit({"phase": "mvmv_full", "nvidia_smi": smi, **mvmv})
    res.update(phase_kernels_backfill_path(dev, k31_taps))
    emit({"phase": "mvmv_check", "nvidia_smi": smi,
          **phase_mvmv_check(dev)})
    emit({"phase": "mvmv_recover", "nvidia_smi": smi,
          **phase_mvmv_recover(dev)})
    phase_kernels_hash_join(dev)
    hj_taps, hjr_taps = {}, {}
    hjf = phase_hj_full(dev, taps=hj_taps)
    emit({"phase": "hj_full", "nvidia_smi": smi, **hjf})
    emit({"phase": "hj_retract", "nvidia_smi": smi,
          **phase_hj_retract(dev, taps=hjr_taps)})
    res.update(phase_kernels_hash_join_path(dev, hj_taps, hjr_taps))
    del hj_taps, hjr_taps
    emit({"phase": "hj_recover", "nvidia_smi": smi,
          **phase_hj_recover(dev)})
    paths = {"q5": q5, "q7": q7, "q8": q8, "q17": q17, "q7d": q7d,
             "q5t": q5t, "q2": q2, "q6": q6, "gagg": gagg, "q5c": q5c,
             "lj": lj, "dynf": dynf, "acd": acd, "mvmv": mvmv, "hj": hjf}
    rows = []
    for name, k in kernels.KERNELS.items():
        r = res[name]
        # each kernel's launches come from the run of its own slice's path
        path = paths[KERNEL_PATH[name]]
        rows.append({
            "name": name, "route": "cuda",
            "source": str(k.source.relative_to(
                os.path.dirname(os.path.abspath(__file__)))),
            "replaces": k.replaces, "launches": path["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
