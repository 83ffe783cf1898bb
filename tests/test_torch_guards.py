"""Guards of the port's boundary: it never imports JAX or the JAX
package, its entry points default to the CUDA device, and asking for
that device without a card raises instead of running on the CPU."""

import inspect
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def _port():
    """Import torch and the port when these tests run, not at collection:
    an xdist worker then runs the JAX tests before them without torch
    (the sharded-join recovery tests abort more often with it loaded)."""
    global torch
    import torch


PORT = pathlib.Path(__file__).resolve().parent.parent / "risingwave_tpu_torch"

MODULES = [
    "risingwave_tpu_torch", "risingwave_tpu_torch.common",
    "risingwave_tpu_torch.connectors", "risingwave_tpu_torch.expr.agg",
    "risingwave_tpu_torch.ops.hash_table", "risingwave_tpu_torch.ops.kernels",
    "risingwave_tpu_torch.state", "risingwave_tpu_torch.stream",
    "risingwave_tpu_torch.meta", "risingwave_tpu_torch.interop",
    "risingwave_tpu_torch.expr.program", "risingwave_tpu_torch.expr.registry",
    "risingwave_tpu_torch.expr.functions",
    "risingwave_tpu_torch.expr.strings", "risingwave_tpu_torch.expr.hll",
    "risingwave_tpu_torch.expr.transforms",
    "risingwave_tpu_torch.stream.project", "risingwave_tpu_torch.stream.misc",
    "risingwave_tpu_torch.stream.row_id", "risingwave_tpu_torch.stream.exchange",
    "risingwave_tpu_torch.stream.align",
    "risingwave_tpu_torch.stream.sorted_join",
    "risingwave_tpu_torch.ops.sort",
    "risingwave_tpu_torch.frontend",
    "risingwave_tpu_torch.frontend.sql",
    "risingwave_tpu_torch.frontend.binder",
    "risingwave_tpu_torch.frontend.session", "risingwave_tpu_torch.plan",
    "risingwave_tpu_torch.plan.graph", "risingwave_tpu_torch.plan.build",
    "risingwave_tpu_torch.connectors.tpch",
    "risingwave_tpu_torch.stream.snapshot_join_agg",
    "risingwave_tpu_torch.stream.sorted_store",
    "risingwave_tpu_torch.stream.retract_top_n",
    "risingwave_tpu_torch.state.storage_table",
    "risingwave_tpu_torch.stream.general_over_window",
    "risingwave_tpu_torch.stream.eowc_over_window",
    "risingwave_tpu_torch.stream.simple_agg",
    "risingwave_tpu_torch.ops.extrema",
    "risingwave_tpu_torch.stream.dynamic",
]


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import json, sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "print(json.dumps(sorted(m for m in sys.modules if m == 'jax'"
              " or m.startswith('jax.') or m == 'risingwave_tpu'"
              " or m.startswith('risingwave_tpu.'))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(PORT.parent))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_collecting_the_port_tests_loads_no_torch():
    """pytest imports every test module to collect it; the port's test
    files leave torch and the port to their `_port` fixtures."""
    code = ("import importlib.util, json, pathlib, sys\n"
            "sys.path[:0] = ['.', 'tests']\n"
            "for p in sorted(pathlib.Path('tests').glob('test_torch_*')):\n"
            "    s = importlib.util.spec_from_file_location(p.stem, p)\n"
            "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "print(json.dumps(sorted(m for m in sys.modules"
            " if m in ('torch', 'chip_smoke')"
            " or m.startswith('risingwave_tpu_torch'))))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(PORT.parent),
                         env=env)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_port_sources_name_no_jax_import():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax)\b|"
                     r"\brisingwave_tpu\.(?!_)", re.M)
    offenders = []
    for p in sorted(PORT.rglob("*.py")):
        for m in pat.finditer(p.read_text()):
            offenders.append(f"{p.relative_to(PORT)}: {m.group(0).strip()}")
    assert not offenders, offenders
    assert len(list(PORT.rglob("*.py"))) > 20


def _entry_points():
    from risingwave_tpu_torch.connectors.nexmark import NexmarkGenerator
    from risingwave_tpu_torch.connectors.tpch import TpchGenerator
    from risingwave_tpu_torch.device import resolve_device
    from risingwave_tpu_torch.frontend import Session
    from risingwave_tpu_torch.interop import (
        agg_state_from_numpy, chunk_from_numpy, hash_table_from_numpy,
        sorted_side_from_numpy)
    from risingwave_tpu_torch.stream.hash_agg import HashAggExecutor
    from risingwave_tpu_torch.stream.snapshot_join_agg import (
        SnapshotJoinAggExecutor)
    from risingwave_tpu_torch.stream.retract_top_n import (
        RetractableTopNExecutor)
    from risingwave_tpu_torch.stream.sorted_join import SortedJoinExecutor
    from risingwave_tpu_torch.stream import (
        DynamicFilterExecutor, EowcOverWindowExecutor,
        GeneralOverWindowExecutor, NowExecutor, SimpleAggExecutor)
    return [NexmarkGenerator.__init__, HashAggExecutor.__init__,
            DynamicFilterExecutor.__init__, NowExecutor.__init__,
            SortedJoinExecutor.__init__, resolve_device, chunk_from_numpy,
            hash_table_from_numpy, agg_state_from_numpy,
            sorted_side_from_numpy, Session.__init__,
            TpchGenerator.__init__, SnapshotJoinAggExecutor.__init__,
            RetractableTopNExecutor.__init__,
            GeneralOverWindowExecutor.__init__,
            EowcOverWindowExecutor.__init__, SimpleAggExecutor.__init__]


def test_entry_points_default_to_cuda():
    for fn in _entry_points():
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_cuda_without_a_card_raises():
    from risingwave_tpu_torch.common import DataType
    from risingwave_tpu_torch.common import schema as make_schema
    from risingwave_tpu_torch.connectors import nexmark as nx
    from risingwave_tpu_torch.connectors import tpch
    from risingwave_tpu_torch.connectors.nexmark import NexmarkGenerator
    from risingwave_tpu_torch.expr import lit
    from risingwave_tpu_torch.expr.agg import count_star
    from risingwave_tpu_torch.frontend import Session
    from risingwave_tpu_torch.interop import (
        agg_state_from_numpy, chunk_from_numpy, hash_table_from_numpy,
        sorted_side_from_numpy)
    from risingwave_tpu_torch.stream.hash_agg import HashAggExecutor
    from risingwave_tpu_torch.stream.snapshot_join_agg import (
        SnapshotJoinAggExecutor)
    from risingwave_tpu_torch.stream.retract_top_n import (
        RetractableTopNExecutor)
    from risingwave_tpu_torch.stream.sorted_join import SortedJoinExecutor
    from risingwave_tpu_torch.stream import (
        DynamicFilterExecutor, EowcOverWindowExecutor,
        GeneralOverWindowExecutor, NowExecutor, SimpleAggExecutor,
        WindowSpec)

    class _In:
        schema = make_schema(("k", DataType.INT64))
        pk_indices = ()

    def card_vocabs():
        """The vocabulary id tables on the card; none without one (the
        generators refuse the device before they read them)."""
        if not torch.cuda.is_available():
            return {}
        return {k: torch.tensor(v, dtype=torch.int32, device="cuda")
                for k, v in nx.vocab_ids().items()}

    keys, occupied = [np.arange(4, dtype=np.int64)], np.ones(4, bool)
    builders = [
        lambda: NexmarkGenerator("bid", chunk_size=64).device,
        lambda: HashAggExecutor(_In(), [0], [count_star()],
                                capacity=64).device,
        lambda: chunk_from_numpy(_In.schema, keys, np.zeros(4, np.int8),
                                 occupied).device,
        lambda: hash_table_from_numpy(keys, occupied).device,
        lambda: agg_state_from_numpy(
            keys, occupied, [np.zeros(4, np.int64)], np.ones(4, np.int64),
            occupied, occupied, [np.zeros(4, np.int64)]).row_count.device,
        lambda: SortedJoinExecutor(_In(), _In(), [0], [0], [0], [0],
                                   capacity=64).device,
        lambda: sorted_side_from_numpy(keys[0], keys, [occupied],
                                       np.zeros(4, np.int32), 4).n.device,
        lambda: Session().device,
        lambda: nx.gen_person_columns(0, 8, nx.NexmarkConfig(),
                                      card_vocabs(), "cuda")[0].device,
        lambda: nx.gen_auction_columns(0, 8, nx.NexmarkConfig(),
                                       card_vocabs(), "cuda")[0].device,
        lambda: tpch.TpchGenerator("lineitem", chunk_size=64).device,
        lambda: SnapshotJoinAggExecutor(
            _In(), _In(), fact_key=0, dim_key=0, sub_agg_calls=[],
            sub_items=[], residue=None, final_agg_calls=[count_star(True)],
            final_items=[lit(1)], out_names=["n"],
            out_types=[DataType.INT64], capacity=64).device,
        lambda: RetractableTopNExecutor(_In(), (), order_col=0, limit=1,
                                        capacity=64).device,
        lambda: GeneralOverWindowExecutor(
            _In(), (), [(0, False)], [WindowSpec("row_number")],
            capacity=64).device,
        lambda: EowcOverWindowExecutor(
            _In(), (), [(0, False)], [WindowSpec("row_number")],
            capacity=64).device,
        lambda: SimpleAggExecutor(_In(), [count_star()]).device,
        lambda: SortedJoinExecutor(_In(), _In(), [0], [0], [0], [0],
                                   capacity=64, join_type="full").device,
        lambda: SortedJoinExecutor(_In(), _In(), [0], [0], [0], [0],
                                   capacity=64, join_type="left",
                                   temporal=True).device,
        lambda: DynamicFilterExecutor(_In(), _In(), 0, capacity=64).device,
        lambda: NowExecutor(None).device,
    ]
    for build in builders:
        if torch.cuda.is_available():
            assert build().type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build()


def test_every_kernel_is_registered_with_its_source():
    import chip_smoke  # noqa: F401  (imports every wrapper module)
    from risingwave_tpu_torch.ops import kernels
    names = sorted(kernels.KERNELS)
    assert names == ["agg_flush", "backfill_filter", "compact",
                     "dynamic_filter", "expr_eval",
                     "extrema_update", "filter_ops", "hash_agg",
                     "hash_table", "hll_update", "hop_window",
                     "nexmark_auction",
                     "nexmark_bid", "nexmark_person", "outer_join",
                     "persist_view",
                     "pk_net", "radix_sort", "row_id", "segment_agg",
                     "simple_agg", "snapshot_append", "snapshot_diff",
                     "snapshot_final", "sorted_join_merge",
                     "sorted_join_probe", "top_n_diff", "top_n_rank",
                     "tpch", "window_diff", "window_scan"]
    for k in kernels.KERNELS.values():
        assert k.source.exists()
        src = k.source.read_text()
        for fn in k.functions:
            assert f'extern "C" int {fn}(' in src
        path, line = k.replaces.rsplit(":", 1)
        ref = PORT.parent / path
        assert ref.exists() and int(line) > 0


def test_wrappers_refuse_other_devices():
    from risingwave_tpu_torch.common.chunk import Column
    from risingwave_tpu_torch.expr import ExprProgram, call, col, lit
    from risingwave_tpu_torch.ops import hash_table as ht
    from risingwave_tpu_torch.connectors import tpch
    from risingwave_tpu_torch.expr.agg import count_star
    from risingwave_tpu_torch.stream import row_id, sorted_join as sj
    from risingwave_tpu_torch.stream import snapshot_join_agg as sja
    from risingwave_tpu_torch.stream import project
    from risingwave_tpu_torch.common import vnode
    from risingwave_tpu_torch.stream import retract_top_n as rtn
    from risingwave_tpu_torch.stream import general_over_window as gow
    from risingwave_tpu_torch.stream import simple_agg as sagg
    from risingwave_tpu_torch.stream import hash_agg
    from risingwave_tpu_torch.ops import extrema
    from risingwave_tpu_torch.stream import dynamic
    from risingwave_tpu_torch.expr import hll
    from risingwave_tpu_torch.common.chunk import StreamChunk
    from risingwave_tpu_torch.common import DataType, schema
    t = ht.HashTable.empty(32, [torch.int64], "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ht.lookup_or_insert(t, [torch.zeros(4, dtype=torch.int64,
                                            device="meta")],
                            torch.ones(4, dtype=torch.bool, device="meta"))
    meta = dict(device="meta")
    i64 = torch.zeros(4, dtype=torch.int64, **meta)
    b = torch.ones(4, dtype=torch.bool, **meta)
    prog = ExprProgram([call("add", col(0), lit(1))])
    side = sj.empty_sorted_side(32, [torch.int64], "meta")
    errs = torch.zeros(3, dtype=torch.int32, **meta)
    refusals = [
        lambda: prog.eval([Column(i64)]),
        lambda: ExprProgram([call("equal", col(0), lit(1))]).and_into(
            [Column(i64)], b.clone()),
        lambda: row_id.row_ids(0, 4, "meta"),
        lambda: sj.probe([i64], b, b, i64.to(torch.int8), side, (0,),
                         [Column(i64)], 8, errs),
        lambda: sj.merge(side, i64, i64, errs[0], [Column(i64)], None,
                         None, 8, (0,), None, 0, errs, side),
        lambda: tpch.gen_tpch_columns("part", 0, 4, i64, i64, "meta"),
        lambda: sja.append_rows([i64.clone()], [None], errs[0], errs, [i64],
                                [None], b, i64.to(torch.int8)),
        lambda: sja.sort_keys(i64, None, errs[0]),
        lambda: sja.take_rows([i64], [None], i64),
        lambda: sja.segment_reduce(i64, i64, errs[0], None, [], [], []),
        lambda: sja.final_reduce(i64, i64, errs[0], i64, errs[0], None,
                                 errs, [], [count_star(True)], [], []),
        lambda: sja.final_diff([Column(i64[:1])], [i64[0]], [b[0]], b[0]),
        lambda: project.filter_fixup(b, None, i64.to(torch.int8), b),
        lambda: vnode.compute_vnodes([i64]),
        lambda: vnode.backfill_filter([i64], [i64], (0,), 0, True, b),
        lambda: sj.net_pk_runs(StreamChunk(
            (Column(i64),), i64.to(torch.int8), b,
            schema(("k", DataType.INT64))), b, (0,)),
        lambda: rtn.topn_keys(side, [(0, False)], ()),
        lambda: rtn.topn_rank(side, i64, i64, 0, 1),
        lambda: rtn.topn_diff(side, i64, i64, errs[0], i64, [i64], [b],
                              errs[0]),
        lambda: gow.window_scan(side, i64, i64, [(0, False)],
                                [gow.WindowSpec("row_number")]),
        lambda: gow.window_hash([i64], [b], i64, errs[0]),
        lambda: gow.window_diff([i64], [b], i64, i64, errs[0], i64, [i64],
                                [b], errs[0]),
        lambda: sagg.simple_agg_apply(
            [count_star().spec()], [i64[0]], i64[0], StreamChunk(
                (Column(i64),), i64.to(torch.int8), b,
                schema(("k", DataType.INT64)))),
        lambda: extrema.extrema_apply(
            extrema.extrema_empty(4, 2, torch.int64, "meta"), i64, None,
            i64.to(torch.int8), i64.to(torch.int32), i64, True,
            errs[0]),
        lambda: sj.outer_apply(b, i64, i64, i64.to(torch.int8), b, b, side,
                               [Column(i64)], [Column(i64)], [Column(i64)],
                               i64.to(torch.int8), 4, True, False, errs),
        lambda: dynamic.dynf_hash(side, 0, "greater_than", 0),
        lambda: dynamic.dynf_diff(side, i64, i64, errs[0], i64, [i64], [b],
                                  errs[0]),
        lambda: hash_agg.agg_flush(hash_agg.AggState(
            t, (i64.clone(),), i64.clone(), b.clone(), b.clone(),
            (i64.clone(),)), [count_star().spec()]),
        lambda: hll.hll_update([i64.clone()] * 8, i64, None,
                               i64.to(torch.int8), vis=b),
    ]
    for refuse in refusals:
        with pytest.raises(ValueError, match="unsupported device"):
            refuse()
