"""Fragment-graph builder — the `from_proto` registry seam (port of
risingwave_tpu/plan/build.py, trimmed to single-process singleton
fragments).

Instantiates executors from the plan's nodes, wraps each fragment root
in its output dispatcher, registers actors and sources with the barrier
coordinator. Each fragment becomes one actor; each inter-fragment edge
is a bounded channel. Executors that own tensors get the environment's
device.

Hash dispatch into a singleton consumer is a simple dispatch (every
row lands on the one actor). Durable nodes (`durable=True`) get their
state tables here, with the JAX package's table-id rule, so a store one
engine wrote is a store the other recovers.

Left out of this slice (ROADMAP A9): parallel fragments (vnode-routed
hash dispatch, vnode bitmaps, merge executors), remote and cluster
placement (`build_partial_graph`, `cluster_remote_edges`,
`_infer_fragment_schema`), per-fragment rebuild and channel replay,
mesh-chain fusion, memory and stats registration, and the builders of
node kinds the port cannot plan yet (the stateless simple
and the other aggregates, the sharded joins, the
group and sharded top-Ns, the sharded over-window, dedup,
project_set);
durable snapshot join-agg state; sinks other than `blackhole_device`;
connectors other than `nexmark` and `tpch`.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from ..common.types import DataType, Field as SchemaField, Schema
from ..meta.barrier_manager import BarrierCoordinator
from ..ops.extrema import extrema_row_layout
from ..state.state_table import StateTable
from ..state.store import StateStore
from ..stream import (
    Actor, BroadcastDispatcher, Channel, ChannelInput,
    DeviceBlackholeSinkExecutor, DynamicFilterExecutor,
    EowcOverWindowExecutor, FilterExecutor,
    GeneralOverWindowExecutor, HashAggExecutor, HashJoinExecutor,
    HopWindowExecutor,
    MaterializeExecutor,
    NoOpExecutor, NowExecutor, ProjectExecutor, RetractableTopNExecutor,
    RowIdGenExecutor, SimpleAggExecutor, SimpleDispatcher,
    SnapshotJoinAggExecutor, SortedJoinExecutor, SourceExecutor,
)
from ..stream.executor import Executor
from .graph import Exchange, Fragment, Node, StreamGraph

BUILDERS: dict[str, Callable] = {}


def register_builder(kind: str):
    def deco(fn):
        BUILDERS[kind] = fn
        return fn
    return deco


class BuildEnv:
    """Shared build-time services: the state store, table-id and actor-id
    allocation, the barrier coordinator being wired up and the device
    the executors run on."""

    def __init__(self, store: StateStore, coord: BarrierCoordinator,
                 device, channel_capacity: int = 64):
        self.store = store
        self.coord = coord
        self.device = device
        self.channel_capacity = channel_capacity
        self._next_table_id = 1
        self._next_actor_id = 1
        self.pending_source_queues: list = []
        # the owning Session's catalog, for nodes that read another
        # flow (stream_scan); None when graphs are built without one
        self.session = None
        # (upstream MvDef, Channel) of every stream_scan of the graph
        # being built: the session attaches each channel to the MV's
        # tap once the graph has built
        self.pending_taps: list = []

    def alloc_table_id(self) -> int:
        t = self._next_table_id
        self._next_table_id += 1
        return t

    def alloc_actor_id(self) -> int:
        a = self._next_actor_id
        self._next_actor_id += 1
        return a

    def state_table(self, table_id: int, schema: Schema,
                    pk_indices: Sequence[int]) -> StateTable:
        if getattr(self.store, "objects", None) is not None and any(
                f.data_type is DataType.VARCHAR for f in schema):
            raise NotImplementedError(
                "a durable table with a VARCHAR column needs the string "
                "dictionary's durable log, not ported yet (ROADMAP A10)")
        return StateTable(self.store, table_id=table_id, schema=schema,
                          pk_indices=pk_indices)


@dataclass
class ActorCtx:
    """Per-actor build context handed to node builders."""

    env: BuildEnv
    fragment: Fragment
    actor_id: int
    table_ids: dict           # node key -> table id

    def table_id(self, key) -> int:
        """Stable table id per plan node (allocated on first request)."""
        if key not in self.table_ids:
            self.table_ids[key] = self.env.alloc_table_id()
        return self.table_ids[key]


@dataclass
class Deployment:
    coord: BarrierCoordinator
    actors: list[Actor] = field(default_factory=list)
    roots: dict[int, list[Executor]] = field(default_factory=dict)
    tasks: list[asyncio.Task] = field(default_factory=list)
    source_queues: list = field(default_factory=list)

    def spawn(self) -> "Deployment":
        self.tasks = [a.spawn() for a in self.actors]
        return self

    def executors(self, cls) -> list:
        """Every executor of type `cls` in the deployment's chains."""
        out, seen = [], set()

        def walk(ex):
            if ex is None or id(ex) in seen:
                return
            seen.add(id(ex))
            if isinstance(ex, cls):
                out.append(ex)
            for attr in ("input", "inputs"):
                v = getattr(ex, attr, None)
                for child in (v if isinstance(v, (list, tuple)) else [v]):
                    if isinstance(child, Executor):
                        walk(child)

        for roots in self.roots.values():
            for r in roots:
                walk(r)
        return out

    async def stop(self) -> None:
        """Stop this deployment's actors at a Stop barrier and deregister
        them so later barriers do not wait on them."""
        ids = {a.actor_id for a in self.actors}
        try:
            await self.coord.stop_all(ids)
        finally:
            for t in self.tasks:
                if not t.done():
                    t.cancel()
                try:
                    await t
                except (asyncio.CancelledError, Exception):
                    pass
            for a in self.actors:
                self.coord.actor_ids.discard(a.actor_id)
            for q in self.source_queues:
                if q in self.coord.source_queues:
                    self.coord.source_queues.remove(q)


class FanoutDispatcher:
    """One dispatcher per consumer fragment."""

    def __init__(self, dispatchers):
        self.dispatchers = list(dispatchers)

    async def dispatch(self, msg) -> None:
        for d in self.dispatchers:
            await d.dispatch(msg)


def _build_fragment_actor(graph, env, dep, channels, built_schema, f, fid,
                          actor_id, consumers):
    """Build one actor of fragment `f`: the executor chain from the node
    tree, exchange legs resolved against the channels, the output
    dispatcher; register it with the coordinator."""
    ctx = ActorCtx(env=env, fragment=f, actor_id=actor_id, table_ids={})
    # per-actor Exchange occurrence counters: the build walk visits
    # leaves in the same pre-order as StreamGraph.edges()
    edge_seen: dict[int, int] = {}

    def build_node(n):
        if isinstance(n, Exchange):
            k = edge_seen.get(n.upstream, 0)
            edge_seen[n.upstream] = k + 1
            ch = channels[(n.upstream, fid, k)]
            # terminate only on this actor's stop (a shared coordinator
            # routes other deployments' stops here too)
            return ChannelInput(ch, built_schema[n.upstream],
                                stop_on=lambda b, aid=actor_id:
                                b.is_stop(aid), actor_id=actor_id)
        inputs = [build_node(i) for i in n.inputs]
        if n.kind not in BUILDERS:
            raise NotImplementedError(
                f"plan node {n.kind!r} is not ported yet (ROADMAP A9)")
        return BUILDERS[n.kind](dict(n.args), inputs, ctx, id(n))

    root = build_node(f.root)
    dep.roots[fid].append(root)
    dispatcher = _dispatcher_for(graph, f, consumers[fid], channels)
    env.coord.register_actor(actor_id)
    return root, Actor(actor_id, root, dispatcher, env.coord)


def build_graph(graph: StreamGraph, env: BuildEnv) -> Deployment:
    env.pending_source_queues = []
    dep = Deployment(coord=env.coord)
    # one channel per exchange edge (up_fid, down_fid, k): a fragment
    # consuming one upstream twice gets independent channels
    channels: dict[tuple[int, int, int], Channel] = {}
    built_schema: dict[int, Schema] = {}
    order = graph.topo_order()
    consumers = {fid: graph.consumers(fid) for fid in order}
    for fid in order:
        f = graph.fragments[fid]
        if f.parallelism != 1 or f.remote_worker:
            raise NotImplementedError(
                "parallel or remote fragments are not ported yet "
                "(ROADMAP A9)")
        for d_fid, k in consumers[fid]:
            channels[(fid, d_fid, k)] = Channel(env.channel_capacity)
    try:
        for fid in order:
            f = graph.fragments[fid]
            dep.roots[fid] = []
            root, actor = _build_fragment_actor(
                graph, env, dep, channels, built_schema, f, fid,
                env.alloc_actor_id(), consumers)
            dep.actors.append(actor)
            built_schema[fid] = root.schema
    except BaseException:
        # a graph refused part-way leaves nothing registered: the
        # session's later barriers must not wait on actors that never run
        for a in dep.actors:
            env.coord.actor_ids.discard(a.actor_id)
        for q in env.pending_source_queues:
            if q in env.coord.source_queues:
                env.coord.source_queues.remove(q)
        raise
    dep.source_queues = list(env.pending_source_queues)
    return dep


def _dispatcher_for(graph, f, cons, channels):
    """Output dispatcher of fragment `f`'s actor (singleton consumers:
    broadcast, hash and simple dispatch all send every message down each
    edge)."""
    if not cons:
        return None
    per_consumer = []
    for d_fid, k in cons:
        out = channels[(f.fid, d_fid, k)]
        if f.dispatch == "broadcast":
            per_consumer.append(BroadcastDispatcher([out]))
        else:
            per_consumer.append(SimpleDispatcher(out))
    return (per_consumer[0] if len(per_consumer) == 1
            else FanoutDispatcher(per_consumer))


# ----------------------------------------------------------------- builders

@register_builder("nexmark_source")
def _build_source(args, inputs, ctx: ActorCtx, key):
    from ..connectors.nexmark import NexmarkConfig, NexmarkGenerator
    from ..connectors.tpch import TpchGenerator
    if args.get("connector", "nexmark") not in ("nexmark", "tpch"):
        raise NotImplementedError(
            f"connector {args.get('connector')!r} is not ported yet "
            "(ROADMAP A9)")
    if int(args.get("splits", 1)) != 1:
        raise NotImplementedError("split sources are not ported yet "
                                  "(ROADMAP A9)")
    barrier_q: asyncio.Queue = asyncio.Queue()
    ctx.env.coord.register_source(barrier_q)
    ctx.env.pending_source_queues.append(barrier_q)
    st = None
    if args.get("durable"):
        st = ctx.env.state_table(
            ctx.table_id(key),
            Schema((SchemaField("split_id", DataType.INT64),
                    SchemaField("offset", DataType.INT64))), (0,))
    if args.get("connector") == "tpch":
        gen = TpchGenerator(args["table"],
                            chunk_size=args.get("chunk_size", 8192),
                            device=ctx.env.device)
    else:
        cfg = (NexmarkConfig(**args["cfg"]) if args.get("cfg")
               else NexmarkConfig())
        gen = NexmarkGenerator(args["table"],
                               chunk_size=args.get("chunk_size", 8192),
                               cfg=cfg, device=ctx.env.device)
    return SourceExecutor(
        ctx.actor_id, gen, barrier_q, state_table=st,
        emit_watermarks=args.get("emit_watermarks", False),
        watermark_lag_us=args.get("watermark_lag_us", 0),
        rate_limit_rows_per_barrier=args.get("rate_limit"))


@register_builder("project")
def _build_project(args, inputs, ctx, key):
    return ProjectExecutor(inputs[0], args["exprs"],
                           names=args.get("names"),
                           watermark_mapping=args.get("watermark_mapping"),
                           watermark_transforms=args.get(
                               "watermark_transforms"))


@register_builder("filter")
def _build_filter(args, inputs, ctx, key):
    return FilterExecutor(inputs[0], args["predicate"])


@register_builder("no_op")
def _build_no_op(args, inputs, ctx, key):
    return NoOpExecutor(inputs[0])


@register_builder("hop_window")
def _build_hop(args, inputs, ctx, key):
    return HopWindowExecutor(inputs[0], time_col=args["time_col"],
                             window_slide_us=args["slide_us"],
                             window_size_us=args["size_us"],
                             output_indices=args.get("output_indices"))


def _agg_state_schema(in_schema: Schema, group_key_indices, agg_calls,
                      minput_k: int) -> Schema:
    """Durable agg row: keys ++ per call its state, or for a retractable
    MIN/MAX its top-K value buffer (K values, K counts, the lossy flag)
    ++ row count (the JAX package's layout)."""
    fields = [in_schema[i] for i in group_key_indices]
    for j, c in enumerate(agg_calls):
        if c.retractable:
            for part, names in enumerate(extrema_row_layout(j, minput_k)):
                dt = c.ret_type if part == 0 else DataType.INT64
                fields += [SchemaField(n, dt) for n in names]
        else:
            fields.append(SchemaField(f"state{j}", c.ret_type))
    fields.append(SchemaField("_row_count", DataType.INT64))
    return Schema(tuple(fields))


@register_builder("hash_agg")
def _build_hash_agg(args, inputs, ctx: ActorCtx, key):
    st = None
    minput_k = args.get("minput_k", 32)
    if args.get("durable"):
        gk = tuple(args["group_key_indices"])
        st = ctx.env.state_table(
            ctx.table_id(key),
            _agg_state_schema(inputs[0].schema, gk, args["agg_calls"],
                              minput_k),
            tuple(range(len(gk))))
    return HashAggExecutor(
        inputs[0], args["group_key_indices"], args["agg_calls"],
        capacity=args.get("capacity", 1 << 16), state_table=st,
        group_key_names=args.get("group_key_names"),
        cleaning_watermark_col=args.get("cleaning_watermark_col"),
        watchdog_interval=args.get("watchdog_interval", 1),
        minput_k=minput_k, device=ctx.env.device)


@register_builder("hash_join")
def _build_hash_join(args, inputs, ctx: ActorCtx, key):
    state_tables = None
    if args.get("durable"):
        state_tables = tuple(
            ctx.env.state_table(
                ctx.table_id((key, s)), inp.schema,
                tuple(args["left_pk_indices" if s == 0
                           else "right_pk_indices"]))
            for s, inp in enumerate(inputs))
    return HashJoinExecutor(
        inputs[0], inputs[1],
        left_key_indices=args["left_key_indices"],
        right_key_indices=args["right_key_indices"],
        left_pk_indices=args["left_pk_indices"],
        right_pk_indices=args["right_pk_indices"],
        key_capacity=args.get("key_capacity", 1 << 14),
        row_capacity=args.get("row_capacity", 1 << 16),
        match_factor=args.get("match_factor", 2),
        condition=args.get("condition"),
        output_indices=args.get("output_indices"),
        state_tables=state_tables,
        clean_watermark_cols=tuple(args.get("clean_watermark_cols",
                                            (None, None))),
        watchdog_interval=args.get("watchdog_interval", 1),
        device=ctx.env.device)


@register_builder("sorted_join")
def _build_sorted_join(args, inputs, ctx: ActorCtx, key):
    state_tables = None
    if args.get("durable"):
        state_tables = tuple(
            ctx.env.state_table(
                ctx.table_id((key, s)), inp.schema,
                tuple(args["left_pk_indices" if s == 0
                           else "right_pk_indices"]))
            for s, inp in enumerate(inputs))
    return SortedJoinExecutor(
        inputs[0], inputs[1],
        left_key_indices=args["left_key_indices"],
        right_key_indices=args["right_key_indices"],
        left_pk_indices=args["left_pk_indices"],
        right_pk_indices=args["right_pk_indices"],
        capacity=args.get("capacity", 1 << 17),
        match_factor=args.get("match_factor", 2),
        match_factors=args.get("match_factors"),
        condition=args.get("condition"),
        join_type=args.get("join_type", "inner"),
        output_indices=args.get("output_indices"),
        append_only=tuple(args.get("append_only", (False, False))),
        clean_watermark_cols=tuple(args.get("clean_watermark_cols",
                                            (None, None))),
        clean_specs=(tuple(args["clean_specs"])
                     if args.get("clean_specs") is not None else None),
        state_tables=state_tables,
        temporal=bool(args.get("temporal", False)),
        watchdog_interval=args.get("watchdog_interval", 1),
        device=ctx.env.device)


@register_builder("now")
def _build_now(args, inputs, ctx: ActorCtx, key):
    # the now fragment is a source of its own: the coordinator's barriers
    # reach it through a queue, as they reach a source
    barrier_q: asyncio.Queue = asyncio.Queue()
    ctx.env.coord.register_source(barrier_q)
    ctx.env.pending_source_queues.append(barrier_q)
    return NowExecutor(barrier_q, device=ctx.env.device)


@register_builder("dynamic_filter")
def _build_dynamic_filter(args, inputs, ctx: ActorCtx, key):
    return DynamicFilterExecutor(
        inputs[0], inputs[1], args["key_col"],
        op=args.get("op", "greater_than"),
        capacity=args.get("capacity", 1 << 14),
        pk_indices=args.get("pk_indices"),
        watchdog_interval=args.get("watchdog_interval", 1),
        device=ctx.env.device)


@register_builder("snapshot_join_agg")
def _build_snapshot_join_agg(args, inputs, ctx: ActorCtx, key):
    if args.get("durable"):
        raise NotImplementedError(
            "durable snapshot join-agg state is not ported yet (ROADMAP "
            "A10)")
    return SnapshotJoinAggExecutor(
        inputs[0], inputs[1],
        fact_key=args["fact_key"], dim_key=args["dim_key"],
        sub_agg_calls=args["sub_agg_calls"],
        sub_items=args["sub_items"], residue=args["residue"],
        final_agg_calls=args["final_agg_calls"],
        final_items=args["final_items"],
        out_names=args["out_names"], out_types=args["out_types"],
        fact_filter=args.get("fact_filter"),
        sub_filter=args.get("sub_filter"),
        dim_filter=args.get("dim_filter"),
        capacity=args.get("capacity", 1 << 17),
        dim_capacity=args.get("dim_capacity", 1 << 14),
        watchdog_interval=args.get("watchdog_interval", 1),
        device=ctx.env.device)


@register_builder("retract_top_n")
def _build_retract_top_n(args, inputs, ctx: ActorCtx, key):
    pk = tuple(args.get("pk_indices")
               or inputs[0].pk_indices
               or range(len(inputs[0].schema)))
    if args.get("mesh_devices", 1) > 1:
        raise NotImplementedError(
            "the sharded top-N is not ported yet (ROADMAP A9)")
    st = None
    if args.get("durable"):
        st = ctx.env.state_table(ctx.table_id(key), inputs[0].schema, pk)
    return RetractableTopNExecutor(
        inputs[0], args.get("group_key_indices", ()),
        order_specs=args["order_specs"],
        limit=args["limit"], offset=args.get("offset", 0),
        capacity=args.get("capacity", 1 << 14),
        state_table=st, pk_indices=pk,
        watchdog_interval=args.get("watchdog_interval", 1),
        device=ctx.env.device)


@register_builder("general_over_window")
def _build_general_over_window(args, inputs, ctx: ActorCtx, key):
    pk = tuple(args["pk_indices"])
    st = None
    if args.get("durable"):
        st = ctx.env.state_table(ctx.table_id(key), inputs[0].schema, pk)
    return GeneralOverWindowExecutor(
        inputs[0], args["partition_by"], args["order_specs"],
        args["windows"], capacity=args.get("capacity", 1 << 14),
        state_table=st, pk_indices=pk,
        watchdog_interval=args.get("watchdog_interval", 1),
        device=ctx.env.device)


@register_builder("eowc_over_window")
def _build_eowc_over_window(args, inputs, ctx: ActorCtx, key):
    pk = tuple(args["pk_indices"])
    st = ft = None
    if args.get("durable"):
        st = ctx.env.state_table(ctx.table_id((key, 0)), inputs[0].schema,
                                 pk)
        ft = ctx.env.state_table(
            ctx.table_id((key, 1)),
            Schema((SchemaField("slot", DataType.INT64),
                    SchemaField("emitted_to", DataType.INT64))), (0,))
    return EowcOverWindowExecutor(
        inputs[0], args["partition_by"], args["order_specs"],
        args["windows"], capacity=args.get("capacity", 1 << 14),
        state_table=st, frontier_table=ft, pk_indices=pk,
        watchdog_interval=args.get("watchdog_interval", 1),
        device=ctx.env.device)


@register_builder("simple_agg")
def _build_simple_agg(args, inputs, ctx: ActorCtx, key):
    st = None
    if args.get("durable"):
        calls = args["agg_calls"]
        fields = [SchemaField("slot", DataType.INT64)]
        fields += [SchemaField(f"state{j}", c.ret_type)
                   for j, c in enumerate(calls)]
        fields.append(SchemaField("_row_count", DataType.INT64))
        st = ctx.env.state_table(ctx.table_id(key), Schema(tuple(fields)),
                                 (0,))
    return SimpleAggExecutor(inputs[0], args["agg_calls"], state_table=st,
                             combine_partials=args.get("combine_partials",
                                                       False),
                             device=ctx.env.device)


@register_builder("row_id_gen")
def _build_row_id(args, inputs, ctx: ActorCtx, key):
    return RowIdGenExecutor(inputs[0], instance=ctx.actor_id)


@register_builder("stream_scan")
def _build_stream_scan(args, inputs, ctx: ActorCtx, key):
    """CREATE MV ... FROM <mv>: a live tap on the upstream MV's root
    actor and a snapshot backfill over its table. The progress table is
    durable unless the node says otherwise, in a volatile session too,
    as the JAX package builds it."""
    from ..state.storage_table import StorageTable
    from ..stream.backfill import BackfillExecutor, backfill_progress_schema
    session = ctx.env.session
    if session is None:
        raise ValueError("stream_scan needs a session catalog")
    mv = session.catalog.mvs[args["mv"]]
    # the session attaches the channel to the MV's tap once the whole
    # graph has built: a builder that raises later leaves no channel
    # that nobody drains on the upstream's root
    ch = Channel(ctx.env.channel_capacity)
    ctx.env.pending_taps.append((mv, ch))
    storage = StorageTable.for_state_table(mv.table)
    st = None
    if args.get("durable", True):
        sch = backfill_progress_schema(mv.schema, mv.pk_indices)
        st = ctx.env.state_table(ctx.table_id(key), sch, (0,))
    return BackfillExecutor(
        ChannelInput(ch, mv.schema,
                     stop_on=lambda b, aid=ctx.actor_id: b.is_stop(aid),
                     actor_id=ctx.actor_id),
        storage, state_table=st, batch_rows=args.get("batch_rows", 65536),
        device=ctx.env.device)


@register_builder("sink")
def _build_sink(args, inputs, ctx: ActorCtx, key):
    connector = args.get("connector", "blackhole")
    if connector != "blackhole_device":
        raise NotImplementedError(
            f"sink connector {connector!r} is not ported yet (ROADMAP A9)")
    return DeviceBlackholeSinkExecutor(inputs[0])


@register_builder("materialize")
def _build_materialize(args, inputs, ctx: ActorCtx, key):
    st = ctx.env.state_table(ctx.table_id(key), inputs[0].schema,
                             tuple(args.get("pk_indices",
                                            inputs[0].pk_indices)))
    if args.get("conflict") is not None:
        return MaterializeExecutor(inputs[0], st, conflict=args["conflict"])
    return MaterializeExecutor(inputs[0], st)


# ------------------------------------------------- deterministic plan ids

def fragment_node_order(frag: Fragment) -> list:
    """The fragment's Node tree in the builder's visit order (post-order,
    inputs first: the order `build_node` constructs executors and
    builders request state-table ids). Exchange leaves excluded."""
    out = []

    def rec(n):
        if isinstance(n, Exchange):
            return
        for i in n.inputs:
            rec(i)
        out.append(n)

    rec(frag.root)
    return out


def _state_table_keys(kind: str, args: dict, key) -> list:
    """The `ctx.table_id(...)` keys the builder for `kind` requests, in
    request order (the JAX package's full rule set, so ids agree)."""
    durable = bool(args.get("durable"))
    if kind in ("nexmark_source", "hash_agg", "group_top_n",
                "general_over_window", "dedup", "simple_agg",
                "retract_top_n"):
        return [key] if durable else []
    if kind in ("hash_join", "sorted_join", "eowc_over_window",
                "snapshot_join_agg"):
        return [(key, 0), (key, 1)] if durable else []
    if kind == "stream_scan":
        return [key] if args.get("durable", True) else []
    if kind == "materialize":
        return [key]
    return []


def assign_graph_ids(graph: StreamGraph, actor_id_base: int,
                     table_id_base: int):
    """Every actor id and state-table id of a graph derived from the
    graph alone: fragments in topo order, nodes in builder visit order.
    Returns (actors, tables, next_actor_id, next_table_id) with
    `actors[fid]` the fragment's actor ids and `tables[fid]` its table
    map keyed by (fid, node index)."""
    next_actor = actor_id_base
    next_table = table_id_base
    actors: dict[int, list[int]] = {}
    tables: dict[int, dict] = {}
    for fid in graph.topo_order():
        f = graph.fragments[fid]
        actors[fid] = list(range(next_actor, next_actor + f.parallelism))
        next_actor += f.parallelism
        tab: dict = {}
        for idx, n in enumerate(fragment_node_order(f)):
            for k in _state_table_keys(n.kind, n.args, (fid, idx)):
                tab[k] = next_table
                next_table += 1
        tables[fid] = tab
    return actors, tables, next_actor, next_table


def infer_fragment_schemas(graph: StreamGraph,
                           on_node: Optional[Callable] = None
                           ) -> dict[int, Schema]:
    """Planner-level output schema of every fragment without building an
    executor, for the node kinds the port plans. `on_node(node,
    input_schemas)` is called at each node."""
    out: dict[int, Schema] = {}

    def node_schema(n) -> Schema:
        if isinstance(n, Exchange):
            return out[n.upstream]
        ins = [node_schema(i) for i in n.inputs]
        if on_node is not None:
            on_node(n, ins)
        k, a = n.kind, n.args
        if k == "nexmark_source":
            if a.get("connector") == "tpch":
                from ..connectors.tpch import TPCH_SCHEMAS
                return TPCH_SCHEMAS[a["table"]]
            from ..connectors.nexmark import (AUCTION_SCHEMA, BID_SCHEMA,
                                              PERSON_SCHEMA)
            return {"bid": BID_SCHEMA, "person": PERSON_SCHEMA,
                    "auction": AUCTION_SCHEMA}[a["table"]]
        if k == "project":
            names = a.get("names") or [f"expr{i}"
                                       for i in range(len(a["exprs"]))]
            return Schema(tuple(SchemaField(nm, e.ret_type)
                                for nm, e in zip(names, a["exprs"])))
        if k in ("filter", "no_op", "retract_top_n", "materialize",
                 "sink", "dynamic_filter"):
            return ins[0]
        if k == "now":
            return Schema((SchemaField("now", DataType.TIMESTAMP),))
        if k == "hop_window":
            fields = tuple(ins[0]) + (
                SchemaField("window_start", DataType.TIMESTAMP),
                SchemaField("window_end", DataType.TIMESTAMP))
            oi = a.get("output_indices")
            return Schema(fields if oi is None
                          else tuple(fields[i] for i in oi))
        if k == "hash_agg":
            gk = list(a["group_key_indices"])
            names = list(a.get("group_key_names")
                         or [ins[0][i].name for i in gk])
            return Schema(tuple(
                [SchemaField(nm, ins[0][i].data_type)
                 for nm, i in zip(names, gk)]
                + [SchemaField(f"agg{j}", c.ret_type)
                   for j, c in enumerate(a["agg_calls"])]))
        if k == "row_id_gen":
            return Schema(tuple(ins[0])
                          + (SchemaField("_row_id", DataType.SERIAL),))
        if k in ("sorted_join", "hash_join"):
            fields = tuple(ins[0]) + tuple(ins[1])
            oi = a.get("output_indices")
            if oi is not None:
                fields = tuple(fields[i] for i in oi)
            return Schema(fields)
        if k == "snapshot_join_agg":
            return Schema(tuple(SchemaField(nm, t) for nm, t in
                                zip(a["out_names"], a["out_types"])))
        if k == "simple_agg":
            return Schema(tuple(SchemaField(f"agg{j}", c.ret_type)
                                for j, c in enumerate(a["agg_calls"])))
        if k in ("general_over_window", "eowc_over_window"):
            return Schema(tuple(ins[0]) + tuple(
                SchemaField(w.name or f"w{j}", w.ret_type(ins[0]))
                for j, w in enumerate(a["windows"])))
        raise NotImplementedError(
            f"no schema rule for node kind {k!r} (ROADMAP A9)")

    for fid in graph.topo_order():
        out[fid] = node_schema(graph.fragments[fid].root)
    return out
