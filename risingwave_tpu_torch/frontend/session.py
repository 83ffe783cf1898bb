"""Session — SQL in, streaming dataflows out (port of
risingwave_tpu/frontend/session.py, trimmed).

One Session owns one state store and one barrier coordinator that drives
every dataflow it creates. `execute` runs SET, CREATE SOURCE, CREATE
SINK and CREATE MATERIALIZED VIEW: a sink or MV statement is planned by
the port's binder, built into actors on the session's device (CUDA by
default; the CPU only when asked for) and brought up with the first
barrier. `tick` advances the barrier loop.

Sources: the `nexmark` and `tpch` connectors (device generators).

Durability (`streaming_durability = 1`, the default): stateful executors
persist their state tables at every checkpoint into the session's store,
a `HummockStateStore` over an object store for real durability. The
checkpoint pipeline (`checkpoint_max_inflight`, default 2) runs the
persist fetches, SST uploads and manifest commits behind the stream.
The DDL log is the durable catalog (the `CATALOG` object, the same JSON
as the JAX package's): `recover()` on a new session over a reopened
store replays it with each entry's table-id floor and config, so every
executor recovers its state and every source re-seeks its committed
offset. `crash()` abandons every actor and uncommitted epoch, as a
killed process would.

An MV or sink may read another MV (`... FROM <mv>`): its plan starts
with a stream_scan, which taps the upstream MV's root actor and
backfills the upstream table. The tap is attached under the
coordinator's rounds lock, so the new flow sees a barrier-aligned
suffix of the upstream changelog. `drop_mv` refuses an MV that another
flow reads, and `drop_all` and `shutdown` go in reverse creation order.
`recover()` rebuilds the whole topology, taps included, before any
barrier runs, and each backfill resumes from its persisted progress.

Left out of this slice (ROADMAP A5/A9/A10): batch SELECT and the
serving path, DROP statements, CREATE TABLE/INSERT, EXPLAIN/SHOW, backup
and restore, cluster mode, automatic and partial recovery, the monitor
and subscription endpoints, the stuck-barrier watchdog (`SET
barrier_stall_threshold_ms` raises), the string dictionary's durable log
(a durable table with a VARCHAR column raises), and every session
variable beyond the ones the port plans with.
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass
from typing import Optional

from ..common.types import Schema
from ..connectors.nexmark import AUCTION_SCHEMA, BID_SCHEMA, PERSON_SCHEMA
from ..connectors.tpch import TPCH_SCHEMAS
from ..device import DEFAULT_DEVICE, resolve_device
from ..meta.barrier_manager import BarrierCoordinator
from ..plan.build import BuildEnv, Deployment, build_graph
from ..state import MemoryStateStore
from ..state.sstable import frame_meta, unframe_meta
from . import sql as ast
from .binder import BindError, StreamPlanner, not_ported

_NEXMARK_SCHEMAS = {"bid": BID_SCHEMA, "person": PERSON_SCHEMA,
                    "auction": AUCTION_SCHEMA}

CATALOG_PATH = "CATALOG"

# The JAX package's session variables and their defaults, in its order:
# each catalog entry records the session config it was planned under,
# and the catalog must be the same JSON in both engines. Only the
# variables in Session.CONFIG_VARS can be SET in the port.
JAX_CONFIG_DEFAULTS = {
    "streaming_join_capacity": 1 << 17,
    "streaming_join_match_factor": 64,
    "streaming_agg_capacity": 1 << 16,
    "streaming_watchdog": 1,
    "streaming_parallelism": 1,
    "streaming_parallelism_devices": 1,
    "streaming_mesh_shuffle": 1,
    "streaming_mesh_shuffle_slack": 0,
    "streaming_mesh_shuffle_adaptive": 1,
    "streaming_mesh_chain": 1,
    "streaming_over_window_capacity": 1 << 14,
    "streaming_top_n_capacity": 1 << 14,
    "streaming_dynamic_filter_capacity": 1 << 14,
    "streaming_fragment_worker": "",
    "streaming_snapshot_fuse": 1,
    "streaming_durability": 1,
    "streaming_chunk_coalesce": 0,
    "checkpoint_max_inflight": 2,
    "hbm_budget_bytes": 0,
    "memory_eviction_policy": "lru",
    "serving_max_concurrency": 4,
    "serving_query_timeout_ms": 0,
    "serving_cache": 1,
    "metric_level": "info",
    "monitor_port": 0,
    "subscription_port": 0,
    "subscription_cursor_ttl_ms": 0,
    "barrier_stall_threshold_ms": 60000,
    "metrics_history_interval": 1,
    "metrics_history_retention": 512,
    "metrics_history_downsample": 8,
    "metrics_history_series": "",
    "metrics_history_durable": 0,
    "partial_recovery": 1,
    "recovery_backoff_ms": 50,
    "recovery_flap_threshold": 3,
    "backup_path": "",
    "storage_scrub_interval": 16,
    "storage_scrub_batch": 2,
    "compaction_interval": 1,
    "compaction_l0_trigger": 4,
    "compaction_budget_bytes": 8 << 20,
    "compaction_max_runs": 8,
    "broker_retention_interval": 0,
    "backup_keep_generations": 8,
    "object_store_retries": 4,
    "fault_injection": "",
    "cluster": "",
}


@dataclass
class SourceDef:
    name: str
    schema: Schema
    options: dict      # builder args for the source node


@dataclass
class SinkDef:
    name: str
    schema: Schema
    deployment: Deployment
    sink_fragment: int
    upstream_taps: tuple = ()          # (upstream MvDef, Channel) to detach

    @property
    def executor(self):
        return self.deployment.roots[self.sink_fragment][0]


@dataclass
class MvDef:
    name: str
    schema: Schema
    pk_indices: tuple
    deployment: Deployment
    mv_fragment: int
    tap: object = None                 # TapDispatcher on the MV root actor
    upstream_taps: tuple = ()          # (upstream MvDef, Channel) to detach
    append_only: bool = False          # its changelog has no retractions

    @property
    def table(self):
        return self.deployment.roots[self.mv_fragment][0].table


class Catalog:
    def __init__(self):
        self.sources: dict[str, SourceDef] = {}
        self.mvs: dict[str, MvDef] = {}
        self.sinks: dict[str, SinkDef] = {}

    def source(self, name: str) -> SourceDef:
        if name not in self.sources:
            raise BindError(f"unknown source {name!r}")
        return self.sources[name]


class Session:
    """One coordinator drives every dataflow of the session."""

    # session variables the port plans with and can SET, each with its
    # converter; their defaults are JAX_CONFIG_DEFAULTS'
    CONFIG_VARS = {
        "streaming_join_capacity": int,
        "streaming_join_match_factor": int,
        "streaming_agg_capacity": int,
        "streaming_watchdog": int,      # 0 disables error fetches
        "streaming_parallelism": int,
        # the top-N's store; 1 device only (the mesh top-N is not
        # ported: above 1 the SET raises)
        "streaming_top_n_capacity": int,
        # the over-window's store (it grows at 0.7 occupancy)
        "streaming_over_window_capacity": int,
        # the NOW() dynamic filter's store (it grows at 0.7 occupancy)
        "streaming_dynamic_filter_capacity": int,
        "streaming_parallelism_devices": int,
        # 0 disables the snapshot join-agg fusion (the shape then plans
        # as a changelog join cascade under a simple agg)
        "streaming_snapshot_fuse": int,
        # 1 = durable state tables, persisted at every checkpoint; 0 =
        # device-resident state only
        "streaming_durability": int,
        # checkpoints in flight behind the stream; 0 = inline sync
        "checkpoint_max_inflight": int,
    }

    def __init__(self, store=None, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.store = store if store is not None else MemoryStateStore()
        self.catalog = Catalog()
        self.coord = BarrierCoordinator(self.store)
        self.env = BuildEnv(self.store, self.coord, self.device)
        self.env.session = self
        self.config = dict(JAX_CONFIG_DEFAULTS)
        # hook(flow name, deployment, root fragment id), called after a
        # flow is built and before its actors start: where a caller
        # attaches to a deployment (a sink that keeps rows, say)
        self.build_hooks: list = []
        # durable catalog: the ordered DDL log with the table-id floor
        # and config each flow was built at, so a replay rebinds the same
        # state-table ids. It loads eagerly: DDL on an existing store
        # without recover() appends to the stored log.
        self._ddl_log: list[dict] = []
        self._recovering = False
        blob = self._load_catalog_blob()
        if blob:
            self._ddl_log = list(json.loads(blob)["ddl"])

    # ------------------------------------------------------ durable catalog
    def _persist_catalog(self) -> None:
        if self._recovering:
            return
        blob = json.dumps({"format": 1, "ddl": self._ddl_log}).encode()
        objects = getattr(self.store, "objects", None)
        if objects is not None:          # Hummock: atomic object swap
            objects.upload(CATALOG_PATH, frame_meta(blob))
        else:                            # in-memory: survives in-process
            self.store._catalog_blob = blob

    def _load_catalog_blob(self):
        objects = getattr(self.store, "objects", None)
        if objects is not None:
            if objects.exists(CATALOG_PATH):
                return unframe_meta(objects.read(CATALOG_PATH),
                                    CATALOG_PATH)
            return None
        return getattr(self.store, "_catalog_blob", None)

    def _log_ddl(self, entry: dict) -> None:
        if self._recovering:
            return
        self._ddl_log = [e for e in self._ddl_log if not (
            e["kind"] == entry["kind"] and e["name"] == entry["name"])]
        self._ddl_log.append(entry)
        self._persist_catalog()

    async def recover(self) -> None:
        """Replay the persisted DDL log: re-register sources and
        re-deploy every flow with its original table ids and config;
        their state is in the store, and sources re-seek their committed
        offsets. One Initial barrier follows over the whole topology."""
        log = list(self._ddl_log)
        if not log:
            return
        self._recovering = True
        saved_config = dict(self.config)
        try:
            for entry in log:
                self.env._next_table_id = entry.get(
                    "table_id_floor", self.env._next_table_id)
                # each entry replays under its own planning-time config
                self.config = {**saved_config, **entry.get("config", {})}
                await self.execute(entry["sql"])
        finally:
            self.config = saved_config
            self._recovering = False
        self._ddl_log = list(log)
        if self.catalog.mvs:
            await self.coord.run_rounds(0)

    async def execute(self, sql_text: str):
        stmt = ast.parse(sql_text)
        if isinstance(stmt, ast.SetVar):
            if stmt.name not in self.CONFIG_VARS:
                raise BindError(f"unknown session variable {stmt.name!r} "
                                "(or not ported yet, ROADMAP A9)")
            value = self.CONFIG_VARS[stmt.name](stmt.value)
            if stmt.name == "streaming_parallelism_devices" and value > 1:
                raise not_ported("the mesh (streaming_parallelism_devices "
                                 "> 1)")
            self.config[stmt.name] = value
            if stmt.name == "checkpoint_max_inflight":
                # takes effect at the next barrier of the live coordinator
                self.coord.checkpoint_max_inflight = value
            return value
        if isinstance(stmt, ast.CreateSource):
            out = self._create_source(stmt)
            self._log_ddl({"kind": "source", "name": stmt.name,
                           "sql": sql_text})
            return out
        if isinstance(stmt, ast.CreateSink):
            if stmt.name in self.catalog.sinks:
                raise BindError(f"sink {stmt.name!r} already exists")
            floor = self.env._next_table_id   # before the build
            out = await self._create_sink(stmt)
            self._log_ddl({"kind": "sink", "name": stmt.name,
                           "sql": sql_text, "table_id_floor": floor,
                           "config": dict(self.config)})
            return out
        if isinstance(stmt, ast.CreateMV):
            if stmt.name in self.catalog.mvs:
                raise BindError(f"MV {stmt.name!r} already exists")
            floor = self.env._next_table_id
            out = await self._create_mv(stmt)
            self._log_ddl({"kind": "mv", "name": stmt.name,
                           "sql": sql_text, "table_id_floor": floor,
                           "config": dict(self.config)})
            return out
        if isinstance(stmt, ast.Select):
            raise BindError("batch SELECT not ported yet (ROADMAP A9)")
        raise BindError(
            f"statement {type(stmt).__name__} not ported yet (ROADMAP A9)")

    def _create_source(self, stmt: ast.CreateSource) -> SourceDef:
        opts = dict(stmt.options)
        connector = opts.pop("connector", "nexmark")
        if connector == "tpch":
            schemas = TPCH_SCHEMAS
        elif connector == "nexmark":
            schemas = _NEXMARK_SCHEMAS
        else:
            raise BindError(f"connector {connector!r} not ported yet "
                            "(ROADMAP A9)")
        table = opts.pop("table", stmt.name)
        if table not in schemas:
            raise BindError(f"unknown {connector} table {table!r}")
        if connector == "tpch":
            bad = {"emit_watermarks", "watermark_lag_us", "inter_event_us",
                   "base_time_us"} & set(opts)
            if bad:
                raise BindError(
                    f"options {sorted(bad)} are not supported by the "
                    "tpch connector (no event-time column)")
        args = {"connector": connector, "table": table,
                "chunk_size": int(opts.pop("chunk_size", 4096))}
        if "splits" in opts:
            raise BindError("split sources not ported yet (ROADMAP A9)")
        cfg = {}
        for k in ("inter_event_us", "base_time_us"):
            if k in opts:
                cfg[k] = int(opts.pop(k))
        if cfg:
            args["cfg"] = cfg
        if "emit_watermarks" in opts:
            v = opts.pop("emit_watermarks")
            args["emit_watermarks"] = v in (True, 1, "1", "true", "t", "on")
        if "primary_key" in opts:
            # a unique column, so downstream state needs no row id
            pk_name = opts.pop("primary_key")
            names = list(schemas[table].names)
            if pk_name not in names:
                raise BindError(f"primary_key {pk_name!r} not a column")
            args["primary_key"] = names.index(pk_name)
        for k in ("watermark_lag_us", "rate_limit"):
            if k in opts:
                args[k] = int(opts.pop(k))
        if opts:
            raise BindError(f"unknown {connector} options {sorted(opts)}")
        src = SourceDef(stmt.name, schemas[table], args)
        self.catalog.sources[stmt.name] = src
        return src

    def throttle_source(self, name: str, rows_per_barrier: int) -> None:
        """Cap a source at `rows_per_barrier` rows between barriers (the
        reference's source rate limit), for the flows created after
        this call: a driver that paces barriers by rows sets it before
        CREATE SINK / MATERIALIZED VIEW."""
        self.catalog.source(name).options["rate_limit"] = int(
            rows_per_barrier)

    def _planner(self) -> StreamPlanner:
        return StreamPlanner(self.catalog,
                             parallelism=self.config["streaming_parallelism"],
                             config=self.config)

    def _spawn(self, name: str, dep: Deployment, root_fragment: int,
               taps: list) -> None:
        """Run the build hooks, spawn the new dataflow's actors and
        attach its channels to the upstream taps, each with the actors
        that consume it (a Stop barrier covering them detaches the
        channel). Called under the rounds lock, after the whole graph
        has built: no barrier is in flight while a tap is attached, and
        a statement refused at build leaves no channel on a tap."""
        for hook in self.build_hooks:
            hook(name, dep, root_fragment)
        dep.spawn()
        ids = {a.actor_id for a in dep.actors}
        for up, ch in taps:
            up.tap.add(ch, ids)

    async def _first_barrier(self) -> None:
        """The session's first flow gets the Initial barrier, a later one
        initializes on the next ordinary barrier. During recovery no
        barrier runs until the whole topology is back: a barrier between
        two re-created flows would advance an upstream MV while a
        consumer is not tapped yet, and lose that epoch for it."""
        if not self._recovering:
            await self.coord.run_rounds(
                0 if not self.coord._started else 1)

    async def _create_mv(self, stmt: ast.CreateMV) -> MvDef:
        from ..stream import TapDispatcher
        planner = self._planner()
        plan = planner.plan_select(stmt.select)
        async with self.coord._rounds_lock:
            self.env.pending_taps = []
            dep = build_graph(plan.graph, self.env)
            # the JAX package allocates one more table id after each MV,
            # for the MV's changelog log; later flows' ids stay equal
            self.env.alloc_table_id()
            # the MV's root actor dispatches through a tap, which MVs and
            # sinks built on this one extend
            root = dep.roots[plan.mv_fragment][0]
            actor = next(a for a in dep.actors if a.consumer is root)
            if actor.dispatcher is not None:
                raise ValueError("an MV fragment must be terminal")
            actor.dispatcher = tap = TapDispatcher()
            taps = list(self.env.pending_taps)
            mv = MvDef(stmt.name, plan.schema, plan.pk_indices, dep,
                       plan.mv_fragment, tap=tap, upstream_taps=tuple(taps),
                       append_only=plan.append_only)
            self.catalog.mvs[stmt.name] = mv
            self._spawn(stmt.name, dep, plan.mv_fragment, taps)
        await self._first_barrier()
        return mv

    async def _create_sink(self, stmt: ast.CreateSink) -> SinkDef:
        planner = self._planner()
        plan = planner.plan_sink(stmt.select, stmt.options)
        async with self.coord._rounds_lock:
            self.env.pending_taps = []
            dep = build_graph(plan.graph, self.env)
            taps = list(self.env.pending_taps)
            sink = SinkDef(stmt.name, plan.schema, dep, plan.mv_fragment,
                           upstream_taps=tuple(taps))
            self.catalog.sinks[stmt.name] = sink
            self._spawn(stmt.name, dep, plan.mv_fragment, taps)
        await self._first_barrier()
        return sink

    def mv_rows(self, name: str) -> list[tuple]:
        """The MV's committed rows: what its state table flushed at the
        last barrier the MV collected."""
        return list(self.catalog.mvs[name].table.iter_committed())

    async def tick(self, rounds: int = 1,
                   interval_s: Optional[float] = None) -> None:
        """Advance the session's barrier loop by `rounds` barriers."""
        if not self.catalog.mvs and not self.catalog.sinks:
            return
        await self.coord.run_rounds(rounds, interval_s=interval_s)

    @staticmethod
    async def _stop(flow) -> None:
        """Stop a flow's actors at a barrier and detach its channels from
        the taps of the MVs it reads."""
        await flow.deployment.stop()
        for up, ch in flow.upstream_taps:
            up.tap.remove(ch)

    async def drop_sink(self, name: str) -> None:
        await self._stop(self.catalog.sinks.pop(name))
        self._forget(name, "sink")

    async def drop_mv(self, name: str) -> None:
        """Stop one MV and detach its upstream taps. Flows that read this
        MV must be dropped first."""
        dependents = [d.name for d in list(self.catalog.mvs.values())
                      + list(self.catalog.sinks.values())
                      if any(up.name == name for up, _ in d.upstream_taps)]
        if dependents:
            raise BindError(f"cannot drop {name!r}: {dependents} read it")
        await self._stop(self.catalog.mvs.pop(name))
        self._forget(name, "mv")

    def _forget(self, name: str, kind: str) -> None:
        self._ddl_log = [e for e in self._ddl_log
                         if not (e["kind"] == kind and e["name"] == name)]
        self._persist_catalog()

    async def drop_all(self) -> None:
        for name in reversed(list(self.catalog.sinks)):
            await self.drop_sink(name)
        # reverse creation order: a later MV may read an earlier one
        for name in reversed(list(self.catalog.mvs)):
            await self.drop_mv(name)

    async def crash(self) -> None:
        """Abandon every actor task without the stop protocol, as a
        killed process would. The catalog and the store's committed
        state stay; the uploader dies too, so sealed-but-uncommitted
        epochs are dropped (the commit point is the manifest swap) and
        recovery replays from the last committed epoch."""
        for d in (list(self.catalog.mvs.values())
                  + list(self.catalog.sinks.values())):
            for t in d.deployment.tasks:
                if not t.done():
                    t.cancel()
                try:
                    await t
                except (asyncio.CancelledError, Exception):
                    pass
        await self.coord.abort_uploads()

    async def shutdown(self) -> None:
        """Stop every flow at a barrier without dropping it: the durable
        catalog and state stay for the next incarnation."""
        for name in reversed(list(self.catalog.sinks)):
            await self._stop(self.catalog.sinks.pop(name))
        for name in reversed(list(self.catalog.mvs)):
            await self._stop(self.catalog.mvs[name])
        self.catalog.mvs.clear()
