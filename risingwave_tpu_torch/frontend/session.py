"""Session — SQL in, streaming dataflows out (port of
risingwave_tpu/frontend/session.py, trimmed).

One Session owns one state store and one barrier coordinator that drives
every dataflow it creates. `execute` runs SET, CREATE SOURCE, CREATE
SINK and CREATE MATERIALIZED VIEW: a sink or MV statement is planned by
the port's binder, built into actors on the session's device (CUDA by
default; the CPU only when asked for) and brought up with the first
barrier. `tick` advances the barrier loop.

Sources: the `nexmark` and `tpch` connectors (device generators).

Left out of this slice (ROADMAP A5/A9/A10): durable state
(`streaming_durability = 1` raises rather than running volatile), the
durable catalog and recovery, batch SELECT and the serving path, DROP,
CREATE TABLE/INSERT, EXPLAIN/SHOW, backup and restore, cluster mode,
the monitor and subscription endpoints, the stuck-barrier watchdog
(`SET barrier_stall_threshold_ms` raises), and every session variable
beyond the seven the port plans with.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..common.types import Schema
from ..connectors.nexmark import AUCTION_SCHEMA, BID_SCHEMA, PERSON_SCHEMA
from ..connectors.tpch import TPCH_SCHEMAS
from ..device import DEFAULT_DEVICE, resolve_device
from ..meta.barrier_manager import BarrierCoordinator
from ..plan.build import BuildEnv, Deployment, build_graph
from ..state import MemoryStateStore
from . import sql as ast
from .binder import BindError, StreamPlanner

_NEXMARK_SCHEMAS = {"bid": BID_SCHEMA, "person": PERSON_SCHEMA,
                    "auction": AUCTION_SCHEMA}


def _durability_not_ported() -> BindError:
    return BindError("durable state not ported yet (ROADMAP A10): SET "
                     "streaming_durability = 0 for volatile state")


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

    # session variables the port plans with: (JAX default, validator)
    CONFIG_VARS = {
        "streaming_join_capacity": (1 << 17, int),
        "streaming_join_match_factor": (64, int),
        "streaming_agg_capacity": (1 << 16, int),
        "streaming_watchdog": (1, int),      # 0 disables error fetches
        "streaming_parallelism": (1, int),
        # 0 disables the snapshot join-agg fusion; the port has no
        # generic plan for that shape, so it then raises BindError
        "streaming_snapshot_fuse": (1, int),
        # 0 = in-memory state; 1 (the JAX default) is durable state,
        # which the port refuses to plan (ROADMAP A10)
        "streaming_durability": (1, int),
    }

    def __init__(self, store=None, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.store = store if store is not None else MemoryStateStore()
        self.catalog = Catalog()
        self.coord = BarrierCoordinator(self.store)
        self.env = BuildEnv(self.store, self.coord, self.device)
        self.config = {k: v for k, (v, _) in self.CONFIG_VARS.items()}
        # hook(flow name, deployment, root fragment id), called after a
        # flow is built and before its actors start: where a caller
        # attaches to a deployment (a sink that keeps rows, say)
        self.build_hooks: list = []

    async def execute(self, sql_text: str):
        stmt = ast.parse(sql_text)
        if isinstance(stmt, ast.SetVar):
            if stmt.name not in self.CONFIG_VARS:
                raise BindError(f"unknown session variable {stmt.name!r} "
                                "(or not ported yet, ROADMAP A9)")
            _, conv = self.CONFIG_VARS[stmt.name]
            value = conv(stmt.value)
            if stmt.name == "streaming_durability" and value:
                raise _durability_not_ported()
            self.config[stmt.name] = value
            return value
        if isinstance(stmt, ast.CreateSource):
            return self._create_source(stmt)
        if isinstance(stmt, ast.CreateSink):
            if stmt.name in self.catalog.sinks:
                raise BindError(f"sink {stmt.name!r} already exists")
            return await self._create_sink(stmt)
        if isinstance(stmt, ast.CreateMV):
            if stmt.name in self.catalog.mvs:
                raise BindError(f"MV {stmt.name!r} already exists")
            return await self._create_mv(stmt)
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
        if self.config["streaming_durability"]:
            raise _durability_not_ported()
        return StreamPlanner(self.catalog,
                             parallelism=self.config["streaming_parallelism"],
                             config=self.config)

    async def _bring_up(self, name: str, dep: Deployment,
                        root_fragment: int) -> None:
        """Run the build hooks, spawn the new dataflow's actors; the
        session's first flow gets the Initial barrier, a later one
        initializes on the next ordinary barrier."""
        for hook in self.build_hooks:
            hook(name, dep, root_fragment)
        dep.spawn()
        await self.coord.run_rounds(0 if not self.coord._started else 1)

    async def _create_mv(self, stmt: ast.CreateMV) -> MvDef:
        planner = self._planner()
        plan = planner.plan_select(stmt.select)
        async with self.coord._rounds_lock:
            dep = build_graph(plan.graph, self.env)
        mv = MvDef(stmt.name, plan.schema, plan.pk_indices, dep,
                   plan.mv_fragment)
        self.catalog.mvs[stmt.name] = mv
        await self._bring_up(stmt.name, dep, plan.mv_fragment)
        return mv

    async def _create_sink(self, stmt: ast.CreateSink) -> SinkDef:
        planner = self._planner()
        plan = planner.plan_sink(stmt.select, stmt.options)
        async with self.coord._rounds_lock:
            dep = build_graph(plan.graph, self.env)
        sink = SinkDef(stmt.name, plan.schema, dep, plan.mv_fragment)
        self.catalog.sinks[stmt.name] = sink
        await self._bring_up(stmt.name, dep, plan.mv_fragment)
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

    async def drop_sink(self, name: str) -> None:
        sink = self.catalog.sinks.pop(name)
        await sink.deployment.stop()

    async def drop_mv(self, name: str) -> None:
        mv = self.catalog.mvs.pop(name)
        await mv.deployment.stop()

    async def drop_all(self) -> None:
        for name in reversed(list(self.catalog.sinks)):
            await self.drop_sink(name)
        for name in reversed(list(self.catalog.mvs)):
            await self.drop_mv(name)

    async def shutdown(self) -> None:
        """Stop every flow at a barrier (volatile state: nothing stays
        for a next incarnation)."""
        await self.drop_all()
