"""Binder + streaming planner: SQL AST -> fragment-graph IR (port of
risingwave_tpu/frontend/binder.py, trimmed to the plans the port runs).

Binds names against the session catalog, lowers expressions onto the
port's Expr IR and emits a `StreamGraph`, with the JAX planner's rules
and in its order, so the same SQL gives the same fragments, node kinds
and executor arguments:

  FROM source            -> shared source fragment + no_op fragment
  FROM (subquery) alias  -> the inner query's plan, unmaterialized
  TUMBLE(...)            -> project fragment appending window_start and
                            window_end, with their watermark transforms
  HOP(...)               -> hop_window fragment (one row per window; the
                            watermark on window_start only, a source pk
                            widened to (pk, window_start))
  GROUP BY keys, COUNT / SUM / MIN / MAX / AVG
                         -> pre-project (keys, then agg args), a
                            hash_agg fragment (hash dispatch on the keys,
                            one actor) with the first watermarked key as
                            its state-cleaning column, post-project (AVG
                            = FLOAT64 SUM / COUNT there); MIN / MAX over
                            a retracting input are retractable
  aggregates without GROUP BY
                         -> pre-project, a singleton simple_agg fragment,
                            post-project
  f(...) OVER (PARTITION BY ... ORDER BY ... [ROWS n PRECEDING])
                         -> general_over_window (eowc_over_window under
                            EMIT ON WINDOW CLOSE) over the relation, a
                            row_id_gen first for a keyless input, then
                            the final projection
  [LEFT|RIGHT|FULL [OUTER]] JOIN ... ON
                         -> sorted_join fragment (equi conjunctions are
                            key columns, the rest the non-equi
                            condition), watermark-derived state cleaning
                            for inner joins ("pair" for windowed
                            equi-joins, "band" for interval joins),
                            join-input pruning pushed into the upstream
                            fragments; outer joins never clean, carry no
                            watermark and are not append-only
  JOIN t FOR SYSTEM_TIME AS OF PROCTIME() ON ...
                         -> a temporal sorted_join (inner or left, over
                            an append-only stream side)
  global aggs over L JOIN dim JOIN (SELECT k, aggs FROM L GROUP BY k) A
                         -> one snapshot_join_agg fragment fed by the two
                            sources (TPC-H q17's shape, append-only
                            inputs; `_try_snapshot_join_agg`)
  WHERE                  -> a filter node above the relation; over an
                            inner join, the conjuncts of one side are
                            pushed below the join first
  WHERE col OP now()     -> a dynamic_filter node against a now
                            fragment (the static conjuncts filter first;
                            a keyless input gets a row_id first)
  ORDER BY ... LIMIT     -> a retract_top_n fragment (one actor) over the
                            query's changelog
  plain SELECT           -> project (+ row_id for a keyless MV pk)
  CREATE SINK            -> the plan ends in a sink node

  FROM <mv>              -> a stream_scan fragment: a tap on the MV's
                            root and a backfill of its table (MV-on-MV,
                            and a sink from an MV)

What the JAX planner also plans raises `BindError("... not ported yet
(ROADMAP A9)")` here, never a different plan: the mesh
top-N and the sharded over-window (`streaming_parallelism_devices` >
1), non-integer inner join keys (hash join), parallelism > 1 and remote
fragment placement.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..common.types import DataType, Field, Schema
from ..expr.agg import AggCall, AggKind
from ..expr.ir import Expr, InputRef, call, col, input_refs, lit, \
    remap_inputs
from ..expr.transforms import TumbleEndTransform, TumbleStartTransform
from ..plan.graph import Exchange, Fragment, Node, StreamGraph
from . import sql as ast

AGG_FUNCS = {"count", "sum", "min", "max", "avg", "bool_and", "bool_or",
             "approx_count_distinct"}


class BindError(Exception):
    pass


def not_ported(what: str) -> BindError:
    return BindError(f"{what} not ported yet (ROADMAP A9)")


@dataclass
class Scope:
    """Visible columns: (qualifier, name) -> (index, dtype)."""

    schema: Schema
    names: dict = field(default_factory=dict)

    @classmethod
    def of(cls, schema: Schema, qualifier: Optional[str]) -> "Scope":
        s = cls(schema)
        for i, f in enumerate(schema):
            s.names.setdefault((None, f.name), (i, f.data_type))
            if qualifier:
                s.names[(qualifier, f.name)] = (i, f.data_type)
        return s

    @classmethod
    def join(cls, left: "Scope", right: "Scope") -> "Scope":
        fields = tuple(left.schema) + tuple(right.schema)
        s = cls(Schema(fields))
        off = len(left.schema)
        for (q, n), (i, t) in left.names.items():
            s.names.setdefault((q, n), (i, t))
        for (q, n), (i, t) in right.names.items():
            if (q, n) in s.names and q is None:
                # ambiguous unqualified name: drop it
                del s.names[(q, n)]
                continue
            s.names[(q, n)] = (i + off, t)
        return s

    def resolve(self, ref: ast.ColRef) -> tuple[int, DataType]:
        # a qualified name must match its qualifier exactly
        key = (ref.qualifier, ref.name)
        if key in self.names:
            return self.names[key]
        raise BindError(f"unknown column {ref.qualifier or ''}.{ref.name}")


def bind_scalar(e, scope: Scope) -> Expr:
    """SQL expression AST -> Expr IR (no aggregates allowed)."""
    if isinstance(e, ast.Lit):
        return lit(e.value)
    if isinstance(e, ast.ColRef):
        i, t = scope.resolve(e)
        return col(i, t)
    if isinstance(e, ast.UnOp):
        return call(e.op, bind_scalar(e.arg, scope))
    if isinstance(e, ast.BinOp):
        return call(e.op, bind_scalar(e.left, scope),
                    bind_scalar(e.right, scope))
    if isinstance(e, ast.Func):
        if e.name in AGG_FUNCS:
            raise BindError(f"aggregate {e.name} not allowed here")
        return call(e.name, *[bind_scalar(a, scope) for a in e.args])
    raise BindError(f"cannot bind {e!r}")


def contains_agg(e) -> bool:
    if isinstance(e, ast.Func):
        return e.name in AGG_FUNCS or any(contains_agg(a) for a in e.args)
    if isinstance(e, ast.BinOp):
        return contains_agg(e.left) or contains_agg(e.right)
    if isinstance(e, ast.UnOp):
        return contains_agg(e.arg)
    return False


@dataclass
class RelInfo:
    """Stream properties of a planned relation: its stream key
    (positions that identify a changelog row), append-only-ness, and the
    columns a watermark flows on (drives join state cleaning)."""

    stream_key: Optional[tuple] = None      # None = keyless (needs row_id)
    append_only: bool = True
    wm_cols: frozenset = frozenset()


# date_time column index per nexmark table (the connector's declared
# watermark column, connectors/nexmark.py watermark_col)
_NEXMARK_WM_COL = {"bid": 5, "person": 6, "auction": 5}


@dataclass
class BoundPlan:
    graph: StreamGraph
    mv_fragment: int            # the fragment whose root materializes/sinks
    schema: Schema
    pk_indices: tuple
    append_only: bool = True


class StreamPlanner:
    def __init__(self, catalog, parallelism: int = 1, config=None):
        if parallelism != 1:
            raise not_ported("streaming_parallelism > 1 (hash dispatch)")
        self.catalog = catalog
        self.parallelism = parallelism
        self.config = config or {}
        self.graph = StreamGraph()
        self._next_fid = 1
        self._source_frags: dict[str, int] = {}
        self._join_frags: dict[int, dict] = {}

    def cfg(self, name: str, default):
        return self.config.get(name, default)

    def durable(self) -> bool:
        """Stateful executors flush to state tables at barriers unless the
        session selected the in-memory state backend."""
        return bool(self.cfg("streaming_durability", 1))

    def fid(self) -> int:
        f = self._next_fid
        self._next_fid = f + 1
        return f

    def source_fragment(self, name: str) -> int:
        """Source fragments are shared within one plan: a query reading a
        source twice runs one generator. The cached fragment stays bare;
        consumers attach through Exchange."""
        if name not in self._source_frags:
            src = self.catalog.source(name)
            node = Node("nexmark_source", dict(src.options, durable=True,
                                               source_name=name))
            f = self.graph.add(Fragment(self.fid(), node,
                                        dispatch="broadcast", parallelism=1))
            self._source_frags[name] = f.fid
        return self._source_frags[name]

    # ----------------------------------------------------------- relations
    def plan_rel(self, rel) -> tuple[int, Scope, RelInfo]:
        """Returns (fragment id, scope over its output, stream info)."""
        if isinstance(rel, ast.TableRel):
            # an MV name resolves to a backfilled stream scan over it
            # (MV-on-MV); a source otherwise
            if rel.name in getattr(self.catalog, "mvs", {}):
                mv = self.catalog.mvs[rel.name]
                node = Node("stream_scan", dict(mv=rel.name))
                f = self.graph.add(Fragment(self.fid(), node,
                                            dispatch="broadcast"))
                return (f.fid, Scope.of(mv.schema, rel.alias or rel.name),
                        RelInfo(stream_key=tuple(mv.pk_indices),
                                append_only=getattr(mv, "append_only",
                                                    False)))
            src = self.catalog.source(rel.name)
            sfid = self.source_fragment(rel.name)
            # indirection fragment: grafts land here, the shared source
            # root stays untouched
            f = self.graph.add(Fragment(self.fid(), Node(
                "no_op", {}, inputs=(Exchange(sfid),)),
                dispatch="broadcast"))
            wm = frozenset()
            wmcol = _NEXMARK_WM_COL.get(src.options.get("table"))
            if src.options.get("emit_watermarks") and wmcol is not None:
                wm = frozenset({wmcol})
            pk_opt = src.options.get("primary_key")
            ao = bool(src.options.get("append_only", True))
            return (f.fid, Scope.of(src.schema, rel.alias or rel.name),
                    RelInfo(None if pk_opt is None else (pk_opt,), ao,
                            wm))
        if isinstance(rel, ast.WindowRel):
            src = self.catalog.source(rel.inner.name)
            scope = Scope.of(src.schema, None)
            i, t = scope.resolve(ast.ColRef(rel.time_col))
            src_node = Exchange(self.source_fragment(rel.inner.name))
            if rel.kind == "tumble":
                exprs = [col(j, f.data_type)
                         for j, f in enumerate(src.schema)]
                exprs.append(call("tumble_start", col(i, t), lit(rel.size)))
                exprs.append(call("tumble_end", col(i, t), lit(rel.size)))
                names = list(src.schema.names) + ["window_start",
                                                  "window_end"]
                W = rel.size
                node = Node("project", dict(
                    exprs=exprs, names=names,
                    watermark_transforms={
                        i: [(len(names) - 2, TumbleStartTransform(W)),
                            (len(names) - 1, TumbleEndTransform(W))]}),
                    inputs=(src_node,))
            else:
                node = Node("hop_window", dict(
                    time_col=i, slide_us=rel.slide, size_us=rel.size),
                    inputs=(src_node,))
            f = self.graph.add(Fragment(self.fid(), node,
                                        dispatch="broadcast"))
            out_schema = Schema(tuple(
                list(src.schema) + [Field("window_start", t),
                                    Field("window_end", t)]))
            wm = frozenset()
            if src.options.get("emit_watermarks"):
                # tumble carries the event-time watermark onto both
                # window columns; hop emits it on window_start only
                wm = (frozenset({len(src.schema), len(src.schema) + 1})
                      if rel.kind == "tumble"
                      else frozenset({len(src.schema)}))
            # tumble is 1:1, so a declared source pk stays a stream key;
            # hop emits one row per window, so the key widens to (pk,
            # window_start)
            pk_opt = src.options.get("primary_key")
            sk = None
            if pk_opt is not None:
                sk = ((pk_opt,) if rel.kind == "tumble"
                      else (pk_opt, len(src.schema)))
            return (f.fid, Scope.of(out_schema, rel.alias or rel.inner.name),
                    RelInfo(sk, True, wm))
        if isinstance(rel, ast.JoinRel):
            return self._plan_join(rel)
        if isinstance(rel, ast.SubqueryRel):
            # FROM (SELECT ...) alias: plan the inner query without
            # materialization; its changelog feeds the outer plan
            sub_fid, names, types, pk_hint, ao, wm = self._plan_query(
                rel.select)
            schema = Schema(tuple(Field(n, t)
                                  for n, t in zip(names, types)))
            return (sub_fid, Scope.of(schema, rel.alias),
                    RelInfo(stream_key=pk_hint, append_only=ao,
                            wm_cols=wm))
        raise BindError(f"cannot plan relation {rel!r}")

    def _plan_join(self, rel: ast.JoinRel) -> tuple[int, Scope, RelInfo]:
        lf, ls, li = self.plan_rel(rel.left)
        rf, rs, ri = self.plan_rel(rel.right)

        # join-state pk must be a real stream key: a keyless append-only
        # side gets a row_id column; a keyed side keeps its key
        def side_key(fid_, scope_, info_):
            if info_.stream_key is not None:
                return scope_, tuple(info_.stream_key)
            if not info_.append_only:
                raise BindError("keyless retracting join input")
            frag_ = self.graph.fragments[fid_]
            frag_.root = Node("row_id_gen", {}, inputs=(frag_.root,))
            sch = Schema(tuple(scope_.schema)
                         + (Field("_row_id", DataType.SERIAL),))
            return Scope(sch, dict(scope_.names)), (len(sch) - 1,)

        ls, lpk = side_key(lf, ls, li)
        rs, rpk = side_key(rf, rs, ri)
        jscope = Scope.join(ls, rs)
        lkeys, rkeys, residue = [], [], []
        for conj in split_conjuncts(rel.on):
            pair = equi_pair(conj, ls, rs)
            if pair is not None:
                lkeys.append(pair[0])
                rkeys.append(pair[1])
            else:
                residue.append(conj)
        if not lkeys:
            raise BindError("join needs at least one equi condition")
        cond = None
        if residue:
            e = residue[0]
            for r in residue[1:]:
                e = ast.BinOp("and", e, r)
            cond = bind_scalar(e, jscope)
        jt = getattr(rel, "join_type", "inner")
        temporal = getattr(rel, "temporal", False)
        if temporal and jt not in ("inner", "left"):
            raise BindError("temporal joins are INNER or LEFT")
        if temporal and not li.append_only:
            # a retracting stream side would emit deletes for rows
            # downstream never saw (the table side's emissions are
            # suppressed)
            raise BindError(
                "temporal joins need an append-only stream side")
        # watermark-driven state cleaning (inner joins; outer joins never
        # clean, for their degrees): a side evicts rows below its
        # watermark on column c when future matches are impossible — (1)
        # c is an equi-key whose partner column is also watermarked
        # ("pair": windowed joins), or (2) a residual conjunct bands c
        # against a watermarked column of the other side ("band":
        # interval joins)
        clean_l = clean_r = None
        for kpos, (lk, rk) in enumerate(zip(lkeys, rkeys)):
            if jt != "inner":
                break
            if lk in li.wm_cols and rk in ri.wm_cols:
                clean_l = ("pair", lk, kpos)
                clean_r = ("pair", rk, kpos)
                break
        if clean_l is None and clean_r is None and jt == "inner":
            for conj in residue:
                b = band_bound(conj, ls, rs, li.wm_cols, ri.wm_cols)
                if b is None:
                    continue
                bside, own_col, other_col, delta = b
                info_side = li if bside == "l" else ri
                own_wm = own_col in info_side.wm_cols
                # a retracting side may still emit deletes for rows the
                # band already evicted: safe only when append-only, or
                # when its own column is watermarked (bound capped)
                if not (info_side.append_only or own_wm):
                    continue
                cap = (own_col if own_wm
                       and not info_side.append_only else None)
                spec = ("band", own_col, other_col, delta, cap)
                if bside == "l" and clean_l is None:
                    clean_l = spec
                elif bside == "r" and clean_r is None:
                    clean_r = spec
                if clean_l is not None and clean_r is not None:
                    break
        # the sorted-merge join needs integer-comparable keys; the JAX
        # planner sends the rest to the chained hash join
        key_int = all(
            np.issubdtype(sc.schema[i].data_type.np_dtype, np.integer)
            for sc, keys in ((ls, lkeys), (rs, rkeys)) for i in keys)
        if not key_int:
            if jt != "inner" or temporal:
                raise BindError(
                    "outer/temporal joins require integer-comparable keys")
            raise not_ported("hash join (non-integer join keys)")
        wd = 1 if self.cfg("streaming_watchdog", 1) else None
        # per-side match buffers: probing a side whose rows are unique
        # per join key yields at most one match per probe row
        mf = self.cfg("streaming_join_match_factor", 64)
        mf_l = min(2, mf) if set(rpk) <= set(rkeys) else mf
        mf_r = min(2, mf) if set(lpk) <= set(lkeys) else mf
        node = Node("sorted_join", dict(
            left_key_indices=lkeys, right_key_indices=rkeys,
            left_pk_indices=list(lpk), right_pk_indices=list(rpk),
            condition=cond, join_type=jt, temporal=temporal,
            capacity=self.cfg("streaming_join_capacity", 1 << 17),
            match_factor=mf, match_factors=(mf_l, mf_r),
            append_only=(li.append_only, ri.append_only),
            clean_specs=(clean_l, clean_r),
            watchdog_interval=wd, durable=self.durable()),
            inputs=(Exchange(lf), Exchange(rf)))
        f = self.graph.add(Fragment(self.fid(), node, dispatch="broadcast"))
        # stash for _optimize_join, which runs once the SELECT is known
        self._join_frags[f.fid] = dict(
            node=node, nl=len(ls.schema), lsch=ls.schema, rsch=rs.schema,
            jt=jt)
        off = len(ls.schema)
        jkey = tuple(lpk) + tuple(off + i for i in rpk)
        # min-of-sides watermarks flow on equi-key columns watermarked on
        # both sides; inner joins only: an outer join's NULL-padded rows
        # emit values on the padded side's key column at any later time
        out_wm = set()
        for lk, rk in zip(lkeys, rkeys):
            if jt == "inner" and lk in li.wm_cols and rk in ri.wm_cols:
                out_wm |= {lk, off + rk}
        # temporal: the table side's updates emit nothing, so the output
        # is append-only iff the stream side is
        ao_out = ((li.append_only and jt == "inner") if temporal
                  else (li.append_only and ri.append_only
                        and jt == "inner"))
        return (f.fid, jscope,
                RelInfo(stream_key=jkey, append_only=ao_out,
                        wm_cols=frozenset(out_wm)))

    # -------------------------------------------------------------- select
    def plan_sink(self, sel: ast.Select, options: dict) -> BoundPlan:
        """CREATE SINK: the plan ends in a sink node instead of a
        materialize."""
        fid, names, types, pk_hint, append_only, _wm = self._plan_query(sel)
        frag = self.graph.fragments[fid]
        frag.root = Node("sink", dict(options), inputs=(frag.root,))
        out = Schema(tuple(Field(n, t) for n, t in zip(names, types)))
        return BoundPlan(self.graph, fid, out, tuple(pk_hint or ()),
                         append_only)

    def plan_select(self, sel: ast.Select) -> BoundPlan:
        fid, names, types, pk_hint, append_only, _wm = self._plan_query(sel)
        frag = self.graph.fragments[fid]
        if pk_hint is None:
            frag.root = Node("row_id_gen", {}, inputs=(frag.root,))
            mv = self.graph.add(Fragment(self.fid(), Node(
                "materialize", dict(pk_indices=[len(names)]),
                inputs=(Exchange(fid),))))
            out = Schema(tuple(
                [Field(n, t) for n, t in zip(names, types)]
                + [Field("_row_id", DataType.SERIAL)]))
            return BoundPlan(self.graph, mv.fid, out, (len(names),),
                             append_only)
        mv = self.graph.add(Fragment(self.fid(), Node(
            "materialize", dict(pk_indices=list(pk_hint)),
            inputs=(Exchange(fid),))))
        out = Schema(tuple(Field(n, t) for n, t in zip(names, types)))
        return BoundPlan(self.graph, mv.fid, out, tuple(pk_hint),
                         append_only)

    def _plan_query(self, sel: ast.Select):
        """Plan one SELECT (no materialization). Returns (fragment id,
        out names, out DataTypes, pk_hint, append_only, watermark
        columns); pk_hint is None for a keyless append-only stream (the
        caller adds a row_id)."""
        top_spec = (list(sel.order_by), sel.limit, sel.offset)
        want_top_n = sel.limit is not None
        if (sel.order_by or sel.offset) and not want_top_n:
            raise BindError(
                "streaming ORDER BY needs a LIMIT (a TopN MV); unbounded "
                "ORDER BY belongs in batch SELECTs over the MV")
        if want_top_n and not sel.order_by:
            raise BindError("streaming LIMIT needs ORDER BY (TopN)")
        # comma join: FROM a, b WHERE ... — the join condition lives in
        # WHERE; hoist it into ON (one 2-way comma join)
        rel, where = sel.rel, sel.where
        if isinstance(rel, ast.JoinRel) and rel.on is None:
            if isinstance(rel.left, ast.JoinRel) and rel.left.on is None:
                raise BindError("only one comma join is supported")
            if where is None:
                raise BindError("comma join needs join conditions in WHERE")
            rel = ast.JoinRel(rel.left, rel.right, where)
            where = None
        fused = self._try_snapshot_join_agg(ast.Select(
            list(sel.items), rel, where, sel.group_by, list(sel.order_by),
            sel.limit, sel.offset))
        if fused is not None:
            return fused
        fid, scope, info = self.plan_rel(rel)
        frag = self.graph.fragments[fid]
        sel = ast.Select(expand_star(sel.items, scope.schema), rel,
                         where, sel.group_by, list(sel.order_by),
                         sel.limit, sel.offset,
                         emit_on_close=getattr(sel, "emit_on_close",
                                               False))
        jinfo = self._join_frags.get(fid)
        if jinfo is not None and frag.root is jinfo["node"]:
            scope, info, sel = self._optimize_join(jinfo, scope, info, sel)

        if sel.where is not None:
            # `col OP now()` conjuncts lower to a dynamic filter against a
            # now fragment; the rest become a plain filter
            plain, dynamic = [], []
            for conj in split_conjuncts(sel.where):
                df = _now_conjunct(conj, scope)
                if df is None:
                    plain.append(conj)
                else:
                    dynamic.append(df)
            # static predicates graft FIRST: rows they reject must never
            # occupy the dynamic filter's bounded device state
            if dynamic and plain:
                frag.root = Node("filter", dict(
                    predicate=bind_scalar(_and_all(plain), scope)),
                    inputs=(frag.root,))
                plain = []
            for key_col, op in dynamic:
                if info.stream_key is None:
                    if not info.append_only:
                        raise BindError(
                            "keyless retracting dynamic-filter input")
                    frag.root = Node("row_id_gen", {},
                                     inputs=(frag.root,))
                    sch2 = Schema(tuple(scope.schema) + (
                        Field("_row_id", DataType.SERIAL),))
                    scope = Scope(sch2, dict(scope.names))
                    info = RelInfo((len(sch2) - 1,), True, info.wm_cols)
                now_f = self.graph.add(Fragment(
                    self.fid(), Node("now", {}), dispatch="broadcast"))
                frag.root = Node("dynamic_filter", dict(
                    key_col=key_col, op=op,
                    pk_indices=list(info.stream_key),
                    capacity=self.cfg("streaming_dynamic_filter_capacity",
                                      1 << 14),
                    watchdog_interval=(
                        1 if self.cfg("streaming_watchdog", 1) else None)),
                    inputs=(frag.root, Exchange(now_f.fid)))
                # the output retracts when the threshold moves
                info = RelInfo(info.stream_key, False, info.wm_cols)
            sel = ast.Select(sel.items, sel.rel,
                             _and_all(plain) if plain else None,
                             sel.group_by, sel.order_by, sel.limit,
                             sel.offset, emit_on_close=getattr(
                                 sel, "emit_on_close", False))
        if sel.where is not None:
            frag.root = Node("filter", dict(
                predicate=bind_scalar(sel.where, scope)),
                inputs=(frag.root,))

        if any(isinstance(it.expr, ast.WindowFunc) for it in sel.items):
            out = self._plan_over_window(sel, fid, scope, info)
            if want_top_n:
                out = self._plan_top_n(top_spec, out)
            return out

        has_agg = bool(sel.group_by) or any(
            contains_agg(it.expr) for it in sel.items)

        def project_wm(exprs):
            """Watermarks survive a projection on InputRef columns."""
            return frozenset(
                j for j, e in enumerate(exprs)
                if isinstance(e, InputRef) and e.index in info.wm_cols)

        if has_agg:
            afid, names, types, pk, wm_out = self._plan_agg(sel, fid, scope,
                                                            info)
            out = (afid, names, types, pk, False, wm_out)
        else:
            out = self._plan_project(sel, frag, scope, info, project_wm)
        if want_top_n:
            out = self._plan_top_n(top_spec, out)
        return out

    def _plan_project(self, sel: ast.Select, frag: Fragment, scope: Scope,
                      info: RelInfo, project_wm):
        exprs, names = [], []
        for j, it in enumerate(sel.items):
            exprs.append(bind_scalar(it.expr, scope))
            names.append(it.alias or auto_name(it.expr, j))
        if info.append_only:
            frag.root = Node("project", dict(exprs=exprs, names=names),
                             inputs=(frag.root,))
            return (frag.fid, names, [e.ret_type for e in exprs], None,
                    True, project_wm(exprs))
        # retracting input: its stream key must survive the projection so
        # deletes keep addressing the same rows
        assert info.stream_key is not None
        key_pos = []
        for ki in info.stream_key:
            found = None
            for j, e in enumerate(exprs):
                if isinstance(e, InputRef) and e.index == ki:
                    found = j
                    break
            if found is None:
                exprs.append(col(ki, scope.schema[ki].data_type))
                names.append(f"_sk{ki}")
                found = len(exprs) - 1
            key_pos.append(found)
        frag.root = Node("project", dict(exprs=exprs, names=names),
                         inputs=(frag.root,))
        return (frag.fid, names, [e.ret_type for e in exprs],
                tuple(key_pos), False, project_wm(exprs))

    def _plan_top_n(self, top_spec, planned):
        """Streaming ORDER BY + LIMIT -> a RetractableTopN over the
        query's changelog, a singleton fragment (per-shard top-Ns would
        union to wrong rows); no watermark survives it."""
        order_by, limit, offset = top_spec
        fid, names, types, pk_hint, append_only, _wm = planned
        order_specs = []
        for e, desc in order_by:
            idx = None
            if isinstance(e, ast.Lit) and isinstance(e.value, int):
                idx = e.value - 1
            elif isinstance(e, ast.ColRef) and e.qualifier is None \
                    and e.name in names:
                idx = names.index(e.name)
            if idx is None or not 0 <= idx < len(names):
                raise BindError(
                    "streaming ORDER BY must name an output column")
            if types[idx] is DataType.VARCHAR:
                # dict ids order by insertion, not lexicographically
                raise BindError(
                    "streaming ORDER BY over VARCHAR is unsupported "
                    "(dict encoding is not lexicographic); ORDER BY in "
                    "a batch SELECT over the MV instead")
            order_specs.append((idx, bool(desc)))
        if pk_hint is None:
            raise BindError(
                "streaming TopN over a keyless stream is unsupported "
                "(add GROUP BY or aggregate first)")
        if self.cfg("streaming_parallelism_devices", 1) > 1:
            raise not_ported("the mesh top-N (streaming_parallelism_"
                             "devices > 1)")
        wd = 1 if self.cfg("streaming_watchdog", 1) else None
        top = self.graph.add(Fragment(self.fid(), Node(
            "retract_top_n", dict(
                group_key_indices=(), order_specs=order_specs,
                limit=limit, offset=offset, durable=self.durable(),
                pk_indices=list(pk_hint),
                capacity=self.cfg("streaming_top_n_capacity", 1 << 14),
                watchdog_interval=wd),
            inputs=(Exchange(fid),)), dispatch="simple"))
        return top.fid, names, types, pk_hint, False, frozenset()

    # ------------------------------------------------------- over-window
    def _plan_over_window(self, sel: ast.Select, fid: int, scope: Scope,
                          info: RelInfo):
        """SELECT items with OVER clauses -> a general_over_window node
        (eowc_over_window under EMIT ON WINDOW CLOSE) computing every
        window function in one pass, then the final projection; all
        calls must share one window definition, as the JAX planner
        requires."""
        from ..stream.general_over_window import WindowSpec
        frag = self.graph.fragments[fid]
        if sel.group_by:
            raise BindError(
                "window functions cannot be combined with GROUP BY in "
                "one SELECT; aggregate in a subquery first")
        wfs = [it.expr for it in sel.items
               if isinstance(it.expr, ast.WindowFunc)]
        over0 = (tuple(map(repr, wfs[0].partition_by)),
                 tuple((repr(e), d) for e, d in wfs[0].order_by))
        for w in wfs[1:]:
            if (tuple(map(repr, w.partition_by)),
                    tuple((repr(e), d) for e, d in w.order_by)) != over0:
                raise BindError(
                    "all window functions in one SELECT must share the "
                    "same OVER (PARTITION BY ... ORDER BY ...) clause")

        def col_of(e) -> int:
            if not isinstance(e, ast.ColRef):
                raise BindError(
                    "window PARTITION BY / ORDER BY / arguments must be "
                    "plain columns")
            return scope.resolve(e)[0]

        partition_by = [col_of(e) for e in wfs[0].partition_by]
        order_specs = []
        for e, desc in wfs[0].order_by:
            i = col_of(e)
            if scope.schema[i].data_type is DataType.VARCHAR:
                raise BindError(
                    "window ORDER BY over VARCHAR is unsupported (dict "
                    "encoding is not lexicographic)")
            order_specs.append((i, bool(desc)))
        if not order_specs:
            raise BindError("window functions need ORDER BY in OVER()")

        # retractions address rows by the stream key; keyless append-only
        # inputs get a generated row id (as join inputs do)
        sk = info.stream_key
        if sk is None:
            if not info.append_only:
                raise BindError("keyless retracting over-window input")
            frag.root = Node("row_id_gen", {}, inputs=(frag.root,))
            sch2 = Schema(tuple(scope.schema)
                          + (Field("_row_id", DataType.SERIAL),))
            scope = Scope(sch2, dict(scope.names))
            sk = (len(sch2) - 1,)

        windows = []
        for j, w in enumerate(wfs):
            name = w.func.name
            if name in ("row_number", "rank", "dense_rank"):
                windows.append(WindowSpec(name, name=f"w{j}"))
            elif name in ("lag", "lead"):
                if not w.func.args:
                    raise BindError(f"window {name}() needs an argument")
                ai = col_of(w.func.args[0])
                off = 1
                if len(w.func.args) > 1:
                    a1 = w.func.args[1]
                    if not (isinstance(a1, ast.Lit)
                            and isinstance(a1.value, int)
                            and a1.value >= 1):
                        raise BindError(
                            f"{name}() offset must be a positive "
                            "integer literal")
                    off = a1.value
                windows.append(WindowSpec(
                    name, arg=ai, offset=off, name=f"w{j}"))
            elif name == "first_value":
                if not w.func.args:
                    raise BindError("first_value() needs an argument")
                windows.append(WindowSpec(
                    name, arg=col_of(w.func.args[0]), name=f"w{j}"))
            elif name in ("sum", "count", "avg"):
                if not w.func.args:
                    raise BindError(f"window {name}() needs an argument")
                ai = col_of(w.func.args[0])
                if (name in ("sum", "avg")
                        and scope.schema[ai].data_type
                        is DataType.VARCHAR):
                    raise BindError(
                        f"window {name}() over VARCHAR is meaningless "
                        "(dict ids are not numbers)")
                windows.append(WindowSpec(
                    name, arg=ai, preceding=w.preceding, name=f"w{j}"))
            else:
                raise BindError(
                    f"unsupported window function {name!r} (have: "
                    "row_number, rank, dense_rank, lag, lead, "
                    "first_value, sum, count, avg)")

        eowc = getattr(sel, "emit_on_close", False)
        if eowc:
            # the leading ORDER BY column must be watermarked ascending,
            # so that a row's finality is decidable
            oc, odesc = order_specs[0]
            if odesc or oc not in info.wm_cols:
                raise BindError(
                    "EMIT ON WINDOW CLOSE needs the leading window "
                    "ORDER BY column ascending and watermarked")
            if any(w.kind == "lead" for w in windows):
                raise BindError(
                    "EMIT ON WINDOW CLOSE cannot finalize lead()")
        ow_args = dict(
            partition_by=partition_by, order_specs=order_specs,
            windows=windows, pk_indices=list(sk),
            capacity=self.cfg("streaming_over_window_capacity", 1 << 14),
            durable=self.durable())
        if not eowc:
            # the JAX planner shards partitions over a device mesh here
            if (self.cfg("streaming_parallelism_devices", 1) > 1
                    and partition_by):
                raise not_ported("the sharded over-window "
                                 "(streaming_parallelism_devices > 1)")
            ow_args["watchdog_interval"] = (
                1 if self.cfg("streaming_watchdog", 1) else None)
        frag.root = Node(
            "eowc_over_window" if eowc else "general_over_window",
            ow_args, inputs=(frag.root,))
        in_width = len(scope.schema)
        win_fields = []
        out_sch = list(scope.schema)
        for w2 in windows:
            t = w2.ret_type(scope.schema)
            out_sch.append(Field(w2.name, t))
            win_fields.append(t)
        ext_scope = Scope(Schema(tuple(out_sch)), dict(scope.names))

        # final projection: SELECT order + hidden stream-key columns
        exprs, names = [], []
        wj = 0
        for j, it in enumerate(sel.items):
            if isinstance(it.expr, ast.WindowFunc):
                exprs.append(col(in_width + wj, win_fields[wj]))
                names.append(it.alias or f"w{wj}")
                wj += 1
            else:
                exprs.append(bind_scalar(it.expr, ext_scope))
                names.append(it.alias or auto_name(it.expr, j))
        key_pos = []
        for ki in sk:
            found = None
            for j2, e2 in enumerate(exprs):
                if isinstance(e2, InputRef) and e2.index == ki:
                    found = j2
                    break
            if found is None:
                exprs.append(col(ki, ext_scope.schema[ki].data_type))
                names.append(f"_sk{ki}")
                found = len(exprs) - 1
            key_pos.append(found)
        frag.root = Node("project", dict(exprs=exprs, names=names),
                         inputs=(frag.root,))
        # EOWC output is append-only (final rows, exactly once) and
        # carries the watermark on the order column where selected
        wm_out = frozenset()
        if eowc:
            oc = order_specs[0][0]
            wm_out = frozenset(
                j2 for j2, e2 in enumerate(exprs)
                if isinstance(e2, InputRef) and e2.index == oc)
        return (fid, names, [e.ret_type for e in exprs], tuple(key_pos),
                eowc, wm_out)

    # ----------------------------------------------------------- GROUP BY
    def _plan_agg(self, sel: ast.Select, fid: int, scope: Scope,
                  info: RelInfo):
        """COUNT / SUM / MIN / MAX / AVG, bool_and / bool_or (two COUNTs
        and a CASE) and approx_count_distinct (a COUNT, 8 HLL register
        words and an estimate), as the JAX binder's `_plan_agg` plans
        them: a pre-project of the group keys then the agg
        arguments grafted onto `fid`, a hash_agg fragment (hash dispatch
        on the keys; a singleton simple_agg without GROUP BY), a
        post-project of the SELECT items over [keys..., agg outputs...].
        Returns (agg fragment id, names, types, pk positions, watermark
        columns)."""
        frag = self.graph.fragments[fid]
        keys = [bind_scalar(g, scope) for g in sel.group_by]
        key_names = [auto_name(g, j) for j, g in enumerate(sel.group_by)]
        pre_exprs = list(keys)
        pre_names = list(key_names)

        def add_arg(e) -> int:
            pre_exprs.append(bind_scalar(e, scope))
            pre_names.append(f"a{len(pre_exprs)}")
            return len(pre_exprs) - 1

        items_plan = []          # per item: ("key", idx) | ("expr",)
        agg_calls: list[AggCall] = []

        def add_call(kind: AggKind, arg: Optional[int],
                     ret: DataType) -> int:
            # append-only inputs get the running max/min variants
            agg_calls.append(AggCall(kind, arg, ret,
                                     append_only=info.append_only))
            return len(agg_calls) - 1

        nk = len(keys)

        def agg_post(e) -> Expr:
            if e.name in ("bool_and", "bool_or"):
                # retractable as two counts: cn = non-NULL inputs, cf =
                # false (bool_and) / true (bool_or) inputs; NULL when
                # cn = 0
                x = e.args[0]
                cn = add_call(AggKind.COUNT, add_arg(x), DataType.INT64)
                inner = ast.UnOp("not", x) if e.name == "bool_and" else x
                hit = ast.Func("case", [inner, ast.Lit(1)])
                cf = add_call(AggKind.COUNT, add_arg(hit), DataType.INT64)
                cond = call("greater_than", col(nk + cn, DataType.INT64),
                            lit(0))
                val = call("equal" if e.name == "bool_and"
                           else "greater_than",
                           col(nk + cf, DataType.INT64), lit(0))
                return call("case", cond, val)
            if e.name == "approx_count_distinct":
                # 8 hidden register-word calls and the estimate in the
                # post-project (expr/hll.py); NULL when the group saw no
                # non-NULL value
                if not info.append_only:
                    raise BindError(
                        "approx_count_distinct needs an append-only "
                        "input (register max cannot retract)")
                a = add_arg(e.args[0])
                cn = add_call(AggKind.COUNT, a, DataType.INT64)
                lanes = []
                for lane in range(8):
                    agg_calls.append(AggCall(
                        AggKind.HLL_REG, a, DataType.INT64,
                        append_only=True, lane=lane))
                    lanes.append(len(agg_calls) - 1)
                est = call("hll_estimate",
                           *[col(nk + j, DataType.INT64) for j in lanes])
                cond = call("greater_than", col(nk + cn, DataType.INT64),
                            lit(0))
                return call("case", cond, est)
            if e.name == "count":
                idx = add_call(AggKind.COUNT,
                               None if e.star else add_arg(e.args[0]),
                               DataType.INT64)
                return col(nk + idx, DataType.INT64)
            if e.name == "sum":
                a = add_arg(e.args[0])
                at = pre_exprs[a].ret_type
                ret = (DataType.FLOAT64
                       if at in (DataType.FLOAT64, DataType.FLOAT32)
                       else DataType.INT64)
                return col(nk + add_call(AggKind.SUM, a, ret), ret)
            if e.name == "avg":
                # SUM as FLOAT64 and COUNT, divided in the post-project
                a = add_arg(e.args[0])
                s_ = add_call(AggKind.SUM, a, DataType.FLOAT64)
                c_ = add_call(AggKind.COUNT, a, DataType.INT64)
                return call("divide", col(nk + s_, DataType.FLOAT64),
                            col(nk + c_, DataType.INT64))
            if e.name in ("min", "max"):
                a = add_arg(e.args[0])
                at = pre_exprs[a].ret_type
                if at is DataType.VARCHAR:
                    raise BindError(
                        f"streaming {e.name}() over VARCHAR is unsupported "
                        "(dict encoding is not lexicographic)")
                kind = AggKind.MIN if e.name == "min" else AggKind.MAX
                return col(nk + add_call(kind, a, at), at)
            raise not_ported(f"aggregate {e.name}() through SQL")

        def post_of(e) -> Expr:
            """Scalar expression over aggregates and keys."""
            if isinstance(e, ast.Func) and e.name in AGG_FUNCS:
                return agg_post(e)
            if isinstance(e, ast.Lit):
                return lit(e.value)
            if not contains_agg(e):
                bound = bind_scalar(e, scope)
                for kj, ke in enumerate(keys):
                    if repr(ke) == repr(bound):
                        return col(kj, keys[kj].ret_type)
            if isinstance(e, ast.BinOp):
                return call(e.op, post_of(e.left), post_of(e.right))
            if isinstance(e, ast.UnOp):
                return call(e.op, post_of(e.arg))
            raise BindError(
                f"{e}: non-aggregate parts of a SELECT item must appear "
                f"in GROUP BY")

        post, names = [], []
        for j, it in enumerate(sel.items):
            e = it.expr
            names.append(it.alias or auto_name(e, j))
            if not contains_agg(e):
                bound = bind_scalar(e, scope)
                for kj, ke in enumerate(keys):
                    if repr(ke) == repr(bound):
                        items_plan.append(("key", kj))
                        post.append(col(kj, keys[kj].ret_type))
                        break
                else:
                    raise BindError(
                        f"{it.alias or e}: non-aggregate SELECT item "
                        f"must appear in GROUP BY")
            else:
                items_plan.append(("expr",))
                post.append(post_of(e))

        frag.root = Node("project", dict(exprs=pre_exprs, names=pre_names),
                         inputs=(frag.root,))
        # group keys that are direct refs to watermarked input columns:
        # the first becomes the agg's state-cleaning column
        wm_keys = [kj for kj, ke in enumerate(keys)
                   if isinstance(ke, InputRef) and ke.index in info.wm_cols]
        wd = 1 if self.cfg("streaming_watchdog", 1) else None
        if keys:
            frag.dispatch = "hash"
            frag.dist_key_indices = tuple(range(nk))
            agg = self.graph.add(Fragment(self.fid(), Node(
                "hash_agg", dict(
                    group_key_indices=list(range(nk)),
                    agg_calls=agg_calls, durable=self.durable(),
                    capacity=self.cfg("streaming_agg_capacity", 1 << 16),
                    cleaning_watermark_col=(wm_keys[0] if wm_keys
                                            else None),
                    watchdog_interval=wd),
                inputs=(Exchange(fid),)),
                dispatch="hash", dist_key_indices=tuple(range(nk)),
                parallelism=self.parallelism))
        else:
            # global aggregation: a singleton SimpleAgg fragment
            frag.dispatch = "simple"
            agg = self.graph.add(Fragment(self.fid(), Node(
                "simple_agg", dict(agg_calls=agg_calls,
                                   durable=self.durable()),
                inputs=(Exchange(fid),)),
                dispatch="simple"))
        # MV pk = the group keys, which must survive the projection:
        # append any key not already selected
        pk = []
        key_out = {}
        for kj in range(nk):
            found = None
            for j, plan in enumerate(items_plan):
                if plan[0] == "key" and plan[1] == kj:
                    found = j
                    break
            if found is None:
                post.append(col(kj, keys[kj].ret_type))
                names.append(f"_key{kj}")
                found = len(post) - 1
            pk.append(found)
            key_out[kj] = found
        agg.root = Node("project", dict(exprs=post, names=names),
                        inputs=(agg.root,))
        # group-key watermarks pass through the agg re-indexed, then
        # through the post-project on their InputRef positions
        wm_out = frozenset(key_out[kj] for kj in wm_keys)
        return (agg.fid, names, [e.ret_type for e in post], tuple(pk),
                wm_out)

    # ------------------------------------------- snapshot join-agg fusion
    def _try_snapshot_join_agg(self, sel: ast.Select):
        """Fuse the q17 shape — SELECT <global aggs over L> FROM L JOIN
        dim JOIN (SELECT k, <agg exprs> FROM L GROUP BY k) A ON A.k = L.k
        [AND residue] WHERE <single-side filters> — into ONE barrier-
        snapshot executor (stream/snapshot_join_agg.py) when every input
        is append-only. Returns a `_plan_query` result tuple, or None
        when the shape does not match (SET streaming_snapshot_fuse = 0
        forces None); the caller then plans the changelog join cascade
        under a simple agg, as the JAX planner does."""
        if not self.cfg("streaming_snapshot_fuse", 1):
            return None
        if (sel.group_by or sel.order_by or sel.limit is not None
                or sel.offset):
            return None
        if not sel.items or not all(
                isinstance(it.expr, ast.Lit) or contains_agg(it.expr)
                for it in sel.items):
            return None
        if not isinstance(sel.rel, ast.JoinRel):
            return None
        leaves: list = []
        bad: list = []

        def flat(r):
            if isinstance(r, ast.JoinRel):
                if (getattr(r, "join_type", "inner") != "inner"
                        or getattr(r, "temporal", False) or r.on is None):
                    bad.append(r)
                    return
                flat(r.left)
                leaves.append((r.right, r.on))
            else:
                leaves.append((r, None))

        flat(sel.rel)
        if bad or len(leaves) != 3:
            return None
        rels = [l for l, _ in leaves]
        if not isinstance(rels[0], ast.TableRel):
            return None
        sub_pos_leaf = [i for i in (1, 2)
                        if isinstance(rels[i], ast.SubqueryRel)]
        dim_pos_leaf = [i for i in (1, 2)
                        if isinstance(rels[i], ast.TableRel)]
        if len(sub_pos_leaf) != 1 or len(dim_pos_leaf) != 1:
            return None
        fact_rel = rels[0]
        dim_rel = rels[dim_pos_leaf[0]]
        sub_rel = rels[sub_pos_leaf[0]]
        asel = sub_rel.select
        if (not isinstance(asel, ast.Select)
                or len(asel.group_by) != 1 or asel.order_by
                or asel.limit is not None or asel.offset
                or not isinstance(asel.rel, ast.TableRel)
                or asel.rel.name != fact_rel.name):
            return None
        # both scans of L must see identical rows: require a SOURCE (an
        # MV could change between the two logical scans' backfills)
        if fact_rel.name in getattr(self.catalog, "mvs", {}) \
                or dim_rel.name in getattr(self.catalog, "mvs", {}):
            return None
        try:
            fact_src = self.catalog.source(fact_rel.name)
            dim_src = self.catalog.source(dim_rel.name)
        except Exception:
            return None
        dim_pk = dim_src.options.get("primary_key")
        if dim_pk is None:
            return None    # the membership mask needs a UNIQUE dim key
        fscope = Scope.of(fact_src.schema, fact_rel.alias or fact_rel.name)
        dscope = Scope.of(dim_src.schema, dim_rel.alias or dim_rel.name)
        nl, nd = len(fscope.schema), len(dscope.schema)

        # ---- the subquery: key + agg items over its own scan scope
        ascan = Scope.of(fact_src.schema, asel.rel.alias or asel.rel.name)
        try:
            gkey = bind_scalar(asel.group_by[0], ascan)
        except BindError:
            return None
        if not isinstance(gkey, InputRef):
            return None
        fact_key = gkey.index

        def make_decomp(calls: list, scope_: Scope):
            def arg_of(e):
                try:
                    b = bind_scalar(e, scope_)
                except BindError:
                    return None
                return b.index if isinstance(b, InputRef) else None

            def decomp(e):
                if isinstance(e, ast.Func) and e.name in AGG_FUNCS:
                    if e.name == "count":
                        a = None
                        if not getattr(e, "star", False) and e.args:
                            a = arg_of(e.args[0])
                            if a is None:
                                return None
                        calls.append(AggCall(AggKind.COUNT, a,
                                             DataType.INT64, True))
                        return col(len(calls) - 1, DataType.INT64)
                    if not e.args:
                        return None
                    a = arg_of(e.args[0])
                    if a is None:
                        return None
                    at = scope_.schema[a].data_type
                    if at is DataType.VARCHAR and e.name != "count":
                        return None
                    if e.name == "avg":
                        calls.append(AggCall(AggKind.SUM, a,
                                             DataType.FLOAT64, True))
                        s_ = len(calls) - 1
                        calls.append(AggCall(AggKind.COUNT, a,
                                             DataType.INT64, True))
                        return call("divide", col(s_, DataType.FLOAT64),
                                    col(s_ + 1, DataType.INT64))
                    if e.name == "sum":
                        ret = (DataType.FLOAT64
                               if at in (DataType.FLOAT64,
                                         DataType.FLOAT32)
                               else DataType.INT64)
                        calls.append(AggCall(AggKind.SUM, a, ret, True))
                        return col(len(calls) - 1, ret)
                    if e.name not in ("min", "max"):
                        # the JAX package fuses approx_count_distinct,
                        # bool_and and bool_or here as MAX of the column
                        # (ROADMAP accepted difference 8); the port
                        # declines the fusion rather than compute a MAX
                        # where the SQL asks for another aggregate
                        return None
                    kind = (AggKind.MIN if e.name == "min"
                            else AggKind.MAX)
                    calls.append(AggCall(kind, a, at, True))
                    return col(len(calls) - 1, at)
                if isinstance(e, ast.Lit):
                    return lit(e.value)
                if isinstance(e, ast.BinOp):
                    l_, r_ = decomp(e.left), decomp(e.right)
                    if l_ is None or r_ is None:
                        return None
                    return call(e.op, l_, r_)
                if isinstance(e, ast.UnOp):
                    a_ = decomp(e.arg)
                    return None if a_ is None else call(e.op, a_)
                return None
            return decomp

        sub_agg_calls: list[AggCall] = []
        decomp_sub = make_decomp(sub_agg_calls, ascan)
        a_fields, a_items, key_item = [], [], None
        for j, it in enumerate(asel.items):
            name = it.alias or auto_name(it.expr, j)
            if not contains_agg(it.expr):
                try:
                    b = bind_scalar(it.expr, ascan)
                except BindError:
                    return None
                if (not isinstance(b, InputRef) or b.index != fact_key
                        or key_item is not None):
                    return None
                key_item = j
                a_fields.append(Field(name, b.ret_type))
                a_items.append(None)
            else:
                e2 = decomp_sub(it.expr)
                if e2 is None:
                    return None
                a_fields.append(Field(name, e2.ret_type))
                a_items.append(e2)
        if key_item is None:
            return None
        sub_filter = None
        if asel.where is not None:
            try:
                sub_filter = bind_scalar(asel.where, ascan)
            except BindError:
                return None

        # ---- classify every ON + WHERE conjunct
        ascope = Scope.of(Schema(tuple(a_fields)), sub_rel.alias)
        parts = {dim_pos_leaf[0]: dscope, sub_pos_leaf[0]: ascope}
        full = Scope.join(Scope.join(fscope, parts[1]), parts[2])
        offs = {1: nl, 2: nl + len(parts[1].schema)}
        dim_off = offs[dim_pos_leaf[0]]
        a_off = offs[sub_pos_leaf[0]]
        na = len(a_fields)
        conjs = []
        for _, on in leaves[1:]:
            conjs += split_conjuncts(on)
        if sel.where is not None:
            conjs += split_conjuncts(sel.where)
        fact_link = dim_link = None
        fact_filters, dim_filters, residues = [], [], []
        for conj in conjs:
            p = equi_pair(conj, fscope, dscope)
            if p is not None:
                if dim_link is not None or p[1] != dim_pk:
                    return None
                dim_link = p[0]
                continue
            p = equi_pair(conj, fscope, ascope)
            if p is not None and p[1] == key_item:
                if fact_link is not None or p[0] != fact_key:
                    return None
                fact_link = p[0]
                continue
            try:
                b = bind_scalar(conj, full)
            except BindError:
                return None
            refs = input_refs(b)
            if all(i < nl for i in refs):
                fact_filters.append(b)
            elif all(dim_off <= i < dim_off + nd for i in refs):
                dim_filters.append(remap_inputs(
                    b, {i: i - dim_off for i in refs}))
            elif all(i < nl or (a_off <= i < a_off + na
                                and i - a_off != key_item)
                     for i in refs):
                residues.append(b)
            else:
                return None
        # membership is computed on the group-key column: the dim must be
        # keyed by the same L column the aggregate groups on
        if fact_link is None or dim_link is None or dim_link != fact_key:
            return None

        sub_items = [e for e in a_items if e is not None]
        sub_idx = {}
        for j, e in enumerate(a_items):
            if e is not None:
                sub_idx[j] = len(sub_idx)

        def combine(es):
            if not es:
                return None
            e = es[0]
            for r in es[1:]:
                e = call("and", e, r)
            return e

        residue = combine(residues)
        if residue is not None:
            refs = input_refs(residue)
            residue = remap_inputs(residue, {
                i: (i if i < nl else nl + sub_idx[i - a_off])
                for i in refs})
        fact_filter = combine(fact_filters)
        dim_filter = combine(dim_filters)

        # ---- final (global) aggregates over L columns only
        final_agg_calls: list[AggCall] = []
        decomp_fin = make_decomp(final_agg_calls, fscope)
        final_items, names, types = [], [], []
        for j, it in enumerate(sel.items):
            e2 = decomp_fin(it.expr)
            if e2 is None:
                return None
            final_items.append(e2)
            names.append(it.alias or auto_name(it.expr, j))
            types.append(e2.ret_type)

        # ---- everything matches: plan the two scans and emit the node
        lf, _, linfo = self.plan_rel(fact_rel)
        df, _, dinfo = self.plan_rel(dim_rel)
        if not (linfo.append_only and dinfo.append_only):
            return None
        wd = 1 if self.cfg("streaming_watchdog", 1) else None
        node = Node("snapshot_join_agg", dict(
            fact_key=fact_key, dim_key=dim_pk,
            sub_agg_calls=sub_agg_calls, sub_items=sub_items,
            residue=residue, final_agg_calls=final_agg_calls,
            final_items=final_items, out_names=names, out_types=types,
            fact_filter=fact_filter, sub_filter=sub_filter,
            dim_filter=dim_filter,
            capacity=self.cfg("streaming_join_capacity", 1 << 17),
            dim_capacity=self.cfg("streaming_agg_capacity", 1 << 16),
            durable=self.durable(), watchdog_interval=wd),
            inputs=(Exchange(lf), Exchange(df)))
        f = self.graph.add(Fragment(self.fid(), node, dispatch="simple"))
        return (f.fid, names, types, (), False, frozenset())

    # ----------------------------------------------------- optimizer passes
    def _optimize_join(self, jinfo, scope: Scope, info: RelInfo,
                       sel: ast.Select):
        """Bind-time rewrites of a SELECT directly over a join, the JAX
        planner's two passes: (1) predicate pushdown (inner joins): the
        WHERE conjuncts touching one side move below the join, absorbed
        into that side's upstream fragment where it has one consumer;
        (2) join-input pruning: each side narrows to the columns the
        join or the SELECT uses, absorbed likewise."""
        node, nl = jinfo["node"], jinfo["nl"]
        lsch, rsch = jinfo["lsch"], jinfo["rsch"]
        args = node.args

        def refs(e) -> set:
            if isinstance(e, ast.ColRef):
                return {scope.resolve(e)[0]}
            if isinstance(e, ast.BinOp):
                return refs(e.left) | refs(e.right)
            if isinstance(e, ast.UnOp):
                return refs(e.arg)
            if isinstance(e, ast.Func):
                out = set()
                for a in e.args:
                    out |= refs(a)
                return out
            return set()

        # ---- 1. filter pushdown ----
        if sel.where is not None and jinfo["jt"] == "inner":
            def push_filter(side: int, pred) -> None:
                inp = node.inputs[side]
                if (isinstance(inp, Exchange) and
                        len(self.graph.consumers(inp.upstream)) == 1):
                    up = self.graph.fragments[inp.upstream]
                    up.root = Node("filter", dict(predicate=pred),
                                   inputs=(up.root,))
                else:
                    wrapped = Node("filter", dict(predicate=pred),
                                   inputs=(inp,))
                    node.inputs = tuple(
                        wrapped if i == side else x
                        for i, x in enumerate(node.inputs))

            keep = []
            for conj in split_conjuncts(sel.where):
                cols = refs(conj)
                if cols and max(cols) < nl:
                    push_filter(0, bind_scalar(conj, scope))
                elif cols and min(cols) >= nl:
                    push_filter(1, remap_inputs(
                        bind_scalar(conj, scope),
                        {i: i - nl for i in cols}))
                else:
                    keep.append(conj)
            w = None
            for c in keep:
                w = c if w is None else ast.BinOp("and", w, c)
            sel = ast.Select(sel.items, sel.rel, w, sel.group_by,
                             sel.order_by, sel.limit, sel.offset)

        # ---- 2. join input pruning ----
        used = set(info.stream_key or ())
        for it in sel.items:
            used |= refs(it.expr)
        if sel.where is not None:
            used |= refs(sel.where)
        for g in sel.group_by:
            used |= refs(g)
        for e, _ in sel.order_by:
            try:
                used |= refs(e)          # may be an output alias/ordinal
            except BindError:
                pass
        need_l = {i for i in used if i < nl}
        need_r = {i - nl for i in used if i >= nl}
        for side, need in (("left", need_l), ("right", need_r)):
            need |= set(args[f"{side}_key_indices"])
            need |= set(args[f"{side}_pk_indices"])
        cond = args.get("condition")
        if cond is not None:
            for i in input_refs(cond):
                (need_l if i < nl else need_r).add(i if i < nl else i - nl)
        specs = args.get("clean_specs") or (None, None)
        for s, spec in enumerate(specs):
            if spec is None:
                continue
            own, other = (need_l, need_r) if s == 0 else (need_r, need_l)
            own.add(spec[1])
            if spec[0] == "band":
                other.add(spec[2])
                if len(spec) > 4 and spec[4] is not None:
                    own.add(spec[4])
        if len(need_l) == nl and len(need_r) == len(rsch):
            return scope, info, sel     # nothing to prune

        keep_l, keep_r = sorted(need_l), sorted(need_r)
        lmap = {o: n for n, o in enumerate(keep_l)}
        rmap = {o: n for n, o in enumerate(keep_r)}
        jmap = {**{o: lmap[o] for o in keep_l},
                **{o + nl: len(keep_l) + rmap[o] for o in keep_r}}
        new_inputs = []
        for keep, sch, inp in ((keep_l, lsch, node.inputs[0]),
                               (keep_r, rsch, node.inputs[1])):
            if (isinstance(inp, Exchange)
                    and self._push_prune_upstream(inp.upstream, keep, sch)):
                new_inputs.append(inp)
            else:
                new_inputs.append(Node("project", dict(
                    exprs=[col(i, sch[i].data_type) for i in keep],
                    names=[sch[i].name for i in keep]),
                    inputs=(inp,)))
        node.inputs = tuple(new_inputs)
        for side, m in (("left", lmap), ("right", rmap)):
            for k in (f"{side}_key_indices", f"{side}_pk_indices"):
                args[k] = [m[i] for i in args[k]]
        if cond is not None:
            args["condition"] = remap_inputs(cond, jmap)
        if any(specs):
            def remap_spec(spec, s):
                if spec is None:
                    return None
                m, om = (lmap, rmap) if s == 0 else (rmap, lmap)
                if spec[0] == "band":
                    cap = (m[spec[4]] if len(spec) > 4
                           and spec[4] is not None else None)
                    return ("band", m[spec[1]], om[spec[2]], spec[3], cap)
                return (spec[0], m[spec[1]]) + tuple(spec[2:])
            args["clean_specs"] = (remap_spec(specs[0], 0),
                                   remap_spec(specs[1], 1))
        # scope and stream info over the pruned joined schema
        new_fields = tuple(scope.schema[o]
                           for o in sorted(jmap, key=lambda o: jmap[o]))
        new_scope = Scope(Schema(new_fields),
                          {k: (jmap[i], t) for k, (i, t) in
                           scope.names.items() if i in jmap})
        new_info = RelInfo(
            stream_key=(None if info.stream_key is None
                        else tuple(jmap[i] for i in info.stream_key)),
            append_only=info.append_only,
            wm_cols=frozenset(jmap[i] for i in info.wm_cols if i in jmap))
        return new_scope, new_info, sel

    def _push_prune_upstream(self, up_fid: int, keep: list,
                             sch: Schema) -> bool:
        """Absorb an input pruning into the upstream fragment when this
        join is its only consumer: a `project` root narrows to the kept
        expressions, `row_id_gen` composes through (its serial column is
        the last kept index), any other root gets a narrowing project
        grafted on top. False when the upstream is shared."""
        if len(self.graph.consumers(up_fid)) != 1:
            return False
        frag = self.graph.fragments[up_fid]

        def prune_project(p: Node, keep_idx: list) -> Node:
            exprs = p.args["exprs"]
            names = p.args.get("names") or [f"e{i}"
                                            for i in range(len(exprs))]
            args = dict(exprs=[exprs[i] for i in keep_idx],
                        names=[names[i] for i in keep_idx])
            tf = p.args.get("watermark_transforms")
            if tf:
                pos = {o: n for n, o in enumerate(keep_idx)}
                new_tf = {}
                for in_col, spec in tf.items():
                    specs = spec if isinstance(spec, list) else [spec]
                    kept = [(pos[o], fn) for o, fn in specs if o in pos]
                    if kept:
                        new_tf[in_col] = kept
                if new_tf:
                    args["watermark_transforms"] = new_tf
            return Node("project", args, inputs=p.inputs)

        def graft(inner: Node, keep_idx: list) -> Node:
            return Node("project", dict(
                exprs=[col(i, sch[i].data_type) for i in keep_idx],
                names=[sch[i].name for i in keep_idx]),
                inputs=(inner,))

        root = frag.root
        if root.kind == "project":
            frag.root = prune_project(root, keep)
        elif root.kind == "row_id_gen":
            rid = len(sch) - 1
            if rid not in keep:
                return False
            inner_keep = [i for i in keep if i < rid]
            inner = root.inputs[0]
            root.inputs = ((prune_project(inner, inner_keep)
                            if inner.kind == "project"
                            else graft(inner, inner_keep)),)
        else:
            frag.root = graft(root, keep)
        return True


def _now_conjunct(conj, scope: Scope):
    """`col OP now()` (either side, OP an order comparison) -> (column
    index, the dynamic filter's op), else None."""
    if not isinstance(conj, ast.BinOp) or conj.op not in (
            "greater_than", "greater_than_or_equal", "less_than",
            "less_than_or_equal"):
        return None

    def is_now(e):
        return isinstance(e, ast.Func) and e.name == "now" and not e.args

    flip = {"greater_than": "less_than",
            "greater_than_or_equal": "less_than_or_equal",
            "less_than": "greater_than",
            "less_than_or_equal": "greater_than_or_equal"}
    if isinstance(conj.left, ast.ColRef) and is_now(conj.right):
        return scope.resolve(conj.left)[0], conj.op
    if is_now(conj.left) and isinstance(conj.right, ast.ColRef):
        return scope.resolve(conj.right)[0], flip[conj.op]
    return None


def _and_all(conjs: list):
    e = conjs[0]
    for c in conjs[1:]:
        e = ast.BinOp("and", e, c)
    return e


def split_conjuncts(e) -> list:
    if isinstance(e, ast.BinOp) and e.op == "and":
        return split_conjuncts(e.left) + split_conjuncts(e.right)
    return [e]


def band_bound(conj, ls: Scope, rs: Scope, lwm: frozenset, rwm: frozenset):
    """Interval-join cleaning derivation: a comparison conjunct
    normalizing to `X.a > Y.o + d` lets side X evict rows with a below
    wm(Y.o) + d. Requires Y.o to carry a watermark. Returns (side_of_X,
    a_index, o_index, d) or None."""
    if not isinstance(conj, ast.BinOp):
        return None
    if conj.op in ("greater_than", "greater_than_or_equal"):
        big, small = conj.left, conj.right
    elif conj.op in ("less_than", "less_than_or_equal"):
        big, small = conj.right, conj.left
    else:
        return None

    def affine(e):
        if isinstance(e, ast.ColRef):
            return e, 0
        if isinstance(e, ast.BinOp) and e.op in ("add", "subtract"):
            if (isinstance(e.left, ast.ColRef) and isinstance(e.right, ast.Lit)
                    and isinstance(e.right.value, int)):
                return e.left, (e.right.value if e.op == "add"
                                else -e.right.value)
            if (e.op == "add" and isinstance(e.right, ast.ColRef)
                    and isinstance(e.left, ast.Lit)
                    and isinstance(e.left.value, int)):
                return e.right, e.left.value
        return None

    bg = affine(big)
    sm = affine(small)
    if bg is None or sm is None:
        return None
    big, bd = bg
    other_ref, sd = sm
    delta = sd - bd

    def side_of(ref):
        try:
            return ("l", ls.resolve(ref)[0])
        except BindError:
            pass
        try:
            return ("r", rs.resolve(ref)[0])
        except BindError:
            return None

    sb, so = side_of(big), side_of(other_ref)
    if sb is None or so is None or sb[0] == so[0]:
        return None
    if (so[1] not in lwm) if so[0] == "l" else (so[1] not in rwm):
        return None
    return sb[0], sb[1], so[1], delta


def equi_pair(e, ls: Scope, rs: Scope) -> Optional[tuple[int, int]]:
    """col_of_left = col_of_right -> (left_idx, right_idx)."""
    if not (isinstance(e, ast.BinOp) and e.op == "equal"):
        return None
    a, b = e.left, e.right
    if not (isinstance(a, ast.ColRef) and isinstance(b, ast.ColRef)):
        return None

    def side(ref):
        try:
            return ("l", ls.resolve(ref)[0])
        except BindError:
            pass
        try:
            return ("r", rs.resolve(ref)[0])
        except BindError:
            return None

    sa, sb = side(a), side(b)
    if sa is None or sb is None or sa[0] == sb[0]:
        return None
    if sa[0] == "l":
        return (sa[1], sb[1])
    return (sb[1], sa[1])


def expand_star(items, schema) -> list:
    """SELECT * -> one item per schema column (aliases = column names),
    skipping internal columns like _row_id."""
    out = []
    for it in items:
        if isinstance(it.expr, ast.ColRef) and it.expr.name == "*":
            for f in schema:
                if not f.name.startswith("_"):
                    out.append(ast.SelectItem(ast.ColRef(f.name), f.name))
        else:
            out.append(it)
    return out


def auto_name(e, j: int) -> str:
    if isinstance(e, ast.ColRef):
        return e.name
    if isinstance(e, ast.Func):
        return e.name
    return f"expr{j}"
