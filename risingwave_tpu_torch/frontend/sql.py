"""SQL tokenizer + recursive-descent parser (thin frontend, layer 3).

The port's own copy of the JAX package's module of the same path (pure
Python, copied whole so the port imports nothing of that package).

Reference: src/sqlparser (a 19.7k-LoC sqlparser-rs fork). This is NOT a
port — it covers the streaming-SQL subset the engine executes today:

  CREATE SOURCE name WITH (connector='nexmark', table='bid', ...)
  CREATE MATERIALIZED VIEW name AS SELECT ...
  SELECT <exprs> FROM <rel> [WHERE e] [GROUP BY cols]
  <rel> := table | TUMBLE(table, col, N) | HOP(table, col, slide, size)
         | <rel> JOIN <rel> ON conj
  exprs: + - * / % comparisons AND OR NOT, literals, idents (qualified),
         function calls, COUNT(*)/SUM/MIN/MAX/AVG

Produces plain-dataclass ASTs the binder lowers onto the fragment-graph IR.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

KEYWORDS = {
    "select", "from", "where", "group", "by", "as", "create",
    "materialized", "view", "source", "with", "join", "on", "and", "or",
    "not", "tumble", "hop", "count", "sum", "min", "max", "avg", "limit",
    "order", "desc", "asc", "offset", "between", "emit", "table", "sink",
    "alter", "set", "parallelism", "left", "right", "full", "outer",
    "inner", "over", "partition", "rows", "unbounded", "preceding",
    "current", "row", "for", "system_time", "of", "proctime",
    "case", "when", "then", "else", "end", "in", "is",
    "explain", "show", "insert", "into", "values", "drop",
}

_TOKEN_RE = re.compile(r"""
    \s*(?:
      (?P<num>\d+\.\d+|\d+)
    | (?P<str>'(?:[^']|'')*')
    | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
    | (?P<op><>|<=|>=|!=|=|<|>|\+|-|\*|/|%|\(|\)|,|\.|\;)
    )""", re.VERBOSE)


@dataclass
class Tok:
    kind: str   # num | str | ident | kw | op | eof
    val: str


def tokenize(sql: str) -> list[Tok]:
    out, pos = [], 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m or m.end() == pos:
            if sql[pos:].strip() == "":
                break
            raise SqlError(f"cannot tokenize at: {sql[pos:pos+20]!r}")
        pos = m.end()
        if m.group("num"):
            out.append(Tok("num", m.group("num")))
        elif m.group("str"):
            out.append(Tok("str", m.group("str")[1:-1].replace("''", "'")))
        elif m.group("ident"):
            low = m.group("ident").lower()
            out.append(Tok("kw" if low in KEYWORDS else "ident", low))
        else:
            out.append(Tok("op", m.group("op")))
    out.append(Tok("eof", ""))
    return out


class SqlError(Exception):
    pass


# ----------------------------------------------------------------- AST

@dataclass
class Lit:
    value: object


@dataclass
class ColRef:
    name: str
    qualifier: Optional[str] = None


@dataclass
class Func:
    name: str
    args: list
    star: bool = False      # COUNT(*)


@dataclass
class BinOp:
    op: str
    left: object
    right: object


@dataclass
class UnOp:
    op: str
    arg: object


@dataclass
class SelectItem:
    expr: object
    alias: Optional[str]


@dataclass
class TableRel:
    name: str
    alias: Optional[str] = None


@dataclass
class WindowRel:
    kind: str               # "tumble" | "hop"
    inner: TableRel
    time_col: str
    size: int
    slide: Optional[int] = None
    alias: Optional[str] = None


@dataclass
class JoinRel:
    left: object
    right: object
    on: object                  # None = comma join (ON comes from WHERE)
    join_type: str = "inner"    # inner | left | right | full
    temporal: bool = False      # FOR SYSTEM_TIME AS OF PROCTIME()


@dataclass
class WindowFunc:
    """func(...) OVER (PARTITION BY ... ORDER BY ... [frame])."""

    func: "Func"
    partition_by: list
    order_by: list              # [(expr, descending)]
    preceding: Optional[int] = None   # None = UNBOUNDED PRECEDING


@dataclass
class SetVar:
    name: str
    value: object


@dataclass
class CreateTable:
    name: str
    columns: list       # [(name, type_str)]


@dataclass
class Insert:
    name: str
    rows: list          # [[literal values]]


@dataclass
class Drop:
    kind: str           # materialized_view | table | source | sink
    name: str


@dataclass
class Explain:
    stmt: object


@dataclass
class ExplainMv:
    """EXPLAIN MATERIALIZED VIEW <name> — the DEPLOYED graph of a live
    MV annotated with per-executor HBM accounting (state_bytes /
    evicted_bytes / reload_count), so operators can see which MV owns
    the device memory."""
    name: str


@dataclass
class BackupStmt:
    """BACKUP TO '<path>' — incremental, generation-stamped, verified
    copy of the session's durable state into a local-dir object store
    (state/backup.py). The path also becomes the session's quarantine
    repair source (backup_path)."""
    path: str


@dataclass
class RestoreStmt:
    """RESTORE FROM '<path>' [AT GENERATION <n>] — verify the backup,
    copy it into this session's FRESH primary store, reload
    catalog+manifest, replay the DDL log (cold-start disaster
    recovery). AT GENERATION picks an older retained generation from
    the ledger (point-in-time restore) instead of the newest."""
    path: str
    generation: Optional[int] = None


@dataclass
class Show:
    what: str           # sources|tables|materialized_views|sinks|all|<var>
    limit: object = None   # SHOW events LIMIT n — tail bound
    # SHOW events KIND 'recovery' / SINCE <unix-ts> — filter parity
    # with /debug/events?kind=&since= (meta/monitor_service.py)
    kind: object = None
    since: object = None


@dataclass
class SubqueryRel:
    select: object              # Select
    alias: str


@dataclass
class Select:
    items: list[SelectItem]
    rel: object
    where: Optional[object] = None
    group_by: list = field(default_factory=list)
    order_by: list = field(default_factory=list)   # (expr, descending)
    limit: Optional[int] = None
    offset: int = 0
    emit_on_close: bool = False     # EMIT ON WINDOW CLOSE


@dataclass
class CreateSource:
    name: str
    options: dict


@dataclass
class CreateMV:
    name: str
    select: Select


@dataclass
class CreateSink:
    name: str
    select: Select
    options: dict


@dataclass
class AlterParallelism:
    name: str
    parallelism: int


# --------------------------------------------------------------- parser

class Parser:
    def __init__(self, sql: str):
        self.toks = tokenize(sql)
        self.i = 0

    def peek(self) -> Tok:
        return self.toks[self.i]

    def next(self) -> Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind: str, val: Optional[str] = None) -> Optional[Tok]:
        t = self.peek()
        if t.kind == kind and (val is None or t.val == val):
            return self.next()
        return None

    def expect(self, kind: str, val: Optional[str] = None) -> Tok:
        t = self.accept(kind, val)
        if t is None:
            raise SqlError(f"expected {val or kind}, got {self.peek().val!r}")
        return t

    # ------------------------------------------------------- statements
    def parse_statement(self):
        stmt = self._statement()
        if self.peek().kind != "eof":
            raise SqlError(f"unexpected trailing input at "
                           f"{self.peek().val!r} (unsupported clause?)")
        return stmt

    def _statement(self):
        # BACKUP/RESTORE lead with plain idents (not reserved keywords:
        # a column named `backup` keeps working everywhere else)
        t = self.peek()
        if t.kind == "ident" and t.val == "backup":
            self.next()
            self.expect("ident", "to")
            path = self.expect("str").val
            self.accept("op", ";")
            return BackupStmt(path)
        if t.kind == "ident" and t.val == "restore":
            self.next()
            self.expect("kw", "from")
            path = self.expect("str").val
            generation = None
            if self.accept("ident", "at"):
                self.expect("ident", "generation")
                generation = int(self.expect("num").val)
            self.accept("op", ";")
            return RestoreStmt(path, generation)
        if self.accept("kw", "explain"):
            # EXPLAIN MATERIALIZED VIEW <name>: live deployed graph +
            # memory accounting (a bare EXPLAIN CREATE ... still plans
            # without deploying, below)
            if self.peek().kind == "kw" and self.peek().val == "materialized":
                self.next()
                self.expect("kw", "view")
                name = self.expect("ident").val
                self.accept("op", ";")
                return ExplainMv(name)
            return Explain(self._statement())
        if self.accept("kw", "show"):
            t = self.next()
            if t.kind not in ("ident", "kw"):
                raise SqlError("SHOW needs a target "
                               "(sources|tables|sinks|all|<variable>)")
            what = t.val.lower()
            if what == "materialized":
                if not self.accept("kw", "view"):
                    self.expect("ident", "views")
                what = "materialized_views"
            # else: object class or a session variable name
            limit = kind = since = None
            # KIND '<kind>' / SINCE <unix-ts> / LIMIT n in any order
            # (SHOW events only; other targets simply never match)
            while True:
                if self.accept("kw", "limit"):
                    limit = int(self.expect("num").val)
                elif self.accept("ident", "kind"):
                    kind = self.expect("str").val
                elif self.accept("ident", "since"):
                    since = float(self.expect("num").val)
                else:
                    break
            self.accept("op", ";")
            return Show(what, limit=limit, kind=kind, since=since)
        if self.accept("kw", "set"):
            # SET var = value — session config (reference: session_config/)
            name = self.next().val
            self.expect("op", "=")
            t = self.next()
            val = (float(t.val) if t.kind == "num" and "." in t.val
                   else int(t.val) if t.kind == "num" else t.val)
            self.accept("op", ";")
            return SetVar(name, val)
        if self.accept("kw", "alter"):
            self.expect("kw", "materialized")
            self.expect("kw", "view")
            name = self.expect("ident").val
            self.expect("kw", "set")
            self.expect("kw", "parallelism")
            self.expect("op", "=")
            n = int(self.expect("num").val)
            self.accept("op", ";")
            return AlterParallelism(name, n)
        if self.accept("kw", "drop"):
            if self.accept("kw", "materialized"):
                self.expect("kw", "view")
                kind = "materialized_view"
            elif self.accept("kw", "table"):
                kind = "table"
            elif self.accept("kw", "source"):
                kind = "source"
            elif self.accept("kw", "sink"):
                kind = "sink"
            else:
                raise SqlError(
                    "DROP supports MATERIALIZED VIEW / TABLE / SOURCE "
                    "/ SINK")
            name = self.expect("ident").val
            self.accept("op", ";")
            return Drop(kind, name)
        if self.accept("kw", "insert"):
            self.expect("kw", "into")
            name = self.expect("ident").val
            self.expect("kw", "values")
            rows = []
            while True:
                self.expect("op", "(")
                row = [self._expr()]
                while self.accept("op", ","):
                    row.append(self._expr())
                self.expect("op", ")")
                rows.append(row)
                if not self.accept("op", ","):
                    break
            self.accept("op", ";")
            return Insert(name, rows)
        if self.accept("kw", "create"):
            if self.accept("kw", "table"):
                name = self.expect("ident").val
                t = self.peek()
                if t.kind == "op" and t.val == "(":
                    # CREATE TABLE name (col type, ...) — a DML-able
                    # base table (reference: CREATE TABLE + dml.rs)
                    self.next()
                    cols = []
                    while True:
                        cn = self.expect("ident").val
                        ct = self.next().val
                        cols.append((cn, ct))
                        if not self.accept("op", ","):
                            break
                    self.expect("op", ")")
                    self.accept("op", ";")
                    return CreateTable(name, cols)
                # legacy: CREATE TABLE name WITH (...) = CREATE SOURCE
                self.expect("kw", "with")
                opts = self._with_options()
                self.accept("op", ";")
                return CreateSource(name, opts)
            if self.accept("kw", "source"):
                return self._create_source()
            if self.accept("kw", "sink"):
                name = self.expect("ident").val
                self.expect("kw", "as")
                sel = self._select()
                self.expect("kw", "with")
                opts = self._with_options()
                self.accept("op", ";")
                return CreateSink(name, sel, opts)
            self.expect("kw", "materialized")
            self.expect("kw", "view")
            name = self.expect("ident").val
            self.expect("kw", "as")
            sel = self._select()
            self.accept("op", ";")
            return CreateMV(name, sel)
        sel = self._select()
        self.accept("op", ";")
        return sel

    def _create_source(self) -> CreateSource:
        name = self.expect("ident").val
        self.expect("kw", "with")
        opts = self._with_options()
        self.accept("op", ";")
        return CreateSource(name, opts)

    def _with_options(self) -> dict:
        self.expect("op", "(")
        opts = {}
        while True:
            k = self.next().val
            self.expect("op", "=")
            t = self.next()
            opts[k] = int(t.val) if t.kind == "num" else t.val
            if not self.accept("op", ","):
                break
        self.expect("op", ")")
        return opts

    def _select(self) -> Select:
        self.expect("kw", "select")
        items = [self._select_item()]
        while self.accept("op", ","):
            items.append(self._select_item())
        self.expect("kw", "from")
        rel = self._relation()
        while self.accept("op", ","):
            rel = JoinRel(rel, self._relation(), None)
        where = None
        if self.accept("kw", "where"):
            where = self._expr()
        group_by = []
        if self.accept("kw", "group"):
            self.expect("kw", "by")
            group_by.append(self._expr())
            while self.accept("op", ","):
                group_by.append(self._expr())
        order_by = []
        if self.accept("kw", "order"):
            self.expect("kw", "by")
            while True:
                e = self._expr()
                desc = bool(self.accept("kw", "desc"))
                if not desc:
                    self.accept("kw", "asc")
                order_by.append((e, desc))
                if not self.accept("op", ","):
                    break
        limit = None
        offset = 0
        if self.accept("kw", "limit"):
            limit = int(self.expect("num").val)
        if self.accept("kw", "offset"):
            offset = int(self.expect("num").val)
        eowc = False
        if self.accept("kw", "emit"):
            self.expect("kw", "on")
            self.expect("ident", "window")
            self.expect("ident", "close")
            eowc = True
        return Select(items, rel, where, group_by, order_by, limit,
                      offset, emit_on_close=eowc)

    def _select_item(self) -> SelectItem:
        if self.accept("op", "*"):
            return SelectItem(ColRef("*"), None)
        e = self._expr()
        alias = None
        if self.accept("kw", "as"):
            alias = self.next().val
        elif self.peek().kind == "ident":
            alias = self.next().val
        return SelectItem(e, alias)

    def _relation(self):
        rel = self._rel_primary()
        while True:
            jt = "inner"
            if self.accept("kw", "inner"):
                pass
            elif self.accept("kw", "left"):
                jt = "left"
                self.accept("kw", "outer")
            elif self.accept("kw", "right"):
                jt = "right"
                self.accept("kw", "outer")
            elif self.accept("kw", "full"):
                jt = "full"
                self.accept("kw", "outer")
            elif self.peek().kind == "kw" and self.peek().val == "join":
                pass
            else:
                break
            self.expect("kw", "join")
            right = self._rel_primary()
            temporal = False
            if self.accept("kw", "for"):
                self.expect("kw", "system_time")
                self.expect("kw", "as")
                self.expect("kw", "of")
                self.expect("kw", "proctime")
                self.expect("op", "(")
                self.expect("op", ")")
                temporal = True
            self.expect("kw", "on")
            on = self._expr()
            rel = JoinRel(rel, right, on, jt, temporal)
        return rel

    def _rel_primary(self):
        for kind in ("tumble", "hop"):
            if self.accept("kw", kind):
                self.expect("op", "(")
                inner = TableRel(self.expect("ident").val)
                self.expect("op", ",")
                time_col = self.expect("ident").val
                self.expect("op", ",")
                a = int(self.expect("num").val)
                b = None
                if self.accept("op", ","):
                    b = int(self.expect("num").val)
                self.expect("op", ")")
                alias = None
                if self.accept("kw", "as"):
                    alias = self.next().val
                elif self.peek().kind == "ident":
                    alias = self.next().val
                if kind == "hop":
                    if b is None:
                        raise SqlError("HOP needs (table, col, slide, size)")
                    return WindowRel("hop", inner, time_col, size=b,
                                     slide=a, alias=alias)
                return WindowRel("tumble", inner, time_col, size=a,
                                 alias=alias)
        if self.accept("op", "("):
            if self.peek().kind == "kw" and self.peek().val == "select":
                sub = self._select()
                self.expect("op", ")")
                alias = None
                if self.accept("kw", "as"):
                    alias = self.next().val
                elif self.peek().kind == "ident" \
                        and self.peek().val not in KEYWORDS:
                    alias = self.next().val
                if alias is None:
                    raise SqlError("FROM subquery needs an alias")
                return SubqueryRel(sub, alias)
            rel = self._relation()
            self.expect("op", ")")
            return rel
        name = self.expect("ident").val
        alias = None
        if self.accept("kw", "as"):
            alias = self.next().val
        elif self.peek().kind == "ident" and self.peek().val not in KEYWORDS:
            alias = self.next().val
        return TableRel(name, alias)

    # ------------------------------------------------------ expressions
    def _expr(self):
        return self._or()

    def _or(self):
        e = self._and()
        while self.accept("kw", "or"):
            e = BinOp("or", e, self._and())
        return e

    def _and(self):
        e = self._not()
        while self.accept("kw", "and"):
            e = BinOp("and", e, self._not())
        return e

    def _not(self):
        if self.accept("kw", "not"):
            return UnOp("not", self._not())
        return self._cmp()

    def _cmp(self):
        e = self._add()
        t = self.peek()
        if t.kind == "op" and t.val in ("=", "<>", "!=", "<", "<=", ">", ">="):
            self.next()
            op = {"=": "equal", "<>": "not_equal", "!=": "not_equal",
                  "<": "less_than", "<=": "less_than_or_equal",
                  ">": "greater_than", ">=": "greater_than_or_equal"}[t.val]
            return BinOp(op, e, self._add())
        if self.accept("kw", "between"):
            lo = self._add()
            self.expect("kw", "and")
            hi = self._add()
            return BinOp("and",
                         BinOp("greater_than_or_equal", e, lo),
                         BinOp("less_than_or_equal", e, hi))
        if self.accept("kw", "is"):
            neg = bool(self.accept("kw", "not"))
            self.expect("ident", "null")
            return Func("is_not_null" if neg else "is_null", [e])
        neg = bool(self.accept("kw", "not"))
        if self.accept("kw", "in"):
            # x IN (a, b, c) -> equality OR-chain (NULL semantics match:
            # x = NULL is NULL, and Kleene OR propagates it)
            self.expect("op", "(")
            items = [self._expr()]
            while self.accept("op", ","):
                items.append(self._expr())
            self.expect("op", ")")
            out = BinOp("equal", e, items[0])
            for it in items[1:]:
                out = BinOp("or", out, BinOp("equal", e, it))
            return UnOp("not", out) if neg else out
        if neg:
            self.expect("kw", "in")   # NOT here only prefixes IN
        return e

    def _add(self):
        e = self._mul()
        while True:
            if self.accept("op", "+"):
                e = BinOp("add", e, self._mul())
            elif self.accept("op", "-"):
                e = BinOp("subtract", e, self._mul())
            else:
                return e

    def _mul(self):
        e = self._unary()
        while True:
            if self.accept("op", "*"):
                e = BinOp("multiply", e, self._unary())
            elif self.accept("op", "/"):
                e = BinOp("divide", e, self._unary())
            elif self.accept("op", "%"):
                e = BinOp("modulus", e, self._unary())
            else:
                return e

    def _unary(self):
        if self.accept("op", "-"):
            return UnOp("neg", self._unary())
        return self._primary()

    def _primary(self):
        t = self.next()
        if t.kind == "kw" and t.val == "case":
            # searched (CASE WHEN c THEN v ...) or simple
            # (CASE x WHEN v THEN r ...) form; both lower to the `case`
            # device function (first-match-wins pairs + optional else)
            operand = None
            if not (self.peek().kind == "kw"
                    and self.peek().val == "when"):
                operand = self._expr()
            args = []
            while self.accept("kw", "when"):
                c = self._expr()
                self.expect("kw", "then")
                v = self._expr()
                if operand is not None:
                    c = BinOp("equal", operand, c)
                args += [c, v]
            if not args:
                raise SqlError("CASE needs at least one WHEN")
            if self.accept("kw", "else"):
                args.append(self._expr())
            self.expect("kw", "end")
            return Func("case", args)
        if t.kind == "ident" and t.val.lower() == "null":
            return Lit(None)
        if t.kind == "num":
            return Lit(float(t.val) if "." in t.val else int(t.val))
        if t.kind == "str":
            return Lit(t.val)
        if t.kind == "op" and t.val == "(":
            e = self._expr()
            self.expect("op", ")")
            return e
        if t.kind in ("ident", "kw"):
            name = t.val
            if self.accept("op", "("):
                if name == "count" and self.accept("op", "*"):
                    self.expect("op", ")")
                    return Func("count", [], star=True)
                args = []
                if not self.accept("op", ")"):
                    args.append(self._expr())
                    while self.accept("op", ","):
                        args.append(self._expr())
                    self.expect("op", ")")
                f = Func(name, args)
                if self.accept("kw", "over"):
                    return self._over_clause(f)
                return f
            if self.accept("op", "."):
                col = self.next().val
                return ColRef(col, qualifier=name)
            return ColRef(name)
        raise SqlError(f"unexpected token {t.val!r}")

    def _over_clause(self, f: Func) -> WindowFunc:
        """OVER (PARTITION BY cols ORDER BY col [DESC], ...
        [ROWS BETWEEN n PRECEDING AND CURRENT ROW
         | ROWS UNBOUNDED PRECEDING])"""
        self.expect("op", "(")
        partition_by, order_by, preceding = [], [], None
        if self.accept("kw", "partition"):
            self.expect("kw", "by")
            partition_by.append(self._expr())
            while self.accept("op", ","):
                partition_by.append(self._expr())
        if self.accept("kw", "order"):
            self.expect("kw", "by")
            while True:
                e = self._expr()
                desc = bool(self.accept("kw", "desc"))
                if not desc:
                    self.accept("kw", "asc")
                order_by.append((e, desc))
                if not self.accept("op", ","):
                    break
        if self.accept("kw", "rows"):
            if self.accept("kw", "between"):
                if self.accept("kw", "unbounded"):
                    self.expect("kw", "preceding")
                else:
                    preceding = int(self.expect("num").val)
                    self.expect("kw", "preceding")
                self.expect("kw", "and")
                self.expect("kw", "current")
                self.expect("kw", "row")
            else:
                self.expect("kw", "unbounded")
                self.expect("kw", "preceding")
        self.expect("op", ")")
        return WindowFunc(f, partition_by, order_by, preceding)


def parse(sql: str):
    return Parser(sql).parse_statement()
