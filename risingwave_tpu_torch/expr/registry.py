"""Declarative scalar-function registry — ONE table: name -> kernel + type
rule (port of risingwave_tpu/expr/registry.py).

A `KernelEntry` carries the function's plain PyTorch body, its type rule
and its input-kind signature. Consumers are table lookups: the tree
evaluator (`FuncCall.eval` in ir.py, the plain version of kernel K5),
return-type inference at build time (`call()` -> `infer_ret_type`), and
the K5 program compiler (expr/program.py), which lowers each registered
name to its opcodes.

Null discipline: `strict` lifts a data-only body to AND-of-valids
propagation; non-strict bodies (Kleene and/or, is_null, case, coalesce)
manage validity themselves.

Every name of the JAX package's registry has an entry here
(`tests/test_torch_expr_registry.py` holds the two lists equal), so the
binder's return-type inference never meets a name the evaluator lacks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from ..common.chunk import Column
from ..common.types import DataType

# ------------------------------------------------------------- type rules

_NUMERIC_ORDER = [
    DataType.BOOLEAN, DataType.INT16, DataType.INT32, DataType.INT64,
    DataType.DECIMAL, DataType.FLOAT32, DataType.FLOAT64,
]

_TIME_TYPES = (DataType.TIMESTAMP, DataType.TIMESTAMPTZ, DataType.DATE,
               DataType.TIME, DataType.INTERVAL)


def _promote(types) -> DataType:
    best = DataType.INT16
    for t in types:
        if t in _TIME_TYPES:
            return t
        if t not in _NUMERIC_ORDER:
            return t
        if _NUMERIC_ORDER.index(t) > _NUMERIC_ORDER.index(best):
            best = t
    return best


def promote(name: str, args) -> DataType:
    """Default rule: numeric promotion over the argument types."""
    return _promote([a.ret_type for a in args])


def fixed(dt: DataType):
    """Rule: the function always returns `dt`."""
    def rule(name: str, args) -> DataType:
        return dt
    return rule


def case_rule(name: str, args) -> DataType:
    """case(c1, v1, ..., [else]): the common type of the VALUE branches."""
    n = len(args)
    vals = [args[2 * i + 1] for i in range(n // 2)]
    if n % 2 == 1:
        vals.append(args[-1])
    ts = [a.ret_type for a in vals]
    if all(t == ts[0] for t in ts):
        return ts[0]     # _promote would degrade BOOLEAN to INT16
    return _promote(ts)


# ------------------------------------------------------------- the table

@dataclass(frozen=True)
class KernelEntry:
    name: str
    kernel: Callable        # (node, cols: Sequence[Column]) -> Column
    type_rule: Callable     # (name, args) -> DataType
    input_kinds: tuple      # ("num", "num"), ("bool",), ... or ()
    variadic: bool = False


_TABLE: dict[str, KernelEntry] = {}
_loaded = False


def kernel(*names: str, type_rule: Optional[Callable] = None,
           input_kinds: Sequence[str] = (), variadic: bool = False):
    """Register a body under one or more names. The decorated callable
    has the evaluator signature `(node, cols) -> Column`."""
    rule = type_rule if type_rule is not None else promote

    def deco(fn):
        for nm in names:
            _TABLE[nm] = KernelEntry(nm, fn, rule, tuple(input_kinds),
                                     variadic)
        return fn
    return deco


def _ensure_loaded() -> None:
    # registrations live in functions.py and strings.py as import side
    # effects; lazy so `registry` itself has no import cycle
    global _loaded
    if not _loaded:
        _loaded = True
        from . import functions, strings  # noqa: F401


def lookup(name: str) -> Callable:
    _ensure_loaded()
    try:
        return _TABLE[name].kernel
    except KeyError:
        raise NotImplementedError(
            f"scalar function {name!r} not registered") from None


def entry(name: str) -> KernelEntry:
    _ensure_loaded()
    return _TABLE[name]


def entries() -> list:
    """Every registered entry, by name (the differential sweep's
    surface)."""
    _ensure_loaded()
    return [_TABLE[k] for k in sorted(_TABLE)]


def registered_names() -> list:
    _ensure_loaded()
    return sorted(_TABLE)


def infer_ret_type(name: str, args) -> DataType:
    _ensure_loaded()
    e = _TABLE.get(name)
    if e is not None:
        return e.type_rule(name, args)
    return promote(name, args)


# ---------------------------------------------------------- null helpers

def and_valid(cols: Sequence[Column]):
    valid = None
    for c in cols:
        if c.valid is not None:
            valid = c.valid if valid is None else (valid & c.valid)
    return valid


def strict(fn):
    """Lift a data-only body to null-propagating (strict) semantics."""
    def wrapped(node, cols: Sequence[Column]) -> Column:
        data = fn(node, *[c.data for c in cols])
        return Column(data, and_valid(cols))
    return wrapped
