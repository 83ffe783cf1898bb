"""String functions over dictionary-encoded VARCHAR columns (port of
risingwave_tpu/expr/strings.py).

VARCHAR columns hold int32 ids of the process-wide `GLOBAL_DICT`, so a
pure string function is a gather through a table built on the host over
the dictionary: `out[i] = table[clip(ids[i])]` with `table[k] =
f(dict[k])`. One table serves every row; building it is O(|dict|) host
work, once per (function, literal) until the dictionary grows.

A function whose result is a string inserts each result into the
dictionary while its table is built (never in a kernel), so every id it
emits decodes. A table is rebuilt when strings came into the dictionary
from anywhere but a table build (a source, a literal, recovery), and
for a call nested in another string function's argument, also when a
table inside that argument minted new results. So nested calls find
their inner results, and tables do not rebuild one another without end
(md5 of every upper-cased md5 ...). An id that a table of another
operator minted after this table's build gathers the clipped last entry,
as under the JAX package's jit, where a table is a constant of the
trace; the JAX package's tree evaluation instead rebuilds whenever the
dictionary's length differs (ROADMAP Queue C, accepted difference 6).

On the CPU the bodies gather with torch; kernel K5 (expr/program.py)
gathers from the same tables, uploaded to the card when rebuilt
(`device_table`), with its GATHER opcode.
"""

from __future__ import annotations

import hashlib
import re
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..common.chunk import Column
from ..common.types import GLOBAL_DICT, DataType
from .registry import and_valid, fixed, kernel, strict

_VARCHAR = fixed(DataType.VARCHAR)
_BOOL = fixed(DataType.BOOLEAN)
_I64 = fixed(DataType.INT64)


class TableSpec(NamedTuple):
    """What a gather reads: the cache key (the function, its literals
    and the keys of the string-result tables inside its argument), f
    over one string (a string result is minted into the dictionary),
    the table's numpy dtype, and those inner keys."""

    key: tuple
    fn: Callable
    np_dtype: type
    inner: tuple


# key -> (external length, inner tables' mint counts, table) at its build
_HOST: dict = {}
# (key, device) -> (the host table it was uploaded from, device tensor)
_DEVICE: dict = {}
# strings minted by table builds: in all, and per table key
_MINTED = {"all": 0}


def _str_result(f):
    return lambda s: GLOBAL_DICT.get_or_insert(f(s))


def _external() -> int:
    """Strings the dictionary holds that no table build minted."""
    return len(GLOBAL_DICT) - _MINTED["all"]


def host_table(spec: TableSpec) -> np.ndarray:
    """The table of `spec` over the dictionary, rebuilt when strings
    came in from outside the tables, or when a table inside its
    argument minted new results, since its build."""
    d = GLOBAL_DICT
    inner = tuple(_MINTED.get(k, 0) for k in spec.inner)
    cached = _HOST.get(spec.key)
    if cached is not None and cached[0] == _external() \
            and cached[1] == inner:
        return cached[2]
    before = len(d)
    vals = [spec.fn(s) for s in list(d._strings)]   # fn may insert
    minted = len(d) - before
    _MINTED["all"] += minted
    _MINTED[spec.key] = _MINTED.get(spec.key, 0) + minted
    table = np.asarray(vals, dtype=spec.np_dtype)
    if table.shape[0] == 0:
        table = np.zeros(1, dtype=spec.np_dtype)
    _HOST[spec.key] = (_external(), inner, table)
    return table


def device_table(spec: TableSpec, device) -> torch.Tensor:
    """`host_table(spec)` on `device`, uploaded again only after a
    rebuild."""
    host = host_table(spec)
    cached = _DEVICE.get((spec.key, device))
    if cached is None or cached[0] is not host:
        cached = (host, torch.from_numpy(host).to(device))
        _DEVICE[(spec.key, device)] = cached
    return cached[1]


def gather(table: np.ndarray, ids: torch.Tensor) -> torch.Tensor:
    t = torch.from_numpy(table).to(ids.device)
    return t[torch.clamp(ids.to(torch.int64), 0, t.shape[0] - 1)]


def _md5(s: str) -> str:
    return hashlib.md5(s.encode()).hexdigest()


STR_FNS = {"lower": str.lower, "upper": str.upper, "trim": str.strip,
           "ltrim": str.lstrip, "rtrim": str.rstrip,
           "reverse": lambda s: s[::-1], "md5": _md5}


def _like_matcher(pattern: str):
    rx = re.compile("".join(
        ".*" if ch == "%" else "." if ch == "_" else re.escape(ch)
        for ch in pattern) + r"\Z", re.S)
    return lambda s: rx.match(s) is not None


STR_PREDS = {"like": _like_matcher,
             "starts_with": lambda p: (lambda s: s.startswith(p)),
             "ends_with": lambda p: (lambda s: s.endswith(p)),
             "contains": lambda p: (lambda s: p in s)}


def _literal(node, pos: int, kind: type, what: str):
    from .ir import Literal
    a = node.args[pos]
    if not isinstance(a, Literal) or not isinstance(a.value, kind) \
            or isinstance(a.value, bool):
        raise NotImplementedError(
            f"{node.name} needs a literal {what} (got {a!r})")
    return a.value


def _inner_keys(e) -> tuple:
    """Keys of the string-result tables inside expression `e`, inner
    first."""
    out = ()
    for a in getattr(e, "args", ()):
        out += _inner_keys(a)
    if getattr(e, "name", None) in STR_FNS or \
            getattr(e, "name", None) == "substr":
        out += (table_spec(e).key,)
    return out


def table_spec(node) -> TableSpec:
    """The gather a string function node lowers to."""
    spec = _base_spec(node)
    inner = _inner_keys(node.args[0])
    return spec._replace(key=spec.key + inner, inner=inner)


def _base_spec(node) -> TableSpec:
    name = node.name
    if name in STR_FNS:
        return TableSpec(("s2s", name), _str_result(STR_FNS[name]),
                         np.int32, ())
    if name in ("length", "char_length"):
        return TableSpec(("len",), len, np.int64, ())
    if name == "ascii":
        return TableSpec(("ascii",), lambda s: ord(s[0]) if s else 0,
                         np.int64, ())
    if name in STR_PREDS:
        pat = _literal(node, 1, str, "pattern")
        pred = STR_PREDS[name](pat)
        return TableSpec((name, pat), lambda s: bool(pred(s)), np.bool_,
                         ())
    if name == "substr":
        s0 = int(_literal(node, 1, int, "start"))
        cnt = (int(_literal(node, 2, int, "count"))
               if len(node.args) > 2 else None)

        def sub(s):
            begin = max(0, s0 - 1)
            return s[begin:begin + cnt] if cnt is not None else s[begin:]
        return TableSpec(("substr", s0, cnt), _str_result(sub), np.int32,
                         ())
    raise NotImplementedError(f"{name} is not a string function")


GATHER_FNS = (tuple(STR_FNS) + ("length", "char_length", "ascii")
              + tuple(STR_PREDS) + ("substr",))


def _gather_body(node, ids):
    return gather(host_table(table_spec(node)), ids)


for _name in STR_FNS:
    kernel(_name, type_rule=_VARCHAR, input_kinds=("str",))(
        strict(_gather_body))
kernel("length", "char_length", type_rule=_I64, input_kinds=("str",))(
    strict(_gather_body))
kernel("ascii", type_rule=_I64, input_kinds=("str",))(strict(_gather_body))


def _pred_body(node, cols):
    """A predicate with a literal pattern: NULL only where the string
    is."""
    return Column(_gather_body(node, cols[0].data), and_valid(cols[:1]))


for _name in STR_PREDS:
    kernel(_name, type_rule=_BOOL, input_kinds=("str", "lit"))(_pred_body)


@kernel("substr", type_rule=_VARCHAR, input_kinds=("str", "lit"),
        variadic=True)
@strict
def _substr(node, ids, *_positions):
    """substr(s, start[, count]) with literal positions (1-based, as
    PostgreSQL counts)."""
    return _gather_body(node, ids)
