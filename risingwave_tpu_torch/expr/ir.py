"""Expression IR — the tree the planner emits and the device evaluates
(port of risingwave_tpu/expr/ir.py).

An `Expr` tree evaluates over a chunk's columns. `eval` walks the tree
with PyTorch ops, one op per node: that is the plain version of kernel
K5. On a CUDA device the executors do not walk the tree: they hand the
expression list to `expr.program.ExprProgram`, which compiles it once
into a postfix program and evaluates every expression of the list in
one launch of K5.

Null semantics: every value carries an optional validity mask (None =
all valid); strict functions propagate NULLs elementwise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch

from ..common.chunk import Column
from ..common.types import DataType, GLOBAL_DICT


class Expr:
    """Base expression node. `ret_type` is static."""

    ret_type: DataType

    def eval(self, columns: Sequence[Column]) -> Column:
        raise NotImplementedError


@dataclass
class InputRef(Expr):
    """Column reference."""

    index: int
    ret_type: DataType = DataType.INT64

    def eval(self, columns):
        return columns[self.index]

    def __repr__(self):
        return f"${self.index}"


@dataclass
class Literal(Expr):
    """Constant. A string literal is dict-encoded at build time."""

    value: Any
    ret_type: DataType = DataType.INT64

    def eval(self, columns):
        cap = columns[0].capacity if columns else 1
        dev = columns[0].data.device if columns else None
        dt = self.ret_type.torch_dtype
        if self.value is None:
            return Column(torch.zeros(cap, dtype=dt, device=dev),
                          torch.zeros(cap, dtype=torch.bool, device=dev))
        return Column(torch.full((cap,), self.encoded(), dtype=dt,
                                 device=dev), None)

    def encoded(self):
        """The value as the device holds it (strings -> dictionary id)."""
        v = self.value
        return GLOBAL_DICT.get_or_insert(v) if isinstance(v, str) else v

    def __repr__(self):
        return f"lit({self.value})"


@dataclass
class FuncCall(Expr):
    """Scalar function application; the body is looked up in the
    registry."""

    name: str
    args: tuple
    ret_type: DataType

    def eval(self, columns):
        from .registry import lookup
        arg_cols = [a.eval(columns) for a in self.args]
        return lookup(self.name)(self, arg_cols)

    def __repr__(self):
        return f"{self.name}({', '.join(map(repr, self.args))})"


def _lit(v) -> Expr:
    if isinstance(v, Expr):
        return v
    if v is None:
        return Literal(None, DataType.INT64)   # typeless SQL NULL
    if isinstance(v, bool):
        return Literal(v, DataType.BOOLEAN)
    if isinstance(v, int):
        return Literal(v, DataType.INT64)
    if isinstance(v, float):
        return Literal(v, DataType.FLOAT64)
    if isinstance(v, str):
        return Literal(v, DataType.VARCHAR)
    raise TypeError(f"cannot lift {v!r} to a literal")


def call(name: str, *args) -> FuncCall:
    """Build a FuncCall with inferred return type."""
    from .registry import infer_ret_type
    args = tuple(_lit(a) for a in args)
    return FuncCall(name, args, infer_ret_type(name, args))


def col(index: int, dtype: DataType = DataType.INT64) -> InputRef:
    return InputRef(index, dtype)


def lit(value, dtype: Optional[DataType] = None) -> Literal:
    e = _lit(value)
    if dtype is not None:
        e.ret_type = dtype
    return e


def input_refs(e: Expr) -> set:
    """All InputRef indices in an expression tree."""
    if isinstance(e, InputRef):
        return {e.index}
    if isinstance(e, FuncCall):
        out = set()
        for a in e.args:
            out |= input_refs(a)
        return out
    return set()


def remap_inputs(e: Expr, mapping: dict) -> Expr:
    """Rewrite InputRef indices through `mapping` (projection pruning)."""
    if isinstance(e, InputRef):
        return InputRef(mapping[e.index], e.ret_type)
    if isinstance(e, FuncCall):
        return FuncCall(e.name, tuple(remap_inputs(a, mapping)
                                      for a in e.args), e.ret_type)
    return e
