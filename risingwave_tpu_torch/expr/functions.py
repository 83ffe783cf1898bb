"""Scalar function bodies behind the registry (port of
risingwave_tpu/expr/functions.py, the entries Nexmark q1/q2/q7, the
q5 top-N and TPC-H q17 use).

Each body is plain PyTorch over `Column`s with the JAX package's
semantics: one entry covers every numeric width by dtype promotion, the
result is cast to the node's return type, integer remainders and
quotients floor (as jnp's `%` and `//` do: `torch.remainder` floors
too, `fmod` and C's `/` would truncate), a zero divisor gives NULL, and
`and`/`or` follow Kleene three-valued logic. These bodies are the plain
version of kernel K5 (expr/program.py), which lowers the same names to
opcodes.

Left out of this slice (ROADMAP A3): neg, abs,
greatest/least, case, coalesce, hll_estimate, extract/date_trunc, the
math functions, bit ops and the string functions.
"""

from __future__ import annotations

import torch

from ..common.chunk import Column
from ..common.types import DataType
from .registry import and_valid, fixed, kernel, strict

_BOOL = fixed(DataType.BOOLEAN)
_TS = fixed(DataType.TIMESTAMP)


# ------------------------------------------------------------- arithmetic

@kernel("add", input_kinds=("num", "num"))
@strict
def _add(node, a, b):
    return (a + b).to(node.ret_type.torch_dtype)


@kernel("subtract", input_kinds=("num", "num"))
@strict
def _sub(node, a, b):
    return (a - b).to(node.ret_type.torch_dtype)


@kernel("multiply", input_kinds=("num", "num"))
@strict
def _mul(node, a, b):
    return (a * b).to(node.ret_type.torch_dtype)


@kernel("divide", input_kinds=("num", "num"))
def _div(node, cols):
    a, b = cols[0].data, cols[1].data
    valid = and_valid(cols)
    zero = b == 0
    safe = torch.where(zero, torch.ones_like(b), b)
    if node.ret_type.is_float:
        if not (a.is_floating_point() or b.is_floating_point()):
            a = a.to(torch.float64)     # jnp's true division of ints
        out = torch.where(zero, 0.0, a / safe)
    else:
        out = torch.where(zero, 0, torch.div(a, safe, rounding_mode="floor"))
    # a zero divisor gives NULL (the reference's per-row error -> NULL)
    valid = (~zero) if valid is None else (valid & ~zero)
    return Column(out.to(node.ret_type.torch_dtype), valid)


@kernel("modulus", input_kinds=("num", "num"))
def _mod(node, cols):
    a, b = cols[0].data, cols[1].data
    valid = and_valid(cols)
    zero = b == 0
    # x % -1 == x % 1 == 0 for integers: the substitution keeps
    # INT64_MIN % -1 (which traps in C) out of the remainder
    ints = not (a.is_floating_point() or b.is_floating_point())
    unit = zero | (b == -1) if ints else zero
    safe = torch.where(unit, torch.ones_like(b), b)
    # jnp's `%`: the floor remainder, which takes the divisor's sign
    # (numpy's `remainder`; `torch.fmod` would truncate)
    out = torch.where(zero, 0, torch.remainder(a, safe))
    valid = (~zero) if valid is None else (valid & ~zero)
    return Column(out.to(node.ret_type.torch_dtype), valid)


# ------------------------------------------------------------- comparison

def _cmp(op):
    @strict
    def fn(node, a, b):
        return op(a, b)
    return fn


CMP_OPS = {
    "equal": lambda a, b: a == b,
    "not_equal": lambda a, b: a != b,
    "less_than": lambda a, b: a < b,
    "less_than_or_equal": lambda a, b: a <= b,
    "greater_than": lambda a, b: a > b,
    "greater_than_or_equal": lambda a, b: a >= b,
}
for _name, _op in CMP_OPS.items():
    kernel(_name, type_rule=_BOOL, input_kinds=("num", "num"))(_cmp(_op))


# ---------------------------------------------------------------- boolean

@kernel("and", type_rule=_BOOL, input_kinds=("bool", "bool"))
def _and(node, cols):
    a, b = cols
    av, bv = a.valid_mask(), b.valid_mask()
    data = a.data & b.data
    # NULL unless: any FALSE operand (result FALSE) or both valid
    valid = (av & ~a.data) | (bv & ~b.data) | (av & bv)
    if a.valid is None and b.valid is None:
        valid = None
    return Column(data, valid)


@kernel("or", type_rule=_BOOL, input_kinds=("bool", "bool"))
def _or(node, cols):
    a, b = cols
    av, bv = a.valid_mask(), b.valid_mask()
    data = a.data | b.data
    valid = (av & a.data) | (bv & b.data) | (av & bv)
    if a.valid is None and b.valid is None:
        valid = None
    return Column(data, valid)


@kernel("not", type_rule=_BOOL, input_kinds=("bool",))
@strict
def _not(node, a):
    return ~a


@kernel("is_null", type_rule=_BOOL, input_kinds=("any",))
def _is_null(node, cols):
    (a,) = cols
    return Column(~a.valid_mask(), None)


@kernel("is_not_null", type_rule=_BOOL, input_kinds=("any",))
def _is_not_null(node, cols):
    (a,) = cols
    return Column(a.valid_mask(), None)


# ------------------------------------------------------------------- cast

@kernel("cast", input_kinds=("any",))
def _cast(node, cols):
    (a,) = cols
    dst = node.ret_type
    if dst is DataType.BOOLEAN:
        out = a.data != 0
    else:
        out = a.data.to(dst.torch_dtype)
    return Column(out, a.valid)


# --------------------------------------------------------------- datetime
# Timestamps and intervals are int64 microseconds.

@kernel("tumble_start", type_rule=_TS, input_kinds=("ts", "interval"))
@strict
def _tumble_start(node, ts, interval):
    return ts - ts % interval


@kernel("tumble_end", type_rule=_TS, input_kinds=("ts", "interval"))
@strict
def _tumble_end(node, ts, interval):
    return ts - ts % interval + interval

