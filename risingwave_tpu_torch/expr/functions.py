"""Scalar function bodies behind the registry (port of
risingwave_tpu/expr/functions.py, every entry; the string functions are
in strings.py).

Each body is plain PyTorch over `Column`s with the JAX package's
semantics: one entry covers every numeric width by dtype promotion, the
result is cast to the node's return type, integer remainders and
quotients floor (as jnp's `%` and `//` do: `torch.remainder` floors
too, `fmod` and C's `/` would truncate), a zero divisor gives NULL, and
`and`/`or` follow Kleene three-valued logic. A float converted to an
integer saturates and NaN gives 0, as XLA converts (`f2i`; torch's `.to`
would give INT64_MIN). Float maxima and minima propagate NaN and order
-0.0 below +0.0, as XLA's do. These bodies are the plain version of
kernel K5 (expr/program.py), which lowers the same names to opcodes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common.chunk import Column
from ..common.types import DataType
from .registry import and_valid, case_rule, fixed, kernel, strict

_BOOL = fixed(DataType.BOOLEAN)
_I64 = fixed(DataType.INT64)
_F64 = fixed(DataType.FLOAT64)
_TS = fixed(DataType.TIMESTAMP)


def f2i(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Float -> integer as XLA converts on the CPU: toward zero,
    saturating at the type's limits, NaN to 0."""
    info = torch.iinfo(dtype)
    x = x.to(torch.float64)
    out = torch.where(x != x, 0.0, x).clamp(-(2.0 ** (info.bits - 1)),
                                            2.0 ** (info.bits - 1))
    hi = out >= 2.0 ** (info.bits - 1)
    out = torch.where(hi, 0.0, out).to(torch.int64)
    return torch.where(hi, info.max, out).to(dtype)


def astype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """jnp's `astype`: `f2i` for float -> integer, `.to` otherwise."""
    if x.is_floating_point() and dtype not in (torch.bool, torch.float16,
                                               torch.float32, torch.float64):
        return f2i(x, dtype)
    return x.to(dtype)


def fmax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.maximum: NaN propagates, max(-0.0, +0.0) is +0.0."""
    if not a.is_floating_point():
        return torch.maximum(a, b)
    both = (a.view(torch.int64) & b.view(torch.int64)).view(torch.float64)
    r = torch.where(a > b, a, torch.where(b > a, b, both))
    return torch.where(torch.isnan(a) | torch.isnan(b), a + b, r)


def fmin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.minimum: NaN propagates, min(-0.0, +0.0) is -0.0."""
    if not a.is_floating_point():
        return torch.minimum(a, b)
    both = (a.view(torch.int64) | b.view(torch.int64)).view(torch.float64)
    r = torch.where(a < b, a, torch.where(b < a, b, both))
    return torch.where(torch.isnan(a) | torch.isnan(b), a + b, r)


def _promoted(args) -> torch.dtype:
    dt = args[0].dtype
    for a in args[1:]:
        dt = torch.promote_types(dt, a.dtype)
    return dt


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


@kernel("neg", input_kinds=("num",))
@strict
def _neg(node, a):
    return -a


@kernel("abs", input_kinds=("num",))
@strict
def _abs(node, a):
    return torch.abs(a)


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


@kernel("greatest", input_kinds=("num",), variadic=True)
@strict
def _greatest(node, *args):
    dt = _promoted(args)
    out = args[0].to(dt)
    for a in args[1:]:
        out = fmax(out, a.to(dt))
    return out


@kernel("least", input_kinds=("num",), variadic=True)
@strict
def _least(node, *args):
    dt = _promoted(args)
    out = args[0].to(dt)
    for a in args[1:]:
        out = fmin(out, a.to(dt))
    return out


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


# ------------------------------------------------------------ conditional

@kernel("case", type_rule=case_rule, input_kinds=("bool", "any"),
        variadic=True)
def _case(node, cols):
    """case(cond1, val1, cond2, val2, ..., [else]): the first match
    wins."""
    n = len(cols)
    has_else = n % 2 == 1
    pairs = (n - 1) // 2 if has_else else n // 2
    dt = node.ret_type.torch_dtype
    if has_else:
        out, valid = astype(cols[-1].data, dt), cols[-1].valid_mask()
    else:
        out = torch.zeros(cols[1].capacity, dtype=dt,
                          device=cols[1].data.device)
        valid = torch.zeros(cols[1].capacity, dtype=torch.bool,
                            device=cols[1].data.device)
    for i in reversed(range(pairs)):
        cond, val = cols[2 * i], cols[2 * i + 1]
        hit = cond.valid_mask() & cond.data
        out = torch.where(hit, astype(val.data, dt), out)
        valid = torch.where(hit, val.valid_mask(), valid)
    return Column(out, valid)


@kernel("coalesce", input_kinds=("any",), variadic=True)
def _coalesce(node, cols):
    dt = node.ret_type.torch_dtype
    out = astype(cols[-1].data, dt)
    valid = cols[-1].valid_mask()
    for c in reversed(cols[:-1]):
        cv = c.valid_mask()
        out = torch.where(cv, astype(c.data, dt), out)
        valid = cv | valid
    return Column(out, valid)


@kernel("hll_estimate", type_rule=_I64, input_kinds=("num",), variadic=True)
def _hll_estimate(node, cols):
    from .hll import estimate_from_words
    out = estimate_from_words([c.data for c in cols])
    valid = cols[0].valid_mask()
    for c in cols[1:]:
        valid = valid & c.valid_mask()
    return Column(out, valid)


# ------------------------------------------------------------------- cast

@kernel("cast", input_kinds=("any",))
def _cast(node, cols):
    (a,) = cols
    dst = node.ret_type
    if dst is DataType.BOOLEAN:
        out = a.data != 0
    else:
        out = astype(a.data, dst.torch_dtype)
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



@kernel("extract_epoch", type_rule=_I64, input_kinds=("ts",))
@strict
def _extract_epoch(node, ts):
    return torch.div(ts, 1_000_000, rounding_mode="floor")


# ------------------------------------------------------- numeric breadth

def _is_int(a: torch.Tensor) -> bool:
    return not a.is_floating_point()


@kernel("floor", input_kinds=("num",))
@strict
def _floor(node, a):
    out = a if _is_int(a) else torch.floor(a)
    return astype(out, node.ret_type.torch_dtype)


@kernel("ceil", input_kinds=("num",))
@strict
def _ceil(node, a):
    out = a if _is_int(a) else torch.ceil(a)
    return astype(out, node.ret_type.torch_dtype)


@kernel("round", input_kinds=("num",))
@strict
def _round(node, a):
    # halves away from zero, as trunc(a +- 0.5) (so 0.49999999999999994
    # rounds to 1); integers pass through unchanged
    if _is_int(a):
        return a.to(node.ret_type.torch_dtype)
    return astype(torch.trunc(a + torch.where(a >= 0, 0.5, -0.5)),
                  node.ret_type.torch_dtype)


@kernel("trunc", input_kinds=("num",))
@strict
def _trunc(node, a):
    out = a if _is_int(a) else torch.trunc(a)
    return astype(out, node.ret_type.torch_dtype)


@kernel("sign", input_kinds=("num",))
@strict
def _sign(node, a):
    out = torch.sign(a)
    if a.is_floating_point():
        # jnp.sign keeps -0.0 and NaN (torch's gives +0.0 for both)
        out = torch.where((a == 0) | torch.isnan(a), a, out)
    return astype(out, node.ret_type.torch_dtype)


def _f64(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.float64)


@kernel("pow", type_rule=_F64, input_kinds=("num", "num"))
@strict
def _pow(node, a, b):
    return torch.pow(_f64(a), _f64(b))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    # PyTorch's CPU sqrt of float64 is off by an ulp on ~1% of inputs;
    # numpy's (as XLA's and CUDA's) is correctly rounded
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    # torch has no cbrt: a power of 1/3 and one Newton step (within an
    # ulp of libm's cbrt)
    y = torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)
    step = (y * y * y - x) / (3.0 * y * y)
    return torch.where(torch.isfinite(step) & (y != 0), y - step, y)


_UNARY_F64 = {
    "sqrt": _sqrt, "cbrt": _cbrt, "exp": torch.exp, "ln": torch.log,
    "log10": torch.log10, "sin": torch.sin, "cos": torch.cos,
    "tan": torch.tan, "atan": torch.atan,
}


def _unary_f64(fn):
    @strict
    def body(node, a):
        return fn(_f64(a))
    return body


for _name, _fn in _UNARY_F64.items():
    kernel(_name, type_rule=_F64, input_kinds=("num",))(_unary_f64(_fn))


@kernel("bitwise_and", input_kinds=("num", "num"))
@strict
def _bit_and(node, a, b):
    return a & b


@kernel("bitwise_or", input_kinds=("num", "num"))
@strict
def _bit_or(node, a, b):
    return a | b


@kernel("bitwise_xor", input_kinds=("num", "num"))
@strict
def _bit_xor(node, a, b):
    return a ^ b


@kernel("bitwise_not", input_kinds=("num",))
@strict
def _bit_not(node, a):
    return ~a


def _shift_args(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dt), b.to(dt)
    bits = torch.iinfo(dt).bits
    out_of_range = (b < 0) | (b >= bits)
    return a, torch.where(out_of_range, 0, b), out_of_range


@kernel("bitwise_shift_left", input_kinds=("num", "num"))
@strict
def _shl(node, a, b):
    # XLA's ShiftLeft: a count below 0 or from the width up gives 0
    a, b, oor = _shift_args(a, b)
    return torch.where(oor, 0, a << b)


@kernel("bitwise_shift_right", input_kinds=("num", "num"))
@strict
def _shr(node, a, b):
    # XLA's arithmetic ShiftRight: an out-of-range count fills with the
    # sign
    a, b, oor = _shift_args(a, b)
    return torch.where(oor, torch.where(a < 0, -1, 0), a >> b)


# ------------------------------------------------------ datetime breadth
# Calendar fields from int64 microseconds since the unix epoch by the
# branchless civil-from-days algorithm (floor divisions throughout, so
# instants before 1970 land in the right day).

US_PER_DAY = 86_400_000_000


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def civil_from_days(z: torch.Tensor):
    """days since the epoch -> (year, month, day)."""
    z = z + 719_468
    era = _fdiv(z, 146_097)
    doe = z - era * 146_097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36_524)
                - _fdiv(doe, 146_096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(y.dtype)
    return y, m, d


def _days_and_us(ts):
    ts = ts.to(torch.int64)
    days = _fdiv(ts, US_PER_DAY)
    return days, ts - days * US_PER_DAY


EXTRACT_FIELDS = ("year", "month", "day", "hour", "minute", "second", "dow")


def extract_field(ts: torch.Tensor, field: str) -> torch.Tensor:
    days, us = _days_and_us(ts)
    if field in ("year", "month", "day"):
        return civil_from_days(days)[("year", "month", "day").index(field)]
    if field == "hour":
        return _fdiv(us, 3_600_000_000)
    if field == "minute":
        return torch.remainder(_fdiv(us, 60_000_000), 60)
    if field == "second":
        return torch.remainder(_fdiv(us, 1_000_000), 60)
    # 1970-01-01 was a Thursday (dow 4, Sunday = 0)
    return torch.remainder(days + 4, 7)


def _extract(field):
    @strict
    def body(node, ts):
        return extract_field(ts, field)
    return body


for _field in EXTRACT_FIELDS:
    kernel(f"extract_{_field}", type_rule=_I64, input_kinds=("ts",))(
        _extract(_field))


TRUNC_US = {
    "second": 1_000_000,
    "minute": 60_000_000,
    "hour": 3_600_000_000,
    "day": US_PER_DAY,
    "week": 7 * US_PER_DAY,
}


def trunc_offset(unit: str) -> int:
    """date_trunc's shift of the epoch: weeks start on Monday, three days
    before the epoch's Thursday."""
    return 3 * US_PER_DAY if unit == "week" else 0


@kernel("date_trunc_second", "date_trunc_minute", "date_trunc_hour",
        "date_trunc_day", "date_trunc_week", type_rule=_TS,
        input_kinds=("ts",))
def _date_trunc(node, cols):
    unit = node.name.rsplit("_", 1)[1]
    us = TRUNC_US[unit]
    off = trunc_offset(unit)
    ts = cols[0]
    data = _fdiv(ts.data.to(torch.int64) + off, us) * us - off
    return Column(data.to(node.ret_type.torch_dtype), ts.valid)
