"""Differential tests of the port's expressions (kernel K5's plain
version on the CPU) against the JAX package's registry, and of K5's
compiled postfix programs against the tree walk.

Inputs come from a numpy seed: int64, int32 (values near the int32
limits, so int32 arithmetic wraps), float64 (also NaN, +-inf, +-0,
rounding ties and out-of-range values), booleans, negative and positive
timestamps (also decades before and after 1970), shift counts past the
width and VARCHAR ids, each with NULLs. Every registry entry is
evaluated by both packages; data must be equal on every valid lane
(strings decoded; the transcendental functions within 2 ulp, cbrt within
128: tests/test_torch_expr_registry.py says why) and the validity masks
equal (exact; Kleene and/or included).

K5 cannot run here, so `_emulate` executes the compiled opcode program
with numpy, opcode for opcode as csrc/expr_eval.cu does; it must equal
the tree walk on every lane, valid or not (the transcendental functions
within 2 ulp: numpy's libm against PyTorch's)."""

import numpy as np
import pytest

from risingwave_tpu.common.chunk import Column as JColumn
from risingwave_tpu.common.types import DataType as JDT
from risingwave_tpu.expr import call as jcall, col as jcol, lit as jlit
from risingwave_tpu.expr.ir import FuncCall as JFuncCall

N = 257


@pytest.fixture(autouse=True, scope="module")
def _port():
    """Import torch and the port when these tests run, not at collection:
    an xdist worker then runs the JAX tests before them without torch
    (the sharded-join recovery tests abort more often with it loaded)."""
    global torch, Column, DataType, call, col, lit, FuncCall, program
    import torch
    from risingwave_tpu_torch.common.chunk import Column
    from risingwave_tpu_torch.common.types import DataType
    from risingwave_tpu_torch.expr import call, col, lit
    from risingwave_tpu_torch.expr import program
    from risingwave_tpu_torch.expr.ir import FuncCall


def _inputs(seed=0):
    """(arrays, valids): a int64, b int64, c int32, d int32, f float64,
    p bool, q bool, ts timestamp, ts2 timestamp, z int64 (small, with
    zeros), m int64 (the int64 limits among small values)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-10**6, 10**6, N)
    b = rng.integers(-10**6, 10**6, N)
    b[::7] = a[::7]                                   # some ties
    c = rng.integers(-2**31, 2**31, N).astype(np.int32)
    d = rng.integers(-2**31, 2**31, N).astype(np.int32)
    f = rng.integers(-4000, 4000, N) / 8.0
    f[::5] = a[::5]                                   # int == float ties
    p = rng.random(N) < 0.5
    q = rng.random(N) < 0.5
    ts = rng.integers(-50_000_000, 50_000_000, N)
    ts2 = ts + rng.integers(-15_000_000, 15_000_000, N)
    arrays = [a, b, c, d, f, p, q, ts, ts2]
    valids = [rng.random(N) < 0.8 if i in (0, 2, 4, 5, 6, 7) else None
              for i in range(len(arrays))]
    # divisors: zeros and negatives, some NULL
    z = rng.integers(-3, 4, N)
    arrays.append(z)
    valids.append(rng.random(N) < 0.9)
    # dividends for modulus: INT64_MIN (% -1 traps in C) and INT64_MAX
    m = rng.integers(-1000, 1000, N)
    m[::4] = np.iinfo(np.int64).min
    m[1::6] = np.iinfo(np.int64).max
    arrays.append(m)
    valids.append(None)
    # g: float hazards; sc: shift counts; t3: timestamps over centuries
    g = rng.normal(0, 1e4, N)
    g[:20] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 0.5, -0.5, 2.5, -2.5,
              0.49999999999999994, 1e19, -1e19, 3e9, -3e9, 1e300, -7.0,
              4503599627370497.0, 9.3e18, -9.3e18, 1.5]
    arrays.append(g)
    valids.append(rng.random(N) < 0.85)
    sc = rng.integers(-3, 70, N)
    sc[:5] = [-1, 0, 63, 64, 32]
    arrays.append(sc)
    valids.append(None)
    day = 86_400_000_000
    t3 = rng.integers(-200 * 365 * day, 200 * 365 * day, N)
    t3[:4] = [-1, 0, 951_782_400_000_000, -day]
    arrays.append(t3)
    valids.append(rng.random(N) < 0.9)
    # strings: indexes into VOCAB (each engine encodes them)
    arrays.append(rng.integers(0, len(VOCAB), N))
    valids.append(rng.random(N) < 0.9)
    return arrays, valids


VOCAB = ["abc", "Person_1x", "  pad  ", "", "CA", "a.b", "x%y", "hello"]
TYPES = ["INT64", "INT64", "INT32", "INT32", "FLOAT64", "BOOLEAN",
         "BOOLEAN", "TIMESTAMP", "TIMESTAMP", "INT64", "INT64", "FLOAT64",
         "INT64", "TIMESTAMP", "VARCHAR"]
ULP_FNS = {"pow", "cbrt", "exp", "ln", "log10", "sin", "cos", "tan",
           "atan"}


def _exprs(call, col, lit, DT, FC):
    """The same expression list in either package."""
    a, b, c, d = (col(i, getattr(DT, TYPES[i])) for i in range(4))
    f, p, q, ts, ts2 = (col(i, getattr(DT, TYPES[i])) for i in range(4, 9))
    z = col(9, DT.INT64)
    m = col(10, DT.INT64)
    W = 10_000_000
    return [
        # modulus: jnp's floor remainder (the divisor's sign), zero ->
        # NULL, INT64_MIN % -1 == 0, int32 operands, int/float promotion,
        # negative float divisors, q5_topn's and q2's literals
        call("modulus", a, z), call("modulus", m, z),
        call("modulus", m, lit(-1)), call("modulus", c, d),
        call("modulus", c, lit(-7)), call("modulus", f, z),
        call("modulus", f, lit(-2.5)), call("modulus", a, lit(0.75)),
        call("modulus", a, lit(65536)),
        call("equal", call("modulus", a, lit(123)), lit(0)),
        call("modulus", a, lit(None)), call("modulus", z, lit(0)),
        # divide: int floor (negative operands, zero -> NULL), int32
        # wrapping, int/float promotion, NULL inputs, q17's avg and
        # `sum / 7.0`, an explicitly float-typed division of ints
        call("divide", a, z), call("divide", c, d),
        call("divide", c, lit(-7)), call("divide", f, z),
        call("divide", a, lit(7.0)), call("divide", a, lit(None)),
        call("multiply", lit(0.2), call("divide", f, a)),
        FC("divide", (a, z), DT.FLOAT64), call("divide", z, lit(0)),
        call("add", a, b), call("subtract", a, b), call("multiply", a, b),
        call("add", c, d), call("multiply", c, d), call("subtract", c, d),
        call("add", a, f), call("multiply", a, lit(0.908)),
        call("subtract", f, lit(3)), call("add", c, a),
        call("add", a, lit(None)),
        call("equal", a, b), call("not_equal", a, b),
        call("less_than", a, f), call("less_than_or_equal", c, a),
        call("greater_than", f, lit(0.5)),
        call("greater_than_or_equal", a, lit(3)), call("equal", a, f),
        call("and", p, q), call("or", p, q), call("not", p),
        call("and", p, lit(None, DT.BOOLEAN)),
        call("or", lit(None, DT.BOOLEAN), q), call("or", lit(True), q),
        call("and", lit(False), lit(None, DT.BOOLEAN)),
        call("is_null", a), call("is_not_null", f), call("is_null", b),
        call("tumble_start", ts, lit(W)), call("tumble_end", ts, lit(W)),
        call("tumble_start", ts, lit(7_000_000)),
        FC("cast", (a,), DT.FLOAT64), FC("cast", (f,), DT.INT64),
        FC("cast", (a,), DT.BOOLEAN), FC("cast", (f,), DT.INT32),
        FC("cast", (c,), DT.INT64), FC("cast", (a,), DT.INT32),
        FC("cast", (f,), DT.BOOLEAN),
        # the q7 band condition and the q1 price projection
        call("and", call("greater_than", ts, call("subtract", ts2, lit(W))),
             call("less_than_or_equal", ts, ts2)),
        call("multiply", FC("cast", (a,), DT.FLOAT64), lit(0.908)),
        a, lit(42), lit(2.5),
    ] + _breadth(call, col, lit, DT, FC)


def _breadth(call, col, lit, DT, FC):
    """The rest of the registry: conditionals, numeric, bit, datetime,
    string functions and the float -> integer casts."""
    a, b, c, d = (col(i, getattr(DT, TYPES[i])) for i in range(4))
    f, p, q = (col(i, getattr(DT, TYPES[i])) for i in range(4, 7))
    m = col(10, DT.INT64)
    g, sc, t3 = col(11, DT.FLOAT64), col(12, DT.INT64), col(13, DT.TIMESTAMP)
    s = col(14, DT.VARCHAR)
    hour = call("extract_hour", t3)
    words = [call("bitwise_and", a, lit(0x3F3F3F3F3F3F3F3F >> k))
             for k in range(8)]
    out = [
        call("neg", a), call("neg", m), call("neg", c), call("neg", g),
        call("abs", m), call("abs", c), call("abs", g),
        call("greatest", a, b, f), call("least", g, f),
        call("greatest", c, d), call("least", a, m, lit(None)),
        call("greatest", g, lit(-0.0)), call("least", lit(0.0), g),
        call("case", p, a, q, b, c),
        call("case", p, f, a), call("case", p, lit(1)),
        call("case", call("greater_than", a, lit(0)), lit("pos"),
             call("less_than", a, lit(0)), lit("neg"), lit("zero")),
        call("case", q, g, lit(None)), call("case", p, c, d),
        call("case", p, FC("cast", (g,), DT.INT64), g),
        call("coalesce", a, b, lit(0)), call("coalesce", f, a),
        call("coalesce", c, d), call("coalesce", lit(None), g),
        call("hll_estimate", *words), call("hll_estimate", *words[:3]),
        call("case", call("greater_than", a, lit(0)),
             call("hll_estimate", *words)),
        call("floor", g), call("ceil", g), call("round", g),
        call("trunc", g), call("sign", g), call("floor", a),
        call("round", m), call("sign", c), call("sign", m),
        call("sqrt", g), call("sqrt", a), call("cbrt", g), call("exp", f),
        call("ln", g), call("log10", a), call("sin", f), call("cos", g),
        call("tan", f), call("atan", g), call("pow", f, lit(2)),
        call("pow", g, c),
        call("bitwise_and", a, b), call("bitwise_or", c, d),
        call("bitwise_xor", m, a), call("bitwise_not", c),
        call("bitwise_shift_left", a, sc), call("bitwise_shift_right", m, sc),
        call("bitwise_shift_left", c, sc), call("bitwise_shift_right", c, sc),
        call("bitwise_shift_right", a, lit(3)),
        call("extract_year", t3), call("extract_month", t3),
        call("extract_day", t3), hour, call("extract_minute", t3),
        call("extract_second", t3), call("extract_dow", t3),
        call("extract_epoch", t3), call("date_trunc_second", t3),
        call("date_trunc_minute", t3), call("date_trunc_hour", t3),
        call("date_trunc_day", t3), call("date_trunc_week", t3),
        call("and", call("greater_than_or_equal", hour, lit(8)),
             call("less_than_or_equal", hour, lit(18))),
        call("lower", s), call("upper", s), call("trim", s),
        call("ltrim", s), call("rtrim", s), call("reverse", s),
        call("md5", s), call("length", s), call("char_length", s),
        call("ascii", s), call("like", s, lit("%a%")),
        call("like", s, lit("a_b")), call("starts_with", s, lit("Pe")),
        call("ends_with", s, lit("c")), call("contains", s, lit("%")),
        call("substr", s, lit(1), lit(4)), call("substr", s, lit(3)),
        call("upper", call("lower", s)),
        call("length", call("substr", s, lit(2), lit(3))),
        call("case", call("like", s, lit("%a%")), call("lower", s),
             lit("none")),
        FC("cast", (g,), DT.INT64), FC("cast", (g,), DT.INT32),
        FC("cast", (g,), DT.INT16), FC("cast", (g,), DT.BOOLEAN),
        # integer CASE conditions (a row holds where the low bit of its
        # condition is set) and booleans in arithmetic, promoted as jnp
        # promotes them (ROADMAP Queue C 1 and 3)
        call("case", a, lit(1), lit(0)), call("case", c, a),
        call("case", m, g, p, c, lit(None)),
        call("add", call("greater_than", a, lit(10)), lit(1)),
        call("add", p, q), call("multiply", p, q), call("add", p, c),
        call("multiply", q, a), call("subtract", c, p),
        call("add", p, f), call("subtract", g, q),
        call("divide", p, call("add", a, lit(0))), call("divide", c, q),
        call("divide", p, lit(2.0)), call("modulus", a, p),
        call("modulus", p, c), call("modulus", p, q),
    ]
    return out


def _encoded(arrays, dictionary):
    """The VARCHAR column as ids of one engine's dictionary."""
    out = list(arrays)
    ids = np.asarray([dictionary.get_or_insert(w) for w in VOCAB], np.int32)
    out[TYPES.index("VARCHAR")] = ids[arrays[TYPES.index("VARCHAR")]]
    return out


def _jax_columns(arrays, valids):
    import jax.numpy as jnp
    from risingwave_tpu.common.types import GLOBAL_DICT as JDICT
    return [JColumn(jnp.asarray(x), None if v is None else jnp.asarray(v))
            for x, v in zip(_encoded(arrays, JDICT), valids)]


def _port_columns(arrays, valids):
    from risingwave_tpu_torch.common.types import GLOBAL_DICT
    return [Column(torch.from_numpy(np.array(x)),
                   None if v is None else torch.from_numpy(np.array(v)))
            for x, v in zip(_encoded(arrays, GLOBAL_DICT), valids)]


def ulp_close(a, b, ulps=2):
    """Elementwise: a and b within `ulps` (chip_smoke.ulp_dist)."""
    import chip_smoke
    return (chip_smoke.ulp_dist(np.asarray(a), np.asarray(b))
            <= ulps).numpy()


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _uses(e, names) -> bool:
    if getattr(e, "name", None) in names:
        return True
    return any(_uses(a, names) for a in getattr(e, "args", ()))


@pytest.mark.parametrize("seed", [0, 1])
def test_every_ported_function_matches_jax(seed):
    arrays, valids = _inputs(seed)
    jexprs = _exprs(jcall, jcol, jlit, JDT, JFuncCall)
    pexprs = _exprs(call, col, lit, DataType, FuncCall)
    jcols, pcols = _jax_columns(arrays, valids), _port_columns(arrays, valids)
    outs = program.ExprProgram(pexprs).eval(pcols)
    names = set()
    for je, pe, po in zip(jexprs, pexprs, outs):
        assert pe.ret_type.value == je.ret_type.value, repr(pe)
        jo = je.eval(jcols)
        jv = _np(jo.valid_mask())
        pv = _np(po.valid_mask())
        np.testing.assert_array_equal(pv, jv, err_msg=repr(pe))
        jd, pd = _np(jo.data), _np(po.data)
        assert pd.dtype == jd.dtype, repr(pe)
        if pe.ret_type is DataType.VARCHAR:
            from risingwave_tpu.common.types import GLOBAL_DICT as JDICT
            from risingwave_tpu_torch.common.types import GLOBAL_DICT
            assert (GLOBAL_DICT.decode_many(pd[jv])
                    == JDICT.decode_many(jd[jv])), repr(pe)
        elif pd.dtype.kind == "f" and _uses(pe, ULP_FNS):
            ulps = 128 if _uses(pe, {"cbrt"}) else 2
            assert ulp_close(pd[jv], jd[jv], ulps).all(), repr(pe)
        else:
            np.testing.assert_array_equal(pd[jv], jd[jv], err_msg=repr(pe))
        assert (po.valid is None) == (jo.valid is None), repr(pe)
        names |= _names(pe)
    from risingwave_tpu_torch.expr.registry import registered_names
    assert set(registered_names()) <= names


def _names(e) -> set:
    out = {getattr(e, "name", None)}
    for a in getattr(e, "args", ()):
        out |= _names(a)
    return out


def _f2i(x, bits):
    """XLA's float -> integer of `bits` width (K5's F2I)."""
    lim = 2.0 ** (bits - 1)
    safe = np.where(np.isnan(x) | (np.abs(x) >= lim), 0.0, x)
    out = np.trunc(safe).astype(np.int64)
    out = np.where(x >= lim, (1 << (bits - 1)) - 1, out)
    out = np.where(x <= -lim, -(1 << (bits - 1)), out)
    return np.where(np.isnan(x), 0, out)


def _floordiv(a, b):
    return np.floor_divide(a, b)


def _civil(days, field):
    z = days + 719468
    era = _floordiv(z, 146097)
    doe = z - era * 146097
    yoe = _floordiv(doe - _floordiv(doe, 1460) + _floordiv(doe, 36524)
                    - _floordiv(doe, 146096), 365)
    doy = doe - (365 * yoe + _floordiv(yoe, 4) - _floordiv(yoe, 100))
    mp = _floordiv(5 * doy + 2, 153)
    d = doy - _floordiv(153 * mp + 2, 5) + 1
    m = mp + np.where(mp < 10, 3, -9)
    return [yoe + era * 400 + (m <= 2), m, d][field]


def _extract(ts, field):
    if field == 7:
        return _floordiv(ts, 1_000_000)
    day = 86_400_000_000
    days = _floordiv(ts, day)
    us = ts - days * day
    if field == 3:
        return _floordiv(us, 3_600_000_000)
    if field == 4:
        return np.remainder(_floordiv(us, 60_000_000), 60)
    if field == 5:
        return np.remainder(_floordiv(us, 1_000_000), 60)
    if field == 6:
        return np.remainder(days + 4, 7)
    return _civil(days, field)


def _hll_est(words):
    inv = np.zeros(words[0].shape[0])
    zeros = np.zeros(words[0].shape[0], np.int64)
    for w in words:
        for b in range(8):
            r = (w >> (8 * b)) & 255
            inv = inv + np.ldexp(1.0, -r)
            zeros += r == 0
    est = (0.709 * 64.0) * 64.0 / inv
    lc = 64.0 * np.log(np.maximum(64.0 / np.maximum(zeros, 1), 1.0))
    est = np.where((est <= 160.0) & (zeros > 0), lc, est)
    return _f2i(np.rint(est), 64)


_MATH = [np.sqrt, np.cbrt, np.exp, np.log, np.log10, np.sin, np.cos,
         np.tan, np.arctan]


def _emulate(prog, columns, n, mask=None):
    """csrc/expr_eval.cu's interpreter in numpy: int64 registers (floats
    as their bits), one opcode at a time."""
    P = program
    from risingwave_tpu_torch.expr import strings
    sd, sv = [], []

    def f(x):
        return x.view(np.float64)

    def bits(x):
        return np.asarray(x, np.float64).view(np.int64)

    ins = [columns[i] for i in prog.inputs]
    tabs = [strings.host_table(spec) for spec in prog.tables]
    outs = []
    with np.errstate(all="ignore"):
        for pc in range(prog.n_code):
            op, arg, imm = prog.ops[pc], prog.args[pc], prog.imms[pc]
            if op == P.LOAD:
                c = ins[arg]
                x = c.data.numpy()
                sd.append(x.view(np.int64) if x.dtype == np.float64
                          else x.astype(np.int64))
                sv.append(np.ones(n, bool) if c.valid is None
                          else c.valid.numpy().copy())
            elif op == P.CONST:
                sd.append(np.full(n, imm, np.int64))
                sv.append(np.ones(n, bool))
            elif op == P.NUL:
                sd.append(np.zeros(n, np.int64))
                sv.append(np.zeros(n, bool))
            elif op == P.IS_NULL:
                sd[-1], sv[-1] = (~sv[-1]).astype(np.int64), np.ones(n, bool)
            elif op == P.IS_NOT_NULL:
                sd[-1], sv[-1] = sv[-1].astype(np.int64), np.ones(n, bool)
            elif op == P.NOT:
                sd[-1] = (sd[-1] == 0).astype(np.int64)
            elif op == P.I2F:
                sd[-1] = bits(sd[-1].astype(np.float64))
            elif op == P.F2I:
                sd[-1] = _f2i(f(sd[-1]), arg or 64)
            elif op == P.I2B:
                sd[-1] = (sd[-1] != 0).astype(np.int64)
            elif op == P.F2B:
                sd[-1] = (f(sd[-1]) != 0).astype(np.int64)
            elif op == P.WRAP:
                dt = {32: np.int32, 16: np.int16, 8: np.int8}[arg]
                sd[-1] = sd[-1].astype(dt).astype(np.int64)
            elif op == P.NEG_I:
                sd[-1] = -sd[-1]
            elif op == P.NEG_F:
                sd[-1] = bits(-f(sd[-1]))
            elif op == P.ABS_I:
                sd[-1] = np.where(sd[-1] < 0, -sd[-1], sd[-1])
            elif op == P.ABS_F:
                sd[-1] = bits(np.abs(f(sd[-1])))
            elif op in (P.FLOOR_F, P.CEIL_F, P.TRUNC_F):
                fn = {P.FLOOR_F: np.floor, P.CEIL_F: np.ceil,
                      P.TRUNC_F: np.trunc}[op]
                sd[-1] = bits(fn(f(sd[-1])))
            elif op == P.ROUND_F:
                x = f(sd[-1])
                sd[-1] = bits(np.trunc(x + np.where(x >= 0, 0.5, -0.5)))
            elif op == P.SIGN_I:
                sd[-1] = np.sign(sd[-1])
            elif op == P.SIGN_F:
                x = f(sd[-1])
                sd[-1] = bits(np.where(x > 0, 1.0, np.where(x < 0, -1.0, x)))
            elif op == P.MATH:
                sd[-1] = bits(_MATH[arg](f(sd[-1])))
            elif op == P.BNOT:
                sd[-1] = ~sd[-1]
            elif op == P.EXTRACT:
                sd[-1] = _extract(sd[-1], arg)
            elif op == P.DTRUNC:
                off = 3 * 86_400_000_000 if arg else 0
                sd[-1] = _floordiv(sd[-1] + off, imm) * imm - off
            elif op == P.GATHER:
                t = tabs[arg]
                sd[-1] = t[np.clip(sd[-1], 0, len(t) - 1)].astype(np.int64)
            elif op in (P.GREATEST, P.LEAST):
                xs, vs = sd[-arg:], sv[-arg:]
                del sd[-arg:], sv[-arg:]
                r, rv = xs[0], vs[0].copy()
                for x, v in zip(xs[1:], vs[1:]):
                    rv &= v
                    if not imm:
                        r = (np.maximum if op == P.GREATEST
                             else np.minimum)(r, x)
                        continue
                    fr, fx = f(r), f(x)
                    eq = (r & x) if op == P.GREATEST else (r | x)
                    gt = fr > fx if op == P.GREATEST else fr < fx
                    lt = fx > fr if op == P.GREATEST else fx < fr
                    nan = np.isnan(fr) | np.isnan(fx)
                    r = np.where(nan, bits(fr + fx),
                                 np.where(gt, r, np.where(lt, x, eq)))
                sd.append(r)
                sv.append(rv)
            elif op == P.CASE:
                m = 2 * arg + (1 if imm else 0)
                xs, vs = sd[-m:], sv[-m:]
                del sd[-m:], sv[-m:]
                r = xs[-1] if imm else np.zeros(n, np.int64)
                rv = vs[-1].copy() if imm else np.zeros(n, bool)
                for k in reversed(range(arg)):
                    hit = vs[2 * k] & (xs[2 * k] != 0)
                    r = np.where(hit, xs[2 * k + 1], r)
                    rv = np.where(hit, vs[2 * k + 1], rv)
                sd.append(r)
                sv.append(rv)
            elif op == P.COALESCE:
                xs, vs = sd[-arg:], sv[-arg:]
                del sd[-arg:], sv[-arg:]
                r, rv = xs[-1], vs[-1].copy()
                for k in reversed(range(arg - 1)):
                    r = np.where(vs[k], xs[k], r)
                    rv = rv | vs[k]
                sd.append(r)
                sv.append(rv)
            elif op == P.HLL_EST:
                xs, vs = sd[-arg:], sv[-arg:]
                del sd[-arg:], sv[-arg:]
                rv = vs[0].copy()
                for v in vs[1:]:
                    rv &= v
                sd.append(_hll_est(xs))
                sv.append(rv)
            elif op == P.OUT:
                d, v = sd.pop(), sv.pop()
                dt = prog.out_dtypes[arg]
                if dt == torch.float64:
                    out = f(d)
                elif dt == torch.bool:
                    out = d != 0
                else:
                    out = d.astype(torch.empty(0, dtype=dt).numpy().dtype)
                outs.append((out, v))
            elif op == P.MASK:
                d, v = sd.pop(), sv.pop()
                mask &= (d != 0) & v
            else:
                b, vb = sd.pop(), sv.pop()
                a, va = sd[-1], sv[-1]
                rv = va & vb
                if op in (P.ADD_I, P.SUB_I, P.MUL_I):
                    r = {P.ADD_I: a + b, P.SUB_I: a - b, P.MUL_I: a * b}[op]
                elif op in (P.ADD_F, P.SUB_F, P.MUL_F):
                    r = bits({P.ADD_F: f(a) + f(b), P.SUB_F: f(a) - f(b),
                              P.MUL_F: f(a) * f(b)}[op])
                elif op in (P.CMP_I, P.CMP_F):
                    x, y = (f(a), f(b)) if op == P.CMP_F else (a, b)
                    r = [x == y, x != y, x < y, x <= y, x > y,
                         x >= y][arg].astype(np.int64)
                elif op == P.AND:
                    r = a & b
                    rv = (va & (a == 0)) | (vb & (b == 0)) | (va & vb)
                elif op == P.OR:
                    r = a | b
                    rv = (va & (a != 0)) | (vb & (b != 0)) | (va & vb)
                elif op == P.DIV_I:
                    zero = b == 0
                    r = np.where(zero, 0, np.floor_divide(
                        a, np.where(zero, 1, b)))
                    rv = rv & ~zero
                elif op == P.DIV_F:
                    zero = f(b) == 0
                    r = bits(np.where(zero, 0.0, f(a) / np.where(
                        zero, 1.0, f(b))))
                    rv = rv & ~zero
                elif op == P.MOD_I:
                    zero = b == 0
                    unit = zero | (b == -1)
                    r = np.where(unit, 0, np.remainder(
                        a, np.where(unit, 1, b)))
                    rv = rv & ~zero
                elif op == P.MOD_F:
                    zero = f(b) == 0
                    den = np.where(zero, 1.0, f(b))
                    t = np.fmod(f(a), den)
                    t = np.where((t != 0) & ((t < 0) != (den < 0)),
                                 t + den, t)
                    r = bits(np.where(zero, 0.0, t))
                    rv = rv & ~zero
                elif op == P.TSTART:
                    r = a - np.remainder(a, b)
                elif op == P.TEND:
                    r = a - np.remainder(a, b) + b
                elif op == P.POW_F:
                    r = bits(np.power(f(a), f(b)))
                elif op in (P.BAND, P.BOR, P.BXOR):
                    r = {P.BAND: a & b, P.BOR: a | b, P.BXOR: a ^ b}[op]
                elif op == P.SHL:
                    oor = (b < 0) | (b >= 64)
                    r = np.where(oor, 0, np.left_shift(a, np.where(oor, 0, b)))
                else:
                    assert op == P.SHR
                    oor = (b < 0) | (b >= 64)
                    r = np.where(oor, np.where(a < 0, -1, 0),
                                 np.right_shift(a, np.where(oor, 0, b)))
                sd[-1], sv[-1] = r, rv
    assert not sd
    return outs


def _check_part(prog, ep, pcols, walked):
    """One compiled program emulated against the tree walk, every lane."""
    done = 0
    for k, (j, (d, v)) in enumerate(zip(prog.outs,
                                        _emulate(prog, pcols, N))):
        e, w = ep.exprs[j], walked[j]
        assert d.dtype == w.data.numpy().dtype, repr(e)
        if d.dtype.kind == "f" and _uses(e, ULP_FNS):
            assert ulp_close(d, w.data.numpy()).all(), repr(e)
        else:
            np.testing.assert_array_equal(d, w.data.numpy(),
                                          err_msg=repr(e))
        np.testing.assert_array_equal(v, w.valid_mask().numpy(),
                                      err_msg=repr(e))
        assert prog.out_nullable[k] == (w.valid is not None), repr(e)
        done += 1
    return done


@pytest.mark.parametrize("seed", [0, 1])
def test_compiled_program_matches_tree_walk(seed):
    """The list in programs of three expressions (several outputs a
    launch), each emulated against the tree walk; the whole list is past
    K5's limits, so it compiles to several programs (one launch each),
    between them every expression once, each equal to the tree walk."""
    arrays, valids = _inputs(seed)
    pexprs = _exprs(call, col, lit, DataType, FuncCall)
    pcols = _port_columns(arrays, valids)
    computed = sum(type(e).__name__ != "InputRef" for e in pexprs)
    whole = program.ExprProgram(pexprs)
    parts = whole._compile(program._signature(pcols, whole.refs),
                           mask=False)
    assert len(parts) > 1
    assert [j for p in parts for j in p.outs] == whole.computed
    walked = whole.eval_plain(pcols)
    assert sum(_check_part(p, whole, pcols, walked)
               for p in parts) == computed
    done = 0
    for at in range(0, len(pexprs), 3):
        ep = program.ExprProgram(pexprs[at:at + 3])
        parts = ep._compile(program._signature(pcols, ep.refs), mask=False)
        assert len(parts) == 1 and parts[0].outs == ep.computed
        done += _check_part(parts[0], ep, pcols, ep.eval_plain(pcols))
    assert done == computed


def test_mask_mode_matches_tree_walk():
    """The join condition's form: mask &= data & valid, in place."""
    arrays, valids = _inputs(2)
    pcols = _port_columns(arrays, valids)
    W = 10_000_000
    ts, ts2 = col(7, DataType.TIMESTAMP), col(8, DataType.TIMESTAMP)
    cond = call("and", call("greater_than", ts, call("subtract", ts2,
                                                     lit(W))),
                call("less_than_or_equal", ts, ts2))
    ep = program.ExprProgram([cond])
    start = np.random.default_rng(3).random(N) < 0.7
    mask = torch.from_numpy(start.copy())
    ep.and_into(pcols, mask)
    pred = cond.eval(pcols)
    want = start & pred.data.numpy() & pred.valid_mask().numpy()
    np.testing.assert_array_equal(mask.numpy(), want)
    emulated = start.copy()
    (prog,) = ep._compile(program._signature(pcols, ep.refs), mask=True)
    _emulate(prog, pcols, N, mask=emulated)
    np.testing.assert_array_equal(emulated, want)
    # a non-boolean condition holds where it is non-zero (the join's
    # `astype(bool)`), a NaN included
    for cond in (col(9, DataType.INT64), col(11, DataType.FLOAT64)):
        ep = program.ExprProgram([cond])
        pred = cond.eval(pcols)
        want = (start & (pred.data.numpy() != 0)
                & pred.valid_mask().numpy())
        mask = torch.from_numpy(start.copy())
        ep.and_into(pcols, mask)
        np.testing.assert_array_equal(mask.numpy(), want)
        emulated = start.copy()
        (prog,) = ep._compile(program._signature(pcols, ep.refs),
                              mask=True)
        _emulate(prog, pcols, N, mask=emulated)
        np.testing.assert_array_equal(emulated, want)


def test_unsupported_expressions_raise():
    f32 = Column(torch.zeros(4, dtype=torch.float32))
    i64 = Column(torch.zeros(4, dtype=torch.int64))
    bools = Column(torch.zeros(4, dtype=torch.bool))
    cases = [
        ([call("add", col(0, DataType.FLOAT32), col(1))], [f32, i64]),
        # jnp refuses to subtract two booleans, and so does K5
        ([call("subtract", col(0, DataType.BOOLEAN),
               col(1, DataType.BOOLEAN))], [bools, bools]),
        ([call("case", col(0, DataType.FLOAT64), col(1))],
         [Column(torch.zeros(4, dtype=torch.float64)), i64]),
        ([call("and", col(0), col(1))], [i64, i64]),
    ]
    for exprs, cols in cases:
        ep = program.ExprProgram(exprs)
        with pytest.raises(NotImplementedError):
            ep._compile(program._signature(cols, ep.refs), mask=False)
