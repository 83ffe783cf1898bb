"""Differential tests of the port's expressions (kernel K5's plain
version on the CPU) against the JAX package's registry, and of K5's
compiled postfix programs against the tree walk.

Inputs come from a numpy seed: int64, int32 (values near the int32
limits, so int32 arithmetic wraps), float64, booleans, negative and
positive timestamps, each with NULLs. Every ported registry entry is
evaluated by both packages; data must be equal on every valid lane and
the validity masks equal (exact; Kleene and/or included).

K5 cannot run here, so `_emulate` executes the compiled opcode program
with numpy, opcode for opcode as csrc/expr_eval.cu does; it must equal
the tree walk on every lane, valid or not."""

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
    return arrays, valids


TYPES = ["INT64", "INT64", "INT32", "INT32", "FLOAT64", "BOOLEAN",
         "BOOLEAN", "TIMESTAMP", "TIMESTAMP", "INT64", "INT64"]


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
    ]


def _jax_columns(arrays, valids):
    import jax.numpy as jnp
    return [JColumn(jnp.asarray(x), None if v is None else jnp.asarray(v))
            for x, v in zip(arrays, valids)]


def _port_columns(arrays, valids):
    return [Column(torch.from_numpy(np.array(x)),
                   None if v is None else torch.from_numpy(np.array(v)))
            for x, v in zip(arrays, valids)]


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


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
        np.testing.assert_array_equal(pd[jv], jd[jv], err_msg=repr(pe))
        assert (po.valid is None) == (jo.valid is None), repr(pe)
        names.add(getattr(pe, "name", None))
    from risingwave_tpu_torch.expr.registry import registered_names
    assert set(registered_names()) <= names


def _emulate(prog, columns, n, mask=None):
    """csrc/expr_eval.cu's interpreter in numpy: int64 registers (floats
    as their bits), one opcode at a time."""
    P = program
    sd, sv = [], []

    def f(x):
        return x.view(np.float64)

    def bits(x):
        return np.asarray(x, np.float64).view(np.int64)

    ins = [columns[i] for i in prog.inputs]
    outs = []
    with np.errstate(over="ignore", invalid="ignore"):
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
                sd[-1] = f(sd[-1]).astype(np.int64)
            elif op == P.I2B:
                sd[-1] = (sd[-1] != 0).astype(np.int64)
            elif op == P.F2B:
                sd[-1] = (f(sd[-1]) != 0).astype(np.int64)
            elif op == P.WRAP:
                dt = {32: np.int32, 16: np.int16, 8: np.int8}[arg]
                sd[-1] = sd[-1].astype(dt).astype(np.int64)
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
                else:
                    assert op == P.TEND
                    r = a - np.remainder(a, b) + b
                sd[-1], sv[-1] = r, rv
    assert not sd
    return outs


@pytest.mark.parametrize("seed", [0, 1])
def test_compiled_program_matches_tree_walk(seed):
    """The list in programs of three expressions (several outputs a
    launch), each emulated against the tree walk; the whole list is past
    K5's limits and is refused, not split."""
    arrays, valids = _inputs(seed)
    pexprs = _exprs(call, col, lit, DataType, FuncCall)
    pcols = _port_columns(arrays, valids)
    whole = program.ExprProgram(pexprs)
    with pytest.raises(NotImplementedError):
        whole._compile(program._signature(pcols, whole.refs), mask=False)
    done = 0
    for at in range(0, len(pexprs), 3):
        exprs = pexprs[at:at + 3]
        ep = program.ExprProgram(exprs)
        prog = ep._compile(program._signature(pcols, ep.refs), mask=False)
        walked = ep.eval_plain(pcols)
        assert prog.outs == ep.computed
        for k, (j, (d, v)) in enumerate(zip(prog.outs,
                                            _emulate(prog, pcols, N))):
            w = walked[j]
            assert d.dtype == w.data.numpy().dtype, repr(exprs[j])
            np.testing.assert_array_equal(d, w.data.numpy(),
                                          err_msg=repr(exprs[j]))
            np.testing.assert_array_equal(v, w.valid_mask().numpy(),
                                          err_msg=repr(exprs[j]))
            assert prog.out_nullable[k] == (w.valid is not None)
            done += 1
    assert done == sum(type(e).__name__ != "InputRef" for e in pexprs)


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
    prog = ep._compile(program._signature(pcols, ep.refs), mask=True)
    _emulate(prog, pcols, N, mask=emulated)
    np.testing.assert_array_equal(emulated, want)


def test_unsupported_expressions_raise():
    f32 = Column(torch.zeros(4, dtype=torch.float32))
    i64 = Column(torch.zeros(4, dtype=torch.int64))
    bools = Column(torch.zeros(4, dtype=torch.bool))
    cases = [
        ([call("add", col(0, DataType.FLOAT32), col(1))], [f32, i64]),
        ([call("add", col(0, DataType.BOOLEAN), col(1))], [bools, i64]),
        ([call("and", col(0), col(1))], [i64, i64]),
    ]
    for exprs, cols in cases:
        ep = program.ExprProgram(exprs)
        with pytest.raises(NotImplementedError):
            ep._compile(program._signature(cols, ep.refs), mask=False)
