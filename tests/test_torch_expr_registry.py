"""Differential sweep of the port's expression registry (the plain
version of kernel K5) against the JAX package's registry: every entry,
on the inputs of tests/test_kernel_registry.py's generator (int, float,
str and ts columns with NULLs, the variadic arities and the literals),
plus hazard inputs (NaN, +-inf, +-0, out-of-range float -> int casts,
rounding ties, INT64_MIN, shift counts past the width, timestamps before
1970 and on 29 February).

The JAX side evaluates device arrays (jnp), as its executors do, so its
casts are XLA's. Integers, booleans, validity and the inferred types
must be equal; strings are compared decoded (each engine's dictionary
assigns its own ids); floats bit for bit (NaN equal to NaN, sqrt
included) except the transcendental functions, within 2 ulp (XLA's CPU
and PyTorch's libm differ in the last places), and cbrt: XLA's CPU cbrt
is up to ~100 ulp off a correctly rounded one at the extremes (1e300,
1e-300), so the port's is held to numpy's within 1 ulp and to JAX's
within 128 ulp. XLA's CPU flushes subnormal results to zero (exp of a
large negative argument) where the port keeps IEEE's gradual underflow
(ROADMAP Queue C, accepted difference 7): in the ulp comparison a
subnormal equals a zero. hll_estimate sums 2^-register over 64
registers: exact, so both engines agree bit for bit, when the
registers span fewer than 53 binary orders (every sketch of fewer than
~2^47 distinct values); the generator's arbitrary words (bytes up to
255) beyond that are held within a relative 1e-14, since the two sum in
different orders.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest

from risingwave_tpu.common.chunk import Column as JColumn
from risingwave_tpu.common.types import GLOBAL_DICT as JDICT
from risingwave_tpu.common.types import DataType as JDT
from risingwave_tpu.expr.ir import FuncCall as JFuncCall
from risingwave_tpu.expr.ir import InputRef as JInputRef
from risingwave_tpu.expr.ir import Literal as JLiteral
from risingwave_tpu.expr.registry import entry as jentry
from risingwave_tpu.expr.registry import infer_ret_type as jinfer
from risingwave_tpu.expr.registry import registered_functions

import test_kernel_registry as gen
# the autouse fixture that drops the strings a test minted from both
# engines' dictionaries when it ends (one definition, in test_torch_expr)
from test_torch_expr import _minted_strings_leave  # noqa: F401

ULP_FNS = {"pow", "cbrt", "exp", "ln", "log10", "sin", "cos", "tan",
           "atan"}
ULPS = 2
CBRT_ULPS = 128


@pytest.fixture(autouse=True, scope="module")
def _port():
    """Import torch and the port when these tests run, not at
    collection."""
    global torch, Column, DataType, FuncCall, InputRef, Literal, GLOBAL_DICT
    global preg
    import torch
    from risingwave_tpu_torch.common.chunk import Column
    from risingwave_tpu_torch.common.types import GLOBAL_DICT, DataType
    from risingwave_tpu_torch.expr.ir import FuncCall, InputRef, Literal
    from risingwave_tpu_torch.expr import registry as preg


def _port_node(jnode):
    """The same call tree in the port's IR (string literals stay
    strings; each engine encodes them in its own dictionary)."""
    if isinstance(jnode, JInputRef):
        return InputRef(jnode.index, DataType(jnode.ret_type.value))
    if isinstance(jnode, JLiteral):
        return Literal(jnode.value, DataType(jnode.ret_type.value))
    return FuncCall(jnode.name, tuple(_port_node(a) for a in jnode.args),
                    DataType(jnode.ret_type.value))


def _jax_cols(arrays, valids):
    return [JColumn(jnp.asarray(np.asarray(a)),
                    None if v is None else jnp.asarray(np.asarray(v)))
            for a, v in zip(arrays, valids)]


def _port_cols(jcols, types):
    out = []
    for c, dt in zip(jcols, types):
        data = np.asarray(c.data)
        if dt is JDT.VARCHAR:
            data = np.asarray([GLOBAL_DICT.get_or_insert(s) for s in
                               JDICT.decode_many(data)], dtype=np.int32)
        out.append(Column(torch.from_numpy(np.array(data)),
                          None if c.valid is None else
                          torch.from_numpy(np.array(c.valid))))
    return out


def ulp_close(a, b, ulps=2):
    """Elementwise: a and b within `ulps` (chip_smoke.ulp_dist)."""
    import chip_smoke
    return (chip_smoke.ulp_dist(np.asarray(a), np.asarray(b))
            <= ulps).numpy()


def _compare(name, jnode, jcols, pnode, pcols):
    jo = jnode.eval(jcols)
    po = pnode.eval(pcols)
    assert pnode.ret_type.value == jnode.ret_type.value, name
    jv = np.asarray(jo.valid_mask())
    pv = po.valid_mask().numpy()
    np.testing.assert_array_equal(pv, jv, err_msg=f"{name}: validity")
    assert (po.valid is None) == (jo.valid is None), name
    jd, pd = np.asarray(jo.data), po.data.numpy()
    assert pd.dtype == jd.dtype, f"{name}: {pd.dtype} != {jd.dtype}"
    jd, pd = jd[jv], pd[jv]
    if pnode.name == "hll_estimate":
        words = [pcols[a.index].data[torch.from_numpy(jv)] for a in
                 pnode.args]
        from risingwave_tpu_torch.expr.hll import registers
        regs = registers(words + [torch.zeros_like(words[0])]
                         * (8 - len(words)))
        exact = (regs.max(-1).values - regs.min(-1).values).numpy() < 53
        np.testing.assert_array_equal(pd[exact], jd[exact], err_msg=name)
        np.testing.assert_allclose(pd[~exact].astype(np.float64),
                                   jd[~exact].astype(np.float64),
                                   rtol=1e-14, err_msg=name)
    elif pnode.ret_type is DataType.VARCHAR:
        assert GLOBAL_DICT.decode_many(pd) == JDICT.decode_many(jd), name
    elif jd.dtype.kind == "f" and pnode.name in ULP_FNS:
        ulps = CBRT_ULPS if pnode.name == "cbrt" else ULPS
        ok = ulp_close(pd, jd, ulps)
        assert ok.all(), (name, pd[~ok][:4], jd[~ok][:4])
        if pnode.name == "cbrt":
            x = pcols[pnode.args[0].index].data.numpy().astype(np.float64)
            assert ulp_close(pd, np.cbrt(x)[jv], 1).all(), name
    else:
        np.testing.assert_array_equal(pd, jd, err_msg=name)


def test_port_registry_holds_every_jax_name():
    """An unported name can never again get through CREATE: the binder's
    type inference and the evaluator both read the registry."""
    assert preg.registered_names() == registered_functions()
    for name in registered_functions():
        pe, je = preg.entry(name), jentry(name)
        assert pe.input_kinds == je.input_kinds, name
        assert pe.variadic == je.variadic, name


@pytest.mark.parametrize("name", registered_functions())
def test_entry_matches_jax(name):
    """Every registry entry on the generator's chunks, integer and float
    sweeps, as tests/test_kernel_registry.py builds them."""
    e = jentry(name)
    for float_mode in (False, True):
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        jnode, jcols = gen._build_call(e, rng, float_mode)
        jcols = _jax_cols([c.data for c in jcols], [c.valid for c in jcols])
        types = [a.ret_type for a in jnode.args if isinstance(a, JInputRef)]
        pnode = _port_node(jnode)
        assert pnode.ret_type.value == jinfer(name, jnode.args).value
        _compare(f"{name}[float={float_mode}]", jnode, jcols, pnode,
                 _port_cols(jcols, types))


N = 48


def _hazard_columns():
    """i int64 with INT64_MIN/MAX, j int32 near its limits, f float64
    hazards, s shift counts past the width, t timestamps before 1970, on
    29 February and at day edges, p/q booleans; each with NULLs."""
    rng = np.random.default_rng(11)
    i = rng.integers(-10 ** 6, 10 ** 6, N)
    i[:6] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0, -1, 1, 7]
    j = rng.integers(-2 ** 31, 2 ** 31, N).astype(np.int32)
    j[:3] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max, -1]
    f = rng.normal(0, 1e3, N)
    f[:22] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 0.5, -0.5, 1.5, 2.5,
              -2.5, 0.49999999999999994, -0.49999999999999994, 1e19, -1e19,
              3e9, -3e9, 1e300, -1e300, 9.223372036854775e18, 7.0, -7.0,
              4503599627370497.0]
    s = rng.integers(-3, 70, N)
    s[:6] = [-1, 0, 63, 64, 65, 32]
    day = 86_400_000_000
    t = rng.integers(-40 * 365 * day, 40 * 365 * day, N)
    t[:8] = [-1, 0, -day, day - 1, 951_782_400_000_000,     # 2000-02-29
             -2_203_891_200_000_000,                         # 1900-03-01
             -62_135_596_800_000_000,                        # 0001-01-01
             951_868_799_999_999]                            # 2000-02-29
    p = rng.random(N) < 0.5
    q = rng.random(N) < 0.5
    arrays = [i, j, f, s, t, p, q]
    types = [JDT.INT64, JDT.INT32, JDT.FLOAT64, JDT.INT64, JDT.TIMESTAMP,
             JDT.BOOLEAN, JDT.BOOLEAN]
    valids = [rng.random(N) < 0.85 for _ in arrays]
    valids[3] = None
    return arrays, types, valids


HAZARD_CASES = [
    ("neg", (0,)), ("neg", (1,)), ("abs", (0,)), ("abs", (1,)),
    ("neg", (2,)), ("abs", (2,)),
    ("greatest", (0, 1, 2)), ("least", (2, 0)), ("greatest", (2, 2)),
    ("least", (1, 0, 3)),
    ("case", (5, 0, 6, 2, 1)), ("case", (5, 2, 6, 1)),
    ("case", (5, 1)), ("coalesce", (0, 1, 2)), ("coalesce", (1, 0)),
    ("floor", (2,)), ("ceil", (2,)), ("round", (2,)), ("trunc", (2,)),
    ("sign", (2,)), ("floor", (0,)), ("round", (0,)), ("sign", (1,)),
    ("sqrt", (2,)), ("exp", (2,)), ("ln", (2,)), ("pow", (2, 1)),
    ("sin", (2,)), ("cbrt", (2,)), ("atan", (0,)), ("log10", (0,)),
    ("bitwise_shift_left", (0, 3)), ("bitwise_shift_right", (0, 3)),
    ("bitwise_shift_left", (1, 3)), ("bitwise_shift_right", (1, 3)),
    ("bitwise_and", (0, 1)), ("bitwise_xor", (1, 1)),
    ("bitwise_not", (1,)), ("bitwise_or", (0, 3)),
    ("extract_year", (4,)), ("extract_month", (4,)), ("extract_day", (4,)),
    ("extract_hour", (4,)), ("extract_minute", (4,)),
    ("extract_second", (4,)), ("extract_dow", (4,)),
    ("extract_epoch", (4,)), ("date_trunc_week", (4,)),
    ("date_trunc_day", (4,)), ("date_trunc_second", (4,)),
]


@pytest.mark.parametrize("case", range(len(HAZARD_CASES)))
def test_hazard_inputs_match_jax(case):
    name, idx = HAZARD_CASES[case]
    arrays, types, valids = _hazard_columns()
    jargs = tuple(JInputRef(k, types[k]) for k in idx)
    jnode = JFuncCall(name, jargs, jinfer(name, jargs))
    jcols = _jax_cols(arrays, valids)
    pcols = _port_cols(jcols, types)
    _compare(name, jnode, jcols, _port_node(jnode), pcols)


@pytest.mark.parametrize("dst", ["INT64", "INT32", "INT16", "BOOLEAN",
                                 "FLOAT64"])
def test_float_casts_saturate_as_xla(dst):
    """cast of NaN, +-inf and out-of-range floats to an integer type:
    XLA converts toward zero with saturation, NaN to 0."""
    arrays, types, valids = _hazard_columns()
    jnode = JFuncCall("cast", (JInputRef(2, JDT.FLOAT64),), JDT[dst])
    jcols = _jax_cols(arrays, valids)
    _compare(f"cast->{dst}", jnode, jcols, _port_node(jnode),
             _port_cols(jcols, types))


@pytest.mark.parametrize("name,lits", [
    ("like", ("abc%",)), ("like", ("%b_",)), ("like", ("",)),
    ("like", ("a.c",)), ("starts_with", ("ab",)), ("contains", ("",)),
    ("substr", (1, 4)), ("substr", (3,)), ("substr", (0, 2)),
])
def test_string_literals_match_jax(name, lits):
    """String functions over a vocabulary with regex metacharacters,
    decoded, with the literal forms SQL writes."""
    vocab = ["abc", "a.c", "abcdef", "ab", "", "xabc", "a\nc", "b_", "Hb?"]
    rng = np.random.default_rng(5)
    jids = np.asarray([JDICT.get_or_insert(s) for s in vocab],
                      np.int32)[rng.integers(0, len(vocab), N)]
    valid = rng.random(N) < 0.9
    lit_t = JDT.VARCHAR if isinstance(lits[0], str) else JDT.INT64
    jargs = (JInputRef(0, JDT.VARCHAR),) + tuple(JLiteral(v, lit_t)
                                                  for v in lits)
    jnode = JFuncCall(name, jargs, jinfer(name, jargs))
    jcols = _jax_cols([jids], [valid])
    _compare(name, jnode, jcols, _port_node(jnode),
             _port_cols(jcols, [JDT.VARCHAR]))


def test_string_result_ids_decode_and_tables_are_stable():
    """A string-result table inserts its results once: a second
    evaluation over the same dictionary rebuilds nothing, nested calls
    find the inner results, and every emitted id decodes."""
    from risingwave_tpu_torch.expr import call, col
    from risingwave_tpu_torch.expr import strings as pstr
    ids = torch.tensor([GLOBAL_DICT.get_or_insert(s) for s in
                        ("MiXed", "  pad ", "q")], dtype=torch.int32)
    cols = [Column(ids)]
    e = call("lower", call("upper", col(0, DataType.VARCHAR)))
    out = e.eval(cols)
    assert GLOBAL_DICT.decode_many(out.data) == ["mixed", "  pad ", "q"]
    nested = call("md5", call("md5", col(0, DataType.VARCHAR)))
    first = nested.eval(cols).data.clone()
    size = len(GLOBAL_DICT)
    assert torch.equal(nested.eval(cols).data, first)
    assert len(GLOBAL_DICT) == size
    import hashlib
    want = [hashlib.md5(hashlib.md5(s.encode()).hexdigest().encode())
            .hexdigest() for s in ("MiXed", "  pad ", "q")]
    assert GLOBAL_DICT.decode_many(first) == want
    assert pstr.host_table(pstr.table_spec(nested)).dtype == np.int32
