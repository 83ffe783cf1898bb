"""Kernel K5: an expression list compiled to one postfix program and run
in one launch (csrc/expr_eval.cu).

`ExprProgram(exprs)` is what executors hold. On a CPU tensor it walks
each tree with PyTorch ops (`Expr.eval`, the plain version); on a CUDA
tensor it launches K5 once per list, or once per part where the list
is past K5's limits on program length, inputs, outputs, stack or
string tables (the list is split between expressions; one expression
past them raises). Expressions that are a bare `InputRef` are a column
reselection: they return the input column itself and cost no launch;
when every expression is one, nothing launches at all.

The compiler reproduces the reference's dtype rules exactly: integers of
every width are widened to int64 in a register and narrowed back where
jnp would have wrapped (WRAP), an int operand meeting a float one is
converted first (I2F), and each result is cast to the node's return
type (a float to an integer saturating at the target width, as XLA
converts: F2I). A string function is a GATHER from a table the host
builds over the string dictionary (expr/strings.py); the tables are
looked up at each launch, so they follow the dictionary's growth. A
program is compiled once per input signature (each referenced column's
dtype and whether it has a validity mask) and cached with its ctypes
argument arrays.

Booleans in arithmetic are 0/1 integers that promote to the other
operand's type, as jnp promotes them; two booleans add as a logical or
and multiply as a logical and. An integer CASE condition holds where its
low bit is set (the reference ANDs it bitwise with its validity).

Not compiled (NotImplementedError): float32 operands, the subtraction
of two booleans (which the reference refuses too), extrema and bit
functions on booleans, floor division of floats (an integer-typed divide
of a float operand), float CASE conditions, and string functions of
non-literal patterns or positions.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Optional, Sequence

import torch

from ..common.chunk import Column
from ..ops import kernels
from . import strings
from .functions import EXTRACT_FIELDS, TRUNC_US
from .ir import Expr, FuncCall, InputRef, Literal

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# K5. Replaces expr/ir.py:FuncCall.eval (94) over expr/functions.py.
K_EXPR = kernels.register(kernels.CudaKernel(
    "expr_eval",
    replaces="risingwave_tpu/expr/ir.py:94",
    functions={"rw_expr_eval": [
        ctypes.POINTER(_I), ctypes.POINTER(_I), ctypes.POINTER(_L), _I, _I,
        ctypes.POINTER(_P), ctypes.POINTER(_P), ctypes.POINTER(_I), _I,
        ctypes.POINTER(_P), ctypes.POINTER(_P), ctypes.POINTER(_I), _I,
        ctypes.POINTER(_P), ctypes.POINTER(_L), ctypes.POINTER(_I), _P, _L,
        _P]}))

# csrc/expr_eval.cu
MAX_CODE, MAX_IN, MAX_OUT, MAX_STACK, MAX_TAB = 128, 32, 16, 24, 8

# opcodes (csrc/expr_eval.cu keeps the same numbers)
(LOAD, CONST, NUL, ADD_I, SUB_I, MUL_I, ADD_F, SUB_F, MUL_F, CMP_I, CMP_F,
 AND, OR, NOT, IS_NULL, IS_NOT_NULL, I2F, F2I, I2B, F2B, WRAP, TSTART, TEND,
 OUT, MASK, DIV_I, DIV_F, MOD_I, MOD_F, NEG_I, NEG_F, ABS_I, ABS_F,
 GREATEST, LEAST, CASE, COALESCE, FLOOR_F, CEIL_F, ROUND_F, TRUNC_F,
 SIGN_I, SIGN_F, MATH, POW_F, BAND, BOR, BXOR, BNOT, SHL, SHR, EXTRACT,
 DTRUNC, HLL_EST, GATHER) = range(55)
CMP_CODES = {"equal": 0, "not_equal": 1, "less_than": 2,
             "less_than_or_equal": 3, "greater_than": 4,
             "greater_than_or_equal": 5}
_ARITH = {"add": (ADD_I, ADD_F), "subtract": (SUB_I, SUB_F),
          "multiply": (MUL_I, MUL_F)}
_UNARY = {"neg": (NEG_I, NEG_F), "abs": (ABS_I, ABS_F)}
_ROUNDING = {"floor": FLOOR_F, "ceil": CEIL_F, "round": ROUND_F,
             "trunc": TRUNC_F}
MATH_CODES = {"sqrt": 0, "cbrt": 1, "exp": 2, "ln": 3, "log10": 4,
              "sin": 5, "cos": 6, "tan": 7, "atan": 8}
_BITS_OPS = {"bitwise_and": BAND, "bitwise_or": BOR, "bitwise_xor": BXOR,
             "bitwise_shift_left": SHL, "bitwise_shift_right": SHR}
EXTRACT_CODES = {f"extract_{f}": k for k, f in enumerate(EXTRACT_FIELDS)}
EXTRACT_CODES["extract_epoch"] = len(EXTRACT_FIELDS)
# functions whose result validity is always a mask (never None), as in
# the reference: case, coalesce and hll_estimate build it from
# valid_mask()
_ALWAYS_MASKED = ("case", "coalesce", "hll_estimate")
# element type codes shared by the kernels' column tables
TYPE_CODES = {torch.int64: 0, torch.int32: 1, torch.int16: 2, torch.int8: 3,
              torch.bool: 4, torch.float64: 5}
_BITS = {torch.int64: 64, torch.int32: 32, torch.int16: 16, torch.int8: 8,
         torch.bool: 8}


def _widest(dtypes) -> torch.dtype:
    """The widest integer operand type; a boolean (0/1) widens to the
    other operand's, and booleans alone stay in range of any."""
    ints = [d for d in dtypes if d != torch.bool] or [torch.int64]
    return max(ints, key=lambda d: _BITS[d])


def _kind(dtype: torch.dtype) -> str:
    """Register kind: 'f' (float64 bits) or 'i' (int64; bools are 0/1)."""
    if dtype == torch.float64:
        return "f"
    if dtype in _BITS:
        return "i"
    raise NotImplementedError(f"K5 does not evaluate {dtype} values")


class _Compiler:
    """Postfix code for one expression list under one input signature:
    `sig[i]` = (dtype, has_valid) of input column i (None if the list
    never reads it)."""

    def __init__(self, sig):
        self.sig = sig
        self.code: list[tuple[int, int, int]] = []
        self.inputs: list[int] = []     # input column -> program slot
        self.tables: list = []          # GATHER slot -> strings.TableSpec
        self.depth = 0
        self.max_depth = 0

    def _op(self, op: int, arg: int = 0, imm: int = 0, push: int = 0):
        self.code.append((op, arg, imm))
        self.depth += push
        self.max_depth = max(self.max_depth, self.depth)

    # static facts about a node: (torch dtype of its value, nullable)
    def info(self, e: Expr):
        if isinstance(e, InputRef):
            dt, has_valid = self.sig[e.index]
            return dt, has_valid
        if isinstance(e, Literal):
            return e.ret_type.torch_dtype, e.value is None
        if isinstance(e, FuncCall):
            if e.name in ("is_null", "is_not_null"):
                nullable = False
            elif e.name in ("divide", "modulus") or e.name in _ALWAYS_MASKED:
                nullable = True     # a zero divisor gives NULL; or a mask
            elif e.name in strings.STR_PREDS:
                nullable = self.info(e.args[0])[1]
            else:
                nullable = any(self.info(a)[1] for a in e.args)
            return e.ret_type.torch_dtype, nullable
        raise NotImplementedError(f"K5 cannot compile {e!r}")

    def _to(self, have: str, want: str) -> None:
        if have == want:
            return
        self._op(I2F if want == "f" else F2I)

    def _wrap(self, dtype: torch.dtype) -> None:
        bits = _BITS[dtype]
        if bits < 64:
            self._op(WRAP, bits)

    def _cast(self, src: torch.dtype, dst: torch.dtype) -> None:
        """The top from `src` to `dst` as jnp's astype converts."""
        if src == dst:
            return
        ks, kd = _kind(src), _kind(dst)
        if dst == torch.bool:
            self._op(I2B if ks == "i" else F2B)
        elif kd == "f":
            self._to(ks, "f")
        elif ks == "f":
            self._op(F2I, _BITS[dst] if _BITS[dst] < 64 else 0)
        elif src != torch.bool:
            self._wrap(dst)

    def _emit_as(self, e: Expr, dst: torch.dtype) -> None:
        self.emit(e)
        self._cast(self.info(e)[0], dst)

    def _ints(self, name: str, args) -> torch.dtype:
        """The promoted integer dtype of a bit function's operands."""
        dts = [self.info(a)[0] for a in args]
        if any(_kind(d) != "i" or d == torch.bool for d in dts):
            raise NotImplementedError(f"K5: {name} of non-integers")
        out = dts[0]
        for d in dts[1:]:
            out = torch.promote_types(out, d)
        return out

    def emit(self, e: Expr) -> None:
        """Push e's value; afterwards the top holds it in the register
        kind of its dtype."""
        if isinstance(e, InputRef):
            dt, _ = self.sig[e.index]
            _kind(dt)
            if e.index not in self.inputs:
                self.inputs.append(e.index)
            self._op(LOAD, self.inputs.index(e.index), push=1)
            return
        if isinstance(e, Literal):
            dt = e.ret_type.torch_dtype
            if e.value is None:
                self._op(NUL, push=1)
                return
            v = e.encoded()
            if _kind(dt) == "f":
                imm = struct.unpack("<q", struct.pack("<d", float(v)))[0]
            elif dt == torch.bool:
                imm = int(bool(v))
            else:
                imm = int(v)
            self._op(CONST, imm=imm, push=1)
            return
        if not isinstance(e, FuncCall):
            raise NotImplementedError(f"K5 cannot compile {e!r}")
        name, args = e.name, e.args
        out_dt = e.ret_type.torch_dtype
        kinds = [_kind(self.info(a)[0]) for a in args]
        if name in _ARITH:
            dts = [self.info(a)[0] for a in args]
            if all(d == torch.bool for d in dts):
                # jnp adds booleans as a logical or, multiplies them as a
                # logical and, and refuses to subtract them
                if name == "subtract":
                    raise NotImplementedError(
                        "K5: subtract of two booleans (the reference "
                        "refuses it too)")
                for a in args:
                    self.emit(a)
                self._op(_ARITH[name][0], push=-1)
                if name == "add":
                    self._op(I2B)
                self._cast(torch.bool, out_dt)
                return
            k = "f" if "f" in kinds else "i"
            for a, ka in zip(args, kinds):
                self.emit(a)
                self._to(ka, k)
            self._op(_ARITH[name][k == "f"], push=-1)
            if k == "i":
                # jnp computes in the widest operand width (a boolean
                # operand, 0/1, promotes to the other's), then casts
                self._wrap(_widest(dts))
            self._to(k, _kind(out_dt))
            if _kind(out_dt) == "i":
                self._wrap(out_dt)
            return
        if name == "divide":
            dts = [self.info(a)[0] for a in args]
            # the result type picks the division: true division in
            # float64, or floor division in the widest operand's width
            k = _kind(out_dt)
            if k == "i" and "f" in kinds:
                raise NotImplementedError("K5: floor division of floats")
            for a, ka in zip(args, kinds):
                self.emit(a)
                self._to(ka, k)
            self._op(DIV_F if k == "f" else DIV_I, push=-1)
            if k == "i":
                self._wrap(_widest(dts))
                self._wrap(out_dt)
            return
        if name == "modulus":
            dts = [self.info(a)[0] for a in args]
            # jnp's `%` in the promoted operand type, then the cast
            k = "f" if "f" in kinds else "i"
            for a, ka in zip(args, kinds):
                self.emit(a)
                self._to(ka, k)
            self._op(MOD_F if k == "f" else MOD_I, push=-1)
            if k == "i":
                self._wrap(_widest(dts))
            self._to(k, _kind(out_dt))
            if _kind(out_dt) == "i":
                self._wrap(out_dt)
            return
        if name in CMP_CODES:
            k = "f" if "f" in kinds else "i"
            for a, ka in zip(args, kinds):
                self.emit(a)
                self._to(ka, k)
            self._op(CMP_F if k == "f" else CMP_I, CMP_CODES[name], push=-1)
            return
        if name in ("and", "or", "not"):
            if any(self.info(a)[0] != torch.bool for a in args):
                raise NotImplementedError(f"K5: {name} of non-booleans")
            for a in args:
                self.emit(a)
            self._op({"and": AND, "or": OR, "not": NOT}[name],
                     push=-1 if name != "not" else 0)
            return
        if name in ("is_null", "is_not_null"):
            self.emit(args[0])
            self._op(IS_NULL if name == "is_null" else IS_NOT_NULL)
            return
        if name in ("tumble_start", "tumble_end"):
            if kinds != ["i", "i"]:
                raise NotImplementedError(f"K5: {name} of floats")
            for a in args:
                self.emit(a)
            self._op(TSTART if name == "tumble_start" else TEND, push=-1)
            return
        if name == "cast":
            (a,) = args
            self._emit_as(a, out_dt)
            return
        if name in _UNARY:
            (a,) = args
            dt = self.info(a)[0]
            if dt == torch.bool:
                raise NotImplementedError(f"K5: {name} of a boolean")
            self.emit(a)
            self._op(_UNARY[name][kinds[0] == "f"])
            if kinds[0] == "i":
                self._wrap(dt)
            self._cast(dt, out_dt)
            return
        if name in ("greatest", "least"):
            dts = [self.info(a)[0] for a in args]
            if torch.bool in dts:
                raise NotImplementedError(f"K5: {name} of booleans")
            dt = dts[0]
            for d in dts[1:]:
                dt = torch.promote_types(dt, d)
            for a in args:
                self._emit_as(a, dt)
            self._op(GREATEST if name == "greatest" else LEAST, len(args),
                     int(_kind(dt) == "f"), push=1 - len(args))
            self._cast(dt, out_dt)
            return
        if name == "case":
            n = len(args)
            has_else = n % 2 == 1
            pairs = n // 2
            for i in range(pairs):
                cond, val = args[2 * i], args[2 * i + 1]
                cdt = self.info(cond)[0]
                if _kind(cdt) != "i":
                    raise NotImplementedError("K5: CASE of a float "
                                              "condition")
                self.emit(cond)
                if cdt != torch.bool:
                    # the reference keeps `valid & data` integer: a row
                    # holds where the low bit of its condition is set
                    self._op(CONST, imm=1, push=1)
                    self._op(BAND, push=-1)
                self._emit_as(val, out_dt)
            if has_else:
                self._emit_as(args[-1], out_dt)
            self._op(CASE, pairs, int(has_else), push=1 - n)
            return
        if name == "coalesce":
            for a in args:
                self._emit_as(a, out_dt)
            self._op(COALESCE, len(args), push=1 - len(args))
            return
        if name == "hll_estimate":
            if any(k != "i" for k in kinds) or len(args) > 8:
                raise NotImplementedError("K5: hll_estimate takes up to 8 "
                                          "integer words")
            for a in args:
                self.emit(a)
            self._op(HLL_EST, len(args), push=1 - len(args))
            return
        if name in _ROUNDING or name == "sign":
            (a,) = args
            dt = self.info(a)[0]
            self.emit(a)
            if name == "sign":
                self._op(SIGN_F if kinds[0] == "f" else SIGN_I)
            elif kinds[0] == "f":
                self._op(_ROUNDING[name])
            self._cast(dt, out_dt)
            return
        if name == "pow":
            for a, ka in zip(args, kinds):
                self.emit(a)
                self._to(ka, "f")
            self._op(POW_F, push=-1)
            return
        if name in MATH_CODES:
            self.emit(args[0])
            self._to(kinds[0], "f")
            self._op(MATH, MATH_CODES[name])
            return
        if name in _BITS_OPS or name == "bitwise_not":
            dt = self._ints(name, args)
            for a in args:
                self._emit_as(a, dt)
            if name == "bitwise_not":
                self._op(BNOT)
            else:
                self._op(_BITS_OPS[name], push=-1)
            self._wrap(dt)
            self._cast(dt, out_dt)
            return
        if name in EXTRACT_CODES or name.startswith("date_trunc_"):
            if kinds != ["i"]:
                raise NotImplementedError(f"K5: {name} of a float")
            self.emit(args[0])
            if name in EXTRACT_CODES:
                self._op(EXTRACT, EXTRACT_CODES[name])
            else:
                unit = name.rsplit("_", 1)[1]
                self._op(DTRUNC, int(unit == "week"), TRUNC_US[unit])
            self._cast(torch.int64, out_dt)
            return
        if name in strings.GATHER_FNS:
            if kinds[0] != "i":
                raise NotImplementedError(f"K5: {name} of a float")
            spec = strings.table_spec(e)
            self.emit(args[0])
            keys = [t.key for t in self.tables]
            if spec.key not in keys:
                self.tables.append(spec)
                keys.append(spec.key)
            self._op(GATHER, keys.index(spec.key))
            return
        raise NotImplementedError(f"K5 has no opcode for {name!r}")

    def fits(self, n_out: int) -> bool:
        return (len(self.code) <= MAX_CODE and len(self.inputs) <= MAX_IN
                and n_out <= MAX_OUT and self.max_depth <= MAX_STACK
                and len(self.tables) <= MAX_TAB)


class _Compiled:
    """One program (one launch) with its ctypes argument arrays."""

    def __init__(self, comp: _Compiler, outs: list, out_dtypes: list,
                 out_nullable: list, mask: bool):
        n = max(1, len(comp.code))
        self.n_code = len(comp.code)
        self.ops = (ctypes.c_int * n)(*[c[0] for c in comp.code])
        self.args = (ctypes.c_int * n)(*[c[1] for c in comp.code])
        self.imms = (ctypes.c_longlong * n)(*[c[2] for c in comp.code])
        self.inputs = list(comp.inputs)
        self.in_types = kernels.int_array(
            TYPE_CODES[comp.sig[i][0]] for i in comp.inputs)
        self.tables = list(comp.tables)
        self.outs = outs                   # expression index per output
        self.out_dtypes = out_dtypes
        self.out_nullable = out_nullable
        self.out_types = kernels.int_array(TYPE_CODES[d] for d in out_dtypes)
        self.mask = mask


def _signature(columns: Sequence[Column], refs) -> tuple:
    return tuple((columns[i].data.dtype, columns[i].valid is not None)
                 if i in refs else None for i in range(len(columns)))


class ExprProgram:
    """An expression list evaluated by kernel K5 on a CUDA device and by
    the tree walk on the CPU."""

    def __init__(self, exprs: Sequence[Expr]):
        from .ir import input_refs
        self.exprs = tuple(exprs)
        self.refs = set()
        for e in self.exprs:
            self.refs |= input_refs(e)
        # expressions the kernel computes (bare InputRefs pass through)
        self.computed = [j for j, e in enumerate(self.exprs)
                         if not isinstance(e, InputRef)]
        self._cache: dict = {}

    def _compile(self, sig, mask: bool) -> tuple:
        """The computed expressions as programs of one launch each: one
        program while the list fits K5's limits, else split between
        expressions (NotImplementedError if one alone does not fit)."""
        key = (sig, mask)
        parts = self._cache.get(key)
        if parts is not None:
            return parts
        parts = []
        # a mask is computed even from a bare column
        todo = list(range(len(self.exprs))) if mask else list(self.computed)
        while todo:
            taken = []
            comp = _Compiler(sig)
            for j in todo:
                trial = _Compiler(sig)
                trial.code, trial.inputs = list(comp.code), list(comp.inputs)
                trial.tables = list(comp.tables)
                trial.max_depth = comp.max_depth
                e = self.exprs[j]
                trial.emit(e)
                dt, _ = trial.info(e)
                if mask:
                    if dt != torch.bool:
                        # the join condition is `astype(bool)`: non-zero
                        # holds (a NaN too)
                        trial._op(CONST, push=1)
                        trial._op(CMP_F if _kind(dt) == "f" else CMP_I,
                                  CMP_CODES["not_equal"], push=-1)
                    trial._op(MASK, push=-1)
                else:
                    trial._op(OUT, len(taken), push=-1)
                if not trial.fits(len(taken) + 1):
                    break
                comp = trial
                taken.append(j)
            if not taken:
                raise NotImplementedError(
                    f"K5 program too large for {self.exprs[todo[0]]!r}")
            parts.append(_Compiled(
                comp, taken, [self.exprs[j].ret_type.torch_dtype
                              for j in taken],
                [comp.info(self.exprs[j])[1] for j in taken], mask))
            todo = todo[len(taken):]
        parts = self._cache[key] = tuple(parts)
        return parts

    # ------------------------------------------------------------ plain
    def eval_plain(self, columns: Sequence[Column]) -> list[Column]:
        """Plain version of K5: the tree walk, one PyTorch op a node."""
        return [e.eval(columns) for e in self.exprs]

    def and_into_plain(self, columns: Sequence[Column],
                       mask: torch.Tensor) -> None:
        (e,) = self.exprs
        pred = e.eval(columns)
        mask &= pred.data.to(torch.bool) & pred.valid_mask()

    # ------------------------------------------------------------ K5
    def eval(self, columns: Sequence[Column]) -> list[Column]:
        """One Column per expression (bare InputRefs return the input
        column itself)."""
        dev = columns[0].data.device
        if dev.type == "cpu":
            return self.eval_plain(columns)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        out = [columns[e.index] if isinstance(e, InputRef) else None
               for e in self.exprs]
        if not self.computed:
            return out
        n = columns[0].capacity
        for prog in self._compile(_signature(columns, self.refs),
                                  mask=False):
            datas, valids = [], []
            for dt, null in zip(prog.out_dtypes, prog.out_nullable):
                datas.append(torch.empty(n, dtype=dt, device=dev))
                valids.append(torch.empty(n, dtype=torch.bool, device=dev)
                              if null else None)
            self._launch(prog, columns, datas, valids, None, n)
            for j, d, v in zip(prog.outs, datas, valids):
                out[j] = Column(d, v)
        return out

    def and_into(self, columns: Sequence[Column], mask: torch.Tensor) -> None:
        """mask &= pred.data & pred.valid for the one boolean expression,
        in place (the join condition on the match buffer)."""
        dev = mask.device
        if dev.type == "cpu":
            return self.and_into_plain(columns, mask)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        if len(self.exprs) != 1 or mask.dtype != torch.bool \
                or not mask.is_contiguous():
            raise ValueError("and_into takes one expression and a "
                             "contiguous bool mask")
        (prog,) = self._compile(_signature(columns, self.refs), mask=True)
        self._launch(prog, columns, [], [], mask, mask.shape[0])

    def _launch(self, prog: _Compiled, columns, datas, valids,
                mask: Optional[torch.Tensor], n: int) -> None:
        ins = [columns[i] for i in prog.inputs]
        dev = columns[0].data.device
        for c in ins:
            if c.data.shape[0] != n or not c.data.is_contiguous() \
                    or c.data.device != dev or (
                        c.valid is not None and (
                            not c.valid.is_contiguous()
                            or c.valid.dtype != torch.bool)):
                raise ValueError("K5 input columns must be contiguous, on "
                                 "one device, of one length")
        # the tables in the order the program gathers (inner calls first,
        # so their results are in the dictionary an outer table maps)
        tabs = [strings.device_table(spec, dev) for spec in prog.tables]
        K_EXPR.launches += 1
        K_EXPR.call("rw_expr_eval", prog.ops, prog.args, prog.imms,
                    prog.n_code, len(ins),
                    kernels.ptr_array([c.data for c in ins]),
                    kernels.ptr_array([c.valid for c in ins]),
                    prog.in_types, len(datas), kernels.ptr_array(datas),
                    kernels.ptr_array(valids), prog.out_types, len(tabs),
                    kernels.ptr_array(tabs),
                    (ctypes.c_longlong * max(1, len(tabs)))(
                        *[t.shape[0] for t in tabs]),
                    kernels.int_array(TYPE_CODES[t.dtype] for t in tabs),
                    kernels.ptr_or_null(mask), n,
                    ctypes.c_void_p(
                        torch.cuda.current_stream(dev).cuda_stream))
