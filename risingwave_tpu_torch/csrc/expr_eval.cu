// K5 — expression evaluation: one fused elementwise pass per expression
// list.
//
// Replaces risingwave_tpu/expr/ir.py:FuncCall.eval (94) over every entry
// of the expression registry: expr/functions.py (arithmetic, modulus
// :76, neg/abs :86/:92, greatest/least :120/:129, case :188, coalesce
// :217, hll_estimate :207, extract_epoch :257, floor/ceil/round/trunc/
// sign :266-:300, the float64 math functions :302-:360, the bit
// functions :362-:396, extract_* over _civil_from_days :407-:480,
// date_trunc_* :491) and expr/strings.py (every string function and
// predicate, as a GATHER from a table the host builds over the string
// dictionary), which XLA fused into the program of each caller:
// stream/project.py:ProjectExecutor._step_impl (66), FilterExecutor.
// _step_impl's predicate (103) and the join condition in
// stream/sorted_join.py:_apply_impl (438).
//
// What bounds it on the H100: bytes. Each row reads the columns the
// expressions name and writes each result once (q7's TUMBLE project:
// 8 B in and 16 B out a row over 131072 rows, 3.1 MB, ~0.9 us at
// 3.35 TB/s); the arithmetic is a handful of 64-bit operations a row.
//
// Design: an interpreter. expr/program.py compiles the expression list
// into a postfix program (typed opcodes; every integer width widened to
// int64 in a register, float64 held as its bits, promotion and the
// narrowing casts of the reference spelled out as opcodes), which is
// passed BY VALUE as a kernel argument, with the input and output column
// tables. One thread per row runs the whole program on a register stack
// of (data, valid) pairs and writes every output, so a list of
// expressions costs one launch and one pass (a list past the program's
// limits is split by expr/program.py into several launches). Float
// conversions and extrema follow XLA's CPU: float -> integer truncates
// with saturation at the target width and NaN to 0; greatest/least
// propagate NaN and order -0.0 below +0.0. Shifts by a count below 0 or
// from 64 up give 0 (left) or the sign fill (right), as XLA's do, where
// C's shift is undefined. The transcendental functions are libdevice's
// (within 2 ulp of XLA's CPU ones; sqrt correctly rounded). The program is uniform
// across the grid, so the switch never diverges within a warp. Each
// block first copies the program and the column tables into shared
// memory with compile-time indices (a by-value argument indexed by a
// run-time value would be copied to local memory per thread). In mask
// mode (the join condition) the one boolean result is AND-ed into an
// existing byte mask in place: mask &= data & valid.

#include "common.cuh"

namespace {

constexpr int kMaxCode = 128;
constexpr int kMaxIn = 32;
constexpr int kMaxOut = 16;
constexpr int kMaxStack = 24;
constexpr int kMaxTab = 8;
constexpr int kThreads = 256;

// opcodes: expr/program.py keeps the same numbers
enum Op {
  LOAD = 0, CONST = 1, NUL = 2,
  ADD_I = 3, SUB_I = 4, MUL_I = 5, ADD_F = 6, SUB_F = 7, MUL_F = 8,
  CMP_I = 9, CMP_F = 10, AND = 11, OR = 12, NOT = 13,
  IS_NULL = 14, IS_NOT_NULL = 15,
  I2F = 16, F2I = 17, I2B = 18, F2B = 19, WRAP = 20,
  TSTART = 21, TEND = 22, OUT = 23, MASK = 24, DIV_I = 25, DIV_F = 26,
  MOD_I = 27, MOD_F = 28,
  NEG_I = 29, NEG_F = 30, ABS_I = 31, ABS_F = 32,
  GREATEST = 33, LEAST = 34, CASE = 35, COALESCE = 36,
  FLOOR_F = 37, CEIL_F = 38, ROUND_F = 39, TRUNC_F = 40,
  SIGN_I = 41, SIGN_F = 42, MATH = 43, POW_F = 44,
  BAND = 45, BOR = 46, BXOR = 47, BNOT = 48, SHL = 49, SHR = 50,
  EXTRACT = 51, DTRUNC = 52, HLL_EST = 53, GATHER = 54,
};
// comparison codes (CMP_* arg)
enum Cmp { EQ = 0, NE = 1, LT = 2, LE = 3, GT = 4, GE = 5 };
// MATH arg
enum Math { SQRT = 0, CBRT = 1, EXP = 2, LN = 3, LOG10 = 4, SIN = 5,
            COS = 6, TAN = 7, ATAN = 8 };
// EXTRACT arg
enum Field { YEAR = 0, MONTH = 1, DAY = 2, HOUR = 3, MINUTE = 4,
             SECOND = 5, DOW = 6, EPOCH = 7 };
// column element types
enum Type { T_I64 = 0, T_I32 = 1, T_I16 = 2, T_I8 = 3, T_BOOL = 4,
            T_F64 = 5 };

constexpr i64 kUsPerDay = 86400000000LL;

struct Instr {
  int op;
  int arg;
  long long imm;
};

struct Prog {
  Instr code[kMaxCode];
  int n_code;
  int n_in;
  int n_out;
  int n_tab;
  const void* in_data[kMaxIn];
  const unsigned char* in_valid[kMaxIn];
  int in_type[kMaxIn];
  void* out_data[kMaxOut];
  unsigned char* out_valid[kMaxOut];
  int out_type[kMaxOut];
  const void* tab[kMaxTab];
  long long tab_len[kMaxTab];
  int tab_type[kMaxTab];
  unsigned char* mask;
};

__device__ __forceinline__ i64 load_value(const void* p, int type,
                                          long long i) {
  switch (type) {
    case T_I64:
    case T_F64: return static_cast<const i64*>(p)[i];
    case T_I32: return static_cast<const int*>(p)[i];
    case T_I16: return static_cast<const short*>(p)[i];
    case T_I8: return static_cast<const signed char*>(p)[i];
    default: return static_cast<const unsigned char*>(p)[i] != 0;
  }
}

__device__ __forceinline__ void store_value(void* p, int type, long long i,
                                            i64 v) {
  switch (type) {
    case T_I64:
    case T_F64: static_cast<i64*>(p)[i] = v; break;
    case T_I32: static_cast<int*>(p)[i] = static_cast<int>(v); break;
    case T_I16: static_cast<short*>(p)[i] = static_cast<short>(v); break;
    case T_I8:
      static_cast<signed char*>(p)[i] = static_cast<signed char>(v);
      break;
    default: static_cast<unsigned char*>(p)[i] = v != 0;
  }
}

__device__ __forceinline__ double as_f(i64 bits) {
  return __longlong_as_double(bits);
}

__device__ __forceinline__ i64 as_bits(double d) {
  return __double_as_longlong(d);
}

__device__ __forceinline__ i64 wrap_add(i64 a, i64 b) {
  return static_cast<i64>(static_cast<u64>(a) + static_cast<u64>(b));
}

__device__ __forceinline__ i64 wrap_mul(i64 a, i64 b) {
  return static_cast<i64>(static_cast<u64>(a) * static_cast<u64>(b));
}

template <typename T>
__device__ __forceinline__ i64 compare(T a, T b, int code) {
  switch (code) {
    case EQ: return a == b;
    case NE: return a != b;
    case LT: return a < b;
    case LE: return a <= b;
    case GT: return a > b;
    default: return a >= b;
  }
}

// jnp's integer `//` (floor), with a zero divisor giving 0 (the caller
// marks the row NULL) and INT64_MIN // -1 wrapping as XLA's does
__device__ __forceinline__ i64 floor_div(i64 a, i64 b) {
  if (b == 0) return 0;
  if (b == -1) return static_cast<i64>(0ULL - static_cast<u64>(a));
  return rw_floordiv(a, b);
}

// jnp's integer `%`: the remainder takes the divisor's sign
__device__ __forceinline__ i64 floor_mod(i64 a, i64 b) {
  const i64 r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// MOD_I: floor_mod with a zero divisor giving 0 (the caller marks the
// row NULL); x % -1 is 0 for every x, INT64_MIN included, where C's
// `%` is undefined
__device__ __forceinline__ i64 int_mod(i64 a, i64 b) {
  return (b == 0 || b == -1) ? 0 : floor_mod(a, b);
}

// MOD_F: jnp.remainder of float64 — the truncated remainder (fmod,
// exact), plus the divisor where the signs differ; a zero divisor gives
// +0 (NULL)
__device__ __forceinline__ double float_mod(double a, double b) {
  if (b == 0.0) return 0.0;
  const double r = fmod(a, b);
  return (r != 0.0 && ((r < 0.0) != (b < 0.0))) ? r + b : r;
}

// XLA's float -> signed integer of `bits` width: toward zero, saturating
// at the width's limits, NaN to 0
__device__ __forceinline__ i64 f2i(double x, int bits) {
  if (x != x) return 0;
  const double lim = ldexp(1.0, bits - 1);
  if (x >= lim) return static_cast<i64>((1ULL << (bits - 1)) - 1);
  if (x <= -lim) return static_cast<i64>(0ULL - (1ULL << (bits - 1)));
  return static_cast<i64>(x);
}

// jnp.maximum / jnp.minimum of float64: NaN propagates, and of two equal
// values (+0.0 and -0.0 included) max takes the AND of the bits (+0.0),
// min the OR (-0.0)
__device__ __forceinline__ i64 fext(i64 a, i64 b, bool is_max) {
  const double x = as_f(a), y = as_f(b);
  if (x != x || y != y) return as_bits(x + y);
  if (is_max) return x > y ? a : (y > x ? b : (a & b));
  return x < y ? a : (y < x ? b : (a | b));
}

// days since the epoch -> year, month or day (Hinnant's civil-from-days
// with floor divisions, as the reference's _civil_from_days)
__device__ __forceinline__ i64 civil(i64 days, int field) {
  const i64 z = days + 719468;
  const i64 era = rw_floordiv(z, 146097);
  const i64 doe = z - era * 146097;
  const i64 yoe = rw_floordiv(doe - rw_floordiv(doe, 1460)
                              + rw_floordiv(doe, 36524)
                              - rw_floordiv(doe, 146096), 365);
  const i64 doy = doe - (365 * yoe + rw_floordiv(yoe, 4)
                         - rw_floordiv(yoe, 100));
  const i64 mp = rw_floordiv(5 * doy + 2, 153);
  const i64 d = doy - rw_floordiv(153 * mp + 2, 5) + 1;
  const i64 m = mp + (mp < 10 ? 3 : -9);
  if (field == DAY) return d;
  if (field == MONTH) return m;
  return yoe + era * 400 + (m <= 2 ? 1 : 0);
}

__device__ __forceinline__ i64 extract(i64 ts, int field) {
  if (field == EPOCH) return rw_floordiv(ts, 1000000);
  const i64 days = rw_floordiv(ts, kUsPerDay);
  // ts - days * day wraps as the reference's int64 arithmetic does
  const i64 us = wrap_add(ts, wrap_mul(-days, kUsPerDay));
  switch (field) {
    case HOUR: return rw_floordiv(us, 3600000000LL);
    case MINUTE: return floor_mod(rw_floordiv(us, 60000000LL), 60);
    case SECOND: return floor_mod(rw_floordiv(us, 1000000LL), 60);
    case DOW: return floor_mod(days + 4, 7);
    default: return civil(days, field);
  }
}

__device__ __forceinline__ double math1(double x, int fn) {
  switch (fn) {
    case SQRT: return sqrt(x);
    case CBRT: return cbrt(x);
    case EXP: return exp(x);
    case LN: return log(x);
    case LOG10: return log10(x);
    case SIN: return sin(x);
    case COS: return cos(x);
    case TAN: return tan(x);
    default: return atan(x);
  }
}

// the reference's estimate_from_words_jnp over n packed words: the raw
// HLL estimate (alpha_64 64^2 / sum 2^-reg), linear counting below 2.5 m
// with an empty register, rounded half to even
__device__ __forceinline__ i64 hll_estimate(const i64* w, int n) {
  double inv = 0.0;
  int zeros = 0;
  for (int k = 0; k < n; ++k) {
    for (int b = 0; b < 8; ++b) {
      const int r = static_cast<int>((w[k] >> (8 * b)) & 255);
      inv += ldexp(1.0, -r);
      zeros += r == 0;
    }
  }
  double est = (0.709 * 64.0) * 64.0 / inv;
  if (est <= 2.5 * 64.0 && zeros > 0) {
    est = 64.0 * log(fmax(64.0 / static_cast<double>(zeros), 1.0));
  }
  return f2i(rint(est), 64);
}

__global__ void __launch_bounds__(kThreads)
expr_eval_kernel(Prog p, long long n) {
  __shared__ Instr s_code[kMaxCode];
  __shared__ const void* s_in[kMaxIn];
  __shared__ const unsigned char* s_inv[kMaxIn];
  __shared__ int s_int[kMaxIn];
  __shared__ void* s_out[kMaxOut];
  __shared__ unsigned char* s_outv[kMaxOut];
  __shared__ int s_outt[kMaxOut];
  __shared__ const void* s_tab[kMaxTab];
  __shared__ long long s_tlen[kMaxTab];
  __shared__ int s_ttype[kMaxTab];
  const int t = threadIdx.x;
  // compile-time indices, stopping at the program's own sizes
#pragma unroll
  for (int k = 0; k < kMaxCode; ++k) {
    if (k >= p.n_code) break;
    if (t == k) s_code[k] = p.code[k];
  }
#pragma unroll
  for (int k = 0; k < kMaxIn; ++k) {
    if (k >= p.n_in) break;
    if (t == k) {
      s_in[k] = p.in_data[k];
      s_inv[k] = p.in_valid[k];
      s_int[k] = p.in_type[k];
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxOut; ++k) {
    if (k >= p.n_out) break;
    if (t == k) {
      s_out[k] = p.out_data[k];
      s_outv[k] = p.out_valid[k];
      s_outt[k] = p.out_type[k];
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxTab; ++k) {
    if (k >= p.n_tab) break;
    if (t == k) {
      s_tab[k] = p.tab[k];
      s_tlen[k] = p.tab_len[k];
      s_ttype[k] = p.tab_type[k];
    }
  }
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + t;
  if (i >= n) return;

  i64 sd[kMaxStack];
  unsigned char sv[kMaxStack];
  int sp = 0;
  for (int pc = 0; pc < p.n_code; ++pc) {
    const Instr ins = s_code[pc];
    switch (ins.op) {
      case LOAD: {
        sd[sp] = load_value(s_in[ins.arg], s_int[ins.arg], i);
        const unsigned char* v = s_inv[ins.arg];
        sv[sp] = v ? v[i] : 1;
        ++sp;
        break;
      }
      case CONST: sd[sp] = ins.imm; sv[sp] = 1; ++sp; break;
      case NUL: sd[sp] = 0; sv[sp] = 0; ++sp; break;
      case IS_NULL: sd[sp - 1] = !sv[sp - 1]; sv[sp - 1] = 1; break;
      case IS_NOT_NULL: sd[sp - 1] = sv[sp - 1]; sv[sp - 1] = 1; break;
      case NOT: sd[sp - 1] = sd[sp - 1] ? 0 : 1; break;
      case I2F: sd[sp - 1] = as_bits(static_cast<double>(sd[sp - 1])); break;
      case F2I:
        sd[sp - 1] = f2i(as_f(sd[sp - 1]), ins.arg ? ins.arg : 64);
        break;
      case I2B: sd[sp - 1] = sd[sp - 1] != 0; break;
      case F2B: sd[sp - 1] = as_f(sd[sp - 1]) != 0.0; break;
      case WRAP: {
        const i64 v = sd[sp - 1];
        sd[sp - 1] = ins.arg == 32 ? static_cast<i64>(static_cast<int>(v))
                   : ins.arg == 16 ? static_cast<i64>(static_cast<short>(v))
                   : static_cast<i64>(static_cast<signed char>(v));
        break;
      }
      case NEG_I: sd[sp - 1] = wrap_mul(sd[sp - 1], -1); break;
      case NEG_F: sd[sp - 1] = as_bits(-as_f(sd[sp - 1])); break;
      case ABS_I:
        if (sd[sp - 1] < 0) sd[sp - 1] = wrap_mul(sd[sp - 1], -1);
        break;
      case ABS_F: sd[sp - 1] = as_bits(fabs(as_f(sd[sp - 1]))); break;
      case FLOOR_F: sd[sp - 1] = as_bits(floor(as_f(sd[sp - 1]))); break;
      case CEIL_F: sd[sp - 1] = as_bits(ceil(as_f(sd[sp - 1]))); break;
      case TRUNC_F: sd[sp - 1] = as_bits(trunc(as_f(sd[sp - 1]))); break;
      case ROUND_F: {
        // halves away from zero as trunc(a +- 0.5), so
        // 0.49999999999999994 rounds to 1, as the reference's does
        const double x = as_f(sd[sp - 1]);
        sd[sp - 1] = as_bits(trunc(x + (x >= 0.0 ? 0.5 : -0.5)));
        break;
      }
      case SIGN_I: {
        const i64 x = sd[sp - 1];
        sd[sp - 1] = (x > 0) - (x < 0);
        break;
      }
      case SIGN_F: {
        // jnp.sign keeps -0.0 and NaN
        const double x = as_f(sd[sp - 1]);
        sd[sp - 1] = as_bits(x > 0.0 ? 1.0 : (x < 0.0 ? -1.0 : x));
        break;
      }
      case MATH: sd[sp - 1] = as_bits(math1(as_f(sd[sp - 1]), ins.arg)); break;
      case BNOT: sd[sp - 1] = ~sd[sp - 1]; break;
      case EXTRACT: sd[sp - 1] = extract(sd[sp - 1], ins.arg); break;
      case DTRUNC: {
        // floor((ts + off) / unit) * unit - off, wrapping as int64 does
        const i64 off = ins.arg ? 3 * kUsPerDay : 0;
        const i64 q = rw_floordiv(wrap_add(sd[sp - 1], off), ins.imm);
        sd[sp - 1] = wrap_add(wrap_mul(q, ins.imm), -off);
        break;
      }
      case GATHER: {
        // out = table[clip(id, 0, len - 1)]; the id's validity stays
        const long long len = s_tlen[ins.arg];
        i64 id = sd[sp - 1];
        id = id < 0 ? 0 : (id >= len ? len - 1 : id);
        sd[sp - 1] = load_value(s_tab[ins.arg], s_ttype[ins.arg], id);
        break;
      }
      case GREATEST:
      case LEAST: {
        // n entries, strict; imm: 1 float64, 0 int64
        const int m = ins.arg;
        const int base = sp - m;
        i64 r = sd[base];
        unsigned char rv = sv[base];
        for (int k = 1; k < m; ++k) {
          const i64 x = sd[base + k];
          rv &= sv[base + k];
          if (ins.imm) {
            r = fext(r, x, ins.op == GREATEST);
          } else {
            r = ins.op == GREATEST ? (x > r ? x : r) : (x < r ? x : r);
          }
        }
        sp = base + 1;
        sd[base] = r;
        sv[base] = rv;
        break;
      }
      case CASE: {
        // arg pairs of (cond, value) then imm ? an else : nothing; the
        // first valid true condition wins
        const int pairs = ins.arg;
        const int m = 2 * pairs + (ins.imm ? 1 : 0);
        const int base = sp - m;
        i64 r = 0;
        unsigned char rv = 0;
        if (ins.imm) {
          r = sd[sp - 1];
          rv = sv[sp - 1];
        }
        for (int k = pairs - 1; k >= 0; --k) {
          if (sv[base + 2 * k] && sd[base + 2 * k]) {
            r = sd[base + 2 * k + 1];
            rv = sv[base + 2 * k + 1];
          }
        }
        sp = base + 1;
        sd[base] = r;
        sv[base] = rv;
        break;
      }
      case COALESCE: {
        // the first valid entry, else the last entry's data (NULL)
        const int m = ins.arg;
        const int base = sp - m;
        i64 r = sd[sp - 1];
        unsigned char rv = sv[sp - 1];
        for (int k = m - 2; k >= 0; --k) {
          if (sv[base + k]) {
            r = sd[base + k];
            rv = 1;
          }
        }
        sp = base + 1;
        sd[base] = r;
        sv[base] = rv;
        break;
      }
      case HLL_EST: {
        const int m = ins.arg;
        const int base = sp - m;
        unsigned char rv = 1;
        for (int k = 0; k < m; ++k) rv &= sv[base + k];
        sd[base] = hll_estimate(&sd[base], m);
        sv[base] = rv;
        sp = base + 1;
        break;
      }
      case OUT: {
        --sp;
        store_value(s_out[ins.arg], s_outt[ins.arg], i, sd[sp]);
        if (s_outv[ins.arg]) s_outv[ins.arg][i] = sv[sp];
        break;
      }
      case MASK: {
        --sp;
        p.mask[i] = p.mask[i] && sd[sp] && sv[sp];
        break;
      }
      default: {
        // binary: b on top, a below; the result replaces a
        --sp;
        const i64 a = sd[sp - 1], b = sd[sp];
        const unsigned char va = sv[sp - 1], vb = sv[sp];
        i64 r;
        unsigned char rv = va & vb;
        switch (ins.op) {
          case ADD_I: r = wrap_add(a, b); break;
          case SUB_I: r = static_cast<i64>(static_cast<u64>(a) - static_cast<u64>(b)); break;
          case MUL_I: r = wrap_mul(a, b); break;
          case ADD_F: r = as_bits(as_f(a) + as_f(b)); break;
          case SUB_F: r = as_bits(as_f(a) - as_f(b)); break;
          case MUL_F: r = as_bits(as_f(a) * as_f(b)); break;
          case CMP_I: r = compare<i64>(a, b, ins.arg); break;
          case CMP_F: r = compare<double>(as_f(a), as_f(b), ins.arg); break;
          case AND:
            // Kleene: FALSE wins over NULL
            r = a & b;
            rv = (va & !a) | (vb & !b) | (va & vb);
            break;
          case OR:
            r = a | b;
            rv = (va & (a != 0)) | (vb & (b != 0)) | (va & vb);
            break;
          case DIV_I: r = floor_div(a, b); rv &= b != 0; break;
          case DIV_F: {
            // one IEEE division; no contraction across opcodes
            const double fb = as_f(b);
            r = fb == 0.0 ? as_bits(0.0) : as_bits(as_f(a) / fb);
            rv &= fb != 0.0;
            break;
          }
          case MOD_I: r = int_mod(a, b); rv &= b != 0; break;
          case MOD_F:
            r = as_bits(float_mod(as_f(a), as_f(b)));
            rv &= as_f(b) != 0.0;
            break;
          case TSTART: r = a - floor_mod(a, b); break;
          case TEND: r = a - floor_mod(a, b) + b; break;
          case POW_F: r = as_bits(pow(as_f(a), as_f(b))); break;
          case BAND: r = a & b; break;
          case BOR: r = a | b; break;
          case BXOR: r = a ^ b; break;
          case SHL:
            r = (b < 0 || b >= 64)
                    ? 0 : static_cast<i64>(static_cast<u64>(a) << b);
            break;
          default:   // SHR, arithmetic
            r = (b < 0 || b >= 64) ? (a < 0 ? -1 : 0) : (a >> b);
        }
        sd[sp - 1] = r;
        sv[sp - 1] = rv;
      }
    }
  }
}

}  // namespace

extern "C" int rw_expr_eval(const int* ops, const int* args,
                            const long long* imms, int n_code, int n_in,
                            void* const* in_data, void* const* in_valid,
                            const int* in_type, int n_out,
                            void* const* out_data, void* const* out_valid,
                            const int* out_type, int n_tab,
                            void* const* tabs, const long long* tab_lens,
                            const int* tab_types, unsigned char* mask,
                            long long n, void* stream) {
  if (n_code < 0 || n_code > kMaxCode || n_in < 0 || n_in > kMaxIn
      || n_out < 0 || n_out > kMaxOut || n_tab < 0 || n_tab > kMaxTab) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Prog p = {};
  p.n_code = n_code;
  p.n_in = n_in;
  p.n_out = n_out;
  p.n_tab = n_tab;
  for (int k = 0; k < n_code; ++k) {
    p.code[k].op = ops[k];
    p.code[k].arg = args[k];
    p.code[k].imm = imms[k];
  }
  for (int k = 0; k < n_in; ++k) {
    p.in_data[k] = in_data[k];
    p.in_valid[k] = static_cast<const unsigned char*>(in_valid[k]);
    p.in_type[k] = in_type[k];
  }
  for (int k = 0; k < n_out; ++k) {
    p.out_data[k] = out_data[k];
    p.out_valid[k] = static_cast<unsigned char*>(out_valid[k]);
    p.out_type[k] = out_type[k];
  }
  for (int k = 0; k < n_tab; ++k) {
    p.tab[k] = tabs[k];
    p.tab_len[k] = tab_lens[k];
    p.tab_type[k] = tab_types[k];
  }
  p.mask = mask;
  if (n > 0) {
    expr_eval_kernel<<<rw_blocks(n, kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(p, n);
  }
  return static_cast<int>(cudaGetLastError());
}
