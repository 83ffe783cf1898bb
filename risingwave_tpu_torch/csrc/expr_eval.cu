// K5 — expression evaluation: one fused elementwise pass per expression
// list.
//
// Replaces risingwave_tpu/expr/ir.py:FuncCall.eval (94) over the
// expr/functions.py entries (modulus, :76, as MOD_I / MOD_F), which XLA
// fused into the program of each caller: stream/project.py:
// ProjectExecutor._step_impl (66), FilterExecutor._step_impl's predicate
// (103) and the join condition in stream/sorted_join.py:_apply_impl
// (438).
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
// expressions costs one launch and one pass. The program is uniform
// across the grid, so the switch never diverges within a warp. Each
// block first copies the program and the column tables into shared
// memory with compile-time indices (a by-value argument indexed by a
// run-time value would be copied to local memory per thread). In mask
// mode (the join condition) the one boolean result is AND-ed into an
// existing byte mask in place: mask &= data & valid.

#include "common.cuh"

namespace {

constexpr int kMaxCode = 48;
constexpr int kMaxIn = 16;
constexpr int kMaxOut = 8;
constexpr int kMaxStack = 16;
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
};
// comparison codes (CMP_* arg)
enum Cmp { EQ = 0, NE = 1, LT = 2, LE = 3, GT = 4, GE = 5 };
// column element types
enum Type { T_I64 = 0, T_I32 = 1, T_I16 = 2, T_I8 = 3, T_BOOL = 4,
            T_F64 = 5 };

struct Instr {
  int op;
  int arg;
  long long imm;
};

struct Prog {
  Instr code[kMaxCode];
  int n_code;
  const void* in_data[kMaxIn];
  const unsigned char* in_valid[kMaxIn];
  int in_type[kMaxIn];
  void* out_data[kMaxOut];
  unsigned char* out_valid[kMaxOut];
  int out_type[kMaxOut];
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

__global__ void __launch_bounds__(kThreads)
expr_eval_kernel(Prog p, long long n) {
  __shared__ Instr s_code[kMaxCode];
  __shared__ const void* s_in[kMaxIn];
  __shared__ const unsigned char* s_inv[kMaxIn];
  __shared__ int s_int[kMaxIn];
  __shared__ void* s_out[kMaxOut];
  __shared__ unsigned char* s_outv[kMaxOut];
  __shared__ int s_outt[kMaxOut];
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 0; k < kMaxCode; ++k) {
    if (t == k) s_code[k] = p.code[k];
  }
#pragma unroll
  for (int k = 0; k < kMaxIn; ++k) {
    if (t == k) {
      s_in[k] = p.in_data[k];
      s_inv[k] = p.in_valid[k];
      s_int[k] = p.in_type[k];
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxOut; ++k) {
    if (t == k) {
      s_out[k] = p.out_data[k];
      s_outv[k] = p.out_valid[k];
      s_outt[k] = p.out_type[k];
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
      case F2I: sd[sp - 1] = static_cast<i64>(as_f(sd[sp - 1])); break;
      case I2B: sd[sp - 1] = sd[sp - 1] != 0; break;
      case F2B: sd[sp - 1] = as_f(sd[sp - 1]) != 0.0; break;
      case WRAP: {
        const i64 v = sd[sp - 1];
        sd[sp - 1] = ins.arg == 32 ? static_cast<i64>(static_cast<int>(v))
                   : ins.arg == 16 ? static_cast<i64>(static_cast<short>(v))
                   : static_cast<i64>(static_cast<signed char>(v));
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
          case ADD_I: r = static_cast<i64>(static_cast<u64>(a) + static_cast<u64>(b)); break;
          case SUB_I: r = static_cast<i64>(static_cast<u64>(a) - static_cast<u64>(b)); break;
          case MUL_I: r = static_cast<i64>(static_cast<u64>(a) * static_cast<u64>(b)); break;
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
          default: r = a - floor_mod(a, b) + b;   // TEND
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
                            const int* out_type, unsigned char* mask,
                            long long n, void* stream) {
  if (n_code < 0 || n_code > kMaxCode || n_in < 0 || n_in > kMaxIn
      || n_out < 0 || n_out > kMaxOut) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Prog p = {};
  p.n_code = n_code;
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
  p.mask = mask;
  if (n > 0) {
    expr_eval_kernel<<<rw_blocks(n, kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(p, n);
  }
  return static_cast<int>(cudaGetLastError());
}
