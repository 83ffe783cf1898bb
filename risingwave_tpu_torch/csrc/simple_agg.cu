// K25 — the global (ungrouped) aggregate's apply of one chunk.
//
// Replaces risingwave_tpu/stream/simple_agg.py:
// SimpleAggExecutor._apply_impl (117): every visible row of the chunk
// signed by its op (+1 Insert / UpdateInsert, -1 Delete / UpdateDelete),
// NULL arguments not counted; per call its signed partial over the
// chunk into one scalar (COUNT: the signed rows, or with
// combine_partials the sum of value x sign, the partial counts of an
// upstream StatelessSimpleAgg; SUM: value x sign in int64 or float64;
// append-only MIN / MAX: over rows of positive sign, NaN propagating as
// jnp.minimum does), combined into the call's state; and row_count +=
// the signed rows.
//
// Two launches, as K16 reduces: a fixed grid of blocks, each thread
// walking a fixed stride of rows and each block combining its threads in
// a fixed order into one partial a call; then one block that folds the
// partials in order and into the states. No atomics: float64 sums are
// the same from run to run, and exact against the plain version for
// integer values below 2^53 (otherwise within a relative 1e-12). K4 with
// every row in slot 0 would serialise its atomics on one address and sum
// floats in launch order.
//
// What bounds it on the H100: bytes. The ops and visibility bytes and
// each call's argument column with its valid byte are read once (at a
// 131072-row chunk of one int64 argument, ~1.4 MB: ~0.4 us at 3.35
// TB/s); the partials are a few KB.

#include "key_hash.cuh"

namespace {

constexpr int kMaxCalls = 8;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 256;
constexpr i64 kI64Max = 0x7fffffffffffffffLL;
constexpr i64 kI64Min = static_cast<i64>(0x8000000000000000ULL);
constexpr i64 kPosInf = 0x7ff0000000000000LL;   // bits of +inf
constexpr i64 kNegInf = static_cast<i64>(0xfff0000000000000ULL);

enum Kind { COUNT = 0, SUM = 1, MIN = 2, MAX = 3, COUNT_SUM = 4 };

struct Calls {
  int kind[kMaxCalls];
  int state_float[kMaxCalls];
  const void* value[kMaxCalls];        // nullptr for count(*)
  int type[kMaxCalls];
  const unsigned char* valid[kMaxCalls];   // nullptr: all valid
  void* state[kMaxCalls];              // int64 or float64 scalar
  int n;                               // calls; slot n is row_count
};

__device__ __forceinline__ double as_f(i64 b) {
  return __longlong_as_double(b);
}

__device__ __forceinline__ i64 as_bits(double d) {
  return __double_as_longlong(d);
}

__device__ __forceinline__ i64 identity(int kind, int fl) {
  if (kind == MIN) return fl ? kPosInf : kI64Max;
  if (kind == MAX) return fl ? kNegInf : kI64Min;
  return fl ? as_bits(0.0) : 0;
}

__device__ __forceinline__ double fmin_nan(double a, double b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}

__device__ __forceinline__ double fmax_nan(double a, double b) {
  return a != a ? a : (b != b ? b : (b > a ? b : a));
}

__device__ __forceinline__ i64 combine(int kind, int fl, i64 a, i64 b) {
  if (fl) {
    const double x = as_f(a), y = as_f(b);
    if (kind == MIN) return as_bits(fmin_nan(x, y));
    if (kind == MAX) return as_bits(fmax_nan(x, y));
    return as_bits(x + y);
  }
  if (kind == MIN) return a < b ? a : b;
  if (kind == MAX) return a > b ? a : b;
  return static_cast<i64>(static_cast<u64>(a) + static_cast<u64>(b));
}

__device__ __forceinline__ i64 load_i(const void* p, int type, long long i) {
  if (type == RW_F64) {
    return static_cast<i64>(static_cast<const double*>(p)[i]);
  }
  return static_cast<i64>(rw_lane_u64(p, type, i));
}

__device__ __forceinline__ double load_f(const void* p, int type,
                                         long long i) {
  if (type == RW_F64) return static_cast<const double*>(p)[i];
  return static_cast<double>(load_i(p, type, i));
}

// block-wide fold of one value a thread in a fixed order (xor butterflies
// within warps, then the warps in order); the result lands in thread 0
__device__ __forceinline__ i64 block_combine(i64 v, int kind, int fl) {
  __shared__ i64 s_v[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = combine(kind, fl, v, __shfl_xor_sync(RW_FULL_MASK, v, o));
  }
  if (lane == 0) s_v[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
      v = combine(kind, fl, v, s_v[w]);
    }
  }
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(kThreads)
sa_partials_kernel(long long N, const signed char* __restrict__ ops,
                   const unsigned char* __restrict__ vis, Calls c,
                   i64* __restrict__ partials) {
  __shared__ Calls s;
  if (threadIdx.x == 0) s = c;
  __syncthreads();
  i64 acc[kMaxCalls + 1];
#pragma unroll
  for (int k = 0; k <= kMaxCalls; ++k) {
    acc[k] = k < s.n ? identity(s.kind[k], s.state_float[k]) : 0;
  }
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads
                     + threadIdx.x; i < N; i += stride) {
    int sign = 0;
    if (vis[i]) sign = (ops[i] == 0 || ops[i] == 3) ? 1 : -1;
    acc[kMaxCalls] += sign;
#pragma unroll
    for (int k = 0; k < kMaxCalls; ++k) {
      if (k >= s.n) break;
      const int kind = s.kind[k], fl = s.state_float[k];
      const int rs = (s.valid[k] && !s.valid[k][i]) ? 0 : sign;
      if (kind == COUNT) {
        acc[k] += rs;
      } else if (kind == COUNT_SUM || (kind == SUM && !fl)) {
        acc[k] = static_cast<i64>(static_cast<u64>(acc[k])
            + static_cast<u64>(load_i(s.value[k], s.type[k], i))
                * static_cast<u64>(static_cast<i64>(rs)));
      } else if (kind == SUM) {
        // the reference multiplies every row by its sign (0 included)
        acc[k] = as_bits(as_f(acc[k]) + load_f(s.value[k], s.type[k], i)
                                        * static_cast<double>(rs));
      } else if (rs > 0) {
        acc[k] = combine(kind, fl, acc[k],
                         fl ? as_bits(load_f(s.value[k], s.type[k], i))
                            : load_i(s.value[k], s.type[k], i));
      }
    }
  }
  for (int k = 0; k <= s.n; ++k) {
    const int slot = k < s.n ? k : kMaxCalls;
    const int kind = k < s.n ? (s.kind[k] == COUNT_SUM ? SUM : s.kind[k])
                             : COUNT;
    const int fl = k < s.n ? s.state_float[k] : 0;
    const i64 v = block_combine(acc[slot], kind, fl);
    if (threadIdx.x == 0) {
      partials[static_cast<long long>(blockIdx.x) * (kMaxCalls + 1) + k] = v;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
sa_combine_kernel(Calls c, const i64* __restrict__ partials, int blocks,
                  i64* __restrict__ row_count) {
  for (int k = 0; k <= c.n; ++k) {
    const int kind = k < c.n ? (c.kind[k] == COUNT_SUM ? SUM : c.kind[k])
                             : COUNT;
    const int fl = k < c.n ? c.state_float[k] : 0;
    i64 v = identity(kind, fl);
    for (int b = threadIdx.x; b < blocks; b += kThreads) {
      v = combine(kind, fl, v,
                  partials[static_cast<long long>(b) * (kMaxCalls + 1) + k]);
    }
    v = block_combine(v, kind, fl);
    if (threadIdx.x == 0) {
      i64* st = k < c.n ? static_cast<i64*>(c.state[k]) : row_count;
      *st = combine(kind, fl, *st, v);
    }
  }
}

}  // namespace

// partials must hold rw_simple_agg_blocks(N) x (kMaxCalls + 1) int64
extern "C" int rw_simple_agg_blocks(long long N) {
  const int nb = rw_blocks(N, kThreads);
  return nb < 1 ? 1 : (nb > kMaxBlocks ? kMaxBlocks : nb);
}

extern "C" int rw_simple_agg_apply(
    long long N, const signed char* ops, const unsigned char* vis,
    int n_calls, const int* kinds, const int* state_float,
    void* const* values, const int* types, void* const* valids,
    void* const* states, long long* row_count, long long* partials,
    void* stream_) {
  if (n_calls < 0 || n_calls > kMaxCalls || N < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  Calls c = {};
  c.n = n_calls;
  for (int k = 0; k < n_calls; ++k) {
    c.kind[k] = kinds[k];
    c.state_float[k] = state_float[k];
    c.value[k] = values[k];
    c.type[k] = types[k];
    c.valid[k] = static_cast<const unsigned char*>(valids[k]);
    c.state[k] = states[k];
  }
  const int blocks = rw_simple_agg_blocks(N);
  sa_partials_kernel<<<blocks, kThreads, 0, stream>>>(N, ops, vis, c,
                                                      partials);
  sa_combine_kernel<<<1, kThreads, 0, stream>>>(
      c, partials, blocks, reinterpret_cast<i64*>(row_count));
  return static_cast<int>(cudaGetLastError());
}
