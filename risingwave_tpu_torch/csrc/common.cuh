// Shared device helpers of the port's hand-written kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define RW_FULL_MASK 0xffffffffu

typedef unsigned long long u64;
typedef long long i64;

// Public splitmix64 finalizer — the JAX package's `_splitmix64`
// (connectors/nexmark.py) and the per-column step of `_bucket_pair`
// (ops/hash_table.py), in native uint64.
__device__ __forceinline__ u64 rw_splitmix64(u64 x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

// Floor division of int64 by a nonzero divisor (jnp.floor_divide).
__device__ __forceinline__ i64 rw_floordiv(i64 a, i64 b) {
  i64 q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// Load element i of a key column of width 4 or 8 bytes, widened to 64
// bits with sign extension (as `astype(uint64)` does in the reference).
__device__ __forceinline__ i64 rw_load_key(const void* col, int width,
                                           long long i) {
  return width == 8 ? static_cast<const i64*>(col)[i]
                    : static_cast<i64>(static_cast<const int32_t*>(col)[i]);
}

__device__ __forceinline__ void rw_store_key(void* col, int width,
                                             long long i, i64 v) {
  if (width == 8) {
    static_cast<i64*>(col)[i] = v;
  } else {
    static_cast<int32_t*>(col)[i] = static_cast<int32_t>(v);
  }
}

// Floats as XLA's CPU programs compare and sort them: a value below its
// type's smallest normal counts as zero. The smallest normal float64 and
// float32:
#define RW_TINY_F64 2.2250738585072014e-308
#define RW_TINY_F32 1.1754943508222875e-38

// x as that compare sees it (subnormals flushed to zero).
__device__ __forceinline__ double rw_daz(double x,
                                         double tiny = RW_TINY_F64) {
  return fabs(x) < tiny ? 0.0 : x;
}

// `x == y` as XLA computes it on the CPU: NaN equals nothing, zeros and
// subnormals (below `tiny`, the smallest normal of the values' type) are
// all equal.
__device__ __forceinline__ bool rw_float_eq(double x, double y,
                                            double tiny = RW_TINY_F64) {
  return rw_daz(x, tiny) == rw_daz(y, tiny);
}

// A float64 as an int64 that orders as jnp.argsort orders floats on the
// CPU: zeros and subnormals equal (0), NaNs last and equal.
__device__ __forceinline__ i64 rw_float_key(double x) {
  const i64 top = 0x7fffffffffffffffLL;
  if (x != x) return top;
  if (fabs(x) < RW_TINY_F64) return 0;
  const i64 b = __double_as_longlong(x);
  return b >= 0 ? b : (b ^ top);
}

static inline int rw_blocks(long long n, int threads) {
  return static_cast<int>((n + threads - 1) / threads);
}
