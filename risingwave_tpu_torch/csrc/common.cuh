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

static inline int rw_blocks(long long n, int threads) {
  return static_cast<int>((n + threads - 1) / threads);
}
