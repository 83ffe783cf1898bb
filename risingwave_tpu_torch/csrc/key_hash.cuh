// The sorted join's 63-bit key hash, shared by K6 (the probe hashes a
// chunk's join keys) and K17 (the snapshot diff hashes whole rows).
//
// Port of risingwave_tpu/stream/sorted_join.py:key_hash (102): the
// splitmix64 chain of the hash table's _bucket_pair over the lanes, each
// widened to 64 bits with sign extension, shifted right once so every
// hash lies in [0, 2^63). kHashSentinel, int64 max, pads a store beyond
// its live rows.

#pragma once

#include "common.cuh"

constexpr u64 kKeyHashSeed = 0x243F6A8885A308D3ULL;
constexpr u64 kGolden = 0x9E3779B97F4A7C15ULL;
constexpr i64 kHashSentinel = 0x7fffffffffffffffLL;

// One link of the chain: h <- splitmix64(h ^ lane * golden).
__device__ __forceinline__ u64 rw_key_hash_step(u64 h, u64 lane) {
  return rw_splitmix64(h ^ (lane * kGolden));
}

// The chain's end: the 63-bit nonnegative hash.
__device__ __forceinline__ i64 rw_key_hash_finish(u64 h) {
  return static_cast<i64>(h >> 1);
}

// Column element types of the kernels' column tables (expr/program.py's
// TYPE_CODES).
enum RwType { RW_I64 = 0, RW_I32 = 1, RW_I16 = 2, RW_I8 = 3, RW_BOOL = 4,
              RW_F64 = 5 };

// Element i of a typed column as the lane `astype(uint64)` gives in the
// JAX package: integers sign-extended, bools 0/1, float64 converted by
// value with XLA's saturation (NaN and values below 1 give 0, values
// from 2^64 up give 2^64 - 1).
__device__ __forceinline__ u64 rw_lane_u64(const void* col, int type,
                                           long long i) {
  switch (type) {
    case RW_I64: return static_cast<u64>(static_cast<const i64*>(col)[i]);
    case RW_I32:
      return static_cast<u64>(static_cast<i64>(
          static_cast<const int*>(col)[i]));
    case RW_I16:
      return static_cast<u64>(static_cast<i64>(
          static_cast<const short*>(col)[i]));
    case RW_I8:
      return static_cast<u64>(static_cast<i64>(
          static_cast<const signed char*>(col)[i]));
    case RW_BOOL:
      return static_cast<const unsigned char*>(col)[i] != 0 ? 1ULL : 0ULL;
    default: {
      const double x = static_cast<const double*>(col)[i];
      if (!(x >= 1.0)) return 0ULL;
      if (x >= 18446744073709551616.0) return ~0ULL;
      return static_cast<u64>(x);
    }
  }
}
