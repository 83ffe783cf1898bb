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
