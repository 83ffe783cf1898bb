// Shared arithmetic of the Nexmark generator kernels (K1, K9, K10): the
// JAX package's _rand (connectors/nexmark.py:127) over its _splitmix64
// (118), the event-kind interleaving and _ids_so_far (141).
#pragma once

#include "common.cuh"

constexpr i64 kPersonProportion = 1;
constexpr i64 kAuctionProportion = 3;
constexpr i64 kBidProportion = 46;
constexpr i64 kTotalProportion = 50;
constexpr i64 kFirstPersonId = 1000;
constexpr i64 kFirstAuctionId = 1000;
constexpr i64 kFirstCategoryId = 10;

__device__ __forceinline__ u64 rw_nexmark_hash(i64 eid, u64 salt) {
  return rw_splitmix64(static_cast<u64>(eid) * 2654435761ULL + salt);
}

// _rand with a compile-time modulus: nvcc turns the remainder into a
// multiply-high.
template <u64 MOD>
__device__ __forceinline__ i64 rw_rand_c(i64 eid, u64 salt) {
  return static_cast<i64>(rw_nexmark_hash(eid, salt) % MOD);
}

// _rand with a runtime modulus (vocabulary sizes, config knobs).
__device__ __forceinline__ i64 rw_rand_r(i64 eid, u64 salt, u64 mod) {
  return static_cast<i64>(rw_nexmark_hash(eid, salt) % mod);
}

// _vocab_pick: a dictionary id from an id table of n entries.
__device__ __forceinline__ int rw_vocab_pick(const int* __restrict__ ids,
                                             int n, i64 eid, u64 salt) {
  return ids[rw_rand_r(eid, salt, static_cast<u64>(n))];
}

// _ids_so_far: persons and auctions emitted before global event id gid.
__device__ __forceinline__ void rw_ids_so_far(i64 gid, i64* n_persons,
                                              i64* n_auctions) {
  const i64 g = rw_floordiv(gid, kTotalProportion);
  const i64 o = gid - g * kTotalProportion;
  *n_persons =
      g * kPersonProportion + (o < kPersonProportion ? o : kPersonProportion);
  i64 ao = o - kPersonProportion;
  ao = ao < 0 ? 0 : (ao > kAuctionProportion ? kAuctionProportion : ao);
  *n_auctions = g * kAuctionProportion + ao;
}
