// The two-choice bucketed hash table's key handling and read-only
// probe, shared by K3 (csrc/hash_table.cu: find or claim a slot) and
// K32 (csrc/hash_join_probe.cu: the hash join's probe of the other
// side's key table).
//
// Port of risingwave_tpu/ops/hash_table.py:_bucket_pair (130),
// _candidates (160) and lookup (175). A key column is int64, int32 or
// float64 (RwType codes of key_hash.cuh). Its lane in the splitmix64
// chain is `astype(uint64)`: integers sign-extended, a float64
// converted by value with XLA's saturation (rw_lane_u64). Keys compare
// as the reference compares them: integers bit for bit, float64 with
// IEEE `==` as XLA's CPU computes it (rw_float_eq: NaN equals nothing,
// -0.0 equals +0.0). So every NaN row is a key of its own, and the keys
// below 1.0 (NaN, negatives, zeros, 0.5) share one lane and one bucket
// pair.

#pragma once

#include "key_hash.cuh"

constexpr int kHtSlots = 16;     // slots per bucket (BUCKET_SLOTS)
constexpr int kHtMaxKeys = 4;    // key columns one launch takes

struct HtKeyCols {
  const void* col[kHtMaxKeys];   // the rows' key columns
  void* tcol[kHtMaxKeys];        // the table's key columns [C]
  int type[kHtMaxKeys];          // RW_I64, RW_I32 or RW_F64
  int n;
};

// Element i of a key column as 64 bits: an integer sign-extended, a
// float64's bit pattern.
__device__ __forceinline__ i64 rw_ht_load(const void* col, int type,
                                          long long i) {
  return type == RW_I32
      ? static_cast<i64>(static_cast<const int*>(col)[i])
      : static_cast<const i64*>(col)[i];
}

__device__ __forceinline__ void rw_ht_store(void* col, int type,
                                            long long i, i64 v) {
  if (type == RW_I32) {
    static_cast<int*>(col)[i] = static_cast<int>(v);
  } else {
    static_cast<i64*>(col)[i] = v;
  }
}

// The `astype(uint64)` lane of a key loaded by rw_ht_load.
__device__ __forceinline__ u64 rw_ht_lane(i64 bits, int type) {
  if (type != RW_F64) return static_cast<u64>(bits);
  const double x = __longlong_as_double(bits);
  return rw_lane_u64(&x, RW_F64, 0);
}

__device__ __forceinline__ bool rw_ht_eq(i64 a, i64 b, int type) {
  return type == RW_F64
      ? rw_float_eq(__longlong_as_double(a), __longlong_as_double(b))
      : a == b;
}

__device__ __forceinline__ void rw_ht_load_keys(const HtKeyCols& kc,
                                                long long i, i64* keys) {
#pragma unroll
  for (int c = 0; c < kHtMaxKeys; ++c) {
    keys[c] = c < kc.n ? rw_ht_load(kc.col[c], kc.type[c], i) : 0;
  }
}

__device__ __forceinline__ u64 rw_ht_hash(const HtKeyCols& kc,
                                          const i64* keys) {
  u64 h = kKeyHashSeed;
#pragma unroll
  for (int c = 0; c < kHtMaxKeys; ++c) {
    if (c < kc.n) h = rw_key_hash_step(h, rw_ht_lane(keys[c], kc.type[c]));
  }
  return h;
}

__device__ __forceinline__ bool rw_ht_keys_eq(const HtKeyCols& kc,
                                              const i64* a, const i64* b) {
  bool eq = true;
#pragma unroll
  for (int c = 0; c < kHtMaxKeys; ++c) {
    if (c < kc.n) eq &= rw_ht_eq(a[c], b[c], kc.type[c]);
  }
  return eq;
}

// The table's key at `slot` equals `keys`.
__device__ __forceinline__ bool rw_ht_table_eq(const HtKeyCols& kc,
                                               long long slot,
                                               const i64* keys) {
  bool eq = true;
#pragma unroll
  for (int c = 0; c < kHtMaxKeys; ++c) {
    if (c < kc.n) {
      eq &= rw_ht_eq(rw_ht_load(kc.tcol[c], kc.type[c], slot), keys[c],
                     kc.type[c]);
    }
  }
  return eq;
}

// Row `row`'s key equals `keys`.
__device__ __forceinline__ bool rw_ht_row_eq(const HtKeyCols& kc,
                                             long long row,
                                             const i64* keys) {
  bool eq = true;
#pragma unroll
  for (int c = 0; c < kHtMaxKeys; ++c) {
    if (c < kc.n) {
      eq &= rw_ht_eq(rw_ht_load(kc.col[c], kc.type[c], row), keys[c],
                     kc.type[c]);
    }
  }
  return eq;
}

// Probe both candidate buckets of hash h: the first slot holding `keys`
// (bucket 1 before bucket 2, slots ascending, as the reference's argmax
// over its [2S] candidates), or -1; and for a miss the bucket a new key
// would take (the emptier by fill, the tie bit breaking equal fills)
// with that bucket's fill.
__device__ __forceinline__ void rw_ht_probe(const HtKeyCols& kc,
                                            const unsigned char* occupied,
                                            int n_buckets, u64 h,
                                            const i64* keys, int* slot,
                                            int* cbucket, int* cfill) {
  const u64 nb = static_cast<u64>(n_buckets);
  const int b1 = static_cast<int>((h & 0xFFFFFFFFULL) % nb);
  const int b2 = static_cast<int>((h >> 32) % nb);
  const bool tie = (h >> 31) & 1ULL;
  int found = -1, fill1 = 0, fill2 = 0;
  for (int s = 0; s < kHtSlots; ++s) {
    const long long at = static_cast<long long>(b1) * kHtSlots + s;
    if (occupied[at]) {
      ++fill1;
      if (found < 0 && rw_ht_table_eq(kc, at, keys)) found = (int)at;
    }
  }
  for (int s = 0; s < kHtSlots; ++s) {
    const long long at = static_cast<long long>(b2) * kHtSlots + s;
    if (occupied[at]) {
      ++fill2;
      if (found < 0 && rw_ht_table_eq(kc, at, keys)) found = (int)at;
    }
  }
  const bool choose2 = fill2 < fill1 || (fill2 == fill1 && tie);
  *slot = found;
  *cbucket = choose2 ? b2 : b1;
  *cfill = fill1 < fill2 ? fill1 : fill2;
}

// The reference's `lookup`: the slot holding row i's key, or -1.
__device__ __forceinline__ int rw_ht_lookup(const HtKeyCols& kc,
                                            const unsigned char* occupied,
                                            int n_buckets, long long i) {
  i64 keys[kHtMaxKeys];
  rw_ht_load_keys(kc, i, keys);
  int slot, cb, cf;
  rw_ht_probe(kc, occupied, n_buckets, rw_ht_hash(kc, keys), keys, &slot,
              &cb, &cf);
  return slot;
}
