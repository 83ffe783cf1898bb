// K3 — find-or-claim slots in the two-choice bucketed hash table.
//
// Replaces risingwave_tpu/ops/hash_table.py:lookup_or_insert (190), with
// _bucket_pair (130) and _candidates (160). On the TPU that is a
// [N, 32] gather-compare plus two device sorts (in-chunk dedup, then
// ranking leaders inside their bucket) and scatters.
//
// What bounds it on the H100: neither bytes nor arithmetic but
// contention. Nexmark bids are skewed (99% go to the current hot
// auction), so a 655360-row chunk after HOP holds a few hundred distinct
// groups and nearly every warp of 32 consecutive rows shares one key: a
// naive per-row probe reads the same two buckets 32 times per warp, and
// a naive per-row claim serializes thousands of atomics on one address.
// The byte bound (key columns + active read once, slots written once,
// the touched buckets read once) is a few microseconds.
//
// Design, three launches on the caller's stream:
//   probe  — warp dedup first: lanes whose key hashes agree
//            (__match_any_sync on the 64-bit hash, then an exact key
//            check against the group's first lane) let that lane probe
//            both buckets once and share its answer by shuffle. A probe
//            returns the existing slot, or for a miss the chosen bucket
//            (the emptier one by PRE-CHUNK fill, the tie bit breaking
//            equal fills) and its pre-chunk fill. The same launch clears
//            the chunk-local scratch below.
//   claim  — missing rows elect one leader per distinct key: warp dedup
//            again, then the group's first lane CASes the row id into a
//            chunk-local open-addressing set keyed by the hash (a loser
//            compares keys with the winner and probes on if they
//            differ). A leader takes position atomicAdd(count[bucket])
//            and owns slot bucket*16 + fill + position if that is inside
//            the bucket, else it is unresolved.
//   resolve— every other missing row copies its leader's slot; rows left
//            without a slot are counted (one atomic per warp).
// Because the bucket choice reads the pre-chunk fill, every bucket
// receives the same number of new keys as in the reference, so the
// per-bucket fill, the number of distinct unresolved keys and
// n_unresolved > 0 all agree with it; only the order of new keys inside
// a bucket (and so which key of an overfull bucket is unresolved) may
// differ.

#include "common.cuh"

namespace {

constexpr int kSlots = 16;
constexpr int kMaxKeys = 4;
constexpr int kThreads = 256;

struct KeyCols {
  const void* col[kMaxKeys];   // chunk key columns [N]
  void* tcol[kMaxKeys];        // table key columns [C]
  int width[kMaxKeys];
  int n;
};

__device__ __forceinline__ u64 key_hash(const KeyCols& kc, const i64* keys) {
  u64 h = 0x243F6A8885A308D3ULL;
#pragma unroll
  for (int c = 0; c < kMaxKeys; ++c) {
    if (c < kc.n) {
      h = rw_splitmix64(h ^ (static_cast<u64>(keys[c]) *
                             0x9E3779B97F4A7C15ULL));
    }
  }
  return h;
}

__device__ __forceinline__ void load_keys(const KeyCols& kc, long long i,
                                          i64* keys) {
#pragma unroll
  for (int c = 0; c < kMaxKeys; ++c) {
    keys[c] = c < kc.n ? rw_load_key(kc.col[c], kc.width[c], i) : 0;
  }
}

__device__ __forceinline__ bool table_key_equals(const KeyCols& kc,
                                                 long long slot,
                                                 const i64* keys) {
  bool eq = true;
#pragma unroll
  for (int c = 0; c < kMaxKeys; ++c) {
    if (c < kc.n) eq &= rw_load_key(kc.tcol[c], kc.width[c], slot) == keys[c];
  }
  return eq;
}

__device__ __forceinline__ bool row_key_equals(const KeyCols& kc,
                                               long long row,
                                               const i64* keys) {
  bool eq = true;
#pragma unroll
  for (int c = 0; c < kMaxKeys; ++c) {
    if (c < kc.n) eq &= rw_load_key(kc.col[c], kc.width[c], row) == keys[c];
  }
  return eq;
}

// Lanes of `grp` whose keys equal those of the group's first lane.
__device__ __forceinline__ bool same_as_leader(unsigned grp, int ldr,
                                               const KeyCols& kc,
                                               const i64* keys) {
  bool same = true;
#pragma unroll
  for (int c = 0; c < kMaxKeys; ++c) {
    if (c < kc.n) same &= __shfl_sync(grp, keys[c], ldr) == keys[c];
  }
  return same;
}

__device__ void probe(const KeyCols& kc, const unsigned char* occupied,
                      int n_buckets, u64 h, const i64* keys, int* slot,
                      int* cbucket, int* cfill) {
  const u64 nb = static_cast<u64>(n_buckets);
  const int b1 = static_cast<int>((h & 0xFFFFFFFFULL) % nb);
  const int b2 = static_cast<int>((h >> 32) % nb);
  const bool tie = (h >> 31) & 1ULL;
  int found = -1, fill1 = 0, fill2 = 0;
  for (int s = 0; s < kSlots; ++s) {
    const long long at = static_cast<long long>(b1) * kSlots + s;
    if (occupied[at]) {
      ++fill1;
      if (found < 0 && table_key_equals(kc, at, keys)) found = (int)at;
    }
  }
  for (int s = 0; s < kSlots; ++s) {
    const long long at = static_cast<long long>(b2) * kSlots + s;
    if (occupied[at]) {
      ++fill2;
      if (found < 0 && table_key_equals(kc, at, keys)) found = (int)at;
    }
  }
  const bool choose2 = fill2 < fill1 || (fill2 == fill1 && tie);
  *slot = found;
  *cbucket = choose2 ? b2 : b1;
  *cfill = fill1 < fill2 ? fill1 : fill2;
}

__global__ void ht_probe_kernel(KeyCols kc, const unsigned char* occupied,
                                int n_buckets,
                                const unsigned char* __restrict__ active,
                                int N, int* __restrict__ slots,
                                int* __restrict__ cbucket,
                                int* __restrict__ cfill, int* scratch,
                                int scratch_cap, int* bucket_count,
                                int* n_unresolved) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = tid; j < scratch_cap; j += stride) scratch[j] = -1;
  for (long long j = tid; j < n_buckets; j += stride) bucket_count[j] = 0;
  if (tid == 0) *n_unresolved = 0;

  const int lane = threadIdx.x & 31;
  const bool in = tid < N;
  const bool act = in && active[tid];
  i64 keys[kMaxKeys];
  u64 h = 0;
  if (act) {
    load_keys(kc, tid, keys);
    h = key_hash(kc, keys);
  }
  const unsigned amask = __ballot_sync(RW_FULL_MASK, act);
  if (!act) {
    if (in) slots[tid] = -1;
    return;
  }
  const unsigned grp = __match_any_sync(amask, h);
  const int ldr = __ffs(grp) - 1;
  const bool same = same_as_leader(grp, ldr, kc, keys);
  int slot = -1, cb = 0, cf = 0;
  if (lane == ldr || !same) {
    probe(kc, occupied, n_buckets, h, keys, &slot, &cb, &cf);
  }
  const int l_slot = __shfl_sync(grp, slot, ldr);
  const int l_cb = __shfl_sync(grp, cb, ldr);
  const int l_cf = __shfl_sync(grp, cf, ldr);
  if (lane != ldr && same) {
    slot = l_slot;
    cb = l_cb;
    cf = l_cf;
  }
  slots[tid] = slot;
  cbucket[tid] = cb;
  cfill[tid] = cf;
}

// Row id of the chunk-wide leader of `keys` (this row if it won).
__device__ int elect(const KeyCols& kc, int* scratch, int scratch_cap,
                     u64 h, const i64* keys, int row) {
  const unsigned mask = static_cast<unsigned>(scratch_cap - 1);
  unsigned p = static_cast<unsigned>(h ^ (h >> 29)) & mask;
  while (true) {
    int cur = scratch[p];
    if (cur == -1) {
      const int prev = atomicCAS(&scratch[p], -1, row);
      if (prev == -1) return row;
      cur = prev;
    }
    if (row_key_equals(kc, cur, keys)) return cur;
    p = (p + 1) & mask;
  }
}

__global__ void ht_claim_kernel(KeyCols kc, unsigned char* occupied,
                                const unsigned char* __restrict__ active,
                                int N, int* slots,
                                const int* __restrict__ cbucket,
                                const int* __restrict__ cfill, int* scratch,
                                int scratch_cap, int* bucket_count,
                                int* __restrict__ leader_of) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool miss = tid < N && active[tid] && slots[tid] < 0;
  const unsigned mmask = __ballot_sync(RW_FULL_MASK, miss);
  if (!miss) return;
  i64 keys[kMaxKeys];
  load_keys(kc, tid, keys);
  const u64 h = key_hash(kc, keys);
  const unsigned grp = __match_any_sync(mmask, h);
  const int ldr = __ffs(grp) - 1;
  const bool same = same_as_leader(grp, ldr, kc, keys);
  const int row = static_cast<int>(tid);
  int leader = -1;
  if (lane == ldr || !same) {
    leader = elect(kc, scratch, scratch_cap, h, keys, row);
  }
  const int l_leader = __shfl_sync(grp, leader, ldr);
  if (lane != ldr && same) leader = l_leader;
  leader_of[tid] = leader;
  if (leader == row) {
    const int cb = cbucket[tid];
    const int pos = atomicAdd(&bucket_count[cb], 1);
    const int at = cfill[tid] + pos;
    if (at < kSlots) {
      const long long slot = static_cast<long long>(cb) * kSlots + at;
#pragma unroll
      for (int c = 0; c < kMaxKeys; ++c) {
        if (c < kc.n) rw_store_key(kc.tcol[c], kc.width[c], slot, keys[c]);
      }
      occupied[slot] = 1;
      slots[tid] = static_cast<int>(slot);
    }
  }
}

__global__ void ht_resolve_kernel(const unsigned char* __restrict__ active,
                                  int N, int* slots,
                                  const int* __restrict__ leader_of,
                                  int* n_unresolved) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  bool unresolved = false;
  if (tid < N && active[tid]) {
    int s = slots[tid];
    if (s < 0) {
      // a follower copies its leader's slot; a leader's own entry was
      // final after the claim launch (leaders are never written here)
      const int l = leader_of[tid];
      if (l != tid) {
        s = slots[l];
        slots[tid] = s;
      }
    }
    unresolved = s < 0;
  }
  const unsigned b = __ballot_sync(RW_FULL_MASK, unresolved);
  if ((threadIdx.x & 31) == 0 && b) atomicAdd(n_unresolved, __popc(b));
}

}  // namespace

extern "C" int rw_ht_lookup_or_insert(
    int n_keys, void* const* key_cols, void* const* table_keys,
    const int* widths, unsigned char* occupied, int capacity,
    const unsigned char* active, int N, int* slots, int* n_unresolved,
    int* scratch, int scratch_cap, int* bucket_count, int* leader_of,
    int* cbucket, int* cfill, void* stream) {
  if (n_keys < 1 || n_keys > kMaxKeys || capacity % kSlots ||
      (scratch_cap & (scratch_cap - 1)) || scratch_cap < 2 * N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  KeyCols kc;
  kc.n = n_keys;
  for (int c = 0; c < kMaxKeys; ++c) {
    kc.col[c] = c < n_keys ? key_cols[c] : nullptr;
    kc.tcol[c] = c < n_keys ? table_keys[c] : nullptr;
    kc.width[c] = c < n_keys ? widths[c] : 8;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_buckets = capacity / kSlots;
  const int blocks = N > 0 ? rw_blocks(N, kThreads) : 1;
  ht_probe_kernel<<<blocks, kThreads, 0, s>>>(
      kc, occupied, n_buckets, active, N, slots, cbucket, cfill, scratch,
      scratch_cap, bucket_count, n_unresolved);
  if (N > 0) {
    ht_claim_kernel<<<blocks, kThreads, 0, s>>>(
        kc, occupied, active, N, slots, cbucket, cfill, scratch, scratch_cap,
        bucket_count, leader_of);
    ht_resolve_kernel<<<blocks, kThreads, 0, s>>>(active, N, slots,
                                                   leader_of, n_unresolved);
  }
  return static_cast<int>(cudaGetLastError());
}
