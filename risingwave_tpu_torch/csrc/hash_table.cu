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
//            With integer keys only, the leader writes its key there.
//   resolve— with a float64 key column, a leader writes its key into its
//            slot here instead, taken from the key's first row in chunk
//            order (an atomicMin in the claim: the reference's sort-1
//            run leader, so -0.0 and +0.0 store the bits the reference
//            stores); every other missing row copies its leader's slot;
//            rows left without a slot are counted (one atomic per warp).
//            Integer keys skip the first-row set: a key's rows all hold
//            the same bits, so the integer path does the work it did
//            before float64 keys were taken.
// Key columns are int64, int32 or float64, each with its type code
// (csrc/hash_probe.cuh): a float64 key hashes by its `astype(uint64)`
// value lane and compares with IEEE `==`, in the probe, the election
// and the warp dedup. So -0.0 and +0.0 are one key, and every NaN row
// is a key of its own and its own leader, as in the reference's sort-1
// runs (NaN == NaN is false there too).
// Because the bucket choice reads the pre-chunk fill, every bucket
// receives the same number of new keys as in the reference, so the
// per-bucket fill, the number of distinct unresolved keys and
// n_unresolved > 0 all agree with it; only the order of new keys inside
// a bucket (and so which key of an overfull bucket is unresolved) may
// differ.

#include "hash_probe.cuh"

namespace {

constexpr int kSlots = kHtSlots;
constexpr int kMaxKeys = kHtMaxKeys;
constexpr int kThreads = 256;

// Lanes of `grp` whose keys equal those of the group's first lane (a
// float64 NaN equals nothing, so a NaN row always probes on its own).
__device__ __forceinline__ bool same_as_leader(unsigned grp, int ldr,
                                               const HtKeyCols& kc,
                                               const i64* keys) {
  bool same = true;
#pragma unroll
  for (int c = 0; c < kMaxKeys; ++c) {
    if (c < kc.n) {
      same &= rw_ht_eq(__shfl_sync(grp, keys[c], ldr), keys[c], kc.type[c]);
    }
  }
  return same;
}

__global__ void ht_probe_kernel(HtKeyCols kc, const unsigned char* occupied,
                                int n_buckets,
                                const unsigned char* __restrict__ active,
                                int N, int* __restrict__ slots,
                                int* __restrict__ cbucket,
                                int* __restrict__ cfill, int* scratch,
                                int* first_row, bool first_bits,
                                int scratch_cap, int* bucket_count,
                                int* n_unresolved,
                                int* __restrict__ leader_of) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = tid; j < scratch_cap; j += stride) {
    scratch[j] = -1;
    if (first_bits) first_row[j] = 0x7fffffff;
  }
  for (long long j = tid; j < n_buckets; j += stride) bucket_count[j] = 0;
  if (tid == 0) *n_unresolved = 0;

  const int lane = threadIdx.x & 31;
  const bool in = tid < N;
  const bool act = in && active[tid];
  // no leader until the claim elects one: the resolve launch reads it
  // for every active row, and the buffer holds whatever the last user
  // left there (a hit row whose stale entry named itself would write a
  // key from an unset first_row entry)
  if (in) leader_of[tid] = -1;
  i64 keys[kMaxKeys];
  u64 h = 0;
  if (act) {
    rw_ht_load_keys(kc, tid, keys);
    h = rw_ht_hash(kc, keys);
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
    rw_ht_probe(kc, occupied, n_buckets, h, keys, &slot, &cb, &cf);
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

// Row id of the chunk-wide leader of `keys` (this row if it won), and
// the key's entry in the chunk-local set.
__device__ int elect(const HtKeyCols& kc, int* scratch, int scratch_cap,
                     u64 h, const i64* keys, int row, unsigned* entry) {
  const unsigned mask = static_cast<unsigned>(scratch_cap - 1);
  unsigned p = static_cast<unsigned>(h ^ (h >> 29)) & mask;
  while (true) {
    int cur = scratch[p];
    if (cur == -1) {
      const int prev = atomicCAS(&scratch[p], -1, row);
      if (prev == -1) {
        *entry = p;
        return row;
      }
      cur = prev;
    }
    if (rw_ht_row_eq(kc, cur, keys)) {
      *entry = p;
      return cur;
    }
    p = (p + 1) & mask;
  }
}

__global__ void ht_claim_kernel(HtKeyCols kc, unsigned char* occupied,
                                const unsigned char* __restrict__ active,
                                int N, int* slots,
                                int* __restrict__ cbucket,
                                const int* __restrict__ cfill, int* scratch,
                                int* first_row, bool first_bits,
                                int scratch_cap, int* bucket_count,
                                int* __restrict__ leader_of) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool miss = tid < N && active[tid] && slots[tid] < 0;
  const unsigned mmask = __ballot_sync(RW_FULL_MASK, miss);
  if (!miss) return;
  i64 keys[kMaxKeys];
  rw_ht_load_keys(kc, tid, keys);
  const u64 h = rw_ht_hash(kc, keys);
  const unsigned grp = __match_any_sync(mmask, h);
  const int ldr = __ffs(grp) - 1;
  const bool same = same_as_leader(grp, ldr, kc, keys);
  const int row = static_cast<int>(tid);
  int leader = -1;
  unsigned entry = 0;
  if (lane == ldr || !same) {
    leader = elect(kc, scratch, scratch_cap, h, keys, row, &entry);
    // the key's first row in chunk order (a warp group's first lane is
    // its first row): the reference's sort-1 run leader, whose key bits
    // the table keeps (-0.0 or +0.0)
    if (first_bits) atomicMin(&first_row[entry], row);
  }
  const int l_leader = __shfl_sync(grp, leader, ldr);
  if (lane != ldr && same) leader = l_leader;
  leader_of[tid] = leader;
  if (leader == row) {
    const int cb = cbucket[tid];
    if (first_bits) cbucket[tid] = static_cast<int>(entry);  // for resolve
    const int pos = atomicAdd(&bucket_count[cb], 1);
    const int at = cfill[tid] + pos;
    if (at < kSlots) {
      const long long slot = static_cast<long long>(cb) * kSlots + at;
      if (!first_bits) {
#pragma unroll
        for (int c = 0; c < kMaxKeys; ++c) {
          if (c < kc.n) rw_ht_store(kc.tcol[c], kc.type[c], slot, keys[c]);
        }
      }
      occupied[slot] = 1;
      slots[tid] = static_cast<int>(slot);
    }
  }
}

__global__ void ht_resolve_kernel(HtKeyCols kc,
                                  const unsigned char* __restrict__ active,
                                  int N, int* slots,
                                  const int* __restrict__ leader_of,
                                  const int* __restrict__ cbucket,
                                  const int* __restrict__ first_row,
                                  bool first_bits, int* n_unresolved) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  bool unresolved = false;
  if (tid < N && active[tid]) {
    int s = slots[tid];
    const int l = leader_of[tid];
    if (first_bits && l == tid && s >= 0) {
      // a leader writes its new key, as the run's first row holds it
      const int src = first_row[cbucket[tid]];
#pragma unroll
      for (int c = 0; c < kMaxKeys; ++c) {
        if (c < kc.n) {
          rw_ht_store(kc.tcol[c], kc.type[c], s,
                      rw_ht_load(kc.col[c], kc.type[c], src));
        }
      }
    } else if (s < 0 && l >= 0 && l != tid) {
      // a follower copies its leader's slot; a leader's slot was final
      // after the claim launch
      s = slots[l];
      slots[tid] = s;
    }
    unresolved = s < 0;
  }
  const unsigned b = __ballot_sync(RW_FULL_MASK, unresolved);
  if ((threadIdx.x & 31) == 0 && b) atomicAdd(n_unresolved, __popc(b));
}

}  // namespace

extern "C" int rw_ht_lookup_or_insert(
    int n_keys, void* const* key_cols, void* const* table_keys,
    const int* types, unsigned char* occupied, int capacity,
    const unsigned char* active, int N, int* slots, int* n_unresolved,
    int* scratch, int* first_row, int scratch_cap, int* bucket_count,
    int* leader_of, int* cbucket, int* cfill, void* stream) {
  if (n_keys < 1 || n_keys > kMaxKeys || capacity % kSlots ||
      (scratch_cap & (scratch_cap - 1)) || scratch_cap < 2 * N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  HtKeyCols kc;
  kc.n = n_keys;
  bool first_bits = false;     // a float64 key column: -0.0 and +0.0
  for (int c = 0; c < kMaxKeys; ++c) {
    kc.col[c] = c < n_keys ? key_cols[c] : nullptr;
    kc.tcol[c] = c < n_keys ? table_keys[c] : nullptr;
    kc.type[c] = c < n_keys ? types[c] : RW_I64;
    if (kc.type[c] != RW_I64 && kc.type[c] != RW_I32 &&
        kc.type[c] != RW_F64) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    first_bits |= kc.type[c] == RW_F64;
  }
  if (first_bits && first_row == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_buckets = capacity / kSlots;
  const int blocks = N > 0 ? rw_blocks(N, kThreads) : 1;
  ht_probe_kernel<<<blocks, kThreads, 0, s>>>(
      kc, occupied, n_buckets, active, N, slots, cbucket, cfill, scratch,
      first_row, first_bits, scratch_cap, bucket_count, n_unresolved,
      leader_of);
  if (N > 0) {
    ht_claim_kernel<<<blocks, kThreads, 0, s>>>(
        kc, occupied, active, N, slots, cbucket, cfill, scratch, first_row,
        first_bits, scratch_cap, bucket_count, leader_of);
    ht_resolve_kernel<<<blocks, kThreads, 0, s>>>(
        kc, active, N, slots, leader_of, cbucket, first_row, first_bits,
        n_unresolved);
  }
  return static_cast<int>(cudaGetLastError());
}
