// K19 — within-chunk pk-run netting of a retracting input: the
// stream-key hash of every chunk row, the netting flags and the insert
// hashes. One kernel for both retracting stores of the port: the sorted
// store's apply and the sorted join's own-side update.
//
// Replaces the chunk side of risingwave_tpu/stream/sorted_store.py:
// sorted_store_apply (28), lines 38-62, and the same netting in
// risingwave_tpu/stream/sorted_join.py:_apply_impl (386-406): h = key_hash(pk
// columns); rows grouped by pk (a stable lexsort, which stays K11 passes)
// are netted to one delete (the run's first row, if a retraction) and
// one insert (the run's last row, if an insertion) per pk; ins_h = is_ins
// ? h : sentinel. The rest of sorted_store_apply — delete victims by
// exact (hash, pk) match with the lowest position winning, and the stable
// merge-insert with state rows before new rows of equal hash — has the
// contract of the sorted join's side update, so it runs on kernel K7
// (csrc/sorted_join_merge.cu) after a K11 sort of ins_h. The join keeps
// only the flags: its K6 hashes the join key, not the pk.
//
// What bounds it on the H100: bytes. A sorted position reads its row
// index, the row's activity, op and pk lanes and its two neighbours'
// (served by the cache), and writes h, ins_h and two flag bytes: at
// q5_topn's 524288-row agg changelog chunk with one int64 pk, ~8+1+1+8
// in and 8+8+2 out, ~18.9 MB, ~5.6 us at 3.35 TB/s.
//
// Design: one thread a sorted position. The permutation makes every row
// written exactly once, so there is no atomic and no scan: a run's start
// and end are local facts (the neighbour's pk and activity), and the
// flags scatter straight to the row's chunk position.

#include "key_hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPk = 4;

struct PkCols {
  const void* col[kMaxPk];
  int type[kMaxPk];
  int n;
};

__device__ __forceinline__ bool lane_eq(const void* col, int type,
                                        long long a, long long b) {
  if (type == RW_F64) {
    return static_cast<const double*>(col)[a]
        == static_cast<const double*>(col)[b];
  }
  return rw_lane_u64(col, type, a) == rw_lane_u64(col, type, b);
}

__device__ __forceinline__ bool pk_eq(const PkCols& pk, long long a,
                                      long long b) {
  for (int k = 0; k < pk.n; ++k) {
    if (!lane_eq(pk.col[k], pk.type[k], a, b)) return false;
  }
  return true;
}

__global__ void __launch_bounds__(kThreads)
pk_net_kernel(PkCols pk, const i64* order, const unsigned char* active,
                 const signed char* ops, long long n, i64* h,
                 unsigned char* is_del, unsigned char* is_ins, i64* ins_h) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i >= n) return;
  const long long o = order[i];
  const bool act = active[o] != 0;
  bool same_prev = false, same_next = false;
  if (act && i > 0) {
    const long long p = order[i - 1];
    same_prev = active[p] != 0 && pk_eq(pk, o, p);
  }
  if (act && i + 1 < n) {
    const long long q = order[i + 1];
    same_next = active[q] != 0 && pk_eq(pk, o, q);
  }
  const signed char op = ops[o];
  const bool insert = op == 0 || op == 3;   // Insert / UpdateInsert
  const bool del = act && !same_prev && !insert;
  const bool ins = act && !same_next && insert;
  u64 hv = kKeyHashSeed;
  for (int k = 0; k < pk.n; ++k) {
    hv = rw_key_hash_step(hv, rw_lane_u64(pk.col[k], pk.type[k], o));
  }
  const i64 hh = rw_key_hash_finish(hv);
  h[o] = hh;
  is_del[o] = del ? 1 : 0;
  is_ins[o] = ins ? 1 : 0;
  ins_h[o] = ins ? hh : kHashSentinel;
}

}  // namespace

extern "C" int rw_pk_net(int n_pk, void* const* pk_cols,
                            const int* pk_types, const long long* order,
                            const unsigned char* active,
                            const signed char* ops, long long n,
                            long long* h, unsigned char* is_del,
                            unsigned char* is_ins, long long* ins_h,
                            void* stream) {
  if (n_pk < 1 || n_pk > kMaxPk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PkCols pk = {};
  pk.n = n_pk;
  for (int k = 0; k < n_pk; ++k) {
    pk.col[k] = pk_cols[k];
    pk.type[k] = pk_types[k];
  }
  if (n > 0) {
    pk_net_kernel<<<rw_blocks(n, kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        pk, reinterpret_cast<const i64*>(order), active, ops, n,
        reinterpret_cast<i64*>(h), is_del, is_ins,
        reinterpret_cast<i64*>(ins_h));
  }
  return static_cast<int>(cudaGetLastError());
}
