// K20 — the retractable top-N's sort keys, ranks and top-set selection.
//
// Replaces risingwave_tpu/stream/retract_top_n.py:
// RetractableTopNExecutor._flush_impl (118), lines 121-150, around the
// lexsort that stays K11 passes:
//   keys  (rw_topn_keys, before the lexsort): every order key as an
//         int64 that sorts as the reference's does (integers as they
//         are, DESC by bitwise complement, which stays signed; floats by
//         an order-keeping map of their bits, DESC by negation first,
//         ±0 and subnormals equal to 0 as XLA's CPU sort compares them,
//         every NaN last and equal), and the group key: the group
//         columns' key hash (0 without group keys) for live slots, int64
//         max for dead ones. Thread 0 also zeroes the top-set count.
//   rank  (rw_topn_rank, after the lexsort by (group key, order keys,
//         row-key hash)): a slot's rank within its group's run is its
//         sorted position minus the run's start, the reference's cummax
//         over run starts; it selects offset <= rank < offset + limit
//         among live slots, writes each selected slot's full-row key
//         hash (the sentinel elsewhere) and counts them.
// A K11 sort of those hashes (carrying the lexsort order) follows, as the
// reference's jnp.argsort(topk, stable=True) at :153; kernel K21 diffs.
//
// What bounds it on the H100: bytes, both entries. keys reads each
// slot's order and group columns and writes one int64 a key (q5_topn:
// C = 2^17 slots, one int64 order key: ~2.1 MB, ~0.6 us); rank reads
// the order, the group key and, for the selected slots only, their row
// columns, and writes topk (~3.1 MB, ~0.9 us at 3.35 TB/s).
//
// Design: the group key is the lexsort's most significant key, so the
// sorted group keys ascend, and a run's start is the first position
// holding the same group key: a binary search over the sorted prefix
// (gathered through the order), not a scan. Every slot is independent
// and no pass crosses blocks; the count is one atomic a warp.

#include "key_hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOrder = 4;
constexpr int kMaxGroup = 4;
constexpr int kMaxCols = 8;
constexpr i64 kMaxKey = 0x7fffffffffffffffLL;

struct KeyArgs {
  const void* order_col[kMaxOrder];
  int order_type[kMaxOrder];
  int order_desc[kMaxOrder];
  i64* order_key[kMaxOrder];
  int n_order;
  const void* group_col[kMaxGroup];
  int group_type[kMaxGroup];
  int n_group;
};

struct RowCols {
  const void* col[kMaxCols];
  int type[kMaxCols];
  int n;
};

__device__ __forceinline__ i64 order_key(const void* col, int type,
                                         bool desc, long long t) {
  if (type == RW_F64) {
    const double x = static_cast<const double*>(col)[t];
    return rw_float_key(desc ? -x : x);
  }
  const i64 v = static_cast<i64>(rw_lane_u64(col, type, t));
  return desc ? ~v : v;
}

__global__ void __launch_bounds__(kThreads)
topn_keys_kernel(KeyArgs a, const int* n_live, long long C, i64* gkey,
                 int* n_top) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (t == 0) *n_top = 0;
  if (t >= C) return;
  for (int k = 0; k < a.n_order; ++k) {
    a.order_key[k][t] = order_key(a.order_col[k], a.order_type[k],
                                  a.order_desc[k] != 0, t);
  }
  i64 g = kMaxKey;
  if (t < *n_live) {
    g = 0;
    if (a.n_group > 0) {
      u64 h = kKeyHashSeed;
      for (int k = 0; k < a.n_group; ++k) {
        h = rw_key_hash_step(h, rw_lane_u64(a.group_col[k],
                                            a.group_type[k], t));
      }
      g = rw_key_hash_finish(h);
    }
  }
  gkey[t] = g;
}

__global__ void __launch_bounds__(kThreads)
topn_rank_kernel(const i64* order, const i64* gkey, const int* n_live,
                 long long C, RowCols rows, long long offset,
                 long long limit, i64* topk, int* n_top) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  bool in_top = false;
  if (i < C) {
    const long long o = order[i];
    if (o < *n_live) {
      // first sorted position with this group key: the run's start
      const i64 g = gkey[o];
      long long lo = 0, hi = i;
      while (lo < hi) {
        const long long mid = (lo + hi) >> 1;
        if (gkey[order[mid]] < g) lo = mid + 1; else hi = mid;
      }
      const long long rank = i - lo;
      in_top = rank >= offset && rank < offset + limit;
    }
    i64 out = kHashSentinel;
    if (in_top) {
      u64 h = kKeyHashSeed;
      for (int k = 0; k < rows.n; ++k) {
        h = rw_key_hash_step(h, rw_lane_u64(rows.col[k], rows.type[k], o));
      }
      out = rw_key_hash_finish(h);
    }
    topk[i] = out;
  }
  const unsigned ballot = __ballot_sync(RW_FULL_MASK, in_top);
  if ((threadIdx.x & 31) == 0 && ballot != 0) {
    atomicAdd(n_top, __popc(ballot));
  }
}

}  // namespace

extern "C" int rw_topn_keys(int n_order, void* const* order_cols,
                            const int* order_types, const int* order_desc,
                            void* const* order_keys, int n_group,
                            void* const* group_cols, const int* group_types,
                            const int* n_live, long long C, long long* gkey,
                            int* n_top, void* stream) {
  if (n_order < 1 || n_order > kMaxOrder || n_group < 0
      || n_group > kMaxGroup) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  KeyArgs a = {};
  a.n_order = n_order;
  for (int k = 0; k < n_order; ++k) {
    a.order_col[k] = order_cols[k];
    a.order_type[k] = order_types[k];
    a.order_desc[k] = order_desc[k];
    a.order_key[k] = static_cast<i64*>(order_keys[k]);
  }
  a.n_group = n_group;
  for (int k = 0; k < n_group; ++k) {
    a.group_col[k] = group_cols[k];
    a.group_type[k] = group_types[k];
  }
  const long long threads = C > 0 ? C : 1;   // thread 0 zeroes n_top
  topn_keys_kernel<<<rw_blocks(threads, kThreads), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      a, n_live, C, reinterpret_cast<i64*>(gkey), n_top);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rw_topn_rank(const long long* order, const long long* gkey,
                            const int* n_live, long long C, int n_cols,
                            void* const* cols, const int* types,
                            long long offset, long long limit,
                            long long* topk, int* n_top, void* stream) {
  if (n_cols < 1 || n_cols > kMaxCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RowCols rows = {};
  rows.n = n_cols;
  for (int k = 0; k < n_cols; ++k) {
    rows.col[k] = cols[k];
    rows.type[k] = types[k];
  }
  if (C > 0) {
    topn_rank_kernel<<<rw_blocks(C, kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const i64*>(order),
        reinterpret_cast<const i64*>(gkey), n_live, C, rows, offset, limit,
        reinterpret_cast<i64*>(topk), n_top);
  }
  return static_cast<int>(cudaGetLastError());
}
