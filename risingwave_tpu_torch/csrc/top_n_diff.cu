// K21 — the retractable top-N's diff against the last emitted top set.
//
// Replaces risingwave_tpu/stream/retract_top_n.py:
// RetractableTopNExecutor._flush_impl (118), lines 154-183: with the new
// top set's full-row hashes sorted (new_hash, n_top of them before the
// sentinels; src = the store slot of each) and the last emitted set
// (old_hash sorted, old_n, its rows), membership is a binary search of
// one sorted hash array for each hash of the other (the reference's
// `member`, two searchsorteds); the output is the reference's 2C-row
// chunk: rows [0, C) the old set's rows as Deletes, visible where a row
// left the set; rows [C, 2C) the new set's rows (the store gathered
// through src) as Inserts, visible where a row joined it. The new set's
// columns are the output's second half: the executor keeps them as its
// next "last emitted" set (views, no second copy).
//
// What bounds it on the H100: bytes. Every output row is written (2C
// rows of the columns, their valid bytes, an op and a visibility byte)
// and read once from the old set or the store, plus new_hash and src
// (q5_topn: C = 2^17 slots, two int64 columns: ~9.2 MB, ~2.7 us at
// 3.35 TB/s). The binary searches run only for the at most old_n + n_top
// rows that can be visible.
//
// Design: one thread an output row, columns copied by their byte width.

#include "key_hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 8;
constexpr signed char kInsert = 0;
constexpr signed char kDelete = 1;

struct Cols {
  const void* src[kMaxCols];          // store columns (gathered via src)
  const unsigned char* src_valid[kMaxCols];
  const void* old[kMaxCols];          // last emitted set's columns
  const unsigned char* old_valid[kMaxCols];
  void* out[kMaxCols];                // [2C] output columns
  unsigned char* out_valid[kMaxCols];
  int width[kMaxCols];
  int n;
};

__device__ __forceinline__ void copy_elem(void* dst, long long di,
                                          const void* src, long long si,
                                          int width) {
  switch (width) {
    case 8:
      static_cast<i64*>(dst)[di] = static_cast<const i64*>(src)[si];
      break;
    case 4:
      static_cast<int*>(dst)[di] = static_cast<const int*>(src)[si];
      break;
    case 2:
      static_cast<short*>(dst)[di] = static_cast<const short*>(src)[si];
      break;
    default:
      static_cast<unsigned char*>(dst)[di] =
          static_cast<const unsigned char*>(src)[si];
  }
}

// b[lower_bound(b, a)] == a, with the index clipped into [0, C)
__device__ __forceinline__ bool member(i64 a, const i64* b, long long C) {
  long long lo = 0, hi = C;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (b[mid] < a) lo = mid + 1; else hi = mid;
  }
  if (lo > C - 1) lo = C - 1;
  return b[lo] == a;
}

__global__ void __launch_bounds__(kThreads)
topn_diff_kernel(long long C, const i64* old_hash, const int* old_n,
                 const i64* new_hash, const int* new_n, const i64* src,
                 Cols c, signed char* ops, unsigned char* vis) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i >= 2 * C) return;
  if (i < C) {
    for (int k = 0; k < c.n; ++k) {
      copy_elem(c.out[k], i, c.old[k], i, c.width[k]);
      c.out_valid[k][i] = c.old_valid[k][i];
    }
    ops[i] = kDelete;
    vis[i] = (i < *old_n && !member(old_hash[i], new_hash, C)) ? 1 : 0;
  } else {
    const long long j = i - C;
    const long long s = src[j];
    for (int k = 0; k < c.n; ++k) {
      copy_elem(c.out[k], i, c.src[k], s, c.width[k]);
      c.out_valid[k][i] = c.src_valid[k][s];
    }
    ops[i] = kInsert;
    vis[i] = (j < *new_n && !member(new_hash[j], old_hash, C)) ? 1 : 0;
  }
}

}  // namespace

extern "C" int rw_topn_diff(long long C, const long long* old_hash,
                            const int* old_n, const long long* new_hash,
                            const int* new_n, const long long* src,
                            int n_cols, void* const* store_cols,
                            void* const* store_valids,
                            void* const* old_cols, void* const* old_valids,
                            void* const* out_cols, void* const* out_valids,
                            const int* widths, signed char* ops,
                            unsigned char* vis, void* stream) {
  if (n_cols < 1 || n_cols > kMaxCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Cols c = {};
  c.n = n_cols;
  for (int k = 0; k < n_cols; ++k) {
    c.src[k] = store_cols[k];
    c.src_valid[k] = static_cast<const unsigned char*>(store_valids[k]);
    c.old[k] = old_cols[k];
    c.old_valid[k] = static_cast<const unsigned char*>(old_valids[k]);
    c.out[k] = out_cols[k];
    c.out_valid[k] = static_cast<unsigned char*>(out_valids[k]);
    c.width[k] = widths[k];
  }
  if (C > 0) {
    topn_diff_kernel<<<rw_blocks(2 * C, kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        C, reinterpret_cast<const i64*>(old_hash), old_n,
        reinterpret_cast<const i64*>(new_hash), new_n,
        reinterpret_cast<const i64*>(src), c, ops, vis);
  }
  return static_cast<int>(cudaGetLastError());
}
