// The membership diff of a sorted hash set against the last emitted one
// and its [2C]-row Delete/Insert output, shared by K21 (the retractable
// top-N's flush, top_n_diff.cu) and K29 (the dynamic filter's flush,
// dynamic_filter.cu).
//
// Port of the reference's `member` and output chunk (risingwave_tpu/
// stream/retract_top_n.py:154-183, stream/dynamic.py:167-183): with the
// new set's row hashes sorted (new_hash, new_n of them before the
// sentinels; src = the store slot of each) and the last emitted set
// (old_hash sorted, old_n, its rows), membership is a binary search of
// one sorted hash array for each hash of the other, hashes only; the
// output's rows [0, C) are the old set's rows as Deletes, visible where
// a row left the set, rows [C, 2C) the new set's rows (the store
// gathered through src) as Inserts, visible where a row joined it. The
// new set's columns are the output's second half: the executor keeps
// them as its next "last emitted" set (views, no second copy).
//
// What bounds it on the H100: bytes. The diff needs the new set's
// rows (the output's second half, kept as the next emitted set) and the
// visible Deletes' rows read once and written once, the old set's
// hashes, and an op and a visibility byte for each of the 2C rows; the
// other rows' columns are never read downstream. This kernel copies the
// columns of all 2C rows, visible or not; the binary searches run only
// for the at most old_n + new_n rows that can be visible. One thread an
// output row, columns copied by their byte width.

#pragma once

#include "key_hash.cuh"
#include "scan.cuh"

namespace {

constexpr int kDiffThreads = 256;
constexpr int kDiffMaxCols = 16;
constexpr signed char kDiffInsert = 0;
constexpr signed char kDiffDelete = 1;

struct DiffCols {
  const void* src[kDiffMaxCols];          // store columns (gathered via src)
  const unsigned char* src_valid[kDiffMaxCols];
  const void* old[kDiffMaxCols];          // last emitted set's columns
  const unsigned char* old_valid[kDiffMaxCols];
  void* out[kDiffMaxCols];                // [2C] output columns
  unsigned char* out_valid[kDiffMaxCols];
  int width[kDiffMaxCols];
  int n;
};

// b[lower_bound(b, a)] == a, with the index clipped into [0, C)
__device__ __forceinline__ bool rw_member(i64 a, const i64* b, long long C) {
  long long lo = rw_lower_bound(b, C, a);
  if (lo > C - 1) lo = C - 1;
  return b[lo] == a;
}

__global__ void __launch_bounds__(kDiffThreads)
set_diff_kernel(long long C, const i64* old_hash, const int* old_n,
                const i64* new_hash, const int* new_n, const i64* src,
                DiffCols c, signed char* ops, unsigned char* vis) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i >= 2 * C) return;
  if (i < C) {
    for (int k = 0; k < c.n; ++k) {
      rw_copy_elem(c.out[k], i, c.old[k], i, c.width[k]);
      c.out_valid[k][i] = c.old_valid[k][i];
    }
    ops[i] = kDiffDelete;
    vis[i] = (i < *old_n && !rw_member(old_hash[i], new_hash, C)) ? 1 : 0;
  } else {
    const long long j = i - C;
    const long long s = src[j];
    for (int k = 0; k < c.n; ++k) {
      rw_copy_elem(c.out[k], i, c.src[k], s, c.width[k]);
      c.out_valid[k][i] = c.src_valid[k][s];
    }
    ops[i] = kDiffInsert;
    vis[i] = (j < *new_n && !rw_member(new_hash[j], old_hash, C)) ? 1 : 0;
  }
}

// Launch the diff on `stream`; returns cudaGetLastError().
inline int rw_set_diff(long long C, const long long* old_hash,
                       const int* old_n, const long long* new_hash,
                       const int* new_n, const long long* src, int n_cols,
                       void* const* store_cols, void* const* store_valids,
                       void* const* old_cols, void* const* old_valids,
                       void* const* out_cols, void* const* out_valids,
                       const int* widths, signed char* ops,
                       unsigned char* vis, void* stream) {
  if (n_cols < 1 || n_cols > kDiffMaxCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DiffCols c = {};
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
    set_diff_kernel<<<rw_blocks(2 * C, kDiffThreads), kDiffThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        C, reinterpret_cast<const i64*>(old_hash), old_n,
        reinterpret_cast<const i64*>(new_hash), new_n,
        reinterpret_cast<const i64*>(src), c, ops, vis);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
