// K24 — the over-window's diff against the last emitted row set.
//
// Replaces risingwave_tpu/stream/general_over_window.py:
// GeneralOverWindowExecutor._flush_impl (250), lines 264-320, around the
// sort of the row hashes that stays K11:
//   rw_window_hash  the identity of every sorted row (input columns ++
//                   window outputs, K23's output): two lanes a column,
//                   the value (floats as their float64 bits, integers
//                   and bools widened; 0 where NULL) and the valid bit,
//                   chained by the sorted join's key hash; the sentinel
//                   for dead rows.
//   rw_window_diff  after the sort (new_hash ascending, rorder the row of
//                   each): the reference's `member` both ways, a binary
//                   search for the first candidate of equal hash and an
//                   EXACT compare of every lane there (a hash collision
//                   can only cause a redundant delete and insert of an
//                   identical row, never a suppressed emission); then the
//                   2C-row chunk: rows [0, C) the last emitted set as
//                   Deletes, visible where a row left; rows [C, 2C) the
//                   new set (the sorted rows gathered through rorder) as
//                   Inserts, visible where a row is new. The second half
//                   is the next "last emitted" set (views, no copy).
// A new kernel rather than an extension of K21: K21 compares hashes only
// and gathers its new rows from the store, where here every lane is
// compared and the new rows are computed columns.
//
// What bounds it on the H100: bytes, counted over live rows (rows past
// old_n and n_new are invisible and nothing reads their columns). The
// hash reads each live row's columns, valid bytes and order once and
// writes one int64; the diff reads the new hashes, rorder and computed
// rows and the old set's hashes and rows once each, writes the next
// emitted set (every live new row) and the deleted rows of the first
// half, and an op and a visibility byte for each of the 2C rows. The
// lane compares re-read one candidate row for each of the at most
// old_n + n_new rows that can be visible.

#include "scan.cuh"
#include "key_hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 24;
constexpr signed char kInsert = 0;
constexpr signed char kDelete = 1;

struct Rows {
  const void* col[kMaxCols];          // computed rows, sorted order
  const unsigned char* valid[kMaxCols];
  const void* old[kMaxCols];          // last emitted set
  const unsigned char* old_valid[kMaxCols];
  void* out[kMaxCols];                // [2C]
  unsigned char* out_valid[kMaxCols];
  int type[kMaxCols];
  int width[kMaxCols];
  int n;
};

// A column element as its int64 lane: float64 bits, or the integer
// widened with sign extension (bools 0/1).
__device__ __forceinline__ i64 lane_of(const void* col, int type,
                                       long long i) {
  if (type == RW_F64) return static_cast<const i64*>(col)[i];
  return static_cast<i64>(rw_lane_u64(col, type, i));
}

__global__ void __launch_bounds__(kThreads)
wd_hash_kernel(long long C, const i64* __restrict__ order,
               const int* __restrict__ n_live, Rows r,
               i64* __restrict__ rhash) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (i >= C) return;
  if (order[i] >= *n_live) {
    rhash[i] = kHashSentinel;
    return;
  }
  u64 h = kKeyHashSeed;
  for (int k = 0; k < r.n; ++k) {
    const bool v = r.valid[k][i] != 0;
    h = rw_key_hash_step(h, static_cast<u64>(v ? lane_of(r.col[k],
                                                         r.type[k], i)
                                               : 0));
    h = rw_key_hash_step(h, v ? 1ULL : 0ULL);
  }
  rhash[i] = rw_key_hash_finish(h);
}

// every lane of old row a equal to computed row b
__device__ __forceinline__ bool same_row(const Rows& r, long long a,
                                         long long b) {
  for (int k = 0; k < r.n; ++k) {
    const bool va = r.old_valid[k][a] != 0;
    const bool vb = r.valid[k][b] != 0;
    if (va != vb) return false;
    if (va && lane_of(r.old[k], r.type[k], a)
                  != lane_of(r.col[k], r.type[k], b)) {
      return false;
    }
  }
  return true;
}

__device__ __forceinline__ long long first_candidate(const i64* h,
                                                     long long C, i64 v) {
  const long long p = rw_lower_bound(h, C, v);
  return p > C - 1 ? C - 1 : p;
}

__global__ void __launch_bounds__(kThreads)
wd_diff_kernel(long long C, const i64* __restrict__ old_hash,
               const int* __restrict__ old_n,
               const i64* __restrict__ new_hash,
               const int* __restrict__ new_n,
               const i64* __restrict__ rorder, Rows r,
               signed char* __restrict__ ops,
               unsigned char* __restrict__ vis) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (i >= 2 * C) return;
  if (i < C) {
    for (int k = 0; k < r.n; ++k) {
      rw_copy_elem(r.out[k], i, r.old[k], i, r.width[k]);
      r.out_valid[k][i] = r.old_valid[k][i];
    }
    ops[i] = kDelete;
    bool still = false;
    if (i < *old_n) {
      const i64 h = old_hash[i];
      const long long j = first_candidate(new_hash, C, h);
      still = new_hash[j] == h && same_row(r, i, rorder[j]);
    }
    vis[i] = i < *old_n && !still;
  } else {
    const long long j = i - C;
    const long long s = rorder[j];
    for (int k = 0; k < r.n; ++k) {
      rw_copy_elem(r.out[k], i, r.col[k], s, r.width[k]);
      r.out_valid[k][i] = r.valid[k][s];
    }
    ops[i] = kInsert;
    bool was = false;
    if (j < *new_n) {
      const i64 h = new_hash[j];
      const long long a = first_candidate(old_hash, C, h);
      was = old_hash[a] == h && same_row(r, a, s);
    }
    vis[i] = j < *new_n && !was;
  }
}

Rows make_rows(int n_cols, void* const* cols, void* const* valids,
               void* const* old_cols, void* const* old_valids,
               void* const* out_cols, void* const* out_valids,
               const int* types, const int* widths) {
  Rows r = {};
  r.n = n_cols;
  for (int k = 0; k < n_cols; ++k) {
    r.col[k] = cols[k];
    r.valid[k] = static_cast<const unsigned char*>(valids[k]);
    if (old_cols) {
      r.old[k] = old_cols[k];
      r.old_valid[k] = static_cast<const unsigned char*>(old_valids[k]);
      r.out[k] = out_cols[k];
      r.out_valid[k] = static_cast<unsigned char*>(out_valids[k]);
    }
    r.type[k] = types[k];
    r.width[k] = widths[k];
  }
  return r;
}

}  // namespace

extern "C" int rw_window_hash(long long C, const long long* order,
                              const int* n_live, int n_cols,
                              void* const* cols, void* const* valids,
                              const int* types, const int* widths,
                              long long* rhash, void* stream) {
  if (n_cols < 1 || n_cols > kMaxCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Rows r = make_rows(n_cols, cols, valids, nullptr, nullptr, nullptr,
                           nullptr, types, widths);
  if (C > 0) {
    wd_hash_kernel<<<rw_blocks(C, kThreads), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        C, reinterpret_cast<const i64*>(order), n_live, r,
        reinterpret_cast<i64*>(rhash));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rw_window_diff(long long C, const long long* old_hash,
                              const int* old_n, const long long* new_hash,
                              const int* new_n, const long long* rorder,
                              int n_cols, void* const* cols,
                              void* const* valids, void* const* old_cols,
                              void* const* old_valids,
                              void* const* out_cols,
                              void* const* out_valids, const int* types,
                              const int* widths, signed char* ops,
                              unsigned char* vis, void* stream) {
  if (n_cols < 1 || n_cols > kMaxCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Rows r = make_rows(n_cols, cols, valids, old_cols, old_valids,
                           out_cols, out_valids, types, widths);
  if (C > 0) {
    wd_diff_kernel<<<rw_blocks(2 * C, kThreads), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        C, reinterpret_cast<const i64*>(old_hash), old_n,
        reinterpret_cast<const i64*>(new_hash), new_n,
        reinterpret_cast<const i64*>(rorder), r, ops, vis);
  }
  return static_cast<int>(cudaGetLastError());
}
