// K29 — the dynamic filter's barrier flush: `x OP rhs` over the stored
// rows, their row hashes, and the diff against the last emitted set.
//
// Replaces risingwave_tpu/stream/dynamic.py:DynamicFilterExecutor.
// _flush_impl (127). The reference, for a store of capacity C with n
// live rows sorted by stream-key hash:
//   passing = (x OP rhs) & live & valid(x), x the filter column, OP one
//   of > >= < <=, rhs an int64 (a float x compares as float64 with the
//   rhs converted to float64, as XLA compares on the CPU: NaN fails,
//   +-0 and subnormals are zero);
//   rhash = passing ? key_hash(lanes) : sentinel, the lanes per column
//   (valid ? value bits : 0, valid);
//   a stable sort of rhash (kernel K11, between the two entries here);
//   the membership diff of the sorted hashes against the last emitted
//   set, hashes only (the reference's `member`), and the [2C] chunk:
//   the old set's rows as Deletes where they left it, the new set's
//   rows (the store gathered through the sort's order) as Inserts
//   where they joined it.
// Entries: rw_dynf_hash (predicate, row hashes, the passing count) and
// rw_dynf_diff (set_diff.cuh, shared with K21).
//
// What bounds it on the H100: bytes. The function needs the filter
// column and its valid byte of every live row, each passing row's
// columns and valids read once, its hash and its row of the new set
// written once, the old set's hashes (for `member`), each row that left
// the set read and written as a Delete, and an op and vis byte for each
// of the 2C output rows (chip_smoke.py's k29_timing counts this from
// the run's data: the dynf shape stores all ten auction columns). This
// kernel reads the filter column of every slot and hashes the passing
// rows only, as needed; the hash sort (K11) runs over all C slots and
// the diff copies all 2C rows (set_diff.cuh): those passes, not the
// data, set its time. The row hash is ~20 integer operations a lane,
// well under the card's integer rate.
//
// Design: one thread a slot; the passing count is a block sum plus one
// atomic a block into a count the entry zeroes first.

#include "set_diff.cuh"

namespace {

constexpr int kMaxCols = 16;

struct Row {
  const void* col[kMaxCols];
  const unsigned char* valid[kMaxCols];
  int type[kMaxCols];
  int n;
};

// The reference's `x OP rhs`: integers compare as int64; float64 with
// the rhs converted to float64, subnormals as zero (NaN fails every OP)
__device__ __forceinline__ bool passes(const Row& r, int key_col, int op,
                                       i64 rhs, long long p) {
  int cmp;   // -1, 0, 1, or 2 for unordered
  if (r.type[key_col] == RW_F64) {
    const double x = rw_daz(static_cast<const double*>(r.col[key_col])[p]);
    const double y = static_cast<double>(rhs);
    cmp = x != x ? 2 : (x < y ? -1 : (x > y ? 1 : 0));
  } else {
    const i64 x = static_cast<i64>(rw_lane_u64(r.col[key_col],
                                               r.type[key_col], p));
    cmp = x < rhs ? -1 : (x > rhs ? 1 : 0);
  }
  switch (op) {
    case 0: return cmp == 1;                 // greater_than
    case 1: return cmp == 1 || cmp == 0;     // greater_than_or_equal
    case 2: return cmp == -1;                // less_than
    default: return cmp == -1 || cmp == 0;   // less_than_or_equal
  }
}

__global__ void __launch_bounds__(kScanThreads)
dynf_hash(Row r, int key_col, int op, i64 rhs, const int* __restrict__ n,
          long long C, i64* __restrict__ rhash, int* __restrict__ n_new) {
  const long long p = static_cast<long long>(blockIdx.x) * kScanThreads
                      + threadIdx.x;
  bool pass = false;
  if (p < C) {
    pass = p < *n && r.valid[key_col][p] && passes(r, key_col, op, rhs, p);
    i64 h = kHashSentinel;
    if (pass) {
      u64 hh = kKeyHashSeed;
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        if (c < r.n) {
          const bool v = r.valid[c][p] != 0;
          // float64 lanes are the value's bits, integers sign-extended
          const u64 bits = r.type[c] == RW_F64
              ? static_cast<u64>(static_cast<const i64*>(r.col[c])[p])
              : rw_lane_u64(r.col[c], r.type[c], p);
          hh = rw_key_hash_step(hh, v ? bits : 0ULL);
          hh = rw_key_hash_step(hh, v ? 1ULL : 0ULL);
        }
      }
      h = rw_key_hash_finish(hh);
    }
    rhash[p] = h;
  }
  int total;
  rw_block_scan(pass ? 1 : 0, &total);
  if (threadIdx.x == 0 && total) atomicAdd(n_new, total);
}

}  // namespace

// op: 0 >, 1 >=, 2 <, 3 <=. types: expr/program.py's TYPE_CODES.
extern "C" int rw_dynf_hash(long long C, int n_cols, void* const* cols,
                            void* const* valids, const int* types,
                            int key_col, int op, long long rhs,
                            const int* n, long long* rhash, int* n_new,
                            void* stream) {
  if (n_cols < 1 || n_cols > kMaxCols || key_col < 0 || key_col >= n_cols
      || op < 0 || op > 3 || C < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Row r = {};
  r.n = n_cols;
  for (int c = 0; c < n_cols; ++c) {
    r.col[c] = cols[c];
    r.valid[c] = static_cast<const unsigned char*>(valids[c]);
    r.type[c] = types[c];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(n_new, 0, sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  dynf_hash<<<rw_blocks(C, kScanThreads), kScanThreads, 0, s>>>(
      r, key_col, op, rhs, n, C, reinterpret_cast<i64*>(rhash), n_new);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rw_dynf_diff(long long C, const long long* old_hash,
                            const int* old_n, const long long* new_hash,
                            const int* new_n, const long long* src,
                            int n_cols, void* const* store_cols,
                            void* const* store_valids,
                            void* const* old_cols, void* const* old_valids,
                            void* const* out_cols, void* const* out_valids,
                            const int* widths, signed char* ops,
                            unsigned char* vis, void* stream) {
  return rw_set_diff(C, old_hash, old_n, new_hash, new_n, src, n_cols,
                     store_cols, store_valids, old_cols, old_valids,
                     out_cols, out_valids, widths, ops, vis, stream);
}
