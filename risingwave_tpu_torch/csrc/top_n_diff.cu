// K21 — the retractable top-N's diff against the last emitted top set.
//
// Replaces risingwave_tpu/stream/retract_top_n.py:
// RetractableTopNExecutor._flush_impl (118), lines 154-183: the
// membership diff of the new top set's sorted full-row hashes against
// the last emitted set and the 2C-row Delete/Insert chunk, which K29
// (the dynamic filter's flush) shares: see set_diff.cuh for the kernel,
// its bound and its design. For q5_topn (C = 2^17 slots, two int64
// columns) the output is ~9.2 MB, ~2.7 us at 3.35 TB/s.

#include "set_diff.cuh"

extern "C" int rw_topn_diff(long long C, const long long* old_hash,
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
