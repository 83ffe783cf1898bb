// K6 — sorted-join probe: key hash, range search, int64 offsets, match
// expansion, exact key recheck and the gather of both sides.
//
// Replaces risingwave_tpu/stream/sorted_join.py:key_hash (102) and
// SortedJoinExecutor._apply_impl (357) lines 409-447: h = key_hash(keys);
// lo/hi = searchsorted(other.khash, h); lens = active ? hi - lo : 0;
// offs = cumsum(lens) in int64; for each match slot j < M: the source row
// src = searchsorted(offs, j, "right"), the other side's row pos =
// lo[src] + (j - offs[src - 1]); emit = j < min(total, M) & pos < other.n
// & keys equal; the chunk row and the other side's row are gathered into
// the [M] match buffer; overflow max(total - M, 0) is added to errs[0].
//
// What bounds it on the H100: bytes and latency of dependent reads. It
// reads the chunk's keys, ops and columns once, writes h and the
// offsets, and writes the [M] buffer (for q7's left side, M = 262144
// rows of 7 columns, ~20 MB, ~6 us at 3.35 TB/s). Each row's binary
// search over the other side (2^19 sorted hashes, 19 dependent loads,
// mostly L2 hits) and each slot's search over the offsets add latency,
// not bytes.
//
// Design: four launches on the caller's stream, no host sync.
//   1. probe_rows: one thread per chunk row: hash, lower/upper bound
//      over the other side's whole capacity (it is padded with the
//      int64-max sentinel, so the ranges stay inside [0, n)), lens, and
//      ins_h = is_ins ? h : sentinel for the merge's sort (K7); each
//      block writes its partial sum of lens.
//   2./3. a hand-written int64 scan (scan.cuh): block offsets in one
//      block, then each block's inclusive scan. The offsets stay int64:
//      a hot key probed by a wide chunk can own more than 2^31 matches.
//   4. expand: one thread per match slot j (not per source row), so a hot
//      key whose row owns a long range spreads over many threads; it
//      finds its row by a binary search over the offsets, exactly as the
//      reference does, so every slot, visible or not, holds the same
//      values as the reference's buffer. An outer join also gets each
//      slot's chunk row and other-side row (slot_src, slot_pos, int32),
//      which K28 (csrc/outer_join.cu) reads after the join condition.

#include "key_hash.cuh"
#include "scan.cuh"

namespace {

constexpr int kMaxKeys = 4;
constexpr int kMaxCols = 8;

struct Keys {
  const void* chunk[kMaxKeys];
  const void* other[kMaxKeys];
  int width[kMaxKeys];
  int n;
};

struct Gather {
  const void* src[kMaxCols];
  const unsigned char* src_valid[kMaxCols];
  void* dst[kMaxCols];
  unsigned char* dst_valid[kMaxCols];
  int width[kMaxCols];
  int n;
};

__global__ void __launch_bounds__(kScanThreads)
probe_rows(Keys keys, const unsigned char* __restrict__ active,
           const unsigned char* __restrict__ is_ins, long long N,
           const i64* __restrict__ okh, long long Co, i64* __restrict__ h_out,
           i64* __restrict__ ins_h, i64* __restrict__ lo_out,
           i64* __restrict__ lens, i64* __restrict__ sums) {
  const long long i = static_cast<long long>(blockIdx.x) * kScanThreads
                      + threadIdx.x;
  i64 len = 0;
  if (i < N) {
    u64 hh = kKeyHashSeed;
#pragma unroll
    for (int k = 0; k < kMaxKeys; ++k) {
      if (k < keys.n) {
        const u64 c = static_cast<u64>(
            rw_load_any(keys.chunk[k], keys.width[k], i));
        hh = rw_key_hash_step(hh, c);
      }
    }
    const i64 h = rw_key_hash_finish(hh);
    h_out[i] = h;
    if (ins_h) ins_h[i] = is_ins[i] ? h : kHashSentinel;
    const long long lo = rw_lower_bound(okh, Co, h);
    const long long hi = lo + rw_upper_bound(okh + lo, Co - lo, h);
    lo_out[i] = lo;
    len = active[i] ? hi - lo : 0;
    lens[i] = len;
  }
  i64 total;
  rw_block_scan(len, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kScanThreads)
expand(Keys keys, const i64* __restrict__ offs, const i64* __restrict__ lo,
       long long N, const int* __restrict__ other_n, long long Co,
       const signed char* __restrict__ ops, Gather own, Gather oth,
       long long M, signed char* __restrict__ ops_out,
       unsigned char* __restrict__ emit, int* __restrict__ slot_src,
       int* __restrict__ slot_pos, int* __restrict__ errs) {
  const long long j = static_cast<long long>(blockIdx.x) * kScanThreads
                      + threadIdx.x;
  if (j >= M) return;
  const i64 total = offs[N - 1];
  const long long src = rw_upper_bound(offs, N, j);
  const long long srcc = src < N ? src : N - 1;
  const i64 prev = srcc > 0 ? offs[srcc - 1] : 0;
  i64 pos = lo[srcc] + (j - prev);
  pos = pos < 0 ? 0 : (pos > Co - 1 ? Co - 1 : pos);
  bool e = j < (total < M ? total : M) && pos < *other_n;
#pragma unroll
  for (int k = 0; k < kMaxKeys; ++k) {
    if (k < keys.n) {
      e = e && rw_load_any(keys.other[k], keys.width[k], pos)
               == rw_load_any(keys.chunk[k], keys.width[k], srcc);
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    if (c < own.n) {
      rw_copy_elem(own.dst[c], j, own.src[c], srcc, own.width[c]);
      if (own.dst_valid[c]) {
        own.dst_valid[c][j] = own.src_valid[c] ? own.src_valid[c][srcc] : 1;
      }
    }
    if (c < oth.n) {
      rw_copy_elem(oth.dst[c], j, oth.src[c], pos, oth.width[c]);
      if (oth.dst_valid[c]) {
        oth.dst_valid[c][j] = oth.src_valid[c] ? oth.src_valid[c][pos] : 1;
      }
    }
  }
  const signed char op = ops[srcc];
  ops_out[j] = (op == 0 || op == 3) ? 0 : 1;   // Insert : Delete
  emit[j] = e;
  if (slot_src) {
    slot_src[j] = static_cast<int>(srcc);
    slot_pos[j] = static_cast<int>(pos);
  }
  if (j == 0 && total > M) {
    // int32 accumulator, as the reference's errs (wraps the same way)
    errs[0] = static_cast<int>(static_cast<unsigned>(errs[0])
                               + static_cast<unsigned>(total - M));
  }
}

}  // namespace

extern "C" int rw_sj_probe(
    int n_keys, void* const* key_chunk, void* const* key_other,
    const int* key_width, const unsigned char* active,
    const unsigned char* is_ins, const signed char* ops, long long N,
    const long long* other_khash, const int* other_n, long long Co,
    int n_own, void* const* own_src, void* const* own_src_valid,
    void* const* own_dst, void* const* own_dst_valid, const int* own_width,
    int n_oth, void* const* oth_src, void* const* oth_src_valid,
    void* const* oth_dst, void* const* oth_dst_valid, const int* oth_width,
    long long M, long long* h, long long* ins_h, long long* lo,
    long long* offs, long long* sums, signed char* ops_out,
    unsigned char* emit, int* slot_src, int* slot_pos, int* errs,
    void* stream) {
  if (n_keys < 1 || n_keys > kMaxKeys || n_own < 0 || n_own > kMaxCols
      || n_oth < 0 || n_oth > kMaxCols || N < 1 || M < 1 || Co < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Keys keys = {};
  keys.n = n_keys;
  for (int k = 0; k < n_keys; ++k) {
    keys.chunk[k] = key_chunk[k];
    keys.other[k] = key_other[k];
    keys.width[k] = key_width[k];
  }
  Gather own = {}, oth = {};
  own.n = n_own;
  for (int c = 0; c < n_own; ++c) {
    own.src[c] = own_src[c];
    own.src_valid[c] = static_cast<const unsigned char*>(own_src_valid[c]);
    own.dst[c] = own_dst[c];
    own.dst_valid[c] = static_cast<unsigned char*>(own_dst_valid[c]);
    own.width[c] = own_width[c];
  }
  oth.n = n_oth;
  for (int c = 0; c < n_oth; ++c) {
    oth.src[c] = oth_src[c];
    oth.src_valid[c] = static_cast<const unsigned char*>(oth_src_valid[c]);
    oth.dst[c] = oth_dst[c];
    oth.dst_valid[c] = static_cast<unsigned char*>(oth_dst_valid[c]);
    oth.width[c] = oth_width[c];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nb = (N + kScanThreads - 1) / kScanThreads;
  probe_rows<<<static_cast<unsigned>(nb), kScanThreads, 0, s>>>(keys, active, is_ins, N,
                                          other_khash, Co, h, ins_h, lo,
                                          offs, sums);
  rw_scan_sums<long long><<<1, kSumsThreads, 0, s>>>(sums, nb);
  rw_scan_apply<long long><<<static_cast<unsigned>(nb), kScanThreads, 0, s>>>(offs, N, sums);
  expand<<<rw_blocks(M, kScanThreads), kScanThreads, 0, s>>>(
      keys, offs, lo, N, other_n, Co, ops, own, oth, M, ops_out, emit,
      slot_src, slot_pos, errs);
  return static_cast<int>(cudaGetLastError());
}
