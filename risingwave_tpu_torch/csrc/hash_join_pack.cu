// K34 — the hash join's row-store compactions, eviction mask and load
// counts, three entries.
//
// Replaces risingwave_tpu/stream/hash_join.py:_persist_view_impl (430),
// _evict_rows_impl (534), _evict_impl (545), _stats_impl (878) and the
// compaction of _rehash_impl (885). On the TPU each compaction is a
// cumsum plus a dropping scatter of the row ids, then a gather of every
// column.
//
// pack  — rows selected by a mode, in row order, gathered into the
//   prefix [0, n) of the outputs, and n:
//     0 dirty        the persist view: every column, and the op (Insert
//                    for a live row, Delete for a dead one);
//     1 evict rows   live rows whose clean column is below the
//                    watermark: every column;
//     2 keep         live or dirty rows (the rehash): every column, its
//                    valid, live and dirty; live and dirty are cleared
//                    past n, so the rehash's K3 sees no row there.
//   Other outputs past n are left unwritten.
// evict — live &= !(col < watermark), in place.
// stats — [occupied key slots, live rows, top] into int32[3].
//
// What bounds it on the H100: bytes. A pack reads the mask bytes of
// every row and moves each selected row once: at a 2^21-row store of 4
// int64 columns whose rows are all selected, ~69 MB in and out, ~21 us
// at 3.35 TB/s; a persist view moves only the dirty rows.
//
// Design: the compaction of K12 (csrc/compact.cu) with the gather
// fused: a count launch (one element a thread, scan.cuh's block scan),
// the block offsets, and a scatter launch that recomputes the block
// scan and writes each selected row at its offset + in-block rank.

#include "key_hash.cuh"
#include "scan.cuh"

namespace {

constexpr int kMaxCols = 16;

struct PackCols {
  const void* rows[kMaxCols];
  const unsigned char* valids[kMaxCols];
  void* out[kMaxCols];
  unsigned char* out_valid[kMaxCols];   // null: not written
  int width[kMaxCols];
  int n;
};

struct Watermark {
  const void* col;
  int type;
  long long wi;
  double wf;
};

__device__ __forceinline__ bool below(const Watermark& w, long long i) {
  switch (w.type) {
    case RW_F64: return static_cast<const double*>(w.col)[i] < w.wf;
    case RW_I32: return static_cast<const int*>(w.col)[i] < w.wi;
    default: return static_cast<const i64*>(w.col)[i] < w.wi;
  }
}

__device__ __forceinline__ bool selected(int mode, const Watermark& w,
                                         const unsigned char* live,
                                         const unsigned char* dirty,
                                         long long i) {
  switch (mode) {
    case 0: return dirty[i] != 0;
    case 1: return live[i] && below(w, i);
    default: return live[i] || dirty[i];
  }
}

__global__ void __launch_bounds__(kScanThreads)
pack_count(int mode, Watermark w, const unsigned char* __restrict__ live,
           const unsigned char* __restrict__ dirty, long long cr,
           int* __restrict__ sums, long long nb) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kScanThreads + threadIdx.x;
  int total;
  rw_block_scan<int>(i < cr && selected(mode, w, live, dirty, i) ? 1 : 0,
                     &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
  if (blockIdx.x == 0 && threadIdx.x == 0) sums[nb] = 0;
}

__global__ void __launch_bounds__(kScanThreads)
pack_scatter(int mode, Watermark w, PackCols pc,
             const unsigned char* __restrict__ live,
             const unsigned char* __restrict__ dirty, long long cr,
             const int* __restrict__ sums, long long nb,
             signed char* __restrict__ out_ops,
             unsigned char* __restrict__ out_live,
             unsigned char* __restrict__ out_dirty, int* n_out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kScanThreads + threadIdx.x;
  const bool sel = i < cr && selected(mode, w, live, dirty, i);
  const int incl = rw_block_scan<int>(sel ? 1 : 0, static_cast<int*>(nullptr));
  const long long n = sums[nb];
  if (i == 0) *n_out = static_cast<int>(n);
  if (i >= cr) return;
  if (i >= n) {
    if (out_live) out_live[i] = 0;
    if (out_dirty) out_dirty[i] = 0;
  }
  if (!sel) return;
  const long long o = sums[blockIdx.x] + incl - 1;
  for (int c = 0; c < pc.n; ++c) {
    rw_copy_elem(pc.out[c], o, pc.rows[c], i, pc.width[c]);
    if (pc.out_valid[c]) pc.out_valid[c][o] = pc.valids[c][i];
  }
  if (out_ops) out_ops[o] = live[i] ? 0 : 1;        // Insert : Delete
  if (out_live) out_live[o] = live[i];
  if (out_dirty) out_dirty[o] = dirty[i];
}

__global__ void __launch_bounds__(kScanThreads)
evict_apply(Watermark w, unsigned char* __restrict__ live, long long cr) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kScanThreads + threadIdx.x;
  if (i < cr && live[i] && below(w, i)) live[i] = 0;
}

__global__ void __launch_bounds__(kScanThreads)
stats_count(const unsigned char* __restrict__ occupied, long long ck,
            const unsigned char* __restrict__ live, long long cr,
            const int* __restrict__ top, int* out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kScanThreads + threadIdx.x;
  const int occ = i < ck && occupied[i] ? 1 : 0;
  const int lv = i < cr && live[i] ? 1 : 0;
  const int a = __syncthreads_count(occ);
  const int b = __syncthreads_count(lv);
  if (threadIdx.x == 0) {
    if (a) atomicAdd(&out[0], a);
    if (b) atomicAdd(&out[1], b);
  }
  if (i == 0) out[2] = *top;
}

Watermark make_wm(const void* col, int type, long long wi, double wf) {
  Watermark w;
  w.col = col;
  w.type = type;
  w.wi = wi;
  w.wf = wf;
  return w;
}

}  // namespace

// sums holds ceil(cr / 256) + 1 ints; valids, out_valids, out_ops,
// out_live and out_dirty may be null (not read / not written).
extern "C" int rw_hj_pack(int mode, long long cr, const unsigned char* live,
                          const unsigned char* dirty, const void* wm_col,
                          int wm_type, long long wm_i, double wm_f,
                          int ncols, void* const* rows,
                          void* const* valids, const int* widths,
                          void* const* out_rows, void* const* out_valids,
                          signed char* out_ops, unsigned char* out_live,
                          unsigned char* out_dirty, int* n_out, int* sums,
                          void* stream) {
  if (mode < 0 || mode > 2 || cr < 1 || ncols < 1 || ncols > kMaxCols ||
      (mode == 1 && !wm_col)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PackCols pc;
  pc.n = ncols;
  for (int c = 0; c < kMaxCols; ++c) {
    const bool on = c < ncols;
    pc.rows[c] = on ? rows[c] : nullptr;
    pc.valids[c] = on && valids
        ? static_cast<const unsigned char*>(valids[c]) : nullptr;
    pc.out[c] = on ? out_rows[c] : nullptr;
    pc.out_valid[c] = on && out_valids
        ? static_cast<unsigned char*>(out_valids[c]) : nullptr;
    pc.width[c] = on ? widths[c] : 8;
    if (pc.out_valid[c] && !pc.valids[c]) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const Watermark w = make_wm(wm_col, wm_type, wm_i, wm_f);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nb = (cr + kScanThreads - 1) / kScanThreads;
  pack_count<<<static_cast<unsigned>(nb), kScanThreads, 0, s>>>(
      mode, w, live, dirty, cr, sums, nb);
  rw_scan_sums<int><<<1, kSumsThreads, 0, s>>>(sums, nb + 1);
  pack_scatter<<<static_cast<unsigned>(nb), kScanThreads, 0, s>>>(
      mode, w, pc, live, dirty, cr, sums, nb, out_ops, out_live, out_dirty,
      n_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rw_hj_evict(long long cr, unsigned char* live,
                           const void* wm_col, int wm_type, long long wm_i,
                           double wm_f, void* stream) {
  if (cr < 1 || !wm_col) return static_cast<int>(cudaErrorInvalidValue);
  evict_apply<<<static_cast<unsigned>(rw_blocks(cr, kScanThreads)),
                kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      make_wm(wm_col, wm_type, wm_i, wm_f), live, cr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rw_hj_stats(long long ck, const unsigned char* occupied,
                           long long cr, const unsigned char* live,
                           const int* top, int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(out, 0, 2 * sizeof(int), s);
  const long long n = ck > cr ? ck : cr;
  stats_count<<<static_cast<unsigned>(rw_blocks(n, kScanThreads)),
                kScanThreads, 0, s>>>(occupied, ck, live, cr, top, out);
  return static_cast<int>(cudaGetLastError());
}
