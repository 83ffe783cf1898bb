// K14 — ordered append of a chunk's inserted rows to a dense store.
//
// Replaces risingwave_tpu/stream/snapshot_join_agg.py:_append_fact_impl
// (173) and _append_dim_impl (194): a cumsum rank plus a dropping
// scatter per column, fused by XLA on the TPU.
//
// Contract (the plain version's, append_rows_plain): the rows with
// vis & op>0 & every extra mask are written, in chunk order, to slots
// count, count+1, ... of every store column (converted between integer
// widths; store validity from the chunk's, or 1); rows past the store's
// capacity are dropped and counted in errs[overflow_slot]; visible
// retractions are counted in errs[2]; count becomes min(count + taken,
// capacity). All of it stays on the device.
//
// What bounds it on the H100: an 8192-row lineitem chunk reads vis, ops
// and four int64 columns and writes four columns and four validity
// bytes: 8192 x 74 B = 0.6 MB, 0.18 us at 3.35 TB/s. So launch latency
// and the serial dependence of the rank (a row's slot depends on every
// earlier row) bound it, not bytes.
//
// Design: one launch, one block of 1024 threads, which walks the chunk
// in tiles of 1024 rows: each thread flags its row, a block scan ranks
// the flags, each taken row writes every column at count + rank, and the
// tile's total carries to the next tile. No inter-block ordering, no
// scratch and no host sync; the count is read by every thread before
// the first scan's barrier and written by thread 0 after the last.
// Writes past capacity are never issued (the dropping scatter's mode).

#include "common.cuh"

namespace {

constexpr int kMaxCols = 16;
constexpr int kThreads = 1024;

struct Cols {
  const void* src[kMaxCols];
  int src_w[kMaxCols];
  const unsigned char* src_valid[kMaxCols];
  void* dst[kMaxCols];
  int dst_w[kMaxCols];
  unsigned char* dst_valid[kMaxCols];
};

__device__ __forceinline__ i64 load_int(const void* p, int w, long long i) {
  switch (w) {
    case 8: return static_cast<const i64*>(p)[i];
    case 4: return static_cast<const int*>(p)[i];
    case 2: return static_cast<const short*>(p)[i];
    default: return static_cast<const signed char*>(p)[i];
  }
}

__device__ __forceinline__ void store_int(void* p, int w, long long i,
                                          i64 v) {
  switch (w) {
    case 8: static_cast<i64*>(p)[i] = v; break;
    case 4: static_cast<int*>(p)[i] = static_cast<int>(v); break;
    case 2: static_cast<short*>(p)[i] = static_cast<short>(v); break;
    default: static_cast<signed char*>(p)[i] = static_cast<signed char>(v);
  }
}

// Inclusive scan of one int a thread over the block; *total gets the
// block's sum. Every thread must call it.
__device__ __forceinline__ int block_scan(int v, int* total) {
  __shared__ int warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(RW_FULL_MASK, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(RW_FULL_MASK, w, o);
      if (lane >= o) w += u;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += warp_sums[warp - 1];
  *total = warp_sums[kThreads / 32 - 1];
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(kThreads)
append_kernel(Cols c, int n_cols, const unsigned char* __restrict__ vis,
              const signed char* __restrict__ ops,
              const unsigned char* __restrict__ m1,
              const unsigned char* __restrict__ m2,
              const unsigned char* __restrict__ m3, long long n,
              long long cap, int* count, int* errs, int overflow_slot) {
  // the column tables in shared memory, copied with compile-time
  // indices (a by-value argument indexed at run time would be copied to
  // local memory by every thread)
  __shared__ const void* s_src[kMaxCols];
  __shared__ int s_src_w[kMaxCols];
  __shared__ const unsigned char* s_src_valid[kMaxCols];
  __shared__ void* s_dst[kMaxCols];
  __shared__ int s_dst_w[kMaxCols];
  __shared__ unsigned char* s_dst_valid[kMaxCols];
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) {
    if (threadIdx.x == k) {
      s_src[k] = c.src[k];
      s_src_w[k] = c.src_w[k];
      s_src_valid[k] = c.src_valid[k];
      s_dst[k] = c.dst[k];
      s_dst_w[k] = c.dst_w[k];
      s_dst_valid[k] = c.dst_valid[k];
    }
  }
  const long long fn = *count;
  long long taken = 0;
  int retract = 0;
  for (long long t0 = 0; t0 < n; t0 += kThreads) {
    const long long i = t0 + threadIdx.x;
    bool take = false;
    if (i < n && vis[i]) {
      const int op = ops[i];
      // op_sign: Insert (0) and UpdateInsert (3) are +1, the rest -1
      const bool ins = op == 0 || op == 3;
      retract += !ins;
      take = ins && (!m1 || m1[i]) && (!m2 || m2[i]) && (!m3 || m3[i]);
    }
    int tile_total;
    const int incl = block_scan(take ? 1 : 0, &tile_total);
    if (take) {
      const long long dest = fn + taken + incl - 1;
      if (dest < cap) {
        for (int k = 0; k < n_cols; ++k) {
          const int sw = s_src_w[k], dw = s_dst_w[k];
          if (sw == dw) {
            switch (dw) {
              case 8: static_cast<i64*>(s_dst[k])[dest] =
                  static_cast<const i64*>(s_src[k])[i]; break;
              case 4: static_cast<int*>(s_dst[k])[dest] =
                  static_cast<const int*>(s_src[k])[i]; break;
              case 2: static_cast<short*>(s_dst[k])[dest] =
                  static_cast<const short*>(s_src[k])[i]; break;
              default: static_cast<unsigned char*>(s_dst[k])[dest] =
                  static_cast<const unsigned char*>(s_src[k])[i];
            }
          } else {
            store_int(s_dst[k], dw, dest, load_int(s_src[k], sw, i));
          }
          if (s_dst_valid[k]) {
            s_dst_valid[k][dest] = s_src_valid[k] ? s_src_valid[k][i] : 1;
          }
        }
      }
    }
    taken += tile_total;
  }
  int retract_total;
  block_scan(retract, &retract_total);
  if (threadIdx.x == 0) {
    const long long total = fn + taken;
    const long long over = total > cap ? total - cap : 0;
    *count = static_cast<int>(total < cap ? total : cap);
    errs[overflow_slot] += static_cast<int>(over);
    errs[2] += retract_total;
  }
}

}  // namespace

extern "C" int rw_snapshot_append(
    int n_cols, void* const* src, const int* src_w, void* const* src_valid,
    void* const* dst, const int* dst_w, void* const* dst_valid,
    const unsigned char* vis, const signed char* ops,
    const unsigned char* m1, const unsigned char* m2,
    const unsigned char* m3, long long n, long long cap, int* count,
    int* errs, int overflow_slot, void* stream) {
  if (n_cols <= 0 || n_cols > kMaxCols || overflow_slot < 0
      || overflow_slot > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Cols c = {};
  for (int k = 0; k < n_cols; ++k) {
    c.src[k] = src[k];
    c.src_w[k] = src_w[k];
    c.src_valid[k] = static_cast<const unsigned char*>(src_valid[k]);
    c.dst[k] = dst[k];
    c.dst_w[k] = dst_w[k];
    c.dst_valid[k] = static_cast<unsigned char*>(dst_valid[k]);
  }
  append_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      c, n_cols, vis, ops, m1, m2, m3, n, cap, count, errs, overflow_slot);
  return static_cast<int>(cudaGetLastError());
}
