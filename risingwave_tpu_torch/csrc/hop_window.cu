// K2 — HOP window expansion.
//
// Replaces risingwave_tpu/stream/hop_window.py:HopWindowExecutor._step_impl
// (68): K-fold tiling of each row, window_start = (floor(ts/slide) - k) *
// slide, window_end = window_start + size, vis &= ts < window_end.
//
// What bounds it on the H100: bytes. For Nexmark q5 (K = 5, 131072 rows,
// output pruned to auction + window_start) it reads 18 B a row and
// writes 5 x 18 B: 14.2 MB, ~4.2 us at 3.35 TB/s. The arithmetic is one
// 64-bit floor division a row.
//
// Design: one thread per INPUT row, which reads the row once and writes
// its K copies at k * n + i, so every store of a warp is coalesced for
// each k. Only the columns the caller asked for are tiled (the output
// pruning of the reference), passed as a by-value array of pointers and
// element widths, so no host->device copy of the argument list.

#include "common.cuh"

namespace {

constexpr int kMaxTiled = 16;

struct TiledCols {
  const void* src[kMaxTiled];
  void* dst[kMaxTiled];
  int width[kMaxTiled];
  int count;
};

template <typename T>
__device__ __forceinline__ void tile_one(const void* src, void* dst, int i,
                                         int n, int K) {
  const T v = static_cast<const T*>(src)[i];
  T* out = static_cast<T*>(dst);
  for (int k = 0; k < K; ++k) out[static_cast<long long>(k) * n + i] = v;
}

__global__ void hop_expand_kernel(const i64* __restrict__ ts,
                                  const unsigned char* __restrict__ vis,
                                  const signed char* __restrict__ ops, int n,
                                  int K, i64 slide, i64 size, TiledCols cols,
                                  i64* __restrict__ ws_out,
                                  i64* __restrict__ we_out,
                                  unsigned char* __restrict__ vis_out,
                                  signed char* __restrict__ ops_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const i64 t = ts[i];
  const i64 base = rw_floordiv(t, slide);
  const unsigned char v = vis[i];
  const signed char op = ops[i];
  for (int k = 0; k < K; ++k) {
    const long long o = static_cast<long long>(k) * n + i;
    const i64 ws = (base - k) * slide;
    const i64 we = ws + size;
    if (ws_out) ws_out[o] = ws;
    if (we_out) we_out[o] = we;
    vis_out[o] = (v && t < we) ? 1 : 0;
    ops_out[o] = op;
  }
  for (int j = 0; j < cols.count; ++j) {
    switch (cols.width[j]) {
      case 8: tile_one<long long>(cols.src[j], cols.dst[j], i, n, K); break;
      case 4: tile_one<int>(cols.src[j], cols.dst[j], i, n, K); break;
      case 2: tile_one<short>(cols.src[j], cols.dst[j], i, n, K); break;
      default: tile_one<unsigned char>(cols.src[j], cols.dst[j], i, n, K);
    }
  }
}

}  // namespace

extern "C" int rw_hop_expand(const long long* ts, const unsigned char* vis,
                             const signed char* ops, int n, int K,
                             long long slide, long long size, int n_cols,
                             void* const* src, void* const* dst,
                             const int* widths, long long* ws_out,
                             long long* we_out, unsigned char* vis_out,
                             signed char* ops_out, void* stream) {
  if (n_cols > kMaxTiled || n_cols < 0) return static_cast<int>(cudaErrorInvalidValue);
  TiledCols cols;
  cols.count = n_cols;
  for (int j = 0; j < n_cols; ++j) {
    cols.src[j] = src[j];
    cols.dst[j] = dst[j];
    cols.width[j] = widths[j];
  }
  if (n > 0) {
    const int threads = 256;
    hop_expand_kernel<<<rw_blocks(n, threads), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        ts, vis, ops, n, K, slide, size, cols, ws_out, we_out, vis_out,
        ops_out);
  }
  return static_cast<int>(cudaGetLastError());
}
