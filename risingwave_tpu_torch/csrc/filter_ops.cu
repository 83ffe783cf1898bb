// K22 — the filter's changelog-op fix-up and visibility mask, one pass.
//
// Replaces risingwave_tpu/stream/project.py:FilterExecutor._step_impl
// (103) after its predicate (which is kernel K5): with cond = the
// predicate's data AND its validity (NULL filters out),
//   an UpdateInsert at i whose partner UpdateDelete at i-1 fails becomes
//   an Insert; an UpdateDelete at i whose partner UpdateInsert at i+1
//   fails becomes a Delete; vis &= cond.
// The partners are read with jnp.roll's wrap-around (row 0's "previous"
// is row n-1, row n-1's "next" is row 0), so both ends match the
// reference bit for bit. No compaction happens here, as in JAX.
//
// What bounds it on the H100: bytes. A row reads its predicate byte and
// validity byte (and its neighbours', which the cache serves), its op
// and its visibility, and writes an op and a visibility byte: 6 B a row,
// 0.8 MB at q2's 131072-row chunks, ~0.23 us at 3.35 TB/s; the launch
// itself costs more.
//
// Design: one thread a row, no shared memory; the neighbours' predicate
// bytes come through the L1 cache.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr signed char kInsert = 0;
constexpr signed char kDelete = 1;
constexpr signed char kUpdateDelete = 2;
constexpr signed char kUpdateInsert = 3;

__device__ __forceinline__ bool cond_at(const unsigned char* data,
                                        const unsigned char* valid,
                                        long long i) {
  return data[i] != 0 && (valid == nullptr || valid[i] != 0);
}

__global__ void __launch_bounds__(kThreads)
filter_fixup_kernel(const unsigned char* data, const unsigned char* valid,
                    const signed char* ops, const unsigned char* vis,
                    long long n, signed char* ops_out,
                    unsigned char* vis_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i >= n) return;
  const bool c = cond_at(data, valid, i);
  const signed char op = ops[i];
  signed char out = op;
  if (op == kUpdateInsert && c
      && !cond_at(data, valid, i == 0 ? n - 1 : i - 1)) {
    out = kInsert;
  } else if (op == kUpdateDelete && c
             && !cond_at(data, valid, i == n - 1 ? 0 : i + 1)) {
    out = kDelete;
  }
  ops_out[i] = out;
  vis_out[i] = (vis[i] != 0 && c) ? 1 : 0;
}

}  // namespace

extern "C" int rw_filter_fixup(const unsigned char* data,
                               const unsigned char* valid,
                               const signed char* ops,
                               const unsigned char* vis, long long n,
                               signed char* ops_out, unsigned char* vis_out,
                               void* stream) {
  if (n > 0) {
    filter_fixup_kernel<<<rw_blocks(n, kThreads), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        data, valid, ops, vis, n, ops_out, vis_out);
  }
  return static_cast<int>(cudaGetLastError());
}
