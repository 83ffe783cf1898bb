// K8 — row ids: out[i] = base + i (int64).
//
// Replaces risingwave_tpu/stream/row_id.py:RowIdGenExecutor._step_impl
// (49): `base + arange(capacity)`, where base = instance << 55 | seq.
//
// What bounds it on the H100: bytes, 8 B written a row (1 MB for a
// 131072-row chunk, ~0.3 us at 3.35 TB/s); a launch costs more than the
// work. Its yardstick is torch.arange.
//
// Design: one thread per row, coalesced 8-byte stores. The base arrives
// by value, so the host keeps the sequence counter and needs no sync.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void row_id_kernel(i64 base, long long n, i64* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i < n) out[i] = base + i;
}

}  // namespace

extern "C" int rw_row_ids(long long base, long long n, long long* out,
                          void* stream) {
  if (n > 0) {
    row_id_kernel<<<rw_blocks(n, kThreads), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(base, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}
