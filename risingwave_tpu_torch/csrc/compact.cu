// K12 — stable compaction of a mask into the indices of its set bits.
//
// Replaces risingwave_tpu/ops/hash_table.py:47 compact_mask (a cumsum
// plus a dropping scatter, fused by XLA on the TPU), which the hash
// agg's barrier flush, eviction and rehash call over its whole table.
//
// Contract (the plain version's): sel[0..n) = the indices i with
// mask[i] set, ascending; sel[n..C) = 0; *n_out = n, left on the device.
//
// What bounds it on the H100: it reads C bool bytes and writes C int64
// indices: 9 bytes a slot, 9.4 MB for q5's C = 2^20, 2.8 us at
// 3.35 TB/s.
//
// Design: three launches, no host sync. compact_counts counts each
// block's set bits (one element per thread, scan.cuh's block scan) and
// zeroes one extra entry; rw_scan_sums turns the nb counts and that
// entry into exclusive block offsets, the last of which is n;
// compact_scatter recomputes the block scan and writes each set index at
// its offset + in-block rank, and the zero tail, so every output element
// is written exactly once.

#include "scan.cuh"

namespace {

// sums[b] <- block b's set bits; block 0 also zeroes sums[nb], the
// entry the scan turns into the total
__global__ void __launch_bounds__(kScanThreads)
compact_counts(const bool* __restrict__ mask, long long c,
               int* __restrict__ sums, int nb) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kScanThreads + threadIdx.x;
  int total;
  rw_block_scan<int>(i < c && mask[i] ? 1 : 0, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
  if (blockIdx.x == 0 && threadIdx.x == 0) sums[nb] = 0;
}

__global__ void __launch_bounds__(kScanThreads)
compact_scatter(const bool* __restrict__ mask, long long c,
                const int* __restrict__ sums, int nb,
                long long* __restrict__ sel, long long* __restrict__ n_out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kScanThreads + threadIdx.x;
  const bool set = i < c && mask[i];
  const int incl = rw_block_scan<int>(set ? 1 : 0, static_cast<int*>(nullptr));
  const long long n = sums[nb];
  if (set) sel[sums[blockIdx.x] + incl - 1] = i;
  if (i < c && i >= n) sel[i] = 0;
  if (i == 0) *n_out = n;
}

}  // namespace

// sums must hold nb + 1 ints, nb = ceil(c / 256) (rw_compact_blocks).
extern "C" int rw_compact_blocks(long long c) {
  return rw_blocks(c, kScanThreads);
}

extern "C" int rw_compact_mask(const bool* mask, long long c, long long* sel,
                               long long* n_out, int* sums, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int nb = rw_compact_blocks(c);
  if (nb == 0) {
    cudaMemsetAsync(n_out, 0, sizeof(long long), stream);
    return static_cast<int>(cudaGetLastError());
  }
  compact_counts<<<nb, kScanThreads, 0, stream>>>(mask, c, sums, nb);
  rw_scan_sums<int><<<1, kSumsThreads, 0, stream>>>(sums, nb + 1);
  compact_scatter<<<nb, kScanThreads, 0, stream>>>(mask, c, sums, nb, sel,
                                                   n_out);
  return static_cast<int>(cudaGetLastError());
}
