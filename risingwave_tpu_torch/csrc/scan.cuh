// Prefix sums shared by the sorted-join kernels (K6, K7).
//
// A scan over n elements is three steps on one stream: the producer
// kernel writes one partial sum per block of kScanThreads elements
// (rw_block_scan's total), rw_scan_sums turns the partials into
// exclusive block offsets in one block, and rw_scan_apply (or a consumer
// that recomputes its inputs) adds a block's offset to its in-block
// inclusive scan. Work and traffic are O(n); no step needs a host sync.

#pragma once

#include "common.cuh"

constexpr int kScanThreads = 256;   // threads (= elements) per scan block
constexpr int kSumsThreads = 1024;  // threads of the one-block offset pass

// Inclusive scan of one value per thread across a block of kScanThreads
// threads; every thread of the block must call it. *total (if given)
// receives the block's sum.
template <typename T>
__device__ __forceinline__ T rw_block_scan(T v, T* total) {
  __shared__ T warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T u = __shfl_up_sync(RW_FULL_MASK, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T w = lane < kScanThreads / 32 ? warp_sums[lane] : T(0);
#pragma unroll
    for (int o = 1; o < kScanThreads / 32; o <<= 1) {
      const T u = __shfl_up_sync(RW_FULL_MASK, w, o);
      if (lane >= o) w += u;
    }
    if (lane < kScanThreads / 32) warp_sums[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += warp_sums[warp - 1];
  if (total) *total = warp_sums[kScanThreads / 32 - 1];
  __syncthreads();
  return v;
}

// sums[0..nb) <- their exclusive prefix sums. One block of kSumsThreads
// threads; each thread owns a contiguous run of partials.
template <typename T>
__global__ void __launch_bounds__(kSumsThreads)
rw_scan_sums(T* sums, long long nb) {
  __shared__ T part[kSumsThreads];
  const int t = threadIdx.x;
  const long long per = (nb + kSumsThreads - 1) / kSumsThreads;
  const long long b0 = min(nb, t * per);
  const long long b1 = min(nb, b0 + per);
  T s = 0;
  for (long long b = b0; b < b1; ++b) s += sums[b];
  part[t] = s;
  __syncthreads();
  for (int o = 1; o < kSumsThreads; o <<= 1) {
    const T u = t >= o ? part[t - o] : T(0);
    __syncthreads();
    part[t] += u;
    __syncthreads();
  }
  T run = t > 0 ? part[t - 1] : T(0);
  for (long long b = b0; b < b1; ++b) {
    const T x = sums[b];
    sums[b] = run;
    run += x;
  }
}

// x[i] <- inclusive prefix sum of x, given the exclusive block offsets.
template <typename T>
__global__ void __launch_bounds__(kScanThreads)
rw_scan_apply(T* x, long long n, const T* sums) {
  const long long i = static_cast<long long>(blockIdx.x) * kScanThreads
                      + threadIdx.x;
  const T v = i < n ? x[i] : T(0);
  const T incl = rw_block_scan(v, static_cast<T*>(nullptr)) + sums[blockIdx.x];
  if (i < n) x[i] = incl;
}

// Number of entries of the ascending a[0..n) that are < v (left) or
// <= v (right): jnp.searchsorted's side="left" / side="right".
__device__ __forceinline__ long long rw_lower_bound(const i64* a,
                                                    long long n, i64 v) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ long long rw_upper_bound(const i64* a,
                                                    long long n, i64 v) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Copy element `from` of a column of `width` bytes to element `to` of
// another column of the same width.
__device__ __forceinline__ void rw_copy_elem(void* dst, long long to,
                                             const void* src,
                                             long long from, int width) {
  switch (width) {
    case 8: static_cast<i64*>(dst)[to] = static_cast<const i64*>(src)[from]; break;
    case 4: static_cast<int*>(dst)[to] = static_cast<const int*>(src)[from]; break;
    case 2: static_cast<short*>(dst)[to] = static_cast<const short*>(src)[from]; break;
    default:
      static_cast<unsigned char*>(dst)[to] =
          static_cast<const unsigned char*>(src)[from];
  }
}

// Element i of a column of width 1, 2, 4 or 8 bytes, widened to int64
// with sign extension (bools read as 0/1).
__device__ __forceinline__ i64 rw_load_any(const void* col, int width,
                                           long long i) {
  switch (width) {
    case 8: return static_cast<const i64*>(col)[i];
    case 4: return static_cast<const int*>(col)[i];
    case 2: return static_cast<const short*>(col)[i];
    default: return static_cast<const signed char*>(col)[i];
  }
}
