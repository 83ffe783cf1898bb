// K11 — stable LSD radix sort of int64 keys, with a permutation.
//
// Replaces the stable argsorts of the JAX package's sorted join:
// risingwave_tpu/stream/sorted_join.py:571 (jnp.argsort(ins_h,
// stable=True) of the new rows' hashes, inside the jitted _apply_impl)
// and every pass of ops/hash_table.py:78 stable_lexsort (the pk-run
// netting at sorted_join.py:395). On the TPU both are XLA sorts.
//
// Contract: keys_out = the keys in ascending signed order, vals_out[j] =
// vals_in[p] (or p when vals_in is null) for the key keys_in[p] that
// lands at j; equal keys keep their input order. key_bits = 64 sorts any
// int64 (the sign bit is flipped so unsigned digit order is signed
// order); key_bits < 64 asserts 0 <= key < 2^key_bits and runs only the
// passes those bits need (a flag: one pass; the 63-bit join hash: 8).
//
// What bounds it on the H100: the function moves 24 bytes a row (key in,
// key and int64 permutation out), 7.1 MB for 294912 rows: 2.1 us at
// 3.35 TB/s. This design reads and writes every row once per 8-bit digit
// (8 passes for the join hash) and launches 2 + passes kernels, so the
// passes' traffic and launch latency, not the bound, set its time.
//
// Design (the one-sweep form of an LSD radix sort):
//   1. radix_upfront: one read of the keys counts every pass's digits
//      (shared atomics, then one global atomic per digit and block). A
//      pass's digit totals do not depend on the order the earlier passes
//      leave, so one histogram serves all passes.
//   2. radix_onesweep, one launch a pass. A block takes the next tile of
//      kTile rows from an atomic counter (so every earlier tile belongs
//      to a block that has already started) and keeps its keys and
//      values in registers. Each warp ranks its own run of rows, in row
//      order, among its rows of the same digit (__match_any_sync and a
//      per-warp count a digit in shared memory); the warps' counts give
//      the tile's count a digit and each warp's offset. For each digit
//      the block publishes the tile's count, then looks back over the
//      earlier tiles' published words, kLookBack at a time, summing
//      counts until it meets a tile that has published its inclusive
//      prefix (decoupled look-back), and publishes its own inclusive
//      prefix. A word packs a 2-bit flag with a 30-bit count, so one
//      store publishes both. The digit's start (exclusive scan of the
//      totals, scan.cuh's block scan) plus that prefix is where the
//      tile's first row of the digit goes. The rows are laid out in
//      digit order in shared memory and written out from there, so
//      neighbouring threads store side by side. Equal digits keep row
//      order inside a tile and tiles keep theirs: each pass is stable.
// Passes ping-pong between the output and a scratch pair so the last one
// lands in the output. One memset zeroes the histogram, the look-back
// words and the tile counters of every pass. No step syncs with the host.
// A look-back that spins past kSpinLimit (a fault: an earlier tile is
// always running) traps, so the launch fails instead of hanging.

#include "scan.cuh"

namespace {

constexpr int kSortThreads = 256;
constexpr int kSortItems = 8;                  // rows per thread
constexpr int kTile = kSortThreads * kSortItems;
constexpr int kWarpRows = 32 * kSortItems;     // a warp's rows of a tile
constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;
constexpr int kWarps = kSortThreads / 32;
constexpr int kMaxPasses = 8;
constexpr unsigned kNoDigit = kRadix;          // rows past n
constexpr unsigned kFlagAggregate = 1u << 30;  // count = this tile's
constexpr unsigned kFlagPrefix = 2u << 30;     // count = tiles <= this
constexpr unsigned kCountMask = (1u << 30) - 1;
constexpr long long kSpinLimit = 1LL << 24;
constexpr int kLookBack = 8;                   // predecessors read at once

static_assert(kRadix == kSortThreads, "one digit per thread");
static_assert(kSortThreads == kScanThreads, "scan blocks are sort blocks");

__device__ __forceinline__ unsigned digit_of(i64 key, int shift, u64 flip) {
  return static_cast<unsigned>(((static_cast<u64>(key) ^ flip) >> shift) &
                               (kRadix - 1));
}

__global__ void __launch_bounds__(kSortThreads)
radix_upfront(const i64* __restrict__ keys, long long n, int passes,
              u64 flip, unsigned* __restrict__ totals) {
  __shared__ unsigned hist[kMaxPasses][kRadix];
  for (int p = 0; p < kMaxPasses; ++p) hist[p][threadIdx.x] = 0;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * kSortThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kSortThreads +
                     threadIdx.x;
       i < n; i += stride) {
    const i64 key = keys[i];
    for (int p = 0; p < passes; ++p)
      atomicAdd(&hist[p][digit_of(key, p * kRadixBits, flip)], 1u);
  }
  __syncthreads();
  for (int p = 0; p < passes; ++p) {
    const unsigned c = hist[p][threadIdx.x];
    if (c) atomicAdd(&totals[p * kRadix + threadIdx.x], c);
  }
}

__global__ void __launch_bounds__(kSortThreads)
radix_onesweep(const i64* __restrict__ keys_in,
               const i64* __restrict__ vals_in, i64* __restrict__ keys_out,
               i64* __restrict__ vals_out, long long n, int shift, u64 flip,
               const unsigned* __restrict__ totals, unsigned* status,
               unsigned* tile_counter) {
  __shared__ i64 s_keys[kTile];        // the tile in digit order
  __shared__ i64 s_vals[kTile];
  __shared__ unsigned s_warp[kWarps][kRadix];  // per warp and digit
  __shared__ unsigned s_local[kRadix]; // tile-local start of each digit
  __shared__ unsigned s_base[kRadix];  // output position of s_local
  __shared__ unsigned s_tile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(tile_counter, 1u);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s_warp[w][tid] = 0;
  __syncthreads();
  const unsigned tile = s_tile;
  // warp w owns rows [w * kWarpRows, (w + 1) * kWarpRows) of the tile,
  // 32 consecutive rows a round
  const long long row0 = static_cast<long long>(tile) * kTile +
                         warp * kWarpRows + lane;

  i64 key[kSortItems];
  i64 val[kSortItems];
  unsigned dig[kSortItems];
  unsigned pos[kSortItems];            // rank among the warp's equal digits
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const long long i = row0 + r * 32;
    const bool ok = i < n;
    key[r] = ok ? keys_in[i] : 0;
    val[r] = ok ? (vals_in ? vals_in[i] : i) : 0;
    dig[r] = ok ? digit_of(key[r], shift, flip) : kNoDigit;
  }
  // rank each row among the warp's rows of its digit, in row order
  const unsigned lanes_before = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const unsigned d = dig[r];
    const unsigned peers = __match_any_sync(RW_FULL_MASK, d);
    const unsigned before = d != kNoDigit ? s_warp[warp][d] : 0u;
    pos[r] = before + __popc(peers & lanes_before);
    __syncwarp();
    if (d != kNoDigit && (__ffs(peers) - 1) == lane)
      s_warp[warp][d] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // thread `tid` owns digit tid: the tile's count and each warp's offset
  unsigned own = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned c = s_warp[w][tid];
    s_warp[w][tid] = own;
    own += c;
  }
  // the digit's first output position over all tiles (exclusive scan of
  // the pass's totals) and inside this tile (of the tile's counts)
  const unsigned total = totals[tid];
  const unsigned digit_start =
      rw_block_scan<unsigned>(total, nullptr) - total;
  const unsigned local = rw_block_scan<unsigned>(own, nullptr) - own;
  s_local[tid] = local;

  // decoupled look-back for digit tid
  volatile unsigned* st = status;
  unsigned excl = 0;
  if (tile == 0) {
    st[tid] = kFlagPrefix | own;
  } else {
    st[static_cast<long long>(tile) * kRadix + tid] = kFlagAggregate | own;
    // read kLookBack predecessors at once (their loads overlap), sum
    // nearest first up to an unpublished word or an inclusive prefix
    long long j = static_cast<long long>(tile) - 1;
    long long spins = 0;
    while (true) {
      unsigned w[kLookBack];
#pragma unroll
      for (int k = 0; k < kLookBack; ++k)
        w[k] = k <= j ? st[(j - k) * kRadix + tid]
                      : static_cast<unsigned>(kFlagPrefix);
      // consumed: the words summed before an unpublished one (w stays
      // in registers: every index is a compile-time constant)
      int consumed = kLookBack;
      bool prefix = false;
#pragma unroll
      for (int k = 0; k < kLookBack; ++k) {
        if (k < consumed && !prefix) {
          if ((w[k] & ~kCountMask) == 0) {
            consumed = k;
          } else {
            excl += w[k] & kCountMask;
            prefix = (w[k] & kFlagPrefix) != 0;
          }
        }
      }
      if (prefix) break;
      if (consumed < kLookBack && ++spins > kSpinLimit) __trap();
      j -= consumed;
    }
    st[static_cast<long long>(tile) * kRadix + tid] =
        kFlagPrefix | (excl + own);
  }
  s_base[tid] = digit_start + excl;
  __syncthreads();
  // each row to its slot of the tile laid out in digit order
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const unsigned d = dig[r];
    if (d != kNoDigit) {
      const unsigned slot = s_local[d] + s_warp[warp][d] + pos[r];
      s_keys[slot] = key[r];
      s_vals[slot] = val[r];
    }
  }
  __syncthreads();
  // write the tile out in digit order: neighbouring threads mostly hold
  // one digit, so their stores land side by side
  const long long left = n - static_cast<long long>(tile) * kTile;
  const int tile_n = left < kTile ? static_cast<int>(left) : kTile;
  for (int j = tid; j < tile_n; j += kSortThreads) {
    const i64 k = s_keys[j];
    const unsigned d = digit_of(k, shift, flip);
    const unsigned out = s_base[d] + (j - s_local[d]);
    keys_out[out] = k;
    vals_out[out] = s_vals[j];
  }
}

int tiles_of(long long n) {
  return static_cast<int>((n + kTile - 1) / kTile);
}

int passes_of(int key_bits) {
  return (key_bits + kRadixBits - 1) / kRadixBits;
}

}  // namespace

// Ints of the zeroed workspace one sort needs: the digit totals of every
// pass, then per pass its tiles' look-back words and its tile counter
// (below 2^31 for the n < 2^30 the 30-bit counts allow).
extern "C" int rw_radix_sort_workspace(long long n, int key_bits) {
  return kRadix * kMaxPasses +
         passes_of(key_bits) * (tiles_of(n) * kRadix + 1);
}

extern "C" int rw_radix_sort(const long long* keys_in,
                             const long long* vals_in, long long* keys_out,
                             long long* vals_out, long long* keys_tmp,
                             long long* vals_tmp, unsigned* workspace,
                             long long n, int key_bits, void* stream_) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int tiles = tiles_of(n);
  const u64 flip = key_bits >= 64 ? (1ULL << 63) : 0ULL;
  const int passes = passes_of(key_bits);
  cudaMemsetAsync(workspace, 0,
                  sizeof(unsigned) * rw_radix_sort_workspace(n, key_bits),
                  stream);
  unsigned* totals = workspace;
  unsigned* pass_ws = workspace + kRadix * kMaxPasses;
  const int up_blocks = tiles < 528 ? tiles : 528;   // 4 a SM at most
  radix_upfront<<<up_blocks, kSortThreads, 0, stream>>>(keys_in, n, passes,
                                                        flip, totals);
  const i64* src_k = keys_in;
  const i64* src_v = vals_in;
  for (int p = 0; p < passes; ++p) {
    const bool to_out = ((passes - 1 - p) % 2) == 0;
    i64* dst_k = to_out ? keys_out : keys_tmp;
    i64* dst_v = to_out ? vals_out : vals_tmp;
    unsigned* status = pass_ws + p * (tiles * kRadix + 1);
    unsigned* tile_counter = status + tiles * kRadix;
    radix_onesweep<<<tiles, kSortThreads, 0, stream>>>(
        src_k, src_v, dst_k, dst_v, n, p * kRadixBits, flip,
        totals + p * kRadix, status, tile_counter);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src_k = dst_k;
    src_v = dst_v;
  }
  return static_cast<int>(cudaGetLastError());
}
