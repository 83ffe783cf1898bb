// K30 — HLL register update: one chunk into the 8 packed register words
// of one approx_count_distinct sketch per group.
//
// Replaces risingwave_tpu/expr/hll.py:lane_partial (121) + lane_combine
// (137), as AggSpec.partial / combine of 8 HLL_REG calls run them inside
// stream/hash_agg.py:_apply_impl (248) and stream/simple_agg.py:
// _apply_impl (117): per lane 8 segment maxima of the rows' ranks, packed
// into a word, then a bytewise max into the state.
//
// Per row: bits = the value's float64 bit pattern (floats) or its int64
// (integers, bools 0/1); h = splitmix64(bits); register = h & 63 (lane
// register >> 3, byte register & 7); rank = the 1-based index of the
// lowest set bit of h >> 6, 59 when those 58 bits are 0. A row counts
// when its slot is >= 0 (the hash agg: K3's slot, -1 for an invisible
// row) or its visibility bit is set (the simple agg: one group, word 0),
// its op is Insert or UpdateInsert, and its value is valid.
//
// What bounds it on the H100: bytes. It must read every row's slot, the
// op of each visible row, the valid byte of each visible insert and the
// value of each live row, and read and write each touched (group, lane)
// word once: at chip_smoke.py kernels_hll's 131072 rows of int64 values
// into one group (83% of them live) 1.64 MB, ~0.49 us at 3.35 TB/s.
//
// Design, for skew: Nexmark q15 groups by day, so a whole chunk lands on
// one group's 64 registers, and a per-row atomic would serialise
// thousands deep on a few words. Each block walks a tile of rows (256
// by default: 512 blocks for a 131072-row chunk; tiles of 4096 rows
// gave only 32 blocks to the 132 SMs and timed 2.2x slower into one
// group and 3.5x slower into 2^20 on an H100 at 700 W, by
// kernels_hll's tile sweep) and
// keeps one "hot" group's 64 registers in shared memory (the group of
// the tile's first live row: a day, or the single group of the simple
// agg); its rows take a shared atomicMax, and at the end the block
// merges each nonzero register into the device word with one atomic.
// Rows of other groups (the per-auction case, spread over 2^20 slots)
// go straight to the device word. A device update reads the word first
// and skips when the register already holds the rank (registers only
// grow, so a stale read can only be low); otherwise an atomicCAS on the
// 32-bit half that holds the register's byte replaces just that byte.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRegs = 64;
constexpr int kMaxRank = 59;

enum VType { V_I64 = 0, V_I32 = 1, V_I16 = 2, V_I8 = 3, V_BOOL = 4,
             V_F64 = 5, V_F32 = 6 };

struct Lanes {
  i64* w[8];      // [C] packed words per lane (nullptr: lane absent)
};

__device__ __forceinline__ u64 value_bits(const void* p, int vt,
                                          long long i) {
  switch (vt) {
    case V_I64: return static_cast<u64>(static_cast<const i64*>(p)[i]);
    case V_I32: return static_cast<u64>(static_cast<i64>(
                    static_cast<const int*>(p)[i]));
    case V_I16: return static_cast<u64>(static_cast<i64>(
                    static_cast<const short*>(p)[i]));
    case V_I8: return static_cast<u64>(static_cast<i64>(
                    static_cast<const signed char*>(p)[i]));
    case V_BOOL: return static_cast<const unsigned char*>(p)[i] != 0;
    case V_F64: return static_cast<u64>(__double_as_longlong(
                    static_cast<const double*>(p)[i]));
    default: return static_cast<u64>(__double_as_longlong(
                    static_cast<double>(static_cast<const float*>(p)[i])));
  }
}

// The row's slot (its group), or -1 when it does not count.
__device__ __forceinline__ int row_slot(long long i,
                                        const unsigned char* valid,
                                        const signed char* ops,
                                        const int* slots,
                                        const unsigned char* vis) {
  const int s = slots ? slots[i] : (vis[i] ? 0 : -1);
  if (s < 0) return -1;
  const int op = ops[i];
  if (op != 0 && op != 3) return -1;      // Insert / UpdateInsert only
  if (valid && !valid[i]) return -1;
  return s;
}

// Bytewise max of `rank` into register `reg` of group `slot`'s words.
__device__ __forceinline__ void word_max(const Lanes& lanes, int slot,
                                         int reg, unsigned rank) {
  i64* word = lanes.w[reg >> 3];
  if (word == nullptr) return;
  const int byte = reg & 7;
  unsigned* half = reinterpret_cast<unsigned*>(word + slot) + (byte >> 2);
  const int sh = (byte & 3) * 8;
  unsigned old = *reinterpret_cast<volatile unsigned*>(half);
  while (((old >> sh) & 255u) < rank) {
    const unsigned nw = (old & ~(255u << sh)) | (rank << sh);
    const unsigned prev = atomicCAS(half, old, nw);
    if (prev == old) break;
    old = prev;
  }
}

__global__ void __launch_bounds__(kThreads)
hll_update_kernel(long long N, const void* __restrict__ values, int vtype,
                  const unsigned char* __restrict__ valid,
                  const signed char* __restrict__ ops,
                  const int* __restrict__ slots,
                  const unsigned char* __restrict__ vis, Lanes lanes,
                  int rows_per_block) {
  __shared__ unsigned s_reg[kRegs];
  __shared__ int s_hot;
  const long long lo = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long hi = lo + rows_per_block < N ? lo + rows_per_block : N;
  if (threadIdx.x < kRegs) s_reg[threadIdx.x] = 0;
  if (threadIdx.x == 0) {
    // the hot group: that of the tile's first counting row (a short
    // scan; a tile of no counting rows has none)
    int hot = -1;
    for (long long i = lo; i < hi && i < lo + 64 && hot < 0; ++i) {
      hot = row_slot(i, valid, ops, slots, vis);
    }
    s_hot = hot;
  }
  __syncthreads();
  const int hot = s_hot;
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    const int s = row_slot(i, valid, ops, slots, vis);
    if (s < 0) continue;
    const u64 h = rw_splitmix64(value_bits(values, vtype, i));
    const int reg = static_cast<int>(h & 63);
    const u64 rest = h >> 6;
    const unsigned rank = rest == 0 ? kMaxRank : __ffsll(
        static_cast<long long>(rest));
    if (s == hot) {
      atomicMax(&s_reg[reg], rank);
    } else {
      word_max(lanes, s, reg, rank);
    }
  }
  __syncthreads();
  if (hot >= 0 && threadIdx.x < kRegs && s_reg[threadIdx.x] > 0) {
    word_max(lanes, hot, threadIdx.x, s_reg[threadIdx.x]);
  }
}

}  // namespace

// lanes: 8 pointers to [C] int64 words (nullptr for an absent lane);
// exactly one of slots (int32 [N]) and vis (bool [N]) is given; each
// block walks a tile of rows_per_block rows.
extern "C" int rw_hll_update(long long N, const void* values, int vtype,
                             const unsigned char* valid,
                             const signed char* ops, const int* slots,
                             const unsigned char* vis, void* const* lanes,
                             int rows_per_block, void* stream) {
  if (N < 0 || vtype < 0 || vtype > V_F32 || (slots == nullptr) ==
      (vis == nullptr) || rows_per_block < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Lanes l;
  for (int k = 0; k < 8; ++k) l.w[k] = static_cast<i64*>(lanes[k]);
  if (N > 0) {
    const int blocks = static_cast<int>((N + rows_per_block - 1)
                                        / rows_per_block);
    hll_update_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        N, values, vtype, valid, ops, slots, vis, l, rows_per_block);
  }
  return static_cast<int>(cudaGetLastError());
}
