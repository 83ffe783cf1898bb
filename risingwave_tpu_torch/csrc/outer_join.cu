// K28 — the sorted join's outer half: degrees, NULL-row transitions and
// the NULL-padded output segments.
//
// Replaces risingwave_tpu/stream/sorted_join.py:SortedJoinExecutor.
// _apply_impl (357) lines 443-533. Given the probe's match buffer (K6)
// after the join condition (K5): emit[j], the chunk row src[j] and the
// other side's row pos[j] of each match slot j < M, and the chunk's ops:
//   match_cnt[i] = #emitting slots of chunk row i;
//   other.degree[p] += sum of the signs of the emitting slots at p;
//   transitions (when the other side is outer): the other side's live
//   rows whose degree went 0 -> >0 (a Delete of their NULL-padded row)
//   or >0 -> 0 (an Insert of it) over the WHOLE chunk (net: 1 -> 0 -> 1
//   emits nothing), compacted in ascending position into rows [M, 2M) of
//   the output; n_trans - M past the buffer is added to errs[0];
//   own unmatched rows (when this side is outer): chunk row i is visible
//   in the [N] segment when it is active with no emitting match, or
//   visible with a NULL join key (it never matches), with its own op.
// The output is [M matches | M transitions | N own rows], the middle
// segment only when the other side is outer and the last only when this
// side is: the own side's columns are NULL in the transitions, the other
// side's columns NULL in the own rows.
//
// What bounds it on the H100: bytes. The function needs every slot's
// emit byte, src and pos (8 B) of the emitting slots only, the match
// counts, the degree of each touched other-side row read and written,
// the transition rows' other-side columns gathered and written, and the
// vis byte of the transition segment; with the own side outer, the
// chunk's rows copied once (chip_smoke.py's k28_timing counts this from
// the run's data). This kernel reads 1 B of every slot and 8 B of each
// emitting one as needed, but its transition pass also clears and reads
// a 4 B delta of every other-side slot, touched or not: an O(capacity)
// term the data does not need.
//
// Design: the delta of each other-side row is accumulated by atomics into
// a zeroed int32 array (exact: integer adds commute), so the degree
// before the chunk is degree - delta and no row needs a second read of
// its old degree. A row whose net delta is 0 cannot change between zero
// and nonzero, so the transition flags need delta and degree only. The
// flags are counted per block, the block offsets scanned (scan.cuh), and
// the write pass recomputes each flag, adds the delta into the degree
// and writes the compacted row. Launches, all on the caller's stream:
//   memset match_cnt (and delta, n_trans when the other side is outer);
//   slots: match_cnt atomics, and delta atomics (other side outer) or the
//     degree atomics directly;
//   trans_count, rw_scan_sums, trans_write, trans_vis (other side outer);
//   own_rows (this side outer).
// Rows of the transition segment past n_trans are invisible; their
// values are not written.

#include "key_hash.cuh"
#include "scan.cuh"

namespace {

constexpr int kMaxCols = 8;
constexpr signed char kInsert = 0;
constexpr signed char kDelete = 1;

struct Side {
  const void* src[kMaxCols];             // store or chunk columns
  const unsigned char* src_valid[kMaxCols];
  void* out[kMaxCols];                   // [T] output columns
  unsigned char* out_valid[kMaxCols];
  int width[kMaxCols];
  int n;
};

__device__ __forceinline__ int op_sign(signed char op) {
  return (op == 0 || op == 3) ? 1 : -1;
}

__device__ __forceinline__ void set_null(void* col, long long i,
                                         int width) {
  switch (width) {
    case 8: static_cast<i64*>(col)[i] = 0; break;
    case 4: static_cast<int*>(col)[i] = 0; break;
    case 2: static_cast<short*>(col)[i] = 0; break;
    default: static_cast<unsigned char*>(col)[i] = 0;
  }
}

__global__ void __launch_bounds__(kScanThreads)
slots(const unsigned char* __restrict__ emit, const int* __restrict__ src,
      const int* __restrict__ pos, const signed char* __restrict__ ops,
      long long M, int* __restrict__ match_cnt, int* __restrict__ delta,
      int* __restrict__ degree) {
  const long long j = static_cast<long long>(blockIdx.x) * kScanThreads
                      + threadIdx.x;
  if (j >= M || !emit[j]) return;
  const int s = src[j];
  atomicAdd(match_cnt + s, 1);
  atomicAdd((delta ? delta : degree) + pos[j], op_sign(ops[s]));
}

// 1 = Delete of the NULL row (0 -> >0), 2 = Insert (>0 -> 0), 0 = none
__device__ __forceinline__ int trans_flag(const int* delta,
                                          const int* degree, int n,
                                          long long p) {
  const int d = delta[p];
  if (d == 0 || p >= n) return 0;
  const int now = degree[p] + d;
  const int was = degree[p];
  if (was == 0 && now != 0) return 1;
  if (was != 0 && now == 0) return 2;
  return 0;
}

__global__ void __launch_bounds__(kScanThreads)
trans_count(const int* __restrict__ delta, const int* __restrict__ degree,
            const int* __restrict__ other_n, long long Co,
            int* __restrict__ sums, int* __restrict__ n_trans) {
  const long long p = static_cast<long long>(blockIdx.x) * kScanThreads
                      + threadIdx.x;
  const int f = p < Co ? trans_flag(delta, degree, *other_n, p) : 0;
  int total;
  rw_block_scan(f != 0 ? 1 : 0, &total);
  if (threadIdx.x == 0) {
    sums[blockIdx.x] = total;
    if (total) atomicAdd(n_trans, total);
  }
}

__global__ void __launch_bounds__(kScanThreads)
trans_write(const int* __restrict__ delta, int* __restrict__ degree,
            const int* __restrict__ other_n, long long Co,
            const int* __restrict__ sums, long long M, long long seg,
            Side own, Side oth, signed char* __restrict__ ops_out) {
  const long long p = static_cast<long long>(blockIdx.x) * kScanThreads
                      + threadIdx.x;
  const int f = p < Co ? trans_flag(delta, degree, *other_n, p) : 0;
  const int rank = rw_block_scan(f != 0 ? 1 : 0, static_cast<int*>(nullptr))
                   - (f != 0 ? 1 : 0) + sums[blockIdx.x];
  if (p >= Co) return;
  const int d = delta[p];
  if (d != 0) degree[p] += d;
  if (f == 0 || rank >= M) return;
  const long long r = seg + rank;
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    if (c < own.n) {
      set_null(own.out[c], r, own.width[c]);
      own.out_valid[c][r] = 0;
    }
    if (c < oth.n) {
      rw_copy_elem(oth.out[c], r, oth.src[c], p, oth.width[c]);
      oth.out_valid[c][r] = oth.src_valid[c] ? oth.src_valid[c][p] : 1;
    }
  }
  ops_out[r] = f == 1 ? kDelete : kInsert;
}

__global__ void trans_vis(const int* __restrict__ n_trans, long long M,
                          long long seg, unsigned char* __restrict__ vis,
                          int* __restrict__ errs) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  const int n = *n_trans;
  if (r == 0 && n > M) {
    // int32 accumulator, as the reference's errs (wraps the same way)
    errs[0] = static_cast<int>(static_cast<unsigned>(errs[0])
                               + static_cast<unsigned>(n - M));
  }
  if (r < M) vis[seg + r] = r < n ? 1 : 0;
}

__global__ void own_rows(const int* __restrict__ match_cnt,
                         const unsigned char* __restrict__ active,
                         const unsigned char* __restrict__ null_key,
                         const signed char* __restrict__ ops, long long N,
                         long long seg, Side own, Side oth,
                         signed char* __restrict__ ops_out,
                         unsigned char* __restrict__ vis) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i >= N) return;
  const long long r = seg + i;
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    if (c < own.n) {
      rw_copy_elem(own.out[c], r, own.src[c], i, own.width[c]);
      own.out_valid[c][r] = own.src_valid[c] ? own.src_valid[c][i] : 1;
    }
    if (c < oth.n) {
      set_null(oth.out[c], r, oth.width[c]);
      oth.out_valid[c][r] = 0;
    }
  }
  ops_out[r] = op_sign(ops[i]) > 0 ? kInsert : kDelete;
  vis[r] = ((active[i] && match_cnt[i] == 0) || null_key[i]) ? 1 : 0;
}

void fill_side(Side* s, int n, void* const* src, void* const* src_valid,
               void* const* out, void* const* out_valid,
               const int* width) {
  s->n = n;
  for (int c = 0; c < n; ++c) {
    s->src[c] = src[c];
    s->src_valid[c] = static_cast<const unsigned char*>(src_valid[c]);
    s->out[c] = out[c];
    s->out_valid[c] = static_cast<unsigned char*>(out_valid[c]);
    s->width[c] = width[c];
  }
}

}  // namespace

// outer_own / outer_other: whether this side / the other side keeps its
// unmatched rows. own_* are the chunk's columns and the output's own-side
// columns, oth_* the other side's store columns and the output's
// other-side columns. delta [Co], sums [ceil(Co / 256)] and n_trans [1]
// are scratch (used when outer_other).
extern "C" int rw_oj_apply(
    long long N, long long M, long long Co, int outer_own, int outer_other,
    const unsigned char* emit, const int* src, const int* pos,
    const signed char* ops, const unsigned char* active,
    const unsigned char* null_key, int* degree, const int* other_n,
    int n_own, void* const* own_src, void* const* own_src_valid,
    void* const* own_out, void* const* own_out_valid, const int* own_width,
    int n_oth, void* const* oth_src, void* const* oth_src_valid,
    void* const* oth_out, void* const* oth_out_valid, const int* oth_width,
    signed char* ops_out, unsigned char* vis, int* match_cnt, int* delta,
    int* sums, int* n_trans, int* errs, void* stream) {
  if (N < 1 || M < 1 || Co < 1 || n_own < 1 || n_own > kMaxCols
      || n_oth < 1 || n_oth > kMaxCols || (!outer_own && !outer_other)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Side own = {}, oth = {};
  fill_side(&own, n_own, own_src, own_src_valid, own_out, own_out_valid,
            own_width);
  fill_side(&oth, n_oth, oth_src, oth_src_valid, oth_out, oth_out_valid,
            oth_width);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(match_cnt, 0, N * sizeof(int), s);
  if (e == cudaSuccess && outer_other) {
    e = cudaMemsetAsync(delta, 0, Co * sizeof(int), s);
    if (e == cudaSuccess) e = cudaMemsetAsync(n_trans, 0, sizeof(int), s);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  slots<<<rw_blocks(M, kScanThreads), kScanThreads, 0, s>>>(
      emit, src, pos, ops, M, match_cnt, outer_other ? delta : nullptr,
      degree);
  if (outer_other) {
    const long long cb = (Co + kScanThreads - 1) / kScanThreads;
    trans_count<<<static_cast<unsigned>(cb), kScanThreads, 0, s>>>(
        delta, degree, other_n, Co, sums, n_trans);
    rw_scan_sums<int><<<1, kSumsThreads, 0, s>>>(sums, cb);
    trans_write<<<static_cast<unsigned>(cb), kScanThreads, 0, s>>>(
        delta, degree, other_n, Co, sums, M, M, own, oth, ops_out);
    trans_vis<<<rw_blocks(M, kScanThreads), kScanThreads, 0, s>>>(
        n_trans, M, M, vis, errs);
  }
  if (outer_own) {
    const long long seg = outer_other ? 2 * M : M;
    own_rows<<<rw_blocks(N, kScanThreads), kScanThreads, 0, s>>>(
        match_cnt, active, null_key, ops, N, seg, own, oth, ops_out, vis);
  }
  return static_cast<int>(cudaGetLastError());
}
