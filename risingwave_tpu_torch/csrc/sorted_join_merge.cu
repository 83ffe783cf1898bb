// K7 — sorted-join side update: retraction victims, inline watermark
// eviction and the merge-insert of the chunk's new rows.
//
// Replaces risingwave_tpu/stream/sorted_join.py:SortedJoinExecutor.
// _apply_impl (357) lines 535-612 and _evict_impl (615). The reference,
// for a side store of capacity C sorted by key hash with n live rows:
//   keep[t] = t < n & !(clean_col[t] < wm)           (inline eviction)
//   for each retraction (is_del), its own-side hash range is expanded
//   like the probe's, candidates must be kept rows with equal key and pk
//   columns, and the lowest candidate position is the victim
//   (keep[victim] = 0; a retraction without one counts in errs[1]);
//   the kept rows (rank kept_rank[t]) and the new rows (sorted by hash,
//   nh/iorder from a stable sort, rank r < n_new) merge by
//     pos_t = kept_rank[t] + #(nh < khash[t])
//     pos_r = r + #(kept rows with khash <= nh[r])
//   into a fresh store; rows past C are dropped and counted in errs[2].
// Eviction alone (_evict_impl) is the same program with no new rows.
//
// What bounds it on the H100: bytes. Every kept row moves (q7's left
// side: ~230 K rows of khash, 5 int64 columns, 5 valid bytes and the
// degree, ~57 B a row, read once and written once: ~26 MB, ~8 us at
// 3.35 TB/s); the binary searches add dependent L2 reads.
//
// Design: rows move, so the result goes to a second, preallocated store
// (the caller swaps it in), never in place. Launches, all on the caller's
// stream and none needing a host sync:
//   retractions only: zero `removed`; victims_rows (one thread per chunk
//   row: own-side lower/upper bound, dlens, victim = C); an int64 scan of
//   dlens (scan.cuh); victims_expand (one thread per slot j < M, as the
//   probe, atomicMin of its position into the row's victim: the lowest
//   candidate wins whatever the order); victims_apply (removed[victim] =
//   1, or errs[1] += 1).
//   keep_reduce: per-block counts of kept rows (int32); the offsets pass;
//   scatter_state: one thread per state row: kept rank by a block scan,
//   the merge position by a binary search over nh, a row copy;
//   scatter_new: one thread per new row: its position by a binary search
//   over the old khash and the kept-rank prefix, a row copy gathered
//   through iorder from the chunk, and its degree: 0, or in an outer
//   join its chunk row's count of matches (match_cnt[iorder[r]], from
//   K28; the reference's lines 604-607); finish: n, errs[2];
//   clear_tail: the second store's rows in [n, its previous n) get the
//   sentinel and zeros, so every slot equals the reference's store.

#include "key_hash.cuh"
#include "scan.cuh"

namespace {

// a store's columns: the sorted stores keep a whole input row (the
// dynamic filter over Nexmark's 10-column auctions). The kernels are
// instantiated for 8 and for 16 columns: the unrolled column loops of
// the 8-column form keep the joins' narrower rows as fast as before.
constexpr int kNarrowCols = 8;
constexpr int kWideCols = 16;
constexpr int kMaxMatch = 8;   // key + pk columns a retraction compares
constexpr int kTailBlocks = 264;

template <int kMaxCols>
struct Store {
  const i64* khash;
  const void* col[kMaxCols];
  const unsigned char* valid[kMaxCols];
  const int* degree;
  const int* n;
};

template <int kMaxCols>
struct OutStore {
  i64* khash;
  void* col[kMaxCols];
  unsigned char* valid[kMaxCols];
  int* degree;
  int* n;
};

template <int kMaxCols>
struct Layout {
  int width[kMaxCols];
  int n_cols;
  int clean_col;      // -1: no inline eviction
  i64 wm;
  int match[kMaxMatch];
  int n_match;
};

template <int kMaxCols>
struct Chunk {
  const void* col[kMaxCols];
  const unsigned char* valid[kMaxCols];
};

template <int kMaxCols>
__device__ __forceinline__ bool keep_init(const Store<kMaxCols>& st,
                                          const Layout<kMaxCols>& L,
                                          long long t) {
  if (t >= *st.n) return false;
  if (L.clean_col >= 0) {
    const int c = L.clean_col;
    if (rw_load_any(st.col[c], L.width[c], t) < L.wm) return false;
  }
  return true;
}

template <int kMaxCols>
__global__ void __launch_bounds__(kScanThreads)
victims_rows(Store<kMaxCols> st, long long C, const i64* __restrict__ h,
             const unsigned char* __restrict__ is_del, long long N,
             i64* __restrict__ dlo, i64* __restrict__ dlens,
             int* __restrict__ victim, i64* __restrict__ sums) {
  const long long i = static_cast<long long>(blockIdx.x) * kScanThreads
                      + threadIdx.x;
  i64 len = 0;
  if (i < N) {
    const long long lo = rw_lower_bound(st.khash, C, h[i]);
    const long long hi = lo + rw_upper_bound(st.khash + lo, C - lo, h[i]);
    dlo[i] = lo;
    len = is_del[i] ? hi - lo : 0;
    dlens[i] = len;
    victim[i] = static_cast<int>(C);
  }
  i64 total;
  rw_block_scan(len, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

template <int kMaxCols>
__global__ void __launch_bounds__(kScanThreads)
victims_expand(Store<kMaxCols> st, Layout<kMaxCols> L, Chunk<kMaxCols> ch,
               long long C,
               const i64* __restrict__ doffs, const i64* __restrict__ dlo,
               long long N, long long M, int* __restrict__ victim) {
  const long long j = static_cast<long long>(blockIdx.x) * kScanThreads
                      + threadIdx.x;
  if (j >= M) return;
  const i64 dtot = doffs[N - 1];
  if (j >= (dtot < M ? dtot : M)) return;
  const long long src = rw_upper_bound(doffs, N, j);
  const long long srcc = src < N ? src : N - 1;
  const i64 prev = srcc > 0 ? doffs[srcc - 1] : 0;
  i64 pos = dlo[srcc] + (j - prev);
  pos = pos < 0 ? 0 : (pos > C - 1 ? C - 1 : pos);
  if (!keep_init(st, L, pos)) return;
#pragma unroll
  for (int k = 0; k < kMaxMatch; ++k) {
    if (k < L.n_match) {
      const int c = L.match[k];
      if (rw_load_any(st.col[c], L.width[c], pos)
          != rw_load_any(ch.col[c], L.width[c], srcc)) {
        return;
      }
    }
  }
  atomicMin(victim + srcc, static_cast<int>(pos));
}

__global__ void victims_apply(const unsigned char* __restrict__ is_del,
                              const int* __restrict__ victim, long long N,
                              long long C, unsigned char* __restrict__ removed,
                              int* __restrict__ errs) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i >= N || !is_del[i]) return;
  const int v = victim[i];
  if (v < C) {
    removed[v] = 1;
  } else {
    atomicAdd(errs + 1, 1);
  }
}

template <int kMaxCols>
__device__ __forceinline__ bool kept(const Store<kMaxCols>& st,
                                     const Layout<kMaxCols>& L,
                                     const unsigned char* removed,
                                     long long t) {
  return keep_init(st, L, t) && !(removed && removed[t]);
}

template <int kMaxCols>
__global__ void __launch_bounds__(kScanThreads)
keep_reduce(Store<kMaxCols> st, Layout<kMaxCols> L,
            const unsigned char* __restrict__ removed, long long C, const int* __restrict__ spare_n,
            int* __restrict__ hw, int* __restrict__ sums) {
  const long long t = static_cast<long long>(blockIdx.x) * kScanThreads
                      + threadIdx.x;
  const int k = t < C && kept(st, L, removed, t) ? 1 : 0;
  int total;
  rw_block_scan(k, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
  // the second store's previous n, read before `finish` overwrites it
  if (t == 0) *hw = *spare_n;
}

template <int kMaxCols>
__device__ __forceinline__ void copy_row(const OutStore<kMaxCols>& out,
                                         long long to,
                                         const void* const* col,
                                         const unsigned char* const* valid,
                                         const Layout<kMaxCols>& L,
                                         long long from) {
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    if (c < L.n_cols) {
      rw_copy_elem(out.col[c], to, col[c], from, L.width[c]);
      out.valid[c][to] = valid[c] ? valid[c][from] : 1;
    }
  }
}

template <int kMaxCols>
__global__ void __launch_bounds__(kScanThreads)
scatter_state(Store<kMaxCols> st, OutStore<kMaxCols> out,
              Layout<kMaxCols> L,
              const unsigned char* __restrict__ removed, long long C,
              const i64* __restrict__ nh, long long N,
              const int* __restrict__ sums, int* __restrict__ kept_incl) {
  const long long t = static_cast<long long>(blockIdx.x) * kScanThreads
                      + threadIdx.x;
  const bool k = t < C && kept(st, L, removed, t);
  const int incl = rw_block_scan(k ? 1 : 0, static_cast<int*>(nullptr))
                   + sums[blockIdx.x];
  if (t >= C) return;
  kept_incl[t] = incl;
  if (!k) return;
  const i64 kh = st.khash[t];
  const long long pos = (incl - 1) + (N > 0 ? rw_lower_bound(nh, N, kh) : 0);
  if (pos >= C) return;
  out.khash[pos] = kh;
  copy_row(out, pos, st.col, st.valid, L, t);
  out.degree[pos] = st.degree[t];
}

template <int kMaxCols>
__global__ void __launch_bounds__(kScanThreads)
scatter_new(Store<kMaxCols> st, OutStore<kMaxCols> out, Layout<kMaxCols> L,
            Chunk<kMaxCols> ch, long long C,
            const i64* __restrict__ nh, const i64* __restrict__ iorder,
            const int* __restrict__ n_new, long long N,
            const int* __restrict__ kept_incl,
            const int* __restrict__ match_cnt) {
  const long long r = static_cast<long long>(blockIdx.x) * kScanThreads
                      + threadIdx.x;
  if (r >= N || r >= *n_new) return;
  const i64 v = nh[r];
  const long long idx = rw_upper_bound(st.khash, C, v);
  const long long pos = r + (idx > 0 ? kept_incl[idx - 1] : 0);
  if (pos >= C) return;
  out.khash[pos] = v;
  const i64 src = iorder[r];
  copy_row(out, pos, ch.col, ch.valid, L, src);
  out.degree[pos] = match_cnt ? match_cnt[src] : 0;
}

__global__ void finish(const int* __restrict__ kept_incl, long long C,
                       const int* __restrict__ n_new, int* __restrict__ n_out,
                       int* __restrict__ errs) {
  const long long after = static_cast<long long>(kept_incl[C - 1])
                          + (n_new ? *n_new : 0);
  if (after > C) {
    errs[2] = static_cast<int>(static_cast<unsigned>(errs[2])
                               + static_cast<unsigned>(after - C));
  }
  *n_out = static_cast<int>(after < C ? after : C);
}

template <int kMaxCols>
__global__ void clear_tail(OutStore<kMaxCols> out, Layout<kMaxCols> L,
                           const int* __restrict__ hw) {
  const long long lo = *out.n;
  const long long hi = *hw;
  for (long long p = lo + static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
       p < hi; p += static_cast<long long>(gridDim.x) * blockDim.x) {
    out.khash[p] = kHashSentinel;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      if (c < L.n_cols) {
        switch (L.width[c]) {
          case 8: static_cast<i64*>(out.col[c])[p] = 0; break;
          case 4: static_cast<int*>(out.col[c])[p] = 0; break;
          case 2: static_cast<short*>(out.col[c])[p] = 0; break;
          default: static_cast<unsigned char*>(out.col[c])[p] = 0;
        }
        out.valid[c][p] = 0;
      }
    }
    out.degree[p] = 0;
  }
}

template <int kMaxCols>
int merge_launch(
    const long long* khash, int n_cols, void* const* cols,
    void* const* valids, const int* widths, const int* degree,
    const int* own_n, long long C, long long* khash2, void* const* cols2,
    void* const* valids2, int* degree2, int* n2, int clean_col,
    long long wm, long long N, const long long* nh, const long long* iorder,
    const int* n_new, void* const* chunk_cols, void* const* chunk_valids,
    const unsigned char* is_del, const long long* h, long long M,
    int n_match, const int* match, long long* dlo, long long* doffs,
    long long* sums64, int* victim, unsigned char* removed, int* kept_incl,
    int* sums32, int* hw, const int* match_cnt, int* errs, void* stream) {
  Store<kMaxCols> st = {};
  OutStore<kMaxCols> out = {};
  Layout<kMaxCols> L = {};
  Chunk<kMaxCols> ch = {};
  st.khash = khash;
  st.degree = degree;
  st.n = own_n;
  out.khash = khash2;
  out.degree = degree2;
  out.n = n2;
  L.n_cols = n_cols;
  L.clean_col = clean_col;
  L.wm = wm;
  L.n_match = n_match;
  for (int c = 0; c < n_cols; ++c) {
    st.col[c] = cols[c];
    st.valid[c] = static_cast<const unsigned char*>(valids[c]);
    out.col[c] = cols2[c];
    out.valid[c] = static_cast<unsigned char*>(valids2[c]);
    L.width[c] = widths[c];
    if (N > 0) {
      ch.col[c] = chunk_cols[c];
      ch.valid[c] = static_cast<const unsigned char*>(chunk_valids[c]);
    }
  }
  for (int k = 0; k < n_match; ++k) L.match[k] = match[k];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* rm = nullptr;
  if (is_del != nullptr && N > 0) {
    cudaError_t e = cudaMemsetAsync(removed, 0, C, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long nb = (N + kScanThreads - 1) / kScanThreads;
    victims_rows<kMaxCols>
        <<<static_cast<unsigned>(nb), kScanThreads, 0, s>>>(
        st, C, h, is_del, N, dlo, doffs, victim, sums64);
    rw_scan_sums<long long><<<1, kSumsThreads, 0, s>>>(sums64, nb);
    rw_scan_apply<long long><<<static_cast<unsigned>(nb), kScanThreads, 0,
                               s>>>(doffs, N, sums64);
    victims_expand<kMaxCols>
        <<<rw_blocks(M, kScanThreads), kScanThreads, 0, s>>>(
        st, L, ch, C, doffs, dlo, N, M, victim);
    victims_apply<<<rw_blocks(N, kScanThreads), kScanThreads, 0, s>>>(
        is_del, victim, N, C, removed, errs);
    rm = removed;
  }
  const long long cb = (C + kScanThreads - 1) / kScanThreads;
  keep_reduce<kMaxCols>
      <<<static_cast<unsigned>(cb), kScanThreads, 0, s>>>(
      st, L, rm, C, n2, hw, sums32);
  rw_scan_sums<int><<<1, kSumsThreads, 0, s>>>(sums32, cb);
  scatter_state<kMaxCols>
      <<<static_cast<unsigned>(cb), kScanThreads, 0, s>>>(
      st, out, L, rm, C, nh, N, sums32, kept_incl);
  if (N > 0) {
    scatter_new<kMaxCols>
        <<<rw_blocks(N, kScanThreads), kScanThreads, 0, s>>>(
        st, out, L, ch, C, nh, iorder, n_new, N, kept_incl, match_cnt);
  }
  finish<<<1, 1, 0, s>>>(kept_incl, C, N > 0 ? n_new : nullptr, n2, errs);
  clear_tail<kMaxCols><<<kTailBlocks, kScanThreads, 0, s>>>(out, L, hw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rw_sj_merge(
    const long long* khash, int n_cols, void* const* cols,
    void* const* valids, const int* widths, const int* degree,
    const int* own_n, long long C, long long* khash2, void* const* cols2,
    void* const* valids2, int* degree2, int* n2, int clean_col,
    long long wm, long long N, const long long* nh, const long long* iorder,
    const int* n_new, void* const* chunk_cols, void* const* chunk_valids,
    const unsigned char* is_del, const long long* h, long long M,
    int n_match, const int* match, long long* dlo, long long* doffs,
    long long* sums64, int* victim, unsigned char* removed, int* kept_incl,
    int* sums32, int* hw, const int* match_cnt, int* errs, void* stream) {
  if (n_cols < 1 || n_cols > kWideCols || n_match < 0 || n_match > kMaxMatch
      || C < 1 || N < 0 || clean_col >= n_cols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto launch = n_cols <= kNarrowCols ? merge_launch<kNarrowCols>
                                      : merge_launch<kWideCols>;
  return launch(
      khash, n_cols, cols, valids, widths, degree, own_n, C, khash2,
      cols2, valids2, degree2, n2, clean_col, wm, N, nh, iorder, n_new,
      chunk_cols, chunk_valids, is_del, h, M, n_match, match, dlo, doffs,
      sums64, victim, removed, kept_incl, sums32, hw, match_cnt, errs,
      stream);
}
