// K32 — the hash join's probe: every active chunk row looks its join
// key up in the OTHER side's key table, walks that key's chain of
// stored rows and emits one match per live row into a fixed [M] match
// buffer, gathering both sides' columns, valids and the op.
//
// Replaces risingwave_tpu/stream/hash_join.py:_apply_impl (290), lines
// 335-369 (the lookup and the lock-step chain walk into the match
// buffer) and 409-425 (the output gather), with ops/hash_table.py:
// lookup (175), which runs here through csrc/hash_probe.cuh, the device
// functions K3 probes with. On the TPU the walk is a while_loop over
// the longest chain, each iteration a cumsum compaction over all N rows.
//
// Contract (the plain version's, stream/hash_join.py:probe_plain): the
// multiset of visible (chunk row, stored row) matches and the match
// overflow max(total - M, 0), added to errs[2], are the reference's;
// a match's slot in [M] may differ (ROADMAP accepted difference 10).
// Invisible slots' columns are left unwritten.
//
// What bounds it on the H100: bytes, at the match count the data has.
// Each active row reads its key and two 16-slot buckets' occupancy and
// keys, then its chain: next and live of every stored row of the key
// (twice: count, then emit). Each match writes its slot pair and its
// gathered columns. Chains are walked one row a thread, so a hot key
// whose chain holds 10^5 rows costs that thread 10^5 dependent loads:
// the probe of such a key is latency-bound, not byte-bound.
//
// Design, four launches on the caller's stream, no host sync:
//   count  — one thread a row: lookup, walk the chain counting live
//            rows (int32 a row), keep the chain's head; the block's
//            int64 sum for the scan (scan.cuh);
//   scan   — exclusive int64 block offsets, the total in sums[nb];
//   emit   — the in-block scan again gives each row its int64 offset;
//            the row walks its chain once more and writes (row, stored
//            row) into slots below M;
//   gather — one thread a match slot: vis = slot < min(total, M); a
//            visible slot gathers the chunk row's and the stored row's
//            columns and valids and writes Insert or Delete by the
//            row's op; slot 0 adds the overflow to errs[2].

#include "hash_probe.cuh"
#include "scan.cuh"

namespace {

constexpr int kMaxCols = 16;

struct GatherCols {
  const void* in[kMaxCols];
  const unsigned char* in_valid[kMaxCols];   // null: all valid
  void* out[kMaxCols];
  unsigned char* out_valid[kMaxCols];
  int width[kMaxCols];
  int n;
};

__global__ void __launch_bounds__(kScanThreads)
hj_count(HtKeyCols kc, const unsigned char* __restrict__ occupied,
         int n_buckets, const int* __restrict__ head,
         const int* __restrict__ next, const unsigned char* __restrict__ live,
         const unsigned char* __restrict__ active, long long n,
         int* __restrict__ cnt, int* __restrict__ start,
         long long* __restrict__ sums, long long nb) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kScanThreads + threadIdx.x;
  long long c = 0;
  if (i < n) {
    int st = -1;
    if (active[i]) {
      const int slot = rw_ht_lookup(kc, occupied, n_buckets, i);
      if (slot >= 0) {
        st = head[slot];
        for (int cur = st; cur >= 0; cur = next[cur]) c += live[cur];
      }
    }
    cnt[i] = static_cast<int>(c);
    start[i] = st;
  }
  long long total;
  rw_block_scan<long long>(c, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
  if (blockIdx.x == 0 && threadIdx.x == 0) sums[nb] = 0;
}

__global__ void __launch_bounds__(kScanThreads)
hj_emit(const int* __restrict__ next, const unsigned char* __restrict__ live,
        long long n, const int* __restrict__ cnt,
        const int* __restrict__ start, const long long* __restrict__ sums,
        long long m, int* __restrict__ src, int* __restrict__ pos) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kScanThreads + threadIdx.x;
  const long long c = i < n ? cnt[i] : 0;
  const long long incl =
      rw_block_scan<long long>(c, static_cast<long long*>(nullptr));
  if (c == 0) return;
  long long off = sums[blockIdx.x] + incl - c;
  for (int cur = start[i]; cur >= 0 && off < m; cur = next[cur]) {
    if (live[cur]) {
      src[off] = static_cast<int>(i);
      pos[off] = cur;
      ++off;
    }
  }
}

__device__ __forceinline__ void gather(const GatherCols& g, long long to,
                                       long long from) {
  for (int c = 0; c < g.n; ++c) {
    rw_copy_elem(g.out[c], to, g.in[c], from, g.width[c]);
    g.out_valid[c][to] = g.in_valid[c] ? g.in_valid[c][from] : 1;
  }
}

__global__ void __launch_bounds__(kScanThreads)
hj_gather(GatherCols own, GatherCols oth,
          const signed char* __restrict__ ops,
          const long long* __restrict__ sums, long long nb, long long m,
          const int* __restrict__ src, const int* __restrict__ pos,
          signed char* __restrict__ out_ops,
          unsigned char* __restrict__ out_vis, int* errs) {
  const long long p =
      static_cast<long long>(blockIdx.x) * kScanThreads + threadIdx.x;
  if (p >= m) return;
  const long long total = sums[nb];
  if (p == 0 && total > m) {
    const long long over = total - m;
    atomicAdd(&errs[2], over > 0x7fffffffLL ? 0x7fffffff
                                            : static_cast<int>(over));
  }
  const bool vis = p < total;
  out_vis[p] = vis;
  if (!vis) return;
  const int i = src[p];
  gather(own, p, i);
  gather(oth, p, pos[p]);
  const signed char op = ops[i];
  out_ops[p] = (op == 0 || op == 3) ? 0 : 1;   // Insert-like -> Insert
}

bool fill(GatherCols* g, int n, void* const* in, void* const* in_valid,
          void* const* out, void* const* out_valid, const int* widths) {
  if (n < 1 || n > kMaxCols) return false;
  g->n = n;
  for (int c = 0; c < kMaxCols; ++c) {
    const bool on = c < n;
    g->in[c] = on ? in[c] : nullptr;
    g->in_valid[c] = on ? static_cast<const unsigned char*>(in_valid[c])
                        : nullptr;
    g->out[c] = on ? out[c] : nullptr;
    g->out_valid[c] = on ? static_cast<unsigned char*>(out_valid[c])
                         : nullptr;
    g->width[c] = on ? widths[c] : 8;
    if (on && (!out_valid[c] || (widths[c] != 1 && widths[c] != 2 &&
                                 widths[c] != 4 && widths[c] != 8))) {
      return false;
    }
  }
  return true;
}

}  // namespace

// sums holds ceil(n / 256) + 1 int64 entries; cnt and start n ints;
// src and pos m ints.
extern "C" int rw_hj_probe(
    int n_keys, void* const* key_cols, void* const* table_keys,
    const int* key_types, const unsigned char* occupied, int ck,
    const int* head, const int* next, const unsigned char* live,
    const unsigned char* active, const signed char* ops, long long n,
    int n_own, void* const* own_cols, void* const* own_valids,
    void* const* out_own, void* const* out_own_valid, const int* own_widths,
    int n_oth, void* const* oth_rows, void* const* oth_valids,
    void* const* out_oth, void* const* out_oth_valid, const int* oth_widths,
    long long m, signed char* out_ops, unsigned char* out_vis, int* cnt,
    int* start, long long* sums, int* src, int* pos, int* errs,
    void* stream) {
  if (n_keys < 1 || n_keys > kHtMaxKeys || ck % kHtSlots || n < 1 ||
      m < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  HtKeyCols kc;
  kc.n = n_keys;
  for (int c = 0; c < kHtMaxKeys; ++c) {
    kc.col[c] = c < n_keys ? key_cols[c] : nullptr;
    kc.tcol[c] = c < n_keys ? table_keys[c] : nullptr;
    kc.type[c] = c < n_keys ? key_types[c] : RW_I64;
    if (kc.type[c] != RW_I64 && kc.type[c] != RW_I32 &&
        kc.type[c] != RW_F64) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  GatherCols own, oth;
  if (!fill(&own, n_own, own_cols, own_valids, out_own, out_own_valid,
            own_widths) ||
      !fill(&oth, n_oth, oth_rows, oth_valids, out_oth, out_oth_valid,
            oth_widths)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nb = (n + kScanThreads - 1) / kScanThreads;
  hj_count<<<static_cast<unsigned>(nb), kScanThreads, 0, s>>>(
      kc, occupied, ck / kHtSlots, head, next, live, active, n, cnt, start,
      sums, nb);
  rw_scan_sums<long long><<<1, kSumsThreads, 0, s>>>(sums, nb + 1);
  hj_emit<<<static_cast<unsigned>(nb), kScanThreads, 0, s>>>(
      next, live, n, cnt, start, sums, m, src, pos);
  hj_gather<<<static_cast<unsigned>(rw_blocks(m, kScanThreads)),
              kScanThreads, 0, s>>>(own, oth, ops, sums, nb, m, src, pos,
                                    out_ops, out_vis, errs);
  return static_cast<int>(cudaGetLastError());
}
