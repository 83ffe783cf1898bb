// K17 — the sorted join's snapshot diff at a checkpoint, for one side.
//
// Replaces risingwave_tpu/stream/sorted_join.py:655 _diff_impl, with
// _row_lanes (643) and key_hash (102). Given the side's store now (cur)
// and as of the last checkpoint (snap), both dense prefixes of C slots:
//   row hash  rh[i] = key_hash(lanes of row i) for i < n, else int64 max;
//             lanes = khash ++ data (invalid -> 0, floats by their bits)
//             ++ valid bits;
//   sort      each side's rh, stably, returning the order (kernel K11,
//             called between the launches of this file by the wrapper);
//   match     a live row of one side is unmatched when the FIRST entry
//             of the other side's sorted hashes at its lower bound
//             (clipped to C - 1) has another hash or other lanes;
//   compact   unmatched snap rows (deletes) then unmatched cur rows
//             (inserts), each in slot order, gathered straight into one
//             packed int64 buffer, row major: row r, column c at
//             out[r * K + c] (raw column data, floats by their bits);
//             counts[0] = deletes, counts[1] = inserts, on the device.
//
// What bounds it on the H100: bytes. The least it must move is each
// side's live rows (slots < n) read once and the changed rows written
// once; it reads the live lanes twice (hash, then the compare of every
// live row against its candidate). At q7d the bid side holds the rows
// of about the last 30 s of event time, a fraction of its 2^18 slots.
// The binary search of each row over the other side's sorted hashes
// adds ~18 dependent, mostly L2-resident loads of latency, not bytes.
//
// Design: four launches of this file around two K11 sorts, no host
// sync. diff_rowhash: one thread per slot. diff_mark: one thread per
// slot of both sides (blocks [0, nb_s) cover snap, [nb_s, nb_s + nb_c)
// cover cur, so deletes rank before inserts), the lower bound, the
// exact lane compare against that one candidate, the mask byte and the
// block's count (scan.cuh's block scan). rw_scan_sums turns the counts
// into exclusive block offsets whose entry nb_s is the delete count and
// whose last entry is the total. diff_scatter recomputes the in-block
// rank and writes each unmatched row's K lanes at its offset.

#include "key_hash.cuh"
#include "scan.cuh"

namespace {

constexpr int kMaxCols = 8;

struct Side {
  const i64* khash;
  const void* col[kMaxCols];
  const unsigned char* valid[kMaxCols];
  int width[kMaxCols];
  int k;                 // columns
  const int* n;          // live rows, on the device
  long long cap;         // slots
};

__device__ __forceinline__ i64 lane(const Side& s, int c, long long i) {
  return s.valid[c][i] ? rw_load_any(s.col[c], s.width[c], i) : 0;
}

__global__ void __launch_bounds__(kScanThreads)
diff_rowhash(Side s, i64* __restrict__ rh) {
  const long long i = static_cast<long long>(blockIdx.x) * kScanThreads
                      + threadIdx.x;
  if (i >= s.cap) return;
  if (i >= *s.n) {
    rh[i] = kHashSentinel;
    return;
  }
  u64 h = rw_key_hash_step(kKeyHashSeed, static_cast<u64>(s.khash[i]));
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    if (c < s.k) h = rw_key_hash_step(h, static_cast<u64>(lane(s, c, i)));
  }
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    if (c < s.k) h = rw_key_hash_step(h, s.valid[c][i] ? 1ULL : 0ULL);
  }
  rh[i] = rw_key_hash_finish(h);
}

// Row i of `a` is unmatched in `b`: live, and the first candidate of
// equal hash in b's sorted hashes is absent or differs in a lane.
__device__ __forceinline__ bool unmatched(const Side& a, const i64* rh_a,
                                          long long i, const Side& b,
                                          const i64* sorted_b,
                                          const i64* order_b) {
  if (i >= *a.n) return false;
  const i64 h = rh_a[i];
  long long pos = rw_lower_bound(sorted_b, b.cap, h);
  if (pos > b.cap - 1) pos = b.cap - 1;
  if (sorted_b[pos] != h) return true;
  const long long j = order_b[pos];
  if (a.khash[i] != b.khash[j]) return true;
  for (int c = 0; c < a.k; ++c) {
    if (lane(a, c, i) != lane(b, c, j)) return true;
    if ((a.valid[c][i] != 0) != (b.valid[c][j] != 0)) return true;
  }
  return false;
}

struct Pair {
  Side snap, cur;
  const i64* rh_s;
  const i64* rh_c;
  const i64* sorted_s;
  const i64* order_s;
  const i64* sorted_c;
  const i64* order_c;
  int nb_s, nb_c;
};

__global__ void __launch_bounds__(kScanThreads)
diff_mark(Pair p, unsigned char* __restrict__ mask, int* __restrict__ sums) {
  const bool is_snap = static_cast<int>(blockIdx.x) < p.nb_s;
  const long long base = is_snap ? 0 : static_cast<long long>(p.nb_s)
                                           * kScanThreads;
  const long long i = static_cast<long long>(blockIdx.x) * kScanThreads
                      + threadIdx.x - base;
  bool m = false;
  if (is_snap) {
    if (i < p.snap.cap) {
      m = unmatched(p.snap, p.rh_s, i, p.cur, p.sorted_c, p.order_c);
      mask[i] = m;
    }
  } else if (i < p.cur.cap) {
    m = unmatched(p.cur, p.rh_c, i, p.snap, p.sorted_s, p.order_s);
    mask[p.snap.cap + i] = m;
  }
  int total;
  rw_block_scan<int>(m ? 1 : 0, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
  if (blockIdx.x == 0 && threadIdx.x == 0) sums[p.nb_s + p.nb_c] = 0;
}

__global__ void __launch_bounds__(kScanThreads)
diff_scatter(Pair p, const unsigned char* __restrict__ mask,
             const int* __restrict__ sums, i64* __restrict__ out,
             i64* __restrict__ counts) {
  const bool is_snap = static_cast<int>(blockIdx.x) < p.nb_s;
  const Side& s = is_snap ? p.snap : p.cur;
  const long long base = is_snap ? 0 : static_cast<long long>(p.nb_s)
                                           * kScanThreads;
  const long long i = static_cast<long long>(blockIdx.x) * kScanThreads
                      + threadIdx.x - base;
  const bool set = i < s.cap && mask[(is_snap ? 0 : p.snap.cap) + i];
  const int incl = rw_block_scan<int>(set ? 1 : 0, static_cast<int*>(nullptr));
  if (set) {
    const long long r = static_cast<long long>(sums[blockIdx.x]) + incl - 1;
    i64* row = out + r * s.k;
    for (int c = 0; c < s.k; ++c) row[c] = rw_load_any(s.col[c], s.width[c], i);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    counts[0] = sums[p.nb_s];
    counts[1] = static_cast<i64>(sums[p.nb_s + p.nb_c]) - sums[p.nb_s];
  }
}

Side make_side(const long long* khash, int k, void* const* cols,
               void* const* valids, const int* widths, const int* n,
               long long cap) {
  Side s = {};
  s.khash = khash;
  s.k = k;
  for (int c = 0; c < k; ++c) {
    s.col[c] = cols[c];
    s.valid[c] = static_cast<const unsigned char*>(valids[c]);
    s.width[c] = widths[c];
  }
  s.n = n;
  s.cap = cap;
  return s;
}

}  // namespace

// Scratch ints the mark/scatter pair needs: one per block of both sides
// plus the total.
extern "C" int rw_diff_sums(long long cap_s, long long cap_c) {
  return rw_blocks(cap_s, kScanThreads) + rw_blocks(cap_c, kScanThreads) + 1;
}

// Row hashes of one side (first launch; the wrapper runs it for snap
// and cur, then sorts both with K11).
extern "C" int rw_diff_rowhash(const long long* khash, int k,
                               void* const* cols, void* const* valids,
                               const int* widths, const int* n,
                               long long cap, long long* rh, void* stream) {
  if (k < 1 || k > kMaxCols || cap < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Side s = make_side(khash, k, cols, valids, widths, n, cap);
  diff_rowhash<<<rw_blocks(cap, kScanThreads), kScanThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(s, rh);
  return static_cast<int>(cudaGetLastError());
}

// Mark, scan and scatter over both sides, given each side's row hashes
// and their stable sort (sorted hashes, order).
extern "C" int rw_diff_compact(
    const long long* khash_s, void* const* cols_s, void* const* valids_s,
    const int* n_s, long long cap_s, const long long* khash_c,
    void* const* cols_c, void* const* valids_c, const int* n_c,
    long long cap_c, int k, const int* widths, const long long* rh_s,
    const long long* rh_c, const long long* sorted_s,
    const long long* order_s, const long long* sorted_c,
    const long long* order_c, unsigned char* mask, int* sums,
    long long* out, long long* counts, void* stream) {
  if (k < 1 || k > kMaxCols || cap_s < 1 || cap_c < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Pair p = {};
  p.snap = make_side(khash_s, k, cols_s, valids_s, widths, n_s, cap_s);
  p.cur = make_side(khash_c, k, cols_c, valids_c, widths, n_c, cap_c);
  p.rh_s = rh_s;
  p.rh_c = rh_c;
  p.sorted_s = sorted_s;
  p.order_s = order_s;
  p.sorted_c = sorted_c;
  p.order_c = order_c;
  p.nb_s = rw_blocks(cap_s, kScanThreads);
  p.nb_c = rw_blocks(cap_c, kScanThreads);
  const int nb = p.nb_s + p.nb_c;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  diff_mark<<<nb, kScanThreads, 0, s>>>(p, mask, sums);
  rw_scan_sums<int><<<1, kSumsThreads, 0, s>>>(sums, nb + 1);
  diff_scatter<<<nb, kScanThreads, 0, s>>>(p, mask, sums, out, counts);
  return static_cast<int>(cudaGetLastError());
}
