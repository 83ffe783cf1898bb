// K18 — the hash agg's durable persist view and its eviction keys: a
// masked compaction in slot order with a gather into one packed int64
// buffer.
//
// Replaces risingwave_tpu/stream/hash_agg.py:891 _persist_view_impl,
// with _durable_cols_at (906), and :358 _evict_keys_impl.
//   persist  mask = dirty; row = ops ++ vis ++ keys ++ per call its
//            state, or for a retractable MIN/MAX its K values, K counts
//            and lossy flag ++ row_count, where ops = Insert (0) if
//            row_count > 0 else Delete (1) and vis = row_count > 0 or
//            prev_exists;
//   evict    mask = occupied and key[j] < watermark and row_count > 0;
//            row = keys.
// Row r of an entry lands at out[base + r * W] (W = its row width,
// values widened to int64, floats by their bits), in slot order; its
// count goes to *count on the device. The evict entry's base may be read
// from the device (the persist entry's count times its width), so both
// views share one buffer and one host fetch.
//
// The persist columns come as column groups (pointer, element width,
// lanes, stride): lane l of slot i is element i * stride + l, so a
// retractable call's [C, K] buffers are read in place as K lanes each,
// widened to int64 lanes (counts sign-extended, the flag as 0/1).
//
// What bounds it on the H100: bytes. It reads the mask inputs of every
// slot and the columns of the selected ones, and writes the selected
// rows: at q7d's C = 2^13 with a few dirty groups a barrier that is
// ~8 KB, a few nanoseconds at 3.35 TB/s, so launch latency dominates.
//
// Design: three launches an entry, no host sync. pv_count: one thread
// per slot computes the mask and its block's count (scan.cuh's block
// scan); rw_scan_sums turns the counts into exclusive block offsets
// (the last entry is the total); pv_scatter recomputes the mask and the
// in-block rank and writes the row. A launch takes at most kMaxCols
// column groups; a longer persist row is written by several scatters
// over one count and scan, each its groups' lanes at their offset in the
// row (and the ops, vis and row_count lanes, the same each time).

#include "scan.cuh"

namespace {

constexpr int kMaxCols = 64;

struct View {
  int mode;                        // 0 persist, 1 evict
  long long cap;
  const bool* dirty;               // persist mask
  const bool* occupied;            // evict mask inputs
  const void* key_j;
  int width_j;
  long long watermark;
  const i64* row_count;
  const bool* prev_exists;
  const void* col[kMaxCols];       // keys, then states (persist)
  int width[kMaxCols];
  int lanes[kMaxCols];
  int stride[kMaxCols];
  int n_keys;
  int n_cols;                      // column groups besides ops/vis/rc
  int lane_at;                     // the groups' first lane in the row
  int row_w;                       // lanes of a persist row
};

__device__ __forceinline__ bool selected(const View& v, long long i) {
  if (i >= v.cap) return false;
  if (v.mode == 0) return v.dirty[i];
  return v.occupied[i] && rw_load_any(v.key_j, v.width_j, i) < v.watermark
         && v.row_count[i] > 0;
}

__global__ void __launch_bounds__(kScanThreads)
pv_count(View v, int* __restrict__ sums, int nb) {
  const long long i = static_cast<long long>(blockIdx.x) * kScanThreads
                      + threadIdx.x;
  int total;
  rw_block_scan<int>(selected(v, i) ? 1 : 0, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
  if (blockIdx.x == 0 && threadIdx.x == 0) sums[nb] = 0;
}

__global__ void __launch_bounds__(kScanThreads)
pv_scatter(View v, const int* __restrict__ sums, int nb,
           i64* __restrict__ out, const i64* __restrict__ base_count,
           int base_width, i64* __restrict__ count) {
  const long long i = static_cast<long long>(blockIdx.x) * kScanThreads
                      + threadIdx.x;
  const bool set = selected(v, i);
  const int incl = rw_block_scan<int>(set ? 1 : 0, static_cast<int*>(nullptr));
  if (set) {
    const long long r = static_cast<long long>(sums[blockIdx.x]) + incl - 1;
    const long long base = base_count ? *base_count * base_width : 0;
    if (v.mode == 0) {
      i64* row = out + base + r * v.row_w;
      const bool exists = v.row_count[i] > 0;
      row[0] = exists ? 0 : 1;
      row[1] = (exists || v.prev_exists[i]) ? 1 : 0;
      int at = v.lane_at;
      for (int c = 0; c < v.n_cols; ++c) {
        const long long e = i * v.stride[c];
        for (int l = 0; l < v.lanes[c]; ++l) {
          row[at++] = rw_load_any(v.col[c], v.width[c], e + l);
        }
      }
      row[v.row_w - 1] = v.row_count[i];
    } else {
      i64* row = out + base + r * v.n_keys;
      for (int c = 0; c < v.n_keys; ++c) {
        row[c] = rw_load_any(v.col[c], v.width[c], i);
      }
    }
  }
  if (i == 0) *count = sums[nb];
}

int launch(const View& v, int* sums, long long* out,
           const long long* base_count, int base_width, long long* count,
           bool scan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = rw_blocks(v.cap, kScanThreads);
  if (scan) {
    pv_count<<<nb, kScanThreads, 0, s>>>(v, sums, nb);
    rw_scan_sums<int><<<1, kSumsThreads, 0, s>>>(sums, nb + 1);
  }
  pv_scatter<<<nb, kScanThreads, 0, s>>>(v, sums, nb, out, base_count,
                                         base_width, count);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scratch ints an entry needs for capacity cap.
extern "C" int rw_pv_sums(long long cap) {
  return rw_blocks(cap, kScanThreads) + 1;
}

// The persist view: column groups = keys ++ per call its state or
// buffers (n_cols of them: widths in bytes, lanes, strides in elements);
// rows of row_w = 2 + (every group's lanes) + 1 lanes, these groups'
// lanes from lane_at on. scan = 0: a later part of a split row, which
// reuses the first part's sums.
extern "C" int rw_persist_view(long long cap, const bool* dirty,
                               const long long* row_count,
                               const bool* prev_exists, int n_cols,
                               void* const* cols, const int* widths,
                               const int* lanes, const int* strides,
                               int lane_at, int row_w, int scan,
                               int* sums, long long* out, long long* count,
                               void* stream) {
  if (cap < 1 || n_cols < 1 || n_cols > kMaxCols || lane_at < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  View v = {};
  v.mode = 0;
  v.cap = cap;
  v.dirty = dirty;
  v.row_count = row_count;
  v.prev_exists = prev_exists;
  v.n_cols = n_cols;
  v.lane_at = lane_at;
  v.row_w = row_w;
  int n_lanes = 0;
  for (int c = 0; c < n_cols; ++c) {
    if (lanes[c] < 1 || strides[c] < lanes[c]) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    v.col[c] = cols[c];
    v.width[c] = widths[c];
    v.lanes[c] = lanes[c];
    v.stride[c] = strides[c];
    n_lanes += lanes[c];
  }
  if (lane_at + n_lanes + 1 > row_w) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(v, sums, out, nullptr, 0, count, scan != 0, stream);
}

// The eviction keys below `watermark` on key column j; rows of n_keys
// lanes, written after base_count[0] * base_width lanes when base_count
// is not null.
extern "C" int rw_evict_keys(long long cap, const bool* occupied,
                             const long long* row_count, int n_keys,
                             void* const* keys, const int* widths, int j,
                             long long watermark, int* sums, long long* out,
                             const long long* base_count, int base_width,
                             long long* count, void* stream) {
  if (cap < 1 || n_keys < 1 || n_keys > kMaxCols || j < 0 || j >= n_keys) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  View v = {};
  v.mode = 1;
  v.cap = cap;
  v.occupied = occupied;
  v.key_j = keys[j];
  v.width_j = widths[j];
  v.watermark = watermark;
  v.row_count = row_count;
  v.n_keys = n_keys;
  for (int c = 0; c < n_keys; ++c) {
    v.col[c] = keys[c];
    v.width[c] = widths[c];
  }
  return launch(v, sums, out, base_count, base_width, count, true, stream);
}
