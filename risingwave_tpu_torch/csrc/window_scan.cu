// K23 — the over-window's window functions over the sorted store.
//
// Replaces risingwave_tpu/stream/general_over_window.py:
// GeneralOverWindowExecutor._compute_windows (144), lines 162-248, after
// the lexsort (the order and partition keys are K20's first entry, the
// lexsort K11 passes), and eowc_over_window.py:_flush_eowc_impl (67),
// lines 71-79, the ripeness mask. With the store's slots lexsorted by
// (partition key, order keys) (`order`; dead slots last, their partition
// key int64 max), per sorted position i:
//   the sorted gathers of every input column and its validity;
//   run_start / run_end of i's partition, by binary search over the
//         sorted partition keys (they ascend), so no scan for them;
//   tie runs: a new tie where the partition or any order column's RAW
//         value changes (`!=`: each NaN its own tie, -0 == +0, as the
//         reference compares sv[1:] != sv[:-1], subnormals equal to zero
//         as its CPU compares them); D = the inclusive prefix
//         count of tie starts; dense_rank = D(i) - D(run_start) + 1,
//         tie_start = the first position of i's partition with D = D(i)
//         (binary search), rank = tie_start - run_start + 1;
//   row_number = i - run_start + 1;
//   sum / count / avg over UNBOUNDED PRECEDING or `p PRECEDING`: prefix
//         sums SEGMENTED at partition starts (a partition's values never
//         depend on another's), a frame as S(i) - S(i - p - 1) inside the
//         partition; sum and avg NULL over a frame with no valid value;
//   lag / lead / first_value: the argument at i - off, i + off or
//         run_start, valid inside the partition where the source is;
//   ripe (EOWC): live and lo < order column <= hi.
//
// Scans: three launches for every scan lane at once. ws_local writes the
// gathers and each lane's in-block inclusive scan (segmented lanes reset
// at partition starts) and the block's aggregate; ws_carry (one block a
// lane) turns the aggregates into exclusive block carries, in a fixed
// order; ws_window adds a carry where a position's partition began
// before its block and computes every output. No atomics anywhere: the
// float sums are the same from run to run. For integer-valued arguments
// (prices, counts) they equal the reference's global-prefix-sum
// differences exactly; for other finite float arguments they differ by
// rounding. A NaN or inf argument stays inside its partition, where the
// reference's global sums carry it into every later partition (NaN
// there); the plain version computes segmented sums as this kernel does.
//
// What bounds it on the H100: bytes. Per live row (dead slots sort last
// and nothing reads their outputs): the order (8 B), the partition key
// (8 B, read through the order), every input column and its valid byte
// read once through the order and written once sorted, each window
// output and valid byte written. The scan lanes' scratch (8 B each way
// a lane) and the binary searches over the sorted keys (log2(C)
// mostly-cached lines a position) are this design's own traffic.

#include "scan.cuh"
#include "key_hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCarryThreads = 1024;
constexpr int kMaxCols = 16;
constexpr int kMaxWin = 8;
constexpr int kMaxOrder = 4;
constexpr int kMaxLanes = 1 + 2 * kMaxWin;

enum WinKind { W_ROW_NUMBER = 0, W_RANK = 1, W_DENSE_RANK = 2, W_SUM = 3,
               W_COUNT = 4, W_AVG = 5, W_LAG = 6, W_LEAD = 7,
               W_FIRST_VALUE = 8 };
// what a scan lane sums: the tie-start flags (D), a window argument's
// valid values, or its valid count
enum LaneWhat { L_TIES = 0, L_VALUE = 1, L_COUNT = 2 };

struct Store {
  const void* col[kMaxCols];
  const unsigned char* valid[kMaxCols];
  int type[kMaxCols];
  int width[kMaxCols];
  void* s_col[kMaxCols];              // sorted gathers (outputs)
  unsigned char* s_valid[kMaxCols];
  int n_cols;
  int order_col[kMaxOrder];
  int n_order;
};

struct Windows {
  int kind[kMaxWin];
  int arg[kMaxWin];
  long long preceding[kMaxWin];       // -1: UNBOUNDED PRECEDING
  long long offset[kMaxWin];
  int vlane[kMaxWin];                 // value scan lane, -1 none
  int clane[kMaxWin];                 // count scan lane, -1 none
  void* out[kMaxWin];
  unsigned char* out_valid[kMaxWin];
  int n;
};

struct Lanes {
  int is_f64[kMaxLanes];
  int segmented[kMaxLanes];
  int what[kMaxLanes];
  int arg[kMaxLanes];                 // store column of L_VALUE/L_COUNT
  int n;
};

struct Scratch {
  i64* s_gkey;                        // [C] sorted partition keys
  i64* local;                         // [lanes][C] in-block scans
  i64* agg_v;                         // [lanes][nb] block aggregates
  unsigned char* agg_f;               // [lanes][nb] block has a start
  i64* carry;                         // [lanes][nb] exclusive carries
};

__device__ __forceinline__ double as_f(i64 b) {
  return __longlong_as_double(b);
}

__device__ __forceinline__ i64 as_bits(double d) {
  return __double_as_longlong(d);
}

// Element i of a numeric column as int64 (integers sign-extended, bools
// 0/1) or as double.
__device__ __forceinline__ i64 load_i(const void* col, int type,
                                      long long i) {
  if (type == RW_BOOL) {
    return static_cast<const unsigned char*>(col)[i] != 0;
  }
  if (type == RW_F64) {
    return static_cast<i64>(static_cast<const double*>(col)[i]);
  }
  return static_cast<i64>(rw_lane_u64(col, type, i));
}

__device__ __forceinline__ double load_f(const void* col, int type,
                                         long long i) {
  if (type == RW_F64) return static_cast<const double*>(col)[i];
  return static_cast<double>(load_i(col, type, i));
}

// raw inequality of elements a and b of one column (floats by value)
__device__ __forceinline__ bool raw_ne(const void* col, int type,
                                       long long a, long long b) {
  if (type == RW_F64) {
    const double* d = static_cast<const double*>(col);
    return !rw_float_eq(d[a], d[b]);
  }
  return load_i(col, type, a) != load_i(col, type, b);
}

// Inclusive scan across the block of one (start flag, value) a thread
// under the segmented sum ((f1, v1), (f2, v2)) -> (f1 | f2, f2 ? v2 :
// v1 + v2); *f becomes the inclusive flag. A fixed order of additions.
template <typename T>
__device__ __forceinline__ T seg_block_scan(bool* f, T v) {
  __shared__ T sh_v[kWarps];
  __shared__ int sh_f[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int fl = *f ? 1 : 0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T uv = __shfl_up_sync(RW_FULL_MASK, v, o);
    const int uf = __shfl_up_sync(RW_FULL_MASK, fl, o);
    if (lane >= o) {
      if (!fl) v = uv + v;
      fl |= uf;
    }
  }
  if (lane == 31) {
    sh_v[warp] = v;
    sh_f[warp] = fl;
  }
  __syncthreads();
  if (warp == 0) {
    T w = lane < kWarps ? sh_v[lane] : T(0);
    int wf = lane < kWarps ? sh_f[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const T uv = __shfl_up_sync(RW_FULL_MASK, w, o);
      const int uf = __shfl_up_sync(RW_FULL_MASK, wf, o);
      if (lane >= o) {
        if (!wf) w = uv + w;
        wf |= uf;
      }
    }
    if (lane < kWarps) {
      sh_v[lane] = w;
      sh_f[lane] = wf;
    }
  }
  __syncthreads();
  if (warp > 0) {
    if (!fl) v = sh_v[warp - 1] + v;
    fl |= sh_f[warp - 1];
  }
  *f = fl != 0;
  __syncthreads();
  return v;
}

template <typename T>
__device__ __forceinline__ T lane_val(i64 bits);
template <>
__device__ __forceinline__ i64 lane_val<i64>(i64 bits) { return bits; }
template <>
__device__ __forceinline__ double lane_val<double>(i64 bits) {
  return as_f(bits);
}

template <typename T>
__device__ __forceinline__ i64 lane_bits(T v);
template <>
__device__ __forceinline__ i64 lane_bits<i64>(i64 v) { return v; }
template <>
__device__ __forceinline__ i64 lane_bits<double>(double v) {
  return as_bits(v);
}

template <typename T>
__device__ __forceinline__ void scan_lane(int L, long long i, long long C,
                                          long long nb, bool flag, T v,
                                          Scratch s) {
  bool f = flag;
  const T incl = seg_block_scan<T>(&f, v);
  if (i < C) s.local[L * C + i] = lane_bits<T>(incl);
  if (threadIdx.x == kThreads - 1) {
    s.agg_v[L * nb + blockIdx.x] = lane_bits<T>(incl);
    s.agg_f[L * nb + blockIdx.x] = f ? 1 : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
ws_local_kernel(const i64* __restrict__ order, const i64* __restrict__ gkey,
                const int* __restrict__ n_live, long long C, long long nb,
                Store st, Lanes ln, Scratch s) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  const long long n = *n_live;
  bool new_run = false, tie_new = false, live = false;
  long long o = 0;
  if (i < C) {
    o = order[i];
    live = o < n;
    const i64 g = gkey[o];
    s.s_gkey[i] = g;
    for (int k = 0; k < st.n_cols; ++k) {
      rw_copy_elem(st.s_col[k], i, st.col[k], o, st.width[k]);
      st.s_valid[k][i] = st.valid[k][o];
    }
    if (i == 0) {
      new_run = tie_new = true;
    } else {
      const long long p = order[i - 1];
      new_run = gkey[p] != g;
      tie_new = new_run;
      for (int k = 0; k < st.n_order && !tie_new; ++k) {
        const int c = st.order_col[k];
        tie_new = raw_ne(st.col[c], st.type[c], o, p);
      }
    }
  }
  for (int L = 0; L < ln.n; ++L) {
    const bool flag = ln.segmented[L] && new_run;
    if (ln.what[L] == L_TIES) {
      scan_lane<i64>(L, i, C, nb, flag, tie_new ? 1 : 0, s);
      continue;
    }
    const int a = ln.arg[L];
    const bool av = i < C && live && st.valid[a][o];
    if (ln.what[L] == L_COUNT) {
      scan_lane<i64>(L, i, C, nb, flag, av ? 1 : 0, s);
    } else if (ln.is_f64[L]) {
      scan_lane<double>(L, i, C, nb, flag,
                        av ? load_f(st.col[a], st.type[a], o) : 0.0, s);
    } else {
      scan_lane<i64>(L, i, C, nb, flag,
                     av ? load_i(st.col[a], st.type[a], o) : 0, s);
    }
  }
}

// One block a lane: carry[b] = the segmented sum of the aggregates of
// blocks [0, b), each thread folding a contiguous run in order, then the
// runs' totals scanned across the block, then the run re-walked.
template <typename T>
__device__ void carry_lane(const i64* agg_v, const unsigned char* agg_f,
                           i64* carry, long long nb) {
  __shared__ T part_v[kCarryThreads];
  __shared__ int part_f[kCarryThreads];
  const int t = threadIdx.x;
  const long long per = (nb + kCarryThreads - 1) / kCarryThreads;
  const long long b0 = min(nb, t * per);
  const long long b1 = min(nb, b0 + per);
  T v = T(0);
  int f = 0;
  for (long long b = b0; b < b1; ++b) {
    const T x = lane_val<T>(agg_v[b]);
    if (agg_f[b]) {
      v = x;
      f = 1;
    } else {
      v = v + x;
    }
  }
  part_v[t] = v;
  part_f[t] = f;
  __syncthreads();
  for (int o = 1; o < kCarryThreads; o <<= 1) {
    const T uv = t >= o ? part_v[t - o] : T(0);
    const int uf = t >= o ? part_f[t - o] : 0;
    __syncthreads();
    if (t >= o) {
      if (!part_f[t]) part_v[t] = uv + part_v[t];
      part_f[t] |= uf;
    }
    __syncthreads();
  }
  T run = t > 0 ? part_v[t - 1] : T(0);
  for (long long b = b0; b < b1; ++b) {
    carry[b] = lane_bits<T>(run);
    const T x = lane_val<T>(agg_v[b]);
    run = agg_f[b] ? x : run + x;
  }
}

__global__ void __launch_bounds__(kCarryThreads)
ws_carry_kernel(Lanes ln, Scratch s, long long nb) {
  const int L = blockIdx.x;
  if (ln.is_f64[L]) {
    carry_lane<double>(s.agg_v + L * nb, s.agg_f + L * nb, s.carry + L * nb,
                       nb);
  } else {
    carry_lane<i64>(s.agg_v + L * nb, s.agg_f + L * nb, s.carry + L * nb,
                    nb);
  }
}

// Final scan value of lane L at position p, whose partition starts at rs.
__device__ __forceinline__ i64 lane_at_i(const Scratch& s, const Lanes& ln,
                                         int L, long long p, long long rs,
                                         long long C, long long nb) {
  const long long b = p / kThreads;
  const i64 v = s.local[L * C + p];
  const bool add = !ln.segmented[L] || rs < b * kThreads;
  return add ? static_cast<i64>(static_cast<u64>(v)
                                + static_cast<u64>(s.carry[L * nb + b]))
             : v;
}

__device__ __forceinline__ double lane_at_f(const Scratch& s,
                                            const Lanes& ln, int L,
                                            long long p, long long rs,
                                            long long C, long long nb) {
  const long long b = p / kThreads;
  const double v = as_f(s.local[L * C + p]);
  const bool add = !ln.segmented[L] || rs < b * kThreads;
  return add ? as_f(s.carry[L * nb + b]) + v : v;
}

__global__ void __launch_bounds__(kThreads)
ws_window_kernel(const i64* __restrict__ order, const int* __restrict__ n_live,
                 long long C, long long nb, Store st, Windows w, Lanes ln,
                 Scratch s, int ripe_col, long long lo, long long hi,
                 unsigned char* __restrict__ ripe) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (i >= C) return;
  const long long n = *n_live;
  const long long o = order[i];
  const bool live = o < n;
  const i64 g = s.s_gkey[i];
  const long long rs = rw_lower_bound(s.s_gkey, i, g);
  const long long re = i + rw_upper_bound(s.s_gkey + i, C - i, g) - 1;
  // lane 0 is D, the prefix count of tie starts
  const i64 d_i = lane_at_i(s, ln, 0, i, rs, C, nb);
  for (int k = 0; k < w.n; ++k) {
    const int kind = w.kind[k];
    unsigned char valid = live;
    if (kind == W_ROW_NUMBER || kind == W_RANK || kind == W_DENSE_RANK) {
      i64 v;
      if (kind == W_ROW_NUMBER) {
        v = i - rs + 1;
      } else if (kind == W_DENSE_RANK) {
        v = d_i - lane_at_i(s, ln, 0, rs, rs, C, nb) + 1;
      } else {
        long long a = rs, b = i;           // first p in [rs, i], D(p) = d_i
        while (a < b) {
          const long long mid = (a + b) >> 1;
          if (lane_at_i(s, ln, 0, mid, rs, C, nb) < d_i) a = mid + 1;
          else b = mid;
        }
        v = a - rs + 1;
      }
      static_cast<i64*>(w.out[k])[i] = v;
    } else if (kind == W_LAG || kind == W_LEAD || kind == W_FIRST_VALUE) {
      long long src;
      bool in_part;
      if (kind == W_FIRST_VALUE) {
        src = rs;
        in_part = true;
      } else if (kind == W_LAG) {
        src = i - w.offset[k];
        in_part = src >= rs;
      } else {
        src = i + w.offset[k];
        in_part = src <= re;
      }
      const long long sc = src < 0 ? 0 : (src > C - 1 ? C - 1 : src);
      const long long so = order[sc];
      const int a = w.arg[k];
      rw_copy_elem(w.out[k], i, st.col[a], so, st.width[a]);
      valid = live && in_part && st.valid[a][so];
    } else {
      const int vl = w.vlane[k], cl = w.clane[k];
      const long long p = w.preceding[k];
      const long long lo_pos = i - (p + 1);
      const bool framed = p >= 0 && lo_pos >= rs;
      long long cnt = 0;
      if (cl >= 0) {
        cnt = lane_at_i(s, ln, cl, i, rs, C, nb);
        if (framed) cnt -= lane_at_i(s, ln, cl, lo_pos, rs, C, nb);
      }
      if (ln.is_f64[vl]) {
        double v = lane_at_f(s, ln, vl, i, rs, C, nb);
        if (framed) v = v - lane_at_f(s, ln, vl, lo_pos, rs, C, nb);
        if (kind == W_AVG) {
          v = v / static_cast<double>(cnt > 1 ? cnt : 1);
        }
        static_cast<double*>(w.out[k])[i] = v;
      } else {
        i64 v = lane_at_i(s, ln, vl, i, rs, C, nb);
        if (framed) {
          v = static_cast<i64>(static_cast<u64>(v) - static_cast<u64>(
              lane_at_i(s, ln, vl, lo_pos, rs, C, nb)));
        }
        static_cast<i64*>(w.out[k])[i] = v;
      }
      if (kind != W_COUNT) valid = live && cnt > 0;
    }
    w.out_valid[k][i] = valid;
  }
  if (ripe) {
    const i64 ov = rw_load_any(st.col[ripe_col], st.width[ripe_col], o);
    ripe[i] = live && ov > lo && ov <= hi;
  }
}

}  // namespace

// The scan's block count nb: the caller allocates lanes * C int64 for
// `local`, lanes * nb int64 for agg_v and carry, lanes * nb bytes for
// agg_f.
extern "C" int rw_window_scan_blocks(long long C) {
  return C > 0 ? static_cast<int>((C + kThreads - 1) / kThreads) : 1;
}

extern "C" int rw_window_scan(
    const long long* order, const long long* gkey, const int* n_live,
    long long C, int n_cols, void* const* cols, void* const* valids,
    const int* types, const int* widths, void* const* s_cols,
    void* const* s_valids, int n_order, const int* order_cols, int n_win,
    const int* kinds, const int* args, const long long* preceding,
    const long long* offsets, const int* vlanes, const int* clanes,
    void* const* outs, void* const* out_valids, int n_lanes,
    const int* lane_f64, const int* lane_seg, const int* lane_what,
    const int* lane_arg, long long* s_gkey, long long* local,
    long long* agg_v, unsigned char* agg_f, long long* carry, int ripe_col,
    long long lo, long long hi, unsigned char* ripe, void* stream_) {
  if (n_cols < 1 || n_cols > kMaxCols || n_order < 1
      || n_order > kMaxOrder || n_win < 0 || n_win > kMaxWin
      || n_lanes < 1 || n_lanes > kMaxLanes || C < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  Store st = {};
  st.n_cols = n_cols;
  for (int k = 0; k < n_cols; ++k) {
    st.col[k] = cols[k];
    st.valid[k] = static_cast<const unsigned char*>(valids[k]);
    st.type[k] = types[k];
    st.width[k] = widths[k];
    st.s_col[k] = s_cols[k];
    st.s_valid[k] = static_cast<unsigned char*>(s_valids[k]);
  }
  st.n_order = n_order;
  for (int k = 0; k < n_order; ++k) st.order_col[k] = order_cols[k];
  Windows w = {};
  w.n = n_win;
  for (int k = 0; k < n_win; ++k) {
    w.kind[k] = kinds[k];
    w.arg[k] = args[k];
    w.preceding[k] = preceding[k];
    w.offset[k] = offsets[k];
    w.vlane[k] = vlanes[k];
    w.clane[k] = clanes[k];
    w.out[k] = outs[k];
    w.out_valid[k] = static_cast<unsigned char*>(out_valids[k]);
  }
  Lanes ln = {};
  ln.n = n_lanes;
  for (int k = 0; k < n_lanes; ++k) {
    ln.is_f64[k] = lane_f64[k];
    ln.segmented[k] = lane_seg[k];
    ln.what[k] = lane_what[k];
    ln.arg[k] = lane_arg[k];
  }
  Scratch s = {reinterpret_cast<i64*>(s_gkey), reinterpret_cast<i64*>(local),
               reinterpret_cast<i64*>(agg_v), agg_f,
               reinterpret_cast<i64*>(carry)};
  const long long nb = rw_window_scan_blocks(C);
  ws_local_kernel<<<static_cast<int>(nb), kThreads, 0, stream>>>(
      reinterpret_cast<const i64*>(order), reinterpret_cast<const i64*>(gkey),
      n_live, C, nb, st, ln, s);
  ws_carry_kernel<<<n_lanes, kCarryThreads, 0, stream>>>(ln, s, nb);
  ws_window_kernel<<<static_cast<int>(nb), kThreads, 0, stream>>>(
      reinterpret_cast<const i64*>(order), n_live, C, nb, st, w, ln, s,
      ripe_col, lo, hi, ripe);
  return static_cast<int>(cudaGetLastError());
}
