// K15 — segmented group aggregation over a key-sorted store.
//
// Replaces risingwave_tpu/stream/snapshot_join_agg.py:_flush_impl (217),
// lines 222-263: the sort keys (dead slots and NULL keys pushed to the
// int64-max sentinel group), the gather of the store into key order, run
// boundaries -> int32 group ids, per-group COUNT / SUM (int64, float64) /
// append-only MIN / MAX with their counts and validity, the group-
// existence mask, and the gather of per-group values back to the rows.
// XLA lowers these to sorts, cumsums and segment reductions on the TPU.
//
// Entry points:
//   rw_seg_keys    out[i] = (i < count && valid[i]) ? key[i] : INT64_MAX
//   rw_seg_take    dst[k][i] = src[k][idx[i]] (and validity) for every
//                  column in one launch; idx int32 or int64
//   rw_seg_reduce  four launches, no host sync:
//     heads   each block counts its run heads (sfk[i] != sfk[i-1]) and
//             sets every group's state to its identity;
//     sums    scan.cuh's one-block scan turns the counts into offsets;
//     reduce  gid = offset + in-block rank of the heads; each row's
//             contributions (sign = the row is live and passes the sub
//             filter, times the argument's validity) are combined by a
//             segmented scan across the warp (runs are contiguous, so a
//             shuffle step joins two lanes only when their gids agree),
//             and the last lane of each run issues one atomic per state;
//     emit    the states cast to each result's type, valid = count > 0
//             (COUNT always), gexists = some row had a nonzero sign.
//
// What bounds it on the H100: bytes. At bench's q17 geometry (C = 2^20
// slots, two calls over one int64 column) the reduce reads the sorted
// keys, the order, the column and its validity (~34 B a slot) and writes
// the gid (4 B); the heads, emit and scan passes add ~30 B a slot: ~70 MB
// per flush, ~21 us at 3.35 TB/s. Atomics stay rare: one a warp and a
// run, and none for a run whose contribution is the identity (the dead
// slots' sentinel run).
//
// Sums of float64 states are taken in another order than the JAX
// package's (warp scans, then atomics in any order), so they equal the
// plain version exactly when every partial sum is an integer below 2^53
// (q17's sum of quantities) and otherwise within a relative 1e-12.

#include "scan.cuh"

namespace {

constexpr int kMaxCalls = 8;
constexpr int kMaxTake = 16;
constexpr i64 kI64Max = 0x7fffffffffffffffLL;
constexpr i64 kI64Min = static_cast<i64>(0x8000000000000000ULL);

enum Kind { COUNT = 0, SUM = 1, MIN = 2, MAX = 3 };
// result types (expr/program.py's codes)
enum Type { T_I64 = 0, T_I32 = 1, T_I16 = 2, T_I8 = 3, T_BOOL = 4,
            T_F64 = 5 };

struct Calls {
  int kind[kMaxCalls];
  const void* arg[kMaxCalls];
  int arg_w[kMaxCalls];
  int arg_float[kMaxCalls];
  const unsigned char* arg_valid[kMaxCalls];
  int state_float[kMaxCalls];
  i64* state[kMaxCalls];
  int* cnt[kMaxCalls];
  void* out[kMaxCalls];
  int out_type[kMaxCalls];
  unsigned char* out_valid[kMaxCalls];
};

struct Take {
  const void* src[kMaxTake];
  int w[kMaxTake];
  const unsigned char* src_valid[kMaxTake];
  void* dst[kMaxTake];
  unsigned char* dst_valid[kMaxTake];
};

__device__ __forceinline__ double as_f(i64 bits) {
  return __longlong_as_double(bits);
}

__device__ __forceinline__ i64 as_bits(double d) {
  return __double_as_longlong(d);
}

// the identity of a state: 0, +inf / INT64_MAX (MIN), -inf / INT64_MIN
// (MAX)
constexpr i64 kPosInf = 0x7ff0000000000000LL;   // bits of +inf
constexpr i64 kNegInf = static_cast<i64>(0xfff0000000000000ULL);

__device__ __forceinline__ i64 identity(int kind, int fl) {
  if (kind == MIN) return fl ? kPosInf : kI64Max;
  if (kind == MAX) return fl ? kNegInf : kI64Min;
  return 0;
}

// NaN-propagating min / max of float64 (torch's amin / amax)
__device__ __forceinline__ double fmin_nan(double a, double b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}

__device__ __forceinline__ double fmax_nan(double a, double b) {
  return a != a ? a : (b != b ? b : (b > a ? b : a));
}

// combine two states of one kind
__device__ __forceinline__ i64 combine(int kind, int fl, i64 a, i64 b) {
  if (fl) {
    const double x = as_f(a), y = as_f(b);
    if (kind == MIN) return as_bits(fmin_nan(x, y));
    if (kind == MAX) return as_bits(fmax_nan(x, y));
    return as_bits(x + y);
  }
  if (kind == MIN) return a < b ? a : b;
  if (kind == MAX) return a > b ? a : b;
  return static_cast<i64>(static_cast<u64>(a) + static_cast<u64>(b));
}

__device__ __forceinline__ void atomic_combine(int kind, int fl, i64* p,
                                               i64 v) {
  if (!fl) {
    if (kind == MIN) {
      atomicMin(reinterpret_cast<long long*>(p), v);
    } else if (kind == MAX) {
      atomicMax(reinterpret_cast<long long*>(p), v);
    } else {
      atomicAdd(reinterpret_cast<unsigned long long*>(p),
                static_cast<unsigned long long>(v));
    }
    return;
  }
  if (kind == SUM) {
    atomicAdd(reinterpret_cast<double*>(p), as_f(v));
    return;
  }
  unsigned long long* a = reinterpret_cast<unsigned long long*>(p);
  unsigned long long old = *a, assumed;
  do {
    assumed = old;
    const i64 want = combine(kind, 1, static_cast<i64>(assumed), v);
    if (want == static_cast<i64>(assumed)) return;
    old = atomicCAS(a, assumed, static_cast<unsigned long long>(want));
  } while (old != assumed);
}

__device__ __forceinline__ i64 load_int(const void* p, int w, long long i) {
  switch (w) {
    case 8: return static_cast<const i64*>(p)[i];
    case 4: return static_cast<const int*>(p)[i];
    case 2: return static_cast<const short*>(p)[i];
    default: return static_cast<const signed char*>(p)[i];
  }
}

// segmented inclusive scan across the warp: lane j joins lane j-o only
// when both hold the same group (runs are contiguous and ascending)
__device__ __forceinline__ i64 seg_scan(i64 v, int g, int kind, int fl) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const i64 u = __shfl_up_sync(RW_FULL_MASK, v, o);
    const int gu = __shfl_up_sync(RW_FULL_MASK, g, o);
    if (lane >= o && gu == g) v = combine(kind, fl, v, u);
  }
  return v;
}

__device__ __forceinline__ int seg_scan_int(int v, int g) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(RW_FULL_MASK, v, o);
    const int gu = __shfl_up_sync(RW_FULL_MASK, g, o);
    if (lane >= o && gu == g) v += u;
  }
  return v;
}

__global__ void keys_kernel(const void* __restrict__ key, int w,
                            const unsigned char* __restrict__ valid,
                            const int* __restrict__ count, long long n,
                            i64* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i >= n) return;
  const bool live = i < *count && (!valid || valid[i]);
  out[i] = live ? rw_load_key(key, w, i) : kI64Max;
}

__global__ void take_kernel(Take t, int n_cols, const void* __restrict__ idx,
                            int idx_w, long long n) {
  __shared__ Take s;
  if (threadIdx.x == 0) s = t;
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i >= n) return;
  const long long j = idx_w == 8 ? static_cast<const i64*>(idx)[i]
                                 : static_cast<const int*>(idx)[i];
  for (int k = 0; k < n_cols; ++k) {
    rw_copy_elem(s.dst[k], i, s.src[k], j, s.w[k]);
    if (s.dst_valid[k]) s.dst_valid[k][i] = s.src_valid[k][j];
  }
}

__global__ void __launch_bounds__(kScanThreads)
heads_kernel(const i64* __restrict__ sfk, long long c, Calls calls,
             int n_calls, int* __restrict__ gcount, int* __restrict__ sums,
             int nb) {
  __shared__ Calls s;
  if (threadIdx.x == 0) s = calls;
  __syncthreads();
  const long long i =
      static_cast<long long>(blockIdx.x) * kScanThreads + threadIdx.x;
  if (i < c) {
    for (int k = 0; k < n_calls; ++k) {
      s.state[k][i] = identity(s.kind[k], s.state_float[k]);
      s.cnt[k][i] = 0;
    }
    gcount[i] = 0;
  }
  const int head = i < c && (i == 0 || sfk[i] != sfk[i - 1]);
  int total;
  rw_block_scan<int>(head, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
  if (blockIdx.x == 0 && threadIdx.x == 0) sums[nb] = 0;
}

__global__ void __launch_bounds__(kScanThreads)
reduce_kernel(const i64* __restrict__ sfk, const i64* __restrict__ perm,
              const int* __restrict__ count,
              const unsigned char* __restrict__ pred,
              const unsigned char* __restrict__ pred_valid, Calls calls,
              int n_calls, int* __restrict__ gid_out,
              int* __restrict__ gcount, const int* __restrict__ sums,
              long long c) {
  __shared__ Calls s;
  if (threadIdx.x == 0) s = calls;
  __syncthreads();
  const long long i =
      static_cast<long long>(blockIdx.x) * kScanThreads + threadIdx.x;
  const bool in = i < c;
  const int head = in && (i == 0 || sfk[i] != sfk[i - 1]);
  const int incl = rw_block_scan<int>(head, static_cast<int*>(nullptr));
  // rows past the end get a group of their own and contribute nothing
  const int g = in ? sums[blockIdx.x] + incl - 1 : 0x7fffffff;
  if (in) gid_out[i] = g;
  const bool live = in && perm[i] < *count;
  const int sign = live && (!pred || (pred[i] && (!pred_valid
                                                  || pred_valid[i])));
  const int lane = threadIdx.x & 31;
  const int g_next = __shfl_down_sync(RW_FULL_MASK, g, 1);
  const bool last = in && (lane == 31 || g_next != g);

  const int gc = seg_scan_int(sign, g);
  if (last && gc) atomicAdd(&gcount[g], gc);
  for (int k = 0; k < n_calls; ++k) {
    const int kind = s.kind[k], fl = s.state_float[k];
    const void* arg = s.arg[k];
    const unsigned char* av = s.arg_valid[k];
    const int rs = sign && (!av || av[i]);
    i64 v = identity(kind, fl);
    if (kind == COUNT) {
      v = rs;
    } else if (in) {
      if (fl) {
        const double x = s.arg_float[k]
            ? as_f(static_cast<const i64*>(arg)[i])
            : static_cast<double>(load_int(arg, s.arg_w[k], i));
        // the reference multiplies every row by its sign (0 included)
        if (kind == SUM) v = as_bits(x * static_cast<double>(rs));
        else if (rs > 0) v = as_bits(x);
      } else {
        const i64 x = load_int(arg, s.arg_w[k], i);
        if (kind == SUM) v = rs ? x : 0;
        else if (rs > 0) v = x;
      }
    }
    v = seg_scan(v, g, kind, fl);
    const int n_rs = seg_scan_int(rs != 0, g);
    if (last) {
      if (v != identity(kind, fl)) {
        atomic_combine(kind, fl, s.state[k] + g, v);
      }
      if (n_rs) atomicAdd(s.cnt[k] + g, n_rs);
    }
  }
}

__device__ __forceinline__ void store_int(void* p, int type, long long i,
                                          i64 v) {
  switch (type) {
    case T_I64:
    case T_F64: static_cast<i64*>(p)[i] = v; break;
    case T_I32: static_cast<int*>(p)[i] = static_cast<int>(v); break;
    case T_I16: static_cast<short*>(p)[i] = static_cast<short>(v); break;
    case T_I8:
      static_cast<signed char*>(p)[i] = static_cast<signed char>(v);
      break;
    default: static_cast<unsigned char*>(p)[i] = v != 0;
  }
}

__global__ void __launch_bounds__(kScanThreads)
emit_kernel(Calls calls, int n_calls, const int* __restrict__ gcount,
            unsigned char* __restrict__ gexists, long long c) {
  __shared__ Calls s;
  if (threadIdx.x == 0) s = calls;
  __syncthreads();
  const long long g =
      static_cast<long long>(blockIdx.x) * kScanThreads + threadIdx.x;
  if (g >= c) return;
  for (int k = 0; k < n_calls; ++k) {
    s.out_valid[k][g] = s.kind[k] == COUNT || s.cnt[k][g] > 0;
    // a 64-bit result of the state's own type is the state itself
    if (s.out[k] != static_cast<void*>(s.state[k])) {
      store_int(s.out[k], s.out_type[k], g, s.state[k][g]);
    }
  }
  gexists[g] = gcount[g] > 0;
}

Calls make_calls(int n_calls, const int* kinds, void* const* args,
                 const int* arg_w, const int* arg_float,
                 void* const* arg_valid, const int* state_float,
                 void* const* state, void* const* cnt, void* const* out,
                 const int* out_type, void* const* out_valid) {
  Calls c = {};
  for (int k = 0; k < n_calls; ++k) {
    c.kind[k] = kinds[k];
    c.arg[k] = args[k];
    c.arg_w[k] = arg_w[k];
    c.arg_float[k] = arg_float[k];
    c.arg_valid[k] = static_cast<const unsigned char*>(arg_valid[k]);
    c.state_float[k] = state_float[k];
    c.state[k] = static_cast<i64*>(state[k]);
    c.cnt[k] = static_cast<int*>(cnt[k]);
    c.out[k] = out[k];
    c.out_type[k] = out_type[k];
    c.out_valid[k] = static_cast<unsigned char*>(out_valid[k]);
  }
  return c;
}

}  // namespace

extern "C" int rw_seg_keys(const void* key, int key_w,
                           const unsigned char* valid, const int* count,
                           long long n, long long* out, void* stream) {
  if (key_w != 4 && key_w != 8) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    keys_kernel<<<rw_blocks(n, 256), 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(key, key_w, valid,
                                                       count, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rw_seg_take(int n_cols, void* const* src, const int* w,
                           void* const* src_valid, void* const* dst,
                           void* const* dst_valid, const void* idx,
                           int idx_w, long long n, void* stream) {
  if (n_cols <= 0 || n_cols > kMaxTake || (idx_w != 4 && idx_w != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Take t = {};
  for (int k = 0; k < n_cols; ++k) {
    t.src[k] = src[k];
    t.w[k] = w[k];
    t.src_valid[k] = static_cast<const unsigned char*>(src_valid[k]);
    t.dst[k] = dst[k];
    t.dst_valid[k] = static_cast<unsigned char*>(dst_valid[k]);
  }
  if (n > 0) {
    take_kernel<<<rw_blocks(n, 256), 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(t, n_cols, idx, idx_w,
                                                       n);
  }
  return static_cast<int>(cudaGetLastError());
}

// sums must hold rw_seg_blocks(c) + 1 ints
extern "C" int rw_seg_blocks(long long c) { return rw_blocks(c, kScanThreads); }

extern "C" int rw_seg_reduce(
    const long long* sfk, const long long* perm, const int* count,
    const unsigned char* pred, const unsigned char* pred_valid, int n_calls,
    const int* kinds, void* const* args, const int* arg_w,
    const int* arg_float, void* const* arg_valid, const int* state_float,
    void* const* state, void* const* cnt, void* const* out,
    const int* out_type, void* const* out_valid, int* gid, int* gcount,
    unsigned char* gexists, int* sums, long long c, void* stream_) {
  if (n_calls < 0 || n_calls > kMaxCalls) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const Calls calls = make_calls(n_calls, kinds, args, arg_w, arg_float,
                                 arg_valid, state_float, state, cnt, out,
                                 out_type, out_valid);
  const int nb = rw_seg_blocks(c);
  if (nb == 0) return static_cast<int>(cudaGetLastError());
  heads_kernel<<<nb, kScanThreads, 0, stream>>>(sfk, c, calls, n_calls,
                                                gcount, sums, nb);
  rw_scan_sums<int><<<1, kSumsThreads, 0, stream>>>(sums, nb + 1);
  reduce_kernel<<<nb, kScanThreads, 0, stream>>>(
      sfk, perm, count, pred, pred_valid, calls, n_calls, gid, gcount, sums,
      c);
  emit_kernel<<<nb, kScanThreads, 0, stream>>>(calls, n_calls, gcount,
                                               gexists, c);
  return static_cast<int>(cudaGetLastError());
}
