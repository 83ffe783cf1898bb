// K16 — dim membership, the masked global aggregates, the diff chunk.
//
// Replaces risingwave_tpu/stream/snapshot_join_agg.py:_flush_impl (217),
// lines 265-322: a searchsorted of every sorted fact key in the sorted
// dim keys (member = pos < dn and the key found at pos, clipped to the
// last slot), AND-ed with group existence (under a sub WHERE), the
// residue and the fact filter; the global COUNT / SUM / MIN / MAX of the
// rows that survive, each to one row; then the comparison with the
// previous emission and the 2-row changelog chunk [prev as U-, cur as U+]
// (Insert before the first emission), both rows invisible when nothing
// changed. XLA fuses these on the TPU.
//
// Entry points:
//   rw_final_reduce  two launches: per-block partials over a fixed grid
//                    (each thread walks a fixed stride of rows, a binary
//                    search only for live rows that keep every
//                    predicate), then one block combines the partials in
//                    a fixed order. No atomics, so the result is the same
//                    from run to run; float64 sums are exact against the
//                    plain version for integer values below 2^53 and
//                    otherwise within a relative 1e-12.
//   rw_final_diff    one thread: compare, write the chunk, replace prev.
//
// What bounds it on the H100: bytes, and the search's dependent loads.
// At q17's bench geometry the reduce reads per slot the sorted key, the
// order, one value column with its validity, the residue's data and
// validity and the group id (~31 B), 33 MB at C = 2^20: ~10 us at 3.35
// TB/s; the 16-step search over the 2^16 dim keys (512 KB, L2-resident)
// runs only for rows that survive the predicates.

#include "scan.cuh"

namespace {

constexpr int kMaxCalls = 8;
constexpr int kMaxItems = 8;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;
constexpr i64 kI64Max = 0x7fffffffffffffffLL;
constexpr i64 kI64Min = static_cast<i64>(0x8000000000000000ULL);
constexpr i64 kPosInf = 0x7ff0000000000000LL;   // bits of +inf
constexpr i64 kNegInf = static_cast<i64>(0xfff0000000000000ULL);

enum Kind { COUNT = 0, SUM = 1, MIN = 2, MAX = 3 };
enum Type { T_I64 = 0, T_I32 = 1, T_I16 = 2, T_I8 = 3, T_BOOL = 4,
            T_F64 = 5 };

struct Args {
  const unsigned char* pred[2];
  const unsigned char* pred_valid[2];
  int kind[kMaxCalls];
  const void* arg[kMaxCalls];
  int arg_w[kMaxCalls];
  int arg_float[kMaxCalls];
  const unsigned char* arg_valid[kMaxCalls];
  int state_float[kMaxCalls];
  void* out[kMaxCalls];
  int out_type[kMaxCalls];
  unsigned char* out_valid[kMaxCalls];
};

struct Diff {
  const void* cur[kMaxItems];
  const unsigned char* cur_valid[kMaxItems];
  int type[kMaxItems];
  void* prev[kMaxItems];
  unsigned char* prev_valid[kMaxItems];
  void* out[kMaxItems];
  unsigned char* out_valid[kMaxItems];
};

__device__ __forceinline__ double as_f(i64 bits) {
  return __longlong_as_double(bits);
}

__device__ __forceinline__ i64 as_bits(double d) {
  return __double_as_longlong(d);
}

__device__ __forceinline__ i64 identity(int kind, int fl) {
  if (kind == MIN) return fl ? kPosInf : kI64Max;
  if (kind == MAX) return fl ? kNegInf : kI64Min;
  return 0;
}

__device__ __forceinline__ double fmin_nan(double a, double b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}

__device__ __forceinline__ double fmax_nan(double a, double b) {
  return a != a ? a : (b != b ? b : (b > a ? b : a));
}

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

__device__ __forceinline__ i64 load_int(const void* p, int w, long long i) {
  switch (w) {
    case 8: return static_cast<const i64*>(p)[i];
    case 4: return static_cast<const int*>(p)[i];
    case 2: return static_cast<const short*>(p)[i];
    default: return static_cast<const signed char*>(p)[i];
  }
}

__device__ __forceinline__ int type_width(int type) {
  switch (type) {
    case T_I64:
    case T_F64: return 8;
    case T_I32: return 4;
    case T_I16: return 2;
    default: return 1;
  }
}

__device__ __forceinline__ void store_value(void* p, int type, long long i,
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

// block-wide reduction of one state a thread in a fixed order (xor
// butterflies, then the warps in order); the result lands in thread 0
__device__ __forceinline__ void block_combine(i64* v, long long* nz,
                                              int kind, int fl) {
  __shared__ i64 s_v[kThreads / 32];
  __shared__ long long s_nz[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    *v = combine(kind, fl, *v, __shfl_xor_sync(RW_FULL_MASK, *v, o));
    *nz += __shfl_xor_sync(RW_FULL_MASK, *nz, o);
  }
  if (lane == 0) {
    s_v[warp] = *v;
    s_nz[warp] = *nz;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    i64 a = s_v[0];
    long long n = s_nz[0];
    for (int w = 1; w < kThreads / 32; ++w) {
      a = combine(kind, fl, a, s_v[w]);
      n += s_nz[w];
    }
    *v = a;
    *nz = n;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
final_rows_kernel(const i64* __restrict__ sfk, const i64* __restrict__ perm,
                  const int* __restrict__ count, const i64* __restrict__ sd,
                  long long cd, const int* __restrict__ dn_ptr,
                  const unsigned char* __restrict__ gexists,
                  const int* __restrict__ gid, int n_preds, Args args,
                  int n_calls, i64* __restrict__ partials, long long c) {
  __shared__ Args s;
  if (threadIdx.x == 0) s = args;
  __syncthreads();
  const long long fn = *count;
  const long long dn = *dn_ptr;
  i64 acc[kMaxCalls];
  long long nz[kMaxCalls];
#pragma unroll
  for (int k = 0; k < kMaxCalls; ++k) {
    acc[k] = k < n_calls ? identity(s.kind[k], s.state_float[k]) : 0;
    nz[k] = 0;
  }
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads
                     + threadIdx.x; i < c; i += stride) {
    bool msign = perm[i] < fn;
    for (int p = 0; p < n_preds && msign; ++p) {
      msign = s.pred[p][i] && (!s.pred_valid[p] || s.pred_valid[p][i]);
    }
    if (msign) {
      const i64 key = sfk[i];
      const long long pos = rw_lower_bound(sd, cd, key);
      msign = pos < dn && sd[pos < cd ? pos : cd - 1] == key;
      if (msign && gexists) msign = gexists[gid[i]];
    }
#pragma unroll
    for (int k = 0; k < kMaxCalls; ++k) {
      if (k >= n_calls) break;
      const int kind = s.kind[k], fl = s.state_float[k];
      const unsigned char* av = s.arg_valid[k];
      const int rs = msign && (!av || av[i]);
      nz[k] += rs != 0;
      if (kind == COUNT) {
        acc[k] += rs;
        continue;
      }
      const void* arg = s.arg[k];
      if (fl) {
        const double x = s.arg_float[k]
            ? as_f(static_cast<const i64*>(arg)[i])
            : static_cast<double>(load_int(arg, s.arg_w[k], i));
        // the reference multiplies every row by its sign (0 included)
        if (kind == SUM) {
          acc[k] = as_bits(as_f(acc[k]) + x * static_cast<double>(rs));
        } else if (rs) {
          acc[k] = combine(kind, 1, acc[k], as_bits(x));
        }
      } else if (rs) {
        acc[k] = combine(kind, 0, acc[k], load_int(arg, s.arg_w[k], i));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxCalls; ++k) {
    if (k >= n_calls) break;
    block_combine(&acc[k], &nz[k], s.kind[k], s.state_float[k]);
    if (threadIdx.x == 0) {
      partials[(static_cast<long long>(blockIdx.x) * n_calls + k) * 2] =
          acc[k];
      partials[(static_cast<long long>(blockIdx.x) * n_calls + k) * 2 + 1] =
          nz[k];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
final_combine_kernel(Args args, int n_calls, const i64* __restrict__ partials,
                     int blocks) {
  __shared__ Args s;
  if (threadIdx.x == 0) s = args;
  __syncthreads();
  for (int k = 0; k < n_calls; ++k) {
    const int kind = s.kind[k], fl = s.state_float[k];
    i64 v = identity(kind, fl);
    long long n = 0;
    for (int b = threadIdx.x; b < blocks; b += kThreads) {
      v = combine(kind, fl, v, partials[(static_cast<long long>(b) * n_calls
                                         + k) * 2]);
      n += partials[(static_cast<long long>(b) * n_calls + k) * 2 + 1];
    }
    block_combine(&v, &n, kind, fl);
    if (threadIdx.x == 0) {
      store_value(s.out[k], s.out_type[k], 0, v);
      s.out_valid[k][0] = kind == COUNT || n > 0;
    }
  }
}

__global__ void final_diff_kernel(Diff d, int n_items,
                                  unsigned char* emitted,
                                  signed char* ops, unsigned char* vis) {
  const bool em = *emitted;
  bool same = true;
  for (int k = 0; k < n_items; ++k) {
    const int w = type_width(d.type[k]);
    const bool cv = d.cur_valid[k] ? d.cur_valid[k][0] != 0 : true;
    const bool pv = d.prev_valid[k][0] != 0;
    bool eq;
    if (d.type[k] == T_F64) {
      eq = as_f(load_int(d.prev[k], 8, 0)) == as_f(load_int(d.cur[k], 8, 0));
    } else if (d.type[k] == T_BOOL) {
      eq = (static_cast<const unsigned char*>(d.prev[k])[0] != 0)
           == (static_cast<const unsigned char*>(d.cur[k])[0] != 0);
    } else {
      eq = load_int(d.prev[k], w, 0) == load_int(d.cur[k], w, 0);
    }
    same = same && pv == cv && (eq || !cv);
  }
  const bool changed = !(em && same);
  ops[0] = em ? 2 : 0;   // UpdateDelete : Insert
  ops[1] = em ? 3 : 0;   // UpdateInsert : Insert
  vis[0] = changed && em;
  vis[1] = changed;
  for (int k = 0; k < n_items; ++k) {
    const int w = type_width(d.type[k]);
    const unsigned char cv = d.cur_valid[k] ? d.cur_valid[k][0] != 0 : 1;
    rw_copy_elem(d.out[k], 0, d.prev[k], 0, w);
    rw_copy_elem(d.out[k], 1, d.cur[k], 0, w);
    d.out_valid[k][0] = d.prev_valid[k][0];
    d.out_valid[k][1] = cv;
    rw_copy_elem(d.prev[k], 0, d.cur[k], 0, w);
    d.prev_valid[k][0] = cv;
  }
  *emitted = 1;
}

}  // namespace

// partials must hold rw_final_blocks(c) x n_calls x 2 int64
extern "C" int rw_final_blocks(long long c) {
  const int nb = rw_blocks(c, kThreads);
  return nb < 1 ? 1 : (nb > kMaxBlocks ? kMaxBlocks : nb);
}

extern "C" int rw_final_reduce(
    const long long* sfk, const long long* perm, const int* count,
    const long long* sd, long long cd, const int* dn,
    const unsigned char* gexists, const int* gid, int n_preds,
    void* const* pred, void* const* pred_valid, int n_calls,
    const int* kinds, void* const* args, const int* arg_w,
    const int* arg_float, void* const* arg_valid, const int* state_float,
    void* const* out, const int* out_type, void* const* out_valid,
    long long* partials, long long c, void* stream_) {
  if (n_calls < 0 || n_calls > kMaxCalls || n_preds < 0 || n_preds > 2
      || cd <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  Args a = {};
  for (int p = 0; p < n_preds; ++p) {
    a.pred[p] = static_cast<const unsigned char*>(pred[p]);
    a.pred_valid[p] = static_cast<const unsigned char*>(pred_valid[p]);
  }
  for (int k = 0; k < n_calls; ++k) {
    a.kind[k] = kinds[k];
    a.arg[k] = args[k];
    a.arg_w[k] = arg_w[k];
    a.arg_float[k] = arg_float[k];
    a.arg_valid[k] = static_cast<const unsigned char*>(arg_valid[k]);
    a.state_float[k] = state_float[k];
    a.out[k] = out[k];
    a.out_type[k] = out_type[k];
    a.out_valid[k] = static_cast<unsigned char*>(out_valid[k]);
  }
  const int blocks = rw_final_blocks(c);
  final_rows_kernel<<<blocks, kThreads, 0, stream>>>(
      sfk, perm, count, sd, cd, dn, gexists, gid, n_preds, a, n_calls,
      partials, c);
  final_combine_kernel<<<1, kThreads, 0, stream>>>(a, n_calls, partials,
                                                   blocks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rw_final_diff(int n_items, void* const* cur,
                             void* const* cur_valid, const int* types,
                             void* const* prev, void* const* prev_valid,
                             unsigned char* emitted, void* const* out,
                             void* const* out_valid, signed char* ops,
                             unsigned char* vis, void* stream) {
  if (n_items < 0 || n_items > kMaxItems) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Diff d = {};
  for (int k = 0; k < n_items; ++k) {
    d.cur[k] = cur[k];
    d.cur_valid[k] = static_cast<const unsigned char*>(cur_valid[k]);
    d.type[k] = types[k];
    d.prev[k] = prev[k];
    d.prev_valid[k] = static_cast<unsigned char*>(prev_valid[k]);
    d.out[k] = out[k];
    d.out_valid[k] = static_cast<unsigned char*>(out_valid[k]);
  }
  final_diff_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      d, n_items, emitted, ops, vis);
  return static_cast<int>(cudaGetLastError());
}
