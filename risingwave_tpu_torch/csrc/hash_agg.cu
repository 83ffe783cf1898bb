// K4 — hash-agg chunk apply: signed per-slot reductions into the state.
//
// Replaces risingwave_tpu/stream/hash_agg.py:HashAggExecutor._apply_impl
// (248) with expr/agg.py:AggSpec.partial (74) / combine (93): on the TPU a
// segment_sum of op signs into row_count, one segment reduction per agg
// call combined into its state, a dirty-bit scatter and the overflow
// accumulator.
//
// What bounds it on the H100: atomics on a handful of addresses. A q5
// chunk (655360 rows after HOP) touches a few hundred slots, and nearly
// every warp of consecutive rows hits one slot, so per-row atomicAdd on
// row_count and the count would serialize ~20 K-deep on each hot
// address. The byte bound (slots + ops read once, the touched slots'
// state read and written once) is about 1 us.
//
// Design: one thread per row. Lanes of a warp that share a slot
// (__match_any_sync) reduce their contributions by shuffles, and only
// the group's first lane issues one atomic per distinct slot per warp:
// atomicAdd on unsigned long long for signed counts and integer sums
// (two's complement), atomicMin/atomicMax on long long for append-only
// integer extrema, atomicAdd(double) for float sums (the order of a
// float sum varies from run to run) and a CAS loop for float extrema.
// The dirty bit is a plain byte store by the same lane. Thread 0 adds
// the chunk's n_unresolved (from K3, on the device) to the overflow
// accumulator, so the whole apply needs no host sync.
//
// A launch takes at most kMaxCalls calls; a longer list is split across
// launches, the first of which alone updates row_count, dirty and
// overflow (the later ones get row_count == nullptr).

#include "common.cuh"

namespace {

constexpr int kMaxCalls = 32;
constexpr int kThreads = 256;
constexpr long long kPosInfBits = 0x7ff0000000000000LL;
constexpr long long kNegInfBits = static_cast<long long>(0xfff0000000000000ULL);

enum Kind { COUNT = 0, SUM_I64 = 1, SUM_F64 = 2, MIN_I64 = 3, MAX_I64 = 4,
            MIN_F64 = 5, MAX_F64 = 6 };
enum VType { V_NONE = 0, V_I32 = 1, V_I64 = 2, V_F32 = 3, V_F64 = 4 };

struct Calls {
  int kind[kMaxCalls];
  void* state[kMaxCalls];
  const void* values[kMaxCalls];
  int vtype[kMaxCalls];
  const unsigned char* valid[kMaxCalls];
  int n;
};

template <typename T>
__device__ __forceinline__ T group_sum(unsigned grp, T v) {
  T acc = 0;
  for (unsigned m = grp; m; m &= m - 1) acc += __shfl_sync(grp, v, __ffs(m) - 1);
  return acc;
}

template <typename T>
__device__ __forceinline__ T group_min(unsigned grp, T v) {
  T acc = v;
  for (unsigned m = grp; m; m &= m - 1) {
    const T o = __shfl_sync(grp, v, __ffs(m) - 1);
    acc = o < acc ? o : acc;
  }
  return acc;
}

template <typename T>
__device__ __forceinline__ T group_max(unsigned grp, T v) {
  T acc = v;
  for (unsigned m = grp; m; m &= m - 1) {
    const T o = __shfl_sync(grp, v, __ffs(m) - 1);
    acc = o > acc ? o : acc;
  }
  return acc;
}

__device__ __forceinline__ i64 load_i64(const void* p, int vt, long long i) {
  switch (vt) {
    case V_I32: return static_cast<const int*>(p)[i];
    case V_I64: return static_cast<const i64*>(p)[i];
    case V_F32: return static_cast<i64>(static_cast<const float*>(p)[i]);
    case V_F64: return static_cast<i64>(static_cast<const double*>(p)[i]);
    default: return 0;
  }
}

__device__ __forceinline__ double load_f64(const void* p, int vt,
                                           long long i) {
  switch (vt) {
    case V_I32: return static_cast<double>(static_cast<const int*>(p)[i]);
    case V_I64: return static_cast<double>(static_cast<const i64*>(p)[i]);
    case V_F32: return static_cast<double>(static_cast<const float*>(p)[i]);
    case V_F64: return static_cast<const double*>(p)[i];
    default: return 0.0;
  }
}

__device__ __forceinline__ void atomic_add_i64(i64* addr, i64 v) {
  atomicAdd(reinterpret_cast<u64*>(addr), static_cast<u64>(v));
}

__device__ __forceinline__ void atomic_min_f64(double* addr, double v) {
  u64* a = reinterpret_cast<u64*>(addr);
  u64 old = *a;
  while (v < __longlong_as_double(static_cast<i64>(old))) {
    const u64 prev = atomicCAS(a, old, static_cast<u64>(__double_as_longlong(v)));
    if (prev == old) break;
    old = prev;
  }
}

__device__ __forceinline__ void atomic_max_f64(double* addr, double v) {
  u64* a = reinterpret_cast<u64*>(addr);
  u64 old = *a;
  while (v > __longlong_as_double(static_cast<i64>(old))) {
    const u64 prev = atomicCAS(a, old, static_cast<u64>(__double_as_longlong(v)));
    if (prev == old) break;
    old = prev;
  }
}

__global__ void agg_apply_kernel(const int* __restrict__ slots,
                                 const signed char* __restrict__ ops, int N,
                                 i64* row_count, unsigned char* dirty,
                                 Calls calls,
                                 const int* __restrict__ n_unresolved,
                                 int* overflow) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const bool in = tid < N;
  const int s = in ? slots[tid] : -1;
  int sign = 0;
  if (s >= 0) {
    const int op = ops[tid];
    sign = (op == 0 || op == 3) ? 1 : -1;   // Insert / UpdateInsert
  }
  const unsigned grp = __match_any_sync(RW_FULL_MASK, s);
  const bool lead = (threadIdx.x & 31) == __ffs(grp) - 1 && s >= 0;

  if (row_count != nullptr) {
    if (tid == 0) *overflow += *n_unresolved;
    const i64 rc = group_sum<i64>(grp, sign);
    if (lead) {
      if (rc != 0) atomic_add_i64(&row_count[s], rc);
      dirty[s] = 1;
    }
  }
  for (int j = 0; j < calls.n; ++j) {
    const bool valid = in && (calls.valid[j] == nullptr || calls.valid[j][tid]);
    const int rs = valid ? sign : 0;
    const int kind = calls.kind[j];
    const void* vals = calls.values[j];
    const int vt = calls.vtype[j];
    if (kind == COUNT) {
      const i64 c = group_sum<i64>(grp, rs);
      if (lead && c != 0) atomic_add_i64(&static_cast<i64*>(calls.state[j])[s], c);
    } else if (kind == SUM_I64) {
      const i64 x = rs != 0 ? rs * load_i64(vals, vt, tid) : 0;
      const i64 t = group_sum<i64>(grp, x);
      if (lead && t != 0) atomic_add_i64(&static_cast<i64*>(calls.state[j])[s], t);
    } else if (kind == SUM_F64) {
      const double x = rs != 0 ? rs * load_f64(vals, vt, tid) : 0.0;
      const double t = group_sum<double>(grp, x);
      if (lead) atomicAdd(&static_cast<double*>(calls.state[j])[s], t);
    } else if (kind == MIN_I64 || kind == MAX_I64) {
      const bool is_min = kind == MIN_I64;
      const i64 ident = is_min ? INT64_MAX : INT64_MIN;
      const i64 x = rs > 0 ? load_i64(vals, vt, tid) : ident;
      const i64 t = is_min ? group_min<i64>(grp, x) : group_max<i64>(grp, x);
      if (lead && t != ident) {
        i64* st = &static_cast<i64*>(calls.state[j])[s];
        if (is_min) atomicMin(reinterpret_cast<long long*>(st), t);
        else atomicMax(reinterpret_cast<long long*>(st), t);
      }
    } else {  // MIN_F64 / MAX_F64
      const bool is_min = kind == MIN_F64;
      const double ident = is_min ? __longlong_as_double(kPosInfBits)
                                  : __longlong_as_double(kNegInfBits);
      const double x = rs > 0 ? load_f64(vals, vt, tid) : ident;
      const double t = is_min ? group_min<double>(grp, x)
                              : group_max<double>(grp, x);
      if (lead && t != ident) {
        double* st = &static_cast<double*>(calls.state[j])[s];
        if (is_min) atomic_min_f64(st, t);
        else atomic_max_f64(st, t);
      }
    }
  }
}

}  // namespace

// row_count == nullptr: a later launch of a split call list, which
// leaves row_count, dirty and overflow to the first.
extern "C" int rw_agg_apply(const int* slots, const signed char* ops, int N,
                            long long* row_count, unsigned char* dirty,
                            int n_calls, const int* kinds,
                            void* const* states, void* const* values,
                            const int* vtypes, void* const* valids,
                            const int* n_unresolved, int* overflow,
                            void* stream) {
  if (n_calls < 0 || n_calls > kMaxCalls) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Calls calls;
  calls.n = n_calls;
  for (int j = 0; j < n_calls; ++j) {
    calls.kind[j] = kinds[j];
    calls.state[j] = states[j];
    calls.values[j] = values[j];
    calls.vtype[j] = vtypes[j];
    calls.valid[j] = static_cast<const unsigned char*>(valids[j]);
  }
  const int blocks = N > 0 ? rw_blocks(N, kThreads) : 1;
  agg_apply_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      slots, ops, N, row_count, dirty, calls, n_unresolved, overflow);
  return static_cast<int>(cudaGetLastError());
}
