// K27 — the hash agg's barrier flush: the changelog of the groups touched
// since the last barrier, and the refresh of what was emitted.
//
// Replaces risingwave_tpu/stream/hash_agg.py:300 _flush_impl, with
// ops/extrema.py:156 extrema_emit for retractable MIN/MAX calls. On the
// TPU that is one XLA program over all C slots after a cumsum-scatter
// compaction of the dirty bits.
//
// Contract (the port's agg_flush_plain, stream/hash_agg.py): given K12's
// compaction of the dirty bits (sel[0..n) the dirty slots in slot order),
// for each rank j < n with slot s = sel[j]:
//   existed = prev_exists[s], exists = row_count[s] > 0;
//   each call's emitted value: a linear call's state, a retractable
//   call's buffer head vals[s, 0] where cnts[s, 0] > 0 and its identity
//   otherwise, cast to the call's output type;
//   unchanged = existed and exists and every emitted value equals the
//   last one (prev_emit[s]) as the JAX package's CPU programs compare
//   (NaN never equal, zeros and subnormals equal);
//   row 2j = (exists ? UpdateDelete : Delete, visible iff existed and
//   not unchanged, the keys, the last values), row 2j + 1 = (existed ?
//   UpdateInsert : Insert, visible iff exists and not unchanged, the
//   keys, the new values); then prev_exists[s] = exists, prev_emit[s] =
//   the new values, dirty[s] = false.
// Rows 2j, 2j + 1 for j >= n are invisible Delete/Insert rows of zeros.
// Slots that are not dirty keep their prev_exists and prev_emit (the JAX
// package rewrites them with equal values, but for the zeroed emitted
// values of groups the cleaning watermark evicted, which no later flush
// reads: a slot it evicted is re-emitted only after prev_exists is set).
//
// What bounds it on the H100: bytes. It writes 2C output rows (ops, vis,
// keys, values) and reads and writes the dirty slots' state: at q5's C =
// 2^20 with two int64 keys and one count, 2^21 x 26 bytes = 55 MB, ~16 us
// at 3.35 TB/s.
//
// Design: one thread per rank j, one launch, no host sync (n is read on
// the device). A thread reads its dirty slot's state, writes its two
// output rows, then refreshes that slot; no two threads share a slot.
// A launch takes at most kMaxCalls calls. A longer list is split across
// launches over the same ranks: each writes its calls' output columns
// and refreshes their prev_emit, and carries "every value so far equal"
// per rank in eq[j] to the next; the last also writes ops, vis and the
// keys and refreshes prev_exists and dirty.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxKeys = 4;
constexpr int kMaxCalls = 32;

enum Type { T_I32 = 1, T_I64 = 2, T_F32 = 3, T_F64 = 4 };

struct Calls {
  int n;
  int kind[kMaxCalls];           // 0 linear state, 1 top-K buffer
  const void* state[kMaxCalls];  // [C] state, or [C, K] buffer values
  const int* cnts[kMaxCalls];    // [C, K] buffer counts
  int k[kMaxCalls];              // buffer width
  int state_float[kMaxCalls];    // state (or buffer values) is float64
  i64 init[kMaxCalls];           // identity, in the state's bits
  int ret[kMaxCalls];            // output type
  void* prev_emit[kMaxCalls];    // [C] of the output type
  void* out[kMaxCalls];          // [2C] of the output type
};

struct Keys {
  int n;
  const void* col[kMaxKeys];
  int width[kMaxKeys];
  void* out[kMaxKeys];           // [2C]
};

// The emitted value as 64 bits of the output type (floats as float64
// bits, float32 outputs rounded to float32 first; as XLA's CPU cast does,
// a float32 subnormal result becomes a zero of its sign).
__device__ __forceinline__ i64 to_ret(i64 bits, bool is_float, int ret) {
  if (is_float) {
    const double x = __longlong_as_double(bits);
    if (ret == T_F32) {
      float f = static_cast<float>(x);
      if (fabsf(f) < RW_TINY_F32) f = copysignf(0.0f, f);
      return __double_as_longlong(static_cast<double>(f));
    }
    return bits;
  }
  return ret == T_I32 ? static_cast<i64>(static_cast<int>(bits)) : bits;
}

__device__ __forceinline__ i64 load_ret(const void* p, int ret, long long i) {
  switch (ret) {
    case T_I32: return static_cast<const int*>(p)[i];
    case T_I64: return static_cast<const i64*>(p)[i];
    case T_F32:
      return __double_as_longlong(
          static_cast<double>(static_cast<const float*>(p)[i]));
    default: return static_cast<const i64*>(p)[i];
  }
}

__device__ __forceinline__ void store_ret(void* p, int ret, long long i,
                                          i64 bits) {
  switch (ret) {
    case T_I32: static_cast<int*>(p)[i] = static_cast<int>(bits); break;
    case T_F32:
      static_cast<float*>(p)[i] =
          static_cast<float>(__longlong_as_double(bits));
      break;
    default: static_cast<i64*>(p)[i] = bits;
  }
}

// `a == b` of two values of the output type as XLA computes it on the
// CPU: subnormals of that type equal zero, NaN equals nothing.
__device__ __forceinline__ bool same(i64 a, i64 b, int ret) {
  if (ret == T_I32 || ret == T_I64) return a == b;
  return rw_float_eq(__longlong_as_double(a), __longlong_as_double(b),
                     ret == T_F32 ? RW_TINY_F32 : RW_TINY_F64);
}

__device__ __forceinline__ void store_raw(void* p, int width, long long i,
                                          i64 v) {
  switch (width) {
    case 8: static_cast<i64*>(p)[i] = v; break;
    case 4: static_cast<int*>(p)[i] = static_cast<int>(v); break;
    case 2: static_cast<short*>(p)[i] = static_cast<short>(v); break;
    default: static_cast<signed char*>(p)[i] = static_cast<signed char>(v);
  }
}

__device__ __forceinline__ i64 load_raw(const void* p, int width,
                                        long long i) {
  switch (width) {
    case 8: return static_cast<const i64*>(p)[i];
    case 4: return static_cast<const int*>(p)[i];
    case 2: return static_cast<const short*>(p)[i];
    default: return static_cast<const signed char*>(p)[i];
  }
}

__global__ void __launch_bounds__(kThreads)
flush_kernel(long long C, const i64* __restrict__ sel,
             const i64* __restrict__ n_dirty,
             const i64* __restrict__ row_count, bool* __restrict__ dirty,
             bool* __restrict__ prev_exists, Keys keys, Calls calls,
             signed char* __restrict__ out_ops, bool* __restrict__ out_vis,
             bool* __restrict__ eq, bool first, bool last) {
  const long long j = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (j >= C) return;
  const long long o = 2 * j;
  if (j >= *n_dirty) {
    if (last) {
      out_ops[o] = 1;
      out_ops[o + 1] = 0;
      out_vis[o] = false;
      out_vis[o + 1] = false;
      for (int c = 0; c < keys.n; ++c) {
        store_raw(keys.out[c], keys.width[c], o, 0);
        store_raw(keys.out[c], keys.width[c], o + 1, 0);
      }
    }
    for (int c = 0; c < calls.n; ++c) {
      store_ret(calls.out[c], calls.ret[c], o, 0);
      store_ret(calls.out[c], calls.ret[c], o + 1, 0);
    }
    return;
  }
  const long long s = sel[j];
  i64 cur[kMaxCalls];
  i64 old[kMaxCalls];
  bool unchanged = first || eq[j];
  for (int c = 0; c < calls.n; ++c) {
    const bool fl = calls.state_float[c] != 0;
    i64 bits;
    if (calls.kind[c] == 0) {
      bits = static_cast<const i64*>(calls.state[c])[s];
    } else {
      const long long at = s * calls.k[c];
      bits = calls.cnts[c][at] > 0
                 ? static_cast<const i64*>(calls.state[c])[at]
                 : calls.init[c];
    }
    cur[c] = to_ret(bits, fl, calls.ret[c]);
    old[c] = load_ret(calls.prev_emit[c], calls.ret[c], s);
    unchanged = unchanged && same(cur[c], old[c], calls.ret[c]);
  }
  for (int c = 0; c < calls.n; ++c) {
    store_ret(calls.out[c], calls.ret[c], o, old[c]);
    store_ret(calls.out[c], calls.ret[c], o + 1, cur[c]);
    store_ret(calls.prev_emit[c], calls.ret[c], s, cur[c]);
  }
  if (!last) {
    eq[j] = unchanged;
    return;
  }
  const bool existed = prev_exists[s];
  const bool exists = row_count[s] > 0;
  unchanged = unchanged && existed && exists;
  out_ops[o] = exists ? 2 : 1;          // UpdateDelete : Delete
  out_ops[o + 1] = existed ? 3 : 0;     // UpdateInsert : Insert
  out_vis[o] = existed && !unchanged;
  out_vis[o + 1] = exists && !unchanged;
  for (int c = 0; c < keys.n; ++c) {
    const i64 k = load_raw(keys.col[c], keys.width[c], s);
    store_raw(keys.out[c], keys.width[c], o, k);
    store_raw(keys.out[c], keys.width[c], o + 1, k);
  }
  prev_exists[s] = exists;
  dirty[s] = false;
}

}  // namespace

// The flush over K12's compaction (sel, n_dirty on the device). Per
// call: kind, state pointer, buffer counts and width (retractable calls),
// float64 state flag, identity bits, output type, prev_emit and output
// column; per key: column, width in bytes, output column. first/last:
// this launch's place in a split call list (both for a whole one); eq
// is a [C] scratch the parts of a split list share (else unused).
extern "C" int rw_agg_flush(long long C, const long long* sel,
                            const long long* n_dirty,
                            const long long* row_count, bool* dirty,
                            bool* prev_exists, int n_keys,
                            const void* const* key_cols,
                            const int* key_widths, void* const* key_out,
                            int n_calls, const int* kinds,
                            const void* const* states,
                            const void* const* cnts, const int* ks,
                            const int* state_float,
                            const long long* inits, const int* rets,
                            void* const* prev_emit, void* const* outs,
                            signed char* out_ops, bool* out_vis,
                            bool* eq, int first, int last, void* stream) {
  if (C < 1 || n_keys < 0 || n_keys > kMaxKeys || n_calls < 0
      || n_calls > kMaxCalls || ((!first || !last) && eq == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Keys k = {};
  k.n = n_keys;
  for (int c = 0; c < n_keys; ++c) {
    k.col[c] = key_cols[c];
    k.width[c] = key_widths[c];
    k.out[c] = key_out[c];
  }
  Calls a = {};
  a.n = n_calls;
  for (int c = 0; c < n_calls; ++c) {
    if (rets[c] < T_I32 || rets[c] > T_F64 || (kinds[c] == 1 && ks[c] < 1)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.kind[c] = kinds[c];
    a.state[c] = states[c];
    a.cnts[c] = static_cast<const int*>(cnts[c]);
    a.k[c] = ks[c];
    a.state_float[c] = state_float[c];
    a.init[c] = inits[c];
    a.ret[c] = rets[c];
    a.prev_emit[c] = prev_emit[c];
    a.out[c] = outs[c];
  }
  flush_kernel<<<rw_blocks(C, kThreads), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      C, sel, n_dirty, row_count, dirty, prev_exists, k, a, out_ops,
      out_vis, eq, first != 0, last != 0);
  return static_cast<int>(cudaGetLastError());
}
