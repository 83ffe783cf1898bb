// K31 — the device vnode and the backfill's live-side filter.
//
// Replaces two JAX programs:
//   * risingwave_tpu/common/vnode.py:compute_vnodes (58): vnode = a
//     splitmix64 chain over the key columns, mod 256. Each column is
//     widened as `col.view(uint{width}).astype(uint64)` widens it: an
//     int32 is reinterpreted as uint32 and ZERO-extended, a float64 is
//     hashed by its bit pattern (-0.0 and +0.0 differ, NaN payloads
//     count), a bool is 0/1.
//   * risingwave_tpu/stream/backfill.py:BackfillExecutor._filter_impl
//     (81): keep a visible live row when the snapshot scan already
//     covered it,
//       vn < cur  OR  (vn == cur AND has_pk AND pk <= last_pk),
//     with the pk compare lexicographic over the pk columns and each
//     column compared by plain IEEE `<` and `==` (-0.0 equals +0.0, a
//     NaN on either side compares false), as the jitted program does.
//
// Entries: rw_compute_vnodes ([N] int32 vnodes of 1-4 key columns) and
// rw_backfill_filter (the fused mask: the vnode of the distribution key
// and the pk compare in one pass, visibility out).
//
// What bounds it on the H100: bytes. A row reads its key columns (8 B
// an int64 or float64, 4 an int32, 1 a bool) and writes a 4-byte vnode,
// or reads its distribution and pk columns and its visibility byte and
// writes one: ~18 B a row for one int64 key, 2.4 MB for a 131072-row
// chunk, 0.7 us at 3.35 TB/s. The splitmix chain is four 64-bit
// multiplies a column, far under the card's integer rate.
//
// Design: one thread a row, no shared memory. The column tables and the
// pk frontier ride in by-value structs, so a launch copies nothing from
// the host.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 4;
constexpr u64 kVnodeSeed = 0x243F6A8885A308D3ULL;
constexpr u64 kGolden = 0x9E3779B97F4A7C15ULL;
constexpr int kVnodeMask = 255;

// element type codes (common/vnode.py's VNODE_TYPES)
enum { T_I64 = 0, T_I32 = 1, T_I16 = 2, T_I8 = 3, T_BOOL = 4, T_F64 = 5 };

struct Cols {
  const void* p[kMaxCols];
  int type[kMaxCols];
  int n;
};

struct Frontier {
  const void* p[kMaxCols];
  int type[kMaxCols];
  i64 val[kMaxCols];  // the last pk: integers by value, float64 by bits
  int n;
};

// Element i as compute_vnodes widens it: the unsigned view of its own
// width, zero-extended.
__device__ __forceinline__ u64 vnode_lane(const void* c, int t,
                                          long long i) {
  switch (t) {
    case T_I32:
      return static_cast<u64>(static_cast<const unsigned int*>(c)[i]);
    case T_I16:
      return static_cast<u64>(static_cast<const unsigned short*>(c)[i]);
    case T_I8:
      return static_cast<u64>(static_cast<const unsigned char*>(c)[i]);
    case T_BOOL:
      return static_cast<const unsigned char*>(c)[i] != 0 ? 1ULL : 0ULL;
    default:  // int64 and float64: the 64 bits as they are
      return static_cast<const u64*>(c)[i];
  }
}

__device__ __forceinline__ int vnode_of(const Cols& k, long long i) {
  u64 h = kVnodeSeed;
  for (int j = 0; j < k.n; ++j) {
    h = rw_splitmix64(h ^ (vnode_lane(k.p[j], k.type[j], i) * kGolden));
  }
  return static_cast<int>(h & kVnodeMask);
}

// (column < v, column == v) for element i in the column's own type.
__device__ __forceinline__ void compare(const void* c, int t, i64 v,
                                        long long i, bool* lt, bool* eq) {
  if (t == T_F64) {
    const double x = static_cast<const double*>(c)[i];
    const double y = __longlong_as_double(v);
    *lt = x < y;
    *eq = x == y;
    return;
  }
  i64 x;
  switch (t) {
    case T_I64: x = static_cast<const i64*>(c)[i]; break;
    case T_I32: x = static_cast<const int*>(c)[i]; break;
    case T_I16: x = static_cast<const short*>(c)[i]; break;
    case T_I8: x = static_cast<const signed char*>(c)[i]; break;
    default: x = static_cast<const unsigned char*>(c)[i] != 0; break;
  }
  *lt = x < v;
  *eq = x == v;
}

__global__ void __launch_bounds__(kThreads)
vnodes_kernel(Cols k, long long n, int* __restrict__ out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) out[i] = vnode_of(k, i);
}

__global__ void __launch_bounds__(kThreads)
backfill_filter_kernel(Cols dist, Frontier pk, i64 cur, int has_pk,
                       const unsigned char* __restrict__ vis, long long n,
                       unsigned char* __restrict__ out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  bool keep = false;
  if (vis[i]) {
    const i64 vn = vnode_of(dist, i);
    if (vn < cur) {
      keep = true;
    } else if (vn == cur && has_pk) {
      // le over the pk columns, last to first, as the reference folds it
      bool le = true;
      for (int j = pk.n - 1; j >= 0; --j) {
        bool lt, eq;
        compare(pk.p[j], pk.type[j], pk.val[j], i, &lt, &eq);
        le = lt || (eq && le);
      }
      keep = le;
    }
  }
  out[i] = keep ? 1 : 0;
}

bool fill(Cols* c, const void* const* p, const int* types, int n) {
  if (n < 1 || n > kMaxCols) return false;
  c->n = n;
  for (int j = 0; j < n; ++j) {
    c->p[j] = p[j];
    c->type[j] = types[j];
  }
  return true;
}

}  // namespace

extern "C" int rw_compute_vnodes(const void* const* cols, const int* types,
                                 int ncols, long long n, int* out,
                                 void* stream) {
  Cols k;
  if (!fill(&k, cols, types, ncols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    vnodes_kernel<<<rw_blocks(n, kThreads), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(k, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rw_backfill_filter(const void* const* dist,
                                  const int* dist_types, int ndist,
                                  const void* const* pk, const int* pk_types,
                                  const long long* pk_vals, int npk,
                                  long long cur, int has_pk,
                                  const unsigned char* vis, long long n,
                                  unsigned char* out, void* stream) {
  Cols d;
  if (!fill(&d, dist, dist_types, ndist) || npk < 1 || npk > kMaxCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Frontier f;
  f.n = npk;
  for (int j = 0; j < npk; ++j) {
    f.p[j] = pk[j];
    f.type[j] = pk_types[j];
    f.val[j] = pk_vals[j];
  }
  if (n > 0) {
    backfill_filter_kernel<<<rw_blocks(n, kThreads), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        d, f, cur, has_pk, vis, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}
