// K33 — the hash join's own-side update, two entries: the deletes'
// tombstones and the inserts' row allocation and chain link.
//
// Replaces risingwave_tpu/stream/hash_join.py:_apply_impl (290), lines
// 371-399 (the delete chain walk with its claim contest), and
// _bulk_insert (101: rows at top + rank, chains linked by a sort of the
// batch by key slot), which the rehash (_rehash_impl, 885) calls too.
//
// delete — one thread an effective delete (the netted run's first row,
//   if a retraction): walk the key's chain from its head to the first
//   live stored row whose pk equals the row's (float64 with IEEE `==`)
//   and claim it by clearing its live byte with an atomicAnd on the
//   byte's 32-bit word, so at most one delete consumes a row; the
//   winner sets the row dirty; a delete that claims nothing counts in
//   errs[1]. Netting leaves at most one delete per pk a chunk, so no two
//   deletes contend for a row unless the store holds duplicate pks.
// insert — a scan of the insert mask ranks the inserts in chunk order,
//   so row top + rank is the reference's row id for every insert and the
//   row store, its persisted bytes included, is the reference's. A row
//   below the capacity gets its columns, valids, live and dirty bytes;
//   with slots it is linked into its key's chain by an atomicExch on the
//   key's head (the chain is an unordered multimap, so the order inside
//   a chain may differ from the reference's: ROADMAP accepted difference
//   11). A one-thread launch then adds the overflow to errs[3] and
//   advances top, clamped to the capacity.
//
// What bounds it on the H100: bytes. An insert reads its row's columns
// and writes them once, plus its next link; a delete reads its chain's
// next, live and pk lanes up to its victim. At a 131072-row chunk of 4
// int64 columns that is ~10 MB, ~3 us at 3.35 TB/s.

#include "key_hash.cuh"
#include "scan.cuh"

namespace {

constexpr int kMaxCols = 16;
constexpr int kMaxPk = 4;

struct PkCols {
  const void* chunk[kMaxPk];
  const void* store[kMaxPk];
  int type[kMaxPk];
  int n;
};

__device__ __forceinline__ bool pk_eq(const PkCols& pk, long long row,
                                      long long stored) {
  for (int k = 0; k < pk.n; ++k) {
    if (pk.type[k] == RW_F64) {
      if (!rw_float_eq(static_cast<const double*>(pk.chunk[k])[row],
                       static_cast<const double*>(pk.store[k])[stored])) {
        return false;
      }
    } else if (rw_lane_u64(pk.chunk[k], pk.type[k], row)
               != rw_lane_u64(pk.store[k], pk.type[k], stored)) {
      return false;
    }
  }
  return true;
}

__global__ void __launch_bounds__(kScanThreads)
hj_delete(PkCols pk, const unsigned char* __restrict__ is_del,
          const int* __restrict__ slots, long long n,
          const int* __restrict__ head, const int* __restrict__ next,
          unsigned char* live, unsigned char* __restrict__ dirty,
          int* errs) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kScanThreads + threadIdx.x;
  if (i >= n || !is_del[i]) return;
  bool found = false;
  const int slot = slots[i];
  if (slot >= 0) {
    for (int cur = head[slot]; cur >= 0; cur = next[cur]) {
      if (!*static_cast<volatile unsigned char*>(live + cur)) continue;
      if (!pk_eq(pk, i, cur)) continue;
      unsigned* word = reinterpret_cast<unsigned*>(
          live + (static_cast<long long>(cur) & ~3LL));
      const unsigned shift = (cur & 3) * 8;
      const unsigned old = atomicAnd(word, ~(0xFFu << shift));
      if ((old >> shift) & 0xFFu) {
        dirty[cur] = 1;
        found = true;
        break;
      }
    }
  }
  if (!found) atomicAdd(&errs[1], 1);
}

struct RowCols {
  const void* in[kMaxCols];
  const unsigned char* in_valid[kMaxCols];   // null: all valid
  void* rows[kMaxCols];
  unsigned char* row_valid[kMaxCols];
  int width[kMaxCols];
  int n;
};

__global__ void __launch_bounds__(kScanThreads)
hj_ins_count(const unsigned char* __restrict__ ins, long long n,
             int* __restrict__ sums, long long nb) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kScanThreads + threadIdx.x;
  int total;
  rw_block_scan<int>(i < n && ins[i] ? 1 : 0, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
  if (blockIdx.x == 0 && threadIdx.x == 0) sums[nb] = 0;
}

__global__ void __launch_bounds__(kScanThreads)
hj_ins_write(RowCols rc, const unsigned char* __restrict__ ins,
             const int* __restrict__ slots, long long n,
             int write_valids, unsigned char live_val,
             const unsigned char* __restrict__ dirty_src,
             int* __restrict__ next, int* head,
             unsigned char* __restrict__ live,
             unsigned char* __restrict__ dirty, const int* __restrict__ top,
             long long cr, const int* __restrict__ sums) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kScanThreads + threadIdx.x;
  const bool on = i < n && ins[i];
  const int incl = rw_block_scan<int>(on ? 1 : 0, static_cast<int*>(nullptr));
  if (!on) return;
  const long long r = static_cast<long long>(*top) + sums[blockIdx.x]
                      + incl - 1;
  if (r >= cr) return;
  for (int c = 0; c < rc.n; ++c) {
    rw_copy_elem(rc.rows[c], r, rc.in[c], i, rc.width[c]);
    if (write_valids) {
      rc.row_valid[c][r] = rc.in_valid[c] ? rc.in_valid[c][i] : 1;
    }
  }
  live[r] = live_val;
  dirty[r] = dirty_src ? dirty_src[i] : 1;
  if (slots) {
    const int slot = slots[i];
    if (slot >= 0) next[r] = atomicExch(&head[slot], static_cast<int>(r));
  }
}

__global__ void hj_ins_finish(int* top, long long cr,
                              const int* __restrict__ sums, long long nb,
                              int* errs) {
  const long long after = static_cast<long long>(*top) + sums[nb];
  if (errs && after > cr) atomicAdd(&errs[3], static_cast<int>(after - cr));
  *top = static_cast<int>(after < cr ? after : cr);
}

}  // namespace

extern "C" int rw_hj_delete(int n_pk, void* const* pk_chunk,
                            void* const* pk_store, const int* pk_types,
                            const unsigned char* is_del, const int* slots,
                            long long n, const int* head, const int* next,
                            unsigned char* live, unsigned char* dirty,
                            int* errs, void* stream) {
  if (n_pk < 1 || n_pk > kMaxPk || n < 1 ||
      (reinterpret_cast<unsigned long long>(live) & 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PkCols pk;
  pk.n = n_pk;
  for (int k = 0; k < kMaxPk; ++k) {
    pk.chunk[k] = k < n_pk ? pk_chunk[k] : nullptr;
    pk.store[k] = k < n_pk ? pk_store[k] : nullptr;
    pk.type[k] = k < n_pk ? pk_types[k] : RW_I64;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  hj_delete<<<static_cast<unsigned>(rw_blocks(n, kScanThreads)),
              kScanThreads, 0, s>>>(pk, is_del, slots, n, head, next, live,
                                    dirty, errs);
  return static_cast<int>(cudaGetLastError());
}

// sums holds ceil(n / 256) + 1 ints. slots null: no chain link; valids
// entries null: valid; dirty_src null: dirty set; errs null: the
// overflow is not counted.
extern "C" int rw_hj_insert(const unsigned char* ins, const int* slots,
                            long long n, int ncols, void* const* cols,
                            void* const* valids, const int* widths,
                            int write_valids, int live_val,
                            const unsigned char* dirty_src,
                            void* const* rows, void* const* row_valids,
                            int* next, int* head, unsigned char* live,
                            unsigned char* dirty, int* top, long long cr,
                            int* sums, int* errs, void* stream) {
  if (ncols < 1 || ncols > kMaxCols || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RowCols rc;
  rc.n = ncols;
  for (int c = 0; c < kMaxCols; ++c) {
    const bool on = c < ncols;
    rc.in[c] = on ? cols[c] : nullptr;
    rc.in_valid[c] = on ? static_cast<const unsigned char*>(valids[c])
                        : nullptr;
    rc.rows[c] = on ? rows[c] : nullptr;
    rc.row_valid[c] = on ? static_cast<unsigned char*>(row_valids[c])
                         : nullptr;
    rc.width[c] = on ? widths[c] : 8;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nb = (n + kScanThreads - 1) / kScanThreads;
  hj_ins_count<<<static_cast<unsigned>(nb), kScanThreads, 0, s>>>(
      ins, n, sums, nb);
  rw_scan_sums<int><<<1, kSumsThreads, 0, s>>>(sums, nb + 1);
  hj_ins_write<<<static_cast<unsigned>(nb), kScanThreads, 0, s>>>(
      rc, ins, slots, n, write_valids, static_cast<unsigned char>(live_val),
      dirty_src, next, head, live, dirty, top, cr, sums);
  hj_ins_finish<<<1, 1, 0, s>>>(top, cr, sums, nb, errs);
  return static_cast<int>(cudaGetLastError());
}
