// K26 — retractable MIN/MAX: one chunk's rows into each group's buffer of
// its K best distinct values and their multiplicities.
//
// Replaces risingwave_tpu/ops/extrema.py:51 extrema_update, with
// _order_key (34) and extrema_underflow (163). On the TPU that is one XLA
// program: a lexsort of the rows by (group, order key), the net delta of
// each (group, value) run, per-sign candidate ranks, [C + 1, K] candidate
// scatters, and a stable [C, 3K] sort-combine-resort over EVERY group.
//
// Contract (the port's extrema_apply_plain, ops/extrema.py):
//   a row applies when its slot is >= 0; with a non-NULL value it adds
//   op_sign(op) to its (group, value) run, where values compare as the
//   JAX package's CPU programs compare them (NaN equals nothing, zeros
//   and subnormals are equal); per group the positive runs and the
//   negative runs are ranked in order-key order (order key: the value
//   for MIN, its complement or negation for MAX; floats mapped so that
//   zeros and subnormals tie and NaN sorts last); the K best of each
//   sign are merged with the stored cells (stored, then insert, then
//   delete candidates on order-key ties), equal neighbours combine into
//   the first, cells left negative count an error unless the buffer is
//   lossy, cells left at zero drop out, the best K are stored and a
//   spill past K makes the buffer lossy. Insert candidates ranked past K
//   make it lossy; delete candidates ranked past K count an error each.
//   A group the chunk touched (NULL-valued rows included) whose buffer is
//   empty, lossy, and whose row count (already updated by K4) is > 0
//   counts one more error. The errors are added to *err.
//
// What bounds it on the H100: bytes. The function reads every row's slot
// (4 bytes), the op and value of the rows it applies (9 bytes), and
// reads and writes the touched groups' buffers (K x 12 bytes + 1 each):
// at q5's MaxBids agg (a 2^21-row flush chunk of which 600,000 rows are
// U-/U+ pairs, ~6 windows touched) about 13.8 MB, ~4.1 us at 3.35 TB/s.
//
// Design: work in proportion to the rows and the touched groups, not to
// C. rw_extrema_keys writes per row an int64 order key and a group key
// (2g for a valued row of group g, 2g + 1 for a NULL-valued one, 2C for
// a row not applied); the wrapper sorts by (group key, order key) with
// two stable K11 passes, so each group's valued rows form one run in
// value order, followed by its NULL rows. rw_extrema_merge: each warp
// looks at 32 sorted rows; for every group that starts among them the
// warp walks the group's rows 256 at a time, 8 consecutive rows a lane
// (8 loads in flight a lane: the walk is latency-bound): leader flags by
// comparing neighbours, a lane's serial sums joined by a segmented warp
// scan (carried across tiles) give each run's net delta at its last row,
// warp prefix counts rank the positive and negative runs, and the first
// K of each sign land in shared memory.
// Lane 0 then merges the stored cells (copied to shared memory first, as
// the buffer is rewritten in place) with the two candidate lists by a
// three-way merge on the order key, combining equal neighbours as they
// stream past, and writes the buffer, the lossy flag and the errors (one
// atomic per group). One warp walks a whole group, so a group of 35k
// rows takes ~140 dependent tile loads.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 64;
constexpr int kRows = 8;      // rows a lane walks per tile

enum VType { V_I32 = 1, V_I64 = 2, V_F32 = 3, V_F64 = 4 };

// The value as 64 bits: integers widened, floats as float64 bits.
__device__ __forceinline__ i64 load_bits(const void* p, int vtype,
                                         long long i) {
  switch (vtype) {
    case V_I32: return static_cast<const int*>(p)[i];
    case V_I64: return static_cast<const i64*>(p)[i];
    case V_F32:
      return __double_as_longlong(
          static_cast<double>(static_cast<const float*>(p)[i]));
    default: return __double_as_longlong(static_cast<const double*>(p)[i]);
  }
}

__device__ __forceinline__ i64 order_key(i64 bits, bool is_max,
                                         bool is_float) {
  if (is_float) {
    const double x = __longlong_as_double(bits);
    return rw_float_key(is_max ? -x : x);
  }
  return is_max ? ~bits : bits;
}

// `a == b` as XLA computes it on the CPU.
__device__ __forceinline__ bool same(i64 a, i64 b, bool is_float) {
  if (!is_float) return a == b;
  return rw_float_eq(__longlong_as_double(a), __longlong_as_double(b));
}

__device__ __forceinline__ int op_sign(signed char op) {
  return (op == 0 || op == 3) ? 1 : -1;   // Insert, UpdateInsert
}

__global__ void __launch_bounds__(kThreads)
keys_kernel(long long N, const int* __restrict__ slots, const void* values,
            int vtype, const bool* __restrict__ valid, long long C,
            bool is_max, bool is_float, i64* __restrict__ okey,
            i64* __restrict__ skey) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (i >= N) return;
  const int s = slots[i];
  if (s < 0 || s >= C) {
    skey[i] = 2 * C;
    okey[i] = 0;
  } else if (valid != nullptr && !valid[i]) {
    skey[i] = 2 * static_cast<i64>(s) + 1;
    okey[i] = 0;
  } else {
    skey[i] = 2 * static_cast<i64>(s);
    okey[i] = order_key(load_bits(values, vtype, i), is_max, is_float);
  }
}

struct Buffers {
  i64* vals;              // [C, K], int64 or float64 bits
  int* cnts;              // [C, K]
  bool* lossy;            // [C]
  const i64* row_count;   // [C]
};

struct Merger {
  int K;
  bool is_max, is_float, lossy;
  i64* out_v;
  int* out_c;
  int n_out, errs;
  // the cell waiting for its neighbour to be seen (its count may grow)
  bool pending, open;     // open: the next equal cell adds to it
  i64 pv, prev;
  int pc;

  __device__ void finish_pending() {
    if (!pending) return;
    if (pc < 0 && !lossy) ++errs;
    if (pc > 0) {
      if (n_out < K) {
        out_v[n_out] = pv;
        out_c[n_out] = pc;
      }
      ++n_out;
    }
    pending = false;
  }

  // The next cell of the merged sequence (order-key order).
  __device__ void push(i64 v, int c) {
    if (pending && same(prev, v, is_float)) {
      if (open) pc += c;
      open = false;
      prev = v;
      return;
    }
    finish_pending();
    pending = open = true;
    pv = prev = v;
    pc = c;
  }
};

__global__ void __launch_bounds__(kThreads)
merge_kernel(long long N, const i64* __restrict__ order,
             const i64* __restrict__ skey_sorted,
             const signed char* __restrict__ ops, const void* values,
             int vtype, long long C, int K, bool is_max, bool is_float,
             Buffers b, int* __restrict__ err) {
  __shared__ i64 s_v[kWarps][3][kMaxK];
  __shared__ int s_c[kWarps][3][kMaxK];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long base =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * 32;
  if (base >= N) return;
  const long long i = base + lane;
  const i64 trash = 2 * C;
  const i64 sk = i < N ? skey_sorted[i] : trash;
  const i64 sk_prev = (i > 0 && i < N) ? skey_sorted[i - 1] : -2;
  const bool start = sk < trash && (sk >> 1) != (sk_prev >> 1);
  unsigned starts = __ballot_sync(RW_FULL_MASK, start);
  i64* cv[3] = {s_v[warp][0], s_v[warp][1], s_v[warp][2]};
  int* cc[3] = {s_c[warp][0], s_c[warp][1], s_c[warp][2]};

  while (starts) {
    const int l = __ffs(starts) - 1;
    starts &= starts - 1;
    const long long lo = base + l;
    const i64 g = __shfl_sync(RW_FULL_MASK, sk, l) >> 1;
    const i64 mine = 2 * g;
    int n_pos = 0, n_neg = 0;
    int carry_sum = 0;
    i64 carry_lead = 0, carry_last = 0;
    // a tile is 32 lanes x kRows consecutive rows (lane l owns rows
    // l * kRows ..), so each lane has kRows loads in flight at once
    for (long long t = lo;; t += 32 * kRows) {
      const long long r0 = t + lane * kRows;
      bool in[kRows], lead[kRows];
      i64 v[kRows];
      int sg[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        in[j] = r0 + j < N && skey_sorted[r0 + j] == mine;
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        v[j] = 0;
        sg[j] = 0;
        if (in[j]) {
          const i64 p = order[r0 + j];
          v[j] = load_bits(values, vtype, p);
          sg[j] = op_sign(ops[p]);
        }
      }
      if (__ballot_sync(RW_FULL_MASK, in[0]) == 0) break;
      // leaders: a group's first row, or a value unlike the row before
      i64 before = __shfl_up_sync(RW_FULL_MASK, v[kRows - 1], 1);
      if (lane == 0) before = carry_last;
      lead[0] = in[0] && (r0 == lo || !same(v[0], before, is_float));
#pragma unroll
      for (int j = 1; j < kRows; ++j) {
        lead[j] = in[j] && !same(v[j], v[j - 1], is_float);
      }
      // the lane's open-run sum and its last leader's value
      int agg = 0;
      bool has_lead = false;
      i64 lane_lv = 0;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (lead[j]) {
          agg = sg[j];
          has_lead = true;
          lane_lv = v[j];
        } else {
          agg += sg[j];
        }
      }
      // segmented inclusive scan over the lanes' (sum, leader) pairs and
      // a max-scan of the lanes holding a leader
      int sum = agg;
      bool f = has_lead;
      int head = has_lead ? lane : -1;
      for (int o = 1; o < 32; o <<= 1) {
        const int s2 = __shfl_up_sync(RW_FULL_MASK, sum, o);
        const bool f2 = __shfl_up_sync(RW_FULL_MASK, f, o);
        const int h2 = __shfl_up_sync(RW_FULL_MASK, head, o);
        if (lane >= o) {
          if (!f) {
            sum += s2;
            f = f2;
          }
          head = max(head, h2);
        }
      }
      int ex_sum = __shfl_up_sync(RW_FULL_MASK, sum, 1);
      bool ex_f = __shfl_up_sync(RW_FULL_MASK, f, 1);
      int ex_head = __shfl_up_sync(RW_FULL_MASK, head, 1);
      if (lane == 0) {
        ex_sum = 0;
        ex_f = false;
        ex_head = -1;
      }
      const i64 hv = __shfl_sync(RW_FULL_MASK, lane_lv,
                                 ex_head < 0 ? 0 : ex_head);
      // the next row after the lane's last (lane 31: past the tile)
      bool next_in = __shfl_down_sync(RW_FULL_MASK, in[0], 1);
      bool next_lead = __shfl_down_sync(RW_FULL_MASK, lead[0], 1);
      if (lane == 31) {
        const long long r = r0 + kRows;
        next_in = in[kRows - 1] && r < N && skey_sorted[r] == mine;
        next_lead = next_in && !same(load_bits(values, vtype, order[r]),
                                     v[kRows - 1], is_float);
      }
      // each run's net delta and leader value at its last row
      int run = ex_sum + (ex_f ? 0 : carry_sum);
      i64 lv = ex_head < 0 ? carry_lead : hv;
      int dlt[kRows];
      i64 lvs[kRows];
      bool tail[kRows];
      int my_pos = 0, my_neg = 0;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (lead[j]) {
          run = sg[j];
          lv = v[j];
        } else {
          run += sg[j];
        }
        const bool nin = j + 1 < kRows ? in[j + 1] : next_in;
        const bool nld = j + 1 < kRows ? lead[j + 1] : next_lead;
        tail[j] = in[j] && (!nin || nld);
        dlt[j] = run;
        lvs[j] = lv;
        my_pos += tail[j] && run > 0;
        my_neg += tail[j] && run < 0;
      }
      // ranks: runs before this lane's, in row order
      int inc_pos = my_pos, inc_neg = my_neg;
      for (int o = 1; o < 32; o <<= 1) {
        const int p2 = __shfl_up_sync(RW_FULL_MASK, inc_pos, o);
        const int n2 = __shfl_up_sync(RW_FULL_MASK, inc_neg, o);
        if (lane >= o) {
          inc_pos += p2;
          inc_neg += n2;
        }
      }
      int rp = n_pos + inc_pos - my_pos;
      int rn = n_neg + inc_neg - my_neg;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (tail[j] && dlt[j] > 0) {
          if (rp < K) {
            cv[1][rp] = lvs[j];
            cc[1][rp] = dlt[j];
          }
          ++rp;
        } else if (tail[j] && dlt[j] < 0) {
          if (rn < K) {
            cv[2][rn] = lvs[j];
            cc[2][rn] = dlt[j];
          }
          ++rn;
        }
      }
      n_pos += __shfl_sync(RW_FULL_MASK, inc_pos, 31);
      n_neg += __shfl_sync(RW_FULL_MASK, inc_neg, 31);
      if (!__all_sync(RW_FULL_MASK, in[kRows - 1])) break;
      carry_sum = __shfl_sync(RW_FULL_MASK, run, 31);
      carry_lead = __shfl_sync(RW_FULL_MASK, lv, 31);
      carry_last = __shfl_sync(RW_FULL_MASK, v[kRows - 1], 31);
    }
    i64* gv = b.vals + g * K;
    int* gc = b.cnts + g * K;
    for (int k = lane; k < K; k += 32) {
      cv[0][k] = gv[k];
      cc[0][k] = gc[k];
    }
    __syncwarp();
    if (lane == 0) {
      const int lens[3] = {K, min(n_pos, K), min(n_neg, K)};
      Merger m;
      m.K = K;
      m.is_max = is_max;
      m.is_float = is_float;
      m.lossy = b.lossy[g] || n_pos > K;
      m.out_v = gv;
      m.out_c = gc;
      m.n_out = 0;
      m.errs = max(n_neg - K, 0);
      m.pending = m.open = false;
      m.pv = m.prev = 0;
      m.pc = 0;
      int at[3] = {0, 0, 0};
      for (;;) {
        // skip the empty stored cells
        while (at[0] < lens[0] && cc[0][at[0]] == 0) ++at[0];
        int best = -1;
        i64 best_key = 0;
        for (int q = 0; q < 3; ++q) {
          if (at[q] >= lens[q]) continue;
          const i64 kq = order_key(cv[q][at[q]], is_max, is_float);
          if (best < 0 || kq < best_key) {
            best = q;
            best_key = kq;
          }
        }
        if (best < 0) break;
        m.push(cv[best][at[best]], cc[best][at[best]]);
        ++at[best];
      }
      m.finish_pending();
      for (int k = min(m.n_out, K); k < K; ++k) {
        gv[k] = 0;
        gc[k] = 0;
      }
      const bool lossy3 = m.lossy || m.n_out > K;
      b.lossy[g] = lossy3;
      if (m.n_out == 0 && lossy3 && b.row_count[g] > 0) ++m.errs;
      if (m.errs) atomicAdd(err, m.errs);
    }
    __syncwarp();
  }
}

}  // namespace

// Per row: the order key and the group key (see the contract above).
extern "C" int rw_extrema_keys(long long N, const int* slots,
                               const void* values,
                               int vtype, const bool* valid, long long C,
                               int is_max, int is_float, long long* okey,
                               long long* skey, void* stream) {
  if (N < 1 || C < 1 || vtype < V_I32 || vtype > V_F64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  keys_kernel<<<rw_blocks(N, kThreads), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      N, slots, values, vtype, valid, C, is_max != 0, is_float != 0, okey,
      skey);
  return static_cast<int>(cudaGetLastError());
}

// The apply over the rows in (group key, order key) order: order[j] is
// the j-th row, skey_sorted[j] its group key.
extern "C" int rw_extrema_merge(long long N, const long long* order,
                                const long long* skey_sorted,
                                const signed char* ops, const void* values,
                                int vtype, long long C, int K, int is_max,
                                int is_float, long long* vals, int* cnts,
                                bool* lossy, const long long* row_count,
                                int* err, void* stream) {
  if (N < 1 || C < 1 || K < 1 || K > kMaxK || vtype < V_I32
      || vtype > V_F64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Buffers b = {vals, cnts, lossy, row_count};
  const long long warps = (N + 31) / 32;
  merge_kernel<<<rw_blocks(warps, kWarps), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      N, order, skey_sorted, ops, values, vtype, C, K, is_max != 0,
      is_float != 0, b, err);
  return static_cast<int>(cudaGetLastError());
}
