// K10 — Nexmark auction columns from a start index.
//
// Replaces risingwave_tpu/connectors/nexmark.py:gen_auction_columns (208),
// with _rand (127), _vocab_pick (113) and _ids_so_far (141): an XLA
// fusion on the TPU.
//
// What bounds it on the H100: a row reads only the small vocabulary id
// tables and writes 68 bytes (7 x int64 + 3 x int32), so a 294912-row
// chunk moves 20.1 MB: 5.99 us at 3.35 TB/s. Each row runs nine
// splitmix64 chains and nine 64-bit remainders (emulated with 32-bit
// integer instructions), so the integer pipes may bound it before memory.
//
// Design: one thread per row, every column computed in registers and
// written once, coalesced; bit-identical to the reference.

#include "nexmark.cuh"

namespace {

constexpr i64 kHotSellerRatio = 4;

__global__ void nexmark_auction_kernel(
    i64 start, int n, i64 base_time_us, i64 inter_event_us,
    i64 num_active_people, const int* __restrict__ item_ids, int n_item,
    const int* __restrict__ desc_ids, int n_desc,
    const int* __restrict__ extra_ids, int n_extra,
    i64* __restrict__ id, int* __restrict__ item, int* __restrict__ desc,
    i64* __restrict__ initial_bid, i64* __restrict__ reserve,
    i64* __restrict__ date_time, i64* __restrict__ expires,
    i64* __restrict__ seller, i64* __restrict__ category,
    int* __restrict__ extra) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const i64 k = start + i;
  const i64 group = rw_floordiv(k, kAuctionProportion);
  const i64 off = k - group * kAuctionProportion;
  const i64 gid = group * kTotalProportion + kPersonProportion + off;
  i64 n_persons, n_auctions;
  rw_ids_so_far(gid, &n_persons, &n_auctions);
  id[i] = kFirstAuctionId + k;
  item[i] = rw_vocab_pick(item_ids, n_item, gid, 21);
  desc[i] = rw_vocab_pick(desc_ids, n_desc, gid, 22);
  const i64 ib = rw_rand_c<1000>(gid, 23) * 100 + 100;
  initial_bid[i] = ib;
  reserve[i] = ib + rw_rand_c<1000>(gid, 24) * 100;
  const i64 dt = base_time_us + gid * inter_event_us;
  date_time[i] = dt;
  expires[i] = dt + (rw_rand_c<100>(gid, 25) + 1) * 1000000LL;
  const bool hot = rw_rand_c<kHotSellerRatio>(gid, 26) > 0;
  const i64 hot_seller =
      rw_floordiv(n_persons - 1, kHotSellerRatio) * kHotSellerRatio;
  i64 cold_seller =
      n_persons - 1 - rw_rand_r(gid, 27, static_cast<u64>(num_active_people));
  cold_seller = cold_seller < 0 ? 0 : cold_seller;
  seller[i] = kFirstPersonId + (hot ? hot_seller : cold_seller);
  category[i] = kFirstCategoryId + rw_rand_c<5>(gid, 28);
  extra[i] = rw_vocab_pick(extra_ids, n_extra, gid, 29);
}

}  // namespace

extern "C" int rw_nexmark_auction(
    long long start, int n, long long base_time_us, long long inter_event_us,
    long long num_active_people, const int* item_ids, int n_item,
    const int* desc_ids, int n_desc, const int* extra_ids, int n_extra,
    long long* id, int* item, int* desc, long long* initial_bid,
    long long* reserve, long long* date_time, long long* expires,
    long long* seller, long long* category, int* extra, void* stream) {
  if (n > 0) {
    const int threads = 256;
    nexmark_auction_kernel<<<rw_blocks(n, threads), threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        start, n, base_time_us, inter_event_us, num_active_people, item_ids,
        n_item, desc_ids, n_desc, extra_ids, n_extra, id, item, desc,
        initial_bid, reserve, date_time, expires, seller, category, extra);
  }
  return static_cast<int>(cudaGetLastError());
}
