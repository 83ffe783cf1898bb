// K1 — Nexmark bid columns from a start index.
//
// Replaces risingwave_tpu/connectors/nexmark.py:gen_bid_columns (156),
// with _splitmix64 (118), _rand (127) and _vocab_pick (113): an XLA
// fusion on the TPU.
//
// What bounds it on the H100: one row reads nothing but the three tiny
// vocabulary tables (L1-resident) and writes 44 bytes (4 x int64 +
// 3 x int32), so the byte bound is 5.8 MB per 131072-row chunk, ~1.7 us
// at 3.35 TB/s. Each row also runs nine splitmix64 chains and nine
// 64-bit remainders, which the card emulates with 32-bit integer
// instructions: the arithmetic, not memory, is the likely limit.
//
// Design: one thread per row, every column computed in registers and
// written once, coalesced. The remainders by compile-time constants
// (100, 5, 900, the vocabulary sizes are runtime) let nvcc replace the
// division by a multiply-high. uint64 arithmetic is native, so the
// output is bit-identical to the reference without the int64 tricks of
// the plain version.

#include "nexmark.cuh"

namespace {

constexpr i64 kHotAuctionRatio = 100;
constexpr i64 kHotBidderRatio = 100;

__global__ void nexmark_bid_kernel(
    i64 start, int n, i64 base_time_us, i64 inter_event_us,
    i64 num_active_people, i64 in_flight_auctions,
    const int* __restrict__ channel_ids, int n_channel,
    const int* __restrict__ url_ids, int n_url,
    const int* __restrict__ extra_ids, int n_extra,
    i64* __restrict__ auction, i64* __restrict__ bidder,
    i64* __restrict__ price, int* __restrict__ channel,
    int* __restrict__ url, i64* __restrict__ date_time,
    int* __restrict__ extra) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const i64 k = start + i;
  const i64 group = k / kBidProportion;
  const i64 off = k % kBidProportion;
  const i64 gid = group * kTotalProportion + kPersonProportion +
                  kAuctionProportion + off;
  i64 n_persons, n_auctions;
  rw_ids_so_far(gid, &n_persons, &n_auctions);

  const bool hot = rw_rand_c<kHotAuctionRatio>(gid, 1) > 0;
  const i64 hot_auction =
      ((n_auctions - 1) / kHotAuctionRatio) * kHotAuctionRatio;
  i64 cold_auction =
      n_auctions - 1 - rw_rand_r(gid, 2, static_cast<u64>(in_flight_auctions));
  cold_auction = cold_auction < 0 ? 0 : cold_auction;
  auction[i] = kFirstAuctionId + (hot ? hot_auction : cold_auction);

  const bool hot_b = rw_rand_c<kHotBidderRatio>(gid, 3) > 0;
  const i64 hot_bidder =
      ((n_persons - 1) / kHotBidderRatio) * kHotBidderRatio + 1;
  i64 cold_bidder =
      n_persons - 1 - rw_rand_r(gid, 4, static_cast<u64>(num_active_people));
  cold_bidder = cold_bidder < 0 ? 0 : cold_bidder;
  bidder[i] = kFirstPersonId + (hot_b ? hot_bidder : cold_bidder);

  const i64 lg = rw_rand_c<5>(gid, 5);
  const i64 mant = rw_rand_c<900>(gid, 6) + 100;
  i64 p10 = 1;
  for (i64 d = 0; d < lg; ++d) p10 *= 10;
  price[i] = mant * p10;

  channel[i] = channel_ids[rw_rand_r(gid, 7, static_cast<u64>(n_channel))];
  url[i] = url_ids[rw_rand_r(gid, 8, static_cast<u64>(n_url))];
  date_time[i] = base_time_us + gid * inter_event_us;
  extra[i] = extra_ids[rw_rand_r(gid, 9, static_cast<u64>(n_extra))];
}

}  // namespace

extern "C" int rw_nexmark_bid(
    long long start, int n, long long base_time_us, long long inter_event_us,
    long long num_active_people, long long in_flight_auctions,
    const int* channel_ids, int n_channel, const int* url_ids, int n_url,
    const int* extra_ids, int n_extra, long long* auction, long long* bidder,
    long long* price, int* channel, int* url, long long* date_time,
    int* extra, void* stream) {
  if (n > 0) {
    const int threads = 256;
    nexmark_bid_kernel<<<rw_blocks(n, threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        start, n, base_time_us, inter_event_us, num_active_people,
        in_flight_auctions, channel_ids, n_channel, url_ids, n_url,
        extra_ids, n_extra, auction, bidder, price, channel, url, date_time,
        extra);
  }
  return static_cast<int>(cudaGetLastError());
}
