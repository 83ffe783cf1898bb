// K13 — TPC-H part and lineitem columns from a start offset.
//
// Replaces risingwave_tpu/connectors/tpch.py:TpchGenerator._gen_impl (77)
// with _part_cols (47): an XLA fusion on the TPU.
//
// Part row r (key k = r + 1): brand = brand_ids[splitmix64(k ^ 0xA5A5) %
// 25], container = container_ids[splitmix64(k ^ 0x5A5A) % 16], price =
// 900 + splitmix64(k ^ 0xA5A5) % 200. Lineitem row r: partkey = 1 +
// splitmix64(r ^ 0x71F3) % 1000, quantity = 1 + splitmix64(r ^ 0x9D2C) %
// 50, extended price = quantity x the part's price, orderkey = r / 4 + 1
// (floor).
//
// What bounds it on the H100: a row writes 32 bytes (four int64 columns)
// and reads only the two tiny id tables (L1-resident), so an 8192-row
// lineitem chunk moves 262 KB: 0.08 us at 3.35 TB/s, far below a
// launch's latency. Each row runs two or three splitmix64 chains and
// 64-bit remainders by constants, which nvcc turns into multiply-highs.
//
// Design: one thread per row, every column computed in registers and
// written once, coalesced. uint64 arithmetic is native, so the output is
// bit-identical to the reference.

#include "common.cuh"

namespace {

constexpr u64 kNumParts = 1000;
constexpr u64 kBrands = 25;
constexpr u64 kContainers = 16;

__device__ __forceinline__ u64 part_hash(i64 key) {
  return rw_splitmix64(static_cast<u64>(key) ^ 0xA5A5ULL);
}

__device__ __forceinline__ i64 part_price(i64 key) {
  return 900 + static_cast<i64>(part_hash(key) % 200);
}

__global__ void tpch_part_kernel(i64 offset, int n,
                                 const i64* __restrict__ brand_ids,
                                 const i64* __restrict__ container_ids,
                                 i64* __restrict__ key,
                                 i64* __restrict__ brand,
                                 i64* __restrict__ container,
                                 i64* __restrict__ price) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const i64 k = offset + i + 1;
  const u64 h = part_hash(k);
  const u64 h2 = rw_splitmix64(static_cast<u64>(k) ^ 0x5A5AULL);
  key[i] = k;
  brand[i] = brand_ids[h % kBrands];
  container[i] = container_ids[h2 % kContainers];
  price[i] = 900 + static_cast<i64>(h % 200);
}

__global__ void tpch_lineitem_kernel(i64 offset, int n,
                                     i64* __restrict__ orderkey,
                                     i64* __restrict__ partkey,
                                     i64* __restrict__ quantity,
                                     i64* __restrict__ extended) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const i64 rid = offset + i;
  const i64 pk =
      1 + static_cast<i64>(rw_splitmix64(static_cast<u64>(rid) ^ 0x71F3ULL)
                           % kNumParts);
  const i64 q =
      1 + static_cast<i64>(rw_splitmix64(static_cast<u64>(rid) ^ 0x9D2CULL)
                           % 50);
  orderkey[i] = rw_floordiv(rid, 4) + 1;
  partkey[i] = pk;
  quantity[i] = q;
  extended[i] = q * part_price(pk);
}

}  // namespace

// table 0 = part (key, brand, container, price), 1 = lineitem
// (orderkey, partkey, quantity, extendedprice).
extern "C" int rw_tpch(int table, long long offset, int n,
                       const long long* brand_ids, int n_brand,
                       const long long* container_ids, int n_container,
                       long long* c0, long long* c1, long long* c2,
                       long long* c3, void* stream) {
  if (n_brand != static_cast<int>(kBrands)
      || n_container != static_cast<int>(kContainers)
      || (table != 0 && table != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const int threads = 256;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (table == 0) {
      tpch_part_kernel<<<rw_blocks(n, threads), threads, 0, s>>>(
          offset, n, brand_ids, container_ids, c0, c1, c2, c3);
    } else {
      tpch_lineitem_kernel<<<rw_blocks(n, threads), threads, 0, s>>>(
          offset, n, c0, c1, c2, c3);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
