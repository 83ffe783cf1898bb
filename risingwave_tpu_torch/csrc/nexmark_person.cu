// K9 — Nexmark person columns from a start index.
//
// Replaces risingwave_tpu/connectors/nexmark.py:gen_person_columns (190),
// with _rand (127) and _vocab_pick (113): an XLA fusion on the TPU.
//
// What bounds it on the H100: a row reads only the small vocabulary id
// tables (L1-resident) and writes 40 bytes (2 x int64 + 6 x int32), so a
// 98304-row chunk moves 3.9 MB: 1.17 us at 3.35 TB/s. Each row also runs
// five splitmix64 chains and five 64-bit remainders by runtime moduli,
// which the card emulates with 32-bit instructions; at this size launch
// latency, not the arithmetic, is the likely limit.
//
// Design: one thread per row, every column computed in registers and
// written once, coalesced. uint64 arithmetic is native, so the output is
// bit-identical to the reference.

#include "nexmark.cuh"

namespace {

__global__ void nexmark_person_kernel(
    i64 start, int n, i64 base_time_us, i64 inter_event_us,
    const int* __restrict__ name_ids, int n_name,
    const int* __restrict__ email_ids, int n_email,
    const int* __restrict__ card_ids, int n_card,
    const int* __restrict__ city_ids, int n_city,
    const int* __restrict__ state_ids, int n_state,
    const int* __restrict__ extra_ids, int n_extra,
    i64* __restrict__ id, int* __restrict__ name, int* __restrict__ email,
    int* __restrict__ card, int* __restrict__ city, int* __restrict__ state,
    i64* __restrict__ date_time, int* __restrict__ extra) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const i64 k = start + i;
  const i64 gid = k * kTotalProportion;  // persons sit at offset 0 of a group
  const i64 pid = kFirstPersonId + k;
  id[i] = pid;
  name[i] = name_ids[pid % n_name];
  email[i] = rw_vocab_pick(email_ids, n_email, gid, 11);
  card[i] = rw_vocab_pick(card_ids, n_card, gid, 12);
  city[i] = rw_vocab_pick(city_ids, n_city, gid, 13);
  state[i] = rw_vocab_pick(state_ids, n_state, gid, 14);
  date_time[i] = base_time_us + gid * inter_event_us;
  extra[i] = rw_vocab_pick(extra_ids, n_extra, gid, 15);
}

}  // namespace

extern "C" int rw_nexmark_person(
    long long start, int n, long long base_time_us, long long inter_event_us,
    const int* name_ids, int n_name, const int* email_ids, int n_email,
    const int* card_ids, int n_card, const int* city_ids, int n_city,
    const int* state_ids, int n_state, const int* extra_ids, int n_extra,
    long long* id, int* name, int* email, int* card, int* city, int* state,
    long long* date_time, int* extra, void* stream) {
  if (n > 0) {
    const int threads = 256;
    nexmark_person_kernel<<<rw_blocks(n, threads), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        start, n, base_time_us, inter_event_us, name_ids, n_name, email_ids,
        n_email, card_ids, n_card, city_ids, n_city, state_ids, n_state,
        extra_ids, n_extra, id, name, email, card, city, state, date_time,
        extra);
  }
  return static_cast<int>(cudaGetLastError());
}
