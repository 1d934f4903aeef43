// K1: one k-step LF round per interval end or per read, for Hopper (sm_90a).
//
// Replaces the Pallas kernel _lf_round_kernel (tpufm/engine/pallas_kernel.py:41,
// built by make_lf_round, :102) and computes exactly what lf_step_fused
// (tpufm/engine/xla.py:80) computes for one end:
//
//   block  = iv / d;  row = entries[min(block, nrows - 1)]
//   count  = sum over windows w of popcount(prefix_mask(iv % d, w)
//            & AND over levels i of plane pair i, each plane taken as is or
//              complemented by the matching bit of code)
//   count -= #levels i with block == dollar_block[i], code == dollar_base[i]
//            and iv > dollar_pos[i]
//   out    = row[2k*nb + (code mod 4^k)] + count          (mod 2^32)
//
// Three entries share one round body (lf_round.cuh's lf_rounds, which K4's
// LF(1) hop in locate_walk.cu shares too):
//   tpufm_lf_round_pairs  the engine's: one thread per read, iv [n, 2] and
//                         one code per read. Both ends of a read take the
//                         same code, and after the prefix-LUT start almost
//                         every read has R - L <= 1, so both ends lie in one
//                         block: the row is loaded once and both ends are
//                         computed from it. Reads whose ends lie in two
//                         blocks take a second row.
//   tpufm_lf_round        one thread per end, the Pallas contract on the
//                         fused table (make_lf_round(k, d)(entries[iv // d],
//                         ...)), the row loaded by the kernel.
//   tpufm_lf_round_rows   the Pallas contract itself: row j was gathered
//                         beforehand (by K3, row_gather.cu, or by torch
//                         indexing) and may carry padding past the
//                         counters, as XLAEngine(gather="dma") rows do.
// The fourth stages its rows by asynchronous copies, as K8 does
// (async_stage.cuh), and counts with the same row_counts / lf_finish:
//   tpufm_lf_round_paired the paired layout's round (lf_step_paired,
//                         tpufm/engine/xla.py:128-176): one thread per read,
//                         the row pair at lo's block of the paired table
//                         (row i = fused rows i and i+1, each W words);
//                         hi's row is the second half where hi's block is
//                         lo's + 1, else the first (wrong for a wider
//                         interval, as in tpufm), and ok = hi's block -
//                         lo's block <= 1 (mod 2^32) flags the reads the
//                         engine searches again on the fused table.
// Paired entry, design: iv and out move as 16-byte pairs where aligned;
// both counters (the next half's where delta == 1) are loaded before the
// copies; the warp lists lo's plane words into the lane's slot and the
// next halves into kHiSlots slots, one a distinct pair (__match_any_sync
// on lo's block), issues every 16-byte unit as one cp.async and waits
// once; the distinct next halves past those slots (at most 32 - kHiSlots)
// take one more batch into any slot, lo's being free by then. Every other hi
// (delta 0, or more than a block apart either way) reads the first half,
// which is lo's row: it is counted on lo's slot at its own offset, under
// lo's counter and with its own block's '$' levels, so no read stages a
// second row it does not need. At d = 192 and k <= 3 the row is read as
// 16-byte vectors. Times (NVIDIA H100 80GB HBM3, 700 W, scripts/k1p_ab.py,
// PERF.md §6): the first version ran lf_rounds (register trips a unit, a
// second dependent staging round of all 32 slots for every warp with a
// read across blocks, 16-24% of warps at chip_smoke.py phase 18's rounds,
// restaging lo's own row for the wider ones): rounds 1 and 18 at 1M reads
// 0.0603-0.0607 and 0.0575-0.0583 ms, every read across two blocks (32
// distinct pairs a warp) 0.1337-0.1339; this design 0.0468-0.0475,
// 0.0468-0.0474 and 0.1109-0.1115. Staging the next halves kHiSlots a
// batch, as K8 does, took 0.1401-0.1408 on the last.
// The ragged edge is masked here, so any n works (the TPU version padded to
// a 2048-end tile).
//
// Bound. HBM-bound as reckoned: each input read once, each output written
// once. Per read the pair entry moves int64 iv [2], code and out [2] (40 B,
// the port's interface: int32 would halve them) and, once, the table words
// its ends need (of each row, the plane words of the windows its ends'
// prefixes cover, and each distinct counter): at 1M reads of phase 4's
// round 18 on the 10 Mbase k=3 d=192 table 41.9 + 10.9 MB, 15.8 us at
// 3.35 TB/s.
// What limits it is the L2: the table lives there (21 MB of 50 MB), and a
// round asks it for every read's plane block (5 sectors at k=3 d=192) and
// counter. Loading them a word at a time per lane would make up to 37
// sector requests an end, and one thread per end would fetch every row
// twice. This design asks for each sector once: the warp stages its rows
// with coalesced 16-byte loads (lf_round.cuh; the paired entry by cp.async),
// the pair entry loads one row per read, and evict-first loads and stores
// (__ldcs, __stcs) for the once-read iv, code and gathered rows and the
// once-written out keep those streams (40 MB a round at 1M reads) from pushing the table out of L2.
// Fusing all rounds of a wave into one launch with the interval kept in a
// register (K2) is later work.
//
// Types. Intervals reach bwtsize, above 2^31 at 3.2 Gbase, so they are held
// as uint32_t here and int64 on the torch side, never as a signed int32.
// Table words arrive as int32 tensors holding the uint32 bits.

#include <cstdint>
#include <cuda_runtime.h>

#include "async_stage.cuh"
#include "lf_round.cuh"

namespace {

using tpufm::HiRows;
using tpufm::LoadCached;
using tpufm::LoadStreaming;
using tpufm::WarpStage;
using tpufm::kHiSlots;
using tpufm::lf_finish;
using tpufm::lf_rounds;
using tpufm::load_read;
using tpufm::stage_rows_async;
using tpufm::stage_stride;
using tpufm::store_read;
using tpufm::warp_stage;

template <int K, int V>
__global__ void lf_round_kernel(const uint32_t* __restrict__ entries,
                                long long nrows, int row_words, int nb,
                                const long long* __restrict__ iv,
                                const long long* __restrict__ code,
                                const long long* __restrict__ dollar,
                                long long* __restrict__ out, long long n) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = j < n;  // every lane stays: the warp stages rows together
  const uint32_t v = active ? (uint32_t)__ldcs(iv + j) : 0u;
  const uint32_t c = active ? (uint32_t)__ldcs(code + j) : 0u;
  const auto row_of = [&](uint32_t block) {
    return entries + min((unsigned long long)block, (unsigned long long)(nrows - 1)) *
                         (unsigned long long)row_words;
  };
  uint32_t o, unused;
  lf_rounds<K, V, LoadCached>(warp_stage<K>(nb), row_of, nb, v, v, c, active, dollar, o, unused);
  if (active) __stcs(out + j, (long long)o);
}

template <int K, int V>
__global__ void lf_round_rows_kernel(const uint32_t* __restrict__ rows,
                                     int row_words, int nb,
                                     const long long* __restrict__ iv,
                                     const long long* __restrict__ code,
                                     const long long* __restrict__ dollar,
                                     long long* __restrict__ out, long long n) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = j < n;
  const uint32_t v = active ? (uint32_t)__ldcs(iv + j) : 0u;
  const uint32_t c = active ? (uint32_t)__ldcs(code + j) : 0u;
  const auto row_of = [&](uint32_t) { return rows + (active ? j : 0) * (unsigned long long)row_words; };
  uint32_t o, unused;
  lf_rounds<K, V, LoadStreaming>(warp_stage<K>(nb), row_of, nb, v, v, c, active, dollar, o, unused);
  if (active) __stcs(out + j, (long long)o);
}

template <int K, int V>
__global__ void lf_round_pairs_kernel(const uint32_t* __restrict__ entries,
                                      long long nrows, int row_words, int nb,
                                      const long long* __restrict__ iv,
                                      const long long* __restrict__ code,
                                      const long long* __restrict__ dollar,
                                      long long* __restrict__ out, long long n) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = j < n;
  const uint32_t lo = active ? (uint32_t)__ldcs(iv + 2 * j) : 0u;
  const uint32_t hi = active ? (uint32_t)__ldcs(iv + 2 * j + 1) : 0u;
  const uint32_t c = active ? (uint32_t)__ldcs(code + j) : 0u;
  const auto row_of = [&](uint32_t block) {
    return entries + min((unsigned long long)block, (unsigned long long)(nrows - 1)) *
                         (unsigned long long)row_words;
  };
  uint32_t o_lo, o_hi;
  lf_rounds<K, V, LoadCached>(warp_stage<K>(nb), row_of, nb, lo, hi, c, active, dollar, o_lo, o_hi);
  if (active) {
    __stcs(out + 2 * j, (long long)o_lo);
    __stcs(out + 2 * j + 1, (long long)o_hi);
  }
}

// The paired round, one thread a read: the pair at lo's block (clamped) is
// lo's row and, where hi's block is the next (delta == 1), hi's row in its
// second half. Both counters are loaded first; lo's plane words go into the
// lane's slot and the next halves' into the hi slots, one a distinct pair,
// in one batch of copies (distinct pairs past the hi slots: one more
// batch). Every other hi (delta 0, or more than a block on or before lo,
// the uint32 difference wrapping) takes the first half as tpufm does, so it
// is counted on lo's slot at its own offset, under lo's counter and its own
// block's '$' levels: no second staging.
template <int K, int V, int NB>
__global__ void lf_round_paired_kernel(const uint32_t* __restrict__ paired,
                                       long long nrows, int half_words, int nb,
                                       const long long* __restrict__ iv,
                                       const long long* __restrict__ code,
                                       const long long* __restrict__ dollar,
                                       long long* __restrict__ out, bool* __restrict__ ok,
                                       long long n) {
  const int lane = threadIdx.x & 31;
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j - lane >= n) return;  // the whole warp is past the end
  const bool active = j < n;  // every lane of a live warp stays: the warp stages rows together
  const bool pairs = ((reinterpret_cast<uintptr_t>(iv) | reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  uint32_t lo, hi, c;
  load_read(iv, code, j, active, pairs, lo, hi, c);
  const uint32_t d = 32u * (uint32_t)nb, b_lo = lo / d, b_hi = hi / d, delta = b_hi - b_lo;
  const int words = 2 * K * nb, stride = stage_stride(words);
  const uint32_t* pair = paired + min((unsigned long long)b_lo, (unsigned long long)(nrows - 1)) * 2ull *
                                      (unsigned long long)half_words;
  const bool next = active && delta == 1u;
  const uint32_t col = words + (c & ((1u << (2 * K)) - 1u));
  const uint32_t cnt = active ? LoadCached::ld(pair + col) : 0u;
  const uint32_t cnt2 = next ? LoadCached::ld(pair + half_words + col) : 0u;
  const HiRows his(next, b_lo);
  const WarpStage<32 + kHiSlots> w = WarpStage<32 + kHiSlots>::at(stride, 0);
  const int jobs = w.list(0, active, pair, lane);
  stage_rows_async<V>(w, stride, his.list(w, jobs, 0, pair + half_words), words);
  const int s_lo = (int)(lo - b_lo * d), s_hi = (int)(hi - b_hi * d);
  uint32_t o_lo = 0, o_hi = 0, unused;
  if (active)
    lf_finish<K, NB>(w.rows + lane * stride, nb, cnt, c, b_lo, lo, s_lo, b_hi, hi, next ? s_lo : s_hi, dollar, o_lo,
                     o_hi);
  // ranks below kHiSlots in the first batch's hi slots; the rest (at most
  // 32 - kHiSlots) in one more batch from slot 0, lo's slots free by then
  for (int pass = 0; pass < 2 && pass * kHiSlots < his.groups; ++pass) {
    const bool mine = pass ? his.want && his.rank >= kHiSlots : his.in(0);
    const int slot = pass ? his.rank - kHiSlots : his.slot(0);
    if (pass) {
      __syncwarp();  // every lane is done with the slots
      stage_rows_async<V>(w, stride, w.list(0, his.lead && mine, pair + half_words, slot), words);
    }
    if (mine)
      lf_finish<K, NB>(w.rows + slot * stride, nb, cnt2, c, b_hi, hi, s_hi, b_hi, hi, s_hi, dollar, o_hi, unused);
  }
  if (!active) return;
  store_read(out, j, pairs, o_lo, o_hi);
  ok[j] = delta <= 1u;
}

bool bad_shape(int row_words, int k, int nb) {
  return nb <= 0 || k < 1 || k > 8 || row_words < 2 * k * nb + (1 << (2 * k));
}

}  // namespace

// Launches K1 on `stream` and returns cudaGetLastError() (0 on success).
// entries: uint32 [nrows, row_words]; iv, code, out: int64 [n];
// dollar: int64 [3, k] (rows pos, base, block). Does not synchronise.
extern "C" int tpufm_lf_round(const void* entries, long long nrows,
                              int row_words, int k, int nb, const void* iv,
                              const void* code, const void* dollar, void* out,
                              long long n, void* stream) {
  if (n <= 0) return 0;
  if (nrows <= 0 || bad_shape(row_words, k, nb)) return (int)cudaErrorInvalidValue;
  return tpufm::dispatch_kv(k, tpufm::unit_words(entries, row_words), [&](auto K, auto V) {
    return tpufm::launch_staged(lf_round_kernel<decltype(K)::value, decltype(V)::value>, k, nb, n,
                  static_cast<cudaStream_t>(stream), static_cast<const uint32_t*>(entries), nrows,
                  row_words, nb, static_cast<const long long*>(iv), static_cast<const long long*>(code),
                  static_cast<const long long*>(dollar), static_cast<long long*>(out), n);
  });
}

// Launches K1 on rows gathered beforehand, the Pallas contract
// make_lf_round(k, d)(rows, iv, code, dollar): rows: uint32 [n, row_words],
// row j belonging to end j; otherwise as tpufm_lf_round.
extern "C" int tpufm_lf_round_rows(const void* rows, int row_words, int k,
                                   int nb, const void* iv, const void* code,
                                   const void* dollar, void* out, long long n,
                                   void* stream) {
  if (n <= 0) return 0;
  if (bad_shape(row_words, k, nb)) return (int)cudaErrorInvalidValue;
  return tpufm::dispatch_kv(k, tpufm::unit_words(rows, row_words), [&](auto K, auto V) {
    return tpufm::launch_staged(lf_round_rows_kernel<decltype(K)::value, decltype(V)::value>, k, nb, n,
                  static_cast<cudaStream_t>(stream), static_cast<const uint32_t*>(rows), row_words, nb,
                  static_cast<const long long*>(iv), static_cast<const long long*>(code),
                  static_cast<const long long*>(dollar), static_cast<long long*>(out), n);
  });
}

// Launches K1 with one thread per read: iv, out: int64 [n, 2] (each read's
// lo, hi); code: int64 [n], one code for both ends; otherwise as
// tpufm_lf_round.
extern "C" int tpufm_lf_round_pairs(const void* entries, long long nrows,
                                    int row_words, int k, int nb, const void* iv,
                                    const void* code, const void* dollar, void* out,
                                    long long n, void* stream) {
  if (n <= 0) return 0;
  if (nrows <= 0 || bad_shape(row_words, k, nb)) return (int)cudaErrorInvalidValue;
  return tpufm::dispatch_kv(k, tpufm::unit_words(entries, row_words), [&](auto K, auto V) {
    return tpufm::launch_staged(lf_round_pairs_kernel<decltype(K)::value, decltype(V)::value>, k, nb, n,
                  static_cast<cudaStream_t>(stream), static_cast<const uint32_t*>(entries), nrows,
                  row_words, nb, static_cast<const long long*>(iv), static_cast<const long long*>(code),
                  static_cast<const long long*>(dollar), static_cast<long long*>(out), n);
  });
}

// Launches the paired round with one thread per read: paired: uint32 [nrows,
// row_words], row_words = 2W (two fused rows of W words); iv, out: int64
// [n, 2]; code: int64 [n]; ok: bool [n]; otherwise as tpufm_lf_round.
extern "C" int tpufm_lf_round_paired(const void* paired, long long nrows,
                                     int row_words, int k, int nb, const void* iv,
                                     const void* code, const void* dollar, void* out,
                                     void* ok, long long n, void* stream) {
  if (n <= 0) return 0;
  const int half = row_words / 2;
  if (nrows <= 0 || row_words % 2 || bad_shape(half, k, nb)) return (int)cudaErrorInvalidValue;
  const size_t warp_bytes = WarpStage<32 + kHiSlots>::bytes(stage_stride(2 * k * nb), 0);
  return tpufm::dispatch_kv(k, tpufm::unit_words(paired, half), [&](auto K, auto V) {
    return tpufm::dispatch_nb<decltype(K)::value>(nb, [&](auto NB) {
      return tpufm::launch_async_staged(
          lf_round_paired_kernel<decltype(K)::value, decltype(V)::value, decltype(NB)::value>, warp_bytes, n,
          static_cast<cudaStream_t>(stream), static_cast<const uint32_t*>(paired), nrows, half, nb,
          static_cast<const long long*>(iv), static_cast<const long long*>(code),
          static_cast<const long long*>(dollar), static_cast<long long*>(out), static_cast<bool*>(ok), n);
    });
  });
}

extern "C" const char* tpufm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
