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
// Four entries share one round body (lf_round.cuh, which K4's LF(1) hop in
// locate_walk.cu shares too):
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
//   tpufm_lf_round_paired the paired layout's round (lf_step_paired,
//                         tpufm/engine/xla.py:128-176): one thread per read,
//                         the row pair at lo's block of the paired table
//                         (row i = fused rows i and i+1, each W words);
//                         hi's row is the second half where hi's block is
//                         lo's + 1, else the first (wrong for a wider
//                         interval, as in tpufm), and ok = hi's block -
//                         lo's block <= 1 (mod 2^32) flags the reads the
//                         engine searches again on the fused table.
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
// with coalesced 16-byte loads (lf_round.cuh), the pair entry loads one row
// per read, and evict-first loads and stores (__ldcs, __stcs) for the
// once-read iv, code and gathered rows and the once-written out keep those
// streams (40 MB a round at 1M reads) from pushing the table out of L2.
// Fusing all rounds of a wave into one launch with the interval kept in a
// register (K2) is later work.
//
// Types. Intervals reach bwtsize, above 2^31 at 3.2 Gbase, so they are held
// as uint32_t here and int64 on the torch side, never as a signed int32.
// Table words arrive as int32 tensors holding the uint32 bits.

#include <cstdint>
#include <cuda_runtime.h>

#include "lf_round.cuh"

namespace {

using tpufm::LoadCached;
using tpufm::LoadStreaming;
using tpufm::lf_rounds;
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

template <int K, int V>
__global__ void lf_round_paired_kernel(const uint32_t* __restrict__ paired,
                                       long long nrows, int half_words, int nb,
                                       const long long* __restrict__ iv,
                                       const long long* __restrict__ code,
                                       const long long* __restrict__ dollar,
                                       long long* __restrict__ out, bool* __restrict__ ok,
                                       long long n) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = j < n;
  const uint32_t lo = active ? (uint32_t)__ldcs(iv + 2 * j) : 0u;
  const uint32_t hi = active ? (uint32_t)__ldcs(iv + 2 * j + 1) : 0u;
  const uint32_t c = active ? (uint32_t)__ldcs(code + j) : 0u;
  const uint32_t d = 32u * (uint32_t)nb, b_lo = lo / d;
  // the pair at lo's block: its first half for lo's block, the second for
  // the next block, the first again for any other
  const uint32_t* pair = paired + min((unsigned long long)b_lo, (unsigned long long)(nrows - 1)) * 2ull *
                                      (unsigned long long)half_words;
  const auto row_of = [&](uint32_t block) { return pair + (block - b_lo == 1u ? half_words : 0); };
  uint32_t o_lo, o_hi;
  lf_rounds<K, V, LoadCached>(warp_stage<K>(nb), row_of, nb, lo, hi, c, active, dollar, o_lo, o_hi);
  if (active) {
    __stcs(out + 2 * j, (long long)o_lo);
    __stcs(out + 2 * j + 1, (long long)o_hi);
    ok[j] = hi / d - b_lo <= 1u;
  }
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
  return tpufm::dispatch_kv(k, tpufm::unit_words(paired, half), [&](auto K, auto V) {
    return tpufm::launch_staged(lf_round_paired_kernel<decltype(K)::value, decltype(V)::value>, k, nb, n,
                                static_cast<cudaStream_t>(stream), static_cast<const uint32_t*>(paired),
                                nrows, half, nb, static_cast<const long long*>(iv),
                                static_cast<const long long*>(code), static_cast<const long long*>(dollar),
                                static_cast<long long*>(out), static_cast<bool*>(ok), n);
  });
}

extern "C" const char* tpufm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
