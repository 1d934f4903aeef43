// K8: one k-step LF round per read on the split tables or on the
// alternate-counters tables, and K9, the sharded engine's owner answer on
// one shard of the split tables, for Hopper (sm_90a).
//
// The port's kernels for two jnp rounds of the JAX package (no pallas_call):
//   tpufm_lf_round_split  lf_step_split (tpufm/engine/xla.py:179-212): the
//                         plane words from bitmaps[block] and the counter
//                         from a table of its own, occ[block, code]; the
//                         '$' correction as K1's (lf_round.cu):
//     out = occ[block, code] + count - #levels(block, code, iv > pos)
//   tpufm_lf_round_ac     lf_step_ac (xla.py:215-244; the numpy oracle
//                         tpufm/engine/oracle.py:63-105, after the
//                         reference's fmIndexCPUBaseline-AltCounters.c):
//                         each entry stores half of the 4^k counters (even
//                         entries the low half, odd the high), S = 4^k / 2:
//     back = (block odd) XOR (code >= S)
//     cnt  = occ_slim[block + back, code & (S-1)]
//     back == 0: out = cnt + count          - #levels(block, code, iv >  pos)
//     back == 1: out = cnt - (count_after    - #levels(block, code, iv <= pos))
//   where count is the popcount of the k-mer's matches in the block before
//   iv and count_after the popcount after it (the complemented prefix masks
//   of tpufm, here the block's whole count less count), all mod 2^32.
// Both ends of a read take one code; ends in one block share the row, the
// counter and `back`, so the kernel runs one thread per read, as K1's pair
// entry does: the warp stages the bit-plane rows of its reads' lo blocks
// (stage_rows, lf_round.cuh: coalesced 16-byte units), each lane loads its
// counter before the staging, and reads whose hi lies in another block take
// a second staging round. Indices clamp as jnp gathers clamp: the row to
// bitmaps' last (row E, zeros), occ's row and column to its last, the slim
// row (block + back) to occ_slim's last (E+1, the safety row).
//
// Bound. As K1's pair entry: per read int64 iv [2], code and out [2] (40 B)
// and, once, the table words its ends need. A simple kernel: the
// alternate-counters entry counts every window of the block, where K1
// counts only the windows before the end.
//
// K9, tpufm_lf_answer_owned: the owner answer of the sharded-index engine
// (_answer_owned, tpufm/parallel/search.py:267-290, which JAX runs as jnp,
// no pallas_call): the split round's per-end math on one shard of the entry
// table. Each request j of a stream (block, code, interval; uint32 [n, 3],
// the rows the routings circulate) is owned by shard block / e_local; the
// shard answers its own requests from its local rows (block - shard *
// e_local) of occ [e_local, 4^k] and bitmaps [e_local, >= 2k*nb]:
//     out = occ[local, code] + count - #levels(block, code, iv > pos)
// with the '$' levels compared on the GLOBAL block (the '$' triple is
// replicated), and writes 0 for every request it does not own. One thread
// per request; the warp stages the rows of its owned requests (stage_rows),
// the others take no row. Bound: per request its 12 B in and 4 B out, and,
// once, the table words the owned requests need; the stream is read once,
// so this kernel is bound by bytes. A simple kernel: requests owned by
// other shards still cost their 16 B, which is the routings' design (the
// allgather and ring routings send every request to every shard).
//
// Types. Intervals are uint32_t here and int64 on the torch side; table
// words arrive as int32 tensors holding the uint32 bits.

#include <cstdint>
#include <cuda_runtime.h>

#include "lf_round.cuh"

namespace {

using tpufm::LoadCached;
using tpufm::dollar_hits;
using tpufm::kFullWarp;
using tpufm::lf_counts;
using tpufm::prefix_mask;
using tpufm::stage_rows;
using tpufm::stage_stride;
using tpufm::warp_stage;

// Popcounts of the k-mer c's matches before the in-block offsets s0 and s1
// and in the whole block (all nb windows), on staged plane words s.
template <int K>
__device__ __forceinline__ void block_counts(const uint32_t* s, int nb, uint32_t c, int s0, int s1,
                                             uint32_t& n0, uint32_t& n1, uint32_t& all) {
  n0 = n1 = all = 0;
  for (int w = 0; w < nb; ++w) {
    uint32_t m = 0xFFFFFFFFu;
#pragma unroll
    for (int q = 0; q < 2 * K; ++q) {
      const uint32_t x = s[q * nb + w];
      m &= ((c >> q) & 1u) ? x : ~x;
    }
    n0 += __popc(m & prefix_mask(s0, w));
    n1 += __popc(m & prefix_mask(s1, w));
    all += __popc(m);
  }
}

// The alternate counters' '$' correction: levels whose '$' lies in this
// block with k-mer c, before v (forward) or at or after it (back).
template <int K>
__device__ __forceinline__ uint32_t dollar_hits_ac(uint32_t block, uint32_t c, uint32_t v, bool back,
                                                   const long long* __restrict__ dollar) {
  uint32_t n = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const bool at = block == (uint32_t)dollar[2 * K + i] && c == (uint32_t)dollar[K + i];
    const uint32_t pos = (uint32_t)dollar[i];
    n += (at && (back ? v <= pos : v > pos)) ? 1u : 0u;
  }
  return n;
}

// The counter of block b under code c (and, for AC, whether the entry read
// is the next one: `back`); the table is occ [rows, 4^K] (split) or
// occ_slim [rows, 4^K / 2] (AC).
template <int K, bool AC>
__device__ __forceinline__ uint32_t counter(const uint32_t* __restrict__ occ, long long occ_rows,
                                            int occ_words, uint32_t b, uint32_t c, bool& back) {
  constexpr uint32_t C = 1u << (2 * K), S = C / 2;
  unsigned long long row = b;
  uint32_t col;
  if (AC) {
    back = ((b & 1u) != 0u) != (c >= S);
    row += back ? 1u : 0u;
    col = c & (S - 1u);
  } else {
    back = false;
    col = c < C - 1u ? c : C - 1u;
  }
  row = min(row, (unsigned long long)(occ_rows - 1));
  return LoadCached::ld(occ + row * (unsigned long long)occ_words + col);
}

// One round's result for the end v in block b, from its counter and counts.
template <int K, bool AC>
__device__ __forceinline__ uint32_t finish(uint32_t cnt, bool back, uint32_t before, uint32_t all,
                                           uint32_t b, uint32_t c, uint32_t v,
                                           const long long* __restrict__ dollar) {
  if (!AC) return cnt + before - dollar_hits<K>(b, c, v, dollar);
  if (back) return cnt - (all - before - dollar_hits_ac<K>(b, c, v, true, dollar));
  return cnt + (before - dollar_hits_ac<K>(b, c, v, false, dollar));
}

// The in-block popcounts of one staged row: K1's windows before the ends
// (split), or every window (AC, which also needs the block's whole count).
template <int K, bool AC>
__device__ __forceinline__ void counts(const uint32_t* s, int nb, uint32_t c, int s0, int s1,
                                       uint32_t& n0, uint32_t& n1, uint32_t& all) {
  if (AC) {
    block_counts<K>(s, nb, c, s0, s1, n0, n1, all);
  } else {
    all = 0;
    lf_counts<K>(s, nb, c, s0, s1, n0, n1);
  }
}

template <int K, int V, bool AC>
__global__ void lf_round_split_kernel(const uint32_t* __restrict__ bitmaps, long long bm_rows,
                                      int bm_words, const uint32_t* __restrict__ occ,
                                      long long occ_rows, int occ_words, int nb,
                                      const long long* __restrict__ iv,
                                      const long long* __restrict__ code,
                                      const long long* __restrict__ dollar,
                                      long long* __restrict__ out, long long n) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = j < n;  // every lane stays: the warp stages rows together
  const uint32_t lo = active ? (uint32_t)__ldcs(iv + 2 * j) : 0u;
  const uint32_t hi = active ? (uint32_t)__ldcs(iv + 2 * j + 1) : 0u;
  const uint32_t c = active ? (uint32_t)__ldcs(code + j) : 0u;
  const uint32_t d = 32u * (uint32_t)nb;
  const int words = 2 * K * nb, stride = stage_stride(words);
  uint32_t* stage = warp_stage<K>(nb);
  const uint32_t* s = stage + (threadIdx.x & 31) * stride;
  const auto row_of = [&](uint32_t block) {
    return bitmaps + min((unsigned long long)block, (unsigned long long)(bm_rows - 1)) *
                         (unsigned long long)bm_words;
  };
  const uint32_t b_lo = lo / d, b_hi = hi / d;
  const bool split = b_lo != b_hi;
  bool back = false;
  const uint32_t cnt = active ? counter<K, AC>(occ, occ_rows, occ_words, b_lo, c, back) : 0u;
  stage_rows<V, LoadCached>(stage, stride, row_of(b_lo), active, words);
  uint32_t n_lo, n_hi, all;
  counts<K, AC>(s, nb, c, (int)(lo - b_lo * d), split ? 0 : (int)(hi - b_lo * d), n_lo, n_hi, all);
  const uint32_t o_lo = finish<K, AC>(cnt, back, n_lo, all, b_lo, c, lo, dollar);
  uint32_t o_hi = finish<K, AC>(cnt, back, n_hi, all, b_lo, c, hi, dollar);
  if (__any_sync(kFullWarp, active && split)) {
    __syncwarp();  // every lane is done with the first rows
    bool back2 = false;
    const uint32_t cnt2 = active && split ? counter<K, AC>(occ, occ_rows, occ_words, b_hi, c, back2) : 0u;
    stage_rows<V, LoadCached>(stage, stride, row_of(b_hi), active && split, words);
    if (active && split) {
      counts<K, AC>(s, nb, c, (int)(hi - b_hi * d), 0, n_hi, n_lo, all);
      o_hi = finish<K, AC>(cnt2, back2, n_hi, all, b_hi, c, hi, dollar);
    }
  }
  if (active) {
    __stcs(out + 2 * j, (long long)o_lo);
    __stcs(out + 2 * j + 1, (long long)o_hi);
  }
}

template <bool AC>
int launch(const void* bitmaps, long long bm_rows, int bm_words, const void* occ, long long occ_rows,
           int occ_words, int k, int nb, const void* iv, const void* code, const void* dollar, void* out,
           long long n, void* stream) {
  if (n <= 0) return 0;
  const int need = AC ? (1 << (2 * k)) / 2 : 1 << (2 * k);
  if (nb <= 0 || k < 1 || k > 8 || bm_rows <= 0 || occ_rows <= 0 || bm_words < 2 * k * nb ||
      occ_words < need)
    return (int)cudaErrorInvalidValue;
  return tpufm::dispatch_kv(k, tpufm::unit_words(bitmaps, bm_words), [&](auto K, auto V) {
    return tpufm::launch_staged(
        lf_round_split_kernel<decltype(K)::value, decltype(V)::value, AC>, k, nb, n,
        static_cast<cudaStream_t>(stream), static_cast<const uint32_t*>(bitmaps), bm_rows, bm_words,
        static_cast<const uint32_t*>(occ), occ_rows, occ_words, nb, static_cast<const long long*>(iv),
        static_cast<const long long*>(code), static_cast<const long long*>(dollar),
        static_cast<long long*>(out), n);
  });
}

// K9: the owner answer of one request a thread (see the header).
template <int K, int V>
__global__ void lf_answer_owned_kernel(const uint32_t* __restrict__ bitmaps, long long bm_rows,
                                       int bm_words, const uint32_t* __restrict__ occ,
                                       long long occ_rows, int occ_words, int nb,
                                       const uint32_t* __restrict__ req, uint32_t shard,
                                       uint32_t e_local, const long long* __restrict__ dollar,
                                       uint32_t* __restrict__ out, long long n) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = j < n;  // every lane stays: the warp stages rows together
  const uint32_t block = in ? __ldcs(req + 3 * j) : 0u;
  const uint32_t c = in ? __ldcs(req + 3 * j + 1) : 0u;
  const uint32_t v = in ? __ldcs(req + 3 * j + 2) : 0u;
  const bool owned = in && block / e_local == shard;
  const uint32_t local = block - shard * e_local;  // meaningful where owned
  const uint32_t d = 32u * (uint32_t)nb;
  const int words = 2 * K * nb, stride = stage_stride(words);
  uint32_t* stage = warp_stage<K>(nb);
  const uint32_t* s = stage + (threadIdx.x & 31) * stride;
  bool back = false;
  const uint32_t cnt = owned ? counter<K, false>(occ, occ_rows, occ_words, local, c, back) : 0u;
  const unsigned long long row = min((unsigned long long)local, (unsigned long long)(bm_rows - 1));
  stage_rows<V, LoadCached>(stage, stride, bitmaps + row * (unsigned long long)bm_words, owned, words);
  uint32_t before = 0, unused = 0;
  if (owned) lf_counts<K>(s, nb, c, (int)(v % d), 0, before, unused);
  if (in) __stcs(out + j, owned ? cnt + before - dollar_hits<K>(block, c, v, dollar) : 0u);
}

}  // namespace

// Launches K9 on `stream` and returns cudaGetLastError() (0 on success):
// bitmaps: uint32 [bm_rows, bm_words >= 2k*nb] and occ: uint32 [occ_rows,
// occ_words >= 4^k], shard `shard`'s rows (e_local of them, > 0); req:
// uint32 [n, 3] rows (block, code, interval); dollar: int64 [3, k] (rows
// pos, base, block; blocks global); out: uint32 [n]. Does not synchronise.
extern "C" int tpufm_lf_answer_owned(const void* bitmaps, long long bm_rows, int bm_words,
                                     const void* occ, long long occ_rows, int occ_words, int k,
                                     int nb, const void* req, long long shard, long long e_local,
                                     const void* dollar, void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  if (nb <= 0 || k < 1 || k > 8 || bm_rows <= 0 || occ_rows <= 0 || bm_words < 2 * k * nb ||
      occ_words < (1 << (2 * k)) || e_local <= 0 || e_local > 0xFFFFFFFFLL || shard < 0 ||
      shard > 0xFFFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  return tpufm::dispatch_kv(k, tpufm::unit_words(bitmaps, bm_words), [&](auto K, auto V) {
    return tpufm::launch_staged(
        lf_answer_owned_kernel<decltype(K)::value, decltype(V)::value>, k, nb, n,
        static_cast<cudaStream_t>(stream), static_cast<const uint32_t*>(bitmaps), bm_rows, bm_words,
        static_cast<const uint32_t*>(occ), occ_rows, occ_words, nb, static_cast<const uint32_t*>(req),
        (uint32_t)shard, (uint32_t)e_local, static_cast<const long long*>(dollar),
        static_cast<uint32_t*>(out), n);
  });
}

// Launches the split round on `stream` and returns cudaGetLastError() (0 on
// success): bitmaps: uint32 [bm_rows, bm_words >= 2k*nb]; occ: uint32
// [occ_rows, occ_words >= 4^k]; iv, out: int64 [n, 2]; code: int64 [n];
// dollar: int64 [3, k] (rows pos, base, block). Does not synchronise.
extern "C" int tpufm_lf_round_split(const void* bitmaps, long long bm_rows, int bm_words,
                                    const void* occ, long long occ_rows, int occ_words, int k,
                                    int nb, const void* iv, const void* code, const void* dollar,
                                    void* out, long long n, void* stream) {
  return launch<false>(bitmaps, bm_rows, bm_words, occ, occ_rows, occ_words, k, nb, iv, code, dollar,
                       out, n, stream);
}

// Launches the alternate-counters round: occ_slim: uint32 [occ_rows,
// occ_words >= 4^k / 2]; otherwise as tpufm_lf_round_split.
extern "C" int tpufm_lf_round_ac(const void* bitmaps, long long bm_rows, int bm_words,
                                 const void* occ_slim, long long occ_rows, int occ_words, int k,
                                 int nb, const void* iv, const void* code, const void* dollar,
                                 void* out, long long n, void* stream) {
  return launch<true>(bitmaps, bm_rows, bm_words, occ_slim, occ_rows, occ_words, k, nb, iv, code,
                      dollar, out, n, stream);
}

extern "C" const char* tpufm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
