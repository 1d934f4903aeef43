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
//     back == 0: out = cnt + count       - #levels(block, code, iv >  pos)
//     back == 1: out = cnt - (count_after - #levels(block, code, iv <= pos))
//   where count is the popcount of the k-mer's matches in the block before
//   iv and count_after the popcount from iv to the block's end (the
//   complemented prefix masks of tpufm), all mod 2^32.
//   tpufm_lf_answer_owned (K9) the owner answer of the sharded-index engine
//                         (_answer_owned, tpufm/parallel/search.py:267-290,
//                         jnp): the split round's per-end math on one shard
//                         of the entry table. Request j of a stream (block,
//                         code, interval; uint32 [n, 3], the rows the
//                         routings circulate) is owned by shard block /
//                         e_local; the shard answers its own from its local
//                         row (block - shard * e_local) of occ [e_local,
//                         4^k] and bitmaps [e_local, >= 2k*nb]:
//     out = occ[local, code] + count - #levels(block, code, iv > pos)
//                         with the '$' levels compared on the GLOBAL block
//                         (the '$' triple is replicated), and 0 for every
//                         request it does not own.
// Indices clamp as jnp gathers clamp: the row to bitmaps' last (row E,
// zeros), occ's row and column to its last, the slim row (block + back) to
// occ_slim's last (E+1, the safety row).
//
// Bound. Bytes: K8 per read int64 iv [2], code and out [2] (40 B), K9 per
// request 12 B in and 4 B out, and, once, the table words the ends need
// (of every distinct row the plane words of the windows the ends cover,
// and each distinct counter), over 3.35 TB/s: 15.7-15.8 us for K8 at 1M
// reads, 5.69 us for K9 at 2^20 requests (k=3 d=192, 10 Mbase). The bound
// counts a row once; the kernels fetch one a read (K8) or an owned request
// (K9) from L2, 144 B at k=3 d=192, and a 32-byte counter sector, so L2
// traffic (about 225 MB a K8 round at 1M reads: 1M x (144 + 32 B) for the
// rows and counters, plus 40 MB of iv, code and out) and the latency of
// those fetches are what hold them above it.
//
// Design. One thread a read (K8) or one or two requests (K9). A warp
// stages the plane rows it needs into shared memory by asynchronous copies
// (async_stage.cuh): the rows are listed by ballot, every 16-byte unit of
// every listed row is one cp.async, and the warp waits once; each lane's
// counter loads are issued before the copies and land meanwhile. Then each
// lane counts on its staged row (lf_round.cuh's row_counts, which K1's
// paired entry shares): at d = 192 (nb = 6) and k <= 3 the row is read as
// 16-byte vectors into registers (no bank conflicts), elsewhere word by
// word.
// - K8: a read's lo row in the lane's slot; where its hi lies in another
//   block, its hi row in one of kHiSlots (4) slots after the lo slots
//   (async_stage.cuh's HiRows, as K1's paired entry stages its next
//   halves), one a distinct hi block (__match_any_sync: every read of
//   round 1 from the full interval shares one), listed in the same batch
//   with its counter load; more distinct hi rows take further batches.
//   The AC entry counts one side of the end only: forward the windows
//   before it, back the windows from floor(s/32) to the block's end under
//   the complemented prefix masks, which is count_after itself. Reads stay
//   one a thread; iv, code and out stay int64 as the engines pass them, iv
//   and out moved as 16-byte pairs where aligned.
// - K9: the warp loads its requests (384 B for 32) as 16-byte units when
//   the stream's base is 16-byte aligned, else as coalesced words (a ring
//   half may start at any row), through shared memory; it stages only the
//   owned requests' rows, packed (about 1/D of an allgather or ring stream,
//   half of an a2a bucket), so its copies are popc(owned) x units; a warp
//   that owns nothing writes its zeros and stops. Where the grid at two
//   requests a lane still fills the card twice over (2^20-request allgather
//   streams on the H100), each lane takes two, so a warp's fetches of 64
//   requests overlap: one wait for them all while 32 slots hold the rows.
// Times (NVIDIA H100 80GB HBM3, 700 W, scripts/k89_ab.py, PERF.md §6): the
// first versions staged through stage_rows (a register trip a 16-byte
// unit, 32 x units trips a warp, every lane's row, K8's hi rows in a second
// staging round, the AC entry counting every window): K8 split
// 0.0533-0.0552 ms, AC 0.0564-0.0569 (round 18) and 0.0720-0.0723 (round
// 1), K9 0.0316-0.0318 at 2^20 requests; this design 0.0425-0.0432,
// 0.0418-0.0422 and 0.0425, 0.0165-0.0167.
// Tried and slower: two full slots a lane for K8 (half the resident
// warps), 8 or 16 hi slots, K8 held to 48 registers for 40 warps an SM
// (4-25% slower: more traffic in flight, no gain), four requests a lane
// for K9 (too few warps for 2^17 and 2^19 requests; taken by size, 12%
// slower on the 2^20-request allgather stream at 10 Mbase, 6% faster at
// 250 Mbase), K9's lanes each
// answering their own requests (most of a warp idle on the requests it
// does not own), a persistent K9 whose warps fetch their next requests
// behind the current rows (0.0214 against 0.0159 ms: 92 registers, fewer
// warps), the word-by-word count at d = 192, and async_stage.cuh's
// dropped copy paths.
//
// Types. Intervals are uint32_t here and int64 on the torch side; table
// words arrive as int32 tensors holding the uint32 bits.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "async_stage.cuh"
#include "lf_round.cuh"

namespace {

using tpufm::HiRows;
using tpufm::LoadCached;
using tpufm::WarpStage;
using tpufm::dispatch_nb;
using tpufm::dollar_hits;
using tpufm::issue_rows_async;
using tpufm::kFullWarp;
using tpufm::kHiSlots;
using tpufm::lf_finish;
using tpufm::load_read;
using tpufm::row_counts;
using tpufm::stage_rows_async;
using tpufm::stage_stride;
using tpufm::store_read;
using tpufm::wait_rows_async;

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

// The rounds of the ends v0 and v1 (in-block offsets s0, s1) of block b
// under code c, from the staged row s and the block's counter: the split
// entry counts before the ends (lf_finish), the AC entry on the side `back`
// selects.
template <int K, int NB, bool AC>
__device__ __forceinline__ void finish(const uint32_t* s, int nb, uint32_t cnt, bool back, uint32_t b,
                                       uint32_t c, uint32_t v0, uint32_t v1, int s0, int s1,
                                       const long long* __restrict__ dollar, uint32_t& o0, uint32_t& o1) {
  if (!AC) {
    lf_finish<K, NB>(s, nb, cnt, c, b, v0, s0, b, v1, s1, dollar, o0, o1);
    return;
  }
  uint32_t n0, n1;
  row_counts<K, NB>(s, nb, c, s0, s1, back, n0, n1);
  if (back) {
    o0 = cnt - (n0 - dollar_hits_ac<K>(b, c, v0, true, dollar));
    o1 = cnt - (n1 - dollar_hits_ac<K>(b, c, v1, true, dollar));
  } else {
    o0 = cnt + (n0 - dollar_hits_ac<K>(b, c, v0, false, dollar));
    o1 = cnt + (n1 - dollar_hits_ac<K>(b, c, v1, false, dollar));
  }
}

template <int K, int V, int NB, bool AC>
__global__ void lf_round_split_kernel(const uint32_t* __restrict__ bitmaps, long long bm_rows,
                                      int bm_words, const uint32_t* __restrict__ occ,
                                      long long occ_rows, int occ_words, int nb,
                                      const long long* __restrict__ iv,
                                      const long long* __restrict__ code,
                                      const long long* __restrict__ dollar,
                                      long long* __restrict__ out, long long n) {
  const int lane = threadIdx.x & 31;
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j - lane >= n) return;  // the whole warp is past the end
  const bool active = j < n;  // every lane of a live warp stays: the warp stages rows together
  const bool pairs = ((reinterpret_cast<uintptr_t>(iv) | reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  uint32_t lo, hi, c;
  load_read(iv, code, j, active, pairs, lo, hi, c);
  const uint32_t d = 32u * (uint32_t)nb;
  const int words = 2 * K * nb, stride = stage_stride(words);
  const auto row_of = [&](uint32_t block) {
    return bitmaps + min((unsigned long long)block, (unsigned long long)(bm_rows - 1)) *
                         (unsigned long long)bm_words;
  };
  const uint32_t b_lo = lo / d, b_hi = hi / d;
  const bool split = active && b_lo != b_hi;
  bool back = false, back2 = false;
  const uint32_t cnt = active ? counter<K, AC>(occ, occ_rows, occ_words, b_lo, c, back) : 0u;
  const uint32_t cnt2 = split ? counter<K, AC>(occ, occ_rows, occ_words, b_hi, c, back2) : 0u;
  // lo rows in slot lane; the split reads' hi rows, one a distinct block, in
  // the hi slots of the same batch
  const HiRows his(split, b_hi);
  const WarpStage<32 + kHiSlots> w = WarpStage<32 + kHiSlots>::at(stride, 0);
  const int jobs = w.list(0, active, row_of(b_lo), lane);
  stage_rows_async<V>(w, stride, his.list(w, jobs, 0, row_of(b_hi)), words);
  const int s_lo = (int)(lo - b_lo * d), s_hi = (int)(hi - b_hi * d);
  uint32_t o_lo = 0, o_hi = 0, unused;
  if (active)
    finish<K, NB, AC>(w.rows + lane * stride, nb, cnt, back, b_lo, c, lo, hi, s_lo, split ? s_lo : s_hi, dollar,
                      o_lo, o_hi);
  for (int base = 0; base < his.groups; base += kHiSlots) {
    if (base > 0) {  // the hi rows past the slots: a further batch
      __syncwarp();  // every lane is done with the slots
      stage_rows_async<V>(w, stride, his.list(w, 0, base, row_of(b_hi)), words);
    }
    if (his.in(base))
      finish<K, NB, AC>(w.rows + his.slot(base) * stride, nb, cnt2, back2, b_hi, c, hi, hi, s_hi, s_hi, dollar,
                        o_hi, unused);
  }
  if (active) store_read(out, j, pairs, o_lo, o_hi);
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
  const size_t warp_bytes = WarpStage<32 + kHiSlots>::bytes(stage_stride(2 * k * nb), 0);
  return tpufm::dispatch_kv(k, tpufm::unit_words(bitmaps, bm_words), [&](auto K, auto V) {
    return dispatch_nb<decltype(K)::value>(nb, [&](auto NB) {
      return tpufm::launch_async_staged(
          lf_round_split_kernel<decltype(K)::value, decltype(V)::value, decltype(NB)::value, AC>, warp_bytes, n,
          static_cast<cudaStream_t>(stream), static_cast<const uint32_t*>(bitmaps), bm_rows, bm_words,
          static_cast<const uint32_t*>(occ), occ_rows, occ_words, nb, static_cast<const long long*>(iv),
          static_cast<const long long*>(code), static_cast<const long long*>(dollar),
          static_cast<long long*>(out), n);
    });
  });
}

// K9's least count of the card's resident warps its grid must fill before
// it takes two requests a lane.
constexpr int kK9Waves = 2;

// K9's words of shared memory a warp beside its row slots: its requests (G
// a lane), then each slot's request (block, code, interval, counter) and
// answer.
__host__ __device__ constexpr int k9_extra_words(int G) { return 3 * 32 * G + 5 * 32; }

// K9: the owner answers of G requests a lane (see the header).
template <int K, int V, int NB, int G>
__global__ void lf_answer_owned_kernel(const uint32_t* __restrict__ bitmaps, long long bm_rows,
                                       int bm_words, const uint32_t* __restrict__ occ,
                                       long long occ_rows, int occ_words, int nb,
                                       const uint32_t* __restrict__ req, uint32_t shard,
                                       uint32_t e_local, const long long* __restrict__ dollar,
                                       uint32_t* __restrict__ out, long long n) {
  const int lane = threadIdx.x & 31;
  const long long first = ((long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * (32 * G);
  if (first >= n) return;  // the whole warp is past the end
  const int words = 2 * K * nb, stride = stage_stride(words);
  const WarpStage<32> w = WarpStage<32>::at(stride, k9_extra_words(G));
  uint32_t* const reqs = w.extra;              // [32 G][3]
  uint32_t* const meta = w.extra + 3 * 32 * G;  // [4][32]: a slot's block, code, interval, counter
  uint32_t* const answers = meta + 4 * 32;      // [32]
  // the warp's requests, coalesced, through shared memory: 16-byte units
  // where the stream is aligned and the warp full (its requests start on a
  // 16-byte boundary), else words
  const uint32_t* base = req + 3 * first;
  const int have = n - first < 32 * G ? (int)(n - first) : 32 * G;
  if (have == 32 * G && (reinterpret_cast<uintptr_t>(req) & 15u) == 0) {
    for (int t = lane; t < 3 * 32 * G / 4; t += 32)
      reinterpret_cast<uint4*>(reqs)[t] = __ldcs(reinterpret_cast<const uint4*>(base) + t);
  } else {
    for (int t = lane; t < 3 * have; t += 32) reqs[t] = __ldcs(base + t);
  }
  __syncwarp();
  uint32_t block[G], cnt[G], res[G];
  bool owned[G];
  int at[G];
  bool mine = false;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int r = 32 * g + lane;
    block[g] = r < have ? reqs[3 * r] : 0u;
    owned[g] = r < have && block[g] / e_local == shard;
    bool back;  // the split table's counter: no back entry
    cnt[g] = owned[g] ? counter<K, false>(occ, occ_rows, occ_words, block[g] - shard * e_local, reqs[3 * r + 1],
                                          back)
                      : 0u;
    res[g] = 0u;
    at[g] = -1;
    mine = mine || owned[g];
  }
  if (__any_sync(kFullWarp, mine)) {
    const uint32_t d = 32u * (uint32_t)nb;
    // the owned requests packed into the 32 slots, group after group; a
    // batch is staged, then answered a slot a lane (no lane idles on a
    // request it does not own), each answer read back by its request's lane
    const auto answer = [&](int jobs) {
      issue_rows_async<V>(w, stride, jobs, words);
#pragma unroll
      for (int g = 0; g < G; ++g)  // the counters, landed while the copies were issued
        if (at[g] >= 0) meta[96 + at[g]] = cnt[g];
      wait_rows_async();
      if (lane < jobs) {
        const uint32_t b = meta[lane], c = meta[32 + lane], v = meta[64 + lane];
        const int s0 = (int)(v % d);
        uint32_t before, unused;
        row_counts<K, NB>(w.rows + lane * stride, nb, c, s0, s0, false, before, unused);
        answers[lane] = meta[96 + lane] + before - dollar_hits<K>(b, c, v, dollar);
      }
      __syncwarp();
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (at[g] >= 0) res[g] = answers[at[g]];
        at[g] = -1;
      }
      __syncwarp();  // every lane is done with the slots
    };
    int jobs = 0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (jobs + __popc(__ballot_sync(kFullWarp, owned[g])) > 32) {  // the slots are full
        answer(jobs);
        jobs = 0;
      }
      const unsigned long long local = min((unsigned long long)(block[g] - shard * e_local),
                                           (unsigned long long)(bm_rows - 1));
      jobs = w.list_packed(jobs, owned[g], bitmaps + local * (unsigned long long)bm_words, at[g]);
      if (owned[g]) {
        const int r = 32 * g + lane;
        meta[at[g]] = block[g];
        meta[32 + at[g]] = reqs[3 * r + 1];
        meta[64 + at[g]] = reqs[3 * r + 2];
      }
    }
    answer(jobs);
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
    if (32 * g + lane < have) __stcs(out + first + 32 * g + lane, res[g]);
}

}  // namespace

// Launches K9 on `stream` and returns cudaGetLastError() (0 on success):
// bitmaps: uint32 [bm_rows, bm_words >= 2k*nb] and occ: uint32 [occ_rows,
// occ_words >= 4^k], shard `shard`'s rows (e_local of them, > 0); req:
// uint32 [n, 3] rows (block, code, interval), at any 4-byte offset; dollar:
// int64 [3, k] (rows pos, base, block; blocks global); out: uint32 [n].
// Does not synchronise.
extern "C" int tpufm_lf_answer_owned(const void* bitmaps, long long bm_rows, int bm_words,
                                     const void* occ, long long occ_rows, int occ_words, int k,
                                     int nb, const void* req, long long shard, long long e_local,
                                     const void* dollar, void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  if (nb <= 0 || k < 1 || k > 8 || bm_rows <= 0 || occ_rows <= 0 || bm_words < 2 * k * nb ||
      occ_words < (1 << (2 * k)) || e_local <= 0 || e_local > 0xFFFFFFFFLL || shard < 0 ||
      shard > 0xFFFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  // two requests a lane where the grid at two still fills the card's
  // resident warps kK9Waves times over (on the H100 at k=3 d=192: from
  // 608,256 requests, so the 2^20-request allgather streams), else one:
  // two a lane overlap more fetches a warp, fewer warps idle SMs at the
  // grid's tail
  const int stride = stage_stride(2 * k * nb);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int resident = tpufm::resident_warps(WarpStage<32>::bytes(stride, k9_extra_words(2)));
  const bool two = n >= (long long)kK9Waves * 32 * 2 * sms * resident;
  return tpufm::dispatch_kv(k, tpufm::unit_words(bitmaps, bm_words), [&](auto K, auto V) {
    return dispatch_nb<decltype(K)::value>(nb, [&](auto NB) {
      const auto run = [&](auto G) {
        return tpufm::launch_async_staged(
            lf_answer_owned_kernel<decltype(K)::value, decltype(V)::value, decltype(NB)::value, decltype(G)::value>,
            WarpStage<32>::bytes(stride, k9_extra_words(G)), (n + G - 1) / G, static_cast<cudaStream_t>(stream),
            static_cast<const uint32_t*>(bitmaps), bm_rows, bm_words, static_cast<const uint32_t*>(occ), occ_rows,
            occ_words, nb, static_cast<const uint32_t*>(req), (uint32_t)shard, (uint32_t)e_local,
            static_cast<const long long*>(dollar), static_cast<uint32_t*>(out), n);
      };
      return two ? run(std::integral_constant<int, 2>{}) : run(std::integral_constant<int, 1>{});
    });
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
