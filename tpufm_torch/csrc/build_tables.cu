// K7: the k-step index's tables from the text and its suffix array, for
// Hopper (sm_90a).
//
// A new kernel with no Pallas counterpart: tpufm computes this pass as jnp
// (_build_tables, tpufm/index/builder_device.py:35-101; per shard,
// _table_program in tpufm/index/builder_sharded.py:36-198), and this
// kernel computes what it computes, on a slice of the suffix array: rows
// [p0, p0 + rows) of it, p0 a multiple of d (the whole build is the slice
// p0 = 0, rows = n + 1). With bwtsize big = n + 1, E = ceil(rows / d)
// blocks of d = 32 * nb positions, T the text with T[n] = 0 ('$' read as
// 'A'), sa[p] = SA[p0 + p], and the row p0 + p a pad where p >= rows or
// p0 + p >= big (a pad's SA value is not read):
//
//   BWT_i[p] = T[(sa[p] - 1 - i) mod big], 0 at a pad, for each level i < k
//   bitmaps[e, i, plane, w]: bit 31 - j set iff bit `plane` of
//              BWT_i[e * d + 32 * w + j] is set (MSB-first); row E is the
//              wrapper's (zero)
//   counts[e, c]: over the nb words of block e, the popcount of the AND over
//              levels of the planes (or their complements) that k-mer c
//              selects, i.e. the positions of block e whose k-mer code
//              sum_i BWT_i[p] << 2i is c; uncorrected, as tpufm's: each '$'
//              is counted as its 'A'-read k-mer and each pad as k-mer 0
//   dollar_pos[sa[p]] = p (the row within the slice) where sa[p] < k; the
//              wrapper adds p0
//
// The wrapper (build_tables) packs the text 2 bits a base first, a launch
// of pack_text_kernel below on each call: 16 bases a uint32 word, base j at
// bits 31 - 2 * (j % 16) .. 30 - 2 * (j % 16), zero past n, one guard word
// (the layout of engine/seed.py's pack_text_words). K7 reads that pack and
// the suffix array as int32 (values 0..n); the planes leave as uint32 words
// and the counts as int32 (at most d).
//
// Bound, of the wrapper's two launches together. Bytes: the text (1 B a
// base, read by the pack) and the suffix array (4 B a position) read once,
// the planes (k / 4 B a position) and counts (4^k * 4 B a block) written
// once: at 10 Mbase, k=3 d=192, 70.8 MB, 21.1 us at 3.35 TB/s. The pack
// itself is not in the bound: it is the design's, not the function's. K7
// reads it at random: a position's k symbols, T[SA[p] - k .. SA[p] - 1],
// lie in one 32-byte sector or straddle two, so the memory system carries
// about 32 B a position where the bound counts one byte or less
// (chip_smoke.py prints the sector counts, 10,625,000 of the byte text and
// 10,156,250 of the pack at 10 Mbase: references at HBM rate, not bounds,
// since a 10 Mbase text stays in the 50 MB L2; a 250 Mbase text does not,
// neither its 250 MB of bytes nor its 62.5 MB pack).
//
// What the first version lost: a thread walked its word's 32 positions in
// series, one SA value and k one-byte text loads at a time, so it waited
// one L2 round trip a position, 32 in a row; neighbouring threads read SA
// values 128 B apart (32 lines a warp load); the counts took 4^k * 2k
// shared loads a word after a block-wide barrier (2,048 at k=4, ~10^6 at
// k=8), and a block's planes were staged in shared memory (a 48 KB limit
// tpufm does not have). It ran at 5.3-5.5% of its bound.
//
// The design:
//   * A warp owns one FM block; lane j takes position 32 * w + j of each
//     word w, so a warp load of SA values is one 128-byte line. The warp
//     loads the SA values of kBatch words, then every position's text
//     window, before it uses any: kBatch independent loads a lane in flight
//     at each step, not one. The SA is read and the outputs written with
//     evict-first hints (__ldcs / __stcs), so the packed text keeps L2.
//   * One window load a position: the 8-byte aligned pair of packed words
//     (32 bases) that holds base s - k (s = SA[p] >= k), and the next word
//     only for the windows that run past it ((k - 1) / 32 of them, a
//     predicated load that costs the other lanes nothing). The k symbols
//     T[s-k .. s-1] are the top 2k bits of the window shifted to base s - k,
//     which is also the position's k-mer code (level i in bits 2i, 2i + 1).
//     Only the k rows with s < k can wrap below 0; they take a slow path
//     that keeps the modulo loop (several wraps when n + 1 < k) and set
//     dollar_pos. A pad (p past the slice's rows below big, one compare
//     with the launcher's min(rows, big - p0)) has code 0 and loads nothing.
//   * Plane j of a word (bit j of the codes: level j / 2, plane j % 2) is
//     __brev(__ballot_sync(bit j)); lane u keeps the 2k words of word
//     w0 + u, and the warp stores each plane's kBatch words as one run.
//   * Counts by histogram: lanes with equal codes merge by
//     __match_any_sync and their leader adds the popcount, so each word
//     costs about one update a lane at every k. For k <= 4 the warp keeps
//     4^k counters in shared memory (at most 1 KB) and writes its row with
//     coalesced stores; for k >= 5 it zeroes its row in device memory with
//     16-byte stores and adds into it there.
//   No block-wide staging: nothing limits k or d beyond k <= 8.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py phase 16, k=3
// d=192, device time of the wrapper's pack and K7): 0.098 ms at 10 Mbase
// (21.5% of the bound; the pack 0.004 ms of it), 5.32 ms at 250 Mbase
// (9.9%; the pack 0.12 ms), 2.2x the time a base, as most window loads
// there miss L2: one random sector request a position sets the time. In
// design runs on the card, two 4-byte window loads in place of the one
// were slightly slower, and an L2 evict_last hint on the window load
// gained nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // warps a block, one FM block each
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = 8;  // words a warp loads before it uses any
constexpr unsigned kAll = 0xFFFFFFFFu;

struct Args {
  const uint32_t* words;  // packed text, ceil(n / 16) + 1 words
  long long n;
  const int* sa;  // rows [p0, p0 + rows) of the suffix array
  long long real;  // its rows below big: min(rows, big - p0), the rest pads
  int nb;
  long long E;
  uint32_t* bitmaps;
  int* counts;
  long long* dollar_pos;
};

// T[q] for 0 <= q <= n, with T[n] = 0
__device__ __forceinline__ uint32_t symbol(const uint32_t* words, long long q, long long n) {
  return q < n ? (__ldg(words + (q >> 4)) >> (30 - 2 * (int)(q & 15))) & 3u : 0u;
}

// The k=3 instance (the main path's) is held to 4 blocks an SM (at most
// 64 registers a thread), the others to 1. Measured on the H100 against
// the kernel before it took slices (scripts/k7_ab.py, K7 alone at
// 10 Mbase): with no minimum, k=3 was 0.5-1.7% slower (60 registers) and
// k=4 3-4%; with 4 for every k, k=4 5% and k=6 1.5%; as here, k=1-3 and 6
// 0.2-3.0% faster, k=4 2.2% slower.
template <int K>
__global__ void __launch_bounds__(kThreads, K == 3 ? 4 : 1) build_tables_kernel(Args a) {
  constexpr int C = 1 << (2 * K);
  constexpr bool kSharedCounts = K <= 4;
  __shared__ int hist[kWarps][kSharedCounts ? C : 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long e = (long long)blockIdx.x * kWarps + warp;
  if (e >= a.E) return;  // the whole warp
  const long long big = a.n + 1;
  const int nb = a.nb;
  const long long first = e * 32LL * nb;
  int* row = a.counts + e * C;
  if constexpr (kSharedCounts) {
    for (int c = lane; c < C; c += 32) hist[warp][c] = 0;
  } else {
    for (int c = lane; c < C / 4; c += 32) __stcs(reinterpret_cast<int4*>(row) + c, make_int4(0, 0, 0, 0));
  }
  __syncwarp();
  uint32_t* planes = a.bitmaps + e * 2 * K * nb;

  for (int w0 = 0; w0 < nb; w0 += kBatch) {
    int s[kBatch];  // SA[p], -1 for the padding
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long p = first + 32LL * (w0 + u) + lane;
      s[u] = w0 + u < nb && p < a.real ? __ldcs(a.sa + p) : -1;
    }
    // the 32 bases of the aligned word pair that holds base s - K, and the
    // next word where the window runs past them ((s - K) % 32 > 32 - K)
    uint2 pair[kBatch];
    uint32_t next[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int from = s[u] - K;
      pair[u] = from >= 0 ? __ldg(reinterpret_cast<const uint2*>(a.words) + (from >> 5)) : make_uint2(0u, 0u);
      next[u] = from >= 0 && (from & 31) > 32 - K ? __ldg(a.words + (from >> 5) * 2 + 2) : 0u;
    }
    uint32_t keep[2 * K];  // lane u: the planes of word w0 + u
#pragma unroll
    for (int j = 0; j < 2 * K; ++j) keep[j] = 0u;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (w0 + u >= nb) break;  // uniform across the warp
      uint32_t code = 0u;
      if (s[u] >= K) {
        const int off = (s[u] - K) & 31;
        unsigned long long x = ((unsigned long long)pair[u].x << 32 | pair[u].y) << (2 * off);
        if (off > 32 - K) x |= ((unsigned long long)next[u] << 32) >> (64 - 2 * off);
        code = (uint32_t)(x >> (64 - 2 * K));
      } else if (s[u] >= 0) {  // a '$' row: its levels wrap
        a.dollar_pos[s[u]] = first + 32LL * (w0 + u) + lane;
#pragma unroll
        for (int i = 0; i < K; ++i) {
          long long q = (long long)s[u] - 1 - i;
          while (q < 0) q += big;  // more than once only for a text shorter than k
          code |= symbol(a.words, q, a.n) << (2 * i);
        }
      }
#pragma unroll
      for (int j = 0; j < 2 * K; ++j) {
        const uint32_t word = __brev(__ballot_sync(kAll, (code >> j) & 1u));
        if (lane == u) keep[j] = word;
      }
      const unsigned peers = __match_any_sync(kAll, code);
      if (lane == __ffs(peers) - 1) {
        if constexpr (kSharedCounts) {
          atomicAdd(&hist[warp][code], __popc(peers));
        } else {
          atomicAdd(row + code, __popc(peers));
        }
      }
    }
    if (lane < kBatch && w0 + lane < nb) {
#pragma unroll
      for (int j = 0; j < 2 * K; ++j) __stcs(planes + j * nb + w0 + lane, keep[j]);
    }
  }
  if constexpr (kSharedCounts) {
    __syncwarp();
    for (int c = lane; c < C; c += 32) __stcs(row + c, hist[warp][c]);
  }
}

template <int K>
int launch(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.E + kWarps - 1) / kWarps;
  build_tables_kernel<K><<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// The text's 2-bit pack (the input above): thread w writes word w of
// ceil(n / 16) + 1, its 16 bases' low two bits MSB-first, zero past n. A
// stream: n bytes in, n / 4 out (16-byte loads where the text is aligned).
__global__ void pack_text_kernel(const uint8_t* codes, long long n, uint32_t* words, long long nw) {
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= nw) return;
  const long long b0 = 16 * w;
  uint32_t word = 0u;
  if (b0 + 16 <= n && (reinterpret_cast<uintptr_t>(codes) & 15) == 0) {
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(codes) + w);
    const uint32_t part[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 16; ++j) word |= ((part[j >> 2] >> (8 * (j & 3))) & 3u) << (30 - 2 * j);
  } else {
    for (int j = 0; j < 16 && b0 + j < n; ++j) word |= (codes[b0 + j] & 3u) << (30 - 2 * j);
  }
  words[w] = word;
}

}  // namespace

// Launches the 2-bit pack of a uint8 text [n] into words, uint32
// [ceil(n / 16) + 1], on `stream`; returns cudaGetLastError().
extern "C" int tpufm_pack_text(const void* codes, long long n, void* words, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  const long long nw = (n + 15) / 16 + 1;
  pack_text_kernel<<<(unsigned)((nw + kThreads - 1) / kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), n, static_cast<uint32_t*>(words), nw);
  return (int)cudaGetLastError();
}

// Launches K7 on `stream` and returns cudaGetLastError() (0 on success).
// words: the packed text, uint32 [ceil(n / 16) + 1], 8-byte aligned; sa:
// int32 [rows], rows p0 .. p0 + rows - 1 of the suffix array (p0 a
// multiple of 32 * nb; rows >= 1); bitmaps: uint32 [E + 1, k, 2, nb] with
// E = ceil(rows / (32 * nb)) (rows 0..E-1 written); counts: int32 [E, 4^k]
// (16-byte aligned); dollar_pos: int64 [k] (set by the caller; entry sa[p]
// set to p, the row within the slice, where sa[p] < k). Does not
// synchronise.
extern "C" int tpufm_build_tables(const void* words, long long n, const void* sa, long long rows, long long p0,
                                  int k, int nb, void* bitmaps, void* counts, void* dollar_pos, void* stream) {
  if (n < 0 || rows < 1 || p0 < 0 || k < 1 || k > 8 || nb < 1 || p0 % (32LL * nb))
    return (int)cudaErrorInvalidValue;
  const long long real = p0 > n ? 0 : (rows < n + 1 - p0 ? rows : n + 1 - p0);
  Args a{static_cast<const uint32_t*>(words), n, static_cast<const int*>(sa), real, nb,
         (rows + 32LL * nb - 1) / (32LL * nb), static_cast<uint32_t*>(bitmaps), static_cast<int*>(counts),
         static_cast<long long*>(dollar_pos)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(a, s);
    case 2: return launch<2>(a, s);
    case 3: return launch<3>(a, s);
    case 4: return launch<4>(a, s);
    case 5: return launch<5>(a, s);
    case 6: return launch<6>(a, s);
    case 7: return launch<7>(a, s);
    default: return launch<8>(a, s);
  }
}

extern "C" const char* tpufm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
