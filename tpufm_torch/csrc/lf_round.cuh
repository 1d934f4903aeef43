// The LF round of one interval end, or of both ends of a read: the round
// body shared by K1 (lf_round.cu: lf_rounds for its pair, per-end and rows
// entries) and K4's LF(1) hop (locate_walk.cu), and the count (row_counts,
// lf_finish) that K1's paired entry, K8 and K9 (lf_round_split.cu) take on
// rows staged by async_stage.cuh, so that one copy of the LF math serves
// every kernel.
//
//   count  = sum over windows w of popcount(prefix_mask(v % d, w)
//            & AND over levels i of plane pair i, each plane taken as is or
//              complemented by the matching bit of c)
//   count -= #levels i with block == dollar_block[i], c == dollar_base[i]
//            and v > dollar_pos[i]
//   out    = r[2K*nb + (c mod 4^K)] + count          (mod 2^32)
//
// r is the end's row (row_words >= 2K*nb + 4^K; words past the 4^K counters,
// e.g. alignment padding or the locate rows' mark columns, are never read).
// Plane q of the row (level q / 2, bit q % 2 of the code) holds window w at
// word q*nb + w: the JAX package's plane-major layout, kept on the device.
// block = v / d comes from the interval itself, never from which row r is:
// the '$' correction compares it with dollar_block exactly as
// _lf_round_kernel does (pallas_kernel.py:56, :92-97). dollar: int64 [3, K],
// rows pos, base, block.
//
// Loads. Every lane of a warp has a row of its own at a random place, so a
// load instruction that each lane issues for its own row touches 32 sectors
// at once, and two of a lane's loads into one sector are two L2 requests
// when they are in flight together. So the warp stages its 32 rows together
// (stage_rows): its lanes copy consecutive 16-byte units of one row at a
// time, so each row's plane block arrives as whole sectors, each requested
// once, in the lane's slot of shared memory; then each lane computes its
// own end(s) from there, indexing words freely (d is a run-time value). On
// the H100 at k=3 d=192 this beat one lane loading its own row, whether as
// 8-byte vectors of the covered windows or as nine 16-byte vectors of the
// whole plane block. The counter, one word by index, is loaded by its lane
// before the staging, so that it is in flight meanwhile. The TPU's
// binary-tree counter pick was a lane-select workaround and is not ported.
// Banks: the lanes' reads of one word of their own slots fall into few
// banks (slots of 36 words: 4-way conflicts; K4's 24: 8-way). A
// conflict-free layout (slots of an odd number of 16-byte units, each unit
// rotated by lane / 8) was slower on the H100 (K1 per end at 2M random ends
// 0.0962-0.1020 ms against 0.0872-0.0889, K4 at 1M rows 0.65-0.69 against
// 0.52): its index arithmetic cost more than the conflicts, so they are
// not what limits these kernels.

#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace tpufm {

constexpr unsigned kFullWarp = 0xFFFFFFFFu;

// Row loads through the read-only path, cached: a table that many ends and
// rounds reuse.
struct LoadCached {
  template <typename T>
  static __device__ __forceinline__ T ld(const T* p) { return __ldg(p); }
};

// Evict-first row loads: rows gathered for one use, which would otherwise
// push the table out of L2.
struct LoadStreaming {
  template <typename T>
  static __device__ __forceinline__ T ld(const T* p) { return __ldcs(p); }
};

template <int V> struct Unit;
template <> struct Unit<1> { using T = uint32_t; };
template <> struct Unit<4> { using T = uint4; };

// The unit (4 or 1 words) in which every row of a table copies aligned: 4
// when the row stride is a multiple of 4 words and the base 16-byte aligned
// (the engines' padded device tables), else single words.
inline int unit_words(const void* table, int row_words) {
  return row_words % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 ? 4 : 1;
}

// Words of shared memory a lane's staged row takes: `words` rounded up to
// whole 16-byte units.
__host__ __device__ constexpr int stage_stride(int words) { return (words + 3) / 4 * 4; }

// Warp-cooperative copy of the first `words` words of every lane's `row`
// into that lane's slot (stride words) of the warp's `stage`, skipping the
// rows of lanes that are not `active`. Consecutive lanes copy consecutive
// V-word units of one row, so a row's loads coalesce into whole sectors.
// Every lane of the warp calls it; a row is copied in whole units, which
// stay inside it (V divides the row stride). Ends with __syncwarp, so the
// staged words are visible to every lane. (Holding a batch of loads in
// registers before storing them was slower on the H100: the registers cost
// more warps than the overlap gained.)
template <int V, class Ld>
__device__ __forceinline__ void stage_rows(uint32_t* stage, int stride, const uint32_t* row,
                                           bool active, int words) {
  using T = typename Unit<V>::T;
  const int units = (words + V - 1) / V;
  const unsigned long long from = reinterpret_cast<unsigned long long>(row);
  // the same trip count, `units`, in every lane: the shuffles stay uniform
  for (int t = threadIdx.x & 31; t < 32 * units; t += 32) {
    const int i = t / units, u = t - i * units;
    const auto src = reinterpret_cast<const T*>(__shfl_sync(kFullWarp, from, i));
    if (__shfl_sync(kFullWarp, (int)active, i))
      *reinterpret_cast<T*>(stage + i * stride + u * V) = Ld::ld(src + u);
  }
  __syncwarp();
}

// The bits of window w before position `shift` of the block: the top
// clip(shift - 32w, 0, 32) bits (never a shift by 32).
__device__ __forceinline__ uint32_t prefix_mask(int shift, int w) {
  const int cov = shift - 32 * w;
  return cov <= 0 ? 0u : (cov >= 32 ? 0xFFFFFFFFu : 0xFFFFFFFFu << (32 - cov));
}

// Popcounts of the k-mer c's matches on a staged row s (plane q, window w
// at s[q*nb + w]) before the in-block offsets s0 and s1 (forward: the
// windows before the larger, ceil(max/32) of them), or from them to the
// block's end (back, the alternate counters' side: the windows from
// floor(min/32) on, under the complemented prefix masks). The one copy of
// the count: K1's entries, K4's hop, K8 and K9.
// NB > 0: nb == NB, and the row is read as 16-byte vectors into registers
// (the slot 16-byte aligned), every window counted under its masks, which
// are 0 past the side counted; a lane's vector reads of its own slot (9
// units at k=3 d=192) meet no bank conflict, where its word reads of the
// generic path (NB = 0) meet four-way ones.
template <int K, int NB>
__device__ __forceinline__ void row_counts(const uint32_t* s, int nb, uint32_t c, int s0, int s1, bool back,
                                           uint32_t& n0, uint32_t& n1) {
  n0 = n1 = 0;
  const auto add = [&](uint32_t m, int w) {
    const uint32_t f = back ? 0xFFFFFFFFu : 0u;
    n0 += __popc(m & (prefix_mask(s0, w) ^ f));
    n1 += __popc(m & (prefix_mask(s1, w) ^ f));
  };
  if constexpr (NB > 0) {
    constexpr int U = (2 * K * NB + 3) / 4;
    uint32_t r[4 * U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const uint4 x = reinterpret_cast<const uint4*>(s)[u];
      r[4 * u] = x.x;
      r[4 * u + 1] = x.y;
      r[4 * u + 2] = x.z;
      r[4 * u + 3] = x.w;
    }
#pragma unroll
    for (int w = 0; w < NB; ++w) {
      uint32_t m = 0xFFFFFFFFu;
#pragma unroll
      for (int q = 0; q < 2 * K; ++q) m &= ((c >> q) & 1u) ? r[q * NB + w] : ~r[q * NB + w];
      add(m, w);
    }
  } else {
    const int lo = back ? (s0 < s1 ? s0 : s1) >> 5 : 0;
    const int hi = back ? nb : ((s0 > s1 ? s0 : s1) + 31) >> 5;
    for (int w = lo; w < hi; ++w) {
      uint32_t m = 0xFFFFFFFFu;
#pragma unroll
      for (int q = 0; q < 2 * K; ++q) {
        const uint32_t x = s[q * nb + w];
        m &= ((c >> q) & 1u) ? x : ~x;
      }
      add(m, w);
    }
  }
}

// The forward count on a row read word by word (K1's staged entries, K4's
// hop): row_counts<K, 0> before s0 and s1.
template <int K>
__device__ __forceinline__ void lf_counts(const uint32_t* s, int nb, uint32_t c, int s0, int s1,
                                          uint32_t& n0, uint32_t& n1) {
  row_counts<K, 0>(s, nb, c, s0, s1, false, n0, n1);
}

// The '$' correction: levels whose '$' lies in this block before v with
// k-mer c.
template <int K>
__device__ __forceinline__ uint32_t dollar_hits(uint32_t block, uint32_t c, uint32_t v,
                                                const long long* __restrict__ dollar) {
  uint32_t n = 0;
#pragma unroll
  for (int i = 0; i < K; ++i)
    n += (block == (uint32_t)dollar[2 * K + i] && c == (uint32_t)dollar[K + i] &&
          v > (uint32_t)dollar[i]) ? 1u : 0u;
  return n;
}

// The LF rounds of the ends v0 (block b0, in-block offset s0) and v1 (b1,
// s1) under code c, both counted forward on the staged row s whose counter
// for c is cnt, each end's '$' levels taken at its own block (K8's split
// entry, K1's paired entry).
template <int K, int NB>
__device__ __forceinline__ void lf_finish(const uint32_t* s, int nb, uint32_t cnt, uint32_t c, uint32_t b0,
                                          uint32_t v0, int s0, uint32_t b1, uint32_t v1, int s1,
                                          const long long* __restrict__ dollar, uint32_t& o0, uint32_t& o1) {
  uint32_t n0, n1;
  row_counts<K, NB>(s, nb, c, s0, s1, false, n0, n1);
  o0 = cnt + n0 - dollar_hits<K>(b0, c, v0, dollar);
  o1 = cnt + n1 - dollar_hits<K>(b1, c, v1, dollar);
}

// A read's ends (lo, hi: int64 iv [n, 2]) and code (int64 [n]) at read j,
// evict-first: iv as one 16-byte pair where `pairs` (iv and out 16-byte
// aligned), else as words. 0 where not `active`.
__device__ __forceinline__ void load_read(const long long* __restrict__ iv, const long long* __restrict__ code,
                                          long long j, bool active, bool pairs, uint32_t& lo, uint32_t& hi,
                                          uint32_t& c) {
  lo = hi = c = 0u;
  if (!active) return;
  if (pairs) {
    const longlong2 e = __ldcs(reinterpret_cast<const longlong2*>(iv) + j);
    lo = (uint32_t)e.x;
    hi = (uint32_t)e.y;
  } else {
    lo = (uint32_t)__ldcs(iv + 2 * j);
    hi = (uint32_t)__ldcs(iv + 2 * j + 1);
  }
  c = (uint32_t)__ldcs(code + j);
}

// Stores read j's new ends into out (int64 [n, 2]), evict-first, as
// load_read loads them.
__device__ __forceinline__ void store_read(long long* __restrict__ out, long long j, bool pairs, uint32_t o_lo,
                                           uint32_t o_hi) {
  if (pairs) {
    __stcs(reinterpret_cast<longlong2*>(out) + j, make_longlong2((long long)o_lo, (long long)o_hi));
  } else {
    __stcs(out + 2 * j, (long long)o_lo);
    __stcs(out + 2 * j + 1, (long long)o_hi);
  }
}

// LF rounds of the ends lo and hi under code c, each on the row of its
// block, row_of(block) (for one end per lane, lo == hi). Warp-collective:
// every lane of the warp calls it, and the lanes that are `active` get
// o_lo, o_hi. The warp stages the rows of the lo blocks; where a lane's hi
// lies in another block (rare after the prefix-LUT start), the warp stages
// those rows in a second round. `stage` is the warp's shared memory,
// 32 * stage_stride(2K*nb) words.
template <int K, int V, class Ld, class RowOf>
__device__ __forceinline__ void lf_rounds(uint32_t* stage, RowOf row_of, int nb, uint32_t lo,
                                          uint32_t hi, uint32_t c, bool active,
                                          const long long* __restrict__ dollar, uint32_t& o_lo,
                                          uint32_t& o_hi) {
  const uint32_t d = 32u * (uint32_t)nb;
  const int words = 2 * K * nb, stride = stage_stride(words);
  const uint32_t* s = stage + (threadIdx.x & 31) * stride;
  const uint32_t cmask = (1u << (2 * K)) - 1u;
  const uint32_t b_lo = lo / d, b_hi = hi / d;
  const bool split = b_lo != b_hi;
  const uint32_t* r = row_of(b_lo);
  const uint32_t cnt = active ? Ld::ld(r + words + (c & cmask)) : 0u;
  stage_rows<V, Ld>(stage, stride, r, active, words);
  uint32_t n_lo, n_hi;
  lf_counts<K>(s, nb, c, (int)(lo - b_lo * d), split ? 0 : (int)(hi - b_lo * d), n_lo, n_hi);
  o_lo = cnt + n_lo - dollar_hits<K>(b_lo, c, lo, dollar);
  o_hi = cnt + n_hi - dollar_hits<K>(b_lo, c, hi, dollar);
  if (__any_sync(kFullWarp, active && split)) {
    __syncwarp();  // every lane is done with the first rows
    const uint32_t* r2 = row_of(b_hi);
    const uint32_t cnt2 = active && split ? Ld::ld(r2 + words + (c & cmask)) : 0u;
    stage_rows<V, Ld>(stage, stride, r2, active && split, words);
    if (active && split) {
      lf_counts<K>(s, nb, c, (int)(hi - b_hi * d), 0, n_hi, n_lo);
      o_hi = cnt2 + n_hi - dollar_hits<K>(b_hi, c, hi, dollar);
    }
  }
}

// Threads per block (a multiple of 32, at most 256) whose staged rows of
// `stride` words fit in 48 KB of shared memory, at least one warp; *smem is
// set to the block's bytes. A caller whose one warp needs more than 48 KB
// raises the kernel's dynamic shared memory limit first.
inline int stage_block(int stride, size_t* smem) {
  const size_t per_warp = 32u * 4u * (size_t)stride;
  size_t warps = (48u * 1024u) / per_warp;
  warps = warps < 1 ? 1 : (warps > 8 ? 8 : warps);
  *smem = warps * per_warp;
  return 32 * (int)warps;
}

// The warp's slot of the block's dynamic shared memory for its staged rows
// of 2K*nb words each (K1's kernels; K8 and K9 take async_stage.cuh's
// WarpStage: row slots and a copy list).
template <int K>
__device__ __forceinline__ uint32_t* warp_stage(int nb) {
  extern __shared__ uint4 staged[];
  return reinterpret_cast<uint32_t*>(staged) + (threadIdx.x & ~31) * stage_stride(2 * K * nb);
}

// f(NB) as an integral constant: 6 (d = 192, the recommended width) where
// a row of K <= 3 fits registers (row_counts' vector reads), else 0 (nb at
// run time).
template <int K, class F>
int dispatch_nb(int nb, F f) {
  if constexpr (K <= 3) {
    if (nb == 6) return f(std::integral_constant<int, 6>{});
  }
  return f(std::integral_constant<int, 0>{});
}

// f(K, V) as integral constants, for k in [1, 8] and v in {1, 4}.
template <int K, class F>
int dispatch_v(int v, F& f) {
  if (v == 4) return f(std::integral_constant<int, K>{}, std::integral_constant<int, 4>{});
  return f(std::integral_constant<int, K>{}, std::integral_constant<int, 1>{});
}

template <class F>
int dispatch_kv(int k, int v, F f) {
  switch (k) {
    case 1: return dispatch_v<1>(v, f);
    case 2: return dispatch_v<2>(v, f);
    case 3: return dispatch_v<3>(v, f);
    case 4: return dispatch_v<4>(v, f);
    case 5: return dispatch_v<5>(v, f);
    case 6: return dispatch_v<6>(v, f);
    case 7: return dispatch_v<7>(v, f);
    default: return dispatch_v<8>(v, f);
  }
}

// Launches `kernel` over n items (ends or reads) with the block size and
// shared memory its staged rows need (2k*nb words a lane); returns
// cudaGetLastError() as an int.
template <class Kernel, class... Args>
int launch_staged(Kernel kernel, int k, int nb, long long n, cudaStream_t stream, Args... args) {
  size_t smem = 0;
  const int threads = stage_block(stage_stride(2 * k * nb), &smem);
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (smem > 48u * 1024u) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace tpufm
