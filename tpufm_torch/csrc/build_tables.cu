// K7: the k-step index's tables from the text and its suffix array, for
// Hopper (sm_90a).
//
// A new kernel with no Pallas counterpart: tpufm computes this pass as jnp
// (_build_tables, tpufm/index/builder_device.py:35-101), and this kernel
// computes what it computes. With bwtsize big = n + 1, E = ceil(big / d)
// blocks of d = 32 * nb positions, T the text with T[n] = 0 ('$' read as
// 'A'):
//
//   BWT_i[p] = T[(SA[p] - 1 - i) mod big] for p < big, 0 past it (the
//              padding up to E * d), for each level i < k
//   bitmaps[e, i, plane, w]: bit 31 - j set iff bit `plane` of
//              BWT_i[e * d + 32 * w + j] is set (MSB-first); row E is the
//              wrapper's (zero)
//   counts[e, c]: over the nb words of block e, the popcount of the AND over
//              levels of the planes (or their complements) that k-mer c
//              selects; uncorrected, as tpufm's: each '$' is counted as its
//              'A'-read k-mer and the padding as k-mer 0
//   dollar_pos[SA[p]] = p where SA[p] < k
//
// The text arrives as uint8 codes, the suffix array as int32 (values 0..n),
// the planes leave as uint32 words and the counts as int32 (at most d).
//
// Bound. Bytes: the suffix array (4 B a position) and the text read once,
// the planes (k / 4 B a position) and counts (4^k * 4 B a block) written
// once. The text is read at random: a position's k symbols, T[SA[p] - k ..
// SA[p] - 1], lie in one 32-byte sector or straddle two, so the memory
// system carries about 32 B a position for the text where the bound counts
// one (chip_smoke.py prints the sector count). At 10 Mbase the text (10 MB)
// stays in the 50 MB L2; at 250 Mbase it does not.
//
// Design (a simple kernel first): a block of 256 threads owns R = max(1,
// 256 / nb) consecutive FM blocks. A thread packs one 32-position word of
// every level's two planes: it reads its 32 suffix array values (the lines
// of the warp's words once each through L1) and each position's k text
// bytes, writes the 2k words and keeps them in shared memory. Then the
// block's threads take its R * 4^k (block, k-mer) counters, each a
// popcount-match over the block's nb words in shared memory, and write them
// in row order (consecutive threads, consecutive k-mers). The level loops
// are unrolled per k (1-8), so a thread's 2k plane words stay in registers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxShared = 48 * 1024;

struct Args {
  const uint8_t* text;
  long long n;
  const int* sa;
  int nb, rows;
  long long E;
  uint32_t* bitmaps;
  int* counts;
  long long* dollar_pos;
};

template <int K>
__global__ void __launch_bounds__(kThreads) build_tables_kernel(Args a) {
  extern __shared__ uint32_t planes[];  // [rows][K][2][nb]
  const long long big = a.n + 1;
  const int nb = a.nb;
  const long long d = 32LL * nb;
  const long long e0 = (long long)blockIdx.x * a.rows;

  for (int t = threadIdx.x; t < a.rows * nb; t += kThreads) {
    const int r = t / nb, w = t - r * nb;
    const long long e = e0 + r;
    if (e >= a.E) break;
    uint32_t lo[K], hi[K];
#pragma unroll
    for (int i = 0; i < K; ++i) lo[i] = hi[i] = 0u;
    const long long p0 = e * d + 32LL * w;
    for (int j = 0; j < 32; ++j) {
      const long long p = p0 + j;
      if (p >= big) break;  // the padding reads as 'A': no bits
      const long long s = __ldg(a.sa + p);
      if (s < K) a.dollar_pos[s] = p;
      const uint32_t bit = 1u << (31 - j);
#pragma unroll
      for (int i = 0; i < K; ++i) {
        long long q = s - 1 - i;
        while (q < 0) q += big;  // more than once only for a text shorter than k
        const uint32_t c = q < a.n ? (uint32_t)__ldg(a.text + q) : 0u;
        lo[i] |= (c & 1u) ? bit : 0u;
        hi[i] |= (c & 2u) ? bit : 0u;
      }
    }
    uint32_t* out = a.bitmaps + e * 2 * K * nb + w;
    uint32_t* mine = planes + r * 2 * K * nb + w;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      out[(2 * i) * nb] = mine[(2 * i) * nb] = lo[i];
      out[(2 * i + 1) * nb] = mine[(2 * i + 1) * nb] = hi[i];
    }
  }
  __syncthreads();

  constexpr int C = 1 << (2 * K);
  for (int q = threadIdx.x; q < a.rows * C; q += kThreads) {
    const int r = q / C, c = q & (C - 1);
    const long long e = e0 + r;
    if (e >= a.E) break;
    const uint32_t* row = planes + r * 2 * K * nb;
    int count = 0;
    for (int w = 0; w < nb; ++w) {
      uint32_t m = 0xFFFFFFFFu;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const uint32_t p0 = row[(2 * i) * nb + w], p1 = row[(2 * i + 1) * nb + w];
        m &= ((c >> (2 * i)) & 1 ? p0 : ~p0) & ((c >> (2 * i + 1)) & 1 ? p1 : ~p1);
      }
      count += __popc(m);
    }
    a.counts[e * C + c] = count;
  }
}

template <int K>
int launch(const Args& a, cudaStream_t stream) {
  const size_t shared = (size_t)a.rows * 2 * K * a.nb * sizeof(uint32_t);
  if (shared > kMaxShared) return (int)cudaErrorInvalidValue;
  const long long blocks = (a.E + a.rows - 1) / a.rows;
  build_tables_kernel<K><<<(unsigned)blocks, kThreads, shared, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches K7 on `stream` and returns cudaGetLastError() (0 on success).
// text: uint8 [n]; sa: int32 [n + 1]; bitmaps: uint32 [E + 1, k, 2, nb]
// (rows 0..E-1 written); counts: int32 [E, 4^k]; dollar_pos: int64 [k]
// (zeroed by the caller; entry SA[p] set to p where SA[p] < k). Does not
// synchronise.
extern "C" int tpufm_build_tables(const void* text, long long n, const void* sa, int k, int nb,
                                  void* bitmaps, void* counts, void* dollar_pos, void* stream) {
  if (n < 0 || k < 1 || k > 8 || nb < 1) return (int)cudaErrorInvalidValue;
  Args a{static_cast<const uint8_t*>(text), n, static_cast<const int*>(sa), nb,
         nb >= kThreads ? 1 : kThreads / nb, (n + 1 + 32LL * nb - 1) / (32LL * nb),
         static_cast<uint32_t*>(bitmaps), static_cast<int*>(counts), static_cast<long long*>(dollar_pos)};
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
