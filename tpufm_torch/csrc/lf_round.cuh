// The LF round of one interval end: the round body shared by K1
// (lf_round.cu, both entries) and K4's LF(1) hop (locate_walk.cu), so that
// one copy of the LF math serves every kernel.
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
// It reads only the plane words of windows the prefix mask covers, and ONE
// counter by index: the TPU's binary-tree counter pick was a lane-select
// workaround and is not ported. block = v / d comes from the interval itself,
// never from which row r is: the '$' correction compares it with
// dollar_block exactly as _lf_round_kernel does (pallas_kernel.py:56,
// :92-97). dollar: int64 [3, K], rows pos, base, block.

#pragma once

#include <cstdint>

namespace tpufm {

template <int K>
__device__ __forceinline__ uint32_t lf_round_end(const uint32_t* __restrict__ r,
                                                 int nb, uint32_t v, uint32_t c,
                                                 uint32_t block, uint32_t d,
                                                 const long long* __restrict__ dollar) {
  const int shift = (int)(v - block * d);  // v % d, in [0, d)
  uint32_t count = 0;
  for (int w = 0; w < nb; ++w) {
    // cov = clip(shift - 32w, 0, 32) bases of window w lie before iv.
    const int cov = min(shift - 32 * w, 32);
    if (cov <= 0) break;  // this window and every later one mask to 0
    // cov in [1, 32]: the shift is in [0, 31], never the undefined 32.
    uint32_t m = 0xFFFFFFFFu << (32 - cov);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const uint32_t p0 = __ldg(r + (2 * i) * nb + w);
      const uint32_t p1 = __ldg(r + (2 * i + 1) * nb + w);
      m &= ((c >> (2 * i)) & 1u) ? p0 : ~p0;
      m &= ((c >> (2 * i + 1)) & 1u) ? p1 : ~p1;
    }
    count += __popc(m);
  }

  const uint32_t cnt = __ldg(r + 2 * K * nb + (c & ((1u << (2 * K)) - 1u)));
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const bool hit = block == (uint32_t)dollar[2 * K + i] &&
                     c == (uint32_t)dollar[K + i] && v > (uint32_t)dollar[i];
    count -= hit ? 1u : 0u;
  }
  return cnt + count;
}

}  // namespace tpufm
