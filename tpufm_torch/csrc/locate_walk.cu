// K4: the sampled-suffix-array walk, BWT row -> SA value, for Hopper (sm_90a).
//
// A new kernel with no Pallas counterpart: the JAX package runs the walk as
// plain jnp inside a fori_loop (make_locate_fn, tpufm/engine/xla.py:970,
// body :994-1061), and this kernel computes exactly what that loop computes
// for one lane p, with exactly sample_rate iterations:
//
//   each iteration, on row = rows[min(p / d, nrows - 1)] (clamped as the JAX
//   gather clamps):
//     test the mark bit of p (check before hop):
//       mark word (p % d) / 32 of the row's mark columns, bit 31 - p % 32;
//       if set: rank = min(mark_rank + marked bits of the row before p % d,
//               n_samples - 1); result = samples[rank] + hops   (mod 2^32);
//               the lane stops
//     else one LF(1) hop: c = the BWT character at p from the row's two
//       bit-planes; p = LF round at k=1 on the row's first 2*nb + 4 words
//       (lf_round_end<1>, lf_round.cuh: K1's round body, '$' correction
//       included), hops += 1
//   a lane never marked within sample_rate iterations gives 0xFFFFFFFF.
//
// A fused locate row (build_locate_tables, xla.py:1352) is uint32
// [2*nb LF(1) plane words | 4 LF(1) counters | nb mark words | mark rank].
//
// Design. One thread per lane with the whole walk in the thread, over a
// 1-D grid with the ragged edge masked. A finished lane exits early: the
// TPU ran every lane for the fixed trip count and masked the finished ones
// (xla.py:1047-1049); nothing forces that here, and the result is the same
// since a marked lane never moves again. Words are indexed directly: the
// one-hot picks of xla.py:982-992 were a TPU lane-select workaround. The
// thread reads only the mark and plane words its prefix mask covers.
//
// Bound. Dependent random row loads: a hop reads at most (2*nb + 2) * 4 B
// of one row (the mark word, the plane words up to p's window, one
// counter), the marked row at most (nb + 1) * 4 B more and one sample:
// about (3*nb + 2) * 4 B, 80 B at d=192. The next hop's row depends on the
// hop before, so a lane is a chain of latencies, and a warp is held to its
// slowest lane (up to sample_rate - 1 hops). At 10 Mbase and d=192 the locate rows (23 words x 52,085 rows =
// 4.8 MB) and the samples (1.25 MB at s=32) sit in the 50 MB L2; at genome
// scale they do not and each hop comes from HBM.
//
// Types. Rows and SA values reach 2^32 - 1: uint32_t here, int64 holding
// the uint32 bits on the torch side. Table words and samples arrive as
// int32 tensors holding the uint32 bits.

#include <cstdint>
#include <cuda_runtime.h>

#include "lf_round.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void locate_walk_kernel(const uint32_t* __restrict__ rows,
                                   long long nrows, int row_words, int nb,
                                   const uint32_t* __restrict__ samples,
                                   long long n_samples,
                                   const long long* __restrict__ dollar,
                                   const long long* __restrict__ p_in,
                                   long long* __restrict__ out, long long n,
                                   int sample_rate) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const uint32_t d = 32u * (uint32_t)nb;
  const int mark0 = 2 * nb + 4;  // first mark word of a row
  const uint32_t last = (uint32_t)(n_samples - 1);
  uint32_t p = (uint32_t)p_in[j];
  uint32_t result = 0xFFFFFFFFu;
  for (int hops = 0; hops < sample_rate; ++hops) {
    const uint32_t block = p / d;
    const uint32_t off = p - block * d;
    const uint32_t* r =
        rows + min((unsigned long long)block, (unsigned long long)(nrows - 1)) *
                   (unsigned long long)row_words;
    const int w = (int)(off >> 5);
    const int bit = 31 - (int)(off & 31u);
    const uint32_t mark = __ldg(r + mark0 + w);
    if ((mark >> bit) & 1u) {
      // marked bits before off: whole words before w, then the top off % 32
      // bits of word w (~(FFFFFFFF >> 0) == 0: no bit at a word's start)
      uint32_t pre = __popc(mark & ~(0xFFFFFFFFu >> (off & 31u)));
      for (int i = 0; i < w; ++i) pre += __popc(__ldg(r + mark0 + i));
      const uint32_t rank = min(__ldg(r + mark0 + nb) + pre, last);
      result = __ldg(samples + rank) + (uint32_t)hops;
      break;
    }
    const uint32_t c = ((__ldg(r + w) >> bit) & 1u) |
                       (((__ldg(r + nb + w) >> bit) & 1u) << 1);
    p = tpufm::lf_round_end<1>(r, nb, p, c, block, d, dollar);
  }
  out[j] = (long long)result;
}

}  // namespace

// Launches K4 on `stream` and returns cudaGetLastError() (0 on success).
// rows: uint32 [nrows, row_words >= 3*nb + 5] fused locate rows; samples:
// uint32 [n_samples >= 1]; dollar: int64 [3, 1] (pos, base, block of the
// k=1 '$'); p, out: int64 [n] (uint32 values). Does not synchronise.
extern "C" int tpufm_locate_walk(const void* rows, long long nrows,
                                 int row_words, int nb, const void* samples,
                                 long long n_samples, const void* dollar,
                                 const void* p, void* out, long long n,
                                 int sample_rate, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (nrows <= 0 || nb <= 0 || row_words < 3 * nb + 5 || n_samples <= 0 ||
      n_samples > 0x100000000LL || sample_rate < 1 || blocks > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  locate_walk_kernel<<<(unsigned)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), nrows, row_words, nb,
      static_cast<const uint32_t*>(samples), n_samples,
      static_cast<const long long*>(dollar), static_cast<const long long*>(p),
      static_cast<long long*>(out), n, sample_rate);
  return (int)cudaGetLastError();
}

extern "C" const char* tpufm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
