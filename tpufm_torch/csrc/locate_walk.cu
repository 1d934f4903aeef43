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
//       (K1's round math, lf_round.cuh, '$' correction included), hops += 1
//   a lane never marked within sample_rate iterations gives 0xFFFFFFFF.
//
// A fused locate row (build_locate_tables, xla.py:1352) is uint32
// [2*nb LF(1) plane words | 4 LF(1) counters | nb mark words | mark rank],
// which the engine pads on the device to a multiple of 4 words (24 at
// d=192: 96 B, three sectors).
//
// Bound. HBM-bound as reckoned: p and out (16 B a lane), the locate rows and
// the samples once; 1M lanes at 10 Mbase s=32 d=192 move 22.8 MB, 6.8 us at
// 3.35 TB/s. A dependent walk cannot come near that: each hop needs the row
// the hop before computed, so one floor is the longest trip (up to
// sample_rate - 1 hops and the sample) times one dependent hop. At 1M lanes
// it stays far above both: ~16M hops each read a 96-byte row (three sectors)
// from L2, and the rate at which L2 serves such scattered rows is the
// likely limit (not measured: no L2 counters were read; shared-memory bank
// conflicts were ruled out, lf_round.cuh).
// The design works on requests and idle lanes:
//   * One memory round trip a hop, a row's sectors each requested once. At
//     each step the warp stages the rows of its 32 lanes' hops in shared
//     memory with coalesced 16-byte loads (stage_rows, lf_round.cuh: the
//     whole row, 24 padded words at d=192), then every lane takes its hop
//     from there: the character, the mark test, the mark prefix, and the LF
//     count by K1's round math (lf_counts). Loaded word by word, a hop
//     would take 2-3 dependent trips (mark word, then the character's
//     plane words, then the LF round's words), one request per word.
//   * Lane refill. A persistent grid of a few blocks per SM; each warp
//     claims kChunk lanes with one atomicAdd by its first thread, and a
//     thread whose walk ends takes the next lane of its warp's chunk (or of
//     a new chunk), so the warp stages 32 rows a step until the queue
//     drains. With one lane a thread, a warp would be held to its slowest
//     lane (mean trip ~15.5 hops, up to 31 at s=32), about half of its
//     lane-slots idle. On the H100 the same walk without refill was as
//     fast at 262,144 lanes, a fused-locate wave (0.1965-0.1975 ms against
//     0.1876-0.2077), and slower at 1M lanes (0.6711-0.6736 against
//     0.5167-0.5178) and over all 10M rows (5.92-5.94 against 3.75), the
//     two-pass locate's walks.
//   * The last iteration's hop is skipped: its row would never be tested.
// In design experiments on the H100, one lane loading its own whole row as
// 16-byte vectors (a row width fixed at compile time) walked faster than
// this staged design; that is the next design to measure.
// Results are written by lane index, so the order lanes finish in is
// irrelevant. Words are indexed directly: the one-hot picks of
// xla.py:982-992 were a TPU lane-select workaround.
//
// Types. Rows and SA values reach 2^32 - 1: uint32_t here, int64 holding
// the uint32 bits on the torch side. Table words and samples arrive as
// int32 tensors holding the uint32 bits.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "lf_round.cuh"

namespace {

using namespace tpufm;

constexpr int kThreads = 256;
constexpr int kChunk = 64;  // lanes a warp claims with one atomic

struct Walk {
  const uint32_t* rows;
  long long nrows;
  int row_words, nb;
  const uint32_t* samples;
  uint32_t last;  // n_samples - 1
  const long long* dollar;
  int sample_rate;
};

// One iteration of the walk of a lane at row p after `hops` hops, on its
// staged row s: true when the lane is finished, its SA value in `result`;
// else p has taken its hop.
__device__ __forceinline__ bool walk_step(const Walk& W, const uint32_t* s, uint32_t& p, int hops,
                                          uint32_t& result) {
  const int nb = W.nb;
  const uint32_t d = 32u * (uint32_t)nb;
  const uint32_t block = p / d;
  const int off = (int)(p - block * d), w = off >> 5, bit = 31 - (off & 31);
  const uint32_t* marks = s + 2 * nb + 4;
  if ((marks[w] >> bit) & 1u) {
    uint32_t pre = __popc(marks[w] & prefix_mask(off, w));
    for (int i = 0; i < w; ++i) pre += __popc(marks[i]);
    result = __ldg(W.samples + min(marks[nb] + pre, W.last)) + (uint32_t)hops;
    return true;
  }
  if (hops + 1 == W.sample_rate) {  // never marked: the last hop is never tested
    result = 0xFFFFFFFFu;
    return true;
  }
  const uint32_t c = ((s[w] >> bit) & 1u) | (((s[nb + w] >> bit) & 1u) << 1);
  uint32_t count, unused;
  lf_counts<1>(s, nb, c, off, 0, count, unused);
  p = s[2 * nb + c] + count - dollar_hits<1>(block, c, p, W.dollar);
  return false;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
locate_walk_kernel(Walk W, const long long* __restrict__ p_in, long long* __restrict__ out,
                   long long n, unsigned long long* __restrict__ next_lane) {
  extern __shared__ uint4 staged[];
  const int stride = stage_stride(W.row_words);
  uint32_t* stage = reinterpret_cast<uint32_t*>(staged) + (threadIdx.x & ~31) * stride;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const uint32_t d = 32u * (uint32_t)W.nb;
  long long base = 0, end = 0;  // the warp's unclaimed lanes [base, end), warp-uniform
  bool drained = false;         // warp-uniform
  long long j = -1;             // this thread's lane, -1 when idle
  uint32_t p = 0, result = 0;
  int hops = 0;
  for (;;) {
    unsigned idle = __ballot_sync(kFullWarp, j < 0);
    while (idle && !drained) {
      if (base == end) {
        unsigned long long b = 0;
        if (lane == 0) b = atomicAdd(next_lane, (unsigned long long)kChunk);
        b = __shfl_sync(kFullWarp, b, 0);
        if (b >= (unsigned long long)n) {
          drained = true;
          break;
        }
        base = (long long)b;
        end = min(base + kChunk, n);
      }
      const int take = (int)min((long long)__popc(idle), end - base);
      if (j < 0 && __popc(idle & below) < take) {
        j = base + __popc(idle & below);
        p = (uint32_t)__ldcs(p_in + j);
        hops = 0;
      }
      base += take;
      idle = __ballot_sync(kFullWarp, j < 0);
    }
    if (idle == kFullWarp) return;  // drained, and every thread idle
    const uint32_t* row =
        W.rows + min((unsigned long long)(p / d), (unsigned long long)(W.nrows - 1)) *
                     (unsigned long long)W.row_words;
    stage_rows<V, LoadCached>(stage, stride, row, j >= 0, W.row_words);
    if (j >= 0) {
      if (walk_step(W, stage + lane * stride, p, hops, result)) {
        __stcs(out + j, (long long)result);
        j = -1;
      } else {
        ++hops;
      }
    }
    __syncwarp();  // every lane is done with the staged rows
  }
}

template <int V>
int launch(const Walk& W, const void* p, void* out, long long n, void* next_lane,
           cudaStream_t stream) {
  const size_t smem = (size_t)kThreads * 4 * stage_stride(W.row_words);
  if (smem > 48u * 1024u) {
    const cudaError_t err = cudaFuncSetAttribute(
        locate_walk_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, locate_walk_kernel<V>, kThreads, smem);
  const long long lanes_per_block = (long long)kChunk * (kThreads / 32);
  const long long blocks =
      std::min((long long)std::max(sms * per_sm, 1), (n + lanes_per_block - 1) / lanes_per_block);
  locate_walk_kernel<V><<<(unsigned)blocks, kThreads, smem, stream>>>(
      W, static_cast<const long long*>(p), static_cast<long long*>(out), n,
      static_cast<unsigned long long*>(next_lane));
  return (int)cudaGetLastError();
}

}  // namespace

// Launches K4 on `stream` and returns cudaGetLastError() (0 on success).
// rows: uint32 [nrows, row_words >= 3*nb + 5] fused locate rows; samples:
// uint32 [n_samples >= 1]; dollar: int64 [3, 1] (pos, base, block of the
// k=1 '$'); p, out: int64 [n] (uint32 values); next_lane: one uint64 set to
// 0, the lane queue's head. Does not synchronise.
extern "C" int tpufm_locate_walk(const void* rows, long long nrows,
                                 int row_words, int nb, const void* samples,
                                 long long n_samples, const void* dollar,
                                 const void* p, void* out, long long n,
                                 int sample_rate, void* next_lane, void* stream) {
  if (n <= 0) return 0;
  if (nrows <= 0 || nb <= 0 || row_words < 3 * nb + 5 || n_samples <= 0 ||
      n_samples > 0x100000000LL || sample_rate < 1)
    return (int)cudaErrorInvalidValue;
  const Walk W{static_cast<const uint32_t*>(rows), nrows, row_words, nb,
               static_cast<const uint32_t*>(samples), (uint32_t)(n_samples - 1),
               static_cast<const long long*>(dollar), sample_rate};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return unit_words(rows, row_words) == 4 ? launch<4>(W, p, out, n, next_lane, s)
                                           : launch<1>(W, p, out, n, next_lane, s);
}

extern "C" const char* tpufm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
