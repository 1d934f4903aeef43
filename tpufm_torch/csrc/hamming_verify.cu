// K5: the seed-and-extend Hamming verify, for Hopper (sm_90a).
//
// A new kernel with no Pallas counterpart: the JAX package verifies with
// plain jnp (hamming_to_text, tpufm/engine/seed.py:94, called by
// make_seed_extend_fn :269-300), and this kernel computes what it computes
// for one candidate lane of the [B, C] grid (read b = lane / C):
//
//   invalid lane: dist = L + 1
//   else: wi = pos / 16, sh = 2 * (pos % 16); the W + 1 packed text words
//         text[min(wi + i, nw - 1)] (clamped as a JAX gather clamps),
//         aligned to the window start (no shift when sh == 0), XOR the
//         read's W words, each base's two bits folded into its low bit
//         ((x | x >> 1) & 0x55555555), the last word masked to the top
//         2 * (L % 16) bits when L % 16 != 0; dist = the popcount.
//
// Words are MSB-first, 16 bases a word (pack_text_words, seed.py:54); the
// packed text arrives as int32 holding the uint32 bits, the read words and
// positions as int64 holding uint32 values.
//
// Bound. HBM-bound as reckoned: per valid lane W + 1 text words, the read's
// W words and pos; the valid mask and out over every lane (the function
// writes every lane). The grid is mostly padding (after the dedup one lane
// of a read's 96 is valid at a seed wave), so the mask and out, 5 bytes a
// lane, are nearly all of the bytes: the kernel is a stream over the grid
// with a few scattered reads beside it.
// The design:
//   * Tiles of valid lanes (valid_tiles.cuh): a block of 128 threads owns
//     2048 lanes in 4 rounds of 512, reads their mask with 4-byte loads (a
//     warp's 128 bytes a request), writes the invalid lanes' L + 1 with
//     16-byte stores (a warp's 512 bytes, whole lines), and lists its valid
//     lanes (about 21 at a seed wave) in shared memory; its threads take
//     them one a thread. With 16 lanes a thread, a warp's stores 64 bytes
//     apart (the first version of these tiles), the stream was slower than
//     with one thread a lane in a design experiment on the card.
//   * A valid lane issues all its loads at once: a kernel per W = ceil(L /
//     16) up to 10 (reads up to 160 bp) holds the W + 1 text words and the
//     read's W words in registers, so the lane waits for pos and then for
//     one round of loads from L2 (the 2.5 MB packed 10 Mbase text stays
//     there), not for W + 1 loads in a chain; longer reads take a loop.
//     The window is aligned with a funnel shift.
// A grid with most lanes valid runs slower than with one thread a lane (a
// tile's lanes queue on its 128 threads); no path makes such grids.
// Measured (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py phase 14, the first
// seed wave: 6.3M lanes, 65,536 valid, L = 120; device time of back-to-back
// launches): 0.0192 ms, against 0.042 ms with one thread a lane; 60% of the
// 11.5 us bytes bound. The stream alone (no lane valid) takes about half of
// that; the valid lanes' two rounds of dependent loads hold their blocks
// for the rest.

#include <cstdint>
#include <cuda_runtime.h>

#include "valid_tiles.cuh"

namespace {

using namespace tpufm;

constexpr int kThreads = 128, kRounds = 4;
using Tiles = tiles::Shape<kThreads, kRounds>;  // 2048 lanes a block

struct Args {
  const uint32_t* text;
  long long nw;
  const long long* pos;
  const long long* qwords;
  const uint8_t* valid;
  int* out;
  long long n, C;
  int W, L;
};

// The Hamming distance of lane's window to its read: WC words unrolled, or
// (WC == 0) a loop over a.W words.
template <int WC>
__device__ __forceinline__ int distance(const Args& a, long long lane) {
  const uint32_t p = (uint32_t)a.pos[lane];
  const long long wi = p >> 4;
  const uint32_t sh = 2u * (p & 15u);
  const int W = WC ? WC : a.W;
  const long long* q = a.qwords + (lane / a.C) * W;
  const uint32_t last = (a.L & 15) ? 0xFFFFFFFFu << (32 - 2 * (a.L & 15)) : 0xFFFFFFFFu;
  int dist = 0;
  if constexpr (WC > 0) {
    uint32_t t[WC + 1], r[WC];
#pragma unroll
    for (int i = 0; i <= WC; ++i) t[i] = __ldg(a.text + min(wi + i, a.nw - 1));
#pragma unroll
    for (int w = 0; w < WC; ++w) r[w] = (uint32_t)__ldg(q + w);
#pragma unroll
    for (int w = 0; w < WC; ++w) {
      const uint32_t x = __funnelshift_l(t[w + 1], t[w], sh) ^ r[w];
      uint32_t mism = (x | (x >> 1)) & 0x55555555u;
      if (w == WC - 1) mism &= last;
      dist += __popc(mism);
    }
  } else {
    uint32_t cur = __ldg(a.text + min(wi, a.nw - 1));
    for (int w = 0; w < W; ++w) {
      const uint32_t nxt = __ldg(a.text + min(wi + w + 1, a.nw - 1));
      const uint32_t x = __funnelshift_l(nxt, cur, sh) ^ (uint32_t)__ldg(q + w);
      uint32_t mism = (x | (x >> 1)) & 0x55555555u;
      if (w == W - 1) mism &= last;
      dist += __popc(mism);
      cur = nxt;
    }
  }
  return dist;
}

template <int WC>
__global__ void __launch_bounds__(kThreads) hamming_verify_kernel(Args a) {
  const int miss = a.L + 1;
  const auto fill = [&](long long lane, uint32_t bits, bool whole) {
    if (whole && bits == 0) {
      *reinterpret_cast<int4*>(a.out + lane) = make_int4(miss, miss, miss, miss);
      return;
    }
    for (int i = 0; i < 4; ++i)
      if (lane + i < a.n && !((bits >> i) & 1u)) a.out[lane + i] = miss;
  };
  const tiles::Tile tile = tiles::pack<kThreads, kRounds>(a.valid, a.n, fill);
  for (int i = threadIdx.x; i < tile.count; i += kThreads) {
    const long long lane = tile.first + tile.list[i];
    a.out[lane] = distance<WC>(a, lane);
  }
}

template <int WC>
int launch(const Args& a, cudaStream_t stream) {
  hamming_verify_kernel<WC><<<(unsigned)Tiles::blocks(a.n), kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches K5 on `stream` and returns cudaGetLastError() (0 on success).
// text: uint32 [nw] packed text; pos: int64 [n]; qwords: int64 [n / C, W];
// valid: bool [n]; out: int32 [n] on a 16-byte boundary; C lanes a read,
// W = ceil(L / 16). Does not synchronise.
extern "C" int tpufm_hamming_verify(const void* text, long long nw, const void* pos, const void* qwords,
                                    const void* valid, void* out, long long n, long long C, int W, int L,
                                    void* stream) {
  if (n <= 0) return 0;
  if (nw <= 0 || C <= 0 || n % C || L <= 0 || W != (L + 15) / 16 || reinterpret_cast<uintptr_t>(out) & 15)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const uint32_t*>(text), nw, static_cast<const long long*>(pos),
               static_cast<const long long*>(qwords), static_cast<const uint8_t*>(valid), static_cast<int*>(out),
               n, C, W, L};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {  // up to 160 bp a kernel per W, whose words a lane loads at once
    case 1: return launch<1>(a, s);
    case 2: return launch<2>(a, s);
    case 3: return launch<3>(a, s);
    case 4: return launch<4>(a, s);
    case 5: return launch<5>(a, s);
    case 6: return launch<6>(a, s);
    case 7: return launch<7>(a, s);
    case 8: return launch<8>(a, s);
    case 9: return launch<9>(a, s);
    case 10: return launch<10>(a, s);
    default: return launch<0>(a, s);
  }
}

extern "C" const char* tpufm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
