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
// writes every lane). The grid is mostly padding (a unique seed gives one
// valid lane of seed_hits), so the kernel is its own compaction: an invalid
// lane writes L + 1 and exits without a load, no host-synchronising
// nonzero. One thread a lane, its words in registers; the text words of
// nearby candidates share sectors only by chance, so each valid lane costs
// a few scattered sector reads from L2 (the 2.5 MB packed 10 Mbase text
// stays there).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
hamming_verify_kernel(const uint32_t* __restrict__ text, long long nw, const long long* __restrict__ pos,
                      const long long* __restrict__ qwords, const uint8_t* __restrict__ valid,
                      int* __restrict__ out, long long n, long long C, int W, int L) {
  const long long lane = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  if (!valid[lane]) {
    out[lane] = L + 1;
    return;
  }
  const uint32_t p = (uint32_t)pos[lane];
  const long long wi = p >> 4;
  const uint32_t sh = 2u * (p & 15u);
  const long long* q = qwords + (lane / C) * W;
  const uint32_t last = (L & 15) ? 0xFFFFFFFFu << (32 - 2 * (L & 15)) : 0xFFFFFFFFu;
  uint32_t lo = __ldg(text + min(wi, nw - 1));
  int dist = 0;
  for (int w = 0; w < W; ++w) {
    const uint32_t hi = __ldg(text + min(wi + w + 1, nw - 1));
    const uint32_t aligned = sh ? (lo << sh) | (hi >> (32u - sh)) : lo;
    const uint32_t x = aligned ^ (uint32_t)q[w];
    uint32_t mism = (x | (x >> 1)) & 0x55555555u;
    if (w == W - 1) mism &= last;
    dist += __popc(mism);
    lo = hi;
  }
  out[lane] = dist;
}

}  // namespace

// Launches K5 on `stream` and returns cudaGetLastError() (0 on success).
// text: uint32 [nw] packed text; pos: int64 [n]; qwords: int64 [n / C, W];
// valid: bool [n]; out: int32 [n]; C lanes a read, W = ceil(L / 16). Does
// not synchronise.
extern "C" int tpufm_hamming_verify(const void* text, long long nw, const void* pos, const void* qwords,
                                    const void* valid, void* out, long long n, long long C, int W, int L,
                                    void* stream) {
  if (n <= 0) return 0;
  if (nw <= 0 || C <= 0 || n % C || L <= 0 || W != (L + 15) / 16) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  hamming_verify_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(text), nw, static_cast<const long long*>(pos),
      static_cast<const long long*>(qwords), static_cast<const uint8_t*>(valid), static_cast<int*>(out), n, C,
      W, L);
  return (int)cudaGetLastError();
}

extern "C" const char* tpufm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
