// K6: the batched multi-word Myers edit-distance verifier, for Hopper (sm_90a).
//
// A new kernel with no Pallas counterpart: the JAX package runs the scan as
// a jnp lax.scan (make_myers_verify_fn, tpufm/engine/edit.py:105, step
// :178-220), and this kernel computes what that scan computes for one
// candidate lane of the [B, C] grid (read b = lane / C):
//
//   invalid lane: (dist, start) = (L + 1, 0xFFFFFFFF)
//   else, with ws = lo, TL = L + 3E, W = ceil(L / 32), peq = read b's match
//   masks (4 planes of W words, built from the REVERSED read; pad bits past
//   L are 0), vp = the low L bits set, vn = 0, score = L, best = L + 1:
//   for t = 0 .. TL - 1, j = TL - 1 - t (the window back to front):
//     c = the 2-bit text character at ws + j (the packed word
//         min(ws / 16 + (ws % 16 + j) / 16, nw - 1)), none (matches no
//         plane) where ws + j >= n_text
//     eq = peq[c]; x = eq | vn; d0 = ((vp + (x & vp)) ^ vp) | x   (multi-
//     word add, ripple carry); hn = vp & d0; hp = vn | ~(vp | d0);
//     score += bit (L-1) % 32 of word (L-1) / 32 of hp, minus that of hn;
//     xs = hp << 1, vn = xs & d0, vp = (hn << 1) | ~(xs | d0)  (multi-word
//     shifts, 0 in); s = ws + j: if s <= hi and score <= best, best = score
//     and start = s (<=: the leftmost start at the least distance wins)
//   (dist, start) = (best, its start)
//
// Words are uint32 here; peq arrives as int64 holding uint32 values, lo and
// hi as int64, the packed text as int32 holding the uint32 bits.
//
// Bound. Per valid lane the scan does TL steps of 30 W + 18 integer
// operations (counted from the source below: 30 a word in step() for the
// character's mask, the add with its carry, the two shifts and the updates;
// 18 a step in scan() for the character, the score and the best), against
// a few hundred bytes read (TL / 16 + 2 text words, its peq row, lo, hi):
// operation-bound at the INT32 issue rate.
// The design:
//   * One thread a lane, its state (vp, vn, score, best, start) and its
//     read's 4W peq words in registers for W <= 8 (reads up to 256 bp), a
//     kernel per W so that every word index is a constant; past W = 8 the
//     same step reads its state from a scratch buffer the wrapper passes
//     ([2, W, n] words, one lane's words n apart so that a warp's accesses
//     coalesce) and its peq row from device memory.
//   * The window characters come from the packed text one word at a time:
//     the scan walks the window back to front, so it loads a word when the
//     character index crosses into the next word (TL / 16 + 1 or 2 loads),
//     no array of words.
//   * The grid is mostly padding (a unique seed gives one valid lane of
//     seed_hits); an invalid lane writes its result and exits, so the
//     kernel is its own compaction. A warp holding one valid lane still
//     takes the whole scan: lanes are not packed (later work).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRegWords = 8;  // the widest read held in registers: 256 bp

struct Args {
  const uint32_t* text;
  long long nw;
  long long n_text;
  const long long* peq;
  const long long* lo;
  const long long* hi;
  const uint8_t* valid;
  int* dist;
  long long* start;
  long long n, C;
  int W, L, E;
  uint32_t* scratch;  // [2, W, n] for W > kMaxRegWords, else null
};

// A lane's bit vectors and its read's match masks in registers.
template <int WC>
struct RegState {
  static constexpr int kWords = WC;
  uint32_t vp_[WC], vn_[WC], pq[4][WC];
  __device__ __forceinline__ RegState(const Args&, long long, const long long* peq) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int w = 0; w < WC; ++w) pq[c][w] = (uint32_t)peq[c * WC + w];
  }
  __device__ __forceinline__ uint32_t& vp(int w) { return vp_[w]; }
  __device__ __forceinline__ uint32_t& vn(int w) { return vn_[w]; }
  __device__ __forceinline__ uint32_t eq(uint32_t c, int w) const {
    return c == 0 ? pq[0][w] : c == 1 ? pq[1][w] : c == 2 ? pq[2][w] : c == 3 ? pq[3][w] : 0u;
  }
};

// The same for any W: bit vectors in the scratch buffer, masks read from
// device memory at every step.
struct SpillState {
  static constexpr int kWords = 0;  // W from the arguments
  uint32_t *vp_, *vn_;
  long long stride;
  const long long* pq;
  int W;
  __device__ __forceinline__ SpillState(const Args& a, long long lane, const long long* peq)
      : vp_(a.scratch + lane), vn_(a.scratch + (long long)a.W * a.n + lane), stride(a.n), pq(peq), W(a.W) {}
  __device__ __forceinline__ uint32_t& vp(int w) { return vp_[w * stride]; }
  __device__ __forceinline__ uint32_t& vn(int w) { return vn_[w * stride]; }
  __device__ __forceinline__ uint32_t eq(uint32_t c, int w) const { return c < 4 ? (uint32_t)pq[c * W + w] : 0u; }
};

// One step of the scan on character c (4: none): updates the bit vectors
// and returns the score's change.
template <class State>
__device__ __forceinline__ int step(State& st, int W, uint32_t c, int msw, int msb) {
  uint32_t carry = 0, hp_in = 0, hn_in = 0;
  int delta = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint32_t vp = st.vp(w), vn = st.vn(w);
    const uint32_t x = st.eq(c, w) | vn;
    const uint32_t s = vp + (x & vp);
    uint32_t c1 = s < vp;  // the carry out, tested on 32-bit words
    const uint32_t s2 = s + carry;
    c1 |= s2 < s;
    carry = c1;
    const uint32_t d0 = (s2 ^ vp) | x;
    const uint32_t hn = vp & d0;
    const uint32_t hp = vn | ~(vp | d0);
    if (w == msw) delta = (int)((hp >> msb) & 1u) - (int)((hn >> msb) & 1u);
    const uint32_t xs = (hp << 1) | hp_in;
    const uint32_t hns = (hn << 1) | hn_in;
    hp_in = hp >> 31;
    hn_in = hn >> 31;
    st.vn(w) = xs & d0;
    st.vp(w) = hns | ~(xs | d0);
  }
  return delta;
}

template <class State>
__device__ __forceinline__ void scan(const Args& a, long long lane) {
  const int L = a.L, TL = L + 3 * a.E;
  const uint32_t ws = (uint32_t)a.lo[lane], hi = (uint32_t)a.hi[lane];
  const int W = State::kWords ? State::kWords : a.W;  // a constant in registers
  State st(a, lane, a.peq + (lane / a.C) * 4 * W);
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int bits = min(32, L - 32 * w);
    st.vp(w) = bits < 32 ? (1u << bits) - 1u : 0xFFFFFFFFu;
    st.vn(w) = 0u;
  }
  const int msw = (L - 1) >> 5, msb = (L - 1) & 31;
  const uint32_t woff = ws & 15u;
  const long long base = ws >> 4;
  int score = L, best = L + 1;
  uint32_t bstart = 0xFFFFFFFFu, word = 0u;
  int loaded = -1;  // the index of `word` within the window's words
  for (int t = 0; t < TL; ++t) {
    const uint32_t j = (uint32_t)(TL - 1 - t);
    const uint32_t rel = woff + j;
    const int sel = (int)(rel >> 4);
    if (sel != loaded) {
      word = __ldg(a.text + min(base + sel, a.nw - 1));
      loaded = sel;
    }
    const uint32_t c = (long long)ws + j < a.n_text ? (word >> (2u * (15u - (rel & 15u)))) & 3u : 4u;
    score += step(st, W, c, msw, msb);
    const uint32_t s = ws + j;
    if (s <= hi && score <= best) {
      best = score;
      bstart = s;
    }
  }
  a.dist[lane] = best;
  a.start[lane] = (long long)bstart;
}

template <int WC>
__global__ void __launch_bounds__(kThreads) myers_verify_kernel(Args a) {
  const long long lane = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= a.n) return;
  if (!a.valid[lane]) {
    a.dist[lane] = a.L + 1;
    a.start[lane] = 0xFFFFFFFFLL;
    return;
  }
  if constexpr (WC > 0)
    scan<RegState<WC>>(a, lane);
  else
    scan<SpillState>(a, lane);
}

template <int WC>
int launch(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.n + kThreads - 1) / kThreads;
  myers_verify_kernel<WC><<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches K6 on `stream` and returns cudaGetLastError() (0 on success).
// text: uint32 [nw] packed text of n_text bases; peq: int64 [n / C, 4, W];
// lo, hi: int64 [n]; valid: bool [n]; dist: int32 [n]; start: int64 [n];
// scratch: uint32 [2, W, n] when W > 8, else unused. Does not synchronise.
extern "C" int tpufm_myers_verify(const void* text, long long nw, long long n_text, const void* peq,
                                  const void* lo, const void* hi, const void* valid, void* dist, void* start,
                                  long long n, long long C, int W, int L, int E, void* scratch, void* stream) {
  if (n <= 0) return 0;
  if (nw <= 0 || C <= 0 || n % C || L <= 0 || E < 0 || W != (L + 31) / 32 ||
      (W > kMaxRegWords && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const uint32_t*>(text), nw, n_text, static_cast<const long long*>(peq),
               static_cast<const long long*>(lo), static_cast<const long long*>(hi),
               static_cast<const uint8_t*>(valid), static_cast<int*>(dist), static_cast<long long*>(start),
               n, C, W, L, E, static_cast<uint32_t*>(scratch)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: return launch<1>(a, s);
    case 2: return launch<2>(a, s);
    case 3: return launch<3>(a, s);
    case 4: return launch<4>(a, s);
    case 5: return launch<5>(a, s);
    case 6: return launch<6>(a, s);
    case 7: return launch<7>(a, s);
    case 8: return launch<8>(a, s);
    default: return launch<0>(a, s);
  }
}

extern "C" const char* tpufm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
