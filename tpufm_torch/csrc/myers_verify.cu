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
// operations, as counted from the first version of this kernel (one thread
// a lane of the whole grid): 30 a word for the character's mask, the add
// with its carry, the two shifts and the updates; 18 a step for the
// character, the score and the best. The bound keeps that count so that
// versions compare on one yardstick, though this one issues fewer (the
// design below). Per lane a few hundred bytes are read (TL / 16 + 2 text words, its peq row,
// lo, hi): operation-bound at the INT32 rate. The steps of a lane are a
// chain, each needing the bit vectors of the step before, and every
// integer instruction of a warp takes two cycles of its scheduler (16
// INT32 lanes each). With ~1.5% of the lanes valid (11,475 of 786,432 at
// an edit wave, ~360 full warps on the card's 528 schedulers) the time of
// one warp's TL steps is the floor, not the card's issue rate.
// The design:
//   * Tiles of valid lanes (valid_tiles.cuh): a block of 128 threads owns
//     2048 lanes (about 30 valid at an edit wave, one warp's worth), writes
//     the invalid lanes' results with 16-byte stores, lists its valid lanes
//     in shared memory, and its threads take them one a thread. A warp
//     holds 32 valid lanes where one thread a lane held ~0.5, so ~360
//     warps run the scans instead of ~6,100. Blocks of one warp (more
//     blocks an SM) and blocks that rotate which warp works first were no
//     faster in design experiments on the card.
//   * A short step. The mask of the character is picked from the four
//     planes by three 3-input logic operations a word (lop3); the
//     multi-word add carries through a 64-bit sum; a round of the loop
//     takes the rest of a packed text word from a shift register and loads
//     the word before it, 16 steps before it is needed; and only the last
//     hi - lo + 1 steps test the best. Windows past the text end take a
//     kernel instance that tests each character against it.
//   * A lane's state (vp, vn, score, best, start) and its read's 4W peq
//     words in registers for W <= 8 (reads up to 256 bp), a kernel per W so
//     that every word index is a constant; past W = 8 the same step keeps
//     its bit vectors in a scratch buffer the wrapper passes ([2, W,
//     slots] words, one slot a thread of the grid, slots apart, so that a
//     warp's accesses coalesce) and reads its peq row from device memory.
// Measured (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py phase 14, the first
// edit wave: 786,432 lanes, 11,475 valid, L = 120, E = 2; device time of
// back-to-back launches): 0.0278 ms, against 0.38-0.40 ms with one thread
// a lane; 43% of the 11.9 us operations bound. With one valid lane left the
// same grid takes 0.0174 ms: one warp's 126 steps beside the grid's mask
// and outputs, the floor of this design; for the rest, about three working
// warps an SM share its four schedulers.

#include <cstdint>
#include <cuda_runtime.h>

#include "valid_tiles.cuh"

namespace {

using namespace tpufm;

constexpr int kMaxRegWords = 8;  // the widest read held in registers: 256 bp
constexpr int kThreads = 128, kRounds = 4;
using Tiles = tiles::Shape<kThreads, kRounds>;  // 2048 lanes a block

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
  uint32_t* scratch;  // [2, W, slots] for W > kMaxRegWords, else null
  long long slots;
};

// A window character: its code c (4: past the text end), and for the
// register state the masks m0 = -(c & 1), m1 = -(c >> 1) and live = -(c < 4).
struct Char {
  uint32_t c, m0, m1, live;
};

// The character in cur's low 2 bits (past the text end where `gone`); cur
// moves on to the next.
__device__ __forceinline__ Char take(uint32_t& cur, bool gone) {
  const uint32_t c = cur & 3u;
  const Char ch{gone ? 4u : c, (uint32_t)((int)(cur << 31) >> 31), (uint32_t)((int)(cur << 30) >> 31),
                gone ? 0u : 0xFFFFFFFFu};
  cur >>= 2;
  return ch;
}

// The bits of b where m is set and of a elsewhere, in one 3-input logic
// operation (the compiler, given ~m as a value of its own, takes two).
__device__ __forceinline__ uint32_t pick(uint32_t a, uint32_t b, uint32_t m) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xD8;" : "=r"(r) : "r"(a), "r"(b), "r"(m));
  return r;
}

// A lane's bit vectors and its read's match masks in registers. The mask of
// character c is picked by bitwise selects on the bits of c: three logic
// operations a word where c == 0 ? .. : c == 1 ? .. would take a compare
// and a select for each plane.
template <int WC>
struct RegState {
  static constexpr int kWords = WC;
  uint32_t vp_[WC], vn_[WC], pq[4][WC];
  __device__ __forceinline__ RegState(const Args&, long long, const long long* peq) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int w = 0; w < WC; ++w) pq[c][w] = (uint32_t)__ldg(peq + c * WC + w);
  }
  __device__ __forceinline__ uint32_t& vp(int w) { return vp_[w]; }
  __device__ __forceinline__ uint32_t& vn(int w) { return vn_[w]; }
  __device__ __forceinline__ uint32_t eq(const Char& ch, int w) const {
    return pick(pick(pq[0][w], pq[1][w], ch.m0), pick(pq[2][w], pq[3][w], ch.m0), ch.m1) & ch.live;
  }
};

// The same for any W: bit vectors in the scratch buffer at the thread's
// slot, masks read from device memory at every step.
struct SpillState {
  static constexpr int kWords = 0;  // W from the arguments
  uint32_t *vp_, *vn_;
  long long stride;
  const long long* pq;
  int W;
  __device__ __forceinline__ SpillState(const Args& a, long long slot, const long long* peq)
      : vp_(a.scratch + slot), vn_(a.scratch + (long long)a.W * a.slots + slot), stride(a.slots), pq(peq),
        W(a.W) {}
  __device__ __forceinline__ uint32_t& vp(int w) { return vp_[w * stride]; }
  __device__ __forceinline__ uint32_t& vn(int w) { return vn_[w * stride]; }
  __device__ __forceinline__ uint32_t eq(const Char& ch, int w) const {
    return ch.c < 4 ? (uint32_t)pq[ch.c * W + w] : 0u;
  }
};

// One step of the scan on character ch: updates the bit vectors and
// returns the score's change (mb: the bit of L - 1 in the last word).
template <class State>
__device__ __forceinline__ int step(State& st, int W, const Char& ch, uint32_t mb) {
  uint32_t carry = 0, hp_prev = 0, hn_prev = 0;
  int delta = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint32_t vp = st.vp(w), vn = st.vn(w);
    const uint32_t x = st.eq(ch, w) | vn;
    const unsigned long long sum = (unsigned long long)vp + (x & vp) + carry;
    carry = (uint32_t)(sum >> 32);
    const uint32_t d0 = ((uint32_t)sum ^ vp) | x;
    const uint32_t hn = vp & d0;
    const uint32_t hp = vn | ~(vp | d0);
    if (w == W - 1) delta = (int)((hp & mb) != 0) - (int)((hn & mb) != 0);
    const uint32_t xs = __funnelshift_l(hp_prev, hp, 1);  // hp << 1, the word below's top bit in
    const uint32_t hns = __funnelshift_l(hn_prev, hn, 1);
    hp_prev = hp;
    hn_prev = hn;
    st.vn(w) = xs & d0;
    st.vp(w) = hns | ~(xs | d0);
  }
  return delta;
}

// The scan of one lane. The window's characters come back to front from
// `cur`, the current packed word shifted so that the next character is in
// its low 2 bits; each round of the outer loop takes the rest of a word,
// and loads the word before it for the next round, 16 steps ahead of its
// use. kEdge: the window reaches past the text end, so each character is
// tested against it. The steps before j = hi - ws cannot set the best;
// only the last (up to 2E + 1) steps test it.
template <class State, bool kEdge>
__device__ __forceinline__ void scan(const Args& a, long long lane, long long slot, long long ws, int TL) {
  const int L = a.L;
  const int W = State::kWords ? State::kWords : a.W;  // a constant in registers
  State st(a, slot, a.peq + (lane / a.C) * 4 * W);
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int bits = min(32, L - 32 * w);
    st.vp(w) = bits < 32 ? (1u << bits) - 1u : 0xFFFFFFFFu;
    st.vn(w) = 0u;
  }
  const uint32_t mb = 1u << ((L - 1) & 31);
  const uint32_t rel = (uint32_t)(ws & 15) + (uint32_t)TL - 1u;  // the first character's offset
  long long wi = (ws >> 4) + (rel >> 4);                         // its word
  uint32_t cur = __ldg(a.text + min(wi, a.nw - 1)) >> (30u - 2u * (rel & 15u));
  int left = (int)(rel & 15u) + 1;  // characters of cur to take
  const int split = (int)max(-1LL, min(a.hi[lane] - ws, (long long)TL - 1));  // j <= split: ws + j <= hi
  int score = L, best = L + 1;
  uint32_t bstart = 0xFFFFFFFFu;
  for (int j = TL - 1; j >= 0; left = 16) {
    const uint32_t next = __ldg(a.text + min(max(--wi, 0LL), a.nw - 1));
    const int end = max(j - left, -1);
    for (; j > max(end, split); --j) score += step(st, W, take(cur, kEdge && ws + j >= a.n_text), mb);
    for (; j > end; --j) {
      score += step(st, W, take(cur, kEdge && ws + j >= a.n_text), mb);
      if (score <= best) {
        best = score;
        bstart = (uint32_t)(ws + j);
      }
    }
    cur = next;
  }
  a.dist[lane] = best;
  a.start[lane] = (long long)bstart;
}

template <class State>
__device__ __forceinline__ void verify(const Args& a, long long lane, long long slot) {
  const long long ws = a.lo[lane];
  const int TL = a.L + 3 * a.E;
  if (ws + TL <= a.n_text)
    scan<State, false>(a, lane, slot, ws, TL);
  else
    scan<State, true>(a, lane, slot, ws, TL);
}

template <int WC>
__global__ void __launch_bounds__(kThreads) myers_verify_kernel(Args a) {
  const int miss = a.L + 1;
  const auto fill = [&](long long lane, uint32_t bits, bool whole) {
    if (whole && bits == 0) {
      *reinterpret_cast<int4*>(a.dist + lane) = make_int4(miss, miss, miss, miss);
      longlong2* s = reinterpret_cast<longlong2*>(a.start + lane);
      s[0] = s[1] = make_longlong2(0xFFFFFFFFLL, 0xFFFFFFFFLL);
      return;
    }
    for (int i = 0; i < 4; ++i)
      if (lane + i < a.n && !((bits >> i) & 1u)) {
        a.dist[lane + i] = miss;
        a.start[lane + i] = 0xFFFFFFFFLL;
      }
  };
  const tiles::Tile tile = tiles::pack<kThreads, kRounds>(a.valid, a.n, fill);
  const long long slot = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (int i = threadIdx.x; i < tile.count; i += kThreads) {
    const long long lane = tile.first + tile.list[i];
    if constexpr (WC > 0)
      verify<RegState<WC>>(a, lane, slot);
    else
      verify<SpillState>(a, lane, slot);
  }
}

template <int WC>
int launch(const Args& a, cudaStream_t stream) {
  myers_verify_kernel<WC><<<(unsigned)Tiles::blocks(a.n), kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches K6 on `stream` and returns cudaGetLastError() (0 on success).
// text: uint32 [nw] packed text of n_text bases; peq: int64 [n / C, 4, W];
// lo, hi: int64 [n]; valid: bool [n]; dist: int32 [n] and start: int64 [n],
// both on 16-byte boundaries; scratch: uint32 [2, W, slots] when W > 8,
// else unused, with slots >= tpufm_myers_verify_slots(n). Does not
// synchronise.
extern "C" int tpufm_myers_verify(const void* text, long long nw, long long n_text, const void* peq,
                                  const void* lo, const void* hi, const void* valid, void* dist, void* start,
                                  long long n, long long C, int W, int L, int E, void* scratch, long long slots,
                                  void* stream) {
  if (n <= 0) return 0;
  if (nw <= 0 || C <= 0 || n % C || L <= 0 || E < 0 || W != (L + 31) / 32 ||
      (reinterpret_cast<uintptr_t>(dist) | reinterpret_cast<uintptr_t>(start)) & 15 ||
      (W > kMaxRegWords && (scratch == nullptr || slots < Tiles::blocks(n) * kThreads)))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const uint32_t*>(text), nw, n_text, static_cast<const long long*>(peq),
               static_cast<const long long*>(lo), static_cast<const long long*>(hi),
               static_cast<const uint8_t*>(valid), static_cast<int*>(dist), static_cast<long long*>(start),
               n, C, W, L, E, static_cast<uint32_t*>(scratch), slots};
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

// The scratch slots K6 needs for n lanes (one a thread of its grid).
extern "C" long long tpufm_myers_verify_slots(long long n) { return Tiles::blocks(n) * kThreads; }

extern "C" const char* tpufm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
