// Tile compaction of a candidate grid's valid lanes, shared by K5
// (hamming_verify.cu) and K6 (myers_verify.cu).
//
// A verify grid is [B, C] lanes, and few of them are valid (a unique seed
// gives one valid lane of its seed_hits). A block of kThreads threads owns
// a tile of kTile = kRounds * kThreads * 4 consecutive lanes, taken in
// kRounds rounds of kThreads * 4 lanes, 4 lanes a thread. Each thread
// loads the valid bytes of its 4 lanes of every round at once (4-byte
// loads, a warp's 128 bytes in one request) and writes the results of its
// invalid lanes itself: 4 lanes' results in 16-byte stores, so that a
// warp's stores fill whole lines. The block then lists the tile's valid
// lanes in shared memory, in lane order: a popcount a thread and round, an
// inclusive scan across each warp with shuffles, and a prefix over the
// block's warps and rounds. The caller's threads take the list one lane a
// thread, so the warps that work hold valid lanes only (all but the last
// of a tile hold 32). No global atomics and no host sync: the list's order
// is fixed, and each lane's result depends on that lane alone.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tpufm {
namespace tiles {

template <int kThreads, int kRounds>
struct Shape {
  static constexpr int kTile = kRounds * kThreads * 4;  // lanes a block
  static long long blocks(long long n) { return (n + kTile - 1) / kTile; }
};

struct Tile {
  long long first;       // the tile's first lane
  int count;             // its valid lanes
  const uint16_t* list;  // their offsets in the tile, ascending (shared memory)
};

// Lists the valid lanes of block blockIdx.x's tile. fill(lane, bits, whole)
// writes the results of the lanes lane + i (i < 4, lane a multiple of 4)
// whose bit i of `bits` is clear and that lie below n; `whole`: all four do.
// Every thread of the block must call it (it synchronises the block).
template <int kThreads, int kRounds, class Fill>
__device__ __forceinline__ Tile pack(const uint8_t* __restrict__ valid, long long n, Fill fill) {
  constexpr int kWarps = kThreads / 32, kRound = kThreads * 4;
  __shared__ uint16_t list[Shape<kThreads, kRounds>::kTile];
  __shared__ int warp_sums[kRounds][kWarps];
  const int tid = threadIdx.x, lane_id = tid & 31, warp = tid >> 5;
  const long long tile = (long long)blockIdx.x * Shape<kThreads, kRounds>::kTile;
  const bool aligned = (reinterpret_cast<uintptr_t>(valid) & 3) == 0;
  uint32_t word[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {  // every round's load in flight at once
    const long long first = tile + r * kRound + 4 * tid;
    word[r] = 0;
    if (aligned && first + 4 <= n) {
      word[r] = __ldcs(reinterpret_cast<const unsigned int*>(valid + first));  // read once
    } else {  // the grid's ragged end, or a mask not on a 4-byte boundary
      for (int i = 0; i < 4; ++i)
        if (first + i < n) word[r] |= (uint32_t)valid[first + i] << (8 * i);
    }
  }
  uint32_t bits[kRounds];
  int incl[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long first = tile + r * kRound + 4 * tid;
    // bit i: byte i of the word nonzero
    bits[r] = ((__vcmpne4(word[r], 0u) & 0x01010101u) * 0x01020408u) >> 24;
    if (first < n) fill(first, bits[r], first + 4 <= n);
    incl[r] = __popc(bits[r]);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, incl[r], o);
      if (lane_id >= o) incl[r] += y;
    }
    if (lane_id == 31) warp_sums[r][warp] = incl[r];
  }
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    int pos = total + incl[r] - __popc(bits[r]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      pos += w < warp ? warp_sums[r][w] : 0;
      total += warp_sums[r][w];
    }
    for (uint32_t m = bits[r]; m; m &= m - 1) list[pos++] = (uint16_t)(r * kRound + 4 * tid + __ffs(m) - 1);
  }
  __syncthreads();
  return {tile, total, list};
}

}  // namespace tiles
}  // namespace tpufm
