// Rows staged by asynchronous copies: the staging of K8 and K9
// (lf_round_split.cu) and of K1's paired entry (lf_round.cu), beside
// lf_round.cuh's stage_rows, which K1's other entries and K4 keep.
//
// stage_rows walks 32 x units copy trips a warp, each a load into a
// register and a store to shared memory, every lane's row whether it needs
// one or not. Here a warp first lists its copy jobs (a row and the slot it
// goes to) in shared memory, only for the lanes that need a row
// (ballot-compacted), then issues every 16-byte unit of every listed row as
// one cp.async (LDGSTS; 4-byte copies on tables whose rows are not 16-byte
// units), consecutive lanes on consecutive units of one row, and waits once
// (cp.async.wait_all, __syncwarp). No register holds a unit, so all of a
// warp's units are in flight together, and the second rows of K8 and of
// K1's paired entry (HiRows) ride in the same batch as the first.
//
// Tried and dropped (scripts/k89_ab.py, PERF.md §6): each row as one
// cp.async.bulk completed on an mbarrier by its transaction count (TMA on
// 144-byte rows: 6-7% faster on K8's split rounds, 8-14% slower on K8's
// AC round 18 and K9's allgather stream, and 13x slower where every lane
// of a warp wants the same row); rows staged in 4-byte copies at an odd
// slot stride (no bank conflicts on the counting reads, but four times the
// copy instructions: 26-50% slower); copies that skip L1 (.cg: 15x slower
// where every read of a round shares its rows, which then queue at one L2
// slice).

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "lf_round.cuh"

namespace tpufm {

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One asynchronous copy of a V-word unit from global to shared memory,
// allocating in L1 (.ca): rows that many lanes of an SM read at once (every
// read of round 1 at the full interval, the a2a buckets' zero rows) hit
// there instead of queueing at one L2 slice.
template <int V>
__device__ __forceinline__ void cp_async(uint32_t* dst, const uint32_t* src) {
  if (V == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

// A warp's part of the block's dynamic shared memory: `Slots` row slots of
// `stride` words (a multiple of 4), the copy list (each job's source row
// and slot), then `extra` words of the kernel's own. Every part starts on
// a 16-byte boundary.
template <int Slots>
struct WarpStage {
  uint32_t* rows;
  const uint32_t** src;
  uint8_t* slot;
  uint32_t* extra;

  static constexpr size_t list_bytes = Slots * sizeof(void*) + (Slots + 15) / 16 * 16;

  __host__ __device__ static constexpr size_t bytes(int stride, int extra_words) {
    return ((size_t)Slots * stride * 4 + list_bytes + (size_t)extra_words * 4 + 15) / 16 * 16;
  }

  __device__ static WarpStage at(int stride, int extra_words) {
    extern __shared__ uint4 staged[];
    char* p = reinterpret_cast<char*>(staged) + (threadIdx.x >> 5) * bytes(stride, extra_words);
    WarpStage w;
    w.rows = reinterpret_cast<uint32_t*>(p);
    p += (size_t)Slots * stride * 4;
    w.src = reinterpret_cast<const uint32_t**>(p);
    p += Slots * sizeof(void*);
    w.slot = reinterpret_cast<uint8_t*>(p);
    p += (Slots + 15) / 16 * 16;
    w.extra = reinterpret_cast<uint32_t*>(p);
    return w;
  }

  // Lists `row` into slot `slot` for every lane where `want` holds, after
  // the `listed` jobs already listed; returns the new count (the same in
  // every lane). Warp-collective.
  __device__ int list(int listed, bool want, const uint32_t* row, int slot_of_lane) const {
    const unsigned m = __ballot_sync(kFullWarp, want);
    if (want) {
      const int i = listed + __popc(m & lanes_below());
      src[i] = row;
      slot[i] = (uint8_t)slot_of_lane;
    }
    return listed + __popc(m);
  }

  // As list, each row into the slot of its own job number (packed slots);
  // `at` is set to the lane's slot where `want` holds.
  __device__ int list_packed(int listed, bool want, const uint32_t* row, int& at) const {
    const unsigned m = __ballot_sync(kFullWarp, want);
    if (want) {
      at = listed + __popc(m & lanes_below());
      src[at] = row;
      slot[at] = (uint8_t)at;
    }
    return listed + __popc(m);
  }
};

// Slots a warp for the second rows of its reads (K8's hi rows, K1-paired's
// next halves), after its 32 lo slots, one a distinct row; more distinct
// rows take further batches. (8, 16 and 32 were slower on K8: fewer warps
// resident.)
constexpr int kHiSlots = 4;

// The second rows of a warp's reads, in the kHiSlots slots after the 32 lo
// slots: the lanes where `want` holds, grouped by `key` (their row; never
// 0xFFFFFFFF), each group's row staged once, by its lowest lane (`lead`),
// into slot 32 + rank - base of the batch whose first rank is `base`
// (every read of round 1 from the full interval shares one).
struct HiRows {
  bool want, lead;
  int rank, groups;

  // Warp-collective.
  __device__ HiRows(bool want_row, uint32_t key) : want(want_row) {
    const unsigned same = __match_any_sync(kFullWarp, want ? key : 0xFFFFFFFFu);
    const int leader = __ffs(same) - 1;
    lead = want && leader == (int)(threadIdx.x & 31);
    const unsigned leads = __ballot_sync(kFullWarp, lead);
    rank = __shfl_sync(kFullWarp, __popc(leads & lanes_below()), leader);
    groups = __popc(leads);
  }

  // Whether the lane's row is in the batch from rank `base`.
  __device__ bool in(int base) const { return want && rank >= base && rank < base + kHiSlots; }

  // The lane's slot in the batch from rank `base`.
  __device__ int slot(int base) const { return 32 + rank - base; }

  // Lists the batch from rank `base` (the leaders' `row`) after the `listed`
  // jobs of `w`; returns the new count. Warp-collective.
  template <int Slots>
  __device__ int list(const WarpStage<Slots>& w, int listed, int base, const uint32_t* row) const {
    return w.list(listed, lead && in(base), row, slot(base));
  }
};

// Issues the copies of the first `words` words of each of the `jobs`
// listed rows into its slot, all units at once. Warp-collective; `jobs` is
// the same in every lane. A row is copied in whole V-word units, which stay
// inside it (V divides the row stride).
template <int V, int Slots>
__device__ __forceinline__ void issue_rows_async(const WarpStage<Slots>& w, int stride, int jobs, int words) {
  const int lane = threadIdx.x & 31;
  __syncwarp();  // the copy list is written
  const int units = (words + V - 1) / V;
  // job i = t / units, unit u = t % units of t = lane, lane + 32, ...;
  // stepped without a division a trip
  const int di = 32 / units, du = 32 % units;
  int i = lane / units, u = lane % units;
  while (i < jobs) {
    cp_async<V>(w.rows + w.slot[i] * stride + u * V, w.src[i] + u * V);
    i += di;
    u += du;
    if (u >= units) {
      u -= units;
      ++i;
    }
  }
}

// Returns when every copy the warp issued has landed and is visible to
// every lane of it. Warp-collective.
__device__ __forceinline__ void wait_rows_async() {
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncwarp();
}

// issue_rows_async, then wait_rows_async.
template <int V, int Slots>
__device__ __forceinline__ void stage_rows_async(const WarpStage<Slots>& w, int stride, int jobs, int words) {
  issue_rows_async<V>(w, stride, jobs, words);
  wait_rows_async();
}

// Threads a block (1-8 warps) for warps of `warp_bytes` of dynamic shared
// memory each: the count that keeps the most warps resident on an SM (228
// KB of shared memory and 64 warps an SM, 1 KB of it reserved a block, at
// most 32 blocks; ties to the larger block); *resident is set to the warps
// an SM then holds.
inline int async_block(size_t warp_bytes, int* resident) {
  constexpr size_t kSmemPerSm = 228u * 1024u, kReserved = 1024u, kSmemPerBlock = 227u * 1024u;
  int best = 0, warps = 1;
  for (int w = 1; w <= 8 && w * warp_bytes <= kSmemPerBlock; ++w) {
    long long blocks = (long long)(kSmemPerSm / (w * warp_bytes + kReserved));
    blocks = blocks < 32 ? blocks : 32;
    blocks = blocks < 64 / w ? blocks : 64 / w;
    if (blocks * w >= best) {
      best = (int)(blocks * w);
      warps = w;
    }
  }
  *resident = best;
  return 32 * warps;
}

// Warps of `warp_bytes` each that an SM holds at once (async_block).
inline int resident_warps(size_t warp_bytes) {
  int resident = 0;
  async_block(warp_bytes, &resident);
  return resident;
}

// Launches `kernel` over n items, one a thread, whose warps each take
// `warp_bytes` of dynamic shared memory, in blocks of async_block's size.
// Returns cudaGetLastError() as an int.
template <class Kernel, class... Args>
int launch_async_staged(Kernel kernel, size_t warp_bytes, long long n, cudaStream_t stream, Args... args) {
  int resident = 0;
  const int threads = async_block(warp_bytes, &resident);
  const size_t smem = threads / 32 * warp_bytes;
  if (smem > 227u * 1024u) return (int)cudaErrorInvalidValue;
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
