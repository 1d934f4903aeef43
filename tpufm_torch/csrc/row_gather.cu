// K3: row gather, out[j] = table[clamp(idx[j], 0, E - 1)], for Hopper (sm_90a).
//
// Replaces the Pallas kernel _gather_kernel (tpufm/engine/dma_gather.py:40-124,
// built by make_dma_gather, :80), which feeds XLAEngine(gather="dma"), and
// the rate probes that run its computation (.bench/probe5.py:13,
// .bench/probe35.py:23). The clamp is the one a JAX gather applies to the
// rows the engine normally takes, and K1's own (lf_round.cu). The Pallas
// kernel's semaphore ring and 1024-entry index chunks are TPU devices and
// are not carried over.
//
// Bound. HBM-bound, pure data movement: n * row_words * 4 B written in
// order, 8 B of index a row, and the distinct rows read once; at the
// search's shape (2M rows of the 52,085 x 100-word table) 876.5 MB, 261.6
// us at 3.35 TB/s. The 21 MB table fits the 50 MB L2, so the output stream
// sets the pace: it must leave as whole lines while every row read finds
// the table still in L2.
//
// Design. The output of T consecutive rows (a tile) is one contiguous run
// of T * row_words words. A block owns a tile at a time over a persistent
// grid: it loads the tile's T indices with one coalesced load into shared
// memory and clamps them once, so no row waits on an index load of its own.
// Thread f of the tile then writes element f of the run (a 16-byte unit or
// a word) and reads it from row src[f / per_row]; neighbouring threads
// write neighbouring elements, so every store instruction covers whole
// lines, and each thread issues kUnroll loads before its first store,
// stepping its (row, column) without a division.
// The wrapper (engine/row_gather.py) picks the path and the tile and grid
// sizes; this file checks what it relies on. Paths: int4 (row_words % 4 ==
// 0, table and out 16-byte aligned: 16-byte loads and stores) and word (any
// other: word loads and stores, 4 * kUnroll a thread; a warp's store still
// covers one whole 128-byte run of the output).
//
// Cache policy. Stores are evict-first (__stcs) and table loads carry an
// L2 evict_last policy, so that the output stream does not push the table
// out of L2. K1's rows entry reads this output next in the gathered-row
// engine; at its shape the buffer (839 MB) leaves L2 long before it is
// read, and evict-first stores made K3 followed by the rows entry 4-5%
// faster (PERF.md section 6, chip_smoke.py phase 6 of the commit that
// timed the variants).
//
// Tried and not kept (times in PERF.md): a cp.async.bulk copy of each row
// into a ring of shared-memory stages with one bulk store per tile (as
// fast at wide rows, slower at the search's shape and at 8-word rows);
// the next tile's indices loaded before this tile's copy (no gain); 8
// blocks an SM (32 registers: spills); on the word path, four word loads
// into one 16-byte store (as fast as word stores at 6-word rows).
//
// Types. Indices are int64: a 3.2 Gbase table has about 17M rows and the
// interval ends they come from pass 2^31. Table words are the uint32 bits
// of int32 tensors and are copied as they are.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;        // threads of a block
constexpr int kUnroll = 4;           // 16-byte elements a thread keeps in flight
constexpr int kBlocksPerSM = 6;      // resident blocks an SM must hold (40 registers)

enum Path { kInt4 = 0, kWord = 1 };

__device__ __forceinline__ long long clamp_row(long long r, long long nrows) {
  return r < 0 ? 0 : (r >= nrows ? nrows - 1 : r);
}

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ int4 get(const int4* p, uint64_t pol) {
  int4 v;
  asm("ld.global.nc.L2::cache_hint.v4.s32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ uint32_t get(const uint32_t* p, uint64_t pol) {
  uint32_t v;
  asm("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(pol));
  return v;
}

// Copies the tile's run of `total` elements (16-byte units or words) to
// `to`: element f is element c of the tile's row r, read from
// from[src[r] + c]. A thread finds (r, c) of its first element with one
// division a pass and steps it by kThreads elements after; it issues U
// loads before its first store.
template <int U, typename T>
__device__ __forceinline__ void copy_run(const T* __restrict__ from, const long long* src, int per_row,
                                         int total, T* __restrict__ to, uint64_t pol) {
  const int dq = kThreads / per_row, dr = kThreads - dq * per_row;
  for (int base = threadIdx.x; base < total; base += kThreads * U) {
    int r = base / per_row, c = base - r * per_row;
    T v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u * kThreads < total) v[u] = get(from + src[r] + c, pol);
      r += dq;
      c += dr;
      if (c >= per_row) { c -= per_row; ++r; }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + u * kThreads < total) __stcs(to + base + u * kThreads, v[u]);
  }
}

template <int PATH>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
row_gather_kernel(const uint32_t* __restrict__ table, long long nrows, int row_words,
                  const long long* __restrict__ idx, uint32_t* __restrict__ out,
                  long long n, int tile_rows) {
  extern __shared__ long long src[];  // first source element of each row of the tile
  const int per_row = PATH == kInt4 ? row_words / 4 : row_words;  // source elements a row
  const long long tiles = (n + tile_rows - 1) / tile_rows;
  const uint64_t pol = evict_last_policy();
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long first = tile * tile_rows;
    const int rows = (int)min((long long)tile_rows, n - first);
    for (int r = threadIdx.x; r < rows; r += kThreads)
      src[r] = clamp_row(__ldcs(idx + first + r), nrows) * per_row;
    __syncthreads();
    uint32_t* to = out + first * row_words;
    if (PATH == kInt4)
      copy_run<kUnroll>(reinterpret_cast<const int4*>(table), src, per_row, rows * per_row,
                        reinterpret_cast<int4*>(to), pol);
    else
      copy_run<4 * kUnroll>(table, src, per_row, rows * per_row, to, pol);
    __syncthreads();  // src is rewritten by the next tile
  }
}

template <int PATH>
int launch(const void* table, long long nrows, int row_words, const void* idx, void* out,
           long long n, int tile_rows, int blocks, cudaStream_t s) {
  row_gather_kernel<PATH><<<blocks, kThreads, (size_t)tile_rows * sizeof(long long), s>>>(
      static_cast<const uint32_t*>(table), nrows, row_words, static_cast<const long long*>(idx),
      static_cast<uint32_t*>(out), n, tile_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches K3 on `stream` and returns cudaGetLastError() (0 on success).
// table: uint32 [nrows, row_words]; idx: int64 [n]; out: uint32 [n, row_words].
// path 0 (int4) needs row_words % 4 == 0 and 16-byte aligned table and out;
// path 1 (word) takes any.
// tile_rows: rows a tile (at most 4096, so that their indices fit shared
// memory); blocks: the persistent grid of kThreads-thread blocks. Does not
// synchronise.
extern "C" int tpufm_row_gather(const void* table, long long nrows, int row_words,
                                const void* idx, void* out, long long n, int path,
                                int tile_rows, int blocks, void* stream) {
  if (n <= 0) return 0;
  if (nrows <= 0 || row_words <= 0 || tile_rows <= 0 || tile_rows > 4096 || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const uintptr_t t = reinterpret_cast<uintptr_t>(table), o = reinterpret_cast<uintptr_t>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (path) {
    case kInt4:
      if (row_words % 4 || t % 16 || o % 16) return (int)cudaErrorInvalidValue;
      return launch<kInt4>(table, nrows, row_words, idx, out, n, tile_rows, blocks, s);
    case kWord:
      return launch<kWord>(table, nrows, row_words, idx, out, n, tile_rows, blocks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* tpufm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
