// K3: row gather, out[j] = table[clamp(idx[j], 0, E - 1)], for Hopper (sm_90a).
//
// Replaces the Pallas kernel _gather_kernel (tpufm/engine/dma_gather.py:40-124,
// built by make_dma_gather, :80), which feeds XLAEngine(gather="dma"), and
// the rate probes that run its computation (.bench/probe5.py:13,
// .bench/probe35.py:23). The clamp is the one a JAX gather applies to the
// rows the engine normally takes, and K1's own (lf_round.cu).
//
// Design, simple and right first. The reference's Coop mapping (SURVEY.md
// section 2 row 11): a group of G lanes, the smallest power of two that
// covers one row's units and at most a warp, copies one row. The group's
// first lane loads the row's index once and hands it to the others with a
// warp shuffle. A unit is a 16-byte int4 (the vector path: row_words % 4 ==
// 0 and both bases 16-byte aligned) or a 4-byte word; the wrapper picks the
// path and this file checks it. Neighbouring lanes copy neighbouring units,
// so one row's loads and stores coalesce. Any n and any row_words >= 1: the
// ragged edge is masked in the kernel, with no padding of n to the TPU's
// 1024-entry index chunks. The TPU's rule that rows be a multiple of 128
// words (a DMA constraint, dma_gather.py:87-91) and its R copies in flight
// are not ported: the card keeps many rows in flight by running many groups.
//
// Bound. HBM-bound, pure data movement: n * row_words * 4 B written in
// order, 8 B of index a row, and the distinct rows read once; at the
// search's shape (2M rows of the 52,085 x 100-word table) 876.5 MB, 261.6
// us at 3.35 TB/s, of which this design reaches about half: each lane
// copies its units one at a time, load then store, so few loads are in
// flight per lane.
//
// Types. Indices are int64: a 3.2 Gbase table has about 17M rows and the
// interval ends they come from pass 2^31. Table words are the uint32 bits
// of int32 tensors and are copied as they are.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void row_gather_kernel(const T* __restrict__ table, long long nrows,
                                  int units, int lanes_log2,
                                  const long long* __restrict__ idx,
                                  T* __restrict__ out, long long n) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lanes = 1 << lanes_log2;
  const long long j = t >> lanes_log2;
  const int lane = (int)(t & (lanes - 1));
  long long src = 0;
  if (lane == 0 && j < n) {
    src = idx[j];
    src = src < 0 ? 0 : (src >= nrows ? nrows - 1 : src);
  }
  // every lane of the warp reaches the shuffle: the edge is masked after it
  src = __shfl_sync(0xFFFFFFFFu, src, 0, lanes);
  if (j >= n) return;
  const T* from = table + src * units;
  T* to = out + j * units;
  for (int u = lane; u < units; u += lanes) to[u] = __ldg(from + u);
}

template <typename T>
int launch(const void* table, long long nrows, int units, const void* idx,
           void* out, long long n, cudaStream_t stream) {
  int lanes_log2 = 0;
  while (lanes_log2 < 5 && (1 << lanes_log2) < units) ++lanes_log2;
  const long long blocks = ((n << lanes_log2) + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  row_gather_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(table), nrows, units, lanes_log2,
      static_cast<const long long*>(idx), static_cast<T*>(out), n);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches K3 on `stream` and returns cudaGetLastError() (0 on success).
// table: uint32 [nrows, row_words]; idx: int64 [n]; out: uint32 [n, row_words].
// vec != 0 copies 16-byte units and needs row_words % 4 == 0 and 16-byte
// aligned table and out. Does not synchronise.
extern "C" int tpufm_row_gather(const void* table, long long nrows,
                                int row_words, const void* idx, void* out,
                                long long n, int vec, void* stream) {
  if (n <= 0) return 0;
  if (nrows <= 0 || row_words <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    if (row_words % 4 || reinterpret_cast<uintptr_t>(table) % 16 ||
        reinterpret_cast<uintptr_t>(out) % 16)
      return (int)cudaErrorInvalidValue;
    return launch<int4>(table, nrows, row_words / 4, idx, out, n, s);
  }
  return launch<uint32_t>(table, nrows, row_words, idx, out, n, s);
}

extern "C" const char* tpufm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
