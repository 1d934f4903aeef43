// K1: one k-step LF round per interval end, for Hopper (sm_90a).
//
// Replaces the Pallas kernel _lf_round_kernel (tpufm/engine/pallas_kernel.py:41,
// built by make_lf_round, :102) and computes exactly what lf_step_fused
// (tpufm/engine/xla.py:80) computes for one end:
//
//   block  = iv / d;  row = entries[min(block, nrows - 1)]
//   count  = sum over windows w of popcount(prefix_mask(iv % d, w)
//            & AND over levels i of plane pair i, each plane taken as is or
//              complemented by the matching bit of code)
//   count -= #levels i with block == dollar_block[i], code == dollar_base[i]
//            and iv > dollar_pos[i]
//   out    = row[2k*nb + (code mod 4^k)] + count          (mod 2^32)
//
// Design. One thread per interval end over a 1-D grid; the ragged edge is
// masked here, so any n works (the TPU version padded to a 2048-end tile).
// The kernel loads its own row: on the TPU the gather stayed in XLA and the
// gathered rows went through HBM between the two (pallas_kernel.py:12-19);
// nothing forces that here. It reads only the plane words of windows the
// prefix mask covers, and ONE counter by index: the TPU's binary-tree
// counter pick was a lane-select workaround and is not ported.
//
// Two entries share one round body (lf_round_end, lf_round.cuh, which K4's
// LF(1) hop in locate_walk.cu shares too). tpufm_lf_round is the fused
// path above. tpufm_lf_round_rows keeps the Pallas contract: row j was
// gathered beforehand (by K3, row_gather.cu, or by torch indexing) and may
// carry padding past the counters, as XLAEngine(gather="dma") rows do.
// It serves the gathered-row engines, which pay a [n, row_words] buffer
// written and read back through HBM every round.
//
// Bound. Dependent random row loads: at most (2k*nb + 1) * 4 B per end per
// round, 148 B at k=3 d=192. At 10 Mbase the 21 MB fused table fits the
// H100's 50 MB L2; at genome scale it does not and each row comes from HBM.
// Fusing all rounds of a wave into one launch with the interval kept in a
// register (K2) is later work.
//
// Types. Intervals reach bwtsize, above 2^31 at 3.2 Gbase, so they are held
// as uint32_t here and int64 on the torch side, never as a signed int32.
// Table words arrive as int32 tensors holding the uint32 bits.

#include <cstdint>
#include <cuda_runtime.h>

#include "lf_round.cuh"

namespace {

using tpufm::lf_round_end;

constexpr int kThreads = 256;

// K1 as the engine's fused path runs it: each end loads its own row.
template <int K>
__global__ void lf_round_kernel(const uint32_t* __restrict__ entries,
                                long long nrows, int row_words, int nb,
                                const long long* __restrict__ iv,
                                const long long* __restrict__ code,
                                const long long* __restrict__ dollar,
                                long long* __restrict__ out, long long n) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const uint32_t v = (uint32_t)iv[j];
  const uint32_t d = 32u * (uint32_t)nb;
  const uint32_t block = v / d;
  const unsigned long long row =
      min((unsigned long long)block, (unsigned long long)(nrows - 1));
  out[j] = (long long)lf_round_end<K>(entries + row * (unsigned long long)row_words,
                                      nb, v, (uint32_t)code[j], block, d, dollar);
}

// K1 with the Pallas contract: end j's row was gathered beforehand into
// rows[j] (by K3, row_gather.cu, or by torch indexing).
template <int K>
__global__ void lf_round_rows_kernel(const uint32_t* __restrict__ rows,
                                     int row_words, int nb,
                                     const long long* __restrict__ iv,
                                     const long long* __restrict__ code,
                                     const long long* __restrict__ dollar,
                                     long long* __restrict__ out, long long n) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const uint32_t v = (uint32_t)iv[j];
  const uint32_t d = 32u * (uint32_t)nb;
  out[j] = (long long)lf_round_end<K>(rows + j * (unsigned long long)row_words,
                                      nb, v, (uint32_t)code[j], v / d, d, dollar);
}

template <int K>
int launch(const void* entries, long long nrows, int row_words, int nb,
           const void* iv, const void* code, const void* dollar, void* out,
           long long n, cudaStream_t stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  lf_round_kernel<K><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(entries), nrows, row_words, nb,
      static_cast<const long long*>(iv), static_cast<const long long*>(code),
      static_cast<const long long*>(dollar), static_cast<long long*>(out), n);
  return (int)cudaGetLastError();
}

template <int K>
int launch_rows(const void* rows, int row_words, int nb, const void* iv,
                const void* code, const void* dollar, void* out, long long n,
                cudaStream_t stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  lf_round_rows_kernel<K><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(rows), row_words, nb,
      static_cast<const long long*>(iv), static_cast<const long long*>(code),
      static_cast<const long long*>(dollar), static_cast<long long*>(out), n);
  return (int)cudaGetLastError();
}

bool bad_shape(int row_words, int k, int nb, long long n) {
  return nb <= 0 || k < 1 || k > 8 || row_words < 2 * k * nb + (1 << (2 * k)) ||
         (n + kThreads - 1) / kThreads > 0x7FFFFFFFLL;
}

}  // namespace

// Launches K1 on `stream` and returns cudaGetLastError() (0 on success).
// entries: uint32 [nrows, row_words]; iv, code, out: int64 [n];
// dollar: int64 [3, k] (rows pos, base, block). Does not synchronise.
extern "C" int tpufm_lf_round(const void* entries, long long nrows,
                              int row_words, int k, int nb, const void* iv,
                              const void* code, const void* dollar, void* out,
                              long long n, void* stream) {
  if (n <= 0) return 0;
  if (nrows <= 0 || bad_shape(row_words, k, nb, n)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(entries, nrows, row_words, nb, iv, code, dollar, out, n, s);
    case 2: return launch<2>(entries, nrows, row_words, nb, iv, code, dollar, out, n, s);
    case 3: return launch<3>(entries, nrows, row_words, nb, iv, code, dollar, out, n, s);
    case 4: return launch<4>(entries, nrows, row_words, nb, iv, code, dollar, out, n, s);
    case 5: return launch<5>(entries, nrows, row_words, nb, iv, code, dollar, out, n, s);
    case 6: return launch<6>(entries, nrows, row_words, nb, iv, code, dollar, out, n, s);
    case 7: return launch<7>(entries, nrows, row_words, nb, iv, code, dollar, out, n, s);
    default: return launch<8>(entries, nrows, row_words, nb, iv, code, dollar, out, n, s);
  }
}

// Launches K1 on rows gathered beforehand, the Pallas contract
// make_lf_round(k, d)(rows, iv, code, dollar): rows: uint32 [n, row_words],
// row j belonging to end j; otherwise as tpufm_lf_round.
extern "C" int tpufm_lf_round_rows(const void* rows, int row_words, int k,
                                   int nb, const void* iv, const void* code,
                                   const void* dollar, void* out, long long n,
                                   void* stream) {
  if (n <= 0) return 0;
  if (bad_shape(row_words, k, nb, n)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch_rows<1>(rows, row_words, nb, iv, code, dollar, out, n, s);
    case 2: return launch_rows<2>(rows, row_words, nb, iv, code, dollar, out, n, s);
    case 3: return launch_rows<3>(rows, row_words, nb, iv, code, dollar, out, n, s);
    case 4: return launch_rows<4>(rows, row_words, nb, iv, code, dollar, out, n, s);
    case 5: return launch_rows<5>(rows, row_words, nb, iv, code, dollar, out, n, s);
    case 6: return launch_rows<6>(rows, row_words, nb, iv, code, dollar, out, n, s);
    case 7: return launch_rows<7>(rows, row_words, nb, iv, code, dollar, out, n, s);
    default: return launch_rows<8>(rows, row_words, nb, iv, code, dollar, out, n, s);
  }
}

extern "C" const char* tpufm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
