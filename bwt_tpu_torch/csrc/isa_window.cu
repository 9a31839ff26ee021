// The inverse-SA window as one launch: one thread per window writes the
// SA rows of the window's positions.
//
// Computes what bwt_tpu/ops/search.py:isa_window computes (an XLA loop
// there; the port's plain version is
// bwt_tpu_torch/ops/search.py:isa_window_plain), bit for bit:
// rows[b, j] = SA^-1[plo[b] + j] for j < width[b] and 0 <= plo[b] + j <=
// length, else -1.  The per-window body is fm::isa_chain (fm_search.cuh),
// which the service kernel shares; this file is the shell that gives
// every window a thread and a row of the output.
//
// What bounds it on the H100: a chain of dependent 32-byte row loads, one
// LF step a position from the ISA sample above the window down to its
// floor (up to rate - 1 + W steps); throughput comes from windows in
// flight.  A thread's W stores go to its own 4 W bytes, so a warp's
// stores of one step are not coalesced; L2 merges them.

#include <cuda_runtime.h>
#include <stddef.h>

#include "fm_search.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kTp>
__global__ void __launch_bounds__(kThreads)
isa_window_kernel(const int* __restrict__ plo, const int* __restrict__ width,
                  int B, int W, fm::IndexT<kTp> ix, fm::IsaT<kTp> isa,
                  int* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const fm::Consts k = fm::load_consts(ix);
  int* o = out + static_cast<size_t>(b) * W;
  for (int j = 0; j < W; ++j) o[j] = -1;
  fm::isa_chain(ix, k, isa, __ldg(plo + b), __ldg(width + b), W,
                [&](int j, int row) { o[j] = row; });
}

template <bool kTp>
int launch(const int* plo, const int* width, int B, int W,
           const fm::IndexArgs& ia, const fm::TableArgs& isa, int shift,
           int length, int* out, cudaStream_t s) {
  const int blocks = (B + kThreads - 1) / kThreads;
  isa_window_kernel<kTp><<<blocks, kThreads, 0, s>>>(
      plo, width, B, W, fm::index_form<kTp>(ia),
      fm::isa_form<kTp>(isa, shift, length), out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// plo and width (B,) int32; the index as fm::IndexArgs and the ISA samples
// as fm::TableArgs (per > 0: a tp view); out (B, W) int32.  All on the
// device, contiguous.  Launches on `stream` and returns cudaGetLastError()
// (0 on success).
extern "C" int isa_window_launch(const int* plo, const int* width, int B,
                                 int W, const void* buckets, int nrows,
                                 int per, const int* C, const int* endloc,
                                 const void* isa_samples, int nisa,
                                 int isa_per, int shift, int length, int* out,
                                 void* stream) {
  if (B <= 0) return 0;
  const fm::IndexArgs ia{buckets, nrows, per, C, endloc};
  const fm::TableArgs isa{isa_samples, nisa, isa_per};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return per > 0 ? launch<true>(plo, width, B, W, ia, isa, shift, length, out, s)
                 : launch<false>(plo, width, B, W, ia, isa, shift, length, out,
                                 s);
}
