// Batched SA lookup by LF walks to the nearest sampled row: one thread per
// walk.
//
// Computes what bwt_tpu/ops/search.py:unc_sa computes (seqindex.c:244-255;
// the port's plain version is bwt_tpu_torch/ops/search.py:unc_sa_plain),
// bit for bit: a lane steps LF while its row is not a multiple of the
// sample rate and returns sa_samples[row >> shift] + steps, wrapped by
// length + 1.  The JAX version is an XLA loop, not a Pallas kernel; its
// compaction ladder exists because a lockstep batch runs as long as its
// slowest lane.  Here each thread stops on its own, so there is no ladder.
//
// The per-row body is fm::sa_walk (fm_search.cuh); this file is the shell
// that gives every row a thread.
//
// Step bound: a walk from a real row (0..length) reaches row 0, which is
// sampled, within length + 1 steps.  A lane still walking after `limit`
// steps stops; when `limit` is that bound (bound_is_limit), the lane
// counts in flag[0] and flag[1] holds B - (its lane), the largest such
// value over the lanes, so the wrapper can name the first row that
// overran and raise instead of hanging the card.
//
// What bounds it on the H100: a walk is a chain of dependent 32-byte row
// loads (about sa_rate steps on average), one per step; at a 2^25-base
// genome the bucket table stays in the 50 MB L2, so the chain runs at L2
// latency and throughput comes from walks in flight.

#include <climits>
#include <cuda_runtime.h>
#include <stddef.h>

#include "fm_search.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
unc_sa_kernel(const int* __restrict__ idx, int B, fm::Index ix,
              fm::Samples sa, int limit, int bound_is_limit,
              int* __restrict__ out, int* __restrict__ flag) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const fm::Consts k = fm::load_consts(ix);
  const fm::Walk w = fm::sa_walk(ix, k, sa, __ldg(idx + b), limit);
  out[b] = w.pos;
  if (bound_is_limit && w.unsampled) fm::raise_flag(flag, B, b);
}

}  // namespace

// idx (B,) int32 rows on the device; sa_samples (nsamples,); out (B,)
// int32; flag (2,) int32, zeroed by the caller.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int unc_sa_launch(const int* idx, int B, const int* buckets,
                             int nrows, const int* C, const int* endloc,
                             const int* sa_samples, int nsamples, int shift,
                             int length, int limit, int bound_is_limit,
                             int* out, int* flag, void* stream) {
  if (B <= 0) return 0;
  const fm::Index ix{buckets, nrows, C, endloc};
  const int blocks = (B + kThreads - 1) / kThreads;
  unc_sa_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, B, ix, fm::Samples{sa_samples, nsamples, shift, length}, limit,
      bound_is_limit, out, flag);
  return static_cast<int>(cudaGetLastError());
}
