// K1: anti-diagonal NW/SW DP fill for a batch of (read, genome) jobs.
//
// Replaces the Pallas TPU kernel bwt_tpu/ops/pallas_align.py:_kernel
// (called through dp_fill_wavefront) and computes exactly what it
// computes, in the batch-major layout (B, D, L1+1) with D = L1+L2+1:
// [b, d, i] is DP cell (i, d-i).  Cells with d-i outside 0..L2 are
// filled by the same recurrence (with genome code 0 there) and never
// read by a backtrack; they are kept so the output is bit-equal.  The
// recurrence and the sweeps are dp_cell.cuh's; this file is their sink
// (store value and pointer, int32 each, a diagonal's rows to neighbouring
// addresses) and the launcher.
//
// What bounds it on the H100: its stores, 8 * D * (L1+1) bytes a job.
// The sweeps carry the diagonals in registers or shared memory, so nothing
// is read back and a warp-sized job runs without a barrier.  The launcher
// picks by shape:
//   L1 + 1 <= 128                      a warp a job, kWarpJobs jobs a block,
//                                      two stripes of rows (L1 + 1 <= 64)
//                                      or four;
//   5 * (L1+1) ints fit shared memory  a block a job, diagonals in shared
//                                      memory (L1 up to 11,621);
//   taller                             a block a job, diagonals d-1 and d-2
//                                      read back from the output arrays.

#include <cuda_runtime.h>
#include <stddef.h>

#include "dp_cell.cuh"

namespace {

constexpr int kWarpJobs = 4;          // jobs (warps) a block of the warp form

struct Job {
  const int* read;
  const int* genome;
  int L2;
  __device__ int read_at(int k) const { return __ldg(read + k); }
  __device__ int genome_at(int k) const {
    return k < L2 ? __ldg(genome + k) : 0;
  }
};

struct StoreSink {
  int* V;
  int* P;
  int lanes;
  __device__ __forceinline__ void put(int d, int i, int, int v, int p) {
    const size_t at = (size_t)d * lanes + i;
    if (i < lanes) V[at] = v;
    if (i < lanes) P[at] = p;
  }
  template <int kStripes>
  __device__ __forceinline__ void diagonal(int, const int (&)[kStripes]) {}
};

// kStripes > 0: the warp form with that many stripes; 0: the block form.
template <int kStripes>
__device__ __forceinline__ void fill_job(size_t job,
                                         const int* reads, const int* genomes,
                                         int* vals, int* ptrs, int L1, int L2,
                                         const dp::Scoring& s, int* carry) {
  const int lanes = L1 + 1;
  const int D = L1 + L2 + 1;
  const Job in{reads + job * L1, genomes + job * L2, L2};
  StoreSink sink{vals + job * D * lanes, ptrs + job * D * lanes, lanes};
  auto read_at = [&](int k) { return in.read_at(k); };
  auto genome_at = [&](int k) { return in.genome_at(k); };
  if constexpr (kStripes > 0) {
    dp::sweep_warp<kStripes>(s, lanes, D - 1, read_at, genome_at, sink);
  } else {
    dp::sweep_block<true>(s, lanes, D - 1, L2, carry, lanes, read_at,
                          genome_at, sink);
  }
}

template <int kStripes>
__global__ void __launch_bounds__(32 * kWarpJobs)
dp_fill_warp_kernel(const int* __restrict__ reads,
                    const int* __restrict__ genomes, int* __restrict__ vals,
                    int* __restrict__ ptrs, int B, int L1, int L2,
                    dp::Scoring s) {
  const int job = blockIdx.x * kWarpJobs + (threadIdx.x >> 5);
  if (job >= B) return;  // a whole warp
  fill_job<kStripes>(job, reads, genomes, vals, ptrs, L1, L2, s, nullptr);
}

__global__ void __launch_bounds__(1024)
dp_fill_block_kernel(const int* __restrict__ reads,
                     const int* __restrict__ genomes, int* __restrict__ vals,
                     int* __restrict__ ptrs, int L1, int L2, dp::Scoring s) {
  extern __shared__ int carry[];
  fill_job<0>(blockIdx.x, reads, genomes, vals, ptrs, L1, L2, s, carry);
}

// The form without a shared-memory limit: a cell reads diagonals d-1 and
// d-2 from the output arrays (in L2 right after they were written).
__global__ void __launch_bounds__(1024)
dp_fill_readback_kernel(const int* __restrict__ reads,
                        const int* __restrict__ genomes, int* vals, int* ptrs,
                        int L1, int L2, dp::Scoring s) {
  const int lanes = L1 + 1;
  const int D = L1 + L2 + 1;
  const size_t job = blockIdx.x;
  const Job in{reads + job * L1, genomes + job * L2, L2};
  int* V = vals + job * D * lanes;
  int* P = ptrs + job * D * lanes;
  for (int i = threadIdx.x; i < lanes; i += blockDim.x) {
    V[i] = 0;
    P[i] = 0;
  }
  __syncthreads();
  for (int d = 1; d < D; ++d) {
    const int* v1 = V + (size_t)(d - 1) * lanes;
    const int* p1 = P + (size_t)(d - 1) * lanes;
    const int* v2 = V + (size_t)(d >= 2 ? d - 2 : 0) * lanes;
    for (int i = threadIdx.x; i < lanes; i += blockDim.x) {
      const int j = d - i;
      const int up = i > 0 ? i - 1 : 0;
      int v, p;
      dp::cell(s, d, i, i > 0 ? in.read_at(i - 1) : 0,
               j >= 1 ? in.genome_at(j - 1) : 0, d >= 2 ? v2[up] : 0, v1[i],
               p1[i], v1[up], p1[up], v, p);
      V[(size_t)d * lanes + i] = v;
      P[(size_t)d * lanes + i] = p;
    }
    __syncthreads();
  }
}

}  // namespace

// reads (B, L1) and genomes (B, L2) int32, contiguous, on the device;
// vals and ptrs (B, L1+L2+1, L1+1) int32.  Launches on ``stream`` and
// returns cudaGetLastError() (0 on success).
extern "C" int dp_wavefront_launch(const int* reads, const int* genomes,
                                   int* vals, int* ptrs, int B, int L1,
                                   int L2, int match, int mismatch,
                                   int gap_open, int gap_extend,
                                   void* stream) {
  if (B <= 0) return 0;
  const dp::Scoring s{match, mismatch, gap_open, gap_extend};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int lanes = L1 + 1;
  int threads = ((lanes + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t carry = sizeof(int) * dp::kCarried * (size_t)lanes;
  if (lanes <= dp::kWarpRows) {
    const int blocks = (B + kWarpJobs - 1) / kWarpJobs;
    if (lanes <= 64) {
      dp_fill_warp_kernel<2><<<blocks, 32 * kWarpJobs, 0, st>>>(
          reads, genomes, vals, ptrs, B, L1, L2, s);
    } else {
      dp_fill_warp_kernel<4><<<blocks, 32 * kWarpJobs, 0, st>>>(
          reads, genomes, vals, ptrs, B, L1, L2, s);
    }
  } else if (carry <= (size_t)dp::kMaxShared) {
    if (carry > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          dp_fill_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)carry);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    dp_fill_block_kernel<<<B, threads, carry, st>>>(reads, genomes, vals, ptrs,
                                                    L1, L2, s);
  } else {
    dp_fill_readback_kernel<<<B, threads, 0, st>>>(reads, genomes, vals, ptrs,
                                                   L1, L2, s);
  }
  return static_cast<int>(cudaGetLastError());
}
