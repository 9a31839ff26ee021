// Anti-diagonal NW/SW DP fill for a batch of (read, genome) jobs.
//
// Replaces the Pallas TPU kernel bwt_tpu/ops/pallas_align.py:_kernel
// (called through dp_fill_wavefront) and computes exactly what it
// computes, in the batch-major layout (B, D, L1+1) with D = L1+L2+1:
// [b, d, i] is DP cell (i, d-i).  Cells with d-i outside 0..L2 are
// filled by the same recurrence (with genome code 0 there) and never
// read by a backtrack; they are kept so the output is bit-equal.
//
// Scoring (smw.c:26-200): match / mismatch by (read == 5 || read ==
// genome); a gap costs gap_extend, plus gap_open unless the
// neighbour's pointer already continues it (left: ptr 2, up: ptr 1).
// Ties go left (2), then up (1), then diagonal (0).  Row 0 and column 0
// hold gap_open + gap_extend*d with pointers 2 and 1; diagonal 0 is all
// zero.  Scoring arrives as kernel arguments.
//
// What bounds it on the H100: each job stores 8*D*(L1+1) bytes (value
// and pointer, int32 each) and runs one block-wide barrier per
// diagonal.  The design answers that simply: one thread block per job,
// threads stride over the rows i = 0..L1 so neighbouring threads store
// to neighbouring addresses, and a cell reads diagonals d-1 and d-2
// back from the output arrays (L2-resident right after they were
// written), so any L1 runs with no shared-memory limit.  Narrower
// pointers, several jobs per block and a fused backtrack are left for
// later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

__global__ void dp_wavefront_kernel(const int* __restrict__ reads,
                                    const int* __restrict__ genomes,
                                    int* __restrict__ vals,
                                    int* __restrict__ ptrs,
                                    int L1, int L2, int match, int mismatch,
                                    int gap_open, int gap_extend) {
  const int lanes = L1 + 1;
  const int D = L1 + L2 + 1;
  const size_t job = blockIdx.x;
  const int* read = reads + job * L1;
  const int* genome = genomes + job * L2;
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
    const int* v2 = d >= 2 ? V + (size_t)(d - 2) * lanes : nullptr;
    int* vo = V + (size_t)d * lanes;
    int* po = P + (size_t)d * lanes;
    const int border = gap_open + gap_extend * d;
    for (int i = threadIdx.x; i < lanes; i += blockDim.x) {
      int v, p;
      if (i == 0) {
        v = border;
        p = 2;
      } else if (i == d) {
        v = border;
        p = 1;
      } else {
        const int rc = read[i - 1];
        const int j = d - i;
        const int gc = (j >= 1 && j <= L2) ? genome[j - 1] : 0;
        const int diag = v2 != nullptr ? v2[i - 1] : 0;
        const int sdiag = diag + ((rc == 5 || rc == gc) ? match : mismatch);
        const int sleft = v1[i] + gap_extend + (p1[i] == 2 ? 0 : gap_open);
        const int sup = v1[i - 1] + gap_extend + (p1[i - 1] == 1 ? 0 : gap_open);
        v = max(max(sdiag, sleft), sup);
        p = v == sleft ? 2 : (v == sup ? 1 : 0);
      }
      vo[i] = v;
      po[i] = p;
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
  int threads = ((L1 + 1 + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  dp_wavefront_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      reads, genomes, vals, ptrs, L1, L2, match, mismatch, gap_open,
      gap_extend);
  return static_cast<int>(cudaGetLastError());
}
