// The whole DP stitch of a batch of jobs as one launch: gather, fill,
// endpoint, backtrack and run-length encoding.
//
// Replaces bwt_tpu/models/batch_exec.py:_dp_core (Pallas branch: the
// gather, the K1 fill, the endpoint scan, the pointer walk and
// _rle_device, one jitted program there) and computes what the port's plain
// version, bwt_tpu_torch/ops/dp_wavefront.py:dp_stitch_plain, computes, bit
// for bit.  A job:
//   1. reads its eight fields and gathers its read slice from `bank` and its
//      genome slice from `genome` itself, with the plain version's clamps
//      (index clamped into the array, positions past rlen / glen read as 0,
//      either slice reversed);
//   2. sweeps the diagonals (dp_cell.cuh), only as far as i0 + jmax, i0 =
//      clamp(rlen, 0, L1) and jmax = min(glen, L2), and keeps only cells
//      with i <= i0 and 0 <= j <= jmax: a cell depends on cells above and
//      to the left of it alone, and neither the endpoint scan nor the walk
//      reads one outside that rectangle;
//   3. keeps each cell's pointer in 2 bits in shared memory (two bit planes
//      a diagonal made by warp ballots; a job too tall for a warp keeps a
//      byte a cell in device memory); values never leave the carried
//      diagonals;
//   4. finds the nw endpoint on the way: the thread that owns row i0 keeps
//      the first maximum (strict >) over columns 0..jmax;
//   5. that thread walks the pointers back from (i0, j0) while i > 0 and
//      j > 0, writes the op row (column s = diagonal D-1-s, 3 = no op) and
//      the run-length form: a run is a stretch of equal ops on neighbouring
//      diagonals (so every diagonal step starts one), the first `runs` are
//      kept, nrun = runs + 1 when the count or a kept run's length passes
//      32,000;
//   6. writes one packed row (maxloc, i_resid, j_resid, nrun, `runs` values,
//      `runs` counts) and the (D,) op row.  Nothing of size B x D x L1
//      exists.
//
// What bounds it on the H100: operations (19 a cell; the bytes are a few KB
// a job) and, in practice, the latency of the diagonal chain, which the
// sweeps keep on the SM.  The launcher picks by shape (dp_stitch_plan):
//   warp   L1 + 1 <= 128 and kWarpJobs jobs' pointers fit shared memory: a
//          warp a job, diagonals in registers, two stripes of rows (L1 + 1
//          <= 64) or four.  Every shape the aligner sends on short reads;
//   block  any other shape up to L1 = 11,621: a block a job, the carried
//          diagonals in shared memory, the pointers a byte a cell in device
//          memory (scratch from the caller);
//   tall   a taller job, whose carried diagonals do not fit a block's shared
//          memory: the block form with those diagonals in device scratch
//          too, read back after each diagonal's barrier (in L2 right after
//          they were written), as dp_wavefront.cu's read-back form reads
//          its own output.  The caller may lower the threshold (`tall_l1`)
//          to send a small job this way.

#include <cuda_runtime.h>
#include <stddef.h>

#include "dp_cell.cuh"

namespace {

constexpr int kWarpJobs = 4;        // jobs (warps) a block of the warp form
constexpr int kNeg = -(1 << 30);    // the plain version's mask value

struct Fields {
  const int* row;
  const int* roff;
  const int* rlen;
  const int* rrev;
  const int* gstart;
  const int* glen;
  const int* grev;
  const int* want_nw;
};

struct Tables {
  const int* bank;
  int R, Lb;
  const int* genome;
  int G;
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// int32 sums that wrap as the tensor code's do
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

struct Job {
  const int* read;  // the job's bank row
  const int* genome;
  int Lb, G, L1, L2;
  int roff, rlen, rrev, gstart, glen, grev, want_nw;
  int i0, jmax;

  __device__ int read_at(int k) const {
    if (k >= rlen || k >= L1) return 0;
    const int at = rrev == 1 ? wadd(wadd(roff, rlen), -1 - k) : wadd(roff, k);
    return __ldg(read + clampi(at, 0, Lb - 1));
  }
  __device__ int genome_at(int k) const {
    if (k >= glen || k >= L2) return 0;
    const int at =
        grev == 1 ? wadd(wadd(gstart, glen), -1 - k) : wadd(gstart, k);
    return __ldg(genome + clampi(at, 0, G - 1));
  }
};

__device__ __forceinline__ Job load_job(const Fields& f, const Tables& t,
                                        int b, int L1, int L2) {
  Job j;
  const int row = clampi(__ldg(f.row + b), 0, t.R - 1);
  j.read = t.bank + (size_t)row * t.Lb;
  j.genome = t.genome;
  j.Lb = t.Lb;
  j.G = t.G;
  j.L1 = L1;
  j.L2 = L2;
  j.roff = __ldg(f.roff + b);
  j.rlen = __ldg(f.rlen + b);
  j.rrev = __ldg(f.rrev + b);
  j.gstart = __ldg(f.gstart + b);
  j.glen = __ldg(f.glen + b);
  j.grev = __ldg(f.grev + b);
  j.want_nw = __ldg(f.want_nw + b);
  j.i0 = clampi(j.rlen, 0, L1);
  j.jmax = min(j.glen, L2);
  return j;
}

// The first maximum of row i0 over columns 0..jmax, as the plain version's
// first argmax over the masked row finds it.
struct Endpoint {
  int i0, jmax;
  int best = kNeg, dstar = 0;
  // v: the value of cell (i0, d - i0); only the row's thread keeps a result
  __device__ __forceinline__ void watch(int d, int v) {
    const bool better = (unsigned)(d - i0) <= (unsigned)jmax && v > best;
    best = better ? v : best;  // jmax >= 0 wherever a sweep runs
    dstar = better ? d : dstar;
  }
};

// The warp form keeps a diagonal's pointers as two bit planes a stripe: bit
// l of word 2 * (d * kStripes + k) is the low bit of the pointer of row
// 32 * k + l on diagonal d, of the next word the high bit.  A ballot makes
// each plane, lane 0 stores both, and no lane tests whether its cell lies in
// the job: the walk reads none that does not.
template <int kStripes>
struct WarpSink {
  uint2* planes;
  Endpoint end;
  __device__ __forceinline__ void put(int d, int, int k, int, int p) {
    uint2 w;
    w.x = __ballot_sync(dp::kFullMask, p & 1);
    w.y = __ballot_sync(dp::kFullMask, p & 2);
    if ((threadIdx.x & 31) == 0) planes[d * kStripes + k] = w;
  }
  __device__ __forceinline__ void diagonal(int d, const int (&v)[kStripes]) {
    int mine = v[0];
#pragma unroll
    for (int k = 1; k < kStripes; ++k) mine = (end.i0 >> 5) == k ? v[k] : mine;
    end.watch(d, mine);
  }
};

struct WarpPointers {
  const uint2* planes;
  int stripes;
  __device__ __forceinline__ int at(int i, int j) const {
    const uint2 w = planes[(i + j) * stripes + (i >> 5)];
    return ((w.x >> (i & 31)) & 1) | (((w.y >> (i & 31)) & 1) << 1);
  }
};

// The block form keeps them a byte a cell, (i, j) at i * width + j of the
// job's scratch in device memory.
struct BlockSink {
  unsigned char* cells;
  int width;  // L2 + 1
  Endpoint end;
  __device__ __forceinline__ void put(int d, int i, int, int v, int p) {
    // sweep_block hands over 0 <= d - i <= jmax only
    cells[(size_t)i * width + (d - i)] = (unsigned char)p;
    if (i == end.i0) end.watch(d, v);
  }
};

struct BlockPointers {
  const unsigned char* cells;
  int width;
  __device__ __forceinline__ int at(int i, int j) const {
    return cells[(size_t)i * width + j];
  }
};

// bytes of a job's pointers in the block forms, a byte a cell, rounded up to
// 16 so that the tall form's carried diagonals after them stay aligned
__host__ __device__ size_t cells_bytes(int L1, int L2) {
  return ((size_t)(L1 + 1) * (L2 + 1) + 15) & ~(size_t)15;
}

// One thread: the endpoint, the walk from (i0, j0), the op row, the runs.
// `packed` is the job's row (4 + 2 * runs ints, runs zeroed), `ops` its op
// row (D ints, all 3).
template <class Pointers>
__device__ __forceinline__ void finish(const Job& job, const Endpoint& end,
                                       const Pointers& ptr, int D, int runs,
                                       int* packed, int* ops) {
  const int maxloc = job.glen >= 0 ? end.dstar - job.i0 : 0;
  const int j0 = job.want_nw == 1 ? maxloc : clampi(job.glen, 0, job.L2);
  int* vals = packed + 4;
  int* counts = vals + runs;
  int i = job.i0, j = j0;
  int nrun = 0, run_op = -1, run_len = 0, longest = 0, last_d = -2;
  while (i > 0 && j > 0) {
    const int d = i + j;
    const int p = ptr.at(i, j);
    const int op = (p == 1 || p == 2) ? p : 0;
    ops[D - 1 - d] = op;
    if (last_d != d + 1 || op != run_op) {
      if (nrun >= 1 && nrun <= runs) {
        vals[nrun - 1] = run_op;
        counts[nrun - 1] = run_len;
        longest = max(longest, run_len);
      }
      ++nrun;
      run_op = op;
      run_len = 0;
    }
    ++run_len;
    last_d = d;
    i -= op != 2;
    j -= op != 1;
  }
  if (nrun >= 1 && nrun <= runs) {
    vals[nrun - 1] = run_op;
    counts[nrun - 1] = run_len;
    longest = max(longest, run_len);
  }
  packed[0] = maxloc;
  packed[1] = i;
  packed[2] = j;
  packed[3] = (nrun > 32000 || longest > 32000) ? runs + 1 : min(nrun, 32000);
}

struct Out {
  int* packed;  // (B, 4 + 2 * runs)
  int* ops;     // (B, D)
  int runs;
};

template <int kStripes>
__global__ void __launch_bounds__(32 * kWarpJobs)
dp_stitch_warp_kernel(Fields f, Tables t, int B, int L1, int L2,
                      dp::Scoring s, Out out) {
  extern __shared__ uint2 shared_planes[];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpJobs + (threadIdx.x >> 5);
  if (b >= B) return;  // a whole warp
  const int D = L1 + L2 + 1;
  const int width = 4 + 2 * out.runs;
  int* packed = out.packed + (size_t)b * width;
  int* ops = out.ops + (size_t)b * D;
  for (int k = lane; k < D; k += 32) ops[k] = 3;
  for (int k = 4 + lane; k < width; k += 32) packed[k] = 0;
  const Job job = load_job(f, t, b, L1, L2);
  uint2* planes = shared_planes + (size_t)(threadIdx.x >> 5) * D * kStripes;
  WarpSink<kStripes> sink{planes, Endpoint{job.i0, job.jmax}};
  if (job.jmax >= 0) {
    dp::sweep_warp<kStripes>(
        s, job.i0 + 1, job.i0 + job.jmax,
        [&](int k) { return job.read_at(k); },
        [&](int k) { return job.genome_at(k); }, sink);
  }
  __syncwarp();
  if (lane == (job.i0 & 31)) {
    finish(job, sink.end, WarpPointers{planes, kStripes}, D, out.runs, packed,
           ops);
  }
}

// kTall: the carried diagonals in the job's scratch, after its pointers
// (dp_stitch_plan's layout), else in shared memory.
template <bool kTall>
__global__ void __launch_bounds__(1024)
dp_stitch_block_kernel(Fields f, Tables t, int L1, int L2, dp::Scoring s,
                       Out out, unsigned char* scratch, size_t job_bytes) {
  extern __shared__ int shared_carry[];
  const int b = blockIdx.x;
  const int D = L1 + L2 + 1;
  const int rows = L1 + 1;
  const int width = 4 + 2 * out.runs;
  int* packed = out.packed + (size_t)b * width;
  int* ops = out.ops + (size_t)b * D;
  for (int k = threadIdx.x; k < D; k += blockDim.x) ops[k] = 3;
  for (int k = 4 + threadIdx.x; k < width; k += blockDim.x) packed[k] = 0;
  const Job job = load_job(f, t, b, L1, L2);
  unsigned char* cells = scratch + (size_t)b * job_bytes;
  int* carry = shared_carry;
  if constexpr (kTall) {
    carry = reinterpret_cast<int*>(cells + cells_bytes(L1, L2));
  }
  BlockSink sink{cells, L2 + 1, Endpoint{job.i0, job.jmax}};
  if (job.jmax >= 0) {  // the same for the whole block
    dp::sweep_block<false>(
        s, job.i0 + 1, job.i0 + job.jmax, job.jmax, carry, rows,
        [&](int k) { return job.read_at(k); },
        [&](int k) { return job.genome_at(k); }, sink);
  }
  __syncthreads();
  if (threadIdx.x == job.i0 % blockDim.x) {
    finish(job, sink.end, BlockPointers{cells, L2 + 1}, D, out.runs, packed,
           ops);
  }
}

int warp_stripes(int L1) { return L1 + 1 <= 64 ? 2 : 4; }

// bytes of a job's pointers in the warp form: two bit planes a stripe and
// diagonal
size_t warp_pointer_bytes(int L1, int L2) {
  return sizeof(uint2) * (size_t)(L1 + L2 + 1) * warp_stripes(L1);
}

size_t carry_bytes(int L1) {
  return sizeof(int) * dp::kCarried * (size_t)(L1 + 1);
}

}  // namespace

// The form the launcher takes at this shape (see the head of the file): 0
// the warp form, 1 the block form, 2 the tall form, taken past L1 =
// tall_l1 or where the block form's diagonals do not fit shared memory;
// and the bytes of device scratch it then needs from the caller for each
// job (0 in the warp form; the pointers, and in the tall form the carried
// diagonals after them).
extern "C" int dp_stitch_plan(int L1, int L2, int tall_l1,
                              long long* scratch_bytes) {
  *scratch_bytes = 0;
  if (L1 > tall_l1 || carry_bytes(L1) > (size_t)dp::kMaxShared) {
    *scratch_bytes = (long long)(cells_bytes(L1, L2) + carry_bytes(L1));
    return 2;
  }
  if (L1 + 1 <= dp::kWarpRows &&
      kWarpJobs * warp_pointer_bytes(L1, L2) <= (size_t)dp::kMaxShared) {
    return 0;
  }
  *scratch_bytes = (long long)cells_bytes(L1, L2);
  return 1;
}

// bank (R, Lb) and genome (G,) int32; the eight job fields (B,) int32 each;
// packed (B, 4 + 2 * runs) and ops (B, L1+L2+1) int32; scratch as
// dp_stitch_plan(L1, L2, tall_l1) asks (B times its size, 16-byte
// aligned), else null.  All contiguous, on the device.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int dp_stitch_launch(
    const int* bank, int R, int Lb, const int* genome, int G, const int* row,
    const int* roff, const int* rlen, const int* rrev, const int* gstart,
    const int* glen, const int* grev, const int* want_nw, int B, int L1,
    int L2, int match, int mismatch, int gap_open, int gap_extend, int runs,
    int tall_l1, int* packed, int* ops, unsigned char* scratch,
    void* stream) {
  if (B <= 0) return 0;
  if (R <= 0 || Lb <= 0 || G <= 0 || L1 < 0 || L2 < 0 || runs < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Fields f{row, roff, rlen, rrev, gstart, glen, grev, want_nw};
  const Tables t{bank, R, Lb, genome, G};
  const dp::Scoring s{match, mismatch, gap_open, gap_extend};
  const Out out{packed, ops, runs};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long job_bytes;
  const int form = dp_stitch_plan(L1, L2, tall_l1, &job_bytes);
  if (job_bytes != 0 && scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool two = warp_stripes(L1) == 2;
  const size_t smem = form == 0   ? kWarpJobs * warp_pointer_bytes(L1, L2)
                      : form == 1 ? carry_bytes(L1)
                                  : 0;
  const void* kernel =
      form == 2   ? reinterpret_cast<const void*>(dp_stitch_block_kernel<true>)
      : form == 1 ? reinterpret_cast<const void*>(dp_stitch_block_kernel<false>)
      : two       ? reinterpret_cast<const void*>(dp_stitch_warp_kernel<2>)
                  : reinterpret_cast<const void*>(dp_stitch_warp_kernel<4>);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (form == 0) {
    const int blocks = (B + kWarpJobs - 1) / kWarpJobs;
    if (two) {
      dp_stitch_warp_kernel<2><<<blocks, 32 * kWarpJobs, smem, st>>>(
          f, t, B, L1, L2, s, out);
    } else {
      dp_stitch_warp_kernel<4><<<blocks, 32 * kWarpJobs, smem, st>>>(
          f, t, B, L1, L2, s, out);
    }
  } else {
    int threads = ((L1 + 1 + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    if (form == 1) {
      dp_stitch_block_kernel<false><<<B, threads, smem, st>>>(
          f, t, L1, L2, s, out, scratch, (size_t)job_bytes);
    } else {
      dp_stitch_block_kernel<true><<<B, threads, 0, st>>>(
          f, t, L1, L2, s, out, scratch, (size_t)job_bytes);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
