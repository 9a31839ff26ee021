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
//
// K11a, the log form (a template argument, `LogForm`, over the same sweeps
// and walk): the stitches of one DP shape bucket of the aligner's phase B.
// Replaces bwt_tpu/models/aligner.py:_dp_scatter_bucket (the gather from the
// device log, _dp_core, _dp_blocks_core and the scatters, one jitted program
// there); the port's plain version is bwt_tpu_torch/ops/dp_wavefront.py:
// dp_log_stitch_plain.  Job b is slot jt[b] of lane jk[b] of the automaton's
// packed output (align_automaton.cu): its kind picks a head stitch (both
// slices reversed, nw endpoint), an SW gap fill or an NW tail, its row is 2
// lane + strand.  The walking thread writes no op row: it builds the job's
// block as _dp_blocks_core does, straight into the chunk-wide accumulator
// runs_oc[lane, slot, 0 : runs + 2], each entry (op + 2) << 24 | count: the
// kept runs in walk order (zero runs up to the reported count), the I and D
// residuals, padding 1 << 24, then, for an NW or head stitch, the first bl
// entries reversed in place (the Cigar flip).  It sets bl3[lane, slot] =
// bl, adds maxloc - 1 to head_end[lane] for a head stitch and raises
// over[lane] where the job has more runs than `runs`.  Bounded as the row
// form.

#include <cuda_runtime.h>
#include <stddef.h>

#include "align_log.cuh"
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

__device__ __forceinline__ Job make_job(const Tables& t, int L1, int L2,
                                        int row, int roff, int rlen, int rrev,
                                        int gstart, int glen, int grev,
                                        int want_nw) {
  Job j;
  j.read = t.bank + (size_t)clampi(row, 0, t.R - 1) * t.Lb;
  j.genome = t.genome;
  j.Lb = t.Lb;
  j.G = t.G;
  j.L1 = L1;
  j.L2 = L2;
  j.roff = roff;
  j.rlen = rlen;
  j.rrev = rrev;
  j.gstart = gstart;
  j.glen = glen;
  j.grev = grev;
  j.want_nw = want_nw;
  j.i0 = clampi(rlen, 0, L1);
  j.jmax = min(glen, L2);
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

// One thread: the endpoint and the walk from (i0, j0).  `out` takes each
// step's op (column s = diagonal D-1-s) and the first `runs` runs as they
// close, then the end cell, the residuals, the reported run count (runs + 1
// when the count or a kept run's length passes 32,000) and the runs kept.
template <class Pointers, class Sink>
__device__ __forceinline__ void finish(const Job& job, const Endpoint& end,
                                       const Pointers& ptr, int D, int runs,
                                       const Sink& out) {
  const int maxloc = job.glen >= 0 ? end.dstar - job.i0 : 0;
  const int j0 = job.want_nw == 1 ? maxloc : clampi(job.glen, 0, job.L2);
  int i = job.i0, j = j0;
  int nrun = 0, run_op = -1, run_len = 0, longest = 0, last_d = -2;
  while (i > 0 && j > 0) {
    const int d = i + j;
    const int p = ptr.at(i, j);
    const int op = (p == 1 || p == 2) ? p : 0;
    out.step(D - 1 - d, op);
    if (last_d != d + 1 || op != run_op) {
      if (nrun >= 1 && nrun <= runs) {
        out.run(nrun - 1, run_op, run_len);
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
    out.run(nrun - 1, run_op, run_len);
    longest = max(longest, run_len);
  }
  out.done(maxloc, i, j,
           (nrun > 32000 || longest > 32000) ? runs + 1 : min(nrun, 32000),
           min(nrun, runs));
}

// The executor's stitch: the jobs' eight fields in, a packed row (maxloc,
// i_resid, j_resid, nrun, `runs` values, `runs` counts) and the (D,) op row
// of each job out.
struct RowForm {
  Fields f;
  Tables t;
  int* packed;  // (B, 4 + 2 * runs)
  int* ops;     // (B, D)
  int runs;

  struct Sink {
    int* packed;
    int* ops;
    int runs;
    __device__ __forceinline__ void step(int s, int op) const { ops[s] = op; }
    __device__ __forceinline__ void run(int t, int op, int len) const {
      packed[4 + t] = op;
      packed[4 + runs + t] = len;
    }
    __device__ __forceinline__ void done(int maxloc, int i, int j, int nrun,
                                         int) const {
      packed[0] = maxloc;
      packed[1] = i;
      packed[2] = j;
      packed[3] = nrun;
    }
  };

  __device__ __forceinline__ Job job(int b, int L1, int L2) const {
    return make_job(t, L1, L2, __ldg(f.row + b), __ldg(f.roff + b),
                    __ldg(f.rlen + b), __ldg(f.rrev + b), __ldg(f.gstart + b),
                    __ldg(f.glen + b), __ldg(f.grev + b),
                    __ldg(f.want_nw + b));
  }
  // all 3 in the op row, zeros after the four scalars of the packed row
  __device__ __forceinline__ void prefill(int b, int D, int tid,
                                          int nthreads) const {
    int* o = ops + (size_t)b * D;
    for (int k = tid; k < D; k += nthreads) o[k] = 3;
    int* p = packed + (size_t)b * (4 + 2 * runs);
    for (int k = 4 + tid; k < 4 + 2 * runs; k += nthreads) p[k] = 0;
  }
  __device__ __forceinline__ Sink sink(int b, int D) const {
    return Sink{packed + (size_t)b * (4 + 2 * runs), ops + (size_t)b * D,
                runs};
  }
};

// K11a: the jobs named by (lane, slot) of the automaton's log in, their
// blocks scattered into the chunk's accumulators out (see the head of the
// file; the layouts are align_log.cuh's, a block runs + 2 entries).
struct LogForm {
  const int* log;  // the automaton's packed output over Bp lanes
  int Bp;
  Tables t;
  const int* jk;
  const int* jt;
  int* acc;
  int runs;

  // the log column c of slot e = lane * 16 + slot
  __device__ __forceinline__ int at(int c, size_t e) const {
    return __ldg(log + alog::log_col(c, Bp) + e);
  }

  struct Sink {
    int* block;  // runs_oc[lane, slot]
    int* bl3;
    int* head_end;
    int* over;
    int runs;
    bool flip, head;
    __device__ __forceinline__ void step(int, int) const {}
    __device__ __forceinline__ void run(int t, int op, int len) const {
      block[t] = ((op + 2) << 24) | len;
    }
    __device__ __forceinline__ void done(int maxloc, int i, int j, int nrun,
                                         int kept) const {
      const int nr = min(nrun, runs);
      for (int t = kept; t < nr; ++t) block[t] = 2 << 24;
      int bl = nr;
      if (i > 0) block[bl++] = (3 << 24) | i;
      if (j > 0) block[bl++] = (4 << 24) | j;
      for (int t = bl; t < runs + 2; ++t) block[t] = 1 << 24;
      if (flip) {
        for (int a = 0, z = bl - 1; a < z; ++a, --z) {
          const int x = block[a];
          block[a] = block[z];
          block[z] = x;
        }
      }
      *bl3 = bl;
      if (head) atomicAdd(head_end, maxloc - 1);
      if (nrun > runs) atomicMax(over, 1);
    }
  };

  __device__ __forceinline__ Job job(int b, int L1, int L2) const {
    const int lane = __ldg(jk + b);
    const size_t e = (size_t)lane * alog::kLogN + __ldg(jt + b);
    const int kind = at(alog::kKinds, e);
    const int head = kind == alog::kHead ? 1 : 0;
    const int strand = __ldg(log + alog::col(alog::kStrand, Bp) + lane);
    return make_job(t, L1, L2, 2 * lane + strand, at(alog::kRoffs, e),
                    at(alog::kRlens, e), head, at(alog::kGstarts, e),
                    at(alog::kGlens, e), head, kind == alog::kSw ? 0 : 1);
  }
  __device__ __forceinline__ void prefill(int, int, int, int) const {}
  __device__ __forceinline__ Sink sink(int b, int) const {
    const int lane = __ldg(jk + b);
    const size_t e = (size_t)lane * alog::kLogN + __ldg(jt + b);
    const int kind = at(alog::kKinds, e);
    const int W = runs + 2;
    return Sink{acc + e * W, acc + alog::acc_bl3(Bp, W) + e,
                acc + alog::acc_head_end(Bp, W) + lane,
                acc + alog::acc_over(Bp, W) + lane, runs, kind != alog::kSw,
                kind == alog::kHead};
  }
};

template <int kStripes, class Form>
__global__ void __launch_bounds__(32 * kWarpJobs)
dp_stitch_warp_kernel(Form form, int B, int L1, int L2, dp::Scoring s) {
  extern __shared__ uint2 shared_planes[];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpJobs + (threadIdx.x >> 5);
  if (b >= B) return;  // a whole warp
  const int D = L1 + L2 + 1;
  form.prefill(b, D, lane, 32);
  const Job job = form.job(b, L1, L2);
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
    finish(job, sink.end, WarpPointers{planes, kStripes}, D, form.runs,
           form.sink(b, D));
  }
}

// kTall: the carried diagonals in the job's scratch, after its pointers
// (dp_stitch_plan's layout), else in shared memory.
template <bool kTall, class Form>
__global__ void __launch_bounds__(1024)
dp_stitch_block_kernel(Form form, int L1, int L2, dp::Scoring s,
                       unsigned char* scratch, size_t job_bytes) {
  extern __shared__ int shared_carry[];
  const int b = blockIdx.x;
  const int D = L1 + L2 + 1;
  const int rows = L1 + 1;
  form.prefill(b, D, threadIdx.x, blockDim.x);
  const Job job = form.job(b, L1, L2);
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
    finish(job, sink.end, BlockPointers{cells, L2 + 1}, D, form.runs,
           form.sink(b, D));
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

namespace {

// One launch of either form at this shape: the plan's kernel, its shared
// memory, its grid.
template <class Form>
int launch(const Form& form, int B, int L1, int L2, dp::Scoring s,
           int tall_l1, unsigned char* scratch, cudaStream_t st) {
  long long job_bytes;
  const int plan = dp_stitch_plan(L1, L2, tall_l1, &job_bytes);
  if (job_bytes != 0 && scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool two = warp_stripes(L1) == 2;
  const size_t smem = plan == 0   ? kWarpJobs * warp_pointer_bytes(L1, L2)
                      : plan == 1 ? carry_bytes(L1)
                                  : 0;
  const void* kernel =
      plan == 2 ? reinterpret_cast<const void*>(
                      dp_stitch_block_kernel<true, Form>)
      : plan == 1
          ? reinterpret_cast<const void*>(dp_stitch_block_kernel<false, Form>)
      : two ? reinterpret_cast<const void*>(dp_stitch_warp_kernel<2, Form>)
            : reinterpret_cast<const void*>(dp_stitch_warp_kernel<4, Form>);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (plan == 0) {
    const int blocks = (B + kWarpJobs - 1) / kWarpJobs;
    if (two) {
      dp_stitch_warp_kernel<2, Form><<<blocks, 32 * kWarpJobs, smem, st>>>(
          form, B, L1, L2, s);
    } else {
      dp_stitch_warp_kernel<4, Form><<<blocks, 32 * kWarpJobs, smem, st>>>(
          form, B, L1, L2, s);
    }
  } else {
    int threads = ((L1 + 1 + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    if (plan == 1) {
      dp_stitch_block_kernel<false, Form><<<B, threads, smem, st>>>(
          form, L1, L2, s, scratch, (size_t)job_bytes);
    } else {
      dp_stitch_block_kernel<true, Form><<<B, threads, 0, st>>>(
          form, L1, L2, s, scratch, (size_t)job_bytes);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

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
  const RowForm form{Fields{row, roff, rlen, rrev, gstart, glen, grev,
                            want_nw},
                     Tables{bank, R, Lb, genome, G}, packed, ops, runs};
  return launch(form, B, L1, L2,
                dp::Scoring{match, mismatch, gap_open, gap_extend}, tall_l1,
                scratch, static_cast<cudaStream_t>(stream));
}

// K11a.  log: the aligner automaton's packed output over Bp lanes; bank
// (2 Bp, Lb) and genome (G,) int32; jk, jt (J,) int32, the jobs' lanes and
// slots, each a valid job of the log; acc the chunk's accumulators (both
// layouts align_log.cuh's, a block runs + 2 entries); scratch as
// dp_stitch_plan(L1, L2, tall_l1) asks (J times its size), else null.  All
// contiguous, on the device.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int dp_log_stitch_launch(
    const int* log, int Bp, const int* bank, int Lb, const int* genome, int G,
    const int* jk, const int* jt, int J, int L1, int L2, int match,
    int mismatch, int gap_open, int gap_extend, int runs, int tall_l1,
    int* acc, unsigned char* scratch, void* stream) {
  if (J <= 0) return 0;
  if (Bp <= 0 || Lb <= 0 || G <= 0 || L1 < 0 || L2 < 0 || runs < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const LogForm form{log, Bp, Tables{bank, 2 * Bp, Lb, genome, G}, jk, jt,
                     acc, runs};
  return launch(form, J, L1, L2,
                dp::Scoring{match, mismatch, gap_open, gap_extend}, tall_l1,
                scratch, static_cast<cudaStream_t>(stream));
}
