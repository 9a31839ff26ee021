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
//   warp   L1 <= 128 and kWarpJobs jobs' pointers fit shared memory: a warp
//          a job, diagonals in registers, rows 1..L1 in one stripe of 32
//          lanes (L1 <= 32), two or four (row 0 is borders, which no walk
//          reads).  Every shape the aligner sends on short reads;
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
// lane + strand; its fields come in one round of loads after (lane, slot).
// The walking thread writes no op row: it builds the job's block as
// _dp_blocks_core does, the kept runs in shared memory as the walk closes
// them, then the warp stores each entry of runs_oc[lane, slot, 0 : runs +
// 2] once, side by side on its lanes, (op + 2) << 24 | count: the kept runs
// in walk order (zero runs up to the reported count), the I and D
// residuals, padding 1 << 24, the first bl entries reversed for an NW or
// head stitch (the Cigar flip).  Nothing written to device memory is read
// back.  The walking thread sets bl3[lane, slot] = bl, adds maxloc - 1 to
// head_end[lane] for a head stitch and raises over[lane] where the job has
// more runs than `runs`.  Bounded as the row form.

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

// The warp form sweeps rows 1..i0 (dp::sweep_warp with kFromRow1: row 0 is
// all border and no walk reads it) and keeps a diagonal's pointers as two bit
// planes a stripe: bit l of word 2 * (d * kStripes + k) is the low bit of the
// pointer of row 32 * k + l + 1 on diagonal d, of the next word the high
// bit.  A ballot makes each plane, lane 0 stores both, and no lane tests
// whether its cell lies in the job: the walk reads none that does not.
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
  // the lane of row i0 (i0 >= 1) keeps the end row's first maximum
  __device__ __forceinline__ void diagonal(int d, const int (&v)[kStripes]) {
    int mine = v[0];
#pragma unroll
    for (int k = 1; k < kStripes; ++k) {
      mine = ((end.i0 - 1) >> 5) == k ? v[k] : mine;
    }
    end.watch(d, mine);
  }
};

struct WarpPointers {
  const uint2* planes;
  int stripes;
  __device__ __forceinline__ int at(int i, int j) const {
    const int r = i - 1;
    const uint2 w = planes[(i + j) * stripes + (r >> 5)];
    return ((w.x >> (r & 31)) & 1) | (((w.y >> (r & 31)) & 1) << 1);
  }
};

// The end row when it is row 0 (rlen 0), which the warp form does not
// sweep: its border cells in order.
__device__ __forceinline__ void row0_end(const dp::Scoring& s, Endpoint& end) {
  end.watch(0, 0);
  for (int j = 1; j <= end.jmax; ++j) {
    int v, p;
    dp::cell(s, j, 0, 0, 0, 0, 0, 0, 0, 0, v, p);
    end.watch(j, v);
  }
}

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

  static constexpr bool kBuffered = false;  // writes its runs as they close
  struct Ids {
    int b;
  };
  __device__ __forceinline__ Ids ids(int b) const { return Ids{b}; }
  __device__ __forceinline__ Job job(const Ids& id, int L1, int L2) const {
    const int b = id.b;
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
  __device__ __forceinline__ Sink sink(const Ids& id, int D, int*, int) const {
    return Sink{packed + (size_t)id.b * (4 + 2 * runs),
                ops + (size_t)id.b * D, runs};
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

  static constexpr bool kBuffered = true;  // its runs wait in shared memory

  // the log column c of slot e = lane * 16 + slot
  __device__ __forceinline__ int at(int c, size_t e) const {
    return __ldg(log + alog::log_col(c, Bp) + e);
  }

  // A walk leaves its block in shared memory: the kept runs at buf[t *
  // stride], t < runs, then kMeta ints: kept, the block's reported runs nr,
  // the residuals i and j, the slot e (-1: no job) and the flip.  store()
  // then writes the block's entries, each once, in their final places.
  static constexpr int kMeta = 6;
  static __host__ __device__ int buffer_ints(int runs) {
    return runs + kMeta;
  }

  struct Sink {
    int* buf;  // shared memory
    int stride;
    int* bl3;
    int* head_end;
    int* over;
    int runs;
    int e;
    bool flip, head;
    __device__ __forceinline__ void step(int, int) const {}
    __device__ __forceinline__ void run(int t, int op, int len) const {
      buf[t * stride] = ((op + 2) << 24) | len;
    }
    __device__ __forceinline__ void done(int maxloc, int i, int j, int nrun,
                                         int kept) const {
      const int nr = min(nrun, runs);
      int* m = buf + runs * stride;
      m[0] = kept;
      m[stride] = nr;
      m[2 * stride] = i;
      m[3 * stride] = j;
      m[4 * stride] = e;
      m[5 * stride] = flip ? 1 : 0;
      *bl3 = nr + (i > 0) + (j > 0);
      if (head) atomicAdd(head_end, maxloc - 1);
      if (nrun > runs) atomicMax(over, 1);
    }
  };

  // Entries first, first + step, ... of the block a walk left at buf: the
  // kept runs in walk order (zero runs up to the reported count), the I and
  // D residuals, padding 1 << 24, the first bl reversed for a flip (the
  // Cigar flip).  The lanes of a warp store a block's entries side by side.
  __device__ __forceinline__ void store(const int* buf, int stride, int first,
                                        int step) const {
    const int* m = buf + runs * stride;
    const int e = m[4 * stride];
    if (e < 0) return;
    const int kept = m[0], nr = m[stride], i = m[2 * stride];
    const int j = m[3 * stride];
    const bool flip = m[5 * stride] != 0;
    const int bl = nr + (i > 0) + (j > 0);
    int* block = acc + (size_t)e * (runs + 2);
    for (int t = first; t < runs + 2; t += step) {
      const int u = flip ? bl - 1 - t : t;  // the entry in walk order
      block[t] = t >= bl               ? 1 << 24
                 : u < kept            ? buf[u * stride]
                 : u < nr              ? 2 << 24
                 : (u == nr && i > 0)  ? (3 << 24) | i
                                       : (4 << 24) | j;
    }
  }

  // (lane, slot) and the kind, then every field in one round of loads
  struct Ids {
    int lane;
    size_t e;
    int kind;
  };
  __device__ __forceinline__ Ids ids(int b) const {
    const int lane = __ldg(jk + b);
    const size_t e = (size_t)lane * alog::kLogN + __ldg(jt + b);
    return Ids{lane, e, at(alog::kKinds, e)};
  }
  __device__ __forceinline__ Job job(const Ids& id, int L1, int L2) const {
    const int head = id.kind == alog::kHead ? 1 : 0;
    const int strand = __ldg(log + alog::col(alog::kStrand, Bp) + id.lane);
    return make_job(t, L1, L2, 2 * id.lane + strand, at(alog::kRoffs, id.e),
                    at(alog::kRlens, id.e), head, at(alog::kGstarts, id.e),
                    at(alog::kGlens, id.e), head,
                    id.kind == alog::kSw ? 0 : 1);
  }
  __device__ __forceinline__ void prefill(int, int, int, int) const {}
  __device__ __forceinline__ Sink sink(const Ids& id, int, int* buf,
                                       int stride) const {
    const int W = runs + 2;
    return Sink{buf, stride, acc + alog::acc_bl3(Bp, W) + id.e,
                acc + alog::acc_head_end(Bp, W) + id.lane,
                acc + alog::acc_over(Bp, W) + id.lane, runs, (int)id.e,
                id.kind != alog::kSw, id.kind == alog::kHead};
  }
};

// the shared memory a form's walking thread keeps its block in, in ints
template <class Form>
__host__ __device__ int buffer_ints(int runs) {
  if constexpr (Form::kBuffered) {
    return Form::buffer_ints(runs);
  } else {
    return 0;
  }
}

template <int kStripes, class Form>
__global__ void __launch_bounds__(32 * kWarpJobs)
dp_stitch_warp_kernel(Form form, int B, int L1, int L2, dp::Scoring s) {
  extern __shared__ uint2 shared_planes[];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpJobs + (threadIdx.x >> 5);
  if (b >= B) return;  // a whole warp
  const int D = L1 + L2 + 1;
  form.prefill(b, D, lane, 32);
  const auto id = form.ids(b);
  const Job job = form.job(id, L1, L2);
  const int warp = threadIdx.x >> 5;
  uint2* planes = shared_planes + (size_t)warp * D * kStripes;
  int* buf = reinterpret_cast<int*>(shared_planes +
                                    (size_t)kWarpJobs * D * kStripes) +
             warp * buffer_ints<Form>(form.runs);
  WarpSink<kStripes> sink{planes, Endpoint{job.i0, job.jmax}};
  if (job.jmax >= 0 && job.i0 >= 1) {  // the same for the whole warp
    dp::sweep_warp<kStripes, true>(
        s, job.i0 + 1, job.i0 + job.jmax,
        [&](int k) { return job.read_at(k); },
        [&](int k) { return job.genome_at(k); }, sink);
  }
  __syncwarp();
  if (lane == ((job.i0 + 31) & 31)) {  // row i0's lane; lane 31 for row 0
    if (job.i0 == 0 && job.jmax >= 0) row0_end(s, sink.end);
    finish(job, sink.end, WarpPointers{planes, kStripes}, D, form.runs,
           form.sink(id, D, buf, 1));
  }
  if constexpr (Form::kBuffered) {  // the whole warp stores the block
    __syncwarp();
    form.store(buf, 1, lane, 32);
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
  const auto id = form.ids(b);
  const Job job = form.job(id, L1, L2);
  unsigned char* cells = scratch + (size_t)b * job_bytes;
  int* carry = shared_carry;
  int* buf = shared_carry;
  if constexpr (kTall) {
    carry = reinterpret_cast<int*>(cells + cells_bytes(L1, L2));
  } else {
    buf += dp::kCarried * rows;
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
           form.sink(id, D, buf, 1));
    if constexpr (Form::kBuffered) form.store(buf, 1, 0, 1);
  }
}

// stripes of 32 rows for rows 1..L1
int warp_stripes(int L1) { return L1 <= 32 ? 1 : L1 <= 64 ? 2 : 4; }

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
// diagonals after them).  log_runs: the log form's runs, whose blocks wait
// in shared memory, or -1 for the row form.
extern "C" int dp_stitch_plan(int L1, int L2, int tall_l1, int log_runs,
                              long long* scratch_bytes) {
  *scratch_bytes = 0;
  const int buf_ints = log_runs < 0 ? 0 : LogForm::buffer_ints(log_runs);
  const size_t buf = sizeof(int) * (size_t)buf_ints;
  if (L1 > tall_l1 || carry_bytes(L1) + buf > (size_t)dp::kMaxShared) {
    *scratch_bytes = (long long)(cells_bytes(L1, L2) + carry_bytes(L1));
    return 2;
  }
  if (L1 <= dp::kWarpRows &&
      kWarpJobs * (warp_pointer_bytes(L1, L2) + buf) <=
          (size_t)dp::kMaxShared) {
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
  const int plan = dp_stitch_plan(
      L1, L2, tall_l1, Form::kBuffered ? form.runs : -1, &job_bytes);
  if (job_bytes != 0 && scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t buf = sizeof(int) * (size_t)buffer_ints<Form>(form.runs);
  const int stripes = warp_stripes(L1);
  const size_t smem =
      plan == 0   ? kWarpJobs * (warp_pointer_bytes(L1, L2) + buf)
      : plan == 1 ? carry_bytes(L1) + buf
                  : buf;
  const void* kernel =
      plan == 2 ? reinterpret_cast<const void*>(
                      dp_stitch_block_kernel<true, Form>)
      : plan == 1
          ? reinterpret_cast<const void*>(dp_stitch_block_kernel<false, Form>)
      : stripes == 1
          ? reinterpret_cast<const void*>(dp_stitch_warp_kernel<1, Form>)
      : stripes == 2
          ? reinterpret_cast<const void*>(dp_stitch_warp_kernel<2, Form>)
          : reinterpret_cast<const void*>(dp_stitch_warp_kernel<4, Form>);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (plan == 0) {
    const int blocks = (B + kWarpJobs - 1) / kWarpJobs;
    if (stripes == 1) {
      dp_stitch_warp_kernel<1, Form><<<blocks, 32 * kWarpJobs, smem, st>>>(
          form, B, L1, L2, s);
    } else if (stripes == 2) {
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
      dp_stitch_block_kernel<true, Form><<<B, threads, smem, st>>>(
          form, L1, L2, s, scratch, (size_t)job_bytes);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bank (R, Lb) and genome (G,) int32; the eight job fields (B,) int32 each;
// packed (B, 4 + 2 * runs) and ops (B, L1+L2+1) int32; scratch as
// dp_stitch_plan(L1, L2, tall_l1, -1) asks (B times its size, 16-byte
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
// dp_stitch_plan(L1, L2, tall_l1, runs) asks (J times its size), else null.
// All contiguous, on the device.  Launches on `stream` and returns
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
