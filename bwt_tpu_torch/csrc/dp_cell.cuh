// The affine-gap DP recurrence and its two anti-diagonal sweeps: the one body
// under the standalone fill (dp_wavefront.cu) and the fused stitch
// (dp_stitch.cu).
//
// Replaces the body of the Pallas TPU kernel
// bwt_tpu/ops/pallas_align.py:_kernel (reached through dp_fill_wavefront),
// which keeps three diagonals and a systolic genome register in VMEM with
// 128 jobs on the lanes.  Here a job is a warp (or a block), and diagonal d
// holds cell (i, d - i) for every row i.
//
// Scoring (smw.c:26-200): match / mismatch by (read == 5 || read ==
// genome); a gap costs gap_extend, plus gap_open unless the neighbour's
// pointer already continues it (left: pointer 2, up: pointer 1).  Ties go
// left (2), then up (1), then diagonal (0).  Row 0 and column 0 hold
// gap_open + gap_extend * d with pointers 2 and 1; diagonal 0 is all zero.
// Cells with d - i outside 0..L2 follow the same recurrence with genome
// code 0; nothing inside the matrix depends on them.
//
// What bounds a sweep on the H100 is not arithmetic (19 operations a cell)
// but the chain from one diagonal to the next: every cell needs its left,
// upper and upper-left neighbours of the two diagonals before.  Read back
// from device memory that chain costs a round trip to L2 and a block-wide
// barrier a diagonal.  The sweeps keep it on the SM:
//
//   sweep_warp   a job of up to 128 rows is one warp.  Lane l owns rows l,
//                l + 32, l + 64, l + 96 (as many stripes as the shape has,
//                a template argument; for the stitch, which reads no cell
//                of row 0, rows l + 1, l + 33, ...) and keeps v(d-1), p(d-1)
//                and the upper-left value of each in registers; the row
//                above comes by a rotating shuffle (lane 0 of a stripe takes
//                lane 31 of the stripe below it); the genome character moves
//                down the rows systolically by one more shuffle, fed at the
//                top row from a 32-character chunk the lanes load together.
//                No barrier, no shared memory, no device-memory read in the
//                loop, and several jobs share a block.
//   sweep_block  a taller job is one block: rows strided over the threads,
//                the carried diagonals (three of values, two of pointers,
//                so that one barrier a diagonal suffices) in shared memory.
//
// Both hand every cell to a sink as put(d, i, slot, v, p): the fill stores
// it, the stitch packs the pointer and watches the end row.  sweep_warp
// calls put from all 32 lanes of every stripe, the rows past the job's last
// included (a sink drops them without a branch, or the stripes' chains
// would again run one after the other), and after each diagonal
// diagonal(d, v) with the lane's values of that diagonal, one a stripe.
// With kOutside false sweep_block computes only cells with 0 <= d - i <=
// jmax.

#pragma once

#include <cuda_runtime.h>

namespace dp {

struct Scoring {
  int match, mismatch, gap_open, gap_extend;
};

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxStripes = 4;  // of 32 rows: the most a warp's job has
constexpr int kWarpRows = 32 * kMaxStripes;
constexpr int kCarried = 5;     // diagonals sweep_block carries
constexpr int kMaxShared = 232448;  // bytes a block may have on sm_90

// Cell (i, d - i) of diagonal d >= 1.  rc: read code of row i; gc: genome
// code of column d - i (0 outside 1..L2); vdiag: v(d-2)[i-1]; vleft, pleft:
// v, p(d-1)[i]; vup, pup: v, p(d-1)[i-1].  The borders ignore all five.
__device__ __forceinline__ void cell(const Scoring& s, int d, int i, int rc,
                                     int gc, int vdiag, int vleft, int pleft,
                                     int vup, int pup, int& v, int& p) {
  const int sdiag = vdiag + ((rc == 5 || rc == gc) ? s.match : s.mismatch);
  const int sleft = vleft + s.gap_extend + (pleft == 2 ? 0 : s.gap_open);
  const int sup = vup + s.gap_extend + (pup == 1 ? 0 : s.gap_open);
  const int best = max(max(sdiag, sleft), sup);
  const bool border = i == 0 || i == d;
  v = border ? s.gap_open + s.gap_extend * d : best;
  p = border ? (i == 0 ? 2 : 1) : (best == sleft ? 2 : (best == sup ? 1 : 0));
}

// One warp sweeps diagonals 0..dlast of a job of `rows` <= 32 * kStripes
// rows (kFromRow1: rows - 1 <= 32 * kStripes).  read_at(k): the read's code
// at 0 <= k < rows - 1; genome_at(k): the genome's code at k >= 0, 0 past
// its end.  All 32 lanes must call it.  Lane l of stripe k holds row 32 k +
// l, or with kFromRow1 row 32 k + l + 1: row 0 is all border, so the stitch,
// which reads no row-0 cell, keeps it in two registers (made by cell() a
// diagonal behind) and spends no stripe on it.  The stripe count is a
// template argument and no stripe is skipped: the stripes of a step are
// independent chains, and only without a branch between them does the
// compiler interleave them.
template <int kStripes, bool kFromRow1 = false, class ReadAt,
          class GenomeAt, class Sink>
__device__ __forceinline__ void sweep_warp(const Scoring& s, int rows,
                                           int dlast, ReadAt read_at,
                                           GenomeAt genome_at, Sink& sink) {
  constexpr int kBase = kFromRow1 ? 1 : 0;  // the row of lane 0, stripe 0
  const int lane = threadIdx.x & 31;
  int v1[kStripes], p1[kStripes], vd[kStripes], gc[kStripes], rc[kStripes];
#pragma unroll
  for (int k = 0; k < kStripes; ++k) {
    const int i = 32 * k + lane + kBase;
    v1[k] = p1[k] = vd[k] = gc[k] = 0;
    rc[k] = (i >= 1 && i < rows) ? read_at(i - 1) : 0;
    sink.put(0, i, k, 0, 0);
  }
  sink.diagonal(0, v1);
  const int from = (lane + 31) & 31;  // the lane above, lane 0 wraps to 31
  const bool seam = lane == 0;
  int chunk = 0;
  int v0 = 0, p0 = 0;  // kFromRow1: row 0's cell on the diagonal before
  for (int d = 1; d <= dlast; ++d) {
    // the top row's column enters: column d at row 0, d - 1 at row 1 (code
    // e = d - 1 - kBase; the cell of e < 0 is a border)
    const int e = d - 1 - kBase;
    if ((e & 31) == 0) chunk = genome_at(e + lane);
    const int gin = __shfl_sync(kFullMask, chunk, e & 31);
    // every stripe's row above, taken before any stripe overwrites v1, p1
    int rv[kStripes], rp[kStripes], rg[kStripes];
#pragma unroll
    for (int k = 0; k < kStripes; ++k) {
      rv[k] = __shfl_sync(kFullMask, v1[k], from);
      rp[k] = __shfl_sync(kFullMask, p1[k], from);
      rg[k] = __shfl_sync(kFullMask, gc[k], from);
    }
#pragma unroll
    for (int k = 0; k < kStripes; ++k) {
      const int vup = seam ? (k ? rv[k ? k - 1 : 0] : v0) : rv[k];
      const int pup = seam ? (k ? rp[k ? k - 1 : 0] : p0) : rp[k];
      const int g = seam ? (k ? rg[k ? k - 1 : 0] : gin) : rg[k];
      const int i = 32 * k + lane + kBase;
      int v, p;
      cell(s, d, i, rc[k], g, vd[k], v1[k], p1[k], vup, pup, v, p);
      vd[k] = vup;
      v1[k] = v;
      p1[k] = p;
      gc[k] = g;
      sink.put(d, i, k, v, p);
    }
    if constexpr (kFromRow1) cell(s, d, 0, 0, 0, 0, 0, 0, 0, 0, v0, p0);
    sink.diagonal(d, v1);
  }
}

// One block sweeps diagonals 0..dlast of a job of `rows` rows.  `carry`
// holds kCarried * cap ints (cap >= rows) of shared memory.  All
// threads of the block must call it; it ends on a barrier.
template <bool kOutside, class ReadAt, class GenomeAt, class Sink>
__device__ __forceinline__ void sweep_block(const Scoring& s, int rows,
                                            int dlast, int jmax, int* carry,
                                            int cap, ReadAt read_at,
                                            GenomeAt genome_at, Sink& sink) {
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    carry[i] = 0;
    carry[3 * cap + i] = 0;
    if (kOutside || i == 0) sink.put(0, i, 0, 0, 0);
  }
  __syncthreads();
  for (int d = 1; d <= dlast; ++d) {
    // values rotate over three arrays, pointers over two: the arrays
    // written at d were last read at d - 1, before its barrier
    const int* v1 = carry + ((d - 1) % 3) * cap;
    const int* v2 = carry + ((d + 1) % 3) * cap;
    const int* p1 = carry + (3 + ((d - 1) & 1)) * cap;
    int* vo = carry + (d % 3) * cap;
    int* po = carry + (3 + (d & 1)) * cap;
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
      const int j = d - i;
      if (!kOutside && (j < 0 || j > jmax)) continue;
      const int up = i > 0 ? i - 1 : 0;
      const int rc = i > 0 ? read_at(i - 1) : 0;
      const int g = j >= 1 ? genome_at(j - 1) : 0;
      int v, p;
      cell(s, d, i, rc, g, d >= 2 ? v2[up] : 0, v1[i], p1[i], v1[up], p1[up],
           v, p);
      vo[i] = v;
      po[i] = p;
      sink.put(d, i, 0, v, p);
    }
    __syncthreads();
  }
}

}  // namespace dp
