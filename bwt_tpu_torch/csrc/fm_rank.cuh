// Rank / LF over the fused 32-byte bucket row: device functions under the
// search and walk of fm_search.cuh, which every search kernel runs.
//
// The counterpart of bwt_tpu/ops/rank.py:199-384 (_adjust, _rows,
// _row_rank, row_ranks_all4, _row_char, row_lf) and of the port's plain
// versions in bwt_tpu_torch/ops/rank.py.  One row per 64 BWT entries:
//
//     [occ_A occ_C occ_G occ_T | w0 w1 w2 w3]
//
// occ_c counts symbol c in bwt[0 : 64b]; w0..w3 hold the next 64 bases,
// 16 little-endian 2-bit lanes per word.  A rank reads one row (two
// 16-byte loads) and counts the in-bucket symbols with XOR, mask and
// __popc.  Arithmetic is uint32 and wraps like rank_ops.wrap32.
//
// Out-of-range rows read like jnp.take (rank.take_fill): a row index in
// [-nrows, 0) wraps, anything further out reads a row of eight INT32_MIN.
// Symbols outside the tables count as zero: occ for c outside 0..3 and
// C[c] for c outside 0..4.  eq_mask takes c as uint32 times 0x55555555
// (mod 2^32), so an unresolved N (c = 5) gives the same defined bits as
// the plain version.

#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace fm {

// The index as the kernels see it: the bucket table, C and endloc, all in
// device memory.
struct Index {
  const int* buckets;  // (nrows, 8) int32, row-major
  int nrows;
  const int* C;       // (5,) int32
  const int* endloc;  // () int32
};

struct Row {
  int occ[4];
  unsigned w[4];
};

// The step's instruction count matters on the H100: the disassembled step
// of the first version held about 225 instructions, and the anchor hunts,
// whose short trips spend much of their time outside the row loads, ran
// 11-15 % faster once it held about 170 (PERF.md).  So the forms below are
// chosen by instruction count: C[c] is one cached load, not a five-way
// select over registers; an occ count is picked by the two bits of c; a
// lane mask is one funnel shift; a row outside the table is read from a
// row of INT32_MIN in memory, so the load needs no second form.

// C and endloc as a thread holds them: endloc read once, C[c] read (from
// L1) where it is used.
struct Consts {
  const int* C;
  int endloc;
};

__device__ __forceinline__ Consts load_consts(const Index& ix) {
  Consts k;
  k.C = ix.C;
  k.endloc = __ldg(ix.endloc);
  return k;
}

// Wrapping int32 arithmetic (two's complement, as torch and XLA give it).
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// C[c] for c in 0..4, 0 for any other c (search.take_c).
__device__ __forceinline__ int take_c(const Consts k, int c) {
  return static_cast<unsigned>(c) < 5u ? __ldg(k.C + c) : 0;
}

// Sentinel skip: the stored BWT omits the sentinel row (seqindex.c:221-225).
__device__ __forceinline__ int adjust(int endloc, int idx) {
  return idx > endloc ? idx - 1 : idx;
}

// What a bucket index outside the table reads: a row of INT32_MIN.
static __device__ const int4 kNoRow[2] = {
    {INT_MIN, INT_MIN, INT_MIN, INT_MIN}, {INT_MIN, INT_MIN, INT_MIN, INT_MIN}};

// The bucket row covering adjusted index i: two 16-byte loads.
__device__ __forceinline__ Row load_row(const Index& ix, int i) {
  int b = i >> 6;  // arithmetic shift, like the int32 tensors'
  if (b < 0) b += ix.nrows;
  Row row;
  const int4* p = static_cast<unsigned>(b) < static_cast<unsigned>(ix.nrows)
      ? reinterpret_cast<const int4*>(ix.buckets) + 2 * static_cast<size_t>(b)
      : kNoRow;
  const int4 lo = __ldg(p);
  const int4 hi = __ldg(p + 1);
  row.occ[0] = lo.x; row.occ[1] = lo.y; row.occ[2] = lo.z; row.occ[3] = lo.w;
  row.w[0] = static_cast<unsigned>(hi.x); row.w[1] = static_cast<unsigned>(hi.y);
  row.w[2] = static_cast<unsigned>(hi.z); row.w[3] = static_cast<unsigned>(hi.w);
  return row;
}

// Mask of the lanes of payload word w below in-bucket offset r (0..63).
__device__ __forceinline__ unsigned lane_mask(int r, int w) {
  // the high word of 0x00000000FFFFFFFF << min(s, 32) is 2^s - 1 for s in
  // 0..32, s twice the lanes of word w below r
  return __funnelshift_lc(0xFFFFFFFFu, 0u, max(2 * r - 32 * w, 0));
}

// One bit (at lane position 2j) per 2-bit lane of `word` equal to the
// lane pattern `pat` (= uint32(c) * 0x55555555).
__device__ __forceinline__ unsigned eq_mask(unsigned word, unsigned pat) {
  const unsigned x = word ^ pat;
  return ~(x | (x >> 1)) & 0x55555555u;
}

__device__ __forceinline__ int occ_of(const Row& row, int c) {
  const int even = (c & 2) ? row.occ[2] : row.occ[0];
  const int odd = (c & 2) ? row.occ[3] : row.occ[1];
  return static_cast<unsigned>(c) < 4u ? ((c & 1) ? odd : even) : 0;
}

// rank of symbol c at in-bucket offset r of a fetched row (_row_rank).
__device__ __forceinline__ int row_rank(const Row& row, int c, int r) {
  const unsigned pat = static_cast<unsigned>(c) * 0x55555555u;
  unsigned cnt = 0;
#pragma unroll
  for (int w = 0; w < 4; ++w) cnt += __popc(eq_mask(row.w[w], pat) & lane_mask(r, w));
  return static_cast<int>(static_cast<unsigned>(occ_of(row, c)) + cnt);
}

// All four symbol ranks at offset r from one fetched row (row_ranks_all4).
__device__ __forceinline__ void row_ranks_all4(const Row& row, int r, int out[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) out[c] = row_rank(row, c, r);
}

// BWT symbol at in-bucket offset r (_row_char).
__device__ __forceinline__ int row_char(const Row& row, int r) {
  const int wi = r >> 4;
  const unsigned even = (wi & 2) ? row.w[2] : row.w[0];
  const unsigned odd = (wi & 2) ? row.w[3] : row.w[1];
  const unsigned w = (wi & 1) ? odd : even;
  return static_cast<int>((w >> (2 * (r & 15))) & 3u);
}

// rank(c, idx) with the sentinel skip (rank.rank).
__device__ __forceinline__ int rank(const Index& ix, const Consts k, int c, int idx) {
  const int i = adjust(k.endloc, idx);
  return row_rank(load_row(ix, i), c, i & 63);
}

// All four ranks at idx (rank.ranks_all4).
__device__ __forceinline__ void ranks_all4(const Index& ix, const Consts k, int idx, int out[4]) {
  const int i = adjust(k.endloc, idx);
  row_ranks_all4(load_row(ix, i), i & 63, out);
}

// LF-mapping (seqindex.c:214-219), lf(endloc) == 0.
__device__ __forceinline__ int lf(const Index& ix, const Consts k, int idx) {
  const int i = adjust(k.endloc, idx);
  const Row row = load_row(ix, i);
  const int r = i & 63;
  const int c = row_char(row, r);
  const int stepped = wadd(take_c(k, c), row_rank(row, c, r));
  return idx == k.endloc ? 0 : stepped;
}

}  // namespace fm
