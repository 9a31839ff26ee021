// One read's backward search and one row's SA walk as device functions:
// the bodies of the search kernels, shared by the standalone shells
// (backward_search.cu, unc_sa.cu) and the fused kernels (anchor_scan.cu,
// locate.cu), so that every kernel steps through the same code and stays
// bit-equal to the plain versions in bwt_tpu_torch/ops/search.py.
//
// search_lane is what bwt_tpu/ops/search.py:backward_search / _run_loop
// computes for one read; sa_walk is bwt_tpu/ops/search.py:unc_sa for one
// row (seqindex.c:244-255).
//
// What the design does for the H100.  A search is a chain of dependent
// 32-byte row gathers served by L2 (a 2^25-base genome's bucket table is
// 16.8 MB): at 2^20 30-mers the rows alone are 1.9 GB through L2 in
// 0.3 ms, near what L2 delivers in random sectors, and every sector the
// step does not ask for is time.  So:
//   * the reads come coalesced.  A block's rows are one contiguous span
//     of the (B, L) array, which the block copies into shared memory with
//     16-byte loads (stage_rows) before its threads search from there:
//     every pattern sector is fetched once, where a 4-byte load a step
//     fetched a 32-byte sector for each of a warp's 32 reads.  That holds
//     while the rows are short.  The search lives on the reads in flight,
//     so where the tile would leave fewer blocks on an SM than the
//     kernel's registers allow (tile_bytes: int32 rows of about 46
//     characters and up), the threads read global memory instead, int32
//     characters through a 16-byte register window (one aligned load
//     serves 4 characters), byte-wide codes as they are (their sector
//     already holds 32).  The anchor hunt always reads global memory: it
//     reads its row dozens of times over, from L1 after the first, and
//     at a search_reads chunk (one block an SM) staging cost it 7 %;
//   * one row load where one suffices: once the interval is narrower than
//     a bucket both of its ends usually lie in the same 64-entry row, and
//     the row is loaded once and ranked twice;
//   * the step's own instructions are kept few (fm_rank.cuh), which is
//     what the hunts of anchor_scan gain from: their short trips spend
//     more of their time outside the row loads.
// PERF.md has the time of each against the form it replaced.
//
// A trap: without the single row load the compiler kept endloc of
// locate.cu in local memory and reloaded it in every step, ahead of the
// row loads that depend on it, and that kernel took twice its time
// (PERF.md); read -Xptxas -v for a stack frame after any change to the
// step.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <stddef.h>

#include "fm_rank.cuh"

namespace fm {

constexpr int kN = 5;  // the read code of N

// Copy the block's rows, a contiguous span of the (B, L) array, into
// shared memory and return this thread's row there.  The copy keeps the
// span's offset in its 16-byte block, so whole blocks move as uint4 and
// the elements before the first and after the last whole block one by
// one.  Every thread of the block calls it (it holds a barrier); the
// launch gives tile_bytes() of dynamic shared memory.
template <typename T>
__device__ __forceinline__ const T* stage_rows(const T* patterns, int B, int L) {
  extern __shared__ uint4 tile[];
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  const int nt = static_cast<int>(blockDim.x);
  const int tid = static_cast<int>(threadIdx.x);
  const int b0 = static_cast<int>(blockIdx.x) * nt;
  const int n = min(nt, B - b0) * L;  // elements in the span
  const T* span = patterns + static_cast<size_t>(b0) * L;
  const int head = static_cast<int>(reinterpret_cast<uintptr_t>(span) & 15) /
                   static_cast<int>(sizeof(T));
  T* dst = reinterpret_cast<T*>(tile) + head;
  const int pre = min(n, (kPer - head) % kPer);
  const int whole = (n - pre) / kPer;
  const uint4* src = reinterpret_cast<const uint4*>(span + pre);
  for (int i = tid; i < pre; i += nt) dst[i] = span[i];
  for (int i = tid; i < whole; i += nt)
    reinterpret_cast<uint4*>(dst + pre)[i] = __ldg(src + i);
  for (int i = pre + whole * kPer + tid; i < n; i += nt) dst[i] = span[i];
  __syncthreads();
  return dst + static_cast<size_t>(tid) * L;
}

// The dynamic shared memory that stage_rows needs for `threads` rows of
// `row_bytes`, or 0 where the rows should stay in global memory: where
// the tile does not fit, or leaves fewer blocks on an SM than the kernel
// has without it.  Host side, before the launch of `tiled`.
template <typename Kernel>
inline size_t tile_bytes(Kernel tiled, int threads, size_t row_bytes) {
  const size_t smem = threads * row_bytes + 16;
  if (smem > static_cast<size_t>(INT_MAX) ||
      cudaFuncSetAttribute(tiled, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess) {
    cudaGetLastError();  // too large for the card: not an error of the launch
    return 0;
  }
  int with = 0, without = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&without, tiled, threads, 0);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&with, tiled, threads, smem);
  return with > 0 && with == without ? smem : 0;
}

// A thread's view of its read: row b of a (B, L) array of T (int32, uint8
// or int8 codes, widened to int as a cast would), staged in shared memory
// (kTile; every thread of the block constructs its view, before any
// returns) or read from global memory.  After flip(len0) the view is the read plain-reversed
// (not complemented) and zero-padded, as models/exact.py:_plain_reverse
// lays it out:
//   view[j] = j < len0 ? row[clip(len0-1-j, 0, L-1)] : 0.
// From global memory, a window holds the aligned 16 bytes around an int32
// element; a block that reaches past either end of the array (the first
// and last block of an array that is not 16-byte aligned) is read element
// by element.
template <typename T, bool kTile>
struct PatternView {
  static constexpr bool kWindow = !kTile && sizeof(T) == 4;

  const T* row;
  int L;
  int len0 = 0;          // the read's full length (reversed only)
  bool reverse = false;
  const uint4* blocks;   // window: the 16-byte block holding row[0]
  int off;               // row[0]'s element offset in that block
  int lo, hi;            // blocks[lo..hi) lie wholly inside the array
  int cur = -1;          // index of the block held in w, -1 for none
  uint4 w;

  __device__ __forceinline__ PatternView(const T* patterns, int B, int b, int L_)
      : L(L_) {
    if constexpr (kTile) {
      row = stage_rows(patterns, B, L_);
    } else {
      row = patterns + static_cast<size_t>(b) * L_;
    }
    if constexpr (kWindow) {
      const uintptr_t a = reinterpret_cast<uintptr_t>(row);
      const uintptr_t a0 = reinterpret_cast<uintptr_t>(patterns);
      const uintptr_t a1 = a0 + static_cast<size_t>(B) * L_ * sizeof(T);
      const uintptr_t base = a & ~static_cast<uintptr_t>(15);
      blocks = reinterpret_cast<const uint4*>(base);
      off = static_cast<int>(a & 15) / 4;
      // a row has at most L / 4 + 2 blocks, so the clamp loses nothing
      const ptrdiff_t span = static_cast<ptrdiff_t>(L_) + 8;
      const ptrdiff_t first =
          (static_cast<ptrdiff_t>((a0 + 15) & ~static_cast<uintptr_t>(15)) -
           static_cast<ptrdiff_t>(base)) / 16;
      const ptrdiff_t last =
          (static_cast<ptrdiff_t>(a1 & ~static_cast<uintptr_t>(15)) -
           static_cast<ptrdiff_t>(base)) / 16;
      lo = static_cast<int>(max(-span, min(span, first)));
      hi = static_cast<int>(max(-span, min(span, last)));
      w = make_uint4(0, 0, 0, 0);
    }
  }

  __device__ __forceinline__ void flip(int len0_) {
    reverse = true;
    len0 = len0_;
  }

  // row[e] for e in [0, L).
  __device__ __forceinline__ int load(int e) {
    if constexpr (!kWindow) {
      return static_cast<int>(row[e]);
    } else {
      const int g = off + e;
      const int blk = g >> 2;
      if (blk < lo || blk >= hi) return static_cast<int>(__ldg(row + e));
      if (blk != cur) {
        w = __ldg(blocks + blk);
        cur = blk;
      }
      const int k = g & 3;
      return static_cast<int>(k == 0 ? w.x : k == 1 ? w.y : k == 2 ? w.z : w.w);
    }
  }

  // view[clip(ci, 0, L-1)] (search._char_at).
  __device__ __forceinline__ int at(int ci) {
    ci = min(max(ci, 0), L - 1);
    if (!reverse) return load(ci);
    return ci < len0 ? load(min(max(len0 - 1 - ci, 0), L - 1)) : 0;
  }
};

// The eight fields backward_search returns for one read.
struct Lane {
  int start, end, sp, ep, nmatched;
  bool alive;
  int skips, eff;
};

// Where a seeded search starts: (nrows, 6) rows of (start, end, sp, ep,
// nmatched, alive) after k steps, one row a k-mer key.
struct SeedRows {
  const int* rows;
  int nrows;
  int k;
};

// Trailing N's of view[:len] (search.trailing_n).
template <typename View>
__device__ __forceinline__ int trailing_n(View& pat, int len) {
  if (len <= 0) return 0;
  int col = min(len - 1, pat.L - 1);
  int count = 0;
  while (col >= 0 && pat.at(col) == kN) {
    ++count;
    --col;
  }
  return count;
}

// The seed key of the read's last k characters (search._seed_key): the
// character processed at step t carries weight 4^t.
template <typename View>
__device__ __forceinline__ int seed_key(View& pat, int len, int k) {
  unsigned key = 0;
  for (int t = 0; t < k; ++t) {
    const int j = wsub(wsub(len, 1), t);
    if (j >= 0 && j < pat.L) {
      key += static_cast<unsigned>(pat.at(j)) << (2 * min(t, 15));
    }
  }
  return static_cast<int>(key);
}

// One read's backward search.  Initial state, by `mode`:
//   0  C[c0] of the last (effective) character, t0 = 1 (backward_search);
//      with resolve_n, trailing N's are stripped first and an all-N read
//      clamps c0 to 'A';
//   1  the given (init_start, init_end) with t0 = 0 and no length clamp
//      (mms_continue, single_align.c:26-46);
//   2  the seed-table row of the read's last k characters, t0 = k
//      (backward_search_seeded).
// Step t processes view[clip(eff_len-1-t, 0, L-1)] while the lane is alive
// and t <= eff_len-1, for t < steps.  With resolve_n an N (code 5) becomes
// the symbol with the most occurrences in the current interval, first
// maximum winning (seqindex.c:330-340).
template <typename View>
__device__ __forceinline__ Lane search_lane(const Index& ix, const Consts k,
                                            View& pat, int len,
                                            int steps, bool resolve_n, int mode,
                                            int init_start, int init_end,
                                            const SeedRows& seed) {
  Lane r;
  r.skips = 0;
  int t0;
  if (mode == 0) {
    if (resolve_n) r.skips = trailing_n(pat, len);
    r.eff = max(wsub(len, r.skips), 1);
    int c0 = pat.at(r.eff - 1);
    if (resolve_n && c0 == kN) c0 = 0;  // all-N read: the reference reads C[5] (UB)
    r.start = r.sp = take_c(k, c0);
    r.end = r.ep = take_c(k, wadd(c0, 1));
    r.alive = r.end > r.start;
    r.nmatched = r.alive ? 1 : 0;
    t0 = 1;
  } else if (mode == 1) {
    r.eff = len;
    r.start = r.sp = init_start;
    r.end = r.ep = init_end;
    r.alive = r.end > r.start;
    r.nmatched = 0;
    t0 = 0;
  } else {
    r.eff = len;
    int key = seed_key(pat, len, seed.k);
    if (key < 0) key += seed.nrows;
    if (key < 0 || key >= seed.nrows) {
      r.start = r.end = r.sp = r.ep = r.nmatched = INT_MIN;
      r.alive = false;
    } else {
      const int* row = seed.rows + 6 * static_cast<size_t>(key);
      r.start = __ldg(row);
      r.end = __ldg(row + 1);
      r.sp = __ldg(row + 2);
      r.ep = __ldg(row + 3);
      r.nmatched = __ldg(row + 4);
      r.alive = __ldg(row + 5) > 0;
    }
    t0 = seed.k;
  }

  const int last = wsub(r.eff, 1);
  for (int t = t0; t < steps; ++t) {
    if (!r.alive || t > last) break;
    int c = pat.at(wsub(last, t));
    const int is = adjust(k.endloc, r.start);
    const int ie = adjust(k.endloc, r.end);
    const Row rs = load_row(ix, is);
    // load_row depends on its index only through i >> 6, so equal bucket
    // numbers give the same row, in range or out of it
    const Row re = (is >> 6) == (ie >> 6) ? rs : load_row(ix, ie);
    if (resolve_n && c == kN) {
      int hi[4], lo[4];
      row_ranks_all4(re, ie & 63, hi);
      row_ranks_all4(rs, is & 63, lo);
      int best = 0;
      int bv = wsub(hi[0], lo[0]);
#pragma unroll
      for (int d = 1; d < 4; ++d) {
        const int v = wsub(hi[d], lo[d]);
        if (v > bv) {
          bv = v;
          best = d;
        }
      }
      c = best;
    }
    const int cc = take_c(k, c);
    const int ns = wadd(cc, row_rank(rs, c, is & 63));
    const int ne = wadd(cc, row_rank(re, c, ie & 63));
    r.start = ns;
    r.end = ne;
    if (ne > ns) {
      r.sp = ns;
      r.ep = ne;
      ++r.nmatched;
    } else {
      r.alive = false;
    }
  }
  return r;
}

// The sampled suffix array as the walk reads it.
struct Samples {
  const int* sa;  // (nsamples,) int32: SA[j << shift]
  int nsamples;
  int shift;      // log2 of the sample rate
  int length;     // of the genome
};

// Where a walk ended: the position, and whether it stopped at its limit
// short of a sampled row.
struct Walk {
  int pos;
  bool unsampled;
};

// SA[i] by LF steps to the nearest sampled row, at most `limit` of them:
// sa[row >> shift] + steps, wrapped by length + 1 (search.unc_sa).  A walk
// from a real row (0..length) reaches row 0 within length + 1 steps, so
// only a row past the suffix array ends `unsampled` at that limit.
__device__ __forceinline__ Walk sa_walk(const Index& ix, const Consts k,
                                        const Samples& s, int i, int limit) {
  const int mask = (1 << s.shift) - 1;
  int steps = 0;
  while ((i & mask) != 0 && steps < limit) {
    i = lf(ix, k, i);
    ++steps;
  }
  int j = i >> s.shift;
  if (j < 0) j += s.nsamples;
  const int v = (j < 0 || j >= s.nsamples) ? INT_MIN : __ldg(s.sa + j);
  const int x = wadd(v, steps);
  return Walk{x > s.length ? wsub(x, s.length + 1) : x, (i & mask) != 0};
}

// Count a lane in flag[0] and keep B - b, the largest over the lanes, in
// flag[1], so that the host can name the first lane that raised it.
__device__ __forceinline__ void raise_flag(int* flag, int B, int b) {
  atomicAdd(flag, 1);
  atomicMax(flag + 1, B - b);
}

}  // namespace fm
