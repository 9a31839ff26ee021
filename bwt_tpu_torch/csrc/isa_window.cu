// The inverse-SA window as one launch (K6): a tile of threads per window,
// each chaining from its own ISA sample, and the window's row stored as one
// coalesced write.
//
// Computes what bwt_tpu/ops/search.py:isa_window computes (an XLA loop
// there; the port's plain version is
// bwt_tpu_torch/ops/search.py:isa_window_plain), bit for bit:
// rows[b, j] = SA^-1[plo[b] + j] for j < width[b] and 0 <= plo[b] + j <=
// length, else -1, with bwt_tpu's cap: its chain runs at most rate - 1 + W
// steps down from the sample above the window's top, so a position below
// that line stays -1 even inside [plo, plo + width) (a width past W).
//
// What bounded the first form (a thread a window over fm::isa_chain, which
// the service lanes keep): a chain of up to rate - 1 + W dependent 32-byte
// row loads a thread, only B threads in flight, and two 4-byte stores a
// cell, a warp's 32 of them on 32 different lines.  Here:
//
//   - The window's emitted positions are cut at the ISA sample boundaries:
//     segment m holds the positions p with ceil(p / rate) = m, whose anchor
//     is min(m rate, length) (the sample ISA[m rate], or row 0 at length
//     when length is not a multiple of the rate, isa_chain's tail rule).
//     Thread q of the window's tile of G takes segments q, q + G, ... from
//     the top, and chains each down from its own anchor only to its floor:
//     ISA is a function of the position, so a row reached from a nearer
//     sample is the same row.  A segment's chain is at most rate loads (a
//     sample and rate - 1 LF steps), against rate - 1 + W for the window's
//     one chain.
//   - G is a power of two picked per launch by the caller (search.isa_tile):
//     the most segments a window can touch, rounded down to a power of two,
//     at most a warp: 8 at rate 4 and W = 32 (a window of 9 segments gives
//     one thread two), 2 at rate 32.  On 2^16 windows of widths 0..32 of a
//     2^25-base genome (H100 80GB HBM3 at 700 W, chip_smoke.py
//     --isa-times 25), G = 1, 2, 4, 8, 16, 32 took 0.0294, 0.0177, 0.0182,
//     0.0172, 0.0254, 0.0441 ms at rate 4 and 0.0415, 0.0264, 0.0394,
//     0.0692, 0.1251, 0.2137 ms at rate 32: past the segments a window
//     has, the extra threads only idle; the first form took 0.0674 and
//     0.0751 ms.
//   - The tile writes its window's row into shared memory, each cell once
//     (-1 outside the emitted columns, a row inside), and each warp stores
//     its windows' rows, contiguous in the output, as 16-byte vectors
//     (W % 4 == 0 and an aligned output; else 4-byte words), streamed
//     (__stcs) so that they do not push the index rows out of L2: at W = 32
//     one 128-byte line a window, no -1 pre-fill in device memory.  Rows
//     wider than the staging (kStagedInts a block) go in column chunks.  The
//     warp needs no block barrier, and blocks of 128 threads free their
//     slots sooner than blocks of 256: a block barrier with 256 threads
//     took 0.0197 / 0.0307 ms at rates 4 / 32, warps alone in blocks of
//     256, 64 or 32 threads 0.0187 / 0.0277, 0.0178 / 0.0282, 0.0205 /
//     0.0282, against 0.0171 / 0.0262 here; plain stores cost 3-4 %.
//
// What bounds it now (no counters on that machine, so not measured apart):
// at rate 4, 1.14 M random loads of sample and row sectors from tables
// (33.5 MB of samples, 16.8 MB of rows at 2^25 bases) that together pass
// the 50 MB L2, at about half its bytes bound; at rate 32, a segment's
// chain of up to 32 dependent loads.

#include <cuda_runtime.h>
#include <stddef.h>

#include <algorithm>

#include "fm_search.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxTile = 32;       // a tile stays inside a warp
constexpr int kStagedInts = 4096;  // a block's staged cells: 16 KB

// The columns [jlo, jhi] of a window that hold a row (empty when jlo > jhi):
// the positions fm::isa_chain emits, from the same anchor and cap, with the
// same wrapping int32 arithmetic.  An emitted position p lies in [max(plo,
// 0), plo + width - 1] without a wrap, so p - plo is exact.
struct Span {
  int jlo, jhi;
};

template <bool kTp>
__device__ __forceinline__ Span window_span(const fm::IsaT<kTp>& s, int plo,
                                            int width, int W) {
  Span e{1, 0};
  if (width <= 0) return e;
  const int n = s.length;
  const int rate = 1 << s.shift;
  const int p_hi = min(fm::wsub(fm::wadd(plo, width), 1), n);
  const int anchor = min(max((fm::wadd(p_hi, rate - 1) >> s.shift) * rate, 0), n);
  const int floor = max(plo, 0);
  const int span = min(anchor - floor + 1, rate - 1 + W);
  if (span <= 0) return e;
  const int lo = anchor - span + 1;  // the cap's line, at or above the floor
  if (p_hi < lo) return e;
  e.jlo = lo - plo;
  e.jhi = min(p_hi - plo, W - 1);
  return e;
}

// The sample segment of a position p >= 0: ceil(p / rate).
__device__ __forceinline__ int segment_of(int p, int shift) {
  return (p >> shift) + ((p & ((1 << shift) - 1)) != 0);
}

// The rows of the positions [pb, pt] that lie in segment m, into
// cells[p - plo - c0]: from the segment's anchor down to its floor.
template <bool kTp>
__device__ __forceinline__ void segment_chain(const fm::IndexT<kTp>& ix,
                                              const fm::Consts k,
                                              const fm::IsaT<kTp>& s, int m,
                                              int pb, int pt, int plo, int c0,
                                              int* cells) {
  const int n = s.length;
  const int rate = 1 << s.shift;
  const int a = m > (n >> s.shift) ? n : m << s.shift;
  const int bot = max(pb, (m - 1) * rate + 1);
  const int top = min(pt, a);
  int row = fm::sample_at(s, min(max(a >> s.shift, 0), s.nsamples - 1));
  if ((n & (rate - 1)) != 0 && a == n) row = 0;
  for (int p = a;; --p) {
    if (p <= top) cells[p - plo - c0] = row;
    if (p <= bot) break;
    row = fm::lf(ix, k, row);
  }
}

template <bool kTp>
__global__ void __launch_bounds__(kThreads)
isa_window_kernel(const int* __restrict__ plo_in,
                  const int* __restrict__ width_in, int B, int W,
                  int tile_shift, int chunk, bool vec, fm::IndexT<kTp> ix,
                  fm::IsaT<kTp> isa, int* __restrict__ out) {
  extern __shared__ int4 staged4[];
  int* staged = reinterpret_cast<int*>(staged4);
  const int G = 1 << tile_shift;
  const int w = threadIdx.x >> tile_shift;  // the window in the block
  const int q = threadIdx.x & (G - 1);
  const int lane = threadIdx.x & 31;
  // a warp's windows, its first one in the block, and how many are real
  const int wpw = 32 >> tile_shift;
  const int first = (threadIdx.x >> 5) * wpw;
  const int b0 = blockIdx.x * (kThreads >> tile_shift) + first;
  const int nw = max(0, min(wpw, B - b0));
  const fm::Consts k = fm::load_consts(ix);
  int plo = 0;
  Span e{1, 0};
  if (w - first < nw) {
    plo = __ldg(plo_in + b0 + w - first);
    e = window_span(isa, plo, __ldg(width_in + b0 + w - first), W);
  }
  int* cells = staged + w * chunk;
  const int* rows = staged + first * chunk;
  for (int c0 = 0; c0 < W; c0 += chunk) {
    const int cn = min(chunk, W - c0);
    const int ja = max(e.jlo, c0);
    const int jb = min(e.jhi, c0 + cn - 1);
    for (int j = q; j < cn; j += G) {
      if (c0 + j < ja || c0 + j > jb) cells[j] = -1;
    }
    if (ja <= jb) {
      const int pb = plo + ja, pt = plo + jb;
      const int mb = segment_of(pb, isa.shift);
      for (int m = segment_of(pt, isa.shift) - q; m >= mb; m -= G) {
        segment_chain(ix, k, isa, m, pb, pt, plo, c0, cells);
      }
    }
    __syncwarp();
    // the warp's rows of this chunk: row r's cn cells at out[(b0 + r) W +
    // c0], one contiguous span when the chunk is the whole row; streamed
    // past L2's keep, which the index rows want
    int* o = out + static_cast<size_t>(b0) * W + c0;
    if (vec) {
      const int cn4 = cn >> 2;
      for (int i = lane; i < nw * cn4; i += 32) {
        const int r = i / cn4, c = i - r * cn4;
        __stcs(reinterpret_cast<int4*>(o + static_cast<size_t>(r) * W) + c,
               reinterpret_cast<const int4*>(rows + r * chunk)[c]);
      }
    } else {
      for (int i = lane; i < nw * cn; i += 32) {
        const int r = i / cn, c = i - r * cn;
        __stcs(o + static_cast<size_t>(r) * W + c, rows[r * chunk + c]);
      }
    }
    if (c0 + chunk < W) __syncwarp();
  }
}

template <bool kTp>
int launch(const int* plo, const int* width, int B, int W, int tile,
           const fm::IndexArgs& ia, const fm::TableArgs& isa, int shift,
           int length, int* out, cudaStream_t s) {
  const int tile_shift = __builtin_ctz(tile);
  const int wpb = kThreads >> tile_shift;  // windows a block
  const int chunk = std::min(W, kStagedInts / wpb);
  const bool vec = W % 4 == 0 && reinterpret_cast<size_t>(out) % 16 == 0;
  const int blocks = (B + wpb - 1) / wpb;
  const size_t smem = static_cast<size_t>(wpb) * chunk * sizeof(int);
  isa_window_kernel<kTp><<<blocks, kThreads, smem, s>>>(
      plo, width, B, W, tile_shift, chunk, vec, fm::index_form<kTp>(ia),
      fm::isa_form<kTp>(isa, shift, length), out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// plo and width (B,) int32; the index as fm::IndexArgs and the ISA samples
// as fm::TableArgs (per > 0: a tp view); tile, the threads a window (a power
// of two, 1..32); out (B, W) int32.  All on the device, contiguous.
// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a tile outside 1..32 or not a power of two.
extern "C" int isa_window_launch(const int* plo, const int* width, int B,
                                 int W, const void* buckets, int nrows,
                                 int per, const int* C, const int* endloc,
                                 const void* isa_samples, int nisa,
                                 int isa_per, int shift, int length, int tile,
                                 int* out, void* stream) {
  if (tile < 1 || tile > kMaxTile || (tile & (tile - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0 || W <= 0) return 0;
  const fm::IndexArgs ia{buckets, nrows, per, C, endloc};
  const fm::TableArgs isa{isa_samples, nisa, isa_per};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return per > 0
      ? launch<true>(plo, width, B, W, tile, ia, isa, shift, length, out, s)
      : launch<false>(plo, width, B, W, tile, ia, isa, shift, length, out, s);
}
