// The fused service round as one launch: one thread per lane (a tile of
// four on a small round) answers the lane's FM-index request, whatever its
// opcode.
//
// Computes what bwt_tpu/models/batch_exec.py:_service_core computes (an
// XLA program there: one lockstep LF loop under per-lane masks, the
// unc_sa walk, the inverse-SA window scan and the C[c] + rank adjunct;
// the port's plain version is
// bwt_tpu_torch/ops/service.py:service_round_plain), bit for bit in all 13
// result columns on every lane, padding lanes included.  The lane's body
// is svc::lane (service_lane.cuh), which the rna_seq automaton
// (rnaseq_automaton.cu) shares; this file is the shell that loads a lane's
// seven fields, calls it, stores the columns and raises the walk's flag.
//
// Output: (13 B + 2) int32, column c at [c B, (c + 1) B), then the flag
// (count of walks that overran, and B - the first such lane), zeroed by
// the caller; an overrun lane's POS slot holds the row it walked from.
//
// What bounds it on the H100 (PERF.md).  A lane's work is a chain of
// dependent 32-byte row loads from L2: its search steps (up to a read's
// length), then its walk, then its window scan.  A warp runs the three one
// after another, each until its longest lane is done, so its time is the
// sum of the three longest, and the host engines' rounds are of two kinds:
//   * the large ones (2^16 lanes and more: the first mms and mms_ext rounds
//     of single_align, rna_seq's spliced rounds) fill the card, and more
//     threads a lane only add to the load unit's work: one thread a lane;
//   * the small ones (the later rounds, the indel reads, the escapes: at
//     most kTileLanes lanes) leave most of the card idle, and there a
//     warp's time is its chain.  They run a tile of kSmallTile threads a
//     lane: each thread searches and walks as the lane (the same addresses,
//     so the same sectors), a warp holds 8 lanes, whose longest search and
//     walk are shorter than 32 lanes' are, and an ext lane's window is cut
//     into kSmallTile slices that chain side by side from the sample above
//     each (svc::TileSplit, as the automatons K9 and K10 scan theirs).
// chip_smoke.py builds the kernel apart with the tile on every round and on
// none (BWT_SERVICE_TILE) to time both beside it.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <stddef.h>
#include <type_traits>

#include "service_lane.cuh"

// 0: the tile from the round; else that tile on every round (builds made
// apart to time the choice).
#ifndef BWT_SERVICE_TILE
#define BWT_SERVICE_TILE 0
#endif

namespace {

constexpr int kThreads = 128;
constexpr int kSmallTile = 4;
constexpr int kTileLanes = 1 << 14;  // the largest round that tiles

// The seven (B,) lane fields.
struct Fields {
  const int *opc, *row, *off, *ln, *sp, *ep, *idx;
};

template <int kTile>
using SplitOf = typename std::conditional<kTile == 1, svc::NoSplit,
                                          svc::TileSplit<kTile>>::type;

// Lane b is threads [b kTile, (b + 1) kTile) of the grid; the first of them
// stores its columns.
template <typename T, int kTile>
__global__ void __launch_bounds__(kThreads)
service_kernel(const T* __restrict__ bank, int R, int Lb, Fields f, int B,
               svc::Flags fl, fm::SeedRows seed, fm::Index ix,
               fm::Samples sa, fm::Isa isa, int* __restrict__ out) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int b = static_cast<int>(t / kTile);
  if (b >= B) return;  // a whole tile: the block is a multiple of it
  const fm::Consts k = fm::load_consts(ix);
  const svc::Cols c = svc::lane<T, SplitOf<kTile>>(
      bank, R, Lb, __ldg(f.opc + b), __ldg(f.row + b), __ldg(f.off + b),
      __ldg(f.ln + b), __ldg(f.sp + b), __ldg(f.ep + b), __ldg(f.idx + b), fl,
      seed, ix, k, sa, isa);
  if (kTile > 1 && svc::Tile<kTile>::rank() != 0) return;
  if (c.overrun) {
    fm::raise_flag(out + static_cast<size_t>(svc::kCols) * B, B, b);
  }
  int* o = out + b;
  const size_t Bs = static_cast<size_t>(B);
  o[0 * Bs] = c.mms_m;
  o[1 * Bs] = c.cont_m;
  o[2 * Bs] = c.start;
  o[3 * Bs] = c.end;
  o[4 * Bs] = c.osp;
  o[5 * Bs] = c.oep;
  o[6 * Bs] = c.nm;
  o[7 * Bs] = c.alive;
  o[8 * Bs] = c.skips;
  o[9 * Bs] = c.pos;
  o[10 * Bs] = c.crank;
  o[11 * Bs] = c.wbest;
  o[12 * Bs] = c.wrow;
}

// The round's tile: kSmallTile for a round of at most kTileLanes lanes.
int tile_of(int B) {
  if (BWT_SERVICE_TILE != 0) return BWT_SERVICE_TILE;
  return B <= kTileLanes ? kSmallTile : 1;
}

template <typename T, int kTile>
int launch(const T* bank, int R, int Lb, Fields f, int B, svc::Flags fl,
           fm::SeedRows seed, fm::Index ix, fm::Samples sa, fm::Isa isa,
           int* out, cudaStream_t s) {
  const long long threads = static_cast<long long>(B) * kTile;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  service_kernel<T, kTile><<<blocks, kThreads, 0, s>>>(
      bank, R, Lb, f, B, fl, seed, ix, sa, isa, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_round(const T* bank, int R, int Lb, Fields f, int B,
                 svc::Flags fl, fm::SeedRows seed, fm::Index ix,
                 fm::Samples sa, fm::Isa isa, int* out, cudaStream_t s) {
  switch (tile_of(B)) {
    case 1:
      return launch<T, 1>(bank, R, Lb, f, B, fl, seed, ix, sa, isa, out, s);
    case kSmallTile:
      return launch<T, kSmallTile>(bank, R, Lb, f, B, fl, seed, ix, sa, isa,
                                   out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// bank (R, Lb) of `elem`-byte codes (4: int32, 1: uint8); the seven lane
// fields (B,) int32; seed_rows (seed_nrows, 6) or null; isa_samples may
// be null when ext is 0; out (13 B + 2,) int32 with its last two entries
// zero.  All on the device, contiguous.  Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for an
// element size it has no kernel for.
extern "C" int service_launch(
    const void* bank, int elem, int R, int Lb, const int* opc, const int* row,
    const int* off, const int* ln, const int* sp, const int* ep,
    const int* idx, int B, int resolve, int ext, int walk,
    const int* seed_rows, int seed_nrows, int seed_k, const int* buckets,
    int nrows, const int* C, const int* endloc, const int* sa_samples,
    int nsamples, int shift, int length, const int* isa_samples, int nisa,
    int* out, void* stream) {
  if (B <= 0) return 0;
  const Fields f{opc, row, off, ln, sp, ep, idx};
  const fm::Index ix{buckets, nrows, C, endloc};
  const fm::Samples sa{sa_samples, nsamples, shift, length};
  const fm::Isa isa{isa_samples, nisa, shift, length};
  const fm::SeedRows seed{seed_rows, seed_nrows, seed_k};
  const svc::Flags fl{resolve != 0, ext != 0, walk != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem == 4) {
    return launch_round(static_cast<const int*>(bank), R, Lb, f, B, fl, seed,
                        ix, sa, isa, out, s);
  }
  if (elem == 1) {
    return launch_round(static_cast<const uint8_t*>(bank), R, Lb, f, B, fl,
                        seed, ix, sa, isa, out, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
