// The whole anchor hunt of search_reads as one launch: a tile of threads per
// read runs the hunt's trips, then one thread of it the SA walk of the last
// anchor.
//
// Computes what bwt_tpu/models/exact.py:_anchor_scan_impl computes (a
// jitted lax.while_loop of trips, search_reads.c:115-133; the port's plain
// version is bwt_tpu_torch/models/exact.py:anchor_scan_plain), bit for
// bit.  While the prefix is longer than min_anchor: backward search with
// N resolution over the prefix (fm::search_lane, mode 0); m = nmatched +
// skips; m >= min_anchor is an anchor, which records the interval start
// and consumes m characters, anything else shrinks the prefix by one.  At
// the end the last anchor's row is walked to its position
// (fm::sa_walk); a read without an anchor gets -1.  All of it in wrapping
// int32 arithmetic: the prefix length goes negative after an all-N anchor.
//
// With `reverse` the tile reads its read plain-reversed (reversed, not
// complemented: search_reads.c:112-114), so the second direction of
// search_reads needs no second array.  Reads are int32, uint8 or int8
// codes (`elem` 4, 1, -1), widened here.
//
// The tile.  Once the prefix length `len` is known, the trips that the
// sequential loop runs while each before it misses are known too: trip q
// after q misses searches the prefix len - q.  So thread q of a tile of
// kTile threads (svc::Tile) runs that candidate, issued while
// len - q > min_anchor (the loop's own condition after q misses); a ballot
// over the tile finds the first candidate q* that anchors (or is stuck),
// every thread takes its (sp, m) by shuffle and steps len down by the q*
// misses and then by m, exactly as the sequential loop would; with none,
// len drops by the candidates issued.  Every thread of the tile keeps the
// read's (len, nmatch, anchor_sp) in registers, the same in each; the
// candidates after q* are discarded.  The plain version runs the same
// schedule at any width (exact.anchor_scan_plain(width=)).
//
// Two loops that never end in the lockstep version are bounded here, a
// thread that never returns being a hung card:
//   * a trip that is an anchor and consumes nothing (m <= 0, which needs
//     min_anchor <= 0) repeats forever: the tile stops and raises
//     flag[2], flag[3];
//   * a walk from a row past the suffix array (an anchor made of trailing
//     N's over an effective last character absent from the genome records
//     sp = C[c] = n + 1) stops at length + 1 steps and raises flag[0],
//     flag[1]; its position slot then holds the row, for the message.
//
// Output, one int32 array of 2B + 4: the anchor counts (B), the positions
// (B), then the flag, zeroed by the caller.
//
// What bounds it on the H100 (PERF.md; chip_smoke.py phase 7 times
// every tile, built apart with -DBWT_ANCHOR_TILE_FWD / _REV).  A read's
// trips are a chain of dependent row loads from L2, and a warp runs as long
// as its longest.  A plain-reversed read is no genome substring: nearly
// every trip misses after about log4(n) steps and shrinks the prefix by
// one, some 30 trips and 400 steps a read, which one thread a read ran one
// after another (0.2767 ms a search_reads chunk, a chain of 441 loads).
// The tile runs kTile of those trips side by side and issues no step the
// sequential loop would not: from kTile = 4 up the chain is no longer what
// sets the time, the chunk's 13 M steps are (their row loads and
// instructions, 0.14-0.18 ms at kTile = 4-32), and 16 was fastest.  A
// forward read from the genome anchors on its first trip, a 50-step search
// that the tile cannot shorten: there the other candidates are discarded
// work (kTile times the steps), so the forward launch keeps a thread a
// read, and so does a reversed one at a min_anchor short enough that its
// trips anchor (rare_anchor).  A candidate that leaves its search off once
// a lower one has anchored needs a ballot of the tile every step, and was
// measured slower than the plain tile in both directions.  So each launch
// takes its tile: kTileRev = 16 for a reversed hunt whose trips miss,
// kTileFwd = 1 for the others.

#include <climits>
#include <cuda_runtime.h>
#include <stddef.h>

#include "service_lane.cuh"

#ifndef BWT_ANCHOR_TILE_FWD
#define BWT_ANCHOR_TILE_FWD 1
#endif
#ifndef BWT_ANCHOR_TILE_REV
#define BWT_ANCHOR_TILE_REV 16
#endif

namespace {

// a chunk of 32,768 reads is 256 blocks at a thread a read, 4,096 at 16:
// every SM has work
constexpr int kThreads = 128;
constexpr int kTileFwd = BWT_ANCHOR_TILE_FWD;
constexpr int kTileRev = BWT_ANCHOR_TILE_REV;
static_assert(kThreads % 32 == 0, "a tile lies in one warp of one block");

template <int kTile, typename T, bool kTp>
__global__ void __launch_bounds__(kThreads)
anchor_scan_kernel(const T* __restrict__ patterns,
                   const int* __restrict__ lengths, int B, int L,
                   int min_anchor, int reverse, fm::IndexT<kTp> ix,
                   fm::SamplesT<kTp> sa, int* __restrict__ out) {
  using Tile = svc::Tile<kTile>;
  const size_t g = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= static_cast<size_t>(B) * kTile) return;  // whole tiles
  const int b = static_cast<int>(g / kTile);
  const int q = Tile::rank();
  // from global memory: a hunt reads its row dozens of times over, from
  // L1 after the first, and staging the rows was measured slower (PERF.md)
  fm::PatternView<T, false> pat(patterns, B, b, L);
  const fm::Consts k = fm::load_consts(ix);
  const int len0 = __ldg(lengths + b);
  if (reverse) pat.flip(len0);
  int* flag = out + 2 * static_cast<size_t>(B);
  const fm::SeedRows no_seed{nullptr, 0, 0};

  int len = len0, nmatch = 0, anchor_sp = 0;
  bool stuck = false;
  while (len > min_anchor) {  // len is the same in every thread of the tile
    // len - min_anchor, exact as an unsigned: it lies in [1, 2^32)
    const unsigned room =
        static_cast<unsigned>(len) - static_cast<unsigned>(min_anchor);
    const bool issued = room > static_cast<unsigned>(q);
    int m = 0, sp = 0;
    if (issued) {
      const fm::Lane r = fm::search_lane(ix, k, pat, fm::wsub(len, q), L,
                                         true, 0, 0, 0, no_seed);
      m = fm::wadd(r.nmatched, r.skips);
      sp = r.sp;
    }
    // a thread a read needs no collective
    const bool hit = issued && m >= min_anchor;
    const unsigned stop = kTile == 1 ? hit : Tile::ballot(hit);
    if (stop == 0) {
      len = fm::wsub(len, static_cast<int>(
                              min(room, static_cast<unsigned>(kTile))));
      continue;
    }
    const int qs = __ffs(stop) - 1;
    const int ms = kTile == 1 ? m : Tile::shfl(m, qs);
    len = fm::wsub(len, qs);
    if (ms <= 0) {
      stuck = true;
      break;
    }
    anchor_sp = kTile == 1 ? sp : Tile::shfl(sp, qs);
    ++nmatch;
    len = fm::wsub(len, ms);
  }
  if (q != 0) return;

  int pos = -1;
  if (stuck) {
    fm::raise_flag(flag + 2, B, b);
  } else if (nmatch > 0) {
    const fm::Walk w = fm::sa_walk(ix, k, sa, anchor_sp, sa.length + 1);
    pos = w.pos;
    if (w.unsampled) {
      fm::raise_flag(flag, B, b);
      pos = anchor_sp;
    }
  }
  out[b] = nmatch;
  out[B + b] = pos;
}

template <int kTile, typename T, bool kTp>
void launch_tile(const T* p, const int* lengths, int B, int L,
                 int min_anchor, int reverse, const fm::IndexArgs& ia,
                 const fm::TableArgs& sa, int shift, int length, int* out,
                 cudaStream_t s) {
  const size_t threads = static_cast<size_t>(B) * kTile;
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  anchor_scan_kernel<kTile, T, kTp><<<blocks, kThreads, 0, s>>>(
      p, lengths, B, L, min_anchor, reverse, fm::index_form<kTp>(ia),
      fm::samples_form<kTp>(sa, shift, length), out);
}

// Whether a random prefix of min_anchor characters rarely occurs in a genome
// of `length`: 4^min_anchor >= 16 (length + 1).  Then a plain-reversed read's
// trips nearly all miss and the tile pays (a search_reads chunk at
// min_anchor 20); where such a prefix often occurs (min_anchor 12 on a
// 2^25-base genome) its trips anchor like a forward read's, and the tile's
// candidates after the first are discarded work (PERF.md).
inline bool rare_anchor(int min_anchor, int length) {
  if (min_anchor < 2) return false;
  if (min_anchor >= 33) return true;
  return (1ull << (2 * (min_anchor - 2))) >=
         static_cast<unsigned long long>(length) + 1;
}

template <typename T, bool kTp>
void launch(const void* patterns, const int* lengths, int B, int L,
            int min_anchor, int reverse, const fm::IndexArgs& ia,
            const fm::TableArgs& sa, int shift, int length, int* out,
            cudaStream_t s) {
  const T* p = static_cast<const T*>(patterns);
  if (reverse && rare_anchor(min_anchor, length)) {
    launch_tile<kTileRev, T, kTp>(p, lengths, B, L, min_anchor, reverse, ia,
                                  sa, shift, length, out, s);
  } else {
    launch_tile<kTileFwd, T, kTp>(p, lengths, B, L, min_anchor, reverse, ia,
                                  sa, shift, length, out, s);
  }
}

template <bool kTp>
void launch_elem(const void* patterns, int elem, const int* lengths, int B,
                 int L, int min_anchor, int reverse, const fm::IndexArgs& ia,
                 const fm::TableArgs& sa, int shift, int length, int* out,
                 cudaStream_t s) {
  if (elem == 4) {
    launch<int, kTp>(patterns, lengths, B, L, min_anchor, reverse, ia, sa,
                     shift, length, out, s);
  } else if (elem == 1) {
    launch<unsigned char, kTp>(patterns, lengths, B, L, min_anchor, reverse,
                               ia, sa, shift, length, out, s);
  } else {
    launch<signed char, kTp>(patterns, lengths, B, L, min_anchor, reverse, ia,
                             sa, shift, length, out, s);
  }
}

}  // namespace

// patterns (B, L) of `elem`-typed codes (4: int32, 1: uint8, -1: int8) and
// lengths (B,) int32, contiguous, on the device; the index as
// fm::IndexArgs and the SA samples as fm::TableArgs (per > 0: a tp view);
// out (2B + 4,) int32 with its last four entries zero.  Launches on
// `stream` and returns cudaGetLastError() (0 on success), or -1 for an
// unknown `elem`.
extern "C" int anchor_scan_launch(
    const void* patterns, int elem, const int* lengths, int B, int L,
    int min_anchor, int reverse, const void* buckets, int nrows, int per,
    const int* C, const int* endloc, const void* sa_samples, int nsamples,
    int sa_per, int shift, int length, int* out, void* stream) {
  if (elem != 4 && elem != 1 && elem != -1) return -1;
  if (B <= 0) return 0;
  const fm::IndexArgs ia{buckets, nrows, per, C, endloc};
  const fm::TableArgs sa{sa_samples, nsamples, sa_per};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (per > 0) {
    launch_elem<true>(patterns, elem, lengths, B, L, min_anchor, reverse, ia,
                      sa, shift, length, out, s);
  } else {
    launch_elem<false>(patterns, elem, lengths, B, L, min_anchor, reverse, ia,
                       sa, shift, length, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}
