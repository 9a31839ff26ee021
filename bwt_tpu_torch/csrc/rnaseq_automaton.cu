// K9: the whole rna_seq main loop (rnaseqtest.c:172-243) as one launch, a
// tile of kTile threads a read.
//
// Replaces bwt_tpu/models/rnaseq.py:_rna_seq_automaton, one jitted
// lax.while_loop there: every iteration issues one fused service op a live
// lane and moves a vectorized phase machine, in lockstep over the batch,
// with a ladder of compactions so that the stragglers run narrower.  The
// port's plain version is bwt_tpu_torch/ops/automaton.py:
// rna_seq_automaton_plain, the same phase machine in lockstep torch over
// the plain service round, at any tile width.  Here every thread of a
// read's tile keeps the read's (it, ph, i, res, cs, ce) in registers, the
// same in each, and the tile runs the machine alone until its read is done
// or the cap:
//   ANCHOR, GAP, CONTC  bsearch over bank[b, 0 : i];
//   CONT1               bsearch_ext over bank[b, i - cc + 1 : i], with the
//                       window [res - cc - 6, res) (mms_continue's phase 1
//                       and its checkpoint scan);
//   CONT2               mms_continue_full over bank[b, 0 : i - cc + 1] from
//                       the interval CONT1 narrowed to;
// each through svc::lane (service_lane.cuh, the body of the service
// kernel K7) with the window scan on and the walk taken, on the read's
// own bank row, and then the transition of the JAX body, line for line
// (the break path's pos + 1, nm >= i - 1 as a full match, the wrow >= 0
// narrowing).  A tile stops on its own, so the compaction ladder has no
// counterpart here.
//
// What bounds it on the H100, and what the tile does about it.  A read's
// iterations are a chain of dependent 32-byte row loads (its search steps,
// then its walk and its window), and a warp waits each iteration for its
// threads' longest search, longest walk and longest window, so the time is
// the longest warp's chain, not the bytes (chip_smoke.py counts both).  A
// tile of kTile threads a read puts 32 / kTile reads in a warp, not 32.  A
// read's longest links are the two hunts, the anchor hunt and
// the gap hunt, each a run of searches of bank[b, 0 : i] with i stepping
// down by one while nothing is found and i > ac, whose inputs are known up
// front.  So in a hunt thread q of the tile searches at i - q while the
// hunt would still go on and under the cap; a ballot finds the first
// search the sequential loop stops at (a find, an exhausted hunt, a walk
// that overran), else the last one; every thread takes its columns by
// shuffle, steps i and it over the searches before it and moves the state
// by its transition.  The searches after it are discarded: they write
// nothing, touch no atomic and skip their walks (the gate).  A thread with
// no search costs its warp the same issue slots as one with a search, so
// a hunt issues all the searches it can (its first search alone was
// measured slower).  CONT1 -> CONT2 -> CONTC stay one
// iteration a round, each depending on the last, but CONT1's window scan,
// up to rate - 1 + 16 dependent LF steps, is cut into kTile slices: every
// thread runs the same request and chains its own slice from the sample
// above it, and the tile takes the least row (svc::TileSplit).  The tile's
// collectives are warp intrinsics on its lane mask (svc::Tile).
//
// The cap (4 Lb + 64 iterations, or the caller's) is a bound with a flag:
// a read still live there has `capped` set, and the caller re-runs it on
// the host; no search is issued at or past the cap.  A walk from a row past
// the suffix array, in the search taken, stops its read, counts in the
// flag and keeps the earliest (iteration, lane) as one 64-bit key,
// (cap - it) << 32 | (R - b), it the sequential iteration, so that the
// caller names the lane the lockstep plain version raises on; the lane's
// `res` then holds the row it walked from.
//
// Output: int32 res (R), capped (R), the iterations each read ran (R), then
// at F = 3 R rounded up to even the flag: the overrun count, a pad word, the
// 64-bit key; zeroed by the caller.  kTile is svc::kAutomatonTile, 4.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <stddef.h>

#include "service_lane.cuh"

namespace {

constexpr int kThreads = 64;
// blocks an SM the kernel is built for: 1,024 threads, a 2^15-read chunk's
// tiles of 4 in one wave, at most 64 registers a thread (without the bound
// ptxas holds the tiled forms at 56 and spills 2 bytes to a stack frame)
constexpr int kMinBlocks = 16;
// the threads a read; a tile never spans two blocks
constexpr int kTile = svc::kAutomatonTile;
static_assert(kThreads % kTile == 0, "a tile lies in one block");
using Tile = svc::Tile<kTile>;
constexpr int kGiveUp = 18;  // the main loop's hardcoded while (i > 18)

// the phases of bwt_tpu/models/rnaseq.py
enum Phase { kDone = 0, kAnchor = 1, kCont1 = 2, kContC = 3, kCont2 = 4,
             kGap = 5 };

struct Next {
  int ph, i;
};

// while (i > 18) and the i -= 3 continuation entry (rnaseqtest.c:209-219)
__device__ __forceinline__ Next outer(int x, int cc) {
  const int y = fm::wsub(x, 3);
  if (x > kGiveUp) return Next{y < cc ? kContC : kCont1, y};
  return Next{kDone, x};
}

// the gap hunt: while (i > ac) { --i; mms_gap } (rnaseqtest.c:227-236)
__device__ __forceinline__ Next to_gap(int x, int ac, int cc) {
  if (x > ac) return Next{kGap, fm::wsub(x, 1)};
  return outer(x, cc);
}

// The tile's gate in a hunt: the searches after the first one the
// sequential loop stops at, known from its own search (a find, or i down
// to ac), skip their walks.  Every thread of the tile calls it.
struct HuntGate {
  bool on;      // an ANCHOR, GAP or CONTC round
  bool issued;  // this thread's search is one
  bool anchor;  // an ANCHOR round (its break path finds on nm + 2 > ac)
  int q, i_q, ac;
  __device__ __forceinline__ bool operator()(const fm::Lane& r, int) const {
    if (!on) return true;
    // a walk's position is never -1, so a find is known before the walk
    const bool found = r.alive || r.nmatched >= fm::wsub(i_q, 1) ||
                       (anchor && fm::wadd(r.nmatched, 2) > ac);
    const unsigned first =
        Tile::ballot(issued && (found || i_q <= ac));
    return first == 0 || q < __ffs(first);
  }
};

template <bool kTp>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rnaseq_automaton_kernel(const uint8_t* __restrict__ bank, int R, int Lb,
                        const int* __restrict__ lens,
                        const uint8_t* __restrict__ live0, int ac, int cc,
                        int resolve, int cap, fm::SeedRows seed,
                        fm::IndexT<kTp> ix, fm::SamplesT<kTp> sa,
                        fm::IsaT<kTp> isa,
                        int* __restrict__ out, int* __restrict__ n_over,
                        unsigned long long* __restrict__ first_over) {
  const int q = Tile::rank();
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) / kTile;
  if (b >= R) return;  // the whole tile: kTile divides kThreads
  const fm::Consts k = fm::load_consts(ix);
  const svc::Flags fl{resolve != 0, true, true};
  const svc::TileSplit<kTile> split{};
  int ph = __ldg(live0 + b) ? kAnchor : kDone;
  int i = __ldg(lens + b);
  int res = -1, cs = 0, ce = 0, it = 0;
  for (; ph != kDone && it < cap; ++it) {
    const bool c1 = ph == kCont1;
    const bool c2 = ph == kCont2;
    const bool hunting = !c1 && !c2;  // ANCHOR, GAP, CONTC
    // search q of a hunt: reached if the q before it found nothing with
    // i - p > ac, and under the cap; CONT1's request is every thread's
    const bool issued =
        (q == 0 || (hunting && i - q + 1 > ac)) && it + q < cap;
    const int i_q = hunting ? i - q : i;
    const int opc = c1 ? svc::kBext : c2 ? svc::kCont : svc::kBsearch;
    const int i_cc = fm::wadd(fm::wsub(i, cc), 1);  // i - cc + 1
    svc::Cols o;
    o.start = o.end = o.nm = o.alive = o.pos = 0;
    o.wrow = -1;
    o.overrun = false;
    bool stop = true;
    if (hunting || c1 || q == 0) {
      // in a hunt every thread calls the lane body (the gate is the
      // tile's), one with no search asking for nothing; CONT1's request is
      // every thread's (the window's slices); CONT2's thread 0's
      const HuntGate gate{hunting, issued, ph == kAnchor, q, i_q, ac};
      o = svc::lane<uint8_t>(
          bank, R, Lb, issued || c1 ? opc : svc::kNone, b, c1 ? i_cc : 0,
          c1 ? cc - 1 : c2 ? i_cc : i_q,
          c1 ? fm::wsub(fm::wsub(res, cc), 6) : c2 ? cs : 0,
          c1 ? cc + 6 : c2 ? ce : 0, 0, fl, seed, ix, k, sa, isa, split,
          gate);
      if (hunting) {
        // a hunt goes on while nothing is found and i > ac: for ANCHOR
        // mmspos == -1, for GAP and CONTC a failed _eval_mms_gap
        const bool full = o.alive != 0 || o.nm >= fm::wsub(i_q, 1);
        const int found =
            full ? o.pos
            : (ph == kAnchor && fm::wadd(o.nm, 2) > ac) ? fm::wadd(o.pos, 1)
                                                        : -1;
        stop = o.overrun || found != -1 || i_q <= ac;
      }
    }
    // the first search the sequential loop stops at, else the last
    const unsigned stops = Tile::ballot(issued && stop);
    const int qs = stops ? __ffs(stops) - 1
                         : 31 - __clz(Tile::ballot(issued));
    const int start = Tile::shfl(o.start, qs);
    const int end = Tile::shfl(o.end, qs);
    const int nm = Tile::shfl(o.nm, qs);
    const bool alive = Tile::shfl(o.alive, qs) != 0;
    const int pos = Tile::shfl(o.pos, qs);
    const int wrow = Tile::shfl(o.wrow, qs);
    const bool overrun = Tile::shfl(o.overrun ? 1 : 0, qs) != 0;
    // the state after the qs searches that found nothing before it
    i = fm::wsub(i, qs);
    it += qs;
    if (overrun) {
      if (q == 0) {
        atomicAdd(n_over, 1);
        atomicMax(first_over,
                  (static_cast<unsigned long long>(cap - it) << 32) |
                      static_cast<unsigned>(R - b));
      }
      res = pos;
      break;
    }
    const Next fail = to_gap(i, ac, cc);
    if (ph == kAnchor) {
      // _eval_mms_search and the anchor hunt (rnaseqtest.c:197-201)
      const bool full = alive || nm >= fm::wsub(i, 1);
      const int mmspos = full ? pos
                         : fm::wadd(nm, 2) > ac ? fm::wadd(pos, 1) : -1;
      const int mmslen = full ? i : fm::wadd(nm, 3);
      if (mmspos == -1 && i > ac) {
        i = fm::wsub(i, 1);
      } else {
        const Next a = outer(fm::wsub(i, mmslen), cc);
        ph = a.ph;
        i = a.i;
        res = mmspos;
      }
    } else if (c1) {
      // mms_continue's phase 1: a dead interval fails to the gap hunt,
      // else narrow to the window's row when there is one
      cs = wrow >= 0 ? wrow : start;
      ce = wrow >= 0 ? fm::wadd(wrow, 1) : end;
      ph = alive ? kCont2 : fail.ph;
      i = alive ? i : fail.i;
    } else {
      // GAP, CONTC (_eval_mms_gap) and CONT2 (over i - cc + 1 characters)
      const int len = c2 ? i_cc : i;
      const bool ok = (alive || nm >= fm::wsub(len, 1)) && pos != -1;
      ph = ok ? kDone : fail.ph;
      i = ok ? 0 : fail.i;
    }
  }
  if (q != 0) return;
  out[b] = res;
  out[R + b] = ph != kDone ? 1 : 0;
  out[2 * R + b] = it;
}

// Launch the kernel at kTile threads a read.
template <bool kTp>
int launch(const uint8_t* bank, int R, int Lb, const int* lens,
           const uint8_t* live0, int ac, int cc, int resolve, int cap,
           fm::SeedRows seed, const fm::IndexArgs& ia,
           const fm::TableArgs& sa, const fm::TableArgs& isa, int shift,
           int length, int* out, int* flag, cudaStream_t stream) {
  const long long threads = static_cast<long long>(R) * kTile;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  rnaseq_automaton_kernel<kTp><<<blocks, kThreads, 0, stream>>>(
      bank, R, Lb, lens, live0, ac, cc, resolve, cap, seed,
      fm::index_form<kTp>(ia), fm::samples_form<kTp>(sa, shift, length),
      fm::isa_form<kTp>(isa, shift, length), out, flag,
      reinterpret_cast<unsigned long long*>(flag + 2));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The flag's offset in `out` (see the head of the file).
extern "C" int rnaseq_automaton_flag_offset(int R) { return (3 * R + 1) & ~1; }

// bank (R, Lb) uint8 codes, one read a row; lens (R,) int32; live0 (R,)
// bool; seed_rows (seed_nrows, 6) or null; the index as fm::IndexArgs and
// the SA and ISA samples as fm::TableArgs (per > 0: a tp view); out
// (F + 4,) int32, F = rnaseq_automaton_flag_offset(R), with its last four
// entries zero.  All on the device, contiguous.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int rnaseq_automaton_launch(
    const uint8_t* bank, int R, int Lb, const int* lens, const uint8_t* live0,
    int ac, int cc, int resolve, int cap, const int* seed_rows,
    int seed_nrows, int seed_k, const void* buckets, int nrows, int per,
    const int* C, const int* endloc, const void* sa_samples, int nsamples,
    int sa_per, int shift, int length, const void* isa_samples, int nisa,
    int isa_per, int* out, void* stream) {
  if (R <= 0) return 0;
  if (Lb <= 0 || isa_samples == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const fm::IndexArgs ia{buckets, nrows, per, C, endloc};
  const fm::TableArgs sa{sa_samples, nsamples, sa_per};
  const fm::TableArgs isa{isa_samples, nisa, isa_per};
  const fm::SeedRows seed{seed_rows, seed_nrows, seed_k};
  int* flag = out + rnaseq_automaton_flag_offset(R);
  const auto st = static_cast<cudaStream_t>(stream);
  return per > 0 ? launch<true>(bank, R, Lb, lens, live0, ac, cc, resolve,
                                cap, seed, ia, sa, isa, shift, length, out,
                                flag, st)
                 : launch<false>(bank, R, Lb, lens, live0, ac, cc, resolve,
                                 cap, seed, ia, sa, isa, shift, length, out,
                                 flag, st);
}
