// K9: the whole rna_seq main loop (rnaseqtest.c:172-243) as one launch, one
// thread a read.
//
// Replaces bwt_tpu/models/rnaseq.py:_rna_seq_automaton, one jitted
// lax.while_loop there: every iteration issues one fused service op a live
// lane and moves a vectorized phase machine, in lockstep over the batch,
// with a ladder of compactions so that the stragglers run narrower.  The
// port's plain version is bwt_tpu_torch/ops/automaton.py:
// rna_seq_automaton_plain, the same phase machine in lockstep torch over
// the plain service round.  Here a thread keeps its read's (it, ph, i,
// res, cs, ce) in registers and runs the machine alone until its read is
// done or the cap:
//   ANCHOR, GAP, CONTC  bsearch over bank[b, 0 : i];
//   CONT1               bsearch_ext over bank[b, i - cc + 1 : i], with the
//                       window [res - cc - 6, res) (mms_continue's phase 1
//                       and its checkpoint scan);
//   CONT2               mms_continue_full over bank[b, 0 : i - cc + 1] from
//                       the interval CONT1 narrowed to;
// each through svc::lane (service_lane.cuh, the body of the service
// kernel K7) with the window scan on and the walk taken, on the thread's
// own bank row, and then the transition of the JAX body, line for line
// (the break path's pos + 1, nm >= i - 1 as a full match, the wrow >= 0
// narrowing).  A thread stops on its own, so the compaction ladder has no
// counterpart here.
//
// The cap (4 Lb + 64 iterations, or the caller's) is a bound with a flag:
// a read still live there has `capped` set, and the caller re-runs it on
// the host.  A walk from a row past the suffix array stops its thread,
// counts in the flag and keeps the earliest (iteration, lane) as one 64-bit
// key, (cap - it) << 32 | (R - b), so that the caller names the lane the
// lockstep plain version raises on; the lane's `res` then holds the row it
// walked from.
//
// Output: int32 res (R), capped (R), the iterations each read ran (R), then
// at F = 3 R rounded up to even the flag: the overrun count, a pad word, the
// 64-bit key; zeroed by the caller.
//
// What bounds it on the H100: one thread a read holds a chain of
// dependent 32-byte row loads, an iteration's search steps, then its walk
// and its window, and a warp runs as long as its slowest read; a chunk of
// 2^15 reads fills about an eighth of the card's resident threads, so the
// time is the longest chain, not the bytes.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <stddef.h>

#include "service_lane.cuh"

namespace {

constexpr int kThreads = 64;
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

__global__ void __launch_bounds__(kThreads)
rnaseq_automaton_kernel(const uint8_t* __restrict__ bank, int R, int Lb,
                        const int* __restrict__ lens,
                        const uint8_t* __restrict__ live0, int ac, int cc,
                        int resolve, int cap, fm::SeedRows seed,
                        fm::Index ix, fm::Samples sa, fm::Isa isa,
                        int* __restrict__ out, int* __restrict__ n_over,
                        unsigned long long* __restrict__ first_over) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= R) return;
  const fm::Consts k = fm::load_consts(ix);
  const svc::Flags fl{resolve != 0, true, true};
  int ph = __ldg(live0 + b) ? kAnchor : kDone;
  int i = __ldg(lens + b);
  int res = -1, cs = 0, ce = 0, it = 0;
  for (; ph != kDone && it < cap; ++it) {
    const bool c1 = ph == kCont1;
    const bool c2 = ph == kCont2;
    const int opc = c1 ? svc::kBext : c2 ? svc::kCont : svc::kBsearch;
    const int i_cc = fm::wadd(fm::wsub(i, cc), 1);  // i - cc + 1
    const svc::Cols o = svc::lane<uint8_t>(
        bank, R, Lb, opc, b, c1 ? i_cc : 0, c1 ? cc - 1 : c2 ? i_cc : i,
        c1 ? fm::wsub(fm::wsub(res, cc), 6) : c2 ? cs : 0,
        c1 ? cc + 6 : c2 ? ce : 0, 0, fl, seed, ix, k, sa, isa);
    if (o.overrun) {
      atomicAdd(n_over, 1);
      atomicMax(first_over,
                (static_cast<unsigned long long>(cap - it) << 32) |
                    static_cast<unsigned>(R - b));
      res = o.pos;
      break;
    }
    const bool alive = o.alive != 0;
    const Next fail = to_gap(i, ac, cc);
    if (ph == kAnchor) {
      // _eval_mms_search and the anchor hunt (rnaseqtest.c:197-201)
      const bool full = alive || o.nm >= fm::wsub(i, 1);
      const int mmspos = full ? o.pos
                         : fm::wadd(o.nm, 2) > ac ? fm::wadd(o.pos, 1) : -1;
      const int mmslen = full ? i : fm::wadd(o.nm, 3);
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
      cs = o.wrow >= 0 ? o.wrow : o.start;
      ce = o.wrow >= 0 ? fm::wadd(o.wrow, 1) : o.end;
      ph = alive ? kCont2 : fail.ph;
      i = alive ? i : fail.i;
    } else {
      // GAP, CONTC (_eval_mms_gap) and CONT2 (over i - cc + 1 characters)
      const int len = c2 ? i_cc : i;
      const bool ok = (alive || o.nm >= fm::wsub(len, 1)) && o.pos != -1;
      ph = ok ? kDone : fail.ph;
      i = ok ? 0 : fail.i;
    }
  }
  out[b] = res;
  out[R + b] = ph != kDone ? 1 : 0;
  out[2 * R + b] = it;
}

}  // namespace

// The flag's offset in `out` (see the head of the file).
extern "C" int rnaseq_automaton_flag_offset(int R) { return (3 * R + 1) & ~1; }

// bank (R, Lb) uint8 codes, one read a row; lens (R,) int32; live0 (R,)
// bool; seed_rows (seed_nrows, 6) or null; isa_samples (nisa,) int32; out
// (F + 4,) int32, F = rnaseq_automaton_flag_offset(R), with its last four
// entries zero.  All on the device, contiguous.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int rnaseq_automaton_launch(
    const uint8_t* bank, int R, int Lb, const int* lens, const uint8_t* live0,
    int ac, int cc, int resolve, int cap, const int* seed_rows,
    int seed_nrows, int seed_k, const int* buckets, int nrows, const int* C,
    const int* endloc, const int* sa_samples, int nsamples, int shift,
    int length, const int* isa_samples, int nisa, int* out, void* stream) {
  if (R <= 0) return 0;
  if (Lb <= 0 || isa_samples == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const fm::Index ix{buckets, nrows, C, endloc};
  const fm::Samples sa{sa_samples, nsamples, shift, length};
  const fm::Isa isa{isa_samples, nisa, shift, length};
  const fm::SeedRows seed{seed_rows, seed_nrows, seed_k};
  int* flag = out + rnaseq_automaton_flag_offset(R);
  const int blocks = (R + kThreads - 1) / kThreads;
  rnaseq_automaton_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      bank, R, Lb, lens, live0, ac, cc, resolve, cap, seed, ix, sa, isa, out,
      flag, reinterpret_cast<unsigned long long*>(flag + 2));
  return static_cast<int>(cudaGetLastError());
}
