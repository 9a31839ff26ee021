// K10: the aligner's whole per-read control flow (align_read_anchored,
// single_align.c:163-298, on its inverse-SA path, and the main loop's forward /
// reverse retry, :483-503) as one launch, a tile of kTile threads a read.
//
// Replaces bwt_tpu/models/aligner.py:_align_automaton, one jitted
// lax.while_loop there: every iteration issues one fused service op a live
// lane and moves a vectorized phase machine in lockstep over the batch, with
// a ladder of compactions so that the stragglers run narrower.  The port's
// plain version is bwt_tpu_torch/ops/automaton.py:align_automaton_plain, the
// same phase machine in lockstep torch over the plain service round, at any
// tile width.  Here every thread of a read's tile keeps the read's phase
// state (it, ph, strand, ln, am, nm, curpos, anchlen, g, lp, mode, ovf) in
// registers, the same in each, and the tile runs the machine alone until the
// read is done or the cap:
//   ANCH  mms over bank[2b + strand, 0 : ln] (the anchor hunt);
//   EXT   mms_ext over bank[2b + strand, 0 : ln - g] with curpos and curgap
//         g (one curgap attempt of the backward extension);
//   HEAD  no request: the head stitch is recorded;
// each through svc::lane (service_lane.cuh, the body of the service kernel
// K7) with the window scan on and the walk taken, and then the transition of
// the JAX body, line for line (the retry budgets, the RESET of
// single_align.c:274-276, the UB-pinned wrap of ln - g, the head with
// ln == 0, the strand retry guarded by the entry condition).  A tile stops
// on its own, so the compaction ladder has no counterpart here.
//
// What bounds it on the H100, and what the tile does about it.  A read's
// iterations are a chain of dependent 32-byte row loads (its search steps,
// its walk, its window), and a warp waits each iteration for its threads'
// longest search, walk and window; the kernel runs as long as its longest
// warp's chain or, on a full chunk, as long as the SMs take to issue every
// warp's instructions, whichever is more: not the bytes (chip_smoke.py
// counts the chains).  A tile of kTile threads a read puts 32 / kTile
// reads in a warp, not 32.  The longest chains are hunts, searches that
// the sequential loop runs one after another although their inputs are
// known up front: an anchor miss retries at ln - 3 with one miss less, a
// rejected curgap tries g + 1 with the same curpos (a false anchor's nine
// curgaps and RESET make the longest reads).  So thread q of the tile runs
// candidate q of the round, the iteration the sequential loop would run q
// iterations on if each before it missed (ANCH: ln - 3q, am - q) or
// rejected (EXT: curgap g + q), while the hunt condition, the nine curgaps
// and the cap allow; a ballot finds the first candidate that the loop
// stops at (a hit,
// an accept, an exhausted hunt, a walk that overran), else the last one;
// every thread takes that candidate's columns by shuffle, steps the state
// over the failed candidates before it (ln -= 3 q*, am -= q*; g += q*; it
// += q*) and then moves it by that candidate's transition, exactly as the
// sequential loop would.  The candidates after it are discarded: they write
// nothing and touch no atomic, and an anchor retry's skip their walks (the
// gate).  Each candidate scans its own window.  The tile shortens a hunt's
// chain by up to kTile - 1 iterations a round; on a full chunk it also
// makes four times the warps, and their instructions, not the chain, set
// the time (PERF.md).  A thread with no candidate costs its warp the
// same issue slots as one with a candidate, so every round issues all the
// candidates it can: issuing a hunt's first attempt alone was measured no
// faster.

// The stitch log: at most two entries an iteration (a stitch, then the M
// push after it), written by thread 0 of the tile straight into the read's
// rows of the output, never held in a local array (which would be a stack
// frame).  Each value is kept as bwt_tpu's narrow column keeps it: roffs,
// rlens and glens wrap as int16; a write past slot 15 is dropped and ovf
// set; a RESET rewinds lp and clears ovf.  The tile zeroes the read's 16
// slots first, so the rows equal the plain version's, stale slots included.
//
// The cap (8 Lb + 64 iterations, or the caller's) is a bound with a flag: a
// read still live there has `capped` set, and the caller re-runs it on the
// host; no candidate is issued at or past the cap, so a cap inside a round
// leaves the state of the sequential run.  Only an ANCH lane walks from a
// real row (mms_ext and HEAD lanes walk from row 0, which is sampled); a
// walk from a row past the suffix array, in the candidate taken, stops its
// read, counts in the flag and keeps the earliest (iteration, lane) as one
// 64-bit key, (cap - it) << 32 | (Bp - b), it the sequential iteration, so
// that the caller names the lane the lockstep plain version raises on; the
// lane's `curpos` then holds the row it walked from.
//
// Output (int32, align_log.cuh's layout): the columns mode, curpos, strand,
// lp, ovf, capped, iters (Bp each), then the log columns kinds, roffs,
// rlens, glens, gstarts (Bp x 16 each), then at alog::flag_offset(Bp) the
// flag: the overrun count, a pad word, the 64-bit key; zeroed by the
// caller.  kTile is svc::kAutomatonTile, 4.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <stddef.h>

#include "align_log.cuh"
#include "service_lane.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kLogN = alog::kLogN;
// the threads a read; a tile never spans two blocks
constexpr int kTile = svc::kAutomatonTile;
static_assert(kThreads % kTile == 0, "a tile lies in one block");
using Tile = svc::Tile<kTile>;

// the phases of bwt_tpu/models/aligner.py
enum Phase { kFail = -1, kDone = 0, kAnch = 1, kExt = 2, kHead = 3 };

// an int32 value as an int16 column keeps it
__device__ __forceinline__ int wrap16(int x) {
  const int v = x & 0xFFFF;
  return v >= 32768 ? v - 65536 : v;
}

// One read's 16 log slots: column c of slot s at c * stride + s.
struct Log {
  int* base;
  size_t stride;
  __device__ __forceinline__ void put(int s, int kind, int roff, int rlen,
                                      int glen, int gstart) const {
    base[s] = kind;
    base[stride + s] = wrap16(roff);
    base[2 * stride + s] = wrap16(rlen);
    base[3 * stride + s] = wrap16(glen);
    base[4 * stride + s] = gstart;
  }
};

// The tile's gate in an anchor hunt: the candidates after the first one
// the sequential loop stops at, known from its search (a hit or an
// exhausted hunt), skip their walks.  Every thread of the tile calls it.
struct HuntGate {
  bool on;      // an ANCH round
  bool issued;  // this thread's candidate is one
  int q, ln_q, am_q, anchor_len;
  __device__ __forceinline__ bool operator()(const fm::Lane& r,
                                             int skips) const {
    if (!on) return true;
    const bool miss = fm::wadd(r.nmatched, skips) < anchor_len ||
                      r.ep - r.sp > 1;
    const bool stops =
        issued && !(miss && ln_q - 3 > anchor_len && am_q - 1 > 0);
    const unsigned first = Tile::ballot(stops);
    return first == 0 || q < __ffs(first);
  }
};

template <bool kTp>
__global__ void __launch_bounds__(kThreads)
align_automaton_kernel(const uint8_t* __restrict__ bank, int Bp, int Lb,
                       const int* __restrict__ lens,
                       const uint8_t* __restrict__ live0, int glen,
                       int anchor_len, int resolve, int cap,
                       fm::SeedRows seed, fm::IndexT<kTp> ix,
                       fm::SamplesT<kTp> sa, fm::IsaT<kTp> isa,
                       int* __restrict__ out,
                       int* __restrict__ n_over,
                       unsigned long long* __restrict__ first_over) {
  const int q = Tile::rank();
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) / kTile;
  if (b >= Bp) return;  // the whole tile: kTile divides kThreads
  const fm::Consts k = fm::load_consts(ix);
  const svc::Flags fl{resolve != 0, true, true};
  const Log log{out + alog::log_col(alog::kKinds, Bp) + (size_t)b * kLogN,
                (size_t)kLogN * Bp};
  for (int s = q; s < kLogN; s += kTile) log.put(s, 0, 0, 0, 0, 0);

  const int olen = __ldg(lens + b);
  const int am0 = olen / 10;  // the anchmisses budget (single_align.c:170)
  const bool can = olen > anchor_len && am0 > 0;
  int ph = (__ldg(live0 + b) && can) ? kAnch : kDone;
  int strand = 0, ln = olen, am = am0, nm = 0, curpos = -1, anchlen = 0;
  int g = 0, lp = 0, mode = 0;
  bool ovf = false;
  int it = 0;
  for (; ph != kDone && it < cap; ++it) {
    const bool is_anch = ph == kAnch;
    const bool is_ext = ph == kExt;
    // candidate q: reached if the q before it miss with the hunt going on
    // (ANCH) or reject with curgaps left (EXT), and under the cap
    const bool issued =
        (q == 0 || (is_anch && ln - 3 * q > anchor_len && am - q > 0) ||
         (is_ext && g + q < 10)) &&
        it + q < cap;
    const int ln_q = is_anch ? ln - 3 * q : ln;
    const int g_q = g + q;
    svc::Cols o;
    o.mms_m = o.osp = o.oep = o.pos = 0;
    o.wbest = -1;
    o.overrun = false;
    bool stop = true;
    if (is_anch || is_ext) {
      // every thread calls the lane body (the gate is the tile's); one
      // with no candidate asks for nothing
      const HuntGate gate{is_anch, issued, q, ln_q, am - q, anchor_len};
      o = svc::lane<uint8_t>(
          bank, 2 * Bp, Lb,
          !issued ? svc::kNone : is_anch ? svc::kMms : svc::kMext,
          2 * b + strand, 0, is_anch ? ln_q : ln_q - g_q,
          is_ext ? curpos : 0, is_ext ? g_q : 0, 0, fl, seed, ix, k, sa,
          isa, svc::NoSplit(), gate);
      const bool goes_on =
          is_anch ? (o.mms_m < anchor_len || o.oep - o.osp > 1) &&
                        ln_q - 3 > anchor_len && am - q - 1 > 0
                  : (o.osp >= o.oep || o.wbest < 0 ||
                     abs(o.wbest + o.mms_m - curpos) - g_q > 3) &&
                        g_q + 1 < 10;
      stop = o.overrun || !goes_on;
    }
    // the first candidate the sequential loop stops at, else the last
    const unsigned stops = Tile::ballot(issued && stop);
    const int qs = stops ? __ffs(stops) - 1
                         : 31 - __clz(Tile::ballot(issued));
    const int seglen = Tile::shfl(o.mms_m, qs);
    const int osp = Tile::shfl(o.osp, qs);
    const int oep = Tile::shfl(o.oep, qs);
    const int pos = Tile::shfl(o.pos, qs);
    const int wbest = Tile::shfl(o.wbest, qs);
    const bool overrun = Tile::shfl(o.overrun ? 1 : 0, qs) != 0;
    // the state after the qs candidates that failed before it
    if (is_anch) {
      ln -= 3 * qs;
      am -= qs;
    } else if (is_ext) {
      g += qs;
    }
    it += qs;
    if (overrun) {
      if (q == 0) {
        atomicAdd(n_over, 1);
        atomicMax(first_over,
                  (static_cast<unsigned long long>(cap - it) << 32) |
                      static_cast<unsigned>(Bp - b));
      }
      curpos = pos;
      break;
    }

    // this iteration's log entries and next state, by phase
    bool w0 = false, w1 = false, reset = false;
    int k0 = 0, r0 = 0, l0 = 0, gl0 = 0, gs0 = 0;
    int ph2, ln2 = ln, am2 = am, nm2 = nm, cp2 = curpos, al2 = anchlen;
    int g2 = g, mode2 = mode;
    if (is_anch) {
      // one mms of pattern[:ln] (single_align.c:174-189)
      const bool miss = seglen < anchor_len || oep - osp > 1;
      const bool hunt = ln - 3 > anchor_len && am - 1 > 0;  // retry budget
      const int a_ln = ln - seglen;
      const int a_nm = olen / 5;
      const int buflen0 = 10 + (olen - ln);  // 10 + the tail beyond it
      const int a_buf =
          buflen0 + pos + seglen > glen ? glen - pos - seglen : buflen0;
      const int a_rlen = olen - ln;
      const bool low = a_nm < 1;  // olen < 5: if (nmisses < 1) continue;
      const bool re = a_ln > anchor_len && am > 0;
      const bool ext_c = a_ln > a_nm && a_ln > 4;
      w0 = !miss && a_rlen != 0;
      w1 = !miss;
      k0 = alog::kNw;
      r0 = ln;
      l0 = a_rlen;
      gl0 = max(a_buf, 0);
      gs0 = pos + seglen;
      ph2 = miss  ? (hunt ? kAnch : kFail)
            : low ? (re ? kAnch : kFail)
                  : (ext_c ? kExt : kHead);
      ln2 = miss ? ln - 3 : a_ln;
      am2 = miss ? am - 1 : am;
      nm2 = (miss || low) ? 0 : a_nm;
      cp2 = miss ? curpos : pos;
      al2 = miss ? anchlen : seglen;
      g2 = ph2 == kExt ? 1 : g;
    } else if (is_ext) {
      // one curgap attempt (single_align.c:224-247)
      const bool rej =
          osp >= oep || wbest < 0 || abs(wbest + seglen - curpos) - g > 3;
      const bool more = g + 1 < 10;
      const int e_nm = nm - g;
      const int e_buf = curpos - (wbest + seglen);
      const bool neg = e_buf < 0;
      const int st0 = ln - g;
      const int st = st0 < 0 ? st0 + olen : st0;  // the UB-pinned wrap
      const int e_rl = max(ln - st, 0);
      const int e_ln = ln - (seglen + g);
      const bool ext_c = e_ln > e_nm && e_ln > 4 && e_nm > 0;
      // RESET (single_align.c:274-276): ln -= anchlen; anchmisses -=
      // anchlen / 10; s.reset(); the outer loop's test
      const int r_am = am - anchlen / 10;
      const int rr_ln = ln - anchlen;    // after a rejected last curgap
      const int ra_ln = e_ln - anchlen;  // after an accept with nm <= 0
      const bool rr_ok = rr_ln > anchor_len && r_am > 0;
      const bool ra_ok = ra_ln > anchor_len && r_am > 0;
      w0 = !rej;
      w1 = !rej;
      k0 = neg ? alog::kI : alog::kSw;
      r0 = neg ? 0 : st;
      l0 = neg ? 0 : e_rl;
      gl0 = abs(e_buf);
      gs0 = neg ? 0 : wbest + seglen;
      ph2 = rej     ? (more ? kExt : rr_ok ? kAnch : kFail)
            : ext_c ? kExt
            : e_nm > 0 ? kHead
                       : (ra_ok ? kAnch : kFail);
      reset = (rej && !more) || (!rej && !ext_c && e_nm <= 0);
      ln2 = rej ? (more ? ln : rr_ln) : (ext_c || e_nm > 0) ? e_ln : ra_ln;
      am2 = (rej && !more) ? r_am : (reset && !rej) ? r_am : am;
      nm2 = rej ? (more ? nm : 0) : reset ? 0 : e_nm;
      cp2 = rej ? curpos : wbest;
      g2 = (rej && more) ? g + 1 : 1;
    } else {
      // HEAD: record the head stitch (single_align.c:256-272); ln == 0
      // short-circuits to a known result
      const int h_buf = min(ln + 10, curpos);
      w0 = ln > 0;
      k0 = alog::kHead;
      l0 = ln;
      gl0 = h_buf;
      gs0 = curpos - h_buf;
      ph2 = (ln > 0 || curpos != 0) ? kDone : kFail;
      mode2 = ln > 0 ? 1 : curpos != 0 ? 2 : 0;
    }

    const int s1 = lp + (w0 ? 1 : 0);
    if (q == 0) {
      if (w0 && lp < kLogN) log.put(lp, k0, r0, l0, gl0, gs0);
      if (w1 && s1 < kLogN) log.put(s1, alog::kM, 0, 0, seglen, 0);
    }
    lp = s1 + (w1 ? 1 : 0);
    ovf = ovf || lp > kLogN;
    if (reset) {
      lp = 0;
      ovf = false;
    }
    if (ph2 == kFail && strand == 0) {
      // the forward strand failed: start over on the reverse row, when the
      // entry condition holds
      ph = can ? kAnch : kDone;
      strand = 1;
      ln = olen;
      am = am0;
      nm = 0;
      curpos = -1;
      anchlen = 0;
      g = 0;
      lp = 0;
      ovf = false;
      mode = mode2;
    } else {
      ph = ph2 == kFail ? kDone : ph2;
      ln = ln2;
      am = am2;
      nm = nm2;
      curpos = cp2;
      anchlen = al2;
      g = g2;
      mode = ph2 == kFail ? 0 : mode2;
    }
  }
  if (q != 0) return;
  out[alog::col(alog::kMode, Bp) + b] = mode;
  out[alog::col(alog::kCurpos, Bp) + b] = curpos;
  out[alog::col(alog::kStrand, Bp) + b] = strand;
  out[alog::col(alog::kLp, Bp) + b] = lp;
  out[alog::col(alog::kOvf, Bp) + b] = ovf ? 1 : 0;
  out[alog::col(alog::kCapped, Bp) + b] = ph != kDone ? 1 : 0;
  out[alog::col(alog::kIters, Bp) + b] = it;
}

// Launch the kernel at kTile threads a read.
template <bool kTp>
int launch(const uint8_t* bank, int Bp, int Lb, const int* lens,
           const uint8_t* live0, int glen, int anchor_len, int resolve,
           int cap, fm::SeedRows seed, const fm::IndexArgs& ia,
           const fm::TableArgs& sa, const fm::TableArgs& isa, int shift,
           int length, int* out, cudaStream_t stream) {
  int* flag = out + alog::flag_offset(Bp);
  const long long threads = static_cast<long long>(Bp) * kTile;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  align_automaton_kernel<kTp><<<blocks, kThreads, 0, stream>>>(
      bank, Bp, Lb, lens, live0, glen, anchor_len, resolve, cap, seed,
      fm::index_form<kTp>(ia), fm::samples_form<kTp>(sa, shift, length),
      fm::isa_form<kTp>(isa, shift, length), out, flag,
      reinterpret_cast<unsigned long long*>(flag + 2));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bank (2 Bp, Lb) uint8 codes, read b's forward strand at row 2b and its
// reverse complement at 2b + 1; lens (Bp,) int32; live0 (Bp,) bool; seed_rows
// (seed_nrows, 6) or null; the index as fm::IndexArgs and the SA and ISA
// samples as fm::TableArgs (per > 0: a tp view); out (F + 4,) int32, F =
// alog::flag_offset(Bp), with its last four entries zero.  All on the
// device, contiguous.  Launches on `stream` and returns cudaGetLastError()
// (0 on success).
extern "C" int align_automaton_launch(
    const uint8_t* bank, int Bp, int Lb, const int* lens, const uint8_t* live0,
    int glen, int anchor_len, int resolve, int cap, const int* seed_rows,
    int seed_nrows, int seed_k, const void* buckets, int nrows, int per,
    const int* C, const int* endloc, const void* sa_samples, int nsamples,
    int sa_per, int shift, int length, const void* isa_samples, int nisa,
    int isa_per, int* out, void* stream) {
  if (Bp <= 0) return 0;
  if (Lb <= 0 || isa_samples == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const fm::IndexArgs ia{buckets, nrows, per, C, endloc};
  const fm::TableArgs sa{sa_samples, nsamples, sa_per};
  const fm::TableArgs isa{isa_samples, nisa, isa_per};
  const fm::SeedRows seed{seed_rows, seed_nrows, seed_k};
  const auto st = static_cast<cudaStream_t>(stream);
  return per > 0 ? launch<true>(bank, Bp, Lb, lens, live0, glen, anchor_len,
                                resolve, cap, seed, ia, sa, isa, shift, length,
                                out, st)
                 : launch<false>(bank, Bp, Lb, lens, live0, glen, anchor_len,
                                 resolve, cap, seed, ia, sa, isa, shift,
                                 length, out, st);
}
