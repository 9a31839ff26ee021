// One lane of the fused service round as a device function: the request of
// one lane, whatever its opcode, answered in the 13 result columns.
//
// The body of the service kernel (service.cu, K7), which is a shell that
// loads a lane's seven fields, calls svc::lane and stores the columns, and
// of the rna_seq automaton (rnaseq_automaton.cu, K9), which calls it once
// an iteration on its read's own bank row.  It computes what
// bwt_tpu/models/batch_exec.py:_service_core computes for one lane (the
// port's plain version is bwt_tpu_torch/ops/service.py:service_round_plain),
// bit for bit in all 13 columns:
//   * every lane forms the initial state of a search over its slice
//     bank[row, off : off + ln] (a padding lane's is C['A'] of row 0);
//   * mms, mms_ext (trailing N's stripped, inner N's resolved, when the
//     round resolves), mms_continue (from the incoming interval, no
//     initial-character step, N's resolved) and bsearch, bsearch_ext (raw:
//     an N steps with rank(5) as it is) lanes run the search, each for its
//     own number of steps; with a seed table, mms and raw lanes with
//     ln > 0, at least seed_k effective characters and (when the round
//     resolves) no N among the first seed_k start from their table row;
//   * the walk (fm::sa_walk, at most length + 1 steps) from the unc_sa
//     lane's row, the mms lane's last nonempty start, the final (possibly
//     empty) start of mms_continue and raw lanes, row 0 otherwise;
//   * the window scan of mms_ext and bsearch_ext lanes (fm::isa_chain):
//     the smallest SA row of the window's positions that lies in the
//     lane's interval, kept as a running minimum in two registers (the
//     rows of distinct positions are distinct, so this is the plain
//     version's first argmin over its (B, 32) array);
//   * C[clip(c, 0, 4)] + rank(c, idx) for crank lanes, C[0] + rank(0, 0)
//     for the others.
// Out-of-range operands read as in the plain version: a bank row in
// [-R, 0) wraps and one further out reads the int32 minimum in every
// column; a column clips to the row.
//
// `walk` is the one batch-level decision of the plain version that a lane
// cannot take alone: an `ext` round walks only if one of its lanes
// consumes the walk's column, else that column is 0 on every lane.  A walk
// that reaches its bound short of a sampled row sets `overrun` and leaves
// the row it walked from in `pos`; the caller raises the flag.
//
// Everything is inlined into the caller: a call that is not inlined keeps
// the lane's state in a stack frame, which chip_smoke.py refuses.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <stddef.h>

#include "fm_search.cuh"

namespace svc {

constexpr int kCols = 13;
constexpr int kW = 32;  // positions of one window

enum Op { kNone = 0, kMms = 1, kCont = 2, kBsearch = 3, kUnc = 4, kCrank = 5,
          kMext = 6, kBext = 7 };

// The round's settings, the same for every lane.
struct Flags {
  bool resolve, ext, walk;
};

// The 13 result columns of one lane (bwt_tpu's order), and whether its
// walk overran.
struct Cols {
  int mms_m, cont_m, start, end, osp, oep, nm, alive, skips, pos, crank,
      wbest, wrow;
  bool overrun;
};

template <typename T>
__device__ __forceinline__ Cols lane(const T* __restrict__ bank, int R, int Lb,
                                     int opc, int brow, int off, int ln,
                                     int sp, int ep, int idx, Flags fl,
                                     const fm::SeedRows& seed,
                                     const fm::Index& ix, const fm::Consts k,
                                     const fm::Samples& sa,
                                     const fm::Isa& isa) {
  const bool is_mms = opc == kMms || opc == kMext;
  const bool is_cont = opc == kCont;
  const bool is_bs = opc == kBsearch || opc == kBext;

  if (brow < 0) brow += R;
  const bool no_row = brow < 0 || brow >= R;
  fm::PatternView<T, false> pat(bank, R, no_row ? 0 : brow, Lb);
  auto char_at = [&](int ci) { return no_row ? INT_MIN : pat.at(ci); };

  // trailing-N strip, slice-aware: the first step j in [0, ln) whose
  // column top - j lies in the row and holds no N
  const int top = fm::wsub(fm::wadd(off, ln), 1);  // column of step 0
  int skips = 0;
  if (fl.resolve && is_mms) {
    int first = INT_MAX;
    for (int j = max(0, top - (Lb - 1)); j < ln && top - j >= 0; ++j) {
      if (char_at(top - j) != fm::kN) {
        first = j;
        break;
      }
    }
    skips = max(min(first, ln), 0);
  }
  const int eff = is_cont ? fm::wadd(ln, 1)
                          : max(is_mms ? fm::wsub(ln, skips) : ln, 1);

  fm::Lane r;
  bool seeded = false;
  if (seed.rows != nullptr && (is_mms || is_bs) && ln > 0 && eff >= seed.k) {
    unsigned key = 0;
    bool has_n = false;
    for (int t = 0; t < seed.k; ++t) {
      const int j = skips + t;
      const int p = top - j;
      if (j >= ln || p < 0 || p >= Lb) continue;
      const int c = char_at(p);
      has_n = has_n || c == fm::kN;
      key += static_cast<unsigned>(c) << (2 * min(t, 15));
    }
    if (!(fl.resolve && has_n)) {
      seeded = true;
      fm::load_seed_row(seed, static_cast<int>(key), r);
    }
  }
  const int tsh = seeded ? seed.k - 1 : 0;
  // the column of step t is base - t, clipped to the row
  const int base = fm::wsub(fm::wsub(fm::wadd(off, eff), 1), tsh);
  bool incoming_empty = false;
  if (!seeded) {
    if (is_cont) {
      r.start = sp;
      r.end = ep;
    } else {
      int c0 = char_at(base);
      // ln <= 0 is reference UB: the search sees 'A' and takes no steps
      if ((is_mms || is_bs) && ln <= 0) c0 = 0;
      if (fl.resolve && is_mms && c0 == fm::kN) c0 = 0;  // all-N read -> 'A'
      r.start = fm::take_c(k, c0);
      r.end = fm::take_c(k, fm::wadd(c0, 1));
    }
    r.sp = r.start;
    r.ep = r.end;
    r.alive = r.end > r.start;
    incoming_empty = is_cont && !r.alive;
    r.nmatched = (r.alive && !is_cont) ? 1 : 0;
  }
  if (is_mms || is_cont || is_bs) {
    const bool resolve_lane = fl.resolve && (is_mms || is_cont);
    const int last = fm::wsub(eff, 1);
    for (int t = 1; r.alive && fm::wadd(t, tsh) <= last; ++t) {
      fm::lf_step(ix, k, r, char_at(fm::wsub(base, t)), resolve_lane);
    }
  }
  Cols o;
  o.mms_m = fm::wadd(r.nmatched, skips);

  const int walk0 = opc == kUnc ? idx
                    : opc == kMms ? r.sp
                    : (is_cont || is_bs) ? r.start : 0;
  o.pos = 0;
  o.overrun = false;
  if (fl.walk) {
    const fm::Walk w = fm::sa_walk(ix, k, sa, walk0, sa.length + 1);
    o.pos = w.unsampled ? walk0 : w.pos;
    o.overrun = w.unsampled;
  }

  o.wbest = -1;
  o.wrow = -1;
  if (fl.ext && (opc == kMext || opc == kBext)) {
    // mms_ext: |pos + seglen - curpos| <= curgap + 3 as a window over the
    // mms interval; bsearch_ext: the caller's window over the final one
    const bool m = opc == kMext;
    const int gap3 = fm::wadd(ep, 3);
    const int wlo = m ? fm::wsub(fm::wsub(sp, o.mms_m), gap3) : sp;
    const int wwid =
        min(max(m ? fm::wadd(fm::wadd(gap3, gap3), 1) : ep, 0), kW);
    const int ilo = m ? r.sp : r.start;
    const int ihi = m ? r.ep : r.end;
    int best = INT_MAX, best_j = 0;
    fm::isa_chain(ix, k, isa, wlo, wwid, kW, [&](int j, int row) {
      if (row >= ilo && row < ihi && row >= 0 && row < best) {
        best = row;
        best_j = j;
      }
    });
    if (best != INT_MAX) {
      o.wbest = fm::wadd(wlo, best_j);
      o.wrow = best;
    }
  }

  const bool is_crank = opc == kCrank;
  const int c_arg = min(max(is_crank ? sp : 0, 0), 4);
  o.crank = fm::wadd(fm::take_c(k, c_arg),
                     fm::rank(ix, k, c_arg, is_crank ? idx : 0));

  o.cont_m = fm::wsub(r.nmatched, incoming_empty ? 1 : 0);
  o.start = r.start;
  o.end = r.end;
  o.osp = r.sp;
  o.oep = r.ep;
  o.nm = r.nmatched;
  o.alive = r.alive ? 1 : 0;
  o.skips = skips;
  return o;
}

}  // namespace svc
