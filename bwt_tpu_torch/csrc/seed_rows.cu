// The k-mer seed table as one launch: a thread searches one key's first
// P characters, then expands the state's last k - P levels in registers
// and writes their 4^(k-P) rows.
//
// Computes what bwt_tpu/ops/search.py:_seed_rows computes (an XLA program
// there; the port's plain version is
// bwt_tpu_torch/ops/search.py:_seed_rows_plain, which runs this schedule),
// bit for bit: row `key` is (start, end, sp, ep, nmatched, alive) after k
// steps of the backward search on the k-mer whose character processed at
// step t sits in bits 2t, 2t + 1 of the key.
//
// Level order.  The state after t + 1 characters depends only on
// key mod 4^(t+1), so the 4^k keys share (4^k - 1) / 3 parent states, and
// a parent's four children share its two bucket rows (fm::row_ranks_all4
// counts all four characters from one row).  A thread a key, as this
// kernel's first form was, loaded each parent's rows once for every key
// below it: 2^24
// keys x up to 11 steps x 2 rows at k = 12, gigabytes through L2 for a
// 16.8 MB bucket table.  Here thread p (p < 4^P, P = max(k - kFused, 1))
// searches key p's first P characters as the search does (fm::lf_step),
// then expands its state: each state of the subtree loads its rows once and
// makes its four children, child c of a state after t characters going to
// row + c * 4^t.  A dead state passes to its children unchanged, as the
// search's masked step leaves it.  So what remains is the 24 bytes a row
// the table must write, plus 4^P prefixes of P - 1 steps.
//
// The writes.  The 32 threads of a warp hold consecutive keys, so for each
// descendant m of their states their rows are 32 consecutive rows of the
// table (768 bytes): the warp stages them in shared memory and stores them
// as 16-byte words.  No level is written to device memory and read back,
// and no scratch exists.

#include <cuda_runtime.h>
#include <stddef.h>

#include "fm_search.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kFields = 6;
constexpr int kFused = 3;  // levels a thread expands (search.SEED_FUSED)
constexpr int kWarpWords = 32 * kFields / 4;  // a warp's rows, as int4

struct State {
  int start, end, sp, ep, nmatched;
  bool alive;
};

// A warp's rows of one descendant m: its keys' rows at base + stride * m.
struct Writer {
  int* out;
  int4* stage;    // kWarpWords of shared memory, this warp's
  size_t base;    // the warp's first key
  size_t stride;  // 4^P
  int n;          // the warp's keys below 4^P (32 but in a table of k < 3)
  int lane;

  __device__ __forceinline__ void put(const State& s, int m) const {
    int* mine = reinterpret_cast<int*>(stage) + lane * kFields;
    mine[0] = s.start;
    mine[1] = s.end;
    mine[2] = s.sp;
    mine[3] = s.ep;
    mine[4] = s.nmatched;
    mine[5] = s.alive ? 1 : 0;
    __syncwarp();
    // base and stride are even, so a row pair starts 16-byte aligned
    int* dst = out + (base + stride * static_cast<size_t>(m)) * kFields;
    if (n == 32) {
      for (int i = lane; i < kWarpWords; i += 32) {
        reinterpret_cast<int4*>(dst)[i] = stage[i];
      }
    } else {
      const int* src = reinterpret_cast<const int*>(stage);
      for (int i = lane; i < n * kFields; i += 32) dst[i] = src[i];
    }
    __syncwarp();
  }
};

// The D levels below state s, its descendants at rows m + mstep * (c1 + 4
// c2 + ...).  Every lane of the warp calls it in step (the writes are the
// warp's); a dead state loads nothing.
template <int D, bool kTp>
__device__ __forceinline__ void expand(const fm::IndexT<kTp>& ix,
                                       const fm::Consts& kc, const State& s,
                                       int m, int mstep, const Writer& w) {
  if constexpr (D == 0) {
    w.put(s, m);
  } else {
    int lo[4] = {0, 0, 0, 0}, hi[4] = {0, 0, 0, 0};
    if (s.alive) {
      const int is = fm::adjust(kc.endloc, s.start);
      const int ie = fm::adjust(kc.endloc, s.end);
      const fm::Row rs = fm::load_row(ix, is);
      const fm::Row re = (is >> 6) == (ie >> 6) ? rs : fm::load_row(ix, ie);
      fm::row_ranks_all4(rs, is & 63, lo);
      fm::row_ranks_all4(re, ie & 63, hi);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      State t = s;
      if (s.alive) {
        const int cc = fm::take_c(kc, c);
        t.start = fm::wadd(cc, lo[c]);
        t.end = fm::wadd(cc, hi[c]);
        t.alive = t.end > t.start;
        if (t.alive) {
          t.sp = t.start;
          t.ep = t.end;
          ++t.nmatched;
        }
      }
      expand<D - 1>(ix, kc, t, m + c * mstep, 4 * mstep, w);
    }
  }
}

template <int D, bool kTp>
__global__ void __launch_bounds__(kThreads)
seed_rows_kernel(int prefix, int nprefix, fm::IndexT<kTp> ix,
                 int* __restrict__ out) {
  __shared__ int4 stage[kThreads / 32][kWarpWords];
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int key = static_cast<int>(blockIdx.x) * kThreads + tid;
  const int warp0 = key - lane;
  if (warp0 >= nprefix) return;  // a whole warp
  const fm::Consts kc = fm::load_consts(ix);
  // a lane past the last key runs a dead state and writes nothing
  const int c0 = key & 3;
  fm::Lane r;
  r.start = r.sp = fm::take_c(kc, c0);
  r.end = r.ep = fm::take_c(kc, c0 + 1);
  r.alive = key < nprefix && r.end > r.start;
  r.nmatched = r.alive ? 1 : 0;
  for (int t = 1; t < prefix && r.alive; ++t) {
    fm::lf_step(ix, kc, r, (key >> (2 * t)) & 3, false);
  }
  const State s{r.start, r.end, r.sp, r.ep, r.nmatched, r.alive};
  const Writer w{out, stage[tid >> 5], static_cast<size_t>(warp0),
                 static_cast<size_t>(nprefix), min(32, nprefix - warp0), lane};
  expand<D>(ix, kc, s, 0, 1, w);
}

template <bool kTp>
int launch(int k, const fm::IndexArgs& ia, int* out, cudaStream_t st) {
  const int prefix = k - kFused > 1 ? k - kFused : 1;
  const int nprefix = 1 << (2 * prefix);
  const fm::IndexT<kTp> ix = fm::index_form<kTp>(ia);
  const int blocks = (nprefix + kThreads - 1) / kThreads;
  switch (k - prefix) {
    case 0:
      seed_rows_kernel<0, kTp>
          <<<blocks, kThreads, 0, st>>>(prefix, nprefix, ix, out);
      break;
    case 1:
      seed_rows_kernel<1, kTp>
          <<<blocks, kThreads, 0, st>>>(prefix, nprefix, ix, out);
      break;
    case 2:
      seed_rows_kernel<2, kTp>
          <<<blocks, kThreads, 0, st>>>(prefix, nprefix, ix, out);
      break;
    default:
      seed_rows_kernel<kFused, kTp><<<blocks, kThreads, 0, st>>>(
          prefix, nprefix, ix, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (4^k, 6) int32 on the device, 1 <= k <= 15; the index as
// fm::IndexArgs (per > 0: a tp view).  One launch on `stream`; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a k
// outside that range.
extern "C" int seed_rows_launch(int k, const void* buckets, int nrows,
                                int per, const int* C, const int* endloc,
                                int* out, void* stream) {
  if (k < 1 || k > 15) return static_cast<int>(cudaErrorInvalidValue);
  const fm::IndexArgs ia{buckets, nrows, per, C, endloc};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return per > 0 ? launch<true>(k, ia, out, st) : launch<false>(k, ia, out, st);
}
