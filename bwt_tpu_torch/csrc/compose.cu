// K11b: phase B's compose, one thread a read: the read's stitch-log run
// stream merged into its CIGAR runs and packed for one copy to the host.
//
// Replaces bwt_tpu/models/aligner.py:_compose_device and _pack_fetch (two
// jitted programs there: the stream gathered over (n, 16, 48) one-hot masks,
// a cumsum for the run ids and a scatter-add for the merge, then the fetch's
// bit packing).  The port's plain version is
// bwt_tpu_torch/ops/compose.py:compose_plain.  Here one thread walks its
// read's log in push order, slots 0 .. min(lp, 16) - 1: an M or I entry is
// one run, (op + 2) << 24 | glens; a stitch slot is its block, bl3 entries
// of runs_oc[lane, slot] (K11a's accumulator).  Only the stream's first F2
// entries are read.  Adjacent equal ops merge (a count-0 run is kept), the
// current run summed in one register, (op + 2) << 24 plus its counts as
// int32 words, as bwt_tpu's packed scatter-add sums them; a run is written
// out when the next one opens, so no per-read array exists (a local array
// would be a stack frame).  Then, as _pack_fetch: the first K ops as 2-bit
// fields of one word, the first 8 counts clipped to 0..255, and the meta
// bits (mode, strand, the RLE and merge overflows, ovf, capped, more than 8
// runs or a count past 254).
//
// Output (Bp, 12) int32: res, meta, the run count (at most K + 1), the ops
// word, 8 counts.  The layouts of the log and of the accumulators are
// align_log.cuh's.
//
// What bounds it on the H100: bytes.  A read reads its 16-slot kinds, glens
// and bl3 rows, the blocks its stream takes (a few words) and five scalars,
// and writes 48 bytes; at 2^15 reads that is under 8 MB, a few microseconds,
// against a launch of tens.

#include <cstdint>
#include <cuda_runtime.h>
#include <stddef.h>

#include "align_log.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kOutW = 12;

__device__ __forceinline__ int wrap(int x, int bits) {
  const unsigned mask = (1u << bits) - 1;
  const unsigned half = 1u << (bits - 1);
  const unsigned v = static_cast<unsigned>(x) & mask;
  return v >= half ? static_cast<int>(v) - static_cast<int>(mask) - 1
                   : static_cast<int>(v);
}

// The merge of one read's stream and the packing of its output row.
struct Merge {
  int* row;         // the read's output row
  int K;
  int rid = -1;     // the current run
  int prev = 0;     // its op field, soc >> 24
  unsigned acc = 0;  // its packed sum
  unsigned ops = 0;
  bool over_cnt = false, over8 = false;

  // run r closes with packed sum v (bwt_tpu's fpk[r])
  __device__ __forceinline__ void flush(int r, unsigned v) {
    const int fpk = static_cast<int>(v);
    const int fo = wrap(fpk != 0 ? (fpk >> 24) - 2 : -1, 8);
    const int fc = fpk & 0xFFFFFF;
    const int fc16 = wrap(fc, 16);
    over_cnt = over_cnt || fc > 32767;
    ops |= (static_cast<unsigned>(fo + 1) & 3u) << (2 * r);
    if (r < 8) {
      row[4 + r] = min(max(fc16, 0), 255);
      over8 = over8 || fc16 > 254;
    }
  }

  __device__ __forceinline__ void entry(int p, int soc) {
    const int op = soc >> 24;  // op + 2, arithmetic as bwt_tpu's int32
    const unsigned count = static_cast<unsigned>(soc & 0xFFFFFF);
    if (p == 0 || op != prev) {
      if (rid >= 0 && rid < K) flush(rid, acc);
      ++rid;
      acc = (static_cast<unsigned>(op) << 24) + count;
    } else {
      acc += count;
    }
    prev = op;
  }
};

__global__ void __launch_bounds__(kThreads)
compose_kernel(const int* __restrict__ log, int Bp,
               const int* __restrict__ acc, int W, int K, int F2,
               int* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= Bp) return;
  using namespace alog;
  const int mode = __ldg(log + col(kMode, Bp) + b);
  const int curpos = __ldg(log + col(kCurpos, Bp) + b);
  const int strand = __ldg(log + col(kStrand, Bp) + b);
  const int lp = __ldg(log + col(kLp, Bp) + b);
  const int ovf = __ldg(log + col(kOvf, Bp) + b);
  const int capped = __ldg(log + col(kCapped, Bp) + b);
  const size_t e0 = (size_t)b * kLogN;
  const int* kinds = log + log_col(kKinds, Bp) + e0;
  const int* glens = log + log_col(kGlens, Bp) + e0;
  const int* runs_oc = acc + e0 * W;
  const int* bl3 = acc + acc_bl3(Bp, W) + e0;

  int* row = out + (size_t)b * kOutW;
  for (int r = 0; r < 8; ++r) row[4 + r] = 0;
  Merge m{row, K};
  const int n = min(lp, kLogN);
  int p = 0;  // stream position
  for (int s = 0; s < n; ++s) {
    const int kind = __ldg(kinds + s);
    if (kind == kM || kind == kI) {
      if (p < F2) {
        m.entry(p, ((kind == kM ? 2 : 3) << 24) | __ldg(glens + s));
      }
      ++p;
      continue;
    }
    const int bl = __ldg(bl3 + s);
    for (int w = 0; w < bl && p + w < F2; ++w) {
      m.entry(p + w, __ldg(runs_oc + (size_t)s * W + min(w, W - 1)));
    }
    p += bl;  // entries past F2 count, unread
  }
  if (m.rid >= 0 && m.rid < K) m.flush(m.rid, m.acc);
  const int nrun = m.rid + 1;
  const int nrun_k = min(nrun, K + 1);
  const bool over = nrun > K || m.over_cnt || p > F2;
  const bool over8 = nrun_k > 8 || m.over8;
  const int head_end = __ldg(acc + acc_head_end(Bp, W) + b);
  const int over_rle = __ldg(acc + acc_over(Bp, W) + b);
  row[0] = mode == 2 ? curpos : mode == 1 ? curpos - head_end : 0;
  row[1] = mode | (strand << 2) | ((over_rle > 0) << 3) |
           (over << 4) | (ovf << 5) | (capped << 6) | (over8 << 7);
  row[2] = nrun_k;
  row[3] = static_cast<int>(m.ops);
}

}  // namespace

// log: the aligner automaton's packed output over Bp lanes; acc: the
// chunk's accumulators after its log stitches (dp_stitch.cu, block width W);
// out (Bp, 12) int32.  K (1..16) merged runs kept, F2 stream entries read.
// All contiguous, on the device.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int compose_launch(const int* log, int Bp, const int* acc, int W,
                              int K, int F2, int* out, void* stream) {
  if (Bp <= 0) return 0;
  if (W <= 0 || K < 1 || K > 16 || F2 < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (Bp + kThreads - 1) / kThreads;
  compose_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      log, Bp, acc, W, K, F2, out);
  return static_cast<int>(cudaGetLastError());
}
