// K11b: phase B's compose: each read's stitch-log run stream merged into its
// CIGAR runs and packed for one copy to the host, a warp for 32 reads.
//
// Replaces bwt_tpu/models/aligner.py:_compose_device and _pack_fetch (two
// jitted programs there: the stream gathered over (n, 16, 48) one-hot masks,
// a cumsum for the run ids and a scatter-add for the merge, then the fetch's
// bit packing).  The port's plain version is
// bwt_tpu_torch/ops/compose.py:compose_plain.  A thread walks its read's log
// in push order, slots 0 .. min(lp, 16) - 1: an M or I entry is one run,
// (op + 2) << 24 | glens; a stitch slot is its block, bl3 entries of
// runs_oc[lane, slot] (K11a's accumulator).  Only the stream's first F2
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
// What bounds it on the H100: bytes, a read's 16-slot kinds, glens and bl3
// rows, the block entries its stream takes, its scalars and its 48-byte
// row.  A thread a read alone reads those rows 64 bytes apart across a warp
// and writes its row word by word 48 bytes apart, so nearly every 32-byte
// sector a warp's access touches carries one useful word (PERF.md: 834,955
// sector requests a chunk of 2^15 reads against 482,205 staged).
// So a warp takes 32 consecutive reads: it stages their three log rows in
// shared memory with coalesced loads (each a 2,048-byte span), each thread
// merges its read from there, the rows assembled in shared memory, and the
// warp stores them as one 1,536-byte span.  The block entries stay per
// thread loads (a few a read, from rows W ints apart), kBatch of them
// issued before any is merged, so that a block waits for one load and not
// for one an entry.  What is left is the merge itself, a read's slots and
// entries one after another on its thread (at 2^15 reads 10.5 steps a read,
// a warp's longest 33 on average) with two warps a scheduler: it holds the
// kernel at a third of its bound (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>
#include <stddef.h>

#include "align_log.cuh"

namespace {

constexpr int kWarps = 4;  // a block's warps, 32 reads each
constexpr int kThreads = 32 * kWarps;
constexpr int kOutW = 12;
// the staged rows' strides: odd, so that the 32 threads reading slot s of
// their own rows hit 32 distinct banks
constexpr int kLogPad = alog::kLogN + 1;
constexpr int kOutPad = kOutW + 1;
constexpr int kBatch = 8;  // block entries loaded together

// One warp's staging in shared memory: its reads' kinds, glens and bl3
// rows, and their output rows.
struct Stage {
  int kinds[32 * kLogPad];
  int glens[32 * kLogPad];
  int bl3[32 * kLogPad];
  int out[32 * kOutPad];
};

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
  using namespace alog;
  __shared__ Stage stage[kWarps];
  Stage& st = stage[threadIdx.x >> 5];
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int r0 = (static_cast<int>(blockIdx.x) * kWarps +
                  static_cast<int>(threadIdx.x >> 5)) * 32;
  if (r0 >= Bp) return;  // the whole warp
  const int nr = min(32, Bp - r0);

  // this thread's read's scalars, then the warp's log rows: element e of
  // each span is read e / 16's slot e % 16, kept at a padded stride so that
  // each thread's row reads conflict-free.  Every load is issued before the
  // first is used, so the warp waits for one load's latency, not for one
  // an element
  const int b = r0 + min(lane, nr - 1);
  const int mode = __ldg(log + col(kMode, Bp) + b);
  const int curpos = __ldg(log + col(kCurpos, Bp) + b);
  const int strand = __ldg(log + col(kStrand, Bp) + b);
  const int lp = __ldg(log + col(kLp, Bp) + b);
  const int ovf = __ldg(log + col(kOvf, Bp) + b);
  const int capped = __ldg(log + col(kCapped, Bp) + b);
  const int head_end = __ldg(acc + acc_head_end(Bp, W) + b);
  const int over_rle = __ldg(acc + acc_over(Bp, W) + b);
  const size_t e0 = static_cast<size_t>(r0) * kLogN;
  const int* kinds_g = log + log_col(kKinds, Bp) + e0;
  const int* glens_g = log + log_col(kGlens, Bp) + e0;
  const int* bl3_g = acc + acc_bl3(Bp, W) + e0;
  int kv[kLogN], gv[kLogN], bv[kLogN];
#pragma unroll
  for (int i = 0; i < kLogN; ++i) {
    const int e = lane + 32 * i;
    const bool in = e < nr * kLogN;
    kv[i] = in ? __ldg(kinds_g + e) : 0;
    gv[i] = in ? __ldg(glens_g + e) : 0;
    bv[i] = in ? __ldg(bl3_g + e) : 0;
  }
#pragma unroll
  for (int i = 0; i < kLogN; ++i) {
    const int e = lane + 32 * i;
    const int at = (e / kLogN) * kLogPad + e % kLogN;
    st.kinds[at] = kv[i];
    st.glens[at] = gv[i];
    st.bl3[at] = bv[i];
  }
  __syncwarp();

  if (lane < nr) {
    const int* kinds = st.kinds + lane * kLogPad;
    const int* glens = st.glens + lane * kLogPad;
    const int* bl3 = st.bl3 + lane * kLogPad;
    const int* runs_oc = acc + static_cast<size_t>(b) * kLogN * W;

    int* row = st.out + lane * kOutPad;
    for (int r = 0; r < 8; ++r) row[4 + r] = 0;
    Merge m{row, K};
    const int n = min(lp, kLogN);
    int p = 0;  // stream position
    for (int s = 0; s < n; ++s) {
      const int kind = kinds[s];
      if (kind == kM || kind == kI) {
        if (p < F2) m.entry(p, ((kind == kM ? 2 : 3) << 24) | glens[s]);
        ++p;
        continue;
      }
      // the block's entries in the stream's first F2, kBatch loads issued
      // together before they merge
      const int bl = bl3[s];
      const int take = min(bl, max(F2 - p, 0));
      const int* blk = runs_oc + static_cast<size_t>(s) * W;
      for (int w0 = 0; w0 < take; w0 += kBatch) {
        int v[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          v[i] = w0 + i < take ? __ldg(blk + min(w0 + i, W - 1)) : 0;
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          if (w0 + i < take) m.entry(p + w0 + i, v[i]);
        }
      }
      p += bl;  // entries past F2 count, unread
    }
    if (m.rid >= 0 && m.rid < K) m.flush(m.rid, m.acc);
    const int nrun = m.rid + 1;
    const int nrun_k = min(nrun, K + 1);
    const bool over = nrun > K || m.over_cnt || p > F2;
    const bool over8 = nrun_k > 8 || m.over8;
    row[0] = mode == 2 ? curpos : mode == 1 ? curpos - head_end : 0;
    row[1] = mode | (strand << 2) | ((over_rle > 0) << 3) |
             (over << 4) | (ovf << 5) | (capped << 6) | (over8 << 7);
    row[2] = nrun_k;
    row[3] = static_cast<int>(m.ops);
  }
  __syncwarp();

  // the warp's rows as one contiguous span
  int* dst = out + static_cast<size_t>(r0) * kOutW;
  for (int e = lane; e < nr * kOutW; e += 32) {
    dst[e] = st.out[(e / kOutW) * kOutPad + e % kOutW];
  }
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
  const int blocks = (Bp + kThreads - 1) / kThreads;  // a read a thread
  compose_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      log, Bp, acc, W, K, F2, out);
  return static_cast<int>(cudaGetLastError());
}
