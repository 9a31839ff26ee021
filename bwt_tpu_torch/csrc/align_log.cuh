// The layouts that the aligner's device engine passes between its kernels, in
// one place: the aligner automaton's packed output (K10, align_automaton.cu,
// writes it; the log stitch K11a, dp_stitch.cu's LogForm, and the compose
// K11b, compose.cu, read it) and phase B's accumulators (K11a writes them,
// K11b reads them).  The Python side reads the same layouts:
// bwt_tpu_torch/ops/automaton.py:align_unpack and
// bwt_tpu_torch/ops/dp_wavefront.py:acc_unpack.
//
// The packed output of Bp reads, int32: seven columns of Bp (Col), then five
// log columns of Bp x 16 (LogCol; slot s of read b at b * 16 + s), then at
// flag_offset(Bp) the walk's overrun flag (its count, a pad word, a 64-bit
// key).  The accumulators, int32, with W entries a block: runs_oc (Bp, 16,
// W), each entry (op + 2) << 24 | count; bl3 (Bp, 16), a slot's block length;
// head_end (Bp,); over (Bp,).

#pragma once

#include <stddef.h>

namespace alog {

constexpr int kLogN = 16;  // slots of a read's log
constexpr int kCols = 7;
constexpr int kLogCols = 5;

enum Col { kMode = 0, kCurpos, kStrand, kLp, kOvf, kCapped, kIters };
enum LogCol { kKinds = 0, kRoffs, kRlens, kGlens, kGstarts };
// the kinds of bwt_tpu/models/aligner.py's log entries
enum Kind { kNw = 1, kSw = 2, kM = 3, kI = 4, kHead = 5 };

__host__ __device__ inline size_t col(int c, int Bp) {
  return (size_t)c * Bp;
}
// the start of log column c; read b's slots follow at b * kLogN
__host__ __device__ inline size_t log_col(int c, int Bp) {
  return (size_t)(kCols + c * kLogN) * Bp;
}
__host__ __device__ inline size_t flag_offset(int Bp) {
  return ((size_t)(kCols + kLogCols * kLogN) * Bp + 1) & ~(size_t)1;
}

__host__ __device__ inline size_t acc_bl3(int Bp, int W) {
  return (size_t)Bp * kLogN * W;
}
__host__ __device__ inline size_t acc_head_end(int Bp, int W) {
  return (size_t)Bp * kLogN * (W + 1);
}
__host__ __device__ inline size_t acc_over(int Bp, int W) {
  return acc_head_end(Bp, W) + Bp;
}

}  // namespace alog
