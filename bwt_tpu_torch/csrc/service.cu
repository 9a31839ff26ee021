// The fused service round as one launch: one thread per lane answers the
// lane's FM-index request, whatever its opcode.
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
// What bounds it on the H100: a round is at most some 2^13 lanes, a
// fifth of the threads the card holds, so the time is one lane's chain of
// dependent 32-byte row loads from L2 (its search steps, then the walk,
// then the window), and a warp runs as long as its longest lane.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <stddef.h>

#include "service_lane.cuh"

namespace {

constexpr int kThreads = 128;

// The seven (B,) lane fields.
struct Fields {
  const int *opc, *row, *off, *ln, *sp, *ep, *idx;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
service_kernel(const T* __restrict__ bank, int R, int Lb, Fields f, int B,
               svc::Flags fl, fm::SeedRows seed, fm::Index ix,
               fm::Samples sa, fm::Isa isa, int* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const fm::Consts k = fm::load_consts(ix);
  const svc::Cols c = svc::lane<T>(
      bank, R, Lb, __ldg(f.opc + b), __ldg(f.row + b), __ldg(f.off + b),
      __ldg(f.ln + b), __ldg(f.sp + b), __ldg(f.ep + b), __ldg(f.idx + b), fl,
      seed, ix, k, sa, isa);
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
  const int blocks = (B + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem == 4) {
    service_kernel<int><<<blocks, kThreads, 0, s>>>(
        static_cast<const int*>(bank), R, Lb, f, B, fl, seed, ix, sa, isa,
        out);
  } else if (elem == 1) {
    service_kernel<uint8_t><<<blocks, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(bank), R, Lb, f, B, fl, seed, ix, sa,
        isa, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
