// Batched FM-index backward search: one thread per read, the whole LF loop
// in registers.
//
// Replaces the Pallas TPU kernel tools/probe_pallas_lf.py:kernel (called
// through pallas_chain), a K-step raw backward search, and computes what
// bwt_tpu/ops/search.py:backward_search / _run_loop computes (the port's
// plain version is bwt_tpu_torch/ops/search.py:backward_search_plain),
// bit for bit.  The Pallas kernel walks its lanes one at a time because
// Mosaic has no per-lane gather; a CUDA thread loads its own bucket rows,
// so each read is one thread that stops when its own lane is done.
//
// The per-read body is fm::search_lane (fm_search.cuh), which states the
// three initial-state modes, the N resolution and the step; this file is
// the shell that gives every read a thread and stores the record.
//
// Outputs, each (B,) int32 in one (8, B) array: start, end, sp, ep,
// nmatched, alive, skips, eff_len.
//
// What bounds it on the H100: each step of a read is one or two dependent
// 32-byte row loads (the interval's two ends) plus a few dozen integer
// ops, so a read is a chain of latency-bound loads.  At a 2^25-base genome
// the bucket table is 16.8 MB and stays in the 50 MB L2, so the chain runs
// at L2 latency, and throughput comes from enough reads in flight: one
// thread per read, 256 threads a block, the block's reads staged in shared
// memory where that costs no block in flight (fm_search.cuh).

#include <climits>
#include <cuda_runtime.h>
#include <stddef.h>

#include "fm_search.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kTile, bool kTp>
__global__ void __launch_bounds__(kThreads)
backward_search_kernel(const int* __restrict__ patterns,
                       const int* __restrict__ lengths, int B, int L,
                       int steps, int resolve_n, int mode,
                       const int* __restrict__ init_start,
                       const int* __restrict__ init_end, fm::SeedRows seed,
                       fm::IndexT<kTp> ix, int* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  fm::PatternView<int, kTile> pat(patterns, B, b, L);
  if (b >= B) return;
  const fm::Consts k = fm::load_consts(ix);
  const int s0 = mode == 1 ? __ldg(init_start + b) : 0;
  const int e0 = mode == 1 ? __ldg(init_end + b) : 0;
  const fm::Lane r = fm::search_lane(ix, k, pat, __ldg(lengths + b), steps,
                                     resolve_n != 0, mode, s0, e0, seed);
  out[b] = r.start;
  out[B + b] = r.end;
  out[2 * B + b] = r.sp;
  out[3 * B + b] = r.ep;
  out[4 * B + b] = r.nmatched;
  out[5 * B + b] = r.alive ? 1 : 0;
  out[6 * B + b] = r.skips;
  out[7 * B + b] = r.eff;
}

template <bool kTp>
int launch(const int* patterns, const int* lengths, int B, int L, int steps,
           int resolve_n, int mode, const int* init_start,
           const int* init_end, const fm::SeedRows& seed,
           const fm::IndexArgs& ia, int* out, cudaStream_t s) {
  const fm::IndexT<kTp> ix = fm::index_form<kTp>(ia);
  const int blocks = (B + kThreads - 1) / kThreads;
  const size_t smem = fm::tile_bytes(backward_search_kernel<true, kTp>,
                                     kThreads, L * sizeof(int));
  if (smem) {
    backward_search_kernel<true, kTp><<<blocks, kThreads, smem, s>>>(
        patterns, lengths, B, L, steps, resolve_n, mode, init_start, init_end,
        seed, ix, out);
  } else {
    backward_search_kernel<false, kTp><<<blocks, kThreads, 0, s>>>(
        patterns, lengths, B, L, steps, resolve_n, mode, init_start, init_end,
        seed, ix, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// patterns (B, L) and lengths (B,) int32, contiguous, on the device;
// init_start / init_end (B,) for mode 1, seed_rows (seed_nrows, 6) for
// mode 2 (null otherwise); the index as fm::IndexArgs (per > 0: a tp
// view); out (8, B) int32.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int backward_search_launch(
    const int* patterns, const int* lengths, int B, int L, int steps,
    int resolve_n, int mode, const int* init_start, const int* init_end,
    const int* seed_rows, int seed_nrows, int seed_k, const void* buckets,
    int nrows, int per, const int* C, const int* endloc, int* out,
    void* stream) {
  if (B <= 0) return 0;
  const fm::IndexArgs ia{buckets, nrows, per, C, endloc};
  const fm::SeedRows seed{seed_rows, seed_nrows, seed_k};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return per > 0 ? launch<true>(patterns, lengths, B, L, steps, resolve_n,
                                mode, init_start, init_end, seed, ia, out, s)
                 : launch<false>(patterns, lengths, B, L, steps, resolve_n,
                                 mode, init_start, init_end, seed, ia, out, s);
}
