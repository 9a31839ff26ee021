// locate as one launch: one thread per read runs the read's backward
// search and then walks the interval's start to its position.
//
// Computes what bwt_tpu/ops/search.py:locate computes (seqindex.c:258-277;
// the port's plain version is bwt_tpu_torch/ops/search.py:locate_plain),
// bit for bit: fm::search_lane from C[c0] (mode 0) or, with a seed table,
// from the row of the read's last k characters (mode 2), no N resolution;
// fm::sa_walk from `start`; -1 where the interval emptied before the final
// character.  Every lane's start is walked, emptied or not, as the plain
// version walks it, so a start past the suffix array (a read ending in a
// symbol absent from the genome) raises the flag; the lane's slot then
// holds that row, for the message.
//
// Output, one int32 array of B + 2: the positions, then the flag (count of
// walks that overran, and B - the first such lane), zeroed by the caller.
// The search's eight-field record stays in registers: against a launch of
// the backward search followed by one of the walk, 32 B a read are not
// written and 4 B a read are not read back.
//
// What bounds it on the H100: the same chain of dependent row loads from
// L2 as the backward search, then about sa_rate more for the walk.

#include <climits>
#include <cuda_runtime.h>
#include <stddef.h>

#include "fm_search.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kTile>
__global__ void __launch_bounds__(kThreads)
locate_kernel(const int* __restrict__ patterns, const int* __restrict__ lengths,
              int B, int L, fm::SeedRows seed, fm::Index ix, fm::Samples sa,
              int* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  fm::PatternView<int, kTile> pat(patterns, B, b, L);
  if (b >= B) return;
  const fm::Consts k = fm::load_consts(ix);
  const int len = __ldg(lengths + b);
  const fm::Lane r = fm::search_lane(ix, k, pat, len, L, false,
                                     seed.rows != nullptr ? 2 : 0, 0, 0, seed);
  const fm::Walk w = fm::sa_walk(ix, k, sa, r.start, sa.length + 1);
  const bool emptied = !r.alive && r.nmatched <= fm::wsub(len, 2);
  if (w.unsampled) {
    fm::raise_flag(out + B, B, b);
    out[b] = r.start;
  } else {
    out[b] = emptied ? -1 : w.pos;
  }
}

}  // namespace

// patterns (B, L) and lengths (B,) int32, contiguous, on the device;
// seed_rows (seed_nrows, 6) or null for an unseeded search; out (B + 2,)
// int32 with its last two entries zero.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int locate_launch(const int* patterns, const int* lengths, int B,
                             int L, const int* seed_rows, int seed_nrows,
                             int seed_k, const int* buckets, int nrows,
                             const int* C, const int* endloc,
                             const int* sa_samples, int nsamples, int shift,
                             int length, int* out, void* stream) {
  if (B <= 0) return 0;
  const fm::Index ix{buckets, nrows, C, endloc};
  const fm::Samples sa{sa_samples, nsamples, shift, length};
  const int blocks = (B + kThreads - 1) / kThreads;
  const fm::SeedRows seed{seed_rows, seed_nrows, seed_k};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = fm::tile_bytes(locate_kernel<true>, kThreads,
                                     L * sizeof(int));
  if (smem) {
    locate_kernel<true><<<blocks, kThreads, smem, s>>>(
        patterns, lengths, B, L, seed, ix, sa, out);
  } else {
    locate_kernel<false><<<blocks, kThreads, 0, s>>>(
        patterns, lengths, B, L, seed, ix, sa, out);
  }
  return static_cast<int>(cudaGetLastError());
}
