// The whole anchor hunt of search_reads as one launch: one thread per read
// runs every trip of the hunt and then the SA walk of its last anchor.
//
// Computes what bwt_tpu/models/exact.py:_anchor_scan_impl computes (a
// jitted lax.while_loop of trips, search_reads.c:115-133; the port's plain
// version is bwt_tpu_torch/models/exact.py:anchor_scan_plain), bit for
// bit.  While the prefix is longer than min_anchor: backward search with
// N resolution over the prefix (fm::search_lane, mode 0); m = nmatched +
// skips; m >= min_anchor is an anchor, which records the interval start
// and consumes m characters, anything else shrinks the prefix by one.  At
// the end the last anchor's row is walked to its position
// (fm::sa_walk); a read without an anchor gets -1.  All of it in wrapping
// int32 arithmetic: the prefix length goes negative after an all-N anchor.
//
// With `reverse` the thread reads its read plain-reversed (reversed, not
// complemented: search_reads.c:112-114), so the second direction of
// search_reads needs no second array.  Reads are int32, uint8 or int8
// codes (`elem` 4, 1, -1), widened here.
//
// Two loops that never end in the lockstep version are bounded here, a
// thread that never returns being a hung card:
//   * a trip that is an anchor and consumes nothing (m <= 0, which needs
//     min_anchor <= 0) repeats forever: the thread stops and raises
//     flag[2], flag[3];
//   * a walk from a row past the suffix array (an anchor made of trailing
//     N's over an effective last character absent from the genome records
//     sp = C[c] = n + 1) stops at length + 1 steps and raises flag[0],
//     flag[1]; its position slot then holds the row, for the message.
//
// Output, one int32 array of 2B + 4: the anchor counts (B), the positions
// (B), then the flag, zeroed by the caller.
//
// What bounds it on the H100: like the backward search, a chain of
// dependent row loads from L2; a warp runs as long as its longest hunt.
// Forward reads from the genome end in one trip; a plain-reversed read
// takes about len - min_anchor trips of about log4(n) steps each.  One
// launch a direction keeps a warp's hunts alike.

#include <climits>
#include <cuda_runtime.h>
#include <stddef.h>

#include "fm_search.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, bool kTp>
__global__ void __launch_bounds__(kThreads)
anchor_scan_kernel(const T* __restrict__ patterns,
                   const int* __restrict__ lengths, int B, int L,
                   int min_anchor, int reverse, fm::IndexT<kTp> ix,
                   fm::SamplesT<kTp> sa, int* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  // from global memory: a hunt reads its row dozens of times over, from
  // L1 after the first, and staging the rows was measured slower (PERF.md)
  fm::PatternView<T, false> pat(patterns, B, b, L);
  const fm::Consts k = fm::load_consts(ix);
  const int len0 = __ldg(lengths + b);
  if (reverse) pat.flip(len0);
  int* flag = out + 2 * static_cast<size_t>(B);
  const fm::SeedRows no_seed{nullptr, 0, 0};

  int len = len0, nmatch = 0, anchor_sp = 0;
  bool stuck = false;
  while (len > min_anchor) {
    const fm::Lane r = fm::search_lane(ix, k, pat, len, L, true, 0, 0, 0,
                                       no_seed);
    const int m = fm::wadd(r.nmatched, r.skips);
    if (m >= min_anchor) {
      if (m <= 0) {
        stuck = true;
        break;
      }
      anchor_sp = r.sp;
      ++nmatch;
      len = fm::wsub(len, m);
    } else {
      len = fm::wsub(len, 1);
    }
  }

  int pos = -1;
  if (stuck) {
    fm::raise_flag(flag + 2, B, b);
  } else if (nmatch > 0) {
    const fm::Walk w = fm::sa_walk(ix, k, sa, anchor_sp, sa.length + 1);
    pos = w.pos;
    if (w.unsampled) {
      fm::raise_flag(flag, B, b);
      pos = anchor_sp;
    }
  }
  out[b] = nmatch;
  out[B + b] = pos;
}

template <typename T, bool kTp>
void launch(const void* patterns, const int* lengths, int B, int L,
            int min_anchor, int reverse, const fm::IndexArgs& ia,
            const fm::TableArgs& sa, int shift, int length, int* out,
            cudaStream_t s) {
  const T* p = static_cast<const T*>(patterns);
  const int blocks = (B + kThreads - 1) / kThreads;
  anchor_scan_kernel<T, kTp><<<blocks, kThreads, 0, s>>>(
      p, lengths, B, L, min_anchor, reverse, fm::index_form<kTp>(ia),
      fm::samples_form<kTp>(sa, shift, length), out);
}

template <bool kTp>
void launch_elem(const void* patterns, int elem, const int* lengths, int B,
                 int L, int min_anchor, int reverse, const fm::IndexArgs& ia,
                 const fm::TableArgs& sa, int shift, int length, int* out,
                 cudaStream_t s) {
  if (elem == 4) {
    launch<int, kTp>(patterns, lengths, B, L, min_anchor, reverse, ia, sa,
                     shift, length, out, s);
  } else if (elem == 1) {
    launch<unsigned char, kTp>(patterns, lengths, B, L, min_anchor, reverse,
                               ia, sa, shift, length, out, s);
  } else {
    launch<signed char, kTp>(patterns, lengths, B, L, min_anchor, reverse, ia,
                             sa, shift, length, out, s);
  }
}

}  // namespace

// patterns (B, L) of `elem`-typed codes (4: int32, 1: uint8, -1: int8) and
// lengths (B,) int32, contiguous, on the device; the index as
// fm::IndexArgs and the SA samples as fm::TableArgs (per > 0: a tp view);
// out (2B + 4,) int32 with its last four entries zero.  Launches on
// `stream` and returns cudaGetLastError() (0 on success), or -1 for an
// unknown `elem`.
extern "C" int anchor_scan_launch(
    const void* patterns, int elem, const int* lengths, int B, int L,
    int min_anchor, int reverse, const void* buckets, int nrows, int per,
    const int* C, const int* endloc, const void* sa_samples, int nsamples,
    int sa_per, int shift, int length, int* out, void* stream) {
  if (elem != 4 && elem != 1 && elem != -1) return -1;
  if (B <= 0) return 0;
  const fm::IndexArgs ia{buckets, nrows, per, C, endloc};
  const fm::TableArgs sa{sa_samples, nsamples, sa_per};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (per > 0) {
    launch_elem<true>(patterns, elem, lengths, B, L, min_anchor, reverse, ia,
                      sa, shift, length, out, s);
  } else {
    launch_elem<false>(patterns, elem, lengths, B, L, min_anchor, reverse, ia,
                       sa, shift, length, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}
