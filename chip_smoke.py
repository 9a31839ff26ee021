#!/usr/bin/env python3
"""Drive bwt_tpu_torch's main path once on an NVIDIA card and check it.

    python3 chip_smoke.py [--seed N] [--out FILE]
    python3 chip_smoke.py --rna-walls N   # rna_seq's device-engine wall alone
    python3 chip_smoke.py --mesh-only 25  # phase 11 alone, at 2^25 bases
    python3 chip_smoke.py --tp-only 25    # phase 11's tp meshes alone
    python3 chip_smoke.py --elastic-only  # phase 13 alone
    python3 chip_smoke.py --isa-times 25  # phase 7's K6 cases alone
    python3 chip_smoke.py --locate-times 25  # the fused locate alone

Phases, one output line each (phases 2 and 7 one per case, phase 10 three, phase 11 six a world), every number beside
the card's name and power limit:
  0. the card (torch and nvidia-smi);
  1. the CUDA kernel build from csrc/ (nvcc, one per source, in parallel),
     with the registers of each search kernel's replicated and tp
     instantiations, and beside it the automatons K10 and K9 built apart at
     tiles 1 and 8 (not the package's tile, 4), to be timed in phases 7
     and 10, and the anchor hunt at tiles 1 to 32 in both directions, to
     be timed in phase 7;
  2. the DP kernels against their plain PyTorch versions on the card, at
     the stitch shapes the aligner uses and at a taller one (a block a
     job): the fill's vals and ptrs and both outputs of the fused stitch
     (the packed end cells, residuals and runs; the op rows) must be
     bit-equal; the stitch is also timed beside the path it replaces
     (gather, fill kernel, endpoint, one eager step a diagonal,
     run-length ops), and its read-back form (the carried diagonals in
     device scratch) at the taller shape through its threshold's test hook
     and at a 12,000-row job;
  3. index build of a 2^25-base random genome at sa_sample_rate 4,
     checked with verify_suffix_array;
  4. locate of 2^20 random 30-mers cut from the genome, plain and with a
     k = 12 seed table built by one launch of the seed-table kernel (K5),
     one launch of the fused locate kernel a call: every position checked
     against the genome; count_matches on the same patterns through the
     standalone backward-search kernel (K3);
  5. single_align (align_reads) at bench.py's width: 2^16 reads of 80 bp
     with one substitution each, two chunks of 2^15, and 4,096 reads with
     one 1-3-base insertion or deletion each, through the default engine,
     the device engine: one launch of the aligner automaton (K10) and one
     of the compose (K11b) a chunk, one of the log stitch (K11a) a
     non-empty DP bucket, no K7 or executor stitch outside the escapes
     (redo and fallback reads, whose counts it prints), no fill, K3, K4,
     K6 or K9; every read equal to the host engine on the same reads (one
     K7 launch a service call, one stitch launch a DP call); every aligned
     CIGAR of a substitution read consumes its read (an indel read's may
     miss it by its gap's width, the reference's semantics: the offsets
     are printed); at least half the substitution reads at their true
     start; a 512-read subset equal through the plain versions (svc_impl,
     dp_impl) and on a CPU copy of the index; 4,096 reads at a forced cap
     of 4 iterations equal; the substitution reads again, written as a
     FastQ file and read by the C++ loader (``native.load_fastq``, which
     must be the compiled one), through align_reads(with_strand=True):
     equal to the code-matrix run, and every record of format_sam's text
     its read's result (the loader's and format_sam's host seconds
     printed).  Then the batched aligners over the standalone fill (K1) on
     4096 pairs of an 80-bp read and its 100-bp window, padded to 96 x
     128, one fill launch each: nw_fast_batch (every CIGAR consumes its
     read, all pairs equal to the same call on the CPU and 16 of them to
     the host's nw_fast), nw_endpos_batch (all four outputs) and
     sw_fast_batch, each equal to the same call on the CPU;
  6. the CLI as subprocesses with ``--platform cuda``: build_index in the
     reference format and as npz, then all the others started together:
     single_align (text on the reference-format index, through the host
     engine; --sam and a FastQ file on the npz index, which has the
     inverse samples, through the device engine), locate, search_reads,
     rnaseq, index_info, index_test,
     filetest and gaptest on a 1 Mb genome and 512 reads, satest and
     fmitest at 2^25 bases: every exit code 0 and every stdout equal to
     the same run in process (cli.main, alone, which gives satest's Mb/s
     and fmitest's 12-mer rate, and whose kernel launches are counted:
     locate, K3, K4, K10-K11b);
  7. every search kernel against its plain version on the card, bit-equal,
     on the 2^25-base index, each timed by CUDA events beside its bound:
     K3 on 2^16 mixed reads in each initial-state mode and on 2^20 30-mers;
     K4 on 2^20 random rows plus rows 0, endloc and n; the fused
     anchor_scan on the mixed reads (min_anchor 20 and 12) and on one
     search_reads chunk (32,768 x 50 bp, uint8), forward and reversed, also
     against the unfused loop of K3 launches and a K4 launch that it
     replaces and against its plain version at every tile width, whose
     rounds give its chains of dependent loads, and beside its builds at
     each tile; the fused locate on
     the 30-mers and on the mixed reads, plain and seeded
     (``--locate-times`` runs these alone, beside K3 and K4 alone on the
     same reads and the 30-mers presorted by their reversed codes, with
     the rows, sectors and rounds of its warps counted on the host:
     locate_counts); the walk's step
     bound and the hunt's no-progress bound raising on the card; then the
     executor's kernels: K7 on fuzzed rounds of 2^13 lanes mixing all eight
     opcodes (with and without N resolution, the window scan and a k = 12
     seed table) and on the largest rounds recorded from phase 5, equal in
     all 13 columns and the flag; K6 on 2^16 windows, on the index and on
     a sa_rate-32 index of the same genome, at the package's tile and at
     every tile, with each form's chains and LF steps (isa_plan; the
     schedule alone, on the host; ``--isa-times`` runs these cases alone,
     for a pairing with an older tree); K5 at k = 12, with
     its bucket-row loads under each schedule (seed_loads); the
     latency of one dependent load (K3, one thread searching a 64- and a
     4,096-base genome substring); then the aligner's: K10 on one chunk of
     phase 5's substitution reads and on its indel reads, and its builds
     at tiles 1 and 8 (every column, the log and the flag, against the
     plain version's lockstep loop; the time at each tile, the registers of
     each, the iteration histogram, and the chain of dependent loads,
     longest and mean, at widths 1, 4 and 8, from the plain version's
     rounds (Chain), which must give the same outputs at every width,
     beside the load latency), K11a on every bucket of both chunks' logs
     (the accumulators; each bucket's time beside its Part A counts,
     dp_slots) and K11b on the substitution chunk's lanes;
  8. search_reads on 2^20 unmutated 50-bp reads cut from the genome (a
     uint8 code array): two anchor_scan launches a chunk and no K3 or K4,
     every forward read anchors at its origin, an 8,192-read subset gives
     the same result dict through the plain versions on the CPU;
  10. rna_seq on 2^16 reads of 50 bp cut from the genome with one base
     complemented (rnaseqtest.c's self-benchmark, cut from its 1 M reads):
     the default engine, the device automaton, one K9 launch a chunk of
     2^15 reads and no other kernel (its wall the median of RNA_WALLS
     untraced runs), unmutated reads report their origin
     and so does a share of those mutated in their last bases; the host
     engine on the same reads (one K7 launch a service call) equal on all
     of them; a 1,024-read subset equal through the plain automaton on the
     card and on a CPU copy of the index; 4,096 reads at a forced cap of 4
     iterations (capped reads re-run on the host), equal; K9 on one chunk,
     and its builds at tiles 1 and 8, against its plain version, bit-equal,
     timed beside its bound, with its registers, the iteration histogram
     and its chains as K10's; 4,096 of the reads on the index without
     isa_samples (the host engine's unc_sa_range chunk scan, K4's
     path), equal; and 4,096 isa_range requests through the executor (K6's
     path), every row walked back to its position;
  11. the mesh (bwt_tpu_torch.parallel), in child processes so that this
     process's state is untouched (``--mesh-child``; each rank's log in
     build/chip_smoke/mesh/): a world of one rank over NCCL, then four
     ranks sharing the card over gloo (NCCL takes one rank a card), every
     rank a process on cuda:0 with every collective under a timeout.  Each
     rank builds the 2^25-base index with the sharded suffix sort over a
     tp = world mesh (one rank takes the single-device sort), its SA and
     every index array equal to phase 3's, with the sort's and the
     finish's peak device memory apart; then, over a dp = world mesh and
     twice each, sharded_search_step + gather_hits on phase 4's 30-mers
     (K3 and K4 a rank), search_reads on phase 8's reads (anchor_scan),
     align_reads on phase 5's substitution and indel reads (K10, K11a,
     K11b; the first run of a process also K5 for its seed table) and
     rna_seq on phase 10's reads (K9), each equal on every rank to this
     process's single-device run, with each rank's launches, wall, the
     merge's share of it (parallel.mesh.MERGE_S) and the bytes the gloo
     collectives staged through the host (STAGED_BYTES).  Then, in the
     gloo world, the tp meshes dp 1 x tp 4 and dp 2 x tp 2: each rank loads
     the index from its npz on the host and serves from
     tp_view(shard_index(...)) (the card's bytes the view holds beside the
     whole index's); twice each, tp_locate + gather_hits and
     sharded_search_step on phase 4's 30-mers (K3, K4), search_reads
     (anchor_scan), align_reads on both kinds of read (K10, K11a, K11b; K5
     for the view's seed table) and rna_seq (K9), each equal to the
     single-device run on every rank with its launches through the view;
     the nine tp kernels against the plain tp path (the gloo all-reduces)
     on a 2^16-base genome, 2^10 reads each, tolerance 0; and, on the first
     mesh, each tp kernel timed on rank 0 at the main path's shapes beside
     the replicated kernel on the same inputs while the others wait at a
     barrier with their blocks mapped; and on the first tp mesh the wide
     (int64) index of phase 12 too: sharded_search_step of 2^16 of phase
     4's 30-mers over its tp view (blocks of its rows32 over the whole
     bases, the wide K3 and K4), equal to the replicated wide kernels and
     to the int32 run.  A failed or
     overrunning rank fails the phase;
  12. the wide (int64) index, before phase 11: the 2^25-base genome built
     again with index_dtype=np.int64 (Mb/s and peak memory beside phase
     3's), its arrays equal to phase 3's values and round-tripped through
     npz, its device layout (rows32 and bases, derived on the card) giving
     back every 12-int row; its main path with the launch counts from 0:
     the k = 12 seed
     table (K5), locate of phase 4's 30-mers plain and seeded,
     count_matches (K3), the walks of 2^20 + 3 rows (K4) and search_reads
     of phase 8's reads (anchor_scan), each equal to the int32 index's run,
     positions int64; each wide instantiation against its plain version,
     tolerance 0, timed beside the int32 kernel on the same inputs, with
     its bound (32-byte rows over their bases, int64 outputs; and the
     48-byte rows' beside it) and registers; the five on the
     shifted-samples index (shifted_index: positions past int32) and on
     the shifted-counts index (shifted_counts: counts past 2^38), equal to
     their plain versions; K3 and locate plain beside the int32 kernels on
     a 2^28-base genome built both ways, whose bucket tables (134 / 201
     MB) pass the 50 MB L2 (wide_big; ``--wide-times`` runs those cases
     and phase 12's others alone, for a pairing with an older tree); and
     align_reads, rna_seq and isa_window on the wide index raising
     ValueError with no launch;
  13. config.elastic_fallback, before phase 9, in a child process so that
     the fault it makes never reaches this one (``--elastic-child``;
     ``--elastic-only`` runs it alone): on a 2^16-base genome, 512 reads
     of 80 bp with one substitution, 1,024 of 50 bp with one base
     complemented and 1,024 unmutated 50-bp reads, at a search_batch of
     512 (two chunks of rna_seq and search_reads), with their outputs
     computed here on the CPU and passed by file.  (a) Each surface
     (build_index, align_reads, rna_seq, search_reads) on the card as it
     is, equal to the CPU's; then with an injected failure: a launcher of
     the library refusing a call with CUDA error 719 (the compose of the
     aligner's chunk, the second chunk's K9, the second chunk's first
     anchor scan, with the first chunk in flight; the build's suffix sort
     raising, as the build launches no kernel of its own),
     KernelLaunchError in the wrapper: with the flag its output equals the
     card's run, with one stderr line, and without the flag the error
     reaches the caller; the same launch refused with CUDA error 1 (an
     argument error) reaches the caller as a plain RuntimeError with the
     flag set, with no line.  (b) A real
     sticky fault: K5's launcher given an invalid device pointer, whose
     synchronise must raise torch.AcceleratorError, the next copy failing
     too; then, with the flag, build_index and align_reads must give the
     CPU's values (rebuilt on the CPU from the genome's host copy, without
     the card) and search_reads and rna_seq, whose index lives on the dead
     card, must raise a device error after their line.  Every check fails
     the run;
  9. one torch.profiler window over each exact-search path and over
     the device engines of rna_seq and single_align, last because the
     profiler slows every later launch of its process: locate plain and
     seeded (device busy time, device ops), search_reads, whose wall it
     splits into host encode, upload, kernels and download, rna_seq (K9,
     uploads, downloads) and single_align's 2^16 reads (K10, K11a, K11b,
     uploads, downloads, the rest).
Each path of phases 4, 5, 8 and 10, each CLI run in process of phase
6, and each rank's run of each path of phase 11 runs with the kernels'
launch counts set to 0 just before it and read just after; a kernel's ``launches`` are those of the paths that run it and
never those of a comparison (the standalone fill's are the batched
aligners': single_align fills inside the
stitch kernels; K4's are the unc_sa_range scan's: the service kernel walks
inside its own launch; K7's and the executor stitch's are the host
engines' and the escapes', K9's and K10-K11b's the device engines').
Then one JSON line with the thirteen kernels and the wide index's
instantiations of five of them (``*_wide``: their launches those of phase
12's main path; ``tp_launches``: the tp form's launches on rank 0's runs of
phase 11's tp paths, of its wide case for K3 and K4, null for a kernel
that reads no index or a wide one with no tp run), the nvidia-smi line,
and as
the last line ``{"ok": true, "device": {...}}``.  Any failed
phase raises and exits non-zero; so does a machine without CUDA.

A kernel's bound is the least time the card could take for the same
work: the larger of its bytes over 3.35 TB/s (each input the run needs
read once, each output written once; of the index, the 32-byte sectors
its steps touch, at most the whole table) and its operations over
33.5 T/s.  The operations are integer and logic ones, for which the
card's data sheet names no rate: 33.5 T/s is what its schedulers can
start (132 SMs x 128 lanes x 1.98 GHz, the rate behind its 67 TFLOP/s of
float32 at two operations an instruction), which no mix exceeds.  They are
counted from what the function computes, not from the kernel's code: the
steps taken on this run's data times the operations of one step.  A rank
over a 64-entry row is, for each of its four words, xor, shift, or,
and-not, mask, popcount and add, plus the add of the stored count
(RANK_OPS); a search step is two ranks, the two adds of C[c], the compare
of the new interval's ends and the match count (SEARCH_STEP_OPS); a walk
step is one rank, the row's symbol (shift, mask), the add of C[c], the
test for a sampled row and the step count (WALK_STEP_OPS); a DP cell is
the match test and its score (5), the two gap scores (4 each), two maxima
and the pointer (4) (DP_CELL_OPS).  The fused stitch's bytes are its job
fields, the two slices and its outputs, each once; its operations are
DP_CELL_OPS times the cells of each job's own (rlen + 1) x (min(glen, L2)
+ 1) matrix, plus one a step of the walk back.  A service round's are its
search steps, its walk steps, the LF steps of its window chains (a walk
step each) and one rank a lane, each counted from the round's own
results.  A seed table's are what the function needs, whatever the
schedule: every live state of levels 0..k-2 ranked once at both ends for
all four characters and its four children made (SEED_PARENT_OPS), its bytes
the table written and the bucket rows those parents read, each once (the
steps of a thread a key repeat a parent's work for every key below it).  K9's are the search, walk
and window steps of every round its chunk's reads needed, counted from the
plain version's rounds, and its bytes the bank, the lengths and the three
output columns once, a sector a seed row, window or walk sample, and the
index sectors the steps touch; K10's the same, its output the seven
columns and the log.  K11a's are the fused stitch's, its bytes a job's ids
and gathered fields, its slices and its block; K11b's its bytes alone: a
read's scalars, its kinds, glens and block-length rows, the stream entries
it reads and its 48-byte row.  The resolution of an N, forming the
lane masks, addresses and branches are left out, so the bound is, if
anything, low.  No PyTorch call computes a backward search, an SA walk,
an anchor hunt, an inverse-SA chain, an affine-gap DP fill or its
backtrack, runs a phase machine over them or merges a CIGAR's runs, so
``library_ms`` is null for every kernel.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

DP_SHAPES = ((32, 32), (32, 64), (64, 64), (64, 96), (96, 128))
ALT_SCORING = (1, -2, -9, -1)
TALL_SHAPE = (256, 160, 192)     # B, L1, L2: past a warp's 128 rows
TRUE_TALL_SHAPE = (2, 12000, 12100)  # past the rows whose diagonals fit
                                     # a block's shared memory
NW_SHAPE = (96, 128)             # nw_fast_batch's padded read and window
NW_PAIRS = 4096
READ_LEN = 80
SEED_K = 12
RNA_WALLS = 7                    # untraced runs of rna_seq's device engine

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
OPS_PER_S = 33.5e12   # 132 SMs x 128 lanes x 1.98 GHz
RANK_OPS = 4 * 7 + 1             # operations of one rank over a fetched row
SEARCH_STEP_OPS = 2 * RANK_OPS + 4   # of one backward-search step
WALK_STEP_OPS = RANK_OPS + 6         # of one LF step of the SA walk
DP_CELL_OPS = 19                     # of one affine-gap DP cell
SEED_PARENT_OPS = 8 * RANK_OPS + 16  # a seed-table parent's four children

class SmokeFailure(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return res.stdout.strip().splitlines()[0]


def cli_command(*args) -> list[str]:
    """``python -m bwt_tpu_torch --platform cuda <args>``: a CLI child
    that cannot see the card exits 1 instead of running on the CPU."""
    return [sys.executable, "-m", "bwt_tpu_torch", "--platform", "cuda",
            *(str(a) for a in args)]


def mixed_reads(rng, codes, B, L=100):
    """(B, L) int32 reads and their lengths, eight kinds in turn: exact
    30-mers; 50-bp reads with a trailing N run and an inner N; 100-bp
    reads with inner N's; all-N reads; length-1 and length-0 reads;
    ragged reads from the genome; random reads with a few codes outside
    the tables (4, 6, -1)."""
    import numpy as np

    kind = np.arange(B) % 8
    col = np.arange(L)[None, :]
    ragged = rng.integers(1, L + 1, size=B)
    lens = np.select([kind == 0, kind == 1, kind == 2, kind == 4, kind == 5],
                     [30, 50, 100, 1, 0], ragged).astype(np.int32)
    lens = np.minimum(lens, L)
    starts = rng.integers(0, len(codes) - L, size=B)
    pats = codes[starts[:, None] + col].astype(np.int32)
    junk = rng.integers(0, 4, size=(B, L)).astype(np.int32)
    odd = rng.choice(np.array([4, 6, -1], np.int32), size=(B, L))
    junk = np.where(rng.random((B, L)) < 0.02, odd, junk)
    pats = np.where((kind == 7)[:, None], junk, pats)
    trail = rng.integers(1, 6, size=B)[:, None]
    nmask = (((kind == 1)[:, None] & (col >= lens[:, None] - trail))
             | ((kind == 1)[:, None] & (col == 10))
             | ((kind == 2)[:, None] & (rng.random((B, L)) < 0.03))
             | (kind == 3)[:, None])
    pats = np.where(nmask, 5, pats)
    pats = np.where(col < lens[:, None], pats, 0).astype(np.int32)
    return pats, lens


def service_lanes(rng, codes, B, R=64, Lb=112, with_n=True, ops=range(8)):
    """A pattern bank and the (7, B) lane fields of one fuzzed service
    round (opc, row, off, ln, sp, ep, idx), every opcode of ``ops`` in
    the mix.  Bank rows, four kinds in turn: cut from the genome; cut with
    a few substitutions; random; cut with N's (``with_n``: inner ones, a
    leading and a trailing run, and the last row all N).  Slices are
    random, and every 32 lanes also ln of 0, -3 and 1, the whole row, a
    slice past the row's end and rows outside the bank.  mms_continue lanes
    carry the whole suffix array, a narrow interval or an empty one;
    mms_ext and bsearch_ext lanes on a cut row aim their window near the
    slice's origin; crank lanes carry symbols -1..6 and indices around
    [0, n]; unc_sa lanes rows in [0, n]."""
    import numpy as np

    n = len(codes)
    kind = np.arange(R) % 4
    cut = rng.integers(0, n - Lb, size=R)
    bank = codes[cut[:, None] + np.arange(Lb)].astype(np.uint8)
    subst = (rng.random((R, Lb)) < 0.04) & (kind == 1)[:, None]
    bank = np.where(subst, bank ^ rng.integers(1, 4, size=(R, Lb)), bank)
    junk = rng.integers(0, 4, size=(R, Lb))
    bank = np.where((kind == 2)[:, None], junk, bank).astype(np.uint8)
    if with_n:
        col = np.arange(Lb)[None, :]
        run = rng.integers(1, 9, size=R)[:, None]
        nmask = (kind == 3)[:, None] & (
            (rng.random((R, Lb)) < 0.04)
            | ((np.arange(R) % 8 == 3)[:, None] & (col >= Lb - run))
            | ((np.arange(R) % 8 == 7)[:, None] & (col < run)))
        nmask[R - 1] = True
        bank[nmask] = 5
    f = np.zeros((7, B), np.int32)
    opc = rng.choice(np.asarray(list(ops), np.int32), size=B)
    row = rng.integers(0, R, size=B)
    ln = rng.integers(1, Lb + 1, size=B)
    off = rng.integers(0, Lb - ln + 1)
    k = np.arange(B) % 32
    ln = np.select([k == 1, k == 2, k == 3, k == 4], [0, -3, 1, Lb], ln)
    off = np.where(k == 4, 0, off)
    off = np.where(k == 5, Lb - ln + 5, off)
    # a trailing-N slice, an all-N slice, rows outside the bank
    row = np.select([k == 6, k == 7, k == 8, k == 9],
                    [3 % R, R - 1, R + 3, -1], row)
    off = np.where(k == 6, Lb - ln, off)
    origin = cut[np.clip(row, 0, R - 1)] + off
    wide = rng.random(B) < 0.4
    sp_c = np.where(wide, 0, rng.integers(0, n + 1, size=B))
    ep_c = np.where(wide, n + 1, np.minimum(sp_c + rng.integers(1, 40, size=B),
                                            n + 1))
    ep_c = np.where(rng.random(B) < 0.2, sp_c - rng.integers(0, 2, size=B),
                    ep_c)  # an empty incoming interval
    sp = np.select(
        [opc == 2, opc == 6, opc == 7, opc == 5],
        [sp_c, origin + ln + rng.integers(-6, 7, size=B),
         np.where(rng.random(B) < 0.8, origin - rng.integers(0, 24, size=B),
                  rng.integers(-40, n + 40, size=B)),
         rng.integers(-1, 7, size=B)], 0)
    ep = np.select(
        [opc == 2, opc == 6, opc == 7],
        [ep_c, rng.integers(-5, 20, size=B), rng.integers(-2, 40, size=B)], 0)
    idx = np.select([opc == 4, opc == 5],
                    [rng.integers(0, n + 1, size=B),
                     rng.integers(-3, n + 4, size=B)], 0)
    f[:] = opc, row, off, ln, sp, ep, idx
    f[:, B - B // 16:] = 0  # padding lanes, as the executor leaves them
    return bank, f


def mutated_reads(rng, codes, n, length=READ_LEN):
    """``n`` reads cut at uniform starts, one substitution each."""
    import numpy as np

    starts = rng.integers(0, len(codes) - length, size=n)
    reads = codes[np.add.outer(starts, np.arange(length))].copy()
    mpos = rng.integers(0, length, size=n)
    reads[np.arange(n), mpos] ^= rng.integers(1, 4, size=n).astype(np.uint8)
    return starts, reads


def complemented_reads(rng, codes, n, length=50):
    """``n`` reads cut at uniform starts, one base complemented each
    (rnaseqtest.c:313-327's self-benchmark): starts, reads, and where each
    was complemented."""
    import numpy as np

    starts = rng.integers(0, len(codes) - length, size=n)
    reads = codes[np.add.outer(starts, np.arange(length))].copy()
    mpos = rng.integers(0, length, size=n)
    reads[np.arange(n), mpos] = 3 - reads[np.arange(n), mpos]
    return starts, reads, mpos


def dp_jobs(rng, B, L1, L2):
    """Random stitch jobs as the executor pads them: random lengths,
    zero padding, a few N's in the reads."""
    import numpy as np

    reads = np.zeros((B, L1), np.int32)
    genomes = np.zeros((B, L2), np.int32)
    rl = rng.integers(1, L1 + 1, size=B)
    gl = rng.integers(1, L2 + 1, size=B)
    r = rng.integers(0, 4, size=(B, L1)).astype(np.int32)
    r[rng.random((B, L1)) < 0.02] = 5
    g = rng.integers(0, 4, size=(B, L2)).astype(np.int32)
    col1, col2 = np.arange(L1)[None, :], np.arange(L2)[None, :]
    reads[col1 < rl[:, None]] = r[col1 < rl[:, None]]
    genomes[col2 < gl[:, None]] = g[col2 < gl[:, None]]
    return reads, genomes


def cuda_ms(fn, reps: int, ahead: bool = False) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events.  With ``ahead``
    the card first spins for longer than the host takes to enqueue all
    ``reps`` calls, so that a kernel shorter than its wrapper's host time
    is timed back to back and not at the host's pace.  The spin is
    ``torch.cuda._sleep``, a private call that takes cycles: 2 GHz is
    assumed, and twice the host's time asked for, so a card clocked
    anywhere near that spins long enough."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    if ahead:
        h0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_s = time.perf_counter() - h0
        torch.cuda.synchronize()
        torch.cuda._sleep(int(2.0e9 * (2 * host_s + 1e-3)))  # cycles
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound_of(nbytes: float, ops: float) -> dict:
    """The least time for ``nbytes`` of traffic and ``ops`` operations,
    and which of the two sets it."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / OPS_PER_S * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bytes=int(nbytes), ops=int(ops))


def device_profile(fn) -> dict:
    """One torch.profiler window over ``fn()``: traced wall, device busy
    time, device operations, and time and count by device-op name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for k in prof.key_averages():
        if k.device_type == DeviceType.CUDA:
            n, ms = by_name.get(k.key, (0, 0.0))
            by_name[k.key] = (n + k.count,
                              ms + k.self_device_time_total / 1e3)
    busy = sum(ms for _, ms in by_name.values())
    require(busy > 0, "torch.profiler saw no device time")
    return dict(wall_s=wall, busy_ms=busy,
                ops=sum(n for n, _ in by_name.values()), by_name=by_name)


def phase_kernel(rng, tag):
    """Phase 2: the DP kernel against its plain twin, bit-equal."""
    import torch

    from bwt_tpu_torch.ops import dp_wavefront as dw

    cases = [(B, L1, L2, None) for L1, L2 in DP_SHAPES for B in (8, 1024)]
    cases.append((1024, 32, 64, ALT_SCORING))
    cases.append((*TALL_SHAPE, None))
    cases.append((NW_PAIRS, *NW_SHAPE, None))  # what nw_fast_batch sends
    rows = []
    for B, L1, L2, scoring in cases:
        r_np, g_np = dp_jobs(rng, B, L1, L2)
        r = torch.from_numpy(r_np).cuda()
        g = torch.from_numpy(g_np).cuda()
        vk, pk = dw.dp_fill_wavefront(r, g, scoring=scoring)
        vp, pp = dw.dp_fill_wavefront_plain(r, g, scoring=scoring)
        torch.cuda.synchronize()
        err = int((vk - vp).abs().max())
        require(torch.equal(vk, vp) and torch.equal(pk, pp),
                f"dp_wavefront kernel differs from its plain twin at "
                f"B={B} L1={L1} L2={L2} scoring={scoring}: max |dv| {err}")
        ms = cuda_ms(lambda: dw.dp_fill_wavefront(r, g, scoring=scoring), 20,
                     ahead=True)
        plain_ms = cuda_ms(
            lambda: dw.dp_fill_wavefront_plain(r, g, scoring=scoring), 3)
        cells = B * (L1 + L2 + 1) * (L1 + 1)  # stored, by diagonal and row
        bound = bound_of(4 * (r.numel() + g.numel()) + 8 * cells,
                         DP_CELL_OPS * cells)
        rows.append(dict(B=B, L1=L1, L2=L2, scoring=scoring or "default",
                         max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound))
        print(f"phase 2 dp_wavefront B={B} L1={L1} L2={L2} "
              f"scoring={scoring or 'default'}: bit-equal (tolerance 0, "
              f"max |dv| {err}), kernel {ms:.4f} "
              f"ms, plain {plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} "
              f"ms by {bound['bound_by']} {tag}", flush=True)
    return rows


def stitch_jobs(rng, B, L1, L2, R=64, G=1 << 16):
    """A pattern bank, a genome and (8, B) job fields as the executor makes
    them: both directions, nw and sw, rlen 0 and L1, glen 0 and L2, N's
    in the reads and an all-N read, reads cut from the genome (every
    diagonal step is a run of its own, so these pass the 40 kept runs
    where the shape allows), and a tail of all-zero padding lanes."""
    import numpy as np

    Lb = L1 + 16
    genome = rng.integers(0, 4, size=G).astype(np.int32)
    genome[:2 * L2] = 0  # a repeat: long gap runs
    bank = rng.integers(0, 4, size=(R, Lb)).astype(np.int32)
    bank[rng.random(bank.shape) < 0.02] = 5
    bank[R - 1] = 5
    cut = rng.integers(0, G - Lb, size=R // 4)
    bank[: R // 4] = genome[cut[:, None] + np.arange(Lb)]
    n = B - B // 8
    f = np.zeros((8, B), np.int32)
    f[0, :n] = rng.integers(0, R, size=n)
    f[2, :n] = rng.integers(0, L1 + 1, size=n)
    f[1, :n] = rng.integers(0, Lb - f[2, :n] + 1)
    f[3, :n] = rng.integers(0, 2, size=n)
    f[5, :n] = rng.integers(0, L2 + 1, size=n)
    f[4, :n] = rng.integers(0, G - L2, size=n)
    f[6, :n] = rng.integers(0, 2, size=n)
    f[7, :n] = rng.integers(0, 2, size=n)
    exact = np.arange(0, n, 4)  # forward reads against their own origin
    f[0, exact] = rng.integers(0, R // 4, size=exact.size)
    f[1, exact], f[2, exact], f[3, exact] = 0, L1, 0
    f[4, exact] = cut[f[0, exact]]
    f[5, exact], f[6, exact] = min(L1 + 3, L2), 0
    for k, rl, gl in ((1, 0, L2), (2, L1, 0), (3, 0, 0), (5, L1, L2)):
        if k < n:
            f[1, k], f[2, k], f[5, k] = 0, rl, gl
    if n > 6:
        f[0, 6] = R - 1  # the all-N read
    return bank, genome, f


def compose_edge_rows(rng, Bp):
    """A random log (an aligner automaton's packed output over ``Bp``
    reads) and the stitches' accumulators that push the compose to its
    edges: log pointers past the 16 slots, every kind of entry, blocks of
    0 to BLOCK_W + 3 entries (past the block: its last entry again, and
    streams past F2), runs of every op with counts up to 40,000 (merged
    counts past 254 and past int16), more runs than K and than 8, and every
    meta bit.  Returns (log, acc), CPU int32 tensors."""
    import numpy as np
    import torch

    from bwt_tpu_torch.ops import automaton as au
    from bwt_tpu_torch.ops import dp_wavefront as dw

    W, N = dw.BLOCK_W, au.LOGN
    log = np.zeros(au.align_flag_offset(Bp) + 4, np.int32)
    cols = dict(mode=rng.integers(0, 3, Bp), curpos=rng.integers(-5, 1 << 25, Bp),
                strand=rng.integers(0, 2, Bp), lp=rng.integers(0, N + 5, Bp),
                ovf=rng.integers(0, 2, Bp), capped=rng.integers(0, 2, Bp),
                iters=rng.integers(0, 9, Bp))
    for k, c in enumerate(au.ALIGN_COLS):
        log[k * Bp:(k + 1) * Bp] = cols[c]
    base = len(au.ALIGN_COLS) * Bp
    kinds = rng.integers(1, 6, (Bp, N))
    glens = np.where(rng.random((Bp, N)) < 0.1,
                     rng.integers(0, 30000, (Bp, N)),
                     rng.integers(0, 300, (Bp, N)))
    for k, x in ((0, kinds), (3, glens)):
        log[base + k * N * Bp:base + (k + 1) * N * Bp] = x.reshape(-1)
    ops = rng.integers(0, 3, (Bp, N, W))
    cnt = np.where(rng.random((Bp, N, W)) < 0.05,
                   rng.integers(0, 40000, (Bp, N, W)),
                   rng.integers(0, 40, (Bp, N, W)))
    acc = np.concatenate([
        (((ops + 2) << 24) | cnt).reshape(-1),
        rng.integers(0, W + 4, (Bp, N)).reshape(-1),
        rng.integers(-5, 1 << 20, Bp), rng.integers(0, 2, Bp)]).astype(np.int32)
    return torch.from_numpy(log), torch.from_numpy(acc)


def log_edge_jobs(rng, Bp=32, Lb=80, G=4096):
    """Phase B's stitch jobs made by hand in a packed K10 output of ``Bp``
    reads: (log, bank (2 Bp, Lb), genome (G,), jk, jt), int32 CPU tensors.
    Every kind (NW tail, SW fill, head) at rlen 0 (row 0 is the end row),
    glen < 0 (no matrix), glen 0, rlen 32 (the 33rd row of a 32-row
    bucket) and 64, reads that run past their bank row or genome slices
    past the genome's end (the clamps), reads with N's, reads cut from the
    genome with every third genome base deleted (a run a step: more runs
    than the 40 kept), two head stitches on one read (their endpoints
    summed), and random jobs up to 64 x 96."""
    import numpy as np
    import torch

    from bwt_tpu_torch.ops import automaton as au

    log = torch.zeros(au.align_flag_offset(Bp) + 4, dtype=torch.int32)
    v = au.align_unpack(log)
    genome = rng.integers(0, 4, size=G).astype(np.int32)
    bank = rng.integers(0, 4, size=(2 * Bp, Lb)).astype(np.int32)
    bank[rng.random(bank.shape) < 0.02] = 5
    strand = rng.integers(0, 2, size=Bp).astype(np.int32)
    v["strand"][:] = torch.from_numpy(strand)
    jobs = []  # (lane, kind, roff, rlen, gstart, glen)
    kinds = (au.K_NW, au.K_SW, au.K_HEAD)
    for kind in kinds:
        for rlen, glen in ((0, 10), (0, 0), (5, -2), (7, 0), (32, 32),
                           (32, 64), (32, 40), (64, 64), (20, 70)):
            jobs.append((None, kind, None, rlen, None, glen))
    jobs += [(None, au.K_SW, Lb - 6, 20, None, 30),   # past the bank row
             (None, au.K_NW, 3, 25, G - 12, 40)]     # past the genome
    for k in range(6):  # a run a step: 32 matches and 16 deletions
        lane = len(jobs) % Bp
        at = int(rng.integers(0, G - 64))
        src = genome[at:at + 48]
        row = 2 * lane + int(strand[lane])
        bank[row, :32] = np.delete(src, np.arange(2, 48, 3))
        jobs.append((lane, kinds[k % 3] if k % 3 != 2 else au.K_SW, 0, 32,
                     at, 48))
    for _ in range(60):
        rlen = int(rng.integers(1, 65))
        glen = int(rng.integers(1, 97))
        jobs.append((None, kinds[int(rng.integers(0, 3))], None, rlen, None,
                     glen))
    slots = np.zeros(Bp, np.int64)
    jk, jt = [], []
    for i, (lane, kind, roff, rlen, gstart, glen) in enumerate(jobs):
        if lane is None:
            lane = i % Bp
            while slots[lane] >= au.LOGN:
                lane = (lane + 1) % Bp
        if roff is None:
            roff = int(rng.integers(0, max(Lb - rlen, 0) + 1))
        if gstart is None:
            gstart = int(rng.integers(0, G - max(glen, 0) + 1))
        t = int(slots[lane])
        slots[lane] += 1
        for name, x in (("kinds", kind), ("roffs", roff), ("rlens", rlen),
                        ("gstarts", gstart), ("glens", glen)):
            v[name][lane, t] = x
        jk.append(lane)
        jt.append(t)
    # two head stitches on one read: its endpoint is their sum
    lane = int(np.argmin(slots))
    for _ in range(2):
        t = int(slots[lane])
        slots[lane] += 1
        v["kinds"][lane, t], v["roffs"][lane, t] = au.K_HEAD, 0
        v["rlens"][lane, t], v["glens"][lane, t] = 30, 40
        v["gstarts"][lane, t] = int(rng.integers(0, G - 40))
        jk.append(lane)
        jt.append(t)
    v["lp"][:] = torch.from_numpy(slots.astype(np.int32))
    return (log, torch.from_numpy(bank), torch.from_numpy(genome),
            torch.tensor(jk, dtype=torch.int32),
            torch.tensor(jt, dtype=torch.int32))


def phase_stitch(rng, tag):
    """Phase 2, the fused stitch: both outputs (the six packed ones, the
    op rows) against the plain version, bit-equal; timed beside its bound
    and the path it replaces."""
    import torch

    import numpy as np

    from bwt_tpu_torch.ops import dp_wavefront as dw

    # (B, L1, L2, scoring, the read-back form's threshold: None for the
    # default, 0 to send the shape through that form)
    cases = [(B, L1, L2, None, None) for L1, L2 in DP_SHAPES
             for B in (8, 1024)]
    cases.append((1024, 32, 64, ALT_SCORING, None))
    cases.append((*TALL_SHAPE, None, None))
    cases.append((*TALL_SHAPE, None, 0))
    cases.append((*TRUE_TALL_SHAPE, None, None))
    names = ("maxloc", "i_resid", "j_resid", "nrun", "vals", "counts", "ops")
    rows = []
    for B, L1, L2, scoring, tall_rows in cases:
        form = ("tall (read-back), through the hook" if tall_rows == 0
                else "tall (read-back)" if L1 > dw._TALL_ROWS
                else "warp" if L1 < 128 else "block")
        # the read-back form's cases draw from their own generator, so
        # that the later phases' inputs stay those of earlier runs
        tall = tall_rows is not None or L1 > dw._TALL_ROWS
        bank_np, genome_np, f_np = stitch_jobs(
            np.random.default_rng(L1 + B) if tall else rng, B, L1, L2,
            R=8 if B < 8 else 64)
        bank = torch.from_numpy(bank_np).cuda()
        genome = torch.from_numpy(genome_np).cuda()
        f = list(torch.from_numpy(f_np).cuda().unbind(0))
        kw = dict(L1=L1, L2=L2, scoring=scoring)
        default_rows = dw._TALL_ROWS
        dw._TALL_ROWS = default_rows if tall_rows is None else tall_rows
        try:
            P, ops = dw.dp_stitch(bank, genome, *f, **kw)
            (Pp, opsp), plain_ms = _event_ms(
                lambda: dw.dp_stitch_plain(bank, genome, *f, **kw))
            got, want = (*dw.unpack(P), ops), (*dw.unpack(Pp), opsp)
            del Pp, opsp
            err = _max_abs_diff(got, want)
            bad = [n for n, a, b in zip(names, got, want)
                   if a.shape != b.shape or a.dtype != b.dtype
                   or not torch.equal(a, b)]
            require(not bad, f"dp_stitch ({form}) differs from its plain "
                             f"version at B={B} L1={L1} L2={L2} "
                             f"scoring={scoring} in {bad}: max |d| {err}")
            ms = cuda_ms(lambda: dw.dp_stitch(bank, genome, *f, **kw),
                         20 if B > 2 else 5, ahead=True)
        finally:
            dw._TALL_ROWS = default_rows
        del want
        torch.cuda.empty_cache()
        # the path the kernel replaces: the same eager program around the
        # fill kernel; host-bound, so its wall (not taken for the tall
        # forms: the fill's output alone is B x D x (L1 + 1) ints twice)
        unfused_ms = None
        if tall_rows is None and L1 <= dw._TALL_ROWS:
            unfused = lambda: dw.dp_stitch_plain(  # noqa: E731
                bank, genome, *f, fill=dw.dp_fill_wavefront, **kw)
            unfused()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            unfused()
            torch.cuda.synchronize()
            unfused_ms = (time.perf_counter() - t0) * 1e3
        rlen, glen = f[2].long(), f[5].long()
        i0, jmax = rlen.clamp(0, L1), glen.clamp(max=L2)
        cells = int(((i0 + 1) * (jmax + 1).clamp(min=0)).sum())
        steps = int((got[6] != 3).sum())
        over = int((got[3] > dw.RLE_R).sum())
        bound = bound_of(
            4 * (8 * B + int(i0.sum()) + int(jmax.clamp(min=0).sum())
                 + sum(t.numel() for t in got)),
            DP_CELL_OPS * cells + steps)
        rows.append(dict(B=B, L1=L1, L2=L2, scoring=scoring or "default",
                         form=form, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, unfused_wall_ms=unfused_ms,
                         cells=cells, walk_steps=steps, over_runs=over,
                         **bound))
        replaced = ("not run" if unfused_ms is None
                    else f"{unfused_ms:.4f} ms of wall")
        print(f"phase 2 dp_stitch B={B} L1={L1} L2={L2} "
              f"scoring={scoring or 'default'}, {form} form: the packed "
              f"outputs and the op rows bit-equal "
              f"(tolerance 0, max |d| {err}), {over} jobs past "
              f"{dw.RLE_R} runs, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound['bound_ms']:.4f} ms by {bound['bound_by']} "
              f"({bound['bytes']} bytes, {bound['ops']} operations); the "
              f"eager path around the fill kernel that it replaces: "
              f"{replaced} {tag}", flush=True)
        del P, ops, got, bank, genome, f
        torch.cuda.empty_cache()
    return rows


def phase_build(codes_np, device, tag):
    """Phase 3: the index build, timed, then built again with the
    suffix-array check (verify_suffix_array); returns the index."""
    import torch

    import bwt_tpu_torch

    n = len(codes_np)
    bwt_tpu_torch.build_index(codes_np[: 1 << 16], sa_sample_rate=4,
                              device=device)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fmi = bwt_tpu_torch.build_index(codes_np, sa_sample_rate=4, device=device)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    del fmi
    t0 = time.perf_counter()
    fmi = bwt_tpu_torch.build_index(codes_np, sa_sample_rate=4, verify=True,
                                    device=device)  # raises if the SA is wrong
    torch.cuda.synchronize()
    dtv = time.perf_counter() - t0
    require(int(fmi.C[4]) == n + 1 and fmi.sa_samples.shape[0] == 1 + n // 4,
            "index C totals or sample count wrong")
    print(f"phase 3 build_index n={n} sa_rate=4: {dt:.3f} s "
          f"({n / dt / 1e6:.3f} Mb/s), peak device memory "
          f"{peak / 2**30:.3f} GiB; rebuilt with verify_suffix_array: SA "
          f"verified ({dtv:.3f} s with the check) {tag}", flush=True)
    return fmi, dict(n=n, build_s=dt, mbps=n / dt / 1e6,
                     peak_gib=peak / 2**30, build_verify_s=dtv)


def phase_locate(fmi, codes_np, rng, nq, tag, plen=30, keep=None):
    """Phase 4: locate random k-mers, plain and seeded, one launch of the
    fused kernel a call, every position checked; count_matches through
    the standalone K3.  Returns the report, the seed table and the
    patterns; the plain positions and the counts go to ``keep``."""
    import numpy as np
    import torch

    from bwt_tpu_torch.ops import search

    dev = fmi.device
    starts = rng.integers(0, len(codes_np) - plen, size=nq)
    pats_np = codes_np[np.add.outer(starts, np.arange(plen))].astype(np.int32)
    pats = torch.from_numpy(pats_np).to(dev)
    lens = torch.full((nq,), plen, dtype=torch.int32, device=dev)
    g = torch.from_numpy(codes_np).to(dev).to(torch.int32)
    search.build_seed_table(fmi, k=4)  # warm-up
    torch.cuda.synchronize()
    search.SEED_LAUNCHES = 0
    t0 = time.perf_counter()
    table = search.build_seed_table(fmi, k=SEED_K)
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    # K5 is one launch for the whole table: its thread a prefix key expands
    # the last search.SEED_FUSED levels itself
    require(search.SEED_LAUNCHES == 1,
            f"the seed table was built by {search.SEED_LAUNCHES} launches of "
            f"the K5 kernel, not 1")
    report = dict(n=nq, seed_k=SEED_K, seed_table_s=table_s, seed_launches=1)
    for name, st in (("plain", None), (f"seeded k={SEED_K}", table)):
        search.locate(fmi, pats[:1024], lens[:1024], seed_table=st)  # warm-up
        torch.cuda.synchronize()
        walls = []
        for _ in range(2):  # the first call at this size also allocates
            search.LOCATE_LAUNCHES = search.BS_LAUNCHES = 0
            search.UNC_LAUNCHES = 0
            t0 = time.perf_counter()
            pos = search.locate(fmi, pats, lens, seed_table=st)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches = (search.LOCATE_LAUNCHES, search.BS_LAUNCHES,
                        search.UNC_LAUNCHES)
            require(launches == (1, 0, 0),
                    f"locate ({name}) is not one launch of the locate "
                    f"kernel: locate, K3, K4 launches {launches}")
        dt = walls[1]
        require(bool(((pos >= 0) & (pos <= len(codes_np) - plen)).all()),
                f"locate ({name}) returned a position outside the genome")
        win = g[(pos.long()[:, None] + torch.arange(plen, device=dev))]
        require(bool((win == pats).all()),
                f"a located position ({name}) does not hold its pattern")
        key = "plain" if st is None else "seeded"
        report[key] = dict(s=dt, per_s=nq / dt, first_s=walls[0], launches=1)
        if keep is not None and st is None:
            keep["locate_pos"] = pos.cpu().numpy()
        print(f"phase 4 locate {nq} x {plen}-mers ({name}): all positions "
              f"checked, {nq / dt:.1f} locates/s ({dt:.6f} s; the first call "
              f"at this size, which also allocates, {walls[0]:.6f} s), "
              f"locate kernel launches 1 a call, K3 and K4 launches 0 {tag}",
              flush=True)
    search.BS_LAUNCHES = 0
    t0 = time.perf_counter()
    counts = search.count_matches(fmi, pats, lens)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    require(search.BS_LAUNCHES == 1, "count_matches did not launch K3 once")
    require(bool((counts >= 1).all()), "a pattern cut from the genome has "
                                       "no match")
    report["count_matches"] = dict(s=dt, per_s=nq / dt, bs_launches=1)
    if keep is not None:
        keep.update(counts=counts.cpu().numpy(), kmers=(pats, lens))
    print(f"phase 4 count_matches {nq} x {plen}-mers: every count >= 1, "
          f"{nq / dt:.1f} patterns/s ({dt:.6f} s), K3 launches 1 {tag}",
          flush=True)
    print(f"phase 4 seed table k={SEED_K}: {4 ** SEED_K} rows built by one "
          f"launch of the K5 kernel in {table_s:.6f} s (allocation of its "
          f"{24 * 4 ** SEED_K} bytes included) {tag}", flush=True)
    return report, table, (pats, lens)


def _cigar_read_len(cig) -> int:
    return sum(c for op, c in cig.ops if op in "MI")


def indel_reads(rng, codes, n, length=READ_LEN):
    """``n`` reads cut at uniform starts, each with one insertion or
    deletion of 1 to 3 bases between its 10th and 70th base."""
    import numpy as np

    starts = rng.integers(0, len(codes) - length - 3, size=n)
    reads = np.empty((n, length), np.uint8)
    for k, s in enumerate(starts.tolist()):
        r = codes[s:s + length + 3]
        at, d = int(rng.integers(10, 70)), int(rng.integers(1, 4))
        if k % 2:
            r = np.concatenate([r[:at], r[at + d:]])
        else:
            r = np.concatenate([r[:at], rng.integers(0, 4, d).astype(np.uint8),
                                r[at:]])
        reads[k] = r[:length]
    return starts, reads


def _align_counts(zero=False):
    """The launch counts of every kernel single_align can reach, set to 0
    with ``zero``."""
    from bwt_tpu_torch.ops import automaton, compose, dp_wavefront, search
    from bwt_tpu_torch.ops import service

    where = ((automaton, "ALIGN_LAUNCHES"), (dp_wavefront, "LOG_STITCH_LAUNCHES"),
             (compose, "COMPOSE_LAUNCHES"), (service, "SERVICE_LAUNCHES"),
             (dp_wavefront, "STITCH_LAUNCHES"), (dp_wavefront, "LAUNCHES"),
             (search, "BS_LAUNCHES"), (search, "UNC_LAUNCHES"),
             (search, "ISA_LAUNCHES"), (automaton, "AUTOMATON_LAUNCHES"),
             (search, "LOCATE_LAUNCHES"))
    if zero:
        for mod, name in where:
            setattr(mod, name, 0)
    return dict(zip(("K10", "K11a", "K11b", "K7", "stitch", "fill", "K3", "K4",
                     "K6", "K9", "locate"), (getattr(m, n) for m, n in where)))


def _norm(results):
    return [(p, c.render() if c else None, s) for p, c, s in results]


def write_fastq(path: Path, reads) -> None:
    """(n, L) code rows as FastQ records: ``@r<i>``, the bases, ``+`` and a
    quality line of 'I's."""
    from bwt_tpu_torch import codec

    n, L = reads.shape
    flat = codec.decode(reads.reshape(-1))
    qual = "I" * L
    path.write_text("".join(f"@r{i}\n{flat[i * L:(i + 1) * L]}\n+\n{qual}\n"
                            for i in range(n)))


def check_sam(text: str, results, reads, ref_name: str) -> None:
    """Every record of ``format_sam``'s text carries its result: FLAG 4, 0
    or 16, POS, the CIGAR and SEQ in the reference's orientation."""
    from bwt_tpu_torch import codec

    lines = text.splitlines()
    require(len(lines) == 3 + len(results) and lines[2].startswith(
        "@PG\tID:bwt_tpu_torch"), "format_sam: not a header and a record "
                                  "a read")
    for k, (line, (p, c, rev), read) in enumerate(zip(lines[3:], results,
                                                      reads)):
        f = line.split("\t")
        seq = codec.decode(codec.revcomp(read) if p and rev else read)
        want = ([f"read{k}", "4", "*", "0", "0", "*"] if not p else
                [f"read{k}", "16" if rev else "0", ref_name, str(p), "255",
                 c.render() if c is not None and c else "*"])
        require(f[:6] == want and f[9] == seq,
                f"format_sam: read {k}'s record {f[:6]} is not its result "
                f"{want}")


def phase_align(fmi, codes_np, rng, nreads, tag, workdir: Path,
                nindel=4096, subset=512, forced=4096, keep=None):
    """Phase 5: single_align through align_reads on bench.py's reads (80 bp,
    one substitution each) and on reads with one indel each: the default
    engine, the device automaton and its phase B, against the host engine
    on the same reads; the substitution reads again from a FastQ file
    through the C++ loader, rendered as SAM; subsets through the plain
    versions, on a CPU copy of the index and at a forced cap."""
    import numpy as np

    from bwt_tpu_torch import native
    from bwt_tpu_torch.models import aligner
    from bwt_tpu_torch.models.batch_exec import QueryService
    from bwt_tpu_torch.ops import service
    from bwt_tpu_torch.utils import sam

    starts, reads = mutated_reads(rng, codes_np, nreads)
    istarts, ireads = indel_reads(rng, codes_np, nindel)
    svc = QueryService(fmi, codes_np)
    aligner.align_reads(fmi, codes_np, reads[:64], service=svc)  # warm-up

    def drive(what, batch, **kw):
        _align_counts(zero=True)
        t0 = time.perf_counter()
        out = aligner.align_reads(fmi, codes_np, batch, service=svc,
                                  with_strand=True, **kw)
        dt = time.perf_counter() - t0
        return out, dt, _align_counts(), dict(svc.last_stats)

    def device_engine(what, batch):
        res, dt, counts, st = drive(what, batch)
        chunks = -(-len(batch) // svc.config.search_batch)
        require(counts["K10"] == st["align_launches"] == st["chunks"]
                == chunks, f"{what}: {counts['K10']} K10 launches for "
                           f"{chunks} chunks ({st})")
        require(counts["K11b"] == st["compose_launches"] == chunks,
                f"{what}: {counts['K11b']} K11b launches for {chunks} "
                f"chunks")
        require(counts["K11a"] == st["log_stitch_launches"] == st["buckets"]
                > 0, f"{what}: {counts['K11a']} K11a launches for "
                     f"{st['buckets']} non-empty buckets")
        # the host engine runs only the escapes: K7 and the executor's
        # stitch for the fallback, the stitch for the redo
        require(counts["K7"] == 0 or st["fallback"] > 0,
                f"{what}: {counts['K7']} K7 launches without a fallback")
        require(counts["stitch"] == 0 or st["fallback"] + st["redo"] > 0,
                f"{what}: {counts['stitch']} executor stitches without an "
                f"escape")
        require(counts["fill"] + counts["K3"] + counts["K4"] + counts["K6"]
                + counts["K9"] == 0, f"{what}: another kernel ran {counts}")
        return dict(res=res, s=dt, counts=counts, stats=st, n=len(batch))

    runs = {what: device_engine(what, batch)
            for what, batch in (("subst", reads), ("indel", ireads))}
    if keep is not None:  # the reads and their results, for phase 11
        keep["align"] = {what: (batch, _norm(runs[what]["res"])) for what, batch
                         in (("subst", reads), ("indel", ireads))}

    # the substitution reads from a FastQ file, as the CLI reads one: the
    # C++ loader, then the default engine with strands and the SAM text
    require(native.available(), "the C++ loader did not build "
                                "(native.available() is false)")
    workdir.mkdir(parents=True, exist_ok=True)
    fq = workdir / "subst.fq"
    write_fastq(fq, reads)
    t0 = time.perf_counter()
    fq_codes, fq_lens = native.load_fastq(fq)
    load_s = time.perf_counter() - t0
    fq_reads = [np.asarray(fq_codes[b, :fq_lens[b]], np.uint8)
                for b in range(fq_codes.shape[0])]
    fastq = device_engine("fastq", fq_reads)
    require(_norm(fastq["res"]) == _norm(runs["subst"]["res"]),
            "the reads from the FastQ file align otherwise than the same "
            "reads as a code matrix")
    t0 = time.perf_counter()
    text = sam.format_sam(fastq["res"], fq_reads, ref_name="genome",
                          ref_len=len(codes_np))
    sam_s = time.perf_counter() - t0
    check_sam(text, fastq["res"], fq_reads, "genome")
    fastq.update(load_fastq_s=load_s, format_sam_s=sam_s,
                 sam_bytes=len(text))
    del fastq["res"], text

    # the host engine on the same reads; its service rounds are kept for
    # phase 7, which times K7 on them (pick_rounds)
    recorded, launch = {"subst": [], "indel": []}, service.service_round_packed
    host = {}
    for what, batch in (("subst", reads), ("indel", ireads)):
        def recording(fmi_, bank, *fields, what=what, **kw):
            recorded[what].append((bank, fields, kw))
            return launch(fmi_, bank, *fields, **kw)

        service.service_round_packed = recording
        try:
            res, dt, counts, st = drive(what, batch, engine="host")
        finally:
            service.service_round_packed = launch
        require(counts["K7"] == st["svc_calls"] == st["svc_launches"] > 0,
                f"host engine: {counts['K7']} K7 launches for "
                f"{st['svc_calls']} service calls")
        require(counts["stitch"] == st["dp_calls"] > 0 and counts["fill"] == 0,
                f"host engine: {counts['stitch']} stitch launches for "
                f"{st['dp_calls']} DP calls, {counts['fill']} fills")
        bad = [k for k, (a, b) in enumerate(zip(_norm(res),
                                                _norm(runs[what]["res"])))
               if a != b]
        require(not bad, f"{what}: the device engine and the host engine "
                         f"differ on {len(bad)} reads, first {bad[:5]}")
        host[what] = dict(s=dt, counts=counts, stats=st)

    # a CIGAR of a substitution read consumes the read; one of an indel read
    # may miss it by the gap fill's width: an I run after a gap counts the
    # genome's overlap, not the read characters skipped (the reference's,
    # and bwt_tpu's, semantics), so there the offsets are counted
    for what, rs, st0 in (("subst", runs["subst"]["res"], starts),
                          ("indel", runs["indel"]["res"], istarts)):
        off = {}
        for k, (p, cig, _) in enumerate(rs):
            if p:
                d = _cigar_read_len(cig) - READ_LEN
                off[d] = off.get(d, 0) + 1
                require(d == 0 if what == "subst" else abs(d) <= 3,
                        f"{what} read {k}: CIGAR {cig.render()} consumes "
                        f"{READ_LEN + d} of its {READ_LEN} bases")
        runs[what]["consumed_off"] = dict(sorted(off.items()))
        at = np.array([p == s + 1 and not r for (p, _, r), s in
                       zip(rs, st0.tolist())])
        runs[what]["at_true"] = float(at.mean())
        runs[what]["aligned"] = sum(1 for p, _, _ in rs if p)
    require(runs["subst"]["at_true"] >= 0.5,
            f"only {runs['subst']['at_true']:.3f} of reads at their true start")

    # subsets: through the plain versions on the card (svc_impl, dp_impl),
    # on a CPU copy of the index, and at a forced cap of 4 iterations
    half = subset // 2
    sub = list(reads[:half]) + list(ireads[:half])
    want = _norm(runs["subst"]["res"][:half] + runs["indel"]["res"][:half])
    svc.svc_impl = svc.dp_impl = "plain"
    t0 = time.perf_counter()
    plain = aligner.align_reads(fmi, codes_np, sub, service=svc,
                                with_strand=True)
    plain_s = time.perf_counter() - t0
    require(svc.last_stats["align_launches"] == 0
            and svc.last_stats["log_stitch_launches"] == 0
            and svc.last_stats["compose_launches"] == 0,
            "svc_impl = dp_impl = 'plain' launched K10, K11a or K11b")
    svc.svc_impl = svc.dp_impl = "kernel"
    t0 = time.perf_counter()
    on_cpu = aligner.align_reads(fmi.to("cpu"), codes_np, sub,
                                 with_strand=True)
    cpu_s = time.perf_counter() - t0
    require(_norm(plain) == want and _norm(on_cpu) == want,
            f"single_align differs on the {subset}-read subset between the "
            f"kernels, their plain versions on the card and the CPU")
    aligner._TEST_CAP = 4
    try:
        capped = aligner.align_reads(fmi, codes_np, reads[:forced],
                                     service=svc, with_strand=True)
    finally:
        aligner._TEST_CAP = 0
    ncapped = svc.last_stats["capped"]
    require(ncapped > 0 and _norm(capped) == _norm(
        runs["subst"]["res"][:forced]),
        f"the forced cap ({ncapped} reads capped) changed a result")

    for what in ("subst", "indel"):
        r, h = runs[what], host[what]
        st, c = r["stats"], r["counts"]
        print(f"phase 5 single_align {r['n']} x {READ_LEN} bp, "
              f"{'one substitution' if what == 'subst' else 'one 1-3-base indel'}"
              f" each, engine 'auto' (the device engine): "
              f"{r['n'] / r['s']:.1f} reads/s ({r['s']:.4f} s), "
              f"{r['aligned']} aligned, {r['at_true']:.4f} at their true "
              f"start, CIGARs by read bases consumed minus {READ_LEN} "
              f"{r['consumed_off']}; launches K10 {c['K10']} ({st['chunks']} chunks), "
              f"K11a {c['K11a']} ({st['buckets']} non-empty buckets), K11b "
              f"{c['K11b']}; escapes: {st['redo']} reads re-composed on the "
              f"host, {st['fallback']} re-run on the host engine "
              f"({st['capped']} capped), which launched K7 {c['K7']} and the "
              f"executor's stitch {c['stitch']} times; no fill, K3, K4, K6 "
              f"or K9; the host's clocks: registering, upload and launch "
              f"{st['t_a']:.4f} s, waiting for the bucket counts and the "
              f"stitch and compose launches {st['t_b']:.4f} s, waiting for "
              f"the rows and building the results {st['t_fetch']:.4f} s, "
              f"the escapes {st['t_escapes']:.4f} s; equal on every read to "
              f"the host engine, "
              f"{r['n'] / h['s']:.1f} reads/s ({h['s']:.3f} s, "
              f"{h['stats']['svc_calls']} K7 and {h['stats']['dp_calls']} "
              f"stitch launches) {tag}", flush=True)
    c = fastq["counts"]
    print(f"phase 5 single_align from FastQ: {nreads} reads through "
          f"native.load_fastq ({load_s:.4f} s on the host, the compiled "
          f"loader) and align_reads(with_strand=True), engine 'auto' "
          f"({fastq['s']:.4f} s; launches K10 {c['K10']}, K11a {c['K11a']}, "
          f"K11b {c['K11b']}): positions, CIGARs and strands equal to the "
          f"code-matrix run; format_sam {sam_s:.4f} s on the host for "
          f"{fastq['sam_bytes']} bytes, every record its read's result "
          f"{tag}", flush=True)
    print(f"phase 5 single_align subsets: {subset} reads ({half} of each "
          f"kind) equal through the plain versions on the card "
          f"({plain_s:.3f} s) and on a CPU copy of the index ({cpu_s:.3f} "
          f"s); at a forced cap of 4 iterations {ncapped} of {forced} reads "
          f"capped and re-run on the host, results equal {tag}", flush=True)
    picked = (pick_rounds("single_align's substitution reads",
                          recorded["subst"])
              + pick_rounds("single_align's indel reads", recorded["indel"]))
    s, i = runs["subst"], runs["indel"]
    out = dict(
        n=nreads, s=s["s"], per_s=nreads / s["s"], at_true=s["at_true"],
        aligned=s["aligned"], stats=s["stats"], counts=s["counts"],
        indel=dict(n=nindel, s=i["s"], per_s=nindel / i["s"],
                   at_true=i["at_true"], stats=i["stats"],
                   counts=i["counts"], consumed_off=i["consumed_off"]),
        host={k: dict(s=v["s"], counts=v["counts"], stats=v["stats"])
              for k, v in host.items()},
        fastq=fastq,
        plain_subset_s=plain_s, cpu_subset_s=cpu_s, forced_capped=ncapped,
        launches={k: s["counts"][k] + i["counts"][k] + fastq["counts"][k]
                  for k in s["counts"]},
        host_launches={k: host["subst"]["counts"][k]
                       + host["indel"]["counts"][k]
                       for k in s["counts"]})
    return out, picked, (reads, ireads)


def phase_nw_batch(codes_np, rng, npairs, tag, window=100, subset=16):
    """Phase 5, the batched aligners over the standalone fill (K1):
    nw_fast_batch, nw_endpos_batch and sw_fast_batch, one fill launch
    each."""
    import numpy as np
    import torch

    from bwt_tpu_torch.ops import align, dp_wavefront
    from bwt_tpu_torch.utils.cigar import Cigar

    L1, L2 = NW_SHAPE
    starts, cut = mutated_reads(rng, codes_np, npairs)
    reads = np.zeros((npairs, L1), np.int32)
    reads[:, :READ_LEN] = cut
    reads[::5, 40:READ_LEN - 2] = reads[::5, 42:READ_LEN]  # a 2-base deletion
    rl = np.full(npairs, READ_LEN, np.int32)
    rl[::5] -= 2
    reads[np.arange(L1)[None, :] >= rl[:, None]] = 0
    genomes = np.zeros((npairs, L2), np.int32)
    gs = np.minimum(starts, len(codes_np) - window)
    genomes[:, :window] = codes_np[np.add.outer(gs, np.arange(window))]
    gl = np.full(npairs, window, np.int32)
    dp_wavefront.nw_fast_batch(reads[:64], rl[:64], genomes[:64], gl[:64])
    dp_wavefront.LAUNCHES = dp_wavefront.STITCH_LAUNCHES = 0
    t0 = time.perf_counter()
    pos, cigars = dp_wavefront.nw_fast_batch(reads, rl, genomes, gl)
    dt = time.perf_counter() - t0
    fills, stitches = dp_wavefront.LAUNCHES, dp_wavefront.STITCH_LAUNCHES
    require((fills, stitches) == (1, 0),
            f"nw_fast_batch is not one launch of the fill kernel: fill, "
            f"stitch launches {(fills, stitches)}")
    for k, c in enumerate(cigars):
        require(_cigar_read_len(c) == rl[k],
                f"pair {k}: CIGAR {c.render()} does not consume {rl[k]} "
                f"read bases")
    # a read cut where its window starts ends READ_LEN columns in, with
    # or without the two bases deleted from it
    at_end = int((pos == READ_LEN - 1).sum())
    require(at_end >= npairs // 2,
            f"only {at_end} of {npairs} reads end where they were cut")
    cpu_pos, cpu_cigars = dp_wavefront.nw_fast_batch(reads, rl, genomes, gl,
                                                     device="cpu")
    require(np.array_equal(pos, cpu_pos)
            and [c.render() for c in cigars]
            == [c.render() for c in cpu_cigars],
            "nw_fast_batch differs between the fill kernel and the plain "
            "fill on the CPU")
    for k in range(subset):
        c = Cigar()
        want = align.nw_fast(reads[k, :rl[k]], genomes[k, :gl[k]], c)
        require(pos[k] == want and cigars[k].render() == c.render(),
                f"pair {k}: nw_fast_batch gives {pos[k]} {cigars[k].render()},"
                f" nw_fast {want} {c.render()}")
    print(f"phase 5 nw_fast_batch {npairs} pairs of {READ_LEN} bp against "
          f"{window} bp, padded to {L1} x {L2}: every CIGAR consumes its "
          f"read, {at_end} end where they were cut, all equal to the plain "
          f"fill on the CPU and {subset} to the host's nw_fast, "
          f"{npairs / dt:.1f} pairs/s ({dt:.3f} s, the host's backtrack "
          f"included), dp_wavefront (fill) launches {fills}, dp_stitch "
          f"launches {stitches} {tag}", flush=True)
    out = dict(n=npairs, s=dt, per_s=npairs / dt, fill_launches=fills,
               at_end=at_end, path_launches={"nw_fast_batch": fills})

    # the other two batched aligners on the same pairs, one fill each
    for name in ("nw_endpos_batch", "sw_fast_batch"):
        fn = getattr(align, name)  # importable from ops.align, as in bwt_tpu
        dp_wavefront.LAUNCHES = dp_wavefront.STITCH_LAUNCHES = 0
        t0 = time.perf_counter()
        got = fn(reads, rl, genomes, gl)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = (dp_wavefront.LAUNCHES, dp_wavefront.STITCH_LAUNCHES)
        require(launches == (1, 0), f"{name} is not one launch of the fill "
                                    f"kernel: fill, stitch {launches}")
        want = fn(reads, rl, genomes, gl, device="cpu")
        if name == "sw_fast_batch":
            same = [c.render() for c in got] == [c.render() for c in want]
            for k, c in enumerate(got):
                require(_cigar_read_len(c) == rl[k],
                        f"pair {k}: sw CIGAR {c.render()} does not consume "
                        f"{rl[k]} read bases")
        else:
            require(got[2].shape == (npairs, L1 + 1, L2 + 1),
                    f"nw_endpos_batch values of shape {tuple(got[2].shape)}")
            same = all(a.device.type == "cuda" and torch.equal(a.cpu(), b)
                       for a, b in zip(got, want))
            require(np.array_equal(got[0].cpu().numpy()[rl > 0],
                                   pos[rl > 0]),
                    "nw_endpos_batch's endpoints are not nw_fast_batch's")
        require(same, f"{name} differs between the fill kernel and the "
                      f"plain fill on the CPU")
        print(f"phase 5 {name} on the same {npairs} pairs: one fill launch "
              f"(dp_wavefront launches {launches[0]}), equal to the same "
              f"call on the CPU, {npairs / dt:.1f} pairs/s ({dt:.3f} s"
              f"{', the host backtrack included' if name[0] == 's' else ''})"
              f" {tag}", flush=True)
        out[name] = dict(s=dt, per_s=npairs / dt, fill_launches=launches[0])
        out["path_launches"][name] = launches[0]
        out["fill_launches"] += launches[0]
    return out


def cli_children(cmds: dict, workdir: Path) -> dict:
    """Start a CLI child (:func:`cli_command`) for every entry of ``cmds``
    at once, their outputs to files, and wait for all: name -> (exit code,
    stdout, stderr).  A child still running when this returns (it raised)
    is killed."""
    procs = {}
    try:
        for name, args in cmds.items():
            with open(workdir / f"{name}.out", "w") as out, \
                    open(workdir / f"{name}.err", "w") as err:
                procs[name] = subprocess.Popen(cli_command(*args), cwd=ROOT,
                                               stdout=out, stderr=err)
        for p in procs.values():
            p.wait(timeout=600)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return {name: (p.returncode, (workdir / f"{name}.out").read_text(),
                   (workdir / f"{name}.err").read_text())
            for name, p in procs.items()}


def cli_in_process(*args):
    """``bwt_tpu_torch.cli.main(["--platform", "cuda", *args])`` in this
    process: (exit code, stdout, stderr, the kernels' launches)."""
    import io

    from bwt_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    _align_counts(zero=True)
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["--platform", "cuda", *(str(a) for a in args)])
    return rc, out.getvalue(), err.getvalue(), _align_counts()


# phase 6's self-checks and the kernels each must launch in process
CLI_CHECKS = {"index_test": ("locate",), "filetest": ("locate",),
              "gaptest": ("K3", "K4"), "fmitest": ("K3",), "satest": (),
              "index_info": ()}


def phase_cli(rng, workdir: Path, tag, glen=1_000_000, nreads=512,
              big=1 << 25):
    """Phase 6: the CLI as subprocesses on the card, against the same runs
    in process: build_index in both formats, then all the others started
    together: the drivers on the 1 Mb genome (single_align on the
    reference-format index, which has no inverse samples, so through the
    host engine; with --sam and from FastQ on the npz index, through the
    device engine), the index and the self-checks; satest and fmitest at
    ``big`` bases, their rates from the runs in process, which run
    alone."""
    import numpy as np

    import bwt_tpu_torch
    from bwt_tpu_torch import codec, io as bio
    from bwt_tpu_torch.models import aligner, exact, rnaseq
    from bwt_tpu_torch.ops import search

    workdir.mkdir(parents=True, exist_ok=True)
    codes = rng.integers(0, 4, size=glen).astype(np.uint8)
    gtext = codec.decode(codes)
    _, reads = mutated_reads(rng, codes, nreads)
    texts = [codec.decode(r) for r in reads]
    gfile, ifile, nfile, rfile, qfile = (
        workdir / "genome.txt", workdir / "genome.idx",
        workdir / "genome.npz", workdir / "reads.txt", workdir / "reads.fq")
    gfile.write_text(gtext)
    rfile.write_text("\n".join(texts) + "\n")
    write_fastq(qfile, reads)
    t0 = time.perf_counter()
    built = cli_children({"ref": ("build_index", gfile, ifile),
                          "npz": ("build_index", "--format", "npz", gfile,
                                  nfile)}, workdir)
    build_s = time.perf_counter() - t0
    for name, (rc, _, err) in built.items():
        require(rc == 0, f"CLI build_index ({name}) exited {rc}: "
                         f"{err[-2000:]}")
    runs = {
        "single_align": ("single_align", gfile, ifile, rfile),
        "locate": ("locate", gfile, ifile, rfile),
        "search_reads": ("search_reads", gfile, ifile, rfile),
        # rnaseq takes no index file: it builds its own from the genome
        "rnaseq": ("rnaseq", gfile, rfile),
        "sam": ("single_align", "--sam", gfile, nfile, rfile),
        "fastq": ("single_align", gfile, nfile, qfile),
        "index_info": ("index_info", ifile),
        "index_test": ("index_test", gfile, ifile),
        "filetest": ("filetest", gfile),
        "gaptest": ("gaptest", "--length", glen),
        "satest": ("satest", "--length", big),
        "fmitest": ("fmitest", "--length", big),
    }
    t0 = time.perf_counter()
    child = cli_children(runs, workdir)
    children_s = time.perf_counter() - t0
    for name, (rc, _, err) in child.items():
        require(rc == 0, f"CLI {name} exited {rc}: {err[-2000:]}")

    t0 = time.perf_counter()
    fmi = bio.read_ref_index(ifile)
    require(fmi.device.type == "cuda" and fmi.isa_samples is None
            and bio.read_npz_index(nfile).isa_samples is not None,
            "the in-process index is not on the card, or the files do not "
            "hold what the engines need")
    pat, lens = exact._encode_batch(texts)
    want = {
        "single_align": aligner.format_ref_output(
            aligner.align_reads(fmi, gtext, texts)),
        "locate": "".join(f"{p}\n" for p in
                          search.locate(fmi, pat, lens).tolist()),
        "search_reads": exact.format_ref_output(
            texts, exact.search_reads(fmi, texts)),
        "rnaseq": "".join(f"{p}\n" for p in rnaseq.rna_seq(
            bwt_tpu_torch.build_index(gtext), texts).tolist()),
    }
    inproc = {}
    for name in ("sam", "fastq", *CLI_CHECKS):
        rc, out, err, counts = cli_in_process(*runs[name])
        require(rc == 0, f"CLI {name} in process exited {rc}: {err[-2000:]}")
        for k in CLI_CHECKS.get(name, ("K10", "K11a", "K11b")):
            require(counts[k] > 0, f"CLI {name} in process launched no {k}")
        want[name] = out
        inproc[name] = dict(err=err, counts=counts)
    inproc_s = time.perf_counter() - t0
    for cmd in want:
        require(child[cmd][1] == want[cmd],
                f"CLI {cmd} stdout differs from the in-process run")
    require(want["fastq"] == want["single_align"],
            "single_align from FastQ on the npz index (the device engine) "
            "differs from the same reads as text on the reference-format "
            "index (the host engine)")
    require(want["sam"].startswith("@HD") and want["sam"].count("\n")
            == nreads + 3, "single_align --sam: not a header and a record "
                           "a read")
    for name, pattern in (("index_test", " 0 mismatches"),
                          ("filetest", " 0 mismatches"),
                          ("satest", "exact check: ok")):
        require(pattern in inproc[name]["err"], f"CLI {name}: "
                f"{inproc[name]['err'].strip()}")
    sa = re.search(r"in ([\d.]+)s \(([\d.]+) Mb/s\)", inproc["satest"]["err"])
    fm = re.search(r"Built index on \d+ bp in ([\d.]+)s.*Searched (\d+) 12bp "
                   r"sequences in ([\d.]+)s \((\d+)/s\)",
                   inproc["fmitest"]["err"], re.S)
    require(sa is not None and fm is not None,
            "satest or fmitest printed no rate")
    naligned = want["single_align"].count("\n ")
    located = sum(1 for ln in want["locate"].split() if int(ln) >= 0)
    paired = want["search_reads"].count("\nRead ")
    anchored = sum(1 for ln in want["rnaseq"].split() if int(ln) >= 0)
    recovered = inproc["gaptest"]["err"].strip()
    launches = {name: {k: v for k, v in r["counts"].items() if v}
                for name, r in inproc.items()}
    print(f"phase 6 CLI --platform cuda: build_index, ref and npz "
          f"({build_s:.3f} s), then "
          f"{len(runs)} subprocesses started together ({children_s:.3f} s): "
          f"single_align (text on the ref index; --sam and FastQ on the npz "
          f"index), locate, search_reads, rnaseq, "
          f"index_info, index_test, filetest, gaptest on {glen} bases and "
          f"{nreads} reads, satest and fmitest at {big} bases; every stdout "
          f"equal to the same run in process ({inproc_s:.3f} s; "
          f"{naligned} aligned, {located} located, {paired} paired, "
          f"{anchored} rnaseq positions >= 0, gaptest: {recovered}), every "
          f"self-check exit 0; in process satest {sa.group(2)} Mb/s "
          f"({sa.group(1)} s), fmitest build {fm.group(1)} s and "
          f"{fm.group(4)} 12-mers/s ({fm.group(2)} in {fm.group(3)} s); "
          f"launches in process {launches} {tag}", flush=True)
    return dict(s=build_s + children_s, build_s=build_s,
                children_s=children_s, inproc_s=inproc_s, aligned=naligned,
                located=located, paired=paired, anchored=anchored,
                satest_mbps=float(sa.group(2)), satest_s=float(sa.group(1)),
                fmitest_build_s=float(fm.group(1)),
                fmitest_per_s=int(fm.group(4)), launches=launches)


def _max_abs_diff(got, want) -> int:
    """Largest absolute difference over paired int tensors."""
    import torch

    err = 0
    for a, b in zip(got, want):
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def _event_ms(fn):
    """``fn()`` once between CUDA events: its result and its time in ms."""
    import torch

    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def _search_steps(r, n0, started):
    """Per lane, the LF steps a backward search took, from its record: the
    matches made after the initial state's ``n0``, plus the step that
    emptied the interval of a lane that ``started`` alive."""
    import torch

    made = (r["nmatched"].to(torch.int64) - n0).clamp(min=0)
    return made + (started & ~r["alive"])


def _walk_steps(fmi, idx) -> int:
    """LF steps of the SA walks from rows ``idx``, counted with the plain
    LF on the card."""
    import torch

    from bwt_tpu_torch.ops import rank as rank_ops

    i, total, mask = idx, 0, fmi.sa_rate - 1
    for _ in range(1 << 12):
        live = (i & mask) != 0
        n = int(live.sum())
        if not n:
            return total
        total += n
        i = torch.where(live, rank_ops.lf(fmi.buckets, fmi.C, fmi.endloc, i),
                        i)
    raise SmokeFailure("a walk took more than 4,096 steps")


def _index_bytes(fmi, search_steps: int, walk_steps: int, walks: int,
                 row_bytes: int = 32) -> int:
    """Bytes of the index a kernel's steps need: a 32-byte row fetched (two
    a search step, one a walk step; the wide index's rows32 beside a bases
    entry, 8 bytes a search fetch's one count and 32 a walk step's four)
    and a 32-byte sector a sample read, each table counted at most once
    whole.  ``row_bytes=48`` counts the 12-int rows that the wide kernels
    read before they read their device layout."""
    from bwt_tpu_torch.ops import rank as rank_ops

    fetches = 2 * search_steps + walk_steps
    rows = fmi.buckets.shape[0]
    total = (min(row_bytes * rows, row_bytes * fetches)
             + min(fmi.sa_samples.numel() * fmi.sa_samples.element_size(),
                   32 * walks))
    if fmi.wide and row_bytes == 32:
        nsb = rank_ops.superblocks(fmi.bucket_rows)
        total += min(32 * (nsb + 1), 16 * search_steps + 32 * walk_steps)
    return total


def _anchor_scan_unfused(fmi, pats, lens, min_anchor):
    """The loop that the fused anchor scan replaces: one K3 launch and a
    host sync a trip, then one K4 launch.  Returns (counts, positions),
    the search and walk steps taken, the walks, the trips, and the loop's
    wall time in ms (with one more sync a trip, for the step count)."""
    import torch

    from bwt_tpu_torch.ops import search

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    len_b = lens.clone()
    nmatch = torch.zeros_like(lens)
    anchor_sp = torch.zeros_like(lens)
    steps = trips = 0
    while True:
        active = len_b > min_anchor
        if not bool(active.any()):
            break
        r = search.search_lanes(fmi, pats, torch.where(active, len_b, 1),
                                resolve_n=True)
        steps += int(_search_steps(r, 1, r["nmatched"] >= 1)[active].sum())
        m = r["nmatched"] + r["skips"]
        got = active & (m >= min_anchor)
        anchor_sp = torch.where(got, r["sp"], anchor_sp)
        nmatch = nmatch + got.to(torch.int32)
        len_b = torch.where(active, torch.where(got, len_b - m, len_b - 1),
                            len_b)
        trips += 1
    pos = torch.where(nmatch > 0, search.unc_sa(fmi, anchor_sp), -1)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    walked = anchor_sp[nmatch > 0]
    return ((nmatch, pos), steps, _walk_steps(fmi, walked),
            int(walked.numel()), trips, wall_ms)


def phase_search_kernels(fmi, codes_np, rng, table, tag, latency_us,
                         anchor_forms, nmixed=1 << 16, nlocate=1 << 20,
                         nrows=1 << 20, chunk=1 << 15):
    """Phase 7: every search kernel against its plain version, bit-equal,
    each timed beside its bound; the anchor hunt also at each of
    ``anchor_forms`` (:func:`finish_tile_builds`), with its chains at
    every tile width beside the load latency ``latency_us``."""
    import numpy as np
    import torch

    import bwt_tpu_torch
    from bwt_tpu_torch.models import exact
    from bwt_tpu_torch.ops import search

    dev = fmi.device
    n = fmi.length
    pats_np, lens_np = mixed_reads(rng, codes_np, nmixed)
    pats = torch.from_numpy(pats_np).to(dev)
    lens = torch.from_numpy(lens_np).to(dev)
    sp = torch.from_numpy(rng.integers(0, n + 1, size=nmixed).astype(
        np.int32)).to(dev)
    ep = (sp + torch.from_numpy(rng.integers(-1, 5, size=nmixed).astype(
        np.int32)).to(dev)).clamp(0, n + 1)
    starts = rng.integers(0, len(codes_np) - 30, size=nlocate)
    kmers = torch.from_numpy(codes_np[np.add.outer(starts, np.arange(30))]
                             .astype(np.int32)).to(dev)
    klens = torch.full((nlocate,), 30, dtype=torch.int32, device=dev)
    rows = []

    def report(kernel, case, shape, err, ms, plain_ms, bound, extra=""):
        rows.append(dict(kernel=kernel, case=case, shape=shape,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound))
        print(f"phase 7 {kernel} {case} {shape}: bit-equal (tolerance 0, "
              f"max |d| {err}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound['bound_ms']:.4f} ms by {bound['bound_by']} "
              f"({bound['bytes']} bytes, {bound['ops']} operations)"
              f"{extra} {tag}", flush=True)

    # K3: (name, patterns, lengths, keywords, n0, bytes of the initial state)
    cases = [
        ("C[c0]", pats, lens, {}, 1, 0),
        ("C[c0] resolve_n", pats, lens, dict(resolve_n=True), 1, 0),
        (f"seed table k={SEED_K}", pats, lens, dict(seed_table=table),
         SEED_K, 32),
        ("given interval (mms_continue)", pats, lens,
         dict(resolve_n=True, start=sp, end=ep), 0, 8),
        ("C[c0], 30-mers", kmers, klens, {}, 1, 0),
    ]
    records = {}
    for name, p, ln, kw, n0, init_bytes in cases:
        got = search.search_lanes(fmi, p, ln, **kw)
        want, plain_ms = _event_ms(
            lambda: search.backward_search_plain(fmi, p, ln, **kw))
        err = _max_abs_diff(got.values(), want.values())
        require(all(torch.equal(got[k], want[k]) for k in want),
                f"K3 differs from its plain version ({name}): max |d| {err}")
        records[name] = got
        started = ep > sp if "start" in kw else got["nmatched"] >= n0
        steps = int(_search_steps(got, n0, started).sum())
        B = p.shape[0]
        bound = bound_of(4 * p.numel() + (4 + init_bytes + 32) * B
                         + _index_bytes(fmi, steps, 0, 0),
                         SEARCH_STEP_OPS * steps)
        ms = cuda_ms(lambda: search.search_lanes(fmi, p, ln, **kw), 20)
        report("backward_search", name, f"B={B} L={p.shape[1]}", err, ms,
               plain_ms, bound, f", {steps} steps")

    idx = torch.from_numpy(np.concatenate([
        np.array([0, int(fmi.endloc), n]),
        rng.integers(0, n + 1, size=nrows)]).astype(np.int32)).to(dev)
    got = search.unc_sa(fmi, idx)
    want, plain_ms = _event_ms(lambda: search.unc_sa_plain(fmi, idx))
    err = _max_abs_diff([got], [want])
    require(torch.equal(got, want),
            f"K4 differs from its plain version: max |d| {err}")
    require(int(got[1]) == 0, "unc_sa(endloc) is not 0")
    steps = _walk_steps(fmi, idx)
    B = idx.shape[0]
    bound = bound_of(8 * B + _index_bytes(fmi, 0, steps, B),
                     WALK_STEP_OPS * steps)
    ms = cuda_ms(lambda: search.unc_sa(fmi, idx), 20)
    report("unc_sa", "rows in [0, n] with 0, endloc, n (a wrapper call, "
           "flag read-back included)", f"B={B}", err, ms, plain_ms, bound,
           f", {steps} steps")

    # the fused anchor scan: mixed reads, and one chunk of search_reads;
    # the chains of the plain version's rounds at every tile width, and
    # the kernel built apart at each tile
    cstarts = rng.integers(0, len(codes_np) - 50, size=chunk)
    creads = torch.from_numpy(
        codes_np[np.add.outer(cstarts, np.arange(50))]).to(dev)
    clens = torch.full((chunk,), 50, dtype=torch.int32, device=dev)
    hunts = {"mixed reads": (pats, lens),
             "a search_reads chunk, uint8": (creads, clens)}
    for name, min_anchor in HUNT_CASES:
        p, ln = hunts[name]
        wide = p.to(torch.int32)
        for reverse in (False, True):
            got = exact.anchor_scan(fmi, p, ln, min_anchor=min_anchor,
                                    reverse=reverse)
            flipped = exact._plain_reverse(wide, ln) if reverse else wide
            want, plain_ms = _event_ms(lambda: exact.anchor_scan_plain(
                fmi, flipped, ln, min_anchor=min_anchor))
            chains, by_width = hunt_chains(fmi, flipped, ln, min_anchor)
            unf, steps, wsteps, walks, trips, unf_ms = _anchor_scan_unfused(
                fmi, flipped, ln, min_anchor)
            err = max(_max_abs_diff(got, want), _max_abs_diff(got, unf),
                      _max_abs_diff(got, by_width))
            case = (f"{name}, {'reversed' if reverse else 'forward'}, "
                    f"min_anchor={min_anchor}")
            require(all(torch.equal(a, b) and torch.equal(a, c)
                        and torch.equal(a, d)
                        for a, b, c, d in zip(got, want, unf, by_width)),
                    f"anchor_scan differs from its plain version or from "
                    f"the unfused loop ({case}): max |d| {err}")
            B = p.shape[0]
            bound = bound_of(p.numel() * p.element_size() + (4 + 8) * B
                             + _index_bytes(fmi, steps, wsteps, walks),
                             SEARCH_STEP_OPS * steps + WALK_STEP_OPS * wsteps)

            def run():
                return search.anchor_scan_kernel(
                    fmi, p, ln, min_anchor=min_anchor, reverse=reverse)

            # the wrapper's host time is near the kernel's: time it with
            # the host ahead, and as earlier PRs did, at the host's pace
            ms = cuda_ms(run, 20, ahead=True)
            paced = cuda_ms(run, 20)
            forms = {}
            for form, (lib, _) in anchor_forms.items():
                with automaton_tile(lib, ANCHOR_LAUNCHERS):
                    alt = exact.anchor_scan(fmi, p, ln, min_anchor=min_anchor,
                                            reverse=reverse)
                    err_f = _max_abs_diff(alt, want)
                    require(all(torch.equal(a, b) for a, b in zip(alt, want)),
                            f"anchor_scan built at {form} differs from its "
                            f"plain version ({case}): max |d| {err_f}")
                    forms[form] = cuda_ms(run, 20, ahead=True)
                err = max(err, err_f)
            report("anchor_scan", case, f"B={B} L={p.shape[1]}", err, ms,
                   plain_ms, bound,
                   f", {steps} search and {wsteps} walk steps; the unfused "
                   f"loop of {trips} K3 launches and a K4 launch, its step "
                   f"count included: {unf_ms:.4f} ms of wall; at the "
                   f"host's pace {paced:.4f} ms; built apart (the host "
                   f"ahead): " + ", ".join(
                       f"{k} {v:.4f}" for k, v in forms.items())
                   + " ms; chains (read mean / longest, warp mean / "
                   "longest, steps issued; with the quit) " + "; ".join(
                       f"T = {T}: {c['read'][0]:.1f} / {c['read'][1]}, "
                       f"{c['warp'][0]:.1f} / {c['warp'][1]} "
                       f"({c['warp'][1] * latency_us / 1e3:.4f} ms at the "
                       f"load latency), {c['issued']}; {c['read_quit'][1]}, "
                       f"{c['issued_quit']}" for T, c in chains.items()))
            rows[-1].update(unfused_wall_ms=unf_ms, trips=trips,
                            reverse=reverse, paced_ms=paced, forms=forms,
                            chains=chains)

    # the fused locate: the 30-mers, and the mixed reads whose walk starts
    # on a real row (the others raise, in both versions)
    for name, p, ln, rec, n0 in (
            ("30-mers", kmers, klens, "C[c0], 30-mers", 1),
            ("mixed reads", pats, lens, "C[c0]", 1),
            ("mixed reads", pats, lens, f"seed table k={SEED_K}", SEED_K),
            ("30-mers", kmers, klens, None, SEED_K)):
        seeded = n0 == SEED_K
        st = table if seeded else None
        r = records[rec] if rec else search.search_lanes(fmi, p, ln,
                                                         seed_table=st)
        real = (((r["start"] >= 0) & (r["start"] <= n))
                | (r["start"] == -2 ** 31))
        p, ln = p[real].contiguous(), ln[real].contiguous()
        got = search.locate(fmi, p, ln, seed_table=st)
        want, plain_ms = _event_ms(
            lambda: search.locate_plain(fmi, p, ln, seed_table=st))
        err = _max_abs_diff([got], [want])
        case = f"{name}, {'seeded k=%d' % SEED_K if seeded else 'plain'}"
        require(got.shape == want.shape and torch.equal(got, want),
                f"locate differs from its plain version ({case}): max |d| "
                f"{err}")
        steps = int(_search_steps(r, n0, r["nmatched"] >= n0)[real].sum())
        wsteps = _walk_steps(fmi, r["start"][real])
        B = p.shape[0]
        bound = bound_of(4 * p.numel() + (4 + 4 + 32 * seeded) * B
                         + _index_bytes(fmi, steps, wsteps, B),
                         SEARCH_STEP_OPS * steps + WALK_STEP_OPS * wsteps)
        ms = cuda_ms(lambda: search.locate_kernel(fmi, p, ln, seed_table=st),
                     20)
        report("locate", case, f"B={B} L={p.shape[1]}", err, ms, plain_ms,
               bound, f", {steps} search and {wsteps} walk steps")

    zeros = bwt_tpu_torch.build_index(np.zeros(64, np.uint8), device=dev)
    for what, match, fn in (
            ("walk bound: locate('C')", "row 65", lambda: search.locate(
                zeros, np.array([[1]], np.int32), np.array([1], np.int32))),
            ("walk bound: anchor_scan('CNNN', min_anchor=3)", "row 65",
             lambda: exact.anchor_scan(zeros, np.array([[1, 5, 5, 5]],
                                                       np.int32), [4],
                                       min_anchor=3)),
            ("no-progress bound: anchor_scan('AC', min_anchor=0)",
             "never end", lambda: exact.anchor_scan(
                 zeros, np.array([[0, 1]], np.int32), [2], min_anchor=0))):
        before = search.LOCATE_LAUNCHES + search.ANCHOR_LAUNCHES
        try:
            fn()
        except RuntimeError as e:
            require(match in str(e), f"{what} raised something else: {e}")
            require(search.LOCATE_LAUNCHES + search.ANCHOR_LAUNCHES
                    == before + 1, f"{what} was not raised by the kernel")
            print(f"phase 7 {what} on a 64-base all-A genome raised on the "
                  f"card: {e} {tag}", flush=True)
        else:
            raise SmokeFailure(f"{what} did not raise")
    return rows


def _window_steps(fmi, plo, width, W=32) -> int:
    """LF steps of the inverse-SA chains of windows [plo, plo + width): one
    a position from the anchor above the window's top down to its floor,
    less the anchor itself (search.isa_window_plain)."""
    import torch

    n, r = fmi.length, fmi.sa_rate
    shift = r.bit_length() - 1
    p_hi = torch.clamp(plo + width - 1, max=n)
    anchor = torch.clamp(((p_hi + r - 1) >> shift) << shift, 0, n)
    span = torch.where(width > 0, anchor - plo.clamp(min=0) + 1, 0)
    return int((span.clamp(max=r - 1 + W) - 1).clamp(min=0).sum())


# the window sets K6 is held on (isa_windows)
ISA_KINDS = ("random", "past-W", "int32-edges", "W8", "W30", "W64")
I32_MAX, I32_MIN = (1 << 31) - 1, -(1 << 31)


def isa_windows(kind: str, n: int, rng, B: int = 96):
    """(plo, width, W) numpy int32 windows of one of ISA_KINDS on a genome
    of length n: random windows (widths -2..32, the tail, plo < 0; W 32);
    widths past W (33..40: bwt_tpu's cap); plo and width at the int32
    edges, every pair; and W = 8, 30 (not a multiple of four) and 64."""
    import numpy as np

    plo = rng.integers(-40, n + 40, size=B).astype(np.int32)
    if kind == "random":
        wid = rng.integers(-2, 33, size=B).astype(np.int32)
        plo[:6] = [0, n - 5, n, -3, n - 31, -31]
        wid[:6] = [32, 32, 1, 10, 32, 32]
        return plo, wid, 32
    if kind == "past-W":
        wid = rng.integers(33, 41, size=B).astype(np.int32)
        plo[:5] = [0, 1, -3, n - 39, n - 35]
        wid[:5] = [40, 40, 40, 40, 33]
        return plo, wid, 32
    if kind == "int32-edges":
        edge_p = [I32_MAX, I32_MAX - 4, I32_MIN, I32_MIN + 3, 0, n, -1, 5]
        edge_w = [I32_MAX, I32_MIN, 1, 32, I32_MAX - 1, I32_MIN + 1, 0, -1]
        plo = np.array([p for p in edge_p for _ in edge_w], np.int32)
        wid = np.array([w for _ in edge_p for w in edge_w], np.int32)
        return plo, wid, 32
    W = {"W8": 8, "W30": 30, "W64": 64}[kind]
    wid = rng.integers(-1, W + 3, size=B).astype(np.int32)
    plo[:4] = [0, n - W + 1, -W + 2, n]
    wid[:4] = [W, W, W, W]
    return plo, wid, W


def isa_plan(n: int, rate: int, plo, width, W: int = 32, tile: int = 1,
             chunk: int | None = None) -> dict:
    """K6's schedule for windows [plo, plo + width) (numpy arrays) of an
    index of ``length`` n at sample rate ``rate``, in both forms, counted on
    the host with the kernels' int32 wraps:

      old_loads  per window, the loads of its one chain in the first form
                 (fm::isa_chain, a thread a window): the sample at or above
                 the window's top and an LF step a position down to its
                 floor or bwt_tpu's cap of rate - 1 + W (its span; the LF
                 steps are :func:`_window_steps`'s);
      jlo, jhi   per window, the columns that get a row (none: jlo > jhi);
      segs       csrc/isa_window.cu's segments, a dict of (B,) arrays for
                 each chunk of ``chunk`` columns (the row when None) and
                 each segment from the top: its number m (the positions p
                 with ceil(p / rate) = m), anchor min(m rate, n), floor and
                 top (the rows it emits), and ``live``;
      new_loads  per window, its longest thread's loads in the tile form,
                 thread q taking segments q, q + ``tile``, ...: a sample
                 and an LF step a position a segment."""
    import numpy as np

    shift = rate.bit_length() - 1
    plo = np.asarray(plo, np.int64)
    width = np.asarray(width, np.int64)

    def wrap(x):
        return (x + (1 << 31)) % (1 << 32) - (1 << 31)

    def segment_of(p):
        return (p >> shift) + ((p & (rate - 1)) != 0)

    p_hi = np.minimum(wrap(plo + width - 1), n)
    anchor = np.clip((wrap(p_hi + rate - 1) >> shift) << shift, 0, n)
    span = np.where(width > 0, np.minimum(anchor - np.maximum(plo, 0) + 1,
                                          rate - 1 + W), 0)
    lo = anchor - span + 1
    live = (span > 0) & (p_hi >= lo)
    jlo = np.where(live, lo - plo, 1)
    jhi = np.where(live, np.minimum(p_hi - plo, W - 1), 0)
    chunk = W if chunk is None else chunk
    segs = []
    threads = np.zeros((len(plo), tile), np.int64)
    for c0 in range(0, W, chunk):
        ja = np.maximum(jlo, c0)
        jb = np.minimum(jhi, c0 + min(chunk, W - c0) - 1)
        on = ja <= jb
        pb, pt = np.where(on, plo + ja, 0), np.where(on, plo + jb, 0)
        top_m, bot_m = segment_of(pt), segment_of(pb)
        nseg = np.where(on, top_m - bot_m + 1, 0)
        for i in range(int(nseg.max(initial=0))):
            ok = i < nseg
            m = np.where(ok, top_m - i, 0)
            a = np.where(m > (n >> shift), n, m << shift)
            bot = np.where(ok, np.maximum(pb, (m - 1) * rate + 1), 0)
            threads[:, i % tile] += np.where(ok, a - bot + 1, 0)
            segs.append(dict(m=m, anchor=a, bot=bot, top=np.minimum(pt, a),
                             live=ok))
    return dict(old_loads=np.maximum(span, 0), jlo=jlo, jhi=jhi, segs=segs,
                new_loads=threads.max(axis=1, initial=0))


def isa_counts(plan: dict) -> dict:
    """The totals of an :func:`isa_plan`: the windows that emit a row, the
    segments (their most in one window), and each form's LF steps, loads
    (LF steps and samples) and longest chain in loads."""
    import numpy as np

    old = plan["old_loads"]
    nseg = sum(s["live"].astype(np.int64) for s in plan["segs"])
    new_steps = sum(int(np.where(s["live"], s["anchor"] - s["bot"], 0).sum())
                    for s in plan["segs"])
    return dict(
        windows=int((plan["jlo"] <= plan["jhi"]).sum()),
        segments=int(np.sum(nseg)), max_segments=int(np.max(nseg, initial=0)),
        old=dict(steps=int(np.maximum(old - 1, 0).sum()),
                 loads=int(old.sum()), longest=int(old.max(initial=0))),
        new=dict(steps=new_steps, loads=new_steps + int(np.sum(nseg)),
                 longest=int(plan["new_loads"].max(initial=0))))


# K6's case in phase 7 and --isa-times; its tiles timed beside the package's
ISA_CASE = "widths 0..32 across the genome, its tail and plo < 0"
ISA_TILES = (1, 2, 4, 8, 16, 32)


def isa_phase_windows(rng, n: int, B: int, dev):
    """Phase 7's K6 windows: ``B`` tops across a genome of length n, its
    tail and plo < 0, widths 0..32; (plo, width) int32 on ``dev``."""
    import numpy as np
    import torch

    plo = torch.from_numpy(rng.integers(-40, n + 40, size=B).astype(
        np.int32)).to(dev)
    wid = torch.from_numpy(rng.integers(0, 33, size=B).astype(
        np.int32)).to(dev)
    plo[:4] = torch.tensor([0, n - 5, n, -3], dtype=torch.int32)
    wid[:4] = torch.tensor([32, 32, 1, 10], dtype=torch.int32)
    return plo, wid


def isa_case(fmi, plo, wid, reps: int = 20, tiles=ISA_TILES) -> dict:
    """K6 on the windows (plo, wid) of ``fmi`` on the card against its plain
    version, bit-equal (tolerance 0), the mean of ``reps`` launches with
    the host ahead beside its bound (its bytes the windows, the rows and a
    sector a window's sample, and the index sectors the first form's LF
    steps touch; its operations a walk step each), with the schedule's
    counts in both forms (:func:`isa_counts`) and, where the package's K6
    takes a tile (``search.isa_tile``), its time at each of ``tiles``,
    each bit-equal too.  An older tree's package gives the first two."""
    import torch

    from bwt_tpu_torch.ops import search

    B = plo.shape[0]
    got = search.isa_window(fmi, plo, wid)
    want, plain_ms = _event_ms(lambda: search.isa_window_plain(fmi, plo, wid))
    err = _max_abs_diff([got], [want])
    require(got.shape == want.shape and torch.equal(got, want),
            f"K6 differs from its plain version at sa_rate {fmi.sa_rate}: "
            f"max |d| {err}")
    steps = _window_steps(fmi, plo, wid)
    bound = bound_of(8 * B + 4 * got.numel() + 32 * B
                     + min(4 * fmi.buckets.numel(), 32 * steps),
                     WALK_STEP_OPS * steps)
    ms = cuda_ms(lambda: search.isa_window(fmi, plo, wid), reps, ahead=True)
    has_tile = hasattr(search, "isa_tile")
    tile = search.isa_tile(fmi.sa_rate, 32) if has_tile else 1
    by_tile = {}
    for t in tiles if has_tile else ():
        def run():
            return search._isa_window_kernel(fmi, plo, wid, tile=t)

        require(torch.equal(run(), want),
                f"K6 at a tile of {t} differs from its plain version")
        by_tile[t] = cuda_ms(run, reps, ahead=True)
    counts = isa_counts(isa_plan(fmi.length, fmi.sa_rate, plo.cpu().numpy(),
                                 wid.cpu().numpy(), tile=tile))
    return dict(kernel="isa_window", case=f"{ISA_CASE}, sa_rate "
                f"{fmi.sa_rate}", shape=f"B={B} W=32", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, tile=tile, by_tile=by_tile,
                counts=counts, **bound)


def isa_text(r: dict) -> str:
    """An :func:`isa_case` row as phase 7 prints it."""
    c = r["counts"]
    return (f"isa_window {r['case']} {r['shape']}: bit-equal (tolerance 0, "
            f"max |d| {r['max_abs_err']}), kernel {r['ms']:.4f} ms at a tile "
            f"of {r['tile']}, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({r['bytes']} bytes, "
            f"{r['ops']} operations); {c['windows']} windows with a row, "
            f"{c['segments']} segments (at most {c['max_segments']} a "
            f"window); first form (a thread a window): {c['old']['steps']} "
            f"LF steps, {c['old']['loads']} loads, longest chain "
            f"{c['old']['longest']} loads; tile form: {c['new']['steps']} LF "
            f"steps, {c['new']['loads']} loads, longest chain "
            f"{c['new']['longest']} loads; ms by tile "
            + (", ".join(f"{t}: {ms:.4f}" for t, ms in r["by_tile"].items())
               or "none (one thread a window)"))


def isa_times(bits: int = 25, seed: int = 0, rates=(4, 32),
              nwindows: int = 1 << 16) -> list:
    """``--isa-times``: K6 on phase 7's windows (:func:`isa_phase_windows`)
    of a 2^bits-base genome indexed at each of ``rates``
    (:func:`isa_case`), one JSON line a rate.  Run beside an older tree's
    package to pair the two trees in one call."""
    import numpy as np
    import torch

    import bwt_tpu_torch

    tag = f"[{card_line()}]"
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=1 << bits).astype(np.uint8)
    plo, wid = isa_phase_windows(rng, len(codes), nwindows, "cuda")
    out = []
    for rate in rates:
        fmi = bwt_tpu_torch.build_index(codes, sa_sample_rate=rate,
                                        device="cuda")
        r = isa_case(fmi, plo, wid)
        r.update(bits=bits, card=tag)
        print(f"isa-times {isa_text(r)} {tag}", flush=True)
        print("isa-times " + json.dumps(r), flush=True)
        out.append(r)
        del fmi
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# the fused locate: its rows counted on the host, its kernel timed
# --------------------------------------------------------------------------

def locate_trace(fmi, pats, lens, seed_table=None) -> dict:
    """The rows the fused locate fetches for reads (pats, lens), by the
    plain version's steps on the index's device (the int32 index): for
    each read, the bucket row of its interval's start at each search step
    (``rs``, (B, T), with ``ms`` the steps it takes, a prefix), of its end
    (``re``, with ``me`` the steps whose end lies in another row: the step
    loads two), the rows of its walk (``wr``, ``wm``), its search and walk
    steps, whether the interval emptied early (``emptied``: its output -1,
    no sample read) and whether the walk overran (``over``)."""
    import torch

    from bwt_tpu_torch.ops import rank as rank_ops
    from bwt_tpu_torch.ops import search

    p = search._i32(pats, fmi)
    ln = search._i32(lens, fmi)
    B, L = p.shape
    if seed_table is None:
        eff = ln.clamp(min=1)
        c0 = search._char_at(p, eff - 1)
        start = search.take_c(fmi.C, c0)
        end = search.take_c(fmi.C, c0 + 1)
        alive = end > start
        nm = alive.to(torch.int32)
        t0 = 1
    else:
        eff = ln
        rows = rank_ops.take_fill(seed_table.rows,
                                  search._seed_key(p, ln, seed_table.k))
        start, end = rows[:, 0], rows[:, 1]
        nm, alive = rows[:, 4].to(torch.int32), rows[:, 5] > 0
        t0 = seed_table.k

    def bucket(i):
        return rank_ops._adjust(fmi.endloc, i) >> 6

    rs, re_, ms, me = [], [], [], []
    for t in range(t0, L):
        active = alive & (t <= eff - 1)
        if not bool(active.any()):
            break
        bs, be = bucket(start), bucket(end)
        rs.append(bs)
        re_.append(be)
        ms.append(active)
        me.append(active & (be != bs))
        ns, ne = search._step(fmi, search._char_at(p, eff - 1 - t), start,
                              end)
        ok = ne > ns
        start = torch.where(active, ns, start)
        end = torch.where(active, ne, end)
        nm = nm + (active & ok).to(torch.int32)
        alive = alive & (~active | ok)
    i, wr, wm = start, [], []
    mask = fmi.sa_rate - 1
    for _ in range(fmi.length + 1):
        live = (i & mask) != 0
        if not bool(live.any()):
            break
        wr.append(bucket(i))
        wm.append(live)
        i = torch.where(live, fmi.lf(i), i)

    def stack(xs, like):
        return torch.stack(xs, 1) if xs else like.new_zeros((B, 0))

    out = dict(rs=stack(rs, start), re=stack(re_, start),
               ms=stack(ms, alive), me=stack(me, alive),
               wr=stack(wr, start), wm=stack(wm, alive),
               over=(i & mask) != 0, emptied=~alive & (nm <= ln - 2))
    out["search"] = out["ms"].sum(1)
    out["walk"] = out["wm"].sum(1)
    return out


def locate_order(pats, lens):
    """The reads (numpy (B, L) codes and (B,) lengths) in the order of
    their reversed codes: by the last character first, a read that ends
    before another with the same characters first.  Returns (order,
    inverse): the reads in that order, and the slot each read takes."""
    import numpy as np

    p = np.asarray(pats, np.int64)
    ln = np.asarray(lens, np.int64)
    L = p.shape[1]
    j = ln[:, None] - 1 - np.arange(L)[None, :]
    q = np.where(j >= 0, np.take_along_axis(p, np.clip(j, 0, L - 1), 1),
                 -(1 << 40))
    order = np.lexsort(q.T[::-1])
    inverse = np.empty_like(order)
    inverse[order] = np.arange(len(order))
    return order, inverse


def _distinct(keys, mask, group: int) -> int:
    """The distinct values among the entries of ``mask`` in each group of
    ``group`` consecutive rows of each column of ``keys`` (N, T), summed."""
    import torch

    N, T = keys.shape
    pad = (-N) % group
    if pad:
        keys = torch.cat([keys, keys.new_zeros((pad, T))])
        mask = torch.cat([mask, mask.new_zeros((pad, T))])
    big = torch.iinfo(torch.int64).max
    k = torch.where(mask, keys.to(torch.int64), big)
    k = k.reshape(-1, group, T).sort(dim=1).values
    new = (k[:, 1:] != k[:, :-1]) & (k[:, 1:] != big)
    return int(new.sum() + (k[:, 0] != big).sum())


def locate_counts(tr, order=None) -> dict:
    """What a :func:`locate_trace` ``tr`` costs csrc/locate.cu's schedule
    (a thread a read, warps of 32 reads in lockstep: a warp runs its
    longest search, then its longest walk), the reads in ``order`` (a
    permutation; None: as given): per read its row fetches (search steps,
    those that load two rows, walk steps) and its sample loads; the walks'
    LF steps, the longest, and the mean of a warp's longest; the distinct
    rows (32-byte sectors) and 128-byte lines a warp's round touches and
    its L1 requests (each 16-byte load instruction one request a distinct
    line it touches; a row is two), summed over the warps' rounds; the
    rounds and the share of lane-rounds that step (``utilization``)."""
    import torch

    B = tr["rs"].shape[0]
    dev = tr["rs"].device
    order = (torch.arange(B, device=dev) if order is None
             else torch.as_tensor(order, device=dev).long())
    search, walk = tr["search"].long(), tr["walk"].long()
    out = dict(reads=B, search_steps=int(search.sum()),
               two_row_steps=int(tr["me"].sum()), walk_steps=int(walk.sum()),
               samples=int((~tr["emptied"] & ~tr["over"]).sum()),
               walk_longest=int(walk.max()) if B else 0)
    out["row_fetches"] = (out["search_steps"] + out["two_row_steps"]
                          + out["walk_steps"])
    rs, re_, ms, me, wr, wm = (tr[x][order] for x in
                               ("rs", "re", "ms", "me", "wr", "wm"))
    pad = (-B) % 32

    def longest(x):
        x = torch.cat([x, x.new_zeros(pad)]) if pad else x
        return x.reshape(-1, 32).max(1).values

    s, wk = longest(search[order]), longest(walk[order])
    rows, mask = torch.cat([rs, re_], 1), torch.cat([ms, me], 1)
    rounds = int((s + wk).sum())
    out.update(
        sectors=_distinct(rows, mask, 32) + _distinct(wr, wm, 32),
        lines=_distinct(rows >> 2, mask, 32) + _distinct(wr >> 2, wm, 32),
        requests=2 * (_distinct(rs >> 2, ms, 32) + _distinct(re_ >> 2, me, 32)
                      + _distinct(wr >> 2, wm, 32)),
        rounds=rounds, walk_warp_longest=float(wk.float().mean()),
        utilization=int((search + walk).sum()) / max(1, 32 * rounds))
    return out


def walk_only(fmi, idx):
    """K4 on the rows ``idx``: one launch and no flag read-back, for
    timing beside the fused kernel."""
    import torch

    from bwt_tpu_torch.ops import _kernels, search

    flat = idx.reshape(-1).contiguous()
    out = torch.empty_like(flat)
    flag = torch.zeros(2, dtype=flat.dtype, device=flat.device)
    err = _kernels.library().unc_sa_launch(
        flat.data_ptr(), flat.shape[0], *search._index_args(fmi),
        *search._samples_args(fmi), fmi.length + 1, 1, out.data_ptr(),
        flag.data_ptr(), search._stream(fmi.device))
    require(err == 0, f"unc_sa_launch returned {err}")
    return out


def _frames(report: str) -> list:
    """(stack frame, spill stores) bytes of each kernel in a compiler report."""
    return re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      report)


def locate_case(fmi, pats, lens, st, name, sort=False) -> dict:
    """The fused locate on reads (pats, lens) of ``fmi`` (seed table ``st``
    or None), on the card against its plain version, tolerance 0: the
    package's kernel (the mean of 20 launches, the host ahead) beside
    K3 alone on the same reads and K4 alone on their interval starts, with
    its bound and the counts of :func:`locate_counts`; with ``sort`` also
    the kernel on the reads presorted by their reversed codes (the sort
    outside the timing) and the counts in that order."""
    import torch

    from bwt_tpu_torch.ops import search

    reps = 20
    n = fmi.length
    seeded = st is not None
    n0 = st.k if seeded else 1
    want = search.locate_plain(fmi, pats, lens, seed_table=st)

    def call():
        return search.locate_kernel(fmi, pats, lens, seed_table=st)

    got = call()[:-2]
    require(got.shape == want.shape and torch.equal(got, want),
            f"locate differs from its plain version ({name}): max |d| "
            f"{_max_abs_diff([got], [want])}")
    r = search.search_lanes(fmi, pats, lens, seed_table=st)
    starts = r["start"].contiguous()
    steps = int(_search_steps(r, n0, r["nmatched"] >= n0).sum())
    wsteps = _walk_steps(fmi, starts)
    B = pats.shape[0]
    bound = bound_of(4 * pats.numel() + (4 + 4 + 32 * seeded) * B
                     + _index_bytes(fmi, steps, wsteps, B),
                     SEARCH_STEP_OPS * steps + WALK_STEP_OPS * wsteps)
    row = dict(kernel="locate", case=name, shape=f"B={B} L={pats.shape[1]}",
               max_abs_err=0, n=n, **bound)
    row["ms"] = cuda_ms(call, reps, ahead=True)
    row["k3_ms"] = cuda_ms(
        lambda: search.search_lanes(fmi, pats, lens, seed_table=st), reps,
        ahead=True)
    row["walk_ms"] = cuda_ms(lambda: walk_only(fmi, starts), reps, ahead=True)
    row["search_steps"], row["walk_steps"] = steps, wsteps
    tr = locate_trace(fmi, pats, lens, st)
    row["counts"] = locate_counts(tr)
    if sort:
        order_np, _ = locate_order(pats.cpu().numpy(), lens.cpu().numpy())
        order = torch.from_numpy(order_np).to(pats.device)
        ps, ls = pats[order].contiguous(), lens[order].contiguous()

        def run_sorted():
            return search.locate_kernel(fmi, ps, ls, seed_table=st)

        require(torch.equal(run_sorted()[:-2], want[order]),
                f"locate on the sorted reads differs ({name})")
        row["sorted_ms"] = cuda_ms(run_sorted, reps, ahead=True)
        row["counts_sorted"] = locate_counts(tr, order)
    del tr
    return row


def locate_text(r: dict) -> str:
    """A :func:`locate_case` row as ``--locate-times`` prints it."""
    text = (f"locate {r['case']} {r['shape']}: bit-equal (tolerance 0), "
            f"the call {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']} ({r['search_steps']} search and "
            f"{r['walk_steps']} walk steps); K3 alone {r['k3_ms']:.4f} ms, "
            f"K4 alone on the starts {r['walk_ms']:.4f} ms")
    if "sorted_ms" in r:
        text += (f"; the reads presorted by their reversed codes "
                 f"{r['sorted_ms']:.4f} ms")
    for key, what in (("counts", "caller's order"),
                      ("counts_sorted", "presorted")):
        c = r.get(key)
        if c:
            B = c["reads"]
            text += (f"; {what}: per read {c['row_fetches'] / B:.2f} row "
                     f"fetches ({c['search_steps'] / B:.2f} search steps, "
                     f"{c['two_row_steps'] / B:.2f} of two rows, "
                     f"{c['walk_steps'] / B:.2f} walk steps, longest "
                     f"{c['walk_longest']}, a warp's longest "
                     f"{c['walk_warp_longest']:.2f}), {c['sectors'] / B:.2f} "
                     f"sectors, {c['lines'] / B:.2f} lines, "
                     f"{c['requests'] / B:.2f} L1 requests a read, "
                     f"{c['rounds']} rounds, {100 * c['utilization']:.1f} % "
                     f"of lane-rounds step")
    return text


def locate_times(bits: int = 25, seed: int = 0) -> list:
    """``--locate-times``: the fused locate on a 2^bits-base genome (sa_rate
    4) on phase 4's 2^20 30-mers plain and k = 12-seeded and on phase 7's
    mixed reads whose walks start on a real row (:func:`locate_case`: the
    package's kernel beside K3 and K4 alone, the presorted 30-mers, the
    counts), then the wide index's kernel beside the int32 one on the
    30-mers of the same genome, plain and seeded, and on 2^20 30-mers of a
    2^WIDE_BIG_BITS-base genome (its tables past the L2), in turns; one JSON
    line a case.  A copy of this file beside an older tree's package times
    that tree's kernel the same way, for a pairing in one call."""
    import numpy as np
    import torch

    import bwt_tpu_torch
    from bwt_tpu_torch.ops import _kernels, search

    tag = f"[{card_line()}]"
    nq, nmixed, reps = 1 << 20, 1 << 16, 20
    _kernels.build(verbose=True)
    regs = [r for key, tp, wide, r in _forms()
            if key == "locate" and not tp and not wide]
    require(regs and all(f == ("0", "0")
                         for f in _frames(_kernels.LAST_REPORT)),
            "a kernel of the package keeps values in local memory")
    print(f"locate-times the package's locate kernel: {regs} registers "
          f"(int32, replicated: the tile and global forms), no stack "
          f"frame {tag}", flush=True)
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=1 << bits).astype(np.uint8)
    fmi = bwt_tpu_torch.build_index(codes, sa_sample_rate=4, device="cuda")
    n = fmi.length
    table = search.build_seed_table(fmi, k=SEED_K)
    starts = rng.integers(0, n - 30, size=nq)
    kmers = torch.from_numpy(codes[np.add.outer(starts, np.arange(30))]
                             .astype(np.int32)).cuda()
    klens = torch.full((nq,), 30, dtype=torch.int32, device="cuda")
    mp, ml = mixed_reads(rng, codes, nmixed)
    mp, ml = torch.from_numpy(mp).cuda(), torch.from_numpy(ml).cuda()
    out = []
    for name, p, ln, st in (
            ("30-mers, plain", kmers, klens, None),
            (f"30-mers, seeded k={SEED_K}", kmers, klens, table),
            ("mixed reads, plain", mp, ml, None),
            (f"mixed reads, seeded k={SEED_K}", mp, ml, table)):
        if name.startswith("mixed"):
            s0 = search.search_lanes(fmi, p, ln, seed_table=st)["start"]
            real = ((s0 >= 0) & (s0 <= n)) | (s0 == -2 ** 31)
            p, ln = p[real].contiguous(), ln[real].contiguous()
        r = locate_case(fmi, p, ln, st, name,
                        sort=name.startswith("30-mers"))
        r.update(bits=bits, card=tag)
        print(f"locate-times {locate_text(r)} {tag}", flush=True)
        print("locate-times " + json.dumps(r), flush=True)
        out.append(r)
        torch.cuda.empty_cache()
    # the wide index's kernel beside the int32 one, in turns
    for b in (bits, WIDE_BIG_BITS):
        if b != bits:
            del fmi, table
            torch.cuda.empty_cache()
            codes = rng.integers(0, 4, size=1 << b).astype(np.uint8)
            fmi = bwt_tpu_torch.build_index(codes, sa_sample_rate=4,
                                            device="cuda")
            starts = rng.integers(0, fmi.length - 30, size=nq)
            kmers = torch.from_numpy(codes[np.add.outer(
                starts, np.arange(30))].astype(np.int32)).cuda()
        wide = bwt_tpu_torch.build_index(codes, sa_sample_rate=4,
                                         index_dtype=np.int64, device="cuda")
        tabs = ({id(fmi): search.build_seed_table(fmi, k=SEED_K),
                 id(wide): search.build_seed_table(wide, k=SEED_K)}
                if b == bits else {})
        for seeded in ((False, True) if b == bits else (False,)):
            def run(f):
                return search.locate_kernel(
                    f, kmers, klens,
                    seed_table=tabs[id(f)] if seeded else None)

            got_w, got_n = run(wide)[:-2], run(fmi)[:-2]
            require(torch.equal(got_w, got_n.long()),
                    f"the wide locate differs from the int32 one at 2^{b}")
            ms = {"wide": [], "int32": []}
            for _ in range(2):
                for f, key in ((wide, "wide"), (fmi, "int32")):
                    ms[key].append(cuda_ms(lambda: run(f), reps, ahead=True))
            r = dict(kernel="locate_wide", bits=b, shape=f"B={nq} L=30",
                     case=f"30-mers, {'seeded k=%d' % SEED_K if seeded else 'plain'}",
                     ms_wide=ms["wide"], ms_int32=ms["int32"], card=tag)
            print(f"locate-times locate_wide {r['case']} on 2^{b} bases: wide "
                  f"{ms['wide'][0]:.4f}; {ms['wide'][1]:.4f} ms, int32 "
                  f"{ms['int32'][0]:.4f}; {ms['int32'][1]:.4f} ms, equal "
                  f"{tag}", flush=True)
            print("locate-times " + json.dumps(r), flush=True)
            out.append(r)
        del wide, tabs
        torch.cuda.empty_cache()
    return out


def _round_steps(fmi, bank, fields, cols, *, ext, walk, seed_k) -> dict:
    """The work of one service round, from its own results: the search
    steps each loop lane took (from its match count and whether it died; a
    lane that could start from the seed table is spared k - 1 of them), the
    walks and their steps, the window chains and their steps, the lanes
    that started from the table, and the bytes of the slices searched."""
    import torch

    from bwt_tpu_torch.ops import service as sv

    opc, _, _, ln, sp, ep, idx = fields
    B, Lb = opc.shape[0], bank.shape[1]
    is_mms = (opc == sv.OP_MMS) | (opc == sv.OP_MEXT)
    is_cont = opc == sv.OP_CONT
    is_bs = (opc == sv.OP_BSEARCH) | (opc == sv.OP_BEXT)
    in_loop = is_mms | is_cont | is_bs
    nm, alive = cols[sv.NM].long(), cols[sv.ALIVE] != 0
    started = torch.where(is_cont, ep > sp, nm >= 1)
    steps = ((nm - (started & ~is_cont).long()).clamp(min=0)
             + (started & ~alive).long())
    seeded = torch.zeros_like(in_loop)
    if seed_k:
        eff = torch.where(is_mms, ln - cols[sv.SKIPS], ln).clamp(min=1)
        seeded = (is_mms | is_bs) & (ln > 0) & (eff >= seed_k)
        steps = torch.where(seeded, (steps - (seed_k - 1)).clamp(min=0), steps)
    nwalk = walks = 0
    if walk:
        zeros = torch.zeros_like(opc)
        walk0 = torch.where(
            opc == sv.OP_UNC, idx, torch.where(
                opc == sv.OP_MMS, cols[sv.OSP],
                torch.where(is_cont | is_bs, cols[sv.START], zeros)))
        nwalk, walks = _walk_steps(fmi, walk0), B
    nwin = wins = 0
    if ext:
        m_ext = opc == sv.OP_MEXT
        any_ext = m_ext | (opc == sv.OP_BEXT)
        wlo = torch.where(m_ext, sp - cols[sv.MMS_M] - (ep + 3), sp)
        wwid = torch.where(m_ext, 2 * (ep + 3) + 1, ep).clamp(0, 32)
        wwid = torch.where(any_ext, wwid, 0)
        nwin, wins = _window_steps(fmi, wlo, wwid), int((wwid > 0).sum())
    return dict(search=int(steps[in_loop].sum()), walk=nwalk, walks=walks,
                window=nwin, windows=wins, seeded=int(seeded.sum()),
                slice_bytes=int(ln[in_loop].clamp(0, Lb).sum())
                * bank.element_size())


def _service_bound(fmi, bank, fields, cols, *, ext, walk, seed_k) -> dict:
    """The bound of one service round from its own results
    (:func:`_round_steps`), with one rank a lane for the C[c] + rank
    column; bytes: the fields, each slice once, a sector a seed row, the
    13 columns, and the index sectors the steps touch."""
    B = fields[0].shape[0]
    w = _round_steps(fmi, bank, fields, cols, ext=ext, walk=walk,
                     seed_k=seed_k)
    lf_steps = w["walk"] + w["window"]
    nbytes = (4 * 7 * B + w["slice_bytes"] + 32 * w["seeded"] + 4 * 13 * B
              + _index_bytes(fmi, w["search"], lf_steps, w["walks"])
              + 32 * w["windows"])
    ops = (SEARCH_STEP_OPS * w["search"] + WALK_STEP_OPS * lf_steps
           + (RANK_OPS + 1) * B)
    return dict(bound_of(nbytes, ops), search_steps=w["search"],
                walk_steps=w["walk"], window_steps=w["window"])


# csrc/service.cu's kTileLanes and kSmallTile: a round of at most this many
# lanes runs a tile of four threads a lane
SERVICE_TILE_LANES = 1 << 14
SERVICE_SMALL_TILE = 4


def pick_rounds(driver, rounds) -> list:
    """The service rounds of one host-engine run (``(bank, fields, kw)``
    each, in order) that phase 7 times K7 on: the largest, the largest ext
    round, and the largest round that the kernel tiles, each once, named
    by ``driver``, its index in the run and its lanes."""
    picked = {}
    lanes = [r[1][0].shape[0] for r in rounds]
    cands = (max(range(len(rounds)), key=lanes.__getitem__),
             max((k for k in range(len(rounds)) if rounds[k][2]["ext"]),
                 key=lanes.__getitem__, default=None),
             max((k for k in range(len(rounds))
                  if lanes[k] <= SERVICE_TILE_LANES),
                 key=lanes.__getitem__, default=None))
    for k in cands:
        if k is not None and k not in picked:
            bank, fields, kw = rounds[k]
            picked[k] = (f"round {k} of {driver} (host engine, "
                         f"{'ext' if kw['ext'] else 'no ext'}, "
                         f"{fields[0].shape[0]} lanes)", bank, fields,
                         {key: v for key, v in kw.items() if key != "plain"})
    return list(picked.values())


def service_case(fmi, case, bank, fields, kw, forms, latency_us, tag) -> dict:
    """Phase 7's K7 on one round: the kernel in the package's form and in
    each of ``forms`` ({name: (library, report)}, :func:`finish_tile_builds`)
    against its plain version on the card, bit-equal in all 13 columns and
    the flag, each timed by CUDA events beside the round's bound and its
    Part A chains (:func:`service_chains`) at ``latency_us`` a load."""
    import torch

    from bwt_tpu_torch.ops import service as sv

    kw = dict(kw, plain=False)
    B = fields[0].shape[0]
    want, plain_ms = _event_ms(lambda: sv.service_round_packed(
        fmi, bank, *fields, **dict(kw, plain=True)))

    def run():
        return sv.service_round_packed(fmi, bank, *fields, **kw)

    by_form, err = {}, 0
    for name, (lib, _) in [("package", (None, None))] + list(forms.items()):
        with automaton_tile(lib, SERVICE_LAUNCHERS):
            got = run()
            e = _max_abs_diff([got], [want])
            same = got.shape == want.shape and torch.equal(got, want)
            bad = [] if same else sorted({int(c) for c in (
                torch.nonzero(got != want)[:, 0] // max(B, 1)).tolist()})
            require(same, f"the service kernel ({name}) differs from its "
                          f"plain version ({case}) in columns {bad} (13: the "
                          f"flag): max |d| {e}")
            by_form[name] = cuda_ms(run, 20, ahead=True)
        err = max(err, e)
    cols = want[:-2].view(sv.NCOLS, B)
    seed_k = kw.get("seed_k", 0) if kw.get("seed_rows") is not None else 0
    bound = _service_bound(fmi, bank, fields, cols, ext=kw["ext"],
                           walk=kw["walk"], seed_k=seed_k)
    chains = service_chains(fmi, fields, cols, ext=kw["ext"], walk=kw["walk"],
                            seed_k=seed_k, tiles=(1, SERVICE_SMALL_TILE))
    tile = SERVICE_SMALL_TILE if B <= SERVICE_TILE_LANES else 1
    longest = chains["tiles"][tile]["longest"]
    row = dict(kernel="service", case=case,
               shape=f"B={B} Lb={bank.shape[1]} {bank.dtype}",
               max_abs_err=err, ms=by_form["package"], plain_ms=plain_ms,
               forms_ms=by_form, tile=tile, chains=chains,
               chain_ms=longest * latency_us / 1e3, **bound)
    print(f"phase 7 service {case} {row['shape']}: bit-equal in every form "
          f"(tolerance 0, max |d| {err}), kernel {by_form['package']:.4f} ms "
          f"at tile {tile} (the forms built apart: " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in by_form.items() if k != "package")
          + f"), plain {plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms by "
          f"{bound['bound_by']} ({bound['bytes']} bytes, {bound['ops']} "
          f"operations: {bound['search_steps']} search, "
          f"{bound['walk_steps']} walk and {bound['window_steps']} window "
          f"steps); the longest warp's chain of dependent loads at tile 1 / "
          f"{SERVICE_SMALL_TILE}: {chains['tiles'][1]['longest']} / "
          f"{chains['tiles'][SERVICE_SMALL_TILE]['longest']} loads, "
          f"{row['chain_ms']:.4f} ms at tile {tile} at {latency_us:.4f} us a "
          f"load {tag}", flush=True)
    return row


def phase_service_kernels(fmi, codes_np, rng, table, recorded, tag, forms,
                          latency_us, nlanes=1 << 13, nwindows=1 << 16):
    """Phase 7, the executor's kernels: the service round (K7) on fuzzed
    rounds and on the host engine's recorded ones (``recorded``, cases of
    :func:`pick_rounds`), in the package's form and in each of ``forms``
    (:func:`service_case`), the inverse-SA window (K6) and the seed-table
    build (K5) against their plain versions on the card, bit-equal, each
    timed beside its bound."""
    import torch

    import bwt_tpu_torch
    from bwt_tpu_torch.ops import search
    from bwt_tpu_torch.ops import service as sv

    dev = fmi.device
    n = fmi.length
    rows = []

    def report(kernel, case, shape, err, ms, plain_ms, bound, extra=""):
        rows.append(dict(kernel=kernel, case=case, shape=shape,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound))
        print(f"phase 7 {kernel} {case} {shape}: bit-equal (tolerance 0, "
              f"max |d| {err}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound['bound_ms']:.4f} ms by {bound['bound_by']} "
              f"({bound['bytes']} bytes, {bound['ops']} operations)"
              f"{extra} {tag}", flush=True)

    for resolve, ext, seeded in ((False, False, False), (True, False, False),
                                 (True, True, False), (True, True, True),
                                 (False, True, True)):
        bank_np, f_np = service_lanes(rng, codes_np, nlanes, with_n=resolve)
        bank = torch.from_numpy(bank_np).to(dev)
        fields = tuple(torch.from_numpy(f_np).to(dev).unbind(0))
        kw = dict(resolve=resolve, ext=ext, walk=True)
        if seeded:
            kw.update(seed_rows=table.rows, seed_k=table.k)
        rows.append(service_case(
            fmi, f"fuzzed lanes, all eight opcodes, resolve={resolve} "
                 f"ext={ext} seed table "
                 f"{'k=%d' % table.k if seeded else 'none'}",
            bank, fields, kw, forms, latency_us, tag))
    for case, bank, fields, kw in recorded:
        rows.append(service_case(fmi, case, bank, fields, kw, forms,
                                 latency_us, tag))

    # K6 on the windows of isa_phase_windows, at the index's sa_rate 4 and
    # on a sa_rate-32 index of the same genome
    plo, wid = isa_phase_windows(rng, n, nwindows, dev)
    got = search.isa_window(fmi, plo, wid)
    back = search.unc_sa(fmi, got[0])
    require(back.tolist() == list(range(32)),
            "the window at position 0 does not hold the rows of 0..31")
    fmi32 = bwt_tpu_torch.build_index(codes_np, sa_sample_rate=32, device=dev)
    for f in (fmi, fmi32):
        r = isa_case(f, plo, wid)
        rows.append(r)
        print(f"phase 7 {isa_text(r)} {tag}", flush=True)
    del fmi32
    torch.cuda.empty_cache()

    # K5 at the table's k against the plain build.  Its bound is what the
    # function must do: write the table, read each bucket row a live parent
    # needs once, and rank each live parent's two rows for all four
    # characters (SEED_PARENT_OPS); the per-key steps of its prefixes and of
    # the kernel's first form repeat a parent's work for every key below it
    got = search._seed_rows(fmi, table.k)
    want, plain_ms = _event_ms(lambda: search._seed_rows_plain(fmi, table.k))
    err = _max_abs_diff([got], [want])
    require(torch.equal(got, want) and torch.equal(got, table.rows),
            f"K5 differs from its plain version: max |d| {err}")
    del want
    loads = seed_loads(fmi, table.k)
    bound = bound_of(
        4 * got.numel() + min(4 * fmi.buckets.numel(),
                              32 * loads["level"]["loads"]),
        SEED_PARENT_OPS * loads["parents"])
    ms = cuda_ms(lambda: search._seed_rows(fmi, table.k), 5)
    report("seed_rows", f"k={table.k}", f"{4 ** table.k} keys", err, ms,
           plain_ms, bound,
           f", {loads['parents']} live parents; bucket rows loaded: "
           f"{loads['subtree']['loads']} (this kernel: {4 ** loads['prefix']}"
           f" prefixes, then {loads['fused']} levels a thread), "
           f"{loads['level']['loads']} (a launch a level), "
           f"{loads['per_key']['loads']} (a thread a key); registers "
           f"{registers_of('seed_rows_kernel')}")
    rows[-1].update(loads=loads, launches_per_table=1)
    return rows


def automaton_bank(fmi, reads, kernel, config=None):
    """One chunk's bank as the device engines build it: K10's (``kernel``
    "align": each read's forward row and its reverse complement) or K9's
    ("rna": one row a read), with the lengths and live flags of its padded
    rows; and whether a read holds an N."""
    import numpy as np
    import torch

    from bwt_tpu_torch.models.batch_exec import QueryService

    svc = QueryService(fmi, config=config)
    svc.add_reads_batch(reads, with_revcomp=kernel == "align")
    bank = svc.bank8
    rows = bank.shape[0] // (2 if kernel == "align" else 1)
    lens = np.zeros(rows, np.int32)
    lens[:len(reads)] = [len(r) for r in reads]
    return (bank, torch.from_numpy(lens).to(fmi.device),
            torch.arange(rows, device=fmi.device) < len(reads), svc._has_n)


# --------------------------------------------------------------------------
# The automatons' chains of dependent loads, counted from the rounds of
# their plain versions.
#
# K9 and K10 run a read's whole phase machine in one tile of threads, and a
# chunk of 2^15 reads fills a fraction of the card's thread slots, so what
# sets a chunk's time is the longest read's chain: the loads each of which
# needs the one before it (a search step's bucket row needs the interval
# the step before it made).  Counted per lane of a service round, in the
# order the lane body issues them:
#
#   * the seed-table row, where the search starts from the table;
#   * one a search step (its one or two bucket rows are issued together);
#   * one a step of the SA walk, and the SA sample it ends on;
#   * for a window scan, the ISA sample it anchors at and one a step of its
#     chain down to the window's floor; split ``split`` ways (K9's tile
#     scans CONT1's window in slices, one a lane), the longest slice.
#
# A read's chain is the sum over the rounds of the plain version of the
# longest of its lanes in the round: at ``width`` 1 one iteration a round,
# the sequential chain of the one-thread-a-read kernel; at the kernels' tile
# width the candidates a round issues side by side, where a hunt's
# candidates after the one taken search but skip their walks (the tiles'
# gate).  :class:`Chain` is the ``on_round`` hook that sums them.  The
# bank's characters are not in the chain (their addresses are known up
# front), nor is the rank a lane makes for its C[c] + rank column (no load
# waits for it).
# --------------------------------------------------------------------------


# the samples are every sa_rate-th row, so a walk's length is geometric
# (a quarter of the steps land on one at rate 4): far below this bound,
# which only a row past the suffix array reaches
_WALK_LIMIT = 1 << 12


def walk_steps(fmi, rows):
    """Per lane, the LF steps of the SA walk from ``rows`` to a sampled
    row (int64)."""
    import torch

    from bwt_tpu_torch.ops import rank as rank_ops

    i = rows.to(torch.int32)
    steps = torch.zeros_like(i, dtype=torch.int64)
    mask = fmi.sa_rate - 1
    for _ in range(_WALK_LIMIT):
        live = (i & mask) != 0
        if not bool(live.any()):
            return steps
        steps += live
        i = torch.where(live, rank_ops.lf(fmi.buckets, fmi.C, fmi.endloc, i),
                        i)
    raise RuntimeError(f"a walk took more than {_WALK_LIMIT} steps")


def window_slices(fmi, plo, width, split: int):
    """Per lane, the dependent loads of the inverse-SA chain of the window
    ``[plo, plo + width)`` (``fm::isa_chain``: the sample at or above the
    window's top, then one LF step a position down to its floor), cut into
    ``split`` slices of ``ceil(width / split)`` positions that chain side
    by side: the longest slice's and the sum over the slices (int64 each;
    0 for an empty window)."""
    import torch

    from bwt_tpu_torch.ops import service as sv

    n, r = fmi.length, fmi.sa_rate
    shift = r.bit_length() - 1
    plo, width = plo.to(torch.int64), width.to(torch.int64)
    size = (width + split - 1) // split
    best = torch.zeros_like(plo)
    total = torch.zeros_like(plo)
    for s in range(split):
        lo = plo + s * size
        w = torch.minimum(size, width - s * size)
        p_hi = torch.clamp(lo + w - 1, max=n)
        anchor = torch.clamp(((p_hi + r - 1) >> shift) << shift, 0, n)
        span = (anchor - lo.clamp(min=0) + 1).clamp(min=0, max=r - 1 + sv.W)
        span = torch.where(w > 0, span, 0)
        best = torch.maximum(best, span)
        total += span
    return best, total


def window_loads(fmi, plo, width, split: int = 1):
    """Per lane, the longest slice's loads (:func:`window_slices`)."""
    return window_slices(fmi, plo, width, split)[0]


def lane_loads(fmi, fields, cols, *, seed_k: int = 0, split: int = 1,
               gated=None):
    """Per lane of a service round with the walk taken and the window scan
    on (the automatons' rounds), its chain of dependent loads in three
    parts, the search's, the walk's and the window's ((3, B) int64; 0 on a
    lane with no request).  ``fields`` the seven lane fields, ``cols``
    the (13, B) result columns; ``seed_k`` the seed table's k (0: none);
    ``split`` the slices of a ``bsearch_ext`` lane's window; ``gated`` (B,)
    bool, lanes that search only (their walk and window skipped)."""
    import torch

    from bwt_tpu_torch.ops import service as sv

    opc, _, _, ln, sp, ep, idx = fields
    is_mms = (opc == sv.OP_MMS) | (opc == sv.OP_MEXT)
    is_cont = opc == sv.OP_CONT
    is_bs = (opc == sv.OP_BSEARCH) | (opc == sv.OP_BEXT)
    nm = cols[sv.NM].to(torch.int64)
    alive = cols[sv.ALIVE] != 0
    # the steps after the initial state, and the one that emptied it
    started = torch.where(is_cont, ep > sp, nm >= 1)
    steps = ((nm - (started & ~is_cont).to(torch.int64)).clamp(min=0)
             + (started & ~alive))
    seeded = torch.zeros_like(is_mms)
    if seed_k:
        eff = torch.where(is_mms, ln - cols[sv.SKIPS], ln).clamp(min=1)
        seeded = (is_mms | is_bs) & (ln > 0) & (eff >= seed_k)
        steps = torch.where(seeded, (steps - (seed_k - 1)).clamp(min=0),
                            steps)
    steps = torch.where(is_mms | is_cont | is_bs, steps, 0)
    walk0 = torch.where(opc == sv.OP_UNC, idx, torch.where(
        opc == sv.OP_MMS, cols[sv.OSP], torch.where(
            is_cont | is_bs, cols[sv.START], torch.zeros_like(opc))))
    m_ext, b_ext = opc == sv.OP_MEXT, opc == sv.OP_BEXT
    wlo = torch.where(m_ext, sp - cols[sv.MMS_M] - (ep + 3), sp)
    wwid = torch.where(m_ext, 2 * (ep + 3) + 1, ep).clamp(0, sv.W)
    wwid = torch.where(m_ext | b_ext, wwid, 0)
    window = torch.where(b_ext, window_loads(fmi, wlo, wwid, split),
                         window_loads(fmi, wlo, wwid))
    walk = walk_steps(fmi, walk0) + 1
    if gated is not None:
        walk = torch.where(gated, 0, walk)
        window = torch.where(gated, 0, window)
    parts = torch.stack([seeded + steps, walk, window])
    return torch.where(opc != sv.OP_NONE, parts, 0)


class Chain:
    """An ``on_round`` hook of ``align_automaton_plain`` /
    ``rna_seq_automaton_plain`` run at ``width``: per read, the sum over
    the rounds of its longest lane's loads (:func:`lane_loads`); per warp
    of the kernel (32 lanes, read b's candidate q at thread b * width + q),
    the sum over the rounds of its longest search, its longest walk and its
    longest window, which its threads run side by side and wait for
    together; and over all lanes the loads and the count of each event
    code (``names``, the plain version's event tuple; K10's RESET and
    strand-retry bits are counted apart).  ``split`` slices a
    ``bsearch_ext`` lane's window."""

    def __init__(self, fmi, nreads: int, *, width: int, names,
                 seed_k: int = 0, split: int = 1):
        import torch

        self.fmi, self.width, self.names = fmi, width, tuple(names)
        self.seed_k, self.split = seed_k, split
        self.loads = torch.zeros(nreads, dtype=torch.int64)
        self.warps = torch.zeros(-(-nreads * width // 32), dtype=torch.int64)
        self.by_event = torch.zeros(len(self.names), dtype=torch.int64)
        self.count = torch.zeros(len(self.names), dtype=torch.int64)
        self.flags = {"reset": 0, "retry": 0}
        self.rounds = 0

    def __call__(self, fields, cols, events):
        import torch

        from bwt_tpu_torch.ops import service as sv
        from bwt_tpu_torch.ops.automaton import EV_SPEC

        # the tiles skip the walks of a hunt's candidates after the one
        # taken: K10's anchor retries (mms), K9's hunts (bsearch)
        hunt = (fields[0] == sv.OP_MMS) | (fields[0] == sv.OP_BSEARCH)
        per = lane_loads(self.fmi, fields, cols, seed_k=self.seed_k,
                         split=self.split,
                         gated=hunt & (events == EV_SPEC)).cpu()
        events = events.cpu().to(torch.int64)
        parts = torch.where(events != 0, per, 0)
        per = parts.sum(0)
        n = self.loads.shape[0]
        self.loads += per.view(-1, self.width)[:n].amax(1)
        w = self.warps.shape[0]
        lanes = torch.zeros(3, w * 32, dtype=torch.int64)
        lanes[:, :min(per.shape[0], w * 32)] = parts[:, :w * 32]
        self.warps += lanes.view(3, w, 32).amax(2).sum(0)
        code = events & 7
        self.by_event.index_add_(0, code, per)
        self.count.index_add_(0, code, torch.ones_like(code))
        self.flags["reset"] += int(((events & 8) != 0).sum())
        self.flags["retry"] += int(((events & 16) != 0).sum())
        self.rounds += 1

    def summary(self, live=None) -> dict:
        """Longest and mean chain over the reads (``live``: a mask of the
        real ones), the longest and mean warp, the rounds, the loads of
        every lane issued (the work the tiles' threads do, discarded
        candidates included), and per event its lanes and loads."""
        loads = self.loads if live is None else self.loads[live.cpu()]
        warps = self.warps
        if live is not None:  # the warps that hold a real read
            warps = warps[:-(-int(live.sum()) * self.width // 32)]
        return dict(
            width=self.width, rounds=self.rounds,
            longest=int(loads.max()) if loads.numel() else 0,
            mean=float(loads.float().mean()) if loads.numel() else 0.0,
            warp_longest=int(warps.max()) if warps.numel() else 0,
            warp_mean=float(warps.float().mean()) if warps.numel() else 0.0,
            issued=int(self.by_event.sum()),
            events={name: [int(c), int(x)] for name, c, x in zip(
                self.names, self.count, self.by_event) if c and name != "none"},
            **self.flags)


def automaton_chains(fmi, bank, lens, live0, seed, kernel, widths, *,
                     on_round=None, **kw) -> tuple[dict, dict]:
    """The chain of dependent loads of K10 (``kernel`` "align") or K9
    ("rna") on one bank, longest and mean over its reads, from the plain
    version's rounds at each of ``widths`` (:class:`Chain`; K9's tile also
    splits CONT1's window among its lanes).  ``kw`` are the automaton's
    keywords; ``on_round`` also sees the rounds at width 1.  Every width's
    outputs must equal the first's (the schedule changes no output).
    Returns ({width: Chain.summary()}, the first width's outputs)."""
    import torch

    from bwt_tpu_torch.ops import automaton as au

    out, first = {}, None
    for T in widths:
        names = au.ALIGN_EVENTS if kernel == "align" else au.RNA_EVENTS
        c = Chain(fmi, lens.shape[0], width=T, names=names,
                  seed_k=seed.k, split=1 if kernel == "align" else T)

        def hook(*a, c=c, T=T):
            c(*a)
            if T == 1 and on_round is not None:
                on_round(*a)

        if kernel == "align":
            got = au.align_automaton_plain(
                fmi, bank, lens, live0, fmi.length, seed.rows, width=T,
                on_round=hook, seed_k=seed.k, **kw)
        else:
            got = au.rna_seq_automaton_plain(
                fmi, bank, lens, live0, seed.rows, width=T, on_round=hook,
                seed_k=seed.k, **kw)
        parts = list(got.values()) if kernel == "align" else list(got)
        if first is None:
            first, want = got, parts
        require(all(torch.equal(x, y) for x, y in zip(parts, want)),
                f"the plain {kernel} automaton at width {T} differs from "
                f"width {widths[0]}")
        out[T] = c.summary(live0)
    return out, first


def cpu_chains(n=4096, seed=0, widths=(1, 2, 4, 8), bits=25):
    """The automatons' chains counted on the CPU, before any kernel: the
    2^``bits``-base genome and k = 12 table of phases 3-4 (from ``seed``), ``n``
    reads of each of phase 5's and phase 10's kinds, K10 and K9 through
    their plain versions at each tile width (:func:`automaton_chains`).
    Prints one JSON line a kernel and kind, with, for the substitution
    reads, the iterations by where the substitution lies (its distance
    from the read's end: the anchor hunt searches the last bases first).

        python3 -c 'import chip_smoke; chip_smoke.cpu_chains()'

    About 3 GiB and a few minutes on the CPU."""
    import numpy as np

    import bwt_tpu_torch
    from bwt_tpu_torch.config import DEFAULT
    from bwt_tpu_torch.ops import search

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=1 << bits).astype(np.uint8)
    t0 = time.perf_counter()
    fmi = bwt_tpu_torch.build_index(codes, sa_sample_rate=4, device="cpu")
    table = search.build_seed_table(fmi, k=SEED_K)
    print(f"index and k={SEED_K} table on the CPU in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    sub_starts, sub = mutated_reads(rng, codes, n)
    _, ind = indel_reads(rng, codes, n)
    _, rna, _ = complemented_reads(rng, codes, n)
    for kernel, what, reads in (("align", "subst", sub),
                                ("align", "indel", ind), ("rna", "rna", rna)):
        bank, lens, live0, has_n = automaton_bank(fmi, reads, kernel)
        kw = (dict(anchor_len=DEFAULT.anchor_len) if kernel == "align" else
              dict(ac=DEFAULT.rnaseq_anchor_cutoff,
                   cc=DEFAULT.rnaseq_cont_cutoff))
        t0 = time.perf_counter()
        chains, got = automaton_chains(fmi, bank, lens, live0, table, kernel,
                                       widths, resolve=has_n, **kw)
        iters = (got["iters"] if kernel == "align" else got[2])[:n].numpy()
        line = dict(kernel=kernel, reads=what, n=n, chains=chains,
                    iters_hist=np.bincount(iters).tolist(),
                    s=round(time.perf_counter() - t0, 1))
        if what == "subst":
            cut = codes[np.add.outer(sub_starts, np.arange(reads.shape[1]))]
            from_end = reads.shape[1] - 1 - (reads != cut).argmax(1)
            for lo, hi in ((0, 12), (12, 80)):
                sel = (from_end >= lo) & (from_end < hi)
                line[f"iters_sub_{lo}_{hi}_from_end"] = np.bincount(
                    iters[sel]).tolist()
        print(json.dumps(line), flush=True)


# --------------------------------------------------------------------------
# The anchor hunt's tile (csrc/anchor_scan.cu), counted from the plain
# version's rounds before any kernel: a read's chain of dependent row loads
# and the steps its tile issues, at each width.
# --------------------------------------------------------------------------

ANCHOR_WIDTHS = (1, 2, 4, 8, 16, 32)
_NEVER = 1 << 40


class HuntChain:
    """An ``on_round`` hook of ``exact.anchor_scan_plain`` at ``width``:
    per read, the sum over its rounds of its longest candidate's search
    steps (the candidates of a round run side by side, a step a dependent
    row load), and the same where a candidate leaves off once a lower one
    has matched ``min_anchor`` characters (the quit: it stops at the
    earliest step at which a lower candidate that anchors got there); per
    warp of the kernel (read b's candidate q at thread b * width + q), the
    sum over the rounds of its longest thread (the warp in lockstep); the
    steps issued over all candidates, discarded ones included, without
    and with the quit; and the last anchor's row, whose walk
    :meth:`summary` adds."""

    def __init__(self, nreads: int, *, width: int, min_anchor: int):
        import torch

        self.width, self.min_anchor = width, min_anchor
        self.loads = torch.zeros(nreads, dtype=torch.int64)
        self.quit_loads = torch.zeros(nreads, dtype=torch.int64)
        self.lockstep = torch.zeros(-(-nreads * width // 32),
                                    dtype=torch.int64)
        self.issued = self.quit_issued = self.rounds = 0
        self.sp = torch.zeros(nreads, dtype=torch.int32)
        self.got = torch.zeros(nreads, dtype=torch.bool)

    def __call__(self, plen, res, events):
        import torch

        from bwt_tpu_torch.models import exact

        T = self.width
        res = {k: v.cpu() for k, v in res.items()}
        ev = events.cpu().view(-1, T)
        n0 = res["nmatched"] >= 1
        steps = _search_steps(res, 1, n0).view(-1, T)
        m = (res["nmatched"] + res["skips"]).view(-1, T)
        stops = (ev != exact.EV_NONE) & (m >= self.min_anchor)
        reach = (self.min_anchor - n0.to(torch.int64).view(-1, T)
                 - res["skips"].view(-1, T)).clamp(min=0)
        reach = torch.where(stops, reach, _NEVER).cummin(1).values
        quit_at = torch.cat([torch.full_like(reach[:, :1], _NEVER),
                             reach[:, :-1]], 1)
        cut = torch.minimum(steps, quit_at)
        self.loads += steps.amax(1)
        self.quit_loads += cut.amax(1)
        flat = torch.zeros(self.lockstep.shape[0] * 32, dtype=torch.int64)
        flat[:steps.numel()] = steps.reshape(-1)
        self.lockstep += flat.view(-1, 32).amax(1)
        self.issued += int(steps.sum())
        self.quit_issued += int(cut.sum())
        taken = ev == exact.EV_TAKEN
        has = taken.any(1)
        sp = res["sp"].view(-1, T).gather(
            1, taken.to(torch.int8).argmax(1, keepdim=True).long())[:, 0]
        self.sp = torch.where(has, sp, self.sp)
        self.got |= has
        self.rounds += 1

    def summary(self, fmi) -> dict:
        """Per read (search and walk steps), mean and longest, without and
        with the quit; per warp, the longest read's chain and the
        lockstep sum with the longest walk, mean and
        longest; the rounds; the steps issued."""
        import torch

        walk = torch.where(self.got, walk_steps(fmi, self.sp.to(fmi.device))
                           .cpu(), 0)
        chain, quit = self.loads + walk, self.quit_loads + walk
        per = 32 // self.width
        pad = -len(chain) % per
        warp = torch.cat([chain, chain.new_zeros(pad)]).view(-1, per)
        wwalk = torch.cat([walk, walk.new_zeros(pad)]).view(-1, per)
        lock = self.lockstep + wwalk.amax(1)

        def mm(x):
            return [float(x.float().mean()), int(x.max())] if len(x) else [0, 0]

        return dict(width=self.width, rounds=self.rounds, read=mm(chain),
                    read_quit=mm(quit), warp=mm(warp.amax(1)),
                    lockstep=mm(lock), walk=int(walk.sum()),
                    issued=self.issued + int(walk.sum()),
                    issued_quit=self.quit_issued + int(walk.sum()))


def hunt_chains(fmi, pats, lens, min_anchor: int, widths=ANCHOR_WIDTHS):
    """The anchor hunt's chains (:class:`HuntChain`) of the reads ``pats``
    (as hunted: reversed already where the kernel flips them) at each of
    ``widths``, from the plain version's rounds on the index's device.
    Every width's outputs must equal the first's.  Returns ({width:
    summary}, the first width's outputs)."""
    import torch

    from bwt_tpu_torch.models import exact

    out, first = {}, None
    for T in widths:
        c = HuntChain(lens.shape[0], width=T, min_anchor=min_anchor)
        got = exact.anchor_scan_plain(fmi, pats, lens, min_anchor=min_anchor,
                                      width=T, on_round=c)
        if first is None:
            first = got
        require(all(torch.equal(a, b) for a, b in zip(got, first)),
                f"the plain anchor scan at width {T} differs from width "
                f"{widths[0]}")
        out[T] = c.summary(fmi)
    return out, first


def hunt_inputs(rng, codes, nmixed=1 << 16, chunk=1 << 15):
    """Phase 7's anchor-hunt reads, as numpy: (name, codes, lengths) of
    the mixed reads (L = 100, N runs, ragged) and of one search_reads
    chunk (``chunk`` 50-bp genome substrings, uint8)."""
    import numpy as np

    pats, lens = mixed_reads(rng, codes, nmixed)
    starts = rng.integers(0, len(codes) - 50, size=chunk)
    return [("mixed reads", pats, lens),
            ("a search_reads chunk, uint8",
             codes[np.add.outer(starts, np.arange(50))],
             np.full((chunk,), 50, np.int32))]


HUNT_CASES = (("mixed reads", 20), ("mixed reads", 12),
              ("a search_reads chunk, uint8", 20))


def anchor_chains(seed=0, bits=25, nmixed=1 << 16, chunk=1 << 15,
                  widths=ANCHOR_WIDTHS, latency_us=0.4129):
    """The anchor hunt's chains counted on the CPU, before any kernel: a
    2^``bits``-base genome (sa_rate 4) from ``seed``, phase 7's mixed reads
    (min_anchor 20 and 12) and search_reads chunk (20), forward and
    reversed, at each tile width (:func:`hunt_chains`).  Prints one JSON
    line a case and direction, with each width's chain beside the time it
    takes at ``latency_us`` a load (PERF.md's K3 measure).

        python3 -c 'import chip_smoke; chip_smoke.anchor_chains()'

    About 25 minutes on eight CPU threads, most of it the mixed reads'
    forward hunts; ``nmixed`` / ``chunk`` cut it."""
    import numpy as np
    import torch

    import bwt_tpu_torch
    from bwt_tpu_torch.models import exact

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=1 << bits).astype(np.uint8)
    t0 = time.perf_counter()
    fmi = bwt_tpu_torch.build_index(codes, sa_sample_rate=4, device="cpu")
    print(f"index on the CPU in {time.perf_counter() - t0:.1f} s", flush=True)
    inputs = {name: (torch.from_numpy(p).to(torch.int32),
                     torch.from_numpy(ln))
              for name, p, ln in hunt_inputs(rng, codes, nmixed, chunk)}
    for name, min_anchor in HUNT_CASES:
        p, ln = inputs[name]
        for reverse in (False, True):
            t0 = time.perf_counter()
            flipped = exact._plain_reverse(p, ln) if reverse else p
            chains, _ = hunt_chains(fmi, flipped, ln, min_anchor, widths)
            for c in chains.values():
                c["warp_ms"] = c["warp"][1] * latency_us / 1e3
            print(json.dumps(dict(
                case=name, min_anchor=min_anchor, reverse=reverse,
                n=int(ln.shape[0]), chains=chains,
                s=round(time.perf_counter() - t0, 1))), flush=True)


# --------------------------------------------------------------------------
# Part A of the K5 and K11a redesigns: the work each schedule issues, counted
# from the plain versions before any kernel.
#
# K5 (the k-mer seed table): a state after t characters is shared by every
# key that agrees in its first t characters, so a thread a key repeats each
# parent's row loads for all 4^(k-1-t) keys below it.  seed_loads counts the
# bucket rows each schedule loads (a step loads one where both ends of its
# interval lie in one bucket, two otherwise: fm::lf_step), from the states of
# every level.
#
# K11a (phase B's log stitch): a bucket pads its jobs to one shape, and the
# jobs fill a small part of it.  dp_slots counts, for each form, the cell
# slots its warps issue (a warp issues for all 32 lanes, whether a lane's
# cell lies in a job or not), the longest chain of dependent steps a warp
# waits on, the walk and the block entries.
# --------------------------------------------------------------------------


def seed_loads(fmi, k: int, fused: int = 3) -> dict:
    """K5's bucket-row loads, and the bytes they and the table move, at
    ``k`` under three schedules, from the states of levels 0..k-2 (the plain
    build's ``_seed_children``):

      per_key   a thread a key, its k - 1 steps while alive (the kernel's
                first form);
      level     a launch a level: every live parent loaded once, each level's
                rows written and read back by the next launch;
      subtree   the keys below 4^P key by key (P = k - ``fused``, at least
                1), then a thread expands its state's ``fused`` levels in
                registers and writes only the table's rows.

    A load is one 32-byte bucket row (``sector_bytes`` of L2 traffic);
    ``written`` and ``read`` are the table rows' bytes through DRAM;
    ``parents`` the live states of levels 0..k-2, each of which the level
    order ranks once."""
    import torch

    from bwt_tpu_torch.ops import rank as rank_ops
    from bwt_tpu_torch.ops import search

    P = max(k - fused, 1)
    per_key = level = subtree = parents = 0
    states = search._seed_rows_plain(fmi, 1)
    for t in range(k - 1):  # the parents of level t + 1
        start, end, alive = states[:, 0], states[:, 1], states[:, 5] != 0
        ia = rank_ops._adjust(fmi.endloc, start) >> 6
        ib = rank_ops._adjust(fmi.endloc, end) >> 6
        rows = torch.where(alive, 1 + (ia != ib).long(), 0)
        parents += int(alive.sum())
        n = int(rows.sum())
        per_key += n * 4 ** (k - 1 - t)
        level += n
        subtree += n * 4 ** (P - 1 - t) if t < P - 1 else n
        if t < k - 2:
            states = search._seed_children(fmi, states).reshape(-1, 6)
    row = 24
    table = row * 4 ** k
    between = sum(4 ** (t + 1) for t in range(k - 1))  # levels 0..k-2
    return dict(
        k=k, fused=fused, prefix=P, parents=parents,
        per_key=dict(loads=per_key, sector_bytes=32 * per_key,
                     written=table, read=0, launches=1),
        level=dict(loads=level, sector_bytes=32 * level,
                   written=table + row * between, read=row * between,
                   launches=1 + sum(1 for t in range(k) if 4 ** (t + 1) > 4096)),
        subtree=dict(loads=subtree, sector_bytes=32 * subtree,
                     written=table, read=0, launches=1))


def _per_warp(x, jobs_per_warp: int):
    """The largest of each warp's ``jobs_per_warp`` consecutive values."""
    import torch

    n = -(-x.shape[0] // jobs_per_warp) * jobs_per_warp
    pad = torch.zeros(n, dtype=x.dtype)
    pad[:x.shape[0]] = x
    return pad.view(-1, jobs_per_warp).amax(1)


def dp_slots(i0, jmax, walk, bl, flip, L1: int, L2: int, runs: int = 40,
             strip: int = 4, thread_cells: int = 128) -> dict:
    """K11a's work on one bucket of (L1, L2) jobs, in the order given
    ((J,) int64 CPU tensors: i0 = clamp(rlen, 0, L1), jmax = min(glen,
    L2), the walk's steps, the block's length and the Cigar flip), under
    each candidate form:

      warp     a warp a job (the first form, a stripe for row 0 too): 32
               lanes x stripes of rows x the
               diagonals 0..i0 + jmax; chain: the diagonals (each three
               shuffles and a cell);
      thread   a thread a job, the cells one after the other; a warp runs
               as long as its largest job; in the order given and sorted by
               cells (``_sorted``);
      strip    a thread a job sweeping ``strip`` rows side by side, each a
               column behind the one above: ceil(i0 / strip) strips of
               jmax + strip - 1 steps, ``strip`` cell slots a step, plus row
               0's jmax + 1 border cells; chain: the steps;
      tile4/8  a tile of 4 or 8 lanes a job, the job's own rows striped over
               the tile, swept by diagonals: chain the diagonals (each a
               shuffle and a cell);
      warp1    the package's: the warp form without a stripe for row 0
               (its cells are borders, which no walk reads), stripes of rows
               1..L1;
      split    jobs of more than ``thread_cells`` cells in warp1, the rest
               in strip, in the order given (largest first, the order that
               keeps a warp of threads' jobs of a size).

    ``slots`` are the cell slots the warps issue (32 a warp-step), ``chain``
    the longest chain of dependent steps of one warp, ``walk_chain`` the
    longest walk a warp waits on and ``walk_issued`` the walk steps its
    warps issue; ``entries`` the block entries written and ``read_back``
    those read back from device memory (the first warp form flips a block in
    place; the new forms write each entry once)."""
    import torch

    ok = jmax >= 0
    cells = torch.where(ok, (i0 + 1) * (jmax + 1), 0)
    diags = torch.where(ok, i0 + jmax + 1, 0)
    J = i0.shape[0]
    swaps = torch.where(flip, 2 * (bl // 2), 0)
    q = (torch.quantile(cells[ok].double(), torch.tensor([0.5, 0.9],
                                                         dtype=torch.float64))
         if bool(ok.any()) else torch.zeros(2))
    out = dict(L1=L1, L2=L2, jobs=J, cells=int(cells.sum()),
               cells_median=float(q[0]), cells_p90=float(q[1]),
               cells_max=int(cells.max()) if J else 0,
               jobs_over_128=int((cells > 128).sum()),
               cells_over_128=int(cells[cells > 128].sum()),
               walk_steps=int(walk.sum()))
    stripes = 2 if L1 + 1 <= 64 else 4
    out["warp"] = dict(
        warps=J, slots=32 * stripes * int(diags.sum()),
        chain=int(diags.max()) if J else 0,
        walk_chain=int(walk.max()) if J else 0,
        walk_issued=int(walk.sum()),
        entries=J * (runs + 2) + int(swaps.sum()),
        read_back=int(swaps.sum()))
    stripes1 = -(-L1 // 32)
    out["warp1"] = dict(
        warps=J, slots=32 * stripes1 * int(diags.sum()),
        chain=int(diags.max()) if J else 0,
        walk_chain=int(walk.max()) if J else 0,
        walk_issued=int(walk.sum()), entries=J * (runs + 2), read_back=0)
    strips = -(-i0 // strip)
    steps = torch.where(ok & (i0 >= 1) & (jmax >= 1),
                        strips * (jmax + strip - 1), 0)
    strip_slots = torch.where(ok, jmax + 1, 0) + strip * steps
    big = cells > thread_cells
    small = ~big
    nsmall = int(small.sum())
    sw = _per_warp(strip_slots[small], 32) if nsmall else strip_slots[:0]
    out["split"] = dict(
        warps=int(big.sum()) + -(-nsmall // 32), big=int(big.sum()),
        slots=32 * stripes1 * int(diags[big].sum()) + 32 * int(sw.sum()),
        chain=max(int(diags[big].max()) if big.any() else 0,
                  int(_per_warp(steps[small], 32).max()) if nsmall else 0),
        walk_chain=int(walk.max()) if J else 0,
        walk_issued=int(walk[big].sum())
        + (32 * int(_per_warp(walk[small], 32).sum()) if nsmall else 0),
        entries=J * (runs + 2), read_back=0)
    order = torch.argsort(cells, descending=True, stable=True)
    for key, idx in (("", None), ("_sorted", order)):
        def w(x, per=32):
            return _per_warp(x if idx is None else x[idx], per)
        out["thread" + key] = dict(
            warps=-(-J // 32), slots=32 * int(w(cells).sum()),
            chain=int(w(cells).max()) if J else 0,
            walk_chain=int(w(walk).max()) if J else 0,
            walk_issued=32 * int(w(walk).sum()),
            entries=J * (runs + 2), read_back=0)
        out["strip" + key] = dict(
            warps=-(-J // 32), slots=32 * int(w(strip_slots).sum()),
            chain=int(w(steps).max()) if J else 0,
            walk_chain=int(w(walk).max()) if J else 0,
            walk_issued=32 * int(w(walk).sum()),
            entries=J * (runs + 2), read_back=0)
        for T in (4, 8):
            per = 32 // T
            work = torch.where(ok, -(-(i0 + 1) // T) * diags, 0)
            out[f"tile{T}{key}"] = dict(
                warps=-(-J // per), slots=32 * int(w(work, per).sum()),
                chain=int(w(diags, per).max()) if J else 0,
                walk_chain=int(w(walk, per).max()) if J else 0,
                walk_issued=32 * int(w(walk, per).sum()),
                entries=J * (runs + 2), read_back=0)
    return out


def log_buckets(log, Lb: int):
    """Phase B's non-empty DP buckets of one chunk's packed K10 output, as
    the device engine forms them: (L1, L2, jk, jt) each, the jobs in the
    order ``_job_bucket_sort`` gives."""
    import numpy as np

    from bwt_tpu_torch.models import aligner
    from bwt_tpu_torch.ops import automaton as au

    v = au.align_unpack(log)
    G = aligner._DP_GRAN
    NL2 = -(-(Lb + 10) // G)
    order, counts = aligner._job_bucket_sort(
        v["mode"], v["lp"], v["ovf"], v["kinds"], v["rlens"], v["glens"],
        NB=-(-Lb // G) * NL2, NL2=NL2)
    counts = counts.cpu().numpy()
    offs = np.concatenate([[0], np.cumsum(counts)])
    for b in np.nonzero(counts)[0].tolist():
        l1, l2 = divmod(b, NL2)
        jk, jt = aligner._bucket_ids(order, int(offs[b]), int(counts[b]))
        yield G * (l1 + 1), G * (l2 + 1), jk, jt


def bucket_slots(log, bank, genome, jk, jt, L1: int, L2: int) -> dict:
    """:func:`dp_slots` of one bucket, its walks and blocks from the plain
    stitch (``dp_stitch_plain``, ``dp_blocks``) on the log's device."""
    from bwt_tpu_torch.ops import dp_wavefront as dw

    fields, is_sw = dw._log_jobs(log, jk, jt)
    P, ops = dw.dp_stitch_plain(bank, genome, *fields, L1=L1, L2=L2)
    bl = dw.dp_blocks(*dw.unpack(P), ~is_sw)[2]
    return dp_slots(fields[2].long().clamp(0, L1).cpu(),
                    fields[5].long().clamp(max=L2).cpu(),
                    (ops != 3).sum(1).cpu(), bl.long().cpu(),
                    (~is_sw).cpu(), L1, L2, runs=dw.RLE_R)


def cpu_slots(seed=0, bits=25, nsub=1 << 15, nindel=4096):
    """Part A of the K5 and K11a redesigns on the CPU, before any kernel:
    the 2^``bits``-base genome and index of phases 3-4 (from ``seed``),
    K5's loads at k = 12 under each schedule (:func:`seed_loads`), then a
    chunk of ``nsub`` substitution reads and one of ``nindel`` indel reads
    (phase 5's kinds) through the plain aligner automaton, and every
    bucket of their logs through :func:`bucket_slots`.  One JSON line a
    table and a bucket.

        python3 -c 'import chip_smoke; chip_smoke.cpu_slots()'

    About 6 GiB and 10 minutes on the CPU."""
    import numpy as np
    import torch

    import bwt_tpu_torch
    from bwt_tpu_torch.models.batch_exec import QueryService
    from bwt_tpu_torch.ops import automaton as au

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=1 << bits).astype(np.uint8)
    t0 = time.perf_counter()
    fmi = bwt_tpu_torch.build_index(codes, sa_sample_rate=4, device="cpu")
    print(json.dumps(dict(seed_rows=seed_loads(fmi, SEED_K),
                          s=round(time.perf_counter() - t0, 1))), flush=True)
    svc = QueryService(fmi, codes)
    table = svc.seed
    _, sub = mutated_reads(rng, codes, nsub)
    _, ind = indel_reads(rng, codes, nindel)
    for what, reads in (("subst", sub), ("indel", ind)):
        t0 = time.perf_counter()
        chunk = QueryService(fmi, svc.genome_dev, svc.config)
        chunk.add_reads_batch(reads, with_revcomp=True)
        bank8 = chunk.bank8
        Bp = bank8.shape[0] // 2
        lens = np.zeros(Bp, np.int32)
        lens[:len(reads)] = [len(r) for r in reads]
        log = au.align_automaton_packed(
            fmi, bank8, torch.from_numpy(lens), torch.arange(Bp) < len(reads),
            fmi.length, table.rows, anchor_len=svc.config.anchor_len,
            resolve=chunk._has_n, seed_k=table.k)
        for L1, L2, jk, jt in log_buckets(log, bank8.shape[1]):
            line = bucket_slots(log, chunk.bank, chunk.genome_dev, jk, jt,
                                L1, L2)
            print(json.dumps(dict(reads=what, n=len(reads), **line,
                                  s=round(time.perf_counter() - t0, 1))),
                  flush=True)


# --------------------------------------------------------------------------
# Part A of the K7 and K11b redesigns, counted from the plain versions
# before any kernel.
#
# K7 (the executor's service round) runs one request a lane, and a round of
# the host engines holds up to 2^19 lanes in arrival order.  A lane's chain
# of dependent loads is its search steps, its walk and its window scan
# (lane_loads); a warp runs the three phases one after another, each until
# its longest lane is done.  With a tile of T threads a lane
# (svc::TileSplit) the search and the walk stay whole on every thread of
# the tile, and the window is cut into T slices that chain side by side, so
# a warp holds 32 / T lanes.  service_chains counts, for each T, each
# warp's chain and the loads the round issues.
#
# K11b (the compose): a read's log rows (kinds, glens, bl3) are 64 bytes
# apart across a warp, and its output row 48 bytes; compose_sectors counts
# the 32-byte sectors a warp's loads and stores touch, one a lane where
# the lanes' words lie in distinct sectors, against a warp that stages its
# 32 reads' rows in shared memory with coalesced loads and stores its 32
# output rows as 1,536 contiguous bytes.
# --------------------------------------------------------------------------


def service_chains(fmi, fields, cols, *, ext: bool, walk: bool,
                   seed_k: int = 0, tiles=(1, 4, 8)) -> dict:
    """Part A of K7 for one service round from its own results: per lane
    its search, walk and window loads (:func:`lane_loads`, the walk only
    where the round walks, the window only in an ``ext`` round), and for
    each tile width T the warps' chains (32 / T lanes a warp, the window of
    every ``_ext`` lane in T slices; a warp runs its lanes' searches, then
    their walks, then their windows, each as long as its longest lane) and
    the loads the round issues (a tile's threads each run the search and
    the walk)."""
    import numpy as np
    import torch

    from bwt_tpu_torch.ops import service as sv

    opc, _, _, ln, sp, ep, _ = fields
    parts = lane_loads(fmi, fields, cols, seed_k=seed_k).cpu()
    if not walk:
        parts[1] = 0
    live = (opc != sv.OP_NONE).cpu()
    m_ext, b_ext = opc == sv.OP_MEXT, opc == sv.OP_BEXT
    wlo = torch.where(m_ext, sp - cols[sv.MMS_M] - (ep + 3), sp)
    wwid = torch.where(m_ext, 2 * (ep + 3) + 1, ep).clamp(0, sv.W)
    wwid = torch.where((m_ext | b_ext) & ext, wwid, 0)
    # a scan runs only on a live interval (service_lane.cuh)
    ilo = torch.where(m_ext, cols[sv.OSP], cols[sv.START])
    ihi = torch.where(m_ext, cols[sv.OEP], cols[sv.END])
    wwid = torch.where(ilo < ihi, wwid, 0)
    B = opc.shape[0]
    parts[2] = window_slices(fmi, wlo, wwid, 1)[0].cpu()
    out = dict(B=B, live=int(live.sum()), ext=ext, walk=walk,
               search=int(parts[0].sum()), walk_loads=int(parts[1].sum()),
               window=int(parts[2].sum()),
               lane_longest=[int(parts[k].max()) if B else 0
                             for k in range(3)])
    by_tile = {}
    for T in tiles:
        best, total = (x.cpu() for x in window_slices(fmi, wlo, wwid, T))
        per = 32 // T
        nw = -(-B // per)

        def warp_max(x):
            pad = torch.zeros(nw * per, dtype=torch.int64)
            pad[:B] = x
            return pad.view(nw, per).amax(1)

        # a warp runs the searches, then the walks, then the windows, each
        # until its longest lane is done
        warps = warp_max(parts[0]) + warp_max(parts[1]) + warp_max(best)
        live_w = torch.zeros(nw * per, dtype=torch.bool)
        live_w[:B] = live
        warps = warps[live_w.view(nw, per).any(1)]
        q = (np.percentile(warps.numpy(), [50, 90, 99]).tolist()
             if warps.numel() else [0, 0, 0])
        by_tile[T] = dict(
            warps=int(warps.numel()),
            longest=int(warps.max()) if warps.numel() else 0,
            mean=float(warps.float().mean()) if warps.numel() else 0.0,
            p50_p90_p99=q,
            window_longest=int(best.max()) if B else 0,
            issued=int(T * (parts[0].sum() + parts[1].sum()) + total.sum()))
    out["tiles"] = by_tile
    return out


def compose_sectors(log, acc) -> dict:
    """Part A of K11b for one chunk: the 32-byte sectors its warps' loads
    and stores touch in the kernel's first layout (a thread a read, its
    rows read slot by slot, its output row written word by word) and in a
    warp-staged one (the warp's kinds, glens and bl3 rows and its output
    rows as contiguous spans); the stream entries each form reads from the
    blocks are the same.  Also the unique sectors of the data each form
    needs, which is what DRAM or L2 must deliver at least once."""
    import torch

    from bwt_tpu_torch.ops import automaton as au
    from bwt_tpu_torch.ops import compose as cmp
    from bwt_tpu_torch.ops import dp_wavefront as dw

    v = au.align_unpack(log)
    _, bl3, _, _ = dw.acc_unpack(acc)
    Bp = v["lp"].shape[0]
    n = v["lp"].clamp(0, au.LOGN).to(torch.int64)
    slot = torch.arange(au.LOGN, device=n.device)[None, :]
    vm = slot < n[:, None]
    single = vm & ((v["kinds"] == au.K_M) | (v["kinds"] == au.K_I))
    stitch = vm & ~single
    bl = torch.where(single, 1, torch.where(vm, bl3, 0)).to(torch.int64)
    offs = torch.cumsum(bl, 1) - bl
    # the entries a stitch slot reads: those of the stream's first F2
    read = torch.where(stitch, (cmp.F2 - offs).clamp(min=0).minimum(bl), 0)
    entries = int(read.sum()) + int(torch.where(
        single & (offs < cmp.F2), 1, 0).sum())
    _, _, nrun, _, _ = cmp.compose_runs_plain(
        v["kinds"], v["glens"], v["lp"], v["mode"], v["curpos"],
        torch.zeros_like(v["lp"]), dw.acc_unpack(acc)[0], bl3)
    flushed = nrun.to(torch.int64).clamp(max=min(cmp.RUNS_K, 8))
    warps = -(-Bp // 32)
    first = dict(
        scalars=8 * 4 * warps,
        kinds=int(n.sum()), glens=int(single.sum()), bl3=int(stitch.sum()),
        runs=int(read.sum()),
        stores=int((8 + 4 + flushed).sum()))
    staged = dict(
        scalars=8 * 4 * warps, kinds=64 * warps, glens=64 * warps,
        bl3=64 * warps, runs=int(read.sum()), stores=48 * warps)
    # the merge's steps a read (the slots it walks and the entries it
    # merges, one after another on its thread), and a warp's longest
    steps = (n + read.sum(1) + torch.where(single & (offs < cmp.F2), 1, 0)
             .sum(1)).cpu()
    pad = torch.zeros(warps * 32, dtype=torch.int64)
    pad[:Bp] = steps
    return dict(Bp=Bp, warps=warps, stream_entries=entries,
                merge_steps=dict(mean=float(steps.float().mean()),
                                 warp_longest_mean=float(
                                     pad.view(warps, 32).amax(1).float()
                                     .mean()),
                                 longest=int(steps.max())),
                first=dict(first, total=sum(first.values())),
                staged=dict(staged, total=sum(staged.values())),
                unique_bytes=Bp * (8 * 4 + 3 * 64 + 48) + 32 * int(
                    (read > 0).sum()))


def cpu_rounds(seed=0, bits=25, nsub=1 << 16, nindel=4096, nrna=1 << 16,
               nlanes=1 << 13, nchunk=1 << 15):
    """Part A of the K7 and K11b redesigns on the CPU, before any kernel:
    the 2^``bits``-base genome and index of phases 3-4 (from ``seed``); every
    service round of the host engines, recorded as phase 5 and phase 10 run
    them (single_align on ``nsub`` substitution and ``nindel`` indel reads,
    rna_seq on ``nrna`` complemented reads), and phase 7's five fuzzed
    rounds of ``nlanes`` lanes, each through :func:`service_chains`; then a
    chunk of ``nchunk`` substitution reads through the plain aligner
    automaton and log stitch, and :func:`compose_sectors` on its compose.
    One JSON line a round and one for the compose.

        python3 -c 'import chip_smoke; chip_smoke.cpu_rounds()'

    About 5 GiB and 15 minutes on the CPU."""
    import numpy as np
    import torch

    import bwt_tpu_torch
    from bwt_tpu_torch.models import aligner, rnaseq
    from bwt_tpu_torch.models.batch_exec import QueryService
    from bwt_tpu_torch.ops import automaton as au
    from bwt_tpu_torch.ops import dp_wavefront as dw
    from bwt_tpu_torch.ops import search
    from bwt_tpu_torch.ops import service as sv

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=1 << bits).astype(np.uint8)
    t0 = time.perf_counter()
    fmi = bwt_tpu_torch.build_index(codes, sa_sample_rate=4, device="cpu")
    print(f"index on the CPU in {time.perf_counter() - t0:.1f} s", flush=True)

    def emit(driver, k, bank, fields, out, kw):
        B = fields[0].shape[0]
        cols = out[:-2].view(sv.NCOLS, B)
        line = service_chains(fmi, fields, cols, ext=kw.get("ext", False),
                              walk=kw.get("walk", True),
                              seed_k=kw.get("seed_k", 0))
        print(json.dumps(dict(driver=driver, round=k, Lb=bank.shape[1],
                              resolve=kw.get("resolve"), **line)), flush=True)

    launch = sv.service_round_packed
    for driver, run in (
            ("single_align subst", lambda: aligner.align_reads(
                fmi, codes, mutated_reads(rng, codes, nsub)[1],
                engine="host", with_strand=True)),
            ("single_align indel", lambda: aligner.align_reads(
                fmi, codes, indel_reads(rng, codes, nindel)[1],
                engine="host", with_strand=True)),
            ("rna_seq", lambda: rnaseq.rna_seq(
                fmi, complemented_reads(rng, codes, nrna)[1],
                engine="host"))):
        rounds = []

        def recording(fmi_, bank, *fields, **kw):
            out = launch(fmi_, bank, *fields, **kw)
            rounds.append((bank, fields, out, kw))
            return out

        sv.service_round_packed = recording
        t0 = time.perf_counter()
        try:
            run()
        finally:
            sv.service_round_packed = launch
        print(f"{driver}: {len(rounds)} service rounds in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for k, (bank, fields, out, kw) in enumerate(rounds):
            emit(driver, k, bank, fields, out, kw)
        del rounds

    table = search.build_seed_table(fmi, k=SEED_K)
    for k, (resolve, ext, seeded) in enumerate((
            (False, False, False), (True, False, False), (True, True, False),
            (True, True, True), (False, True, True))):
        bank_np, f_np = service_lanes(rng, codes, nlanes, with_n=resolve)
        bank = torch.from_numpy(bank_np)
        fields = tuple(torch.from_numpy(f_np).unbind(0))
        kw = dict(resolve=resolve, ext=ext, walk=True)
        if seeded:
            kw.update(seed_rows=table.rows, seed_k=table.k)
        out = launch(fmi, bank, *fields, **kw)
        emit("fuzzed", k, bank, fields, out, kw)
    del table

    svc = QueryService(fmi, codes)
    chunk = QueryService(fmi, svc.genome_dev, svc.config)
    reads = mutated_reads(rng, codes, nchunk)[1]
    chunk.add_reads_batch(reads, with_revcomp=True)
    bank8 = chunk.bank8
    Bp = bank8.shape[0] // 2
    lens = np.zeros(Bp, np.int32)
    lens[:len(reads)] = [len(r) for r in reads]
    seedt = svc.seed
    log = au.align_automaton_packed(
        fmi, bank8, torch.from_numpy(lens), torch.arange(Bp) < len(reads),
        fmi.length, seedt.rows, anchor_len=svc.config.anchor_len,
        resolve=chunk._has_n, seed_k=seedt.k)
    acc = dw.log_acc(Bp, torch.device("cpu"))
    for L1, L2, jk, jt in log_buckets(log, bank8.shape[1]):
        dw.dp_log_stitch(log, chunk.bank, chunk.genome_dev, jk, jt, acc,
                         L1=L1, L2=L2)
    print(json.dumps(dict(compose=compose_sectors(log, acc))), flush=True)


def registers_of(fragment: str, report: str | None = None) -> list[int]:
    """The registers of each compiled kernel whose name holds ``fragment``,
    from a compiler report (phase 1's by default)."""
    from bwt_tpu_torch.ops import _kernels

    found = re.findall(r"Compiling entry function '(\S+)' for 'sm_90a'\n"
                       r"(?:.*\n){0,3}?.*Used (\d+) registers",
                       _kernels.LAST_REPORT if report is None else report)
    return sorted(int(r) for name, r in found if fragment in name)


def anchor_registers(report: str | None = None, wide: bool = False) -> dict:
    """The registers of each instantiation of the anchor hunt's kernel for
    the int32 index (the wide index's with ``wide``), keyed "tile T, int32
    / uint8 / int8, replicated / tp", from a compiler report (phase 1's by
    default)."""
    from bwt_tpu_torch.ops import _kernels

    found = re.findall(r"Compiling entry function '\S*anchor_scan_kernelILi"
                       r"(\d+)E([iha])Lb([01])ELb([01])E\S*' for 'sm_90a'\n"
                       r"(?:.*\n){0,3}?.*Used (\d+) registers",
                       _kernels.LAST_REPORT if report is None else report)
    code = {"i": "int32", "h": "uint8", "a": "int8"}
    return {f"tile {T}, {code[c]}, {('replicated', 'tp')[int(tp)]}": int(r)
            for T, c, tp, w, r in sorted(found, key=lambda f: (int(f[0]),
                                                                f[2], f[1]))
            if w == str(int(wide))}


# the kernels with a tp form, by the name their entry function carries
TP_ENTRIES = (("K3", "backward_search_kernel"), ("K4", "unc_sa_kernel"),
              ("locate", "locate_kernel"), ("anchor_scan", "anchor_scan_kernel"),
              ("K5", "seed_rows_kernel"), ("K6", "isa_window_kernel"),
              ("K7", "service_kernel"), ("K9", "rnaseq_automaton_kernel"),
              ("K10", "align_automaton_kernel"))


def _forms(report: str | None = None):
    """(kernel, kTp, kWide, registers) for each instantiation of the
    kernels of TP_ENTRIES in a compiler report (phase 1's by default),
    the forms read from the entry function's mangled name: ``kTp`` is the
    last template argument, or for the kernels of WIDE_KERNELS the one
    before ``kWide``."""
    from bwt_tpu_torch.ops import _kernels

    found = re.findall(r"Compiling entry function '(\S+)' for 'sm_90a'\n"
                       r"(?:.*\n){0,3}?.*Used (\d+) registers",
                       _kernels.LAST_REPORT if report is None else report)
    for key, entry in TP_ENTRIES:
        for name, r in found:
            m = re.search(rf"\d{entry}I.*?E+v", name)
            if m:
                flags = re.findall(r"Lb([01])E", m.group(0))
                wide = key in WIDE_KERNELS and flags[-1] == "1"
                tp = flags[-2 if key in WIDE_KERNELS else -1] == "1"
                yield key, tp, wide, int(r)


def registers_by_form(report: str | None = None) -> dict:
    """{kernel: (registers of its replicated instantiations, of its tp
    ones)} for the int32 index's instantiations of the kernels of
    TP_ENTRIES (:func:`_forms`)."""
    out = {key: ([], []) for key, _ in TP_ENTRIES}
    for key, tp, wide, r in _forms(report):
        if not wide:
            out[key][tp].append(r)
    return {k: (sorted(a), sorted(b)) for k, (a, b) in out.items()}


def registers_wide(report: str | None = None) -> dict:
    """{kernel: (registers of its int32 instantiations, of its wide ones)},
    replicated and tp forms together, for the kernels of WIDE_KERNELS
    (:func:`_forms`)."""
    out = {key: ([], []) for key in WIDE_KERNELS}
    for key, _, wide, r in _forms(report):
        if key in out:
            out[key][wide].append(r)
    return {k: (sorted(a), sorted(b)) for k, (a, b) in out.items()}


# The automatons K10 and K9 at other tiles than the package's
# (svc::kAutomatonTile), the service kernel K7 with each of its choices
# turned off, and the anchor hunt at every tile in both directions, built
# apart to be timed beside the package: the package builds
# one form of each, and these builds are never on its path.
AUTOMATON_SOURCES = ("align_automaton.cu", "rnaseq_automaton.cu")
AUTOMATON_LAUNCHERS = ("align_automaton_launch", "rnaseq_automaton_launch")
OTHER_TILES = (1, 8)
SERVICE_LAUNCHERS = ("service_launch",)
# name: the define of csrc/service.cu that makes the form
SERVICE_FORMS = {
    "tile 1": "-DBWT_SERVICE_TILE=1",        # a thread a lane on every round
    "tile 4": "-DBWT_SERVICE_TILE=4",        # four threads a lane on every one
}
ANCHOR_LAUNCHERS = ("anchor_scan_launch",)
# name: the defines of csrc/anchor_scan.cu that make the form
# (phase 7 times the int32 index's forms alone: BWT_ANCHOR_INT32_ONLY
# leaves out the wide ones, half of the source's compile)
ANCHOR_FORMS = {f"tile {T}": (f"-DBWT_ANCHOR_TILE_FWD={T}",
                              f"-DBWT_ANCHOR_TILE_REV={T}",
                              "-DBWT_ANCHOR_INT32_ONLY")
                for T in ANCHOR_WIDTHS}


def start_tile_builds(tiles=OTHER_TILES, forms=SERVICE_FORMS,
                      anchor_forms=ANCHOR_FORMS) -> dict:
    """Start one ``nvcc`` a build, together: the two automatons' sources at
    each tile (``-DBWT_AUTOMATON_TILE``, keyed by the tile), the service
    kernel's source in each form (keyed by its name) and the anchor hunt's
    in each of ``anchor_forms`` (keyed by ("anchor", its name)), each into
    a library of its launchers under ``build/tile_variants/``."""
    from bwt_tpu_torch.ops import _kernels

    out_dir = _kernels.BUILD_DIR.parent / "tile_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _kernels._nvcc()
    stem = _kernels.library_path().stem
    specs = {T: (f"tile{T}", (f"-DBWT_AUTOMATON_TILE={T}",),
                 AUTOMATON_SOURCES) for T in tiles}
    specs.update({name: ("svc_" + re.sub(r"\W", "", name), (define,),
                         ("service.cu",)) for name, define in forms.items()})
    specs.update({("anchor", name): ("anchor_" + re.sub(r"\W", "", name),
                                     defines, ("anchor_scan.cu",))
                  for name, defines in anchor_forms.items()})
    started = {}
    for key, (suffix, defines, sources) in specs.items():
        path = out_dir / f"{stem}_{suffix}.so"
        cmd = [nvcc, *_kernels.NVCC_FLAGS, *defines, "-Xptxas", "-v",
               "-shared", "-o", str(path),
               *(str(_kernels.CSRC / f) for f in sources)]
        started[key] = (path, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return started


def finish_tile_builds(started) -> tuple[dict, dict, dict]:
    """Wait for :func:`start_tile_builds`: ({tile: (library, the compiler's
    report)}, {service form: (library, report)}, {anchor form: (library,
    report)}); a failed build, a stack frame or a spill fails the run."""
    import ctypes

    from bwt_tpu_torch.ops import _kernels

    base = _kernels.library()
    tiles, forms, anchors = {}, {}, {}
    for key, (path, cmd, proc) in started.items():
        so, se = proc.communicate()
        require(proc.returncode == 0, f"nvcc failed on the build {key!r}:\n"
                                      f"{' '.join(cmd)}\n{so}{se}")
        frames = _frames(se)
        require(frames and all(f == ("0", "0") for f in frames),
                f"the build {key!r} keeps values in local memory: {frames}")
        lib = ctypes.CDLL(str(path))
        kind, launchers = (
            (anchors, ANCHOR_LAUNCHERS) if isinstance(key, tuple) else
            (forms, SERVICE_LAUNCHERS) if isinstance(key, str) else
            (tiles, AUTOMATON_LAUNCHERS))
        for name in launchers:
            fn = getattr(lib, name)
            fn.argtypes = getattr(base, name).argtypes
            fn.restype = ctypes.c_int
        kind[key[1] if isinstance(key, tuple) else key] = (lib, se)
    return tiles, forms, anchors


@contextlib.contextmanager
def automaton_tile(lib, launchers=AUTOMATON_LAUNCHERS):
    """The wrappers of ``launchers`` (the automatons' by default) launch
    from ``lib`` (a library of :func:`finish_tile_builds`; None: the
    package's own) inside the block."""
    from bwt_tpu_torch.ops import _kernels

    if lib is None:
        yield
        return
    base = _kernels.library()

    class Shim:
        def __getattr__(self, name):
            return getattr(lib if name in launchers else base, name)

    _kernels._lib = Shim()
    try:
        yield
    finally:
        _kernels._lib = base


def time_by_tile(run, want, tiles, what: str) -> tuple[dict, dict, int]:
    """The automaton ``run()`` (its packed output) at the package's tile
    and each of ``tiles`` ({tile: (library, report)}), each bit-equal to
    ``want``: ({tile: ms}, {tile: registers}, the largest |difference|)."""
    import torch

    from bwt_tpu_torch.ops import automaton as au

    kernel = ("align_automaton_kernel" if what == "K10"
              else "rnaseq_automaton_kernel")
    ms, regs, err = {}, {}, 0
    for T, (lib, report) in [(au.TILE, (None, None))] + sorted(tiles.items()):
        with automaton_tile(lib):
            got = run()
            err_t = _max_abs_diff([got], [want])
            require(got.shape == want.shape and torch.equal(got, want),
                    f"{what} at tile {T} differs from its plain version: "
                    f"max |d| {err_t}")
            ms[T] = cuda_ms(run, 10, ahead=True)
        err = max(err, err_t)
        regs[T] = registers_of(kernel, report)
    return ms, regs, err


def load_latency(fmi, codes_np, tag, short=64, long=4096) -> float:
    """Phase 7: the latency of one dependent load on the card, in µs, as
    K3 shows it: one thread's backward search of a genome substring, so
    every step matches and the search runs its whole length, each step's
    bucket row waiting for the one before; (time at ``long`` characters -
    time at ``short``) / (long - short) steps."""
    import numpy as np
    import torch

    from bwt_tpu_torch.ops import search

    at = len(codes_np) // 3
    pat = torch.from_numpy(codes_np[at:at + long].astype(np.int32))[None]
    pat = pat.to(fmi.device)
    ms = {}
    for n in (short, long):
        lens = torch.tensor([n], dtype=torch.int32, device=fmi.device)
        r = search.backward_search(fmi, pat, lens)
        require(int(r["nmatched"][0]) == n and bool(r["alive"][0]),
                f"a {n}-base genome substring did not match whole")
        ms[n] = cuda_ms(lambda: search.backward_search(fmi, pat, lens), 20,
                        ahead=True)
    us = (ms[long] - ms[short]) * 1e3 / (long - short)
    print(f"phase 7 load latency: K3, one thread searching a genome "
          f"substring, {ms[short]:.4f} ms at {short} characters, "
          f"{ms[long]:.4f} ms at {long}: {us:.4f} µs a dependent step "
          f"{tag}", flush=True)
    return us


def _chain_text(chains, latency_us) -> str:
    return "; ".join(
        f"T = {T}: longest {c['longest']} ({c['longest'] * latency_us / 1e3:.4f}"
        f" ms at the load latency), mean {c['mean']:.1f}, {c['rounds']} "
        f"rounds" for T, c in chains.items())


def phase_align_kernels(fmi, svc, chunks, tag, latency_us,
                        variants) -> list:
    """Phase 7, the aligner's kernels: K10 on one chunk of phase 5's
    substitution reads and one of its indel reads, K11a on every bucket of
    both chunks' logs and K11b on the substitution chunk's composed lanes,
    each against its plain version on the card, bit-equal, and timed
    beside its bound, K10 also at the tiles of ``variants``
    (:func:`time_by_tile`), K11a also a bucket at a time beside the
    bucket's Part A counts (:func:`bucket_slots`).
    K10's bound counts what the chunk's reads needed, from the plain
    version's rounds, as K9's does; K11a's the cells of each job's own
    matrix and its walk (one operation a step), and its bytes the job's ids
    and fields, its two slices and its block; K11b's its bytes: a read's
    scalars, its log and block rows, the runs its stream reads, and its
    output row."""
    import numpy as np
    import torch

    from bwt_tpu_torch.models.batch_exec import QueryService
    from bwt_tpu_torch.ops import automaton as au
    from bwt_tpu_torch.ops import compose as cmp
    from bwt_tpu_torch.ops import dp_wavefront as dw
    from bwt_tpu_torch.ops import service as sv

    dev = fmi.device
    seed = svc.seed
    rows, logs = [], {}
    for what, reads in chunks:
        chunk = QueryService(fmi, svc.genome_dev, svc.config)
        chunk.add_reads_batch(reads, with_revcomp=True)
        bank = chunk.bank8
        Bp = bank.shape[0] // 2
        lens_np = np.zeros(Bp, np.int32)
        lens_np[:len(reads)] = [len(r) for r in reads]
        args = (fmi, bank, torch.from_numpy(lens_np).to(dev),
                torch.arange(Bp, device=dev) < len(reads), fmi.length,
                seed.rows)
        kw = dict(anchor_len=svc.config.anchor_len, resolve=chunk._has_n,
                  seed_k=seed.k)
        # the kernel, and its builds at the other tiles, against the plain
        # version's lockstep loop; the row is the package's tile's
        want, plain_ms = _event_ms(lambda: au.align_automaton_packed(
            *args, plain=True, **kw))
        tiles, regs, err = time_by_tile(
            lambda: au.align_automaton_packed(*args, **kw), want, variants,
            "K10")
        got = au.align_automaton_packed(*args, **kw)
        au.align_automaton_raise(fmi, got)
        v = au.align_unpack(got)
        require(not bool(v["capped"].any()), "a read reached K10's cap")
        totals = dict(search=0, walk=0, walks=0, window=0, windows=0,
                      seeded=0, rounds=0)

        def on_round(fields, cols, events):
            live = fields[0] != sv.OP_NONE
            w = _round_steps(fmi, bank, [f[live] for f in fields],
                             cols[:, live], ext=True, walk=True,
                             seed_k=seed.k)
            for key in totals:
                totals[key] += w.get(key, 1)

        chains, _ = automaton_chains(
            fmi, *args[1:4], seed, "align", (1, au.TILE, 8),
            on_round=on_round, anchor_len=svc.config.anchor_len,
            resolve=chunk._has_n)
        lf_steps = totals["walk"] + totals["window"]
        nbytes = (bank.numel() + 5 * Bp + 4 * got.numel()
                  + 32 * (totals["seeded"] + totals["windows"])
                  + _index_bytes(fmi, totals["search"], lf_steps,
                                 totals["walks"]))
        bound = bound_of(nbytes, SEARCH_STEP_OPS * totals["search"]
                         + WALK_STEP_OPS * lf_steps)
        ms = tiles[au.TILE]
        iters = v["iters"][:len(reads)]
        longest = int(iters.max())
        hist = np.bincount(iters.cpu().numpy()).tolist()
        row = dict(kernel="align_automaton", case=f"a chunk of phase 5, {what}",
                   shape=f"Bp={Bp} Lb={bank.shape[1]} uint8, k={seed.k} "
                         f"table, tile {au.TILE}",
                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   tiles_ms=tiles, chains=chains, latency_us=latency_us,
                   chain_ms=chains[au.TILE]["longest"] * latency_us / 1e3,
                   rounds=totals["rounds"], search_steps=totals["search"],
                   walk_steps=totals["walk"], window_steps=totals["window"],
                   longest_iters=longest, mean_iters=float(iters.float().mean()),
                   iters_hist=hist, registers=regs, **bound)
        rows.append(row)
        logs[what] = (chunk, got)
        print(f"phase 7 K10 align_automaton on a chunk of {len(reads)} "
              f"{what} reads ({row['shape']}): bit-equal to its plain version "
              f"on the card at every tile (tolerance 0, max |d| {err}; every "
              f"column, the log and the flag), kernel {ms:.4f} ms at tile "
              f"{au.TILE} (by tile: "
              + ", ".join(f"{T}: {t:.4f} ms" for T, t in tiles.items())
              + f"), plain {plain_ms:.4f} ms in {totals['rounds']} lockstep "
              f"rounds, bound {bound['bound_ms']:.4f} ms by "
              f"{bound['bound_by']} ({bound['bytes']} bytes, {bound['ops']} "
              f"operations: {totals['search']} search, {totals['walk']} walk "
              f"and {totals['window']} window steps); the chain of dependent "
              f"loads: {_chain_text(chains, latency_us)}; registers by tile "
              f"{regs}, no stack frame; the longest read ran {longest} "
              f"iterations, the mean {row['mean_iters']:.3f}, by count {hist} "
              f"{tag}", flush=True)

    # K11a on every bucket of each chunk's log, then K11b on the
    # substitution chunk's.  Each bucket is timed beside its Part A counts
    # (bucket_slots)
    for what, _ in reversed(chunks):
        chunk, log = logs[what]
        v = au.align_unpack(log)
        bank, genome = chunk.bank, chunk.genome_dev
        Bp = au.align_lanes(log)
        got, want, scratch = (dw.log_acc(Bp, dev) for _ in range(3))
        ms = plain_ms = 0.0
        jobs = cells = steps = nbytes = 0
        shapes, buckets = [], []
        for L1, L2, jk, jt in log_buckets(log, chunk.bank8.shape[1]):
            dw.dp_log_stitch(log, bank, genome, jk, jt, got, L1=L1, L2=L2)
            _, t = _event_ms(lambda: dw.dp_log_stitch(
                log, bank, genome, jk, jt, want, L1=L1, L2=L2, plain=True))
            plain_ms += t
            t_pkg = cuda_ms(lambda: dw.dp_log_stitch(
                log, bank, genome, jk, jt, scratch, L1=L1, L2=L2), 20,
                ahead=True)
            ms += t_pkg
            slots = bucket_slots(log, bank, genome, jk, jt, L1, L2)
            fields, _ = dw._log_jobs(log, jk, jt)
            i0 = fields[2].long().clamp(0, L1)
            jmax = fields[5].long().clamp(max=L2)
            J = jk.shape[0]
            jobs += J
            cells += slots["cells"]
            steps += slots["walk_steps"]
            nbytes += 4 * (J * (2 + 6 + dw.BLOCK_W + 3) + int(i0.sum())
                           + int(jmax.clamp(min=0).sum()))
            shapes.append(f"{L1}x{L2}: {J}")
            buckets.append(dict(L1=L1, L2=L2, jobs=J, ms=t_pkg, slots=slots))
            print(f"phase 7 K11a bucket {L1}x{L2} of the {what} chunk: {J} "
                  f"jobs, {slots['cells']} cells, {t_pkg:.4f} ms; cell slots "
                  f"issued (longest chain, diagonals): the first warp form "
                  f"{slots['warp']['slots']} ({slots['warp']['chain']}), "
                  f"this one, without a stripe for row 0, "
                  f"{slots['warp1']['slots']} ({slots['warp1']['chain']}); "
                  f"block entries read back: that form's "
                  f"{slots['warp']['read_back']}, this one's 0 {tag}",
                  flush=True)
        err = _max_abs_diff([got], [want])
        require(torch.equal(got, want), f"K11a differs from its plain "
                                        f"version on the buckets of a "
                                        f"{what} chunk: max |d| {err}")
        bound = bound_of(nbytes, DP_CELL_OPS * cells + steps)
        regs = registers_of("LogForm")
        rows.append(dict(kernel="dp_log_stitch", case=f"the buckets of a "
                         f"chunk of phase 5, {what}", shape="; ".join(shapes),
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         jobs=jobs, cells=cells,
                         walk_steps=steps, registers=regs,
                         buckets=buckets, **bound))
        print(f"phase 7 K11a dp_log_stitch on the {len(shapes)} buckets of "
              f"the {what} chunk (jobs by padded shape {shapes}): the "
              f"accumulators bit-equal to the plain version's (tolerance 0, "
              f"max |d| {err}), kernels {ms:.4f} ms in all, plain "
              f"{plain_ms:.4f} ms, "
              f"bound {bound['bound_ms']:.4f} ms by {bound['bound_by']} "
              f"({bound['bytes']} bytes, {bound['ops']} operations: {cells} "
              f"cells, {steps} walk steps); registers of the log form's "
              f"kernels {regs} {tag}", flush=True)

    comp = cmp.compose(log, got)
    want_c, plain_c = _event_ms(lambda: cmp.compose_plain(log, got))
    err = _max_abs_diff([comp], [want_c])
    require(torch.equal(comp, want_c), f"K11b differs from its plain version "
                                       f"on a chunk: max |d| {err}")
    ms_c = cuda_ms(lambda: cmp.compose(log, got), 20, ahead=True)
    bl3 = dw.acc_unpack(got)[1]
    slot = torch.arange(au.LOGN, device=dev)[None, :]
    vm = slot < v["lp"].clamp(max=au.LOGN)[:, None]
    single = vm & ((v["kinds"] == au.K_M) | (v["kinds"] == au.K_I))
    entries = int(torch.where(single, 1, torch.where(vm, bl3, 0)).sum(1)
                  .clamp(max=cmp.F2).sum())
    bound_c = bound_of(Bp * (6 * 4 + 3 * au.LOGN * 4 + 8 + 4 * cmp.OUT_W)
                       + 4 * entries, 0)
    regs = registers_of("compose_kernel")
    sectors = compose_sectors(log, got)
    rows.append(dict(kernel="compose", case="the lanes of a chunk of phase 5, "
                     "subst", shape=f"Bp={Bp}, K={cmp.RUNS_K}",
                     max_abs_err=err, ms=ms_c, plain_ms=plain_c,
                     registers=regs, stream_entries=entries, sectors=sectors,
                     **bound_c))
    print(f"phase 7 K11b compose on the {Bp} lanes of that chunk: bit-equal "
          f"to its plain version (tolerance 0, max |d| {err}), kernel "
          f"{ms_c:.4f} ms ({100 * bound_c['bound_ms'] / ms_c:.1f} % of its "
          f"bound), plain {plain_c:.4f} ms, bound "
          f"{bound_c['bound_ms']:.4f} ms by {bound_c['bound_by']} "
          f"({bound_c['bytes']} bytes, {entries} stream entries read); "
          f"32-byte sector requests of the warps, a thread a read / "
          f"staged by the warp (this kernel): {sectors['first']['total']} / "
          f"{sectors['staged']['total']}; the merge's steps (slots walked "
          f"and entries merged, one after another on a read's thread): "
          f"{sectors['merge_steps']['mean']:.2f} a read, "
          f"{sectors['merge_steps']['warp_longest_mean']:.2f} a warp's "
          f"longest on average, {sectors['merge_steps']['longest']} at most; "
          f"registers {regs} {tag}",
          flush=True)
    return rows


def _automaton_case(fmi, svc, reads, tag, latency_us, variants) -> dict:
    """K9 on one chunk of phase 10's reads against its plain version on the
    card, bit-equal in its whole packed output (res, capped, iterations,
    flag), timed beside its bound, and at the tiles of ``variants``.  The bound counts what the chunk's reads
    needed, from the plain version's rounds: each live read's search steps
    (62 operations), walk and window-chain steps (35) and a 32-byte sector
    for each of its seed rows, window samples and walk samples; bytes: the
    bank, the lengths and live flags and the three output columns once,
    and the index sectors the steps touch."""
    import numpy as np
    import torch

    from bwt_tpu_torch.models.batch_exec import QueryService
    from bwt_tpu_torch.ops import automaton
    from bwt_tpu_torch.ops import service as sv

    cfg, seed = svc.config, svc.seed
    chunk = QueryService(fmi, config=cfg)
    _, rl = chunk.add_reads_batch(reads)
    bank = chunk.bank8
    R = bank.shape[0]
    lens_np = np.zeros(R, np.int32)
    lens_np[:len(rl)] = rl
    lens = torch.from_numpy(lens_np).to(fmi.device)
    live0 = torch.arange(R, device=fmi.device) < len(rl)
    args = (fmi, bank, lens, live0, seed.rows)
    kw = dict(ac=cfg.rnaseq_anchor_cutoff, cc=cfg.rnaseq_cont_cutoff,
              resolve=chunk._has_n, seed_k=seed.k)
    # the kernel, and its builds at the other tiles, against the plain
    # version's lockstep loop; the row is the package's tile's
    want, plain_ms = _event_ms(lambda: automaton.rna_seq_automaton_packed(
        *args, plain=True, **kw))
    tiles, regs, err = time_by_tile(
        lambda: automaton.rna_seq_automaton_packed(*args, **kw), want,
        variants, "K9")
    got = automaton.rna_seq_automaton_packed(*args, **kw)
    automaton.automaton_raise(fmi, got)
    _, capped, iters = automaton.unpack(got)
    require(not bool(capped.any()), "a read reached K9's iteration cap")
    totals = dict(search=0, walk=0, walks=0, window=0, windows=0, seeded=0,
                  rounds=0)

    def on_round(fields, cols, events):
        live = fields[0] != sv.OP_NONE
        w = _round_steps(fmi, bank, [f[live] for f in fields], cols[:, live],
                         ext=True, walk=True, seed_k=seed.k)
        for key in totals:
            totals[key] += w.get(key, 1)

    chains, _ = automaton_chains(
        fmi, bank, lens, live0, seed, "rna", (1, automaton.TILE, 8),
        on_round=on_round, ac=kw["ac"], cc=kw["cc"], resolve=kw["resolve"])
    lf_steps = totals["walk"] + totals["window"]
    nbytes = (bank.numel() + 5 * R + 4 * 3 * R
              + 32 * (totals["seeded"] + totals["windows"])
              + _index_bytes(fmi, totals["search"], lf_steps, totals["walks"]))
    bound = bound_of(nbytes, SEARCH_STEP_OPS * totals["search"]
                     + WALK_STEP_OPS * lf_steps)
    ms = tiles[automaton.TILE]
    longest = int(iters.max())
    hist = np.bincount(iters[:len(rl)].cpu().numpy())
    row = dict(kernel="rnaseq_automaton", case="a chunk of phase 10",
               shape=f"R={R} Lb={bank.shape[1]} uint8, k={seed.k} table, "
                     f"tile {automaton.TILE}",
               max_abs_err=err, ms=ms, plain_ms=plain_ms, tiles_ms=tiles,
               chains=chains, latency_us=latency_us,
               chain_ms=chains[automaton.TILE]["longest"] * latency_us / 1e3,
               rounds=totals["rounds"], search_steps=totals["search"],
               walk_steps=totals["walk"], window_steps=totals["window"],
               longest_iters=longest,
               mean_iters=float(iters[:len(rl)].float().mean()),
               iters_hist=hist.tolist(), registers=regs, **bound)
    print(f"phase 10 K9 rnaseq_automaton on a chunk of {len(rl)} reads "
          f"({row['shape']}): bit-equal to its plain version on the card at "
          f"every tile (tolerance 0, max |d| {err}; res, capped, iterations "
          f"and the flag), kernel {ms:.4f} ms at tile {automaton.TILE} (by "
          f"tile: " + ", ".join(f"{T}: {t:.4f} ms" for T, t in tiles.items())
          + f"), plain {plain_ms:.4f} ms in {totals['rounds']} lockstep "
          f"rounds, bound {bound['bound_ms']:.4f} ms by {bound['bound_by']} "
          f"({bound['bytes']} bytes, {bound['ops']} operations: "
          f"{totals['search']} search, {totals['walk']} walk and "
          f"{totals['window']} window steps); the chain of dependent loads: "
          f"{_chain_text(chains, latency_us)}; registers by tile {regs}, no "
          f"stack frame; the longest read ran {longest} iterations, the mean "
          f"{row['mean_iters']:.3f}, by count {hist.tolist()} {tag}",
          flush=True)
    return row


def phase_rna_seq(fmi, codes_np, rng, nreads, tag, latency_us, variants,
                  forms, read_len=50, subset=1024, forced=4096, no_isa=4096,
                  nwindows=4096, keep=None):
    """Phase 10: rna_seq on reads cut from the genome with one base
    complemented (the self-benchmark of rnaseqtest.c:313-327): the device
    automaton ("auto"), then the host engine on the same reads, whose
    service rounds K7 is timed on as phase 7 times it (``forms``), then the
    executor's isa_range request."""
    import dataclasses

    import numpy as np

    from bwt_tpu_torch.models import rnaseq
    from bwt_tpu_torch.models.batch_exec import BatchExecutor, QueryService
    from bwt_tpu_torch.ops import automaton, dp_wavefront, search, service

    starts, reads, mpos = complemented_reads(rng, codes_np, nreads, read_len)
    svc = QueryService(fmi)
    # warm-up, on the reads before their mutation (it also builds the
    # seed table): an exact read is one full match and reports where it
    # was cut
    exact = codes_np[np.add.outer(starts[:256], np.arange(read_len))]
    require(np.array_equal(rnaseq.rna_seq(fmi, exact, service=svc),
                           starts[:256]),
            "an unmutated read does not report its origin")

    def zero_counts():
        search.BS_LAUNCHES = search.UNC_LAUNCHES = search.ISA_LAUNCHES = 0
        search.LOCATE_LAUNCHES = search.ANCHOR_LAUNCHES = 0
        dp_wavefront.LAUNCHES = dp_wavefront.STITCH_LAUNCHES = 0
        service.SERVICE_LAUNCHES = automaton.AUTOMATON_LAUNCHES = 0

    def others():
        return (search.BS_LAUNCHES, search.UNC_LAUNCHES, search.ISA_LAUNCHES,
                search.LOCATE_LAUNCHES, search.ANCHOR_LAUNCHES,
                dp_wavefront.LAUNCHES, dp_wavefront.STITCH_LAUNCHES)

    # the main path: "auto" takes the device automaton, one K9 launch a
    # chunk of config.search_batch reads
    zero_counts()
    t0 = time.perf_counter()
    pos = rnaseq.rna_seq(fmi, reads, service=svc)
    dt = time.perf_counter() - t0
    dstats = dict(svc.last_stats)
    k9 = automaton.AUTOMATON_LAUNCHES
    nchunks = -(-nreads // svc.config.search_batch)
    require(k9 == dstats["automaton_launches"] == dstats["chunks"] == nchunks,
            f"{k9} K9 launches for {nchunks} chunks ({dstats})")
    require(service.SERVICE_LAUNCHES == 0 and others() == (0,) * 7,
            f"rna_seq's device engine launched another kernel than K9: K7 "
            f"{service.SERVICE_LAUNCHES}, K3, K4, K6, locate, anchor_scan, "
            f"fill, stitch {others()}")
    require(dstats["capped"] == 0, f"{dstats['capped']} reads capped")
    # the device engine's wall, untraced: this run and RNA_WALLS - 1 more on
    # the same reads, and their median
    walls = [dt]
    for _ in range(RNA_WALLS - 1):
        t0 = time.perf_counter()
        again = rnaseq.rna_seq(fmi, reads, service=svc)
        walls.append(time.perf_counter() - t0)
        require(np.array_equal(again, pos), "rna_seq changed on a rerun")
    wall = float(np.median(walls))
    if keep is not None:
        keep["rna_seq"] = (reads, pos)
    require(pos.shape == (nreads,) and bool((pos >= -1).all())
            and bool((pos <= len(codes_np)).all()),
            "rna_seq returned a position outside [-1, n]")
    # a read whose mutation lies in its last bases retries shorter
    # prefixes while its search breaks short of the anchor cutoff; a prefix
    # that leaves the mutation out is exact and reports the read's origin.
    # On 2^25 bases a mutated suffix matches 12 to 14 bases somewhere by
    # chance, and 13 pass the cutoff: each retry then has an even chance of
    # ending the hunt at such a chance match (the break path's position,
    # rnaseqtest.c:55), so a fifth of these reads reach the exact prefix
    tail = mpos >= read_len - 10
    at_origin = float((pos[tail] == starts[tail]).mean())
    require(at_origin >= 0.1, f"only {at_origin:.3f} of the reads mutated in "
                              f"their last 10 bases report their origin")

    # the host engine on the same reads: K7, one launch a service call.
    # The executor clocks its service calls and its generators; the two
    # other loops over a round's requests are clocked from here
    clocks = dict(dispatch=0.0, replies=0.0, lanes=0)
    dispatch, finish = (BatchExecutor._dispatch_round,
                        BatchExecutor._finish_service)

    def clocked(key, fn):
        def run(*a):
            t = time.perf_counter()
            out = fn(*a)
            clocks[key] += time.perf_counter() - t
            if key == "replies":  # a: ((items, columns),)
                clocks["lanes"] += len(a[0][0])
            return out
        return run

    rounds, launch = [], service.service_round_packed

    def recording(fmi_, bank, *fields, **kw):
        rounds.append((bank, fields, kw))
        return launch(fmi_, bank, *fields, **kw)

    BatchExecutor._dispatch_round = clocked("dispatch", dispatch)
    BatchExecutor._finish_service = staticmethod(clocked("replies", finish))
    service.service_round_packed = recording
    zero_counts()
    try:
        t0 = time.perf_counter()
        host = rnaseq.rna_seq(fmi, reads, service=svc, engine="host")
        dt_host = time.perf_counter() - t0
    finally:
        BatchExecutor._dispatch_round = dispatch
        BatchExecutor._finish_service = staticmethod(finish)
        service.service_round_packed = launch
    stats = dict(svc.last_stats)
    launches = service.SERVICE_LAUNCHES
    require(launches == stats["svc_calls"] == stats["svc_launches"] > 0,
            f"{launches} service kernel launches for {stats['svc_calls']} "
            f"service calls")
    require(others() == (0,) * 7 and automaton.AUTOMATON_LAUNCHES == 0,
            f"rna_seq's host engine launched another kernel than the "
            f"service's: K9 {automaton.AUTOMATON_LAUNCHES}, K3, K4, K6, "
            f"locate, anchor_scan, fill, stitch {others()}")
    require(np.array_equal(host, pos),
            f"the device automaton and the host engine differ on "
            f"{int((host != pos).sum())} of {nreads} reads")

    # a subset through the plain automaton on the card and on the CPU
    sub = reads[:subset]
    svc.svc_impl = "plain"
    with_plain = rnaseq.rna_seq(fmi, sub, service=svc)
    require(svc.last_stats["automaton_launches"] == 0,
            "svc_impl = 'plain' launched K9")
    svc.svc_impl = "kernel"
    t1 = time.perf_counter()
    on_cpu = rnaseq.rna_seq(fmi.to("cpu"), sub)
    cpu_s = time.perf_counter() - t1
    require(np.array_equal(with_plain, pos[:subset])
            and np.array_equal(on_cpu, pos[:subset]),
            f"rna_seq differs on the {subset}-read subset between K9, its "
            f"plain version on the card and the CPU")

    # the cap as a bound with a flag: at 4 iterations most reads come back
    # capped and re-run on the host generators, with unchanged values
    rnaseq._TEST_CAP = 4
    try:
        t1 = time.perf_counter()
        capped = rnaseq.rna_seq(fmi, reads[:forced], service=svc)
        cap_s = time.perf_counter() - t1
    finally:
        rnaseq._TEST_CAP = 0
    ncapped = svc.last_stats["capped"]
    require(ncapped > 0 and np.array_equal(capped, pos[:forced]),
            f"the forced cap ({ncapped} reads capped) changed a value")

    k7_rows = [service_case(fmi, case, bank, fields, kw, forms, latency_us,
                            tag)
               for case, bank, fields, kw in pick_rounds(
                   "rna_seq's complemented reads", rounds)]
    del rounds
    k9_row = _automaton_case(fmi, svc, reads[:svc.config.search_batch], tag,
                             latency_us, variants)
    rest = dt_host - clocks["dispatch"] - clocks["replies"] - stats["t_gen"]
    print(f"phase 10 rna_seq {nreads} x {read_len} bp, one base complemented "
          f"(the self-benchmark's 1 M reads cut to 2^16), engine 'auto': "
          f"{nreads / dt:.1f} reads/s ({dt:.4f} s; the median of "
          f"{RNA_WALLS} untraced runs {wall:.4f} s, each "
          f"{[round(w, 4) for w in walls]}), {k9} K9 launches for "
          f"{nchunks} chunks and no other kernel, the longest read "
          f"{dstats['max_iters']} iterations, 256 unmutated reads report "
          f"their origin, {at_origin:.4f} of the {int(tail.sum())} reads "
          f"mutated in their last 10 bases do (the others end at a chance "
          f"match of 13 bases); equal on all {nreads} reads to the host "
          f"engine, {nreads / dt_host:.1f} reads/s ({dt_host:.3f} s): "
          f"{stats['rounds']} rounds, {stats['svc_calls']} service calls = "
          f"{launches} K7 launches over {clocks['lanes']} lanes, t_svc "
          f"{stats['t_svc']:.4f} s "
          f"({100 * stats['t_svc'] / dt_host:.2f} % of its wall) inside "
          f"{clocks['dispatch']:.4f} s of sorting the rounds' requests, "
          f"building their replies {clocks['replies']:.4f} s, generators "
          f"{stats['t_gen']:.4f} s, the rest (registering the reads, the "
          f"bank, making the generators) {rest:.4f} s; {subset}-read subset equal through the plain automaton on "
          f"the card and on a CPU copy of the index ({cpu_s:.3f} s); at a "
          f"forced cap of 4 iterations {ncapped} of {forced} reads re-ran "
          f"on the host, values equal ({cap_s:.3f} s) {tag}", flush=True)

    # an index read from the reference's file format has no inverse
    # samples: "auto" takes the host engine, whose continuation's candidate
    # scan walks the interval's rows in chunks (unc_sa_range): K4's path
    bare = dataclasses.replace(fmi, isa_samples=None)
    zero_counts()
    t0 = time.perf_counter()
    chunked = rnaseq.rna_seq(bare, reads[:no_isa])
    dt_bare = time.perf_counter() - t0
    unc = search.UNC_LAUNCHES
    require(np.array_equal(chunked, pos[:no_isa]),
            "rna_seq without isa_samples differs from the fused window scan")
    require(unc > 0 and search.BS_LAUNCHES == 0
            and automaton.AUTOMATON_LAUNCHES == 0,
            f"rna_seq without isa_samples: K4 launches {unc}, K3 launches "
            f"{search.BS_LAUNCHES}, K9 launches "
            f"{automaton.AUTOMATON_LAUNCHES}")
    print(f"phase 10 rna_seq {no_isa} reads on the index without "
          f"isa_samples (the host engine): equal to the device automaton, "
          f"{no_isa / dt_bare:.1f} reads/s ({dt_bare:.3f} s), K4 launches "
          f"{unc} (one a round with an unc_sa_range request), service kernel "
          f"launches {service.SERVICE_LAUNCHES} {tag}", flush=True)

    # the executor's isa_range request: the SA rows of a window, walked
    # back to their positions
    def lookup(p, w):
        rows = yield ("isa_range", p, p + w)
        back = yield ("par", [("unc_sa", int(r)) for r in rows])
        return back

    plo = rng.integers(0, len(codes_np) - 32, size=nwindows)
    wid = rng.integers(1, 33, size=nwindows)
    zero_counts()
    t0 = time.perf_counter()
    ex = BatchExecutor(QueryService(fmi))
    back = ex.run([lookup(int(p), int(w)) for p, w in zip(plo, wid)])
    dt_isa = time.perf_counter() - t0
    isa = search.ISA_LAUNCHES
    require(isa == 1 and service.SERVICE_LAUNCHES == 1,
            f"{nwindows} isa_range requests: K6 launches {isa}, service "
            f"kernel launches {service.SERVICE_LAUNCHES}")
    require(all(b == list(range(p, p + w))
                for b, p, w in zip(back, plo.tolist(), wid.tolist())),
            "unc_sa of an isa_range row is not its position")
    print(f"phase 10 executor isa_range: {nwindows} windows of 1..32 "
          f"positions, every row walked back to its position, "
          f"{nwindows / dt_isa:.1f} windows/s ({dt_isa:.3f} s), K6 launches "
          f"1, service kernel launches 1 {tag}", flush=True)
    return reads, dict(
        n=nreads, s=dt, per_s=nreads / dt, walls_s=walls, median_s=wall,
        at_origin=at_origin,
        automaton_launches=k9, device_stats=dstats, host_s=dt_host,
        host_per_s=nreads / dt_host, launches=launches, stats=stats,
        clocks=clocks, cpu_subset_s=cpu_s, forced_capped=ncapped, k9=k9_row,
        k7=k7_rows,
        no_isa_s=dt_bare, unc_launches=unc, isa_launches=isa,
        isa_svc_launches=service.SERVICE_LAUNCHES)


def rna_walls(n=RNA_WALLS, seed=0, nreads=1 << 16, read_len=50) -> dict:
    """rna_seq's device-engine wall alone, on phase 10's input (the
    2^25-base genome from ``seed``, sa_rate 4, 2^16 reads of 50 bp with one
    base complemented), ``n`` untraced runs after two warm-ups, and their
    median; nothing else runs in the process, and it uses only the entry
    points every earlier tree of the port has, so that the same script
    times two trees in one call:

        python3 chip_smoke.py --rna-walls 7"""
    import numpy as np

    import bwt_tpu_torch
    from bwt_tpu_torch.models import rnaseq
    from bwt_tpu_torch.models.batch_exec import QueryService

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=1 << 25).astype(np.uint8)
    fmi = bwt_tpu_torch.build_index(codes, sa_sample_rate=4, device="cuda")
    starts, reads, _ = complemented_reads(rng, codes, nreads, read_len)
    svc = QueryService(fmi)
    exact = codes[np.add.outer(starts[:256], np.arange(read_len))]
    require(np.array_equal(rnaseq.rna_seq(fmi, exact, service=svc),
                           starts[:256]),
            "an unmutated read does not report its origin")
    first = rnaseq.rna_seq(fmi, reads, service=svc)
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        pos = rnaseq.rna_seq(fmi, reads, service=svc)
        walls.append(time.perf_counter() - t0)
        require(np.array_equal(pos, first), "rna_seq changed on a rerun")
    out = dict(tree=str(ROOT), n=n, walls_s=walls,
               median_s=float(np.median(walls)), card=card_line())
    print(json.dumps(out), flush=True)
    return out


def rna_profile(n=RNA_WALLS, seed=0, nreads=1 << 16, read_len=50,
                trace=None) -> dict:
    """Where rna_seq's device engine spends its host time, on phase 10's
    input with the entry points of every earlier tree (as :func:`rna_walls`):
    ``n`` untraced runs with a clock around each step of the engine (the
    bank's build, the uploads, the K9 wrapper and its launch, the copy
    back and its wait, the flag's read), then one warmed run under
    cProfile and one under torch.profiler (host and device activities;
    ``trace`` names a Chrome trace file to write).  Prints one JSON line
    and the two profiles' tables:

        python3 chip_smoke.py --rna-profile 7"""
    import cProfile
    import io
    import pstats

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import bwt_tpu_torch
    from bwt_tpu_torch.models import batch_exec, rnaseq
    from bwt_tpu_torch.models.batch_exec import QueryService
    from bwt_tpu_torch.ops import automaton

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=1 << 25).astype(np.uint8)
    fmi = bwt_tpu_torch.build_index(codes, sa_sample_rate=4, device="cuda")
    starts, reads, _ = complemented_reads(rng, codes, nreads, read_len)
    svc = QueryService(fmi)
    exact = codes[np.add.outer(starts[:256], np.arange(read_len))]
    require(np.array_equal(rnaseq.rna_seq(fmi, exact, service=svc),
                           starts[:256]),
            "an unmutated read does not report its origin")
    first = rnaseq.rna_seq(fmi, reads, service=svc)

    clocks = {}

    def clocked(key, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                clocks.setdefault(key, []).append(time.perf_counter() - t)
        return run

    patched = [(rnaseq, "_host_array"), (rnaseq, "_to_device"),
               (rnaseq, "_to_host_async"), (automaton, "_automaton_kernel"),
               (automaton, "rna_seq_automaton_packed"),
               (automaton, "automaton_raise"),
               (batch_exec.QueryService, "add_reads_batch"),
               (batch_exec.QueryService, "reset_reads")]
    saved = [(obj, name, getattr(obj, name)) for obj, name in patched]
    walls = []
    try:
        for obj, name, fn in saved:
            setattr(obj, name, clocked(name, fn))
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pos = rnaseq.rna_seq(fmi, reads, service=svc)
            walls.append(time.perf_counter() - t0)
            require(np.array_equal(pos, first), "rna_seq changed on a rerun")
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    # the median over the runs of each step's total a run
    steps = {k: float(np.median(np.asarray(v).reshape(n, -1).sum(1)))
             for k, v in clocks.items()}

    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    rnaseq.rna_seq(fmi, reads, service=svc)
    prof.disable()
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(25)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as tp:
        rnaseq.rna_seq(fmi, reads, service=svc)
        torch.cuda.synchronize()
    if trace:
        tp.export_chrome_trace(str(trace))
    table = tp.key_averages().table(sort_by="self_cpu_time_total",
                                    row_limit=25)
    out = dict(tree=str(ROOT), n=n, walls_s=walls,
               median_s=float(np.median(walls)), steps_median_s=steps,
               card=card_line())
    print(json.dumps(out), flush=True)
    print(buf.getvalue(), flush=True)
    print(table, flush=True)
    return out


def phase_search_reads(fmi, codes_np, rng, nreads, tag, read_len=50,
                       subset=8192, keep=None):
    """Phase 8: search_reads on unmutated reads cut from the genome."""
    import numpy as np

    from bwt_tpu_torch.config import DEFAULT
    from bwt_tpu_torch.models import exact
    from bwt_tpu_torch.ops import search

    starts = rng.integers(0, len(codes_np) - read_len, size=nreads)
    reads = codes_np[np.add.outer(starts, np.arange(read_len))]
    chunks = -(-nreads // DEFAULT.search_batch)
    exact.search_reads(fmi, reads[:4096])  # warm-up
    walls = []
    for _ in range(2):  # the first call at this size also pins its buffers
        search.ANCHOR_LAUNCHES = search.BS_LAUNCHES = search.UNC_LAUNCHES = 0
        t0 = time.perf_counter()
        res = exact.search_reads(fmi, reads)
        walls.append(time.perf_counter() - t0)
        launches = (search.ANCHOR_LAUNCHES, search.BS_LAUNCHES,
                    search.UNC_LAUNCHES)
        require(launches == (2 * chunks, 0, 0),
                f"search_reads is not two anchor_scan launches a chunk: "
                f"anchor_scan, K3, K4 launches {launches} for {chunks} "
                f"chunks")
    dt = walls[1]
    require(bool((res["fwd_matches"] >= 1).all()),
            "a forward read found no anchor")
    fp = res["fwd_pos"]
    require(bool(((fp >= starts) & (fp < starts + read_len)).all()),
            "a forward anchor lies outside its read's origin span")
    t1 = time.perf_counter()
    plain = exact.search_reads(fmi.to("cpu"), reads[:subset])
    plain_s = time.perf_counter() - t1
    for k in res:
        require(np.array_equal(plain[k], res[k][:subset]),
                f"search_reads {k} differs between the kernels and the "
                f"plain versions on the {subset}-read subset")
    paired = int(res["paired"].sum())
    if keep is not None:
        keep["search_reads"] = (reads, res)
    print(f"phase 8 search_reads {nreads} x {read_len} bp ({reads.dtype} "
          f"codes): all forward reads anchored at their origin, {paired} "
          f"paired, {nreads / dt:.1f} reads/s ({dt:.4f} s; the first call at "
          f"this size, which also pins its buffers, {walls[0]:.4f} s), "
          f"anchor_scan launches {launches[0]} in {chunks} chunks a call, K3 "
          f"and K4 launches 0; "
          f"{subset}-read subset equal through the plain versions on the CPU "
          f"({plain_s:.3f} s) {tag}", flush=True)
    return dict(n=nreads, s=dt, per_s=nreads / dt, first_s=walls[0],
                launches=launches[0], chunks=chunks, paired=paired), reads


def phase_wide(fmi, codes_np, rng, keep, build, tag,
               chunk=1 << 15, nrows=1 << 20, nshift=1 << 16):
    """Phase 12: the wide (int64) index.  The 2^25-base genome built again
    with ``index_dtype=np.int64`` at sa_rate 4 (Mb/s and the peak above
    what the card held before, beside phase 3's), its arrays equal to
    phase 3's values and round-tripped through npz; then its main path with
    the launch counts set to 0 just before it: the k = 12 seed table (K5),
    locate of phase 4's 30-mers plain and seeded, count_matches (K3), the
    walks of 2^20 + 3 rows (K4) and search_reads of phase 8's reads
    (anchor_scan), each equal to the int32 index's run in int64; each wide
    kernel against its plain version (tolerance 0) and timed beside the
    int32 kernel on the same inputs, with its bound (the device layout's
    and the 12-int rows') and registers; the same kernels on the
    shifted-samples index (positions past int32) and on the shifted-counts
    index (counts past 2^38, its device layout derived on the card),
    bit-equal to their plain versions; K3 and locate on a 2^28-base genome
    built both ways, whose bucket tables pass the L2 (wide_big); and the
    drivers with no wide form (align_reads, rna_seq, isa_window) raising
    ValueError with no launch.
    Returns the report, its kernel rows, and the wide index."""
    import numpy as np
    import torch

    import bwt_tpu_torch
    from bwt_tpu_torch import index as tindex
    from bwt_tpu_torch import io as bio
    from bwt_tpu_torch.models import aligner, exact, rnaseq
    from bwt_tpu_torch.ops import search

    dev = fmi.device
    n = fmi.length
    bwt_tpu_torch.build_index(codes_np[:1 << 16], sa_sample_rate=4,
                              index_dtype=np.int64, device=dev)  # warm-up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wide = bwt_tpu_torch.build_index(codes_np, sa_sample_rate=4,
                                     index_dtype=np.int64, device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    held = sum(t.numel() * t.element_size() for t in (
        wide.bwt_words, wide.buckets, wide.sa_samples, wide.isa_samples,
        wide.C, wide.endloc, wide.rows32, wide.bases))
    held32 = sum(t.numel() * t.element_size() for t in (
        fmi.bwt_words, fmi.buckets, fmi.sa_samples, fmi.isa_samples, fmi.C,
        fmi.endloc))
    require(wide.wide and wide.buckets.shape[1] == 12
            and all(getattr(wide, f).dtype == torch.int64
                    for f in ("sa_samples", "isa_samples", "C", "endloc")),
            "the wide build is not the wide layout")
    as32 = tindex.narrow(wide)
    require(all(torch.equal(getattr(as32, f), getattr(fmi, f))
                for f in ("bwt_words", "buckets", "sa_samples", "isa_samples",
                          "C", "endloc"))
            and not bool(wide.buckets[:, 4:8].any()),
            "the wide index's values differ from the int32 build's")
    del as32
    from bwt_tpu_torch.ops import rank as rank_ops

    b = torch.arange(wide.buckets.shape[0], device=dev, dtype=torch.int64)
    require(wide.rows32 is not None and torch.equal(
        rank_ops.derived_rows(wide.rows32, wide.bases, 64 * b + b % 64),
        wide.buckets), "the wide index's device layout (rows32, bases) "
            "does not give back its 12-int rows")
    del b
    print(f"phase 12 build_index n={n} sa_rate=4 index_dtype=int64: "
          f"{dt:.3f} s ({n / dt / 1e6:.3f} Mb/s; phase 3's int32 build "
          f"{build['mbps']:.3f} Mb/s), peak device memory above what the "
          f"card held before {peak:.3f} GiB (phase 3: "
          f"{build['peak_gib']:.3f} GiB), the index {held / 1e6:.1f} MB "
          f"with its device layout ({wide.rows32.numel() * 4 / 1e6:.1f} MB "
          f"of rows32, {wide.bases.numel() * 8} bytes of bases, every 12-int "
          f"row given back) (int32: {held32 / 1e6:.1f} MB); every array "
          f"equal to the int32 build's values {tag}", flush=True)
    report = dict(n=n, build_s=dt, mbps=n / dt / 1e6, peak_gib=peak,
                  bytes=held, bytes_int32=held32)
    # the npz round trip of a host copy, on a thread while the card is
    # timed (zlib's 168 MB take about 18 s and leave the card alone)
    path = ROOT / "build" / "chip_smoke" / "wide.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    on_host = wide.to("cpu")
    npz = {}

    def round_trip():
        t0 = time.perf_counter()
        bio.write_npz_index(on_host, path)
        npz["back"] = bio.read_npz_index(path, device="cpu")
        npz["s"] = time.perf_counter() - t0

    npz_thread = threading.Thread(target=round_trip)
    npz_thread.start()

    # the main path on the wide index, its launch counts from 0
    kmers, klens = keep["kmers"]
    reads, want_sr = keep["search_reads"]
    idx = torch.from_numpy(np.concatenate([
        np.array([0, int(fmi.endloc), n]),
        rng.integers(0, n + 1, size=nrows)])).to(dev)
    exact.search_reads(wide, reads[:4096])  # warm-up: pins its buffers
    torch.cuda.synchronize()
    tp_launches(zero=True)
    t0 = time.perf_counter()
    wtable = search.build_seed_table(wide, k=SEED_K)
    pos = search.locate(wide, kmers, klens)
    pos_seeded = search.locate(wide, kmers, klens, seed_table=wtable)
    counts = search.count_matches(wide, kmers, klens)
    walked = search.unc_sa(wide, idx)
    sr = exact.search_reads(wide, reads)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = {k: v for k, v in tp_launches().items() if k in WIDE_KERNELS}
    require(all(launches[k] > 0 for k in WIDE_KERNELS),
            f"the wide main path left a kernel unlaunched: {launches}")
    require(pos.dtype == torch.int64 and torch.equal(
        pos.cpu(), torch.from_numpy(keep["locate_pos"]).long())
            and torch.equal(pos_seeded, pos),
            "locate on the wide index differs from the int32 index's")
    require(torch.equal(counts.cpu(), torch.from_numpy(keep["counts"]).long()),
            "count_matches on the wide index differs from the int32 index's")
    require(walked.dtype == torch.int64 and torch.equal(
        walked, search.unc_sa(fmi, idx.int()).long()),
            "unc_sa on the wide index differs from the int32 index's")
    require(all(np.array_equal(sr[k], want_sr[k]) for k in want_sr)
            and sr["fwd_pos"].dtype == np.int64
            and sr["fwd_matches"].dtype == np.int32,
            "search_reads on the wide index differs from the int32 index's")
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        exact.search_reads(wide, reads)
        walls.append(time.perf_counter() - t0)
    report.update(launches=launches, path_s=path_s, search_reads_s=walls[1],
                  search_reads_per_s=len(reads) / walls[1])
    print(f"phase 12 the wide main path (K5 at k={SEED_K}, locate plain and "
          f"seeded and count_matches of {kmers.shape[0]} 30-mers, unc_sa of "
          f"{idx.shape[0]} rows, search_reads of {len(reads)} x "
          f"{reads.shape[1]} bp) in {path_s:.3f} s, launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items())
          + f"; every output equal to the int32 index's, positions int64; "
          f"search_reads {len(reads) / walls[1]:.1f} reads/s ({walls[1]:.4f} "
          f"s; phase 8's int32 run in its line) {tag}", flush=True)

    # each wide kernel beside its plain version and the int32 kernel
    del wtable
    regs = registers_wide()
    rows = wide_pairs(fmi, wide, codes_np, rng, check=None)
    for r in rows:
        key = KERNEL_KEYS[r["kernel"].removesuffix("_wide")]
        r["registers"] = regs[key]
        print(f"phase 12 {r['kernel']} {r['case']} {r['shape']}: bit-equal "
              f"to its plain version and to the int32 kernel (tolerance 0), "
              f"wide kernel {r['ms_wide'][0]:.4f}; {r['ms_wide'][1]:.4f} ms, "
              f"int32 kernel {r['ms_int32'][0]:.4f}; {r['ms_int32'][1]:.4f} "
              f"ms on the same inputs in turns (ratio {r['ratio']:.3f}), "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']} ({r['bytes']} bytes, {r['ops']} operations; "
              f"with 48-byte rows {r['bound48_ms']:.4f} ms by "
              f"{r['bound48_by']}){r['note']}; registers int32 / wide "
              f"{regs[key][0]} / {regs[key][1]} {tag}", flush=True)
    chunk = 1 << 15
    cstarts = rng.integers(0, n - 50, size=chunk)
    creads = torch.from_numpy(
        codes_np[np.add.outer(cstarts, np.arange(50))]).to(dev)
    clens = torch.full((chunk,), 50, dtype=torch.int32, device=dev)

    # the shifted-samples index (positions past int32) and the
    # shifted-counts index (counts past 2^38, its device layout derived on
    # the card): every kernel equal to its plain version
    x = dict(kmers=kmers[:nshift], klens=klens[:nshift],
             sr=creads[:nshift], srlens=clens[:nshift],
             rows=idx[:nshift], pats=kmers[:nshift], lens=klens[:nshift],
             s0=idx[:nshift], e0=idx[1:nshift + 1])
    sh = shifted_index(wide)
    checked = held_to_plain(sh, x, "the shifted-samples index")
    require(all(checked[k] > np.iinfo(np.int32).max
                for k in ("K4", "locate", "anchor_scan")),
            f"the shifted-samples index gave no position past int32: "
            f"{checked}")
    report["shifted_max"] = checked
    print(f"phase 12 the shifted-samples index (every SA sample + "
          f"{WIDE_SHIFT}): " + ", ".join(WIDE_KERNELS) + f" on {nshift} "
          f"inputs each bit-equal to the plain versions, largest output "
          + ", ".join(f"{k} {v}" for k, v in checked.items())
          + f" (past int32 where a walk ends) {tag}", flush=True)
    del sh
    t0 = time.perf_counter()
    sc = shifted_counts(wide)
    torch.cuda.synchronize()
    derive_s = time.perf_counter() - t0
    require(sc.rows32.device == dev and bool(
        (sc.bases[:-1] >> 32 == COUNT_SHIFT >> 32).all()),
            "the shifted-counts index's bases are not derived on the card")
    checked = held_to_plain(sc, x, "the shifted-counts index")
    require(torch.equal(search.unc_sa(sc, idx[:nshift]), walked[:nshift]),
            "the shifted-counts index's walks differ from the wide index's")
    report["counts_max"] = checked
    print(f"phase 12 the shifted-counts index (every occ count + "
          f"{COUNT_SHIFT}, C - {COUNT_SHIFT}; its rows32 and bases derived "
          f"on the card in {derive_s:.4f} s): " + ", ".join(WIDE_KERNELS)
          + f" on {nshift} inputs each bit-equal to the plain versions, and "
          f"its walks (K4) equal to the wide index's {tag}", flush=True)
    del sc
    report["big"] = wide_big(rng, tag)

    refused = {}
    before = tp_launches()
    for what, fn in (
            ("align_reads", lambda: aligner.align_reads(
                wide, codes_np, [codes_np[:80]])),
            ("rna_seq", lambda: rnaseq.rna_seq(wide, [codes_np[:50]])),
            ("isa_window", lambda: search.isa_window(wide, [0], [8]))):
        try:
            fn()
        except ValueError as e:
            refused[what] = str(e)
        else:
            raise SmokeFailure(f"{what} ran on the wide index")
    require(tp_launches() == before, "a refused driver launched a kernel")
    print(f"phase 12 align_reads, rna_seq and isa_window on the wide index "
          f"raised ValueError with no launch: {refused['align_reads']} "
          f"{tag}", flush=True)
    npz_thread.join()
    back = npz.get("back")
    require(back is not None and all(
        torch.equal(getattr(back, f), getattr(on_host, f))
        and getattr(back, f).dtype == getattr(on_host, f).dtype
        for f in ("bwt_words", "buckets", "sa_samples", "isa_samples", "C",
                  "endloc")), "the wide index does not round-trip through npz")
    report["npz_s"] = npz["s"]
    print(f"phase 12 to_numpy -> write_npz_index -> read_npz_index "
          f"round-trips the wide index, every array and dtype ({npz['s']:.3f} "
          f"s on a host thread while the card ran the checks above) {tag}",
          flush=True)
    del back, on_host
    report["rows"] = rows
    return report, rows, wide


WIDE_BIG_BITS = 28   # a genome whose bucket tables pass the 50 MB L2
WIDE_CHECK = 1 << 12  # the inputs of a timed case held to the plain version


def wide_pairs(fmi, wide, codes_np, rng, nq=1 << 20, full=True, reps=20,
               check=WIDE_CHECK) -> list:
    """Each wide kernel timed beside the int32 kernel on the same inputs,
    in turns (wide, int32, wide, int32; CUDA events, ``reps`` launches
    each), its outputs on the first ``check`` inputs (all with None) equal
    to its plain version's (timed there once) and, in int64, to the int32
    kernel's, tolerance 0, with its bound for the work these inputs need
    in the device layout (32-byte rows over their bases) and in the 12-int
    rows: K3 and locate plain on ``nq`` random 30-mers of the genome
    ``codes_np`` of the two indexes; with ``full`` also locate k =
    12-seeded, K4 on ``nq`` + 3 rows, the anchor hunt on a search_reads
    chunk forward and reversed, and K5 at k = 12 (its whole table).  It
    calls the package's wrappers alone, so this file beside an older
    tree's package (one with ``rank_ops.superblocks``) times that tree the
    same way.  Returns one row a case."""
    import numpy as np
    import torch

    from bwt_tpu_torch.models import exact
    from bwt_tpu_torch.ops import rank as rank_ops
    from bwt_tpu_torch.ops import search

    dev = fmi.device
    n = fmi.length
    m = check  # the inputs held to the plain version: all with None

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def bounds(nbytes, steps, wsteps, walks, ops):
        return [bound_of(nbytes + _index_bytes(wide, steps, wsteps, walks,
                                               row_bytes=rb), ops)
                for rb in (32, 48)]

    def search_bounds(nbytes, r, n0, walks=0):
        steps = int(_search_steps(r, n0, r["nmatched"] >= n0).sum())
        ws = wsteps if walks else 0
        note = f", {steps} search" + (f" and {ws} walk steps" if walks
                                      else " steps")
        return bounds(nbytes, steps, ws, walks,
                      SEARCH_STEP_OPS * steps + WALK_STEP_OPS * ws) + [note]

    kmers = on_dev(codes_np[np.add.outer(rng.integers(0, n - 30, size=nq),
                                         np.arange(30))].astype(np.int32))
    klens = torch.full((nq,), 30, dtype=torch.int32, device=dev)

    def lanes(f, k=None, **kw):
        r = search.search_lanes(f, kmers[:k], klens[:k], **kw)
        return [r[x] for x in search._FIELDS]

    r32 = search.search_lanes(fmi, kmers, klens)
    wsteps = _walk_steps(fmi, r32["start"])
    shape = f"B={nq} L=30"
    cases = [
        ("backward_search_wide", "C[c0], 30-mers", shape, lanes,
         lambda: [search.backward_search_plain(wide, kmers[:m], klens[:m])[x]
                  for x in search._FIELDS], False, reps,
         lambda: search_bounds(4 * kmers.numel() + (4 + 8 * 8) * nq, r32,
                               1)),
        ("locate_wide", "30-mers, plain", shape,
         lambda f, k=None: [search.locate_kernel(f, kmers[:k], klens[:k])
                            [:-2]],
         lambda: [search.locate_plain(wide, kmers[:m], klens[:m])], False,
         reps, lambda: search_bounds(4 * kmers.numel() + 12 * nq, r32, 1,
                                     nq)),
    ]
    if full:
        tables = {id(f): search.build_seed_table(f, k=SEED_K)
                  for f in (fmi, wide)}
        idx = on_dev(np.concatenate([np.array([0, int(fmi.endloc), n]),
                                     rng.integers(0, n + 1, size=nq)]))
        idxs = {id(f): idx.to(f.pos_dtype) for f in (fmi, wide)}
        chunk = 1 << 15
        starts = rng.integers(0, n - 50, size=chunk)
        creads = on_dev(codes_np[np.add.outer(starts, np.arange(50))])
        clens = torch.full((chunk,), 50, dtype=torch.int32, device=dev)

        def seeded_bounds():
            r = search.search_lanes(fmi, kmers, klens,
                                    seed_table=tables[id(fmi)])
            return search_bounds(4 * kmers.numel() + (4 + 8 + 48) * nq, r,
                                 SEED_K, nq)

        def walk_bounds():
            steps = _walk_steps(fmi, idx.int())
            return bounds(16 * idx.shape[0], 0, steps, idx.shape[0],
                          WALK_STEP_OPS * steps) + [f", {steps} steps"]

        def hunt_bounds(flipped):
            _, steps, ws, walks, _, _ = _anchor_scan_unfused(
                fmi, flipped, clens, exact.MIN_ANCHOR)
            return bounds(creads.numel() + (4 + 16) * chunk, steps, ws,
                          walks,
                          SEARCH_STEP_OPS * steps + WALK_STEP_OPS * ws) + [
                f", {steps} search and {ws} walk steps"]

        def seed_bounds():
            loads = seed_loads(fmi, SEED_K)
            got = loads["level"]["loads"]
            out = [bound_of(
                48 * 4 ** SEED_K + min(rb * wide.buckets.shape[0], rb * got)
                + (rb == 32) * min(
                    32 * (rank_ops.superblocks(wide.bucket_rows) + 1),
                    32 * got),
                SEED_PARENT_OPS * loads["parents"]) for rb in (32, 48)]
            return out + [f", {loads['parents']} live parents; the table "
                          f"{48 * 4 ** SEED_K} bytes (int64 rows)"]

        cases += [
            ("locate_wide", f"30-mers, seeded k={SEED_K}", shape,
             lambda f, k=None: [search.locate_kernel(
                 f, kmers[:k], klens[:k], seed_table=tables[id(f)])[:-2]],
             lambda: [search.locate_plain(wide, kmers[:m], klens[:m],
                                          seed_table=tables[id(wide)])],
             False, reps, seeded_bounds),
            ("unc_sa_wide", "rows in [0, n] with 0, endloc, n (a wrapper "
             "call, flag read-back included)", f"B={idx.shape[0]}",
             lambda f, k=None: [search.unc_sa(f, idxs[id(f)][:k])],
             lambda: [search.unc_sa_plain(wide, idx[:m])], False, reps,
             walk_bounds)]
        for rev in (False, True):
            flipped = creads.to(torch.int32)
            if rev:
                flipped = exact._plain_reverse(flipped, clens)
            cases.append((
                "anchor_scan_wide", f"a search_reads chunk, uint8, "
                f"{'reversed' if rev else 'forward'}, min_anchor="
                f"{exact.MIN_ANCHOR}", f"B={chunk} L=50",
                lambda f, k=None, rev=rev: [search.anchor_scan_kernel(
                    f, creads[:k], clens[:k], min_anchor=exact.MIN_ANCHOR,
                    reverse=rev)[:-4]],
                lambda flipped=flipped: [torch.cat(exact.anchor_scan_plain(
                    wide, flipped[:m], clens[:m]))], True, reps,
                lambda flipped=flipped: hunt_bounds(flipped)))
        cases.append(("seed_rows_wide", f"k={SEED_K}", f"{4 ** SEED_K} keys",
                      lambda f, k=None: [search._seed_rows(f, SEED_K)],
                      lambda: [search._seed_rows_plain(wide, SEED_K)],
                      False, 5, seed_bounds))
    rows = []
    for kernel, case, shp, run, plain, ahead, k, work in cases:
        got, narrow = run(wide, m), run(fmi, m)
        want, plain_ms = _event_ms(plain)
        got_n = got[0].shape[0]
        require(len(got) == len(want) == len(narrow) and all(
            torch.equal(a, b) and torch.equal(a.long(), c.long())
            for a, b, c in zip(got, want, narrow)),
                f"{kernel} {case}: the wide kernel differs from its plain "
                f"version or the int32 kernel")
        err = max(_max_abs_diff(got, want), _max_abs_diff(got, narrow))
        del got, want, narrow
        ms = {"wide": [], "int32": []}
        for _ in range(2):
            for f, key in ((wide, "wide"), (fmi, "int32")):
                ms[key].append(cuda_ms(lambda: run(f), k, ahead=ahead))
        b32, b48, note = work()
        rows.append(dict(
            kernel=kernel, case=case, shape=shp, n=n, max_abs_err=err,
            ms_wide=ms["wide"], ms_int32=ms["int32"],
            ms=sum(ms["wide"]) / 2, narrow_ms=sum(ms["int32"]) / 2,
            ratio=sum(ms["wide"]) / sum(ms["int32"]), plain_ms=plain_ms,
            checked=got_n, note=note, bound48_ms=b48["bound_ms"],
            bound48_by=b48["bound_by"], **b32))
    return rows


def wide_big(rng, tag, bits: int = WIDE_BIG_BITS) -> dict:
    """Phase 12's table past the L2: a 2^bits-base genome built int32 and
    wide on the card (sa_rate 4), K3 and locate plain on 2^20 of its
    30-mers, each wide kernel beside the int32 one (:func:`wide_pairs`)."""
    import numpy as np
    import torch

    import bwt_tpu_torch

    t0 = time.perf_counter()
    codes = rng.integers(0, 4, size=1 << bits, dtype=np.uint8)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fmi = bwt_tpu_torch.build_index(codes, sa_sample_rate=4, device="cuda")
    wide = bwt_tpu_torch.build_index(codes, sa_sample_rate=4,
                                     index_dtype=np.int64, device="cuda")
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    build_s = time.perf_counter() - t0
    sizes = dict(int32=fmi.buckets.numel() * 4, wide=wide.buckets.numel() * 4,
                 rows32=wide.rows32.numel() * 4, bases=wide.bases.numel() * 8)
    rows = wide_pairs(fmi, wide, codes, rng, full=False)
    for r in rows:
        print(f"phase 12 {r['kernel']} {r['case']} on the 2^{bits}-base "
              f"table: wide {r['ms_wide'][0]:.4f}; {r['ms_wide'][1]:.4f} ms, "
              f"int32 {r['ms_int32'][0]:.4f}; {r['ms_int32'][1]:.4f} ms "
              f"(ratio {r['ratio']:.3f}); bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']} (48-byte rows {r['bound48_ms']:.4f})"
              f"{r['note']}; {r['checked']} outputs bit-equal to the plain "
              f"version and the int32 kernel {tag}",
              flush=True)
    del fmi, wide, codes
    torch.cuda.empty_cache()
    out = dict(bits=bits, build_s=build_s, peak_gib=peak, bytes=sizes,
               rows=rows, s=time.perf_counter() - t0)
    print(f"phase 12 the 2^{bits}-base genome built int32 and wide on the "
          f"card (peak {peak:.3f} GiB above what the card held), bucket "
          f"tables {sizes['int32'] / 1e6:.1f} / {sizes['wide'] / 1e6:.1f} MB "
          f"(int32 / 12-int), the wide device layout "
          f"{sizes['rows32'] / 1e6:.1f} MB of rows32 and {sizes['bases']} "
          f"bytes of bases; the case "
          f"{out['s']:.3f} s {tag}", flush=True)
    return out


def wide_times(bits=(25, WIDE_BIG_BITS), seed: int = 0) -> list:
    """``--wide-times``: the int32 and wide indexes of a 2^b-base genome for
    each b of ``bits``, every wide kernel beside the int32 one
    (:func:`wide_pairs`; the full set at the first size), one JSON line a
    case.  Run beside an older tree's package to pair the two trees in
    one call."""
    import numpy as np
    import torch

    import bwt_tpu_torch

    tag = f"[{card_line()}]"
    rng = np.random.default_rng(seed)
    out = []
    for j, b in enumerate(bits):
        codes = rng.integers(0, 4, size=1 << b, dtype=np.uint8)
        fmi = bwt_tpu_torch.build_index(codes, sa_sample_rate=4,
                                        device="cuda")
        wide = bwt_tpu_torch.build_index(codes, sa_sample_rate=4,
                                         index_dtype=np.int64, device="cuda")
        for r in wide_pairs(fmi, wide, codes, rng, full=j == 0):
            r.update(bits=b, card=tag)
            print("wide-times " + json.dumps(r), flush=True)
            out.append(r)
        del fmi, wide, codes
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# the tp form of the search kernels: the cases it is held on
# --------------------------------------------------------------------------

# the JSON line's names of the kernels that read an index, with the keys
# of TP_KERNELS
KERNEL_KEYS = dict(backward_search="K3", unc_sa="K4", locate="locate",
                   anchor_scan="anchor_scan", seed_rows="K5",
                   isa_window="K6", service="K7", rnaseq_automaton="K9",
                   align_automaton="K10")

# the kernels that read an index through fm::IndexT, and the launch count
# each wrapper keeps
TP_KERNELS = (("K3", "search", "BS_LAUNCHES"),
              ("K4", "search", "UNC_LAUNCHES"),
              ("locate", "search", "LOCATE_LAUNCHES"),
              ("anchor_scan", "search", "ANCHOR_LAUNCHES"),
              ("K5", "search", "SEED_LAUNCHES"),
              ("K6", "search", "ISA_LAUNCHES"),
              ("K7", "service", "SERVICE_LAUNCHES"),
              ("K9", "automaton", "AUTOMATON_LAUNCHES"),
              ("K10", "automaton", "ALIGN_LAUNCHES"))


def tp_launches(zero=False) -> dict:
    """The launch counts of :data:`TP_KERNELS`, set to 0 with ``zero``."""
    import importlib

    out = {}
    for key, mod, name in TP_KERNELS:
        m = importlib.import_module(f"bwt_tpu_torch.ops.{mod}")
        if zero:
            setattr(m, name, 0)
        out[key] = getattr(m, name)
    return out


def tp_inputs(fmi, codes, rng, device, n) -> dict:
    """The inputs the tp kernels are held on (:func:`tp_cases`), on
    ``device``, from the genome ``codes`` of the index ``fmi`` (whole, on
    any device; its banks only): ``n`` mixed reads (mixed_reads) for the
    searches, the same reads from random intervals (mode 1, rows out of
    the table included), every row of the suffix array in steps for the
    walks, ``n`` exact 30-mers for locate, ``n`` 50-bp reads for the anchor
    hunts, windows of widths -2..40 across the genome, a service round of
    ``n`` fuzzed lanes (service_lanes), and ``n`` reads each for the two
    automatons (complemented 50-mers; 80-bp reads with a substitution,
    both strands)."""
    import numpy as np
    import torch

    from bwt_tpu_torch.models.batch_exec import QueryService

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    m = fmi.length
    pats, lens = mixed_reads(rng, codes, n)
    starts = rng.integers(0, m - 30, size=n)
    kmers = codes[np.add.outer(starts, np.arange(30))].astype(np.int32)
    starts = rng.integers(0, m - 50, size=n)
    sr = codes[np.add.outer(starts, np.arange(50))]
    bank, fields = service_lanes(rng, codes, n, R=64, Lb=112)
    rsvc = QueryService(fmi)
    _, rl = rsvc.add_reads_batch(complemented_reads(rng, codes, n)[1])
    asvc = QueryService(fmi)
    areads = mutated_reads(rng, codes, n)[1]
    asvc.add_reads_batch(areads, with_revcomp=True)
    R, Bp = rsvc.bank8.shape[0], asvc.bank8.shape[0] // 2
    rlens, alens = np.zeros(R, np.int32), np.zeros(Bp, np.int32)
    rlens[:len(rl)] = rl
    alens[:len(areads)] = [len(r) for r in areads]
    return dict(
        pats=dev(pats), lens=dev(lens),
        s0=dev(rng.integers(-2 * m, 2 * m, size=n).astype(np.int32)),
        e0=dev(rng.integers(-2 * m, 2 * m, size=n).astype(np.int32)),
        rows=torch.arange(0, m + 1, max(1, (m + 1) // (4 * n)),
                          dtype=torch.int32, device=device),
        kmers=dev(kmers), klens=dev(np.full(n, 30, np.int32)),
        sr=dev(sr), srlens=dev(np.full(n, 50, np.int32)),
        plo=dev(rng.integers(-40, m + 40, size=n).astype(np.int32)),
        wid=dev(rng.integers(-2, 41, size=n).astype(np.int32)),
        bank=dev(bank), fields=dev(fields).unbind(0),
        rbank=rsvc.bank8.to(device), rlens=dev(rlens),
        rlive=torch.arange(R, device=device) < len(rl),
        abank=asvc.bank8.to(device), alens=dev(alens),
        alive=torch.arange(Bp, device=device) < len(areads))


def tp_cases(fmi, x, plain=False) -> dict:
    """Each kernel of :data:`TP_KERNELS` on the inputs ``x``
    (:func:`tp_inputs`), as a call that returns its outputs: through the
    wrapper (the kernel on a card, the replicated or the tp form by the
    index) or, with ``plain``, through its plain version (on a tp view,
    the local gathers and the all-reduces over 'tp')."""
    from bwt_tpu_torch.models import exact
    from bwt_tpu_torch.models.batch_exec import _service_core
    from bwt_tpu_torch.ops import automaton, search

    def bs(**kw):
        fn = search.backward_search_plain if plain else search.search_lanes
        r = fn(fmi, x["pats"], x["lens"], **kw)
        return [r[f].to(fmi.pos_dtype) for f in search._FIELDS]

    def hunt(reverse):
        if not plain:
            return list(exact.anchor_scan(fmi, x["sr"], x["srlens"],
                                          min_anchor=20, reverse=reverse))
        p = x["sr"].int()
        if reverse:
            p = exact._plain_reverse(p, x["srlens"])
        return list(exact.anchor_scan_plain(fmi, p, x["srlens"],
                                            min_anchor=20))

    def walk(idx):
        return (search.unc_sa_plain if plain else search.unc_sa)(fmi, idx)

    return {
        "K3": lambda: (bs(resolve_n=True) + bs()
                       + bs(resolve_n=True, start=x["s0"], end=x["e0"])),
        "K4": lambda: [walk(x["rows"])],
        "locate": lambda: [(search.locate_plain if plain else search.locate)(
            fmi, x["kmers"], x["klens"])],
        "anchor_scan": lambda: hunt(False) + hunt(True),
        "K5": lambda: [(search._seed_rows_plain if plain
                        else search._seed_rows)(fmi, 6)],
        "K6": lambda: [(search.isa_window_plain if plain
                        else search.isa_window)(fmi, x["plo"], x["wid"])],
        "K7": lambda: list(_service_core(fmi, x["bank"], *x["fields"],
                                         resolve=True, ext=True,
                                         plain=plain)),
        "K9": lambda: [automaton.rna_seq_automaton_packed(
            fmi, x["rbank"], x["rlens"], x["rlive"], ac=14, cc=10,
            resolve=True, plain=plain)],
        "K10": lambda: [automaton.align_automaton_packed(
            fmi, x["abank"], x["alens"], x["alive"], fmi.length,
            anchor_len=12, resolve=True, plain=plain)],
    }


# the kernels with a wide (int64) instantiation, as TP_KERNELS names them
WIDE_KERNELS = ("K3", "K4", "locate", "anchor_scan", "K5")
# what shifted_index adds to every SA sample: its positions pass int32
WIDE_SHIFT = (1 << 32) + 7


def shifted_index(fmi):
    """The wide index ``fmi`` with every SA sample moved WIDE_SHIFT up: a
    stand-in for a genome past the int32 cap (whose build needs about
    155 GB).  A walk's position, its sample plus its steps wrapped by
    length + 1, then lies in [2^32 + 6 - length, 2^32 + 6], which no
    int32 kernel could hold."""
    import dataclasses

    return dataclasses.replace(fmi, sa_samples=fmi.sa_samples + WIDE_SHIFT)


# what shifted_counts adds to every occ count of a wide index and takes from
# its C: a multiple of 2^38, so that a position moved by it reads the same
# row (the row number i >> 6 is cut to int32) and every LF step lands where
# the index's own does; the high halves of its counts are 3 << 6
COUNT_SHIFT = 3 << 38
# the shifts of the CPU tests' count tables, whose reads need no walk
COUNT_SHIFTS = ((1 << 32) + 7, (1 << 33) + 1)


def shift_counts(buckets, shift: int):
    """Wide 12-int bucket rows with every occ count moved ``shift`` up
    (wrapping int64), the words as they are."""
    import torch

    from bwt_tpu_torch.ops import rank as rank_ops

    occ = rank_ops._row_occ(buckets) + shift
    return torch.cat([rank_ops.wrap32(occ & 0xFFFFFFFF),
                      (occ >> 32).to(torch.int32), buckets[:, 8:]],
                     dim=1).contiguous()


def held_to_plain(fmi, x, what: str) -> dict:
    """Each wide kernel (:data:`WIDE_KERNELS`) of :func:`tp_cases` on the
    inputs ``x``, launched, and bit-equal to its plain version on the
    index ``fmi``; {kernel: its largest output}."""
    checked = {}
    for k, fn in tp_cases(fmi, x).items():
        if k not in WIDE_KERNELS:
            continue
        tp_launches(zero=True)
        got = tp_outcome(fn)
        want = tp_outcome(tp_cases(fmi, x, plain=True)[k])
        require(tp_launches()[k] > 0 and tp_equal(got, want),
                f"{k} (wide) on {what} differs from its plain version")
        checked[k] = (max(int(t.max()) for t in got)
                      if isinstance(got, list) else got.__name__)
    return checked


def shifted_counts(fmi, shift: int = COUNT_SHIFT):
    """The wide index ``fmi`` with every occ count moved ``shift`` up and C
    moved down by it: the only index whose counts have high halves that
    are not 0 (a genome past 2^32 bases would need about 300 GB to build).
    Each LF step, C[c] - shift + rank(c, i) + shift, is the index's own;
    the first step of a search reads its row at C[c0] - shift, the row of
    C[c0] with no sentinel skip, so an interval may start one row off
    there, and nothing leaves the suffix array's rows.  Its device layout
    is derived anew where the index lies on a card."""
    import dataclasses

    return dataclasses.replace(
        fmi, buckets=shift_counts(fmi.buckets, shift), C=fmi.C - shift)


def wide_inputs(x, rng) -> dict:
    """:func:`tp_inputs`' inputs for a wide index's kernels
    (:data:`WIDE_KERNELS`): the given intervals and the walks' rows as
    int64, a quarter of the intervals moved by multiples of 2^38, whose
    row numbers are cut to int32 as bwt_tpu's are."""
    import numpy as np
    import torch

    far = torch.from_numpy(rng.choice(
        np.array([0, 0, 0, 1 << 38, -(1 << 40), 3 << 44], np.int64),
        size=x["s0"].shape[0])).to(x["s0"].device)
    return dict(x, s0=x["s0"].long() + far, e0=x["e0"].long() + far,
                rows=x["rows"].long())


def tp_outcome(fn):
    """What a case gave: its outputs on the host, or the type of what it
    raised (a walk from a row past the suffix array raises in both
    forms)."""
    import torch

    try:
        out = fn()
    except RuntimeError as e:
        return type(e)
    torch.cuda.synchronize()
    return [t.cpu() for t in out]


def tp_equal(a, b) -> bool:
    import torch

    if isinstance(a, type) or isinstance(b, type):
        return a is b
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# --------------------------------------------------------------------------
# phase 11: the mesh (bwt_tpu_torch.parallel), in child processes
# --------------------------------------------------------------------------

MESH_WORLDS = (("nccl", 1), ("gloo", 4))  # backend, ranks, all on cuda:0
MESH_TIMEOUT_S = 300  # every collective's bound, and a world's wall
MESH_COUNTS = (("K3", "search", "BS_LAUNCHES"),
               ("K4", "search", "UNC_LAUNCHES"),
               ("anchor_scan", "search", "ANCHOR_LAUNCHES"),
               ("K10", "automaton", "ALIGN_LAUNCHES"),
               ("K11a", "dp_wavefront", "LOG_STITCH_LAUNCHES"),
               ("K11b", "compose", "COMPOSE_LAUNCHES"),
               ("K9", "automaton", "AUTOMATON_LAUNCHES"),
               ("K5", "search", "SEED_LAUNCHES"))
# the kernels each path must launch on every rank, in each of its runs
MESH_NEEDS = {"search_step": ("K3", "K4"), "search_reads": ("anchor_scan",),
              "align_subst": ("K10", "K11a", "K11b"),
              "align_indel": ("K10", "K11a", "K11b"), "rna_seq": ("K9",)}


def _mesh_counts(zero=False) -> dict:
    """The launch counts the mesh phase reads, set to 0 with ``zero``."""
    import importlib

    out = {}
    for key, mod, name in MESH_COUNTS:
        m = importlib.import_module(f"bwt_tpu_torch.ops.{mod}")
        if zero:
            setattr(m, name, 0)
        out[key] = getattr(m, name)
    return out


def _mesh_inputs(workdir: Path, fmi, codes_np, keep, wide=None) -> None:
    """Phase 3's index, genome and SA, the wide index (built here when
    ``wide`` is None), and phases 4, 5, 8 and 10's inputs with their
    single-device outputs, written for the ranks."""
    import pickle

    import numpy as np

    import bwt_tpu_torch
    from bwt_tpu_torch.ops import suffix

    np.savez(workdir / "index.npz", **fmi.to_numpy())
    if wide is None:
        wide = bwt_tpu_torch.build_index(codes_np, sa_sample_rate=fmi.sa_rate,
                                         index_dtype=np.int64,
                                         device=fmi.device)
    np.savez(workdir / "wide.npz", **wide.to_numpy())
    np.save(workdir / "genome.npy", codes_np)
    np.save(workdir / "sa.npy", suffix.suffix_array(codes_np,
                                                    device=fmi.device)
            .cpu().numpy())
    pats, lens = keep["kmers"]
    np.savez(workdir / "search_step.npz", pats=pats.cpu().numpy(),
             lens=lens.cpu().numpy(), pos=keep["locate_pos"],
             counts=keep["counts"])
    np.savez(workdir / "search_reads.npz", reads=keep["search_reads"][0],
             **keep["search_reads"][1])
    (workdir / "align.pkl").write_bytes(pickle.dumps(keep["align"]))
    np.savez(workdir / "rna_seq.npz", reads=keep["rna_seq"][0],
             pos=keep["rna_seq"][1])


def _mesh_rank(workdir: Path, world: int, device="cuda:0",
               tp_only: bool = False) -> dict:
    """One rank's run of the mesh phase: the sharded build over a tp =
    world mesh, then the four serving paths over a dp = world mesh, each
    twice (its first run in this process, then again), every output held
    to the single-device run's, tolerance 0; then, in a world of more than
    one rank, the tp meshes (:func:`_tp_rank`), alone with ``tp_only``."""
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist

    import bwt_tpu_torch
    from bwt_tpu_torch import parallel
    from bwt_tpu_torch.models import aligner, exact, rnaseq
    from bwt_tpu_torch.models.batch_exec import QueryService
    from bwt_tpu_torch.parallel import mesh as pmesh
    from bwt_tpu_torch.parallel import suffix_dist

    dev = torch.device(device)
    out = dict(rank=dist.get_rank(), paths={})
    step = dict(np.load(workdir / "search_step.npz"))
    sr = dict(np.load(workdir / "search_reads.npz"))
    sr_reads = sr.pop("reads")
    align = pickle.loads((workdir / "align.pkl").read_bytes())
    rna = dict(np.load(workdir / "rna_seq.npz"))
    if tp_only:
        out["tp"] = _tp_rank(workdir, world, dev, step, sr, sr_reads, align,
                             rna)
        dist.barrier()
        return out
    serve = parallel.make_mesh(world, tp=1, device=dev)
    build = parallel.make_mesh(world, tp=world, device=dev)
    codes = np.load(workdir / "genome.npy")

    # the build first, on a device that holds nothing else yet: the sort's
    # and the finish's peaks apart (build_index_sharded's two calls)
    rec, sort = {}, suffix_dist.sharded_suffix_array

    def sort_clocked(*a, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        sa = sort(*a, **kw)
        torch.cuda.synchronize()
        rec.update(sort_s=time.perf_counter() - t, sa=sa,
                   sort_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   finish_t0=time.perf_counter())
        torch.cuda.reset_peak_memory_stats()
        return sa

    suffix_dist.sharded_suffix_array = sort_clocked
    staged = pmesh.STAGED_BYTES
    try:
        dist.barrier()
        t0 = time.perf_counter()
        built = suffix_dist.build_index_sharded(codes, build, axis="tp",
                                                sa_sample_rate=4)
        torch.cuda.synchronize()
    finally:
        suffix_dist.sharded_suffix_array = sort
    t1 = time.perf_counter()
    require(np.array_equal(rec.pop("sa"), np.load(workdir / "sa.npy")),
            "the sharded SA differs from the single-device SA")
    with np.load(workdir / "index.npz") as want:
        got = built.to_numpy()
        bad = [k for k in want.files if not np.array_equal(got[k], want[k])]
    require(not bad, f"build_index_sharded's {bad} differ from phase 3's")
    out["build"] = dict(s=t1 - t0, finish_s=t1 - rec.pop("finish_t0"),
                        finish_peak_gib=torch.cuda.max_memory_allocated()
                        / 2**30, staged=pmesh.STAGED_BYTES - staged, **rec)
    del built
    torch.cuda.empty_cache()

    fmi = parallel.replicate_index(
        bwt_tpu_torch.read_npz_index(workdir / "index.npz", device=dev),
        serve)
    svc, rsvc = QueryService(fmi, codes), QueryService(fmi)

    def search_step():
        p, ln = parallel.shard_patterns(step["pats"], step["lens"], serve)
        pos, counts, total = parallel.sharded_search_step(fmi, p, ln, serve)
        return (parallel.gather_hits(pos, serve),
                parallel.host_fetch([counts], serve)[0], int(total))

    def step_ok(got):
        return (np.array_equal(got[0], step["pos"])
                and np.array_equal(got[1], step["counts"])
                and got[2] == int((step["pos"] >= 0).sum()))

    def aligned(kind):
        return lambda: _norm(aligner.align_reads(
            fmi, codes, align[kind][0], service=svc, with_strand=True,
            mesh=serve))

    paths = (
        ("search_step", search_step, step_ok),
        ("search_reads", lambda: exact.search_reads(fmi, sr_reads,
                                                    mesh=serve),
         lambda got: all(np.array_equal(got[k], sr[k]) for k in sr)),
        ("align_subst", aligned("subst"),
         lambda got: got == align["subst"][1]),
        ("align_indel", aligned("indel"),
         lambda got: got == align["indel"][1]),
        ("rna_seq", lambda: rnaseq.rna_seq(fmi, rna["reads"], service=rsvc,
                                           mesh=serve),
         lambda got: np.array_equal(got, rna["pos"])))
    for name, fn, ok in paths:
        runs = []
        for _ in range(2):
            dist.barrier()
            _mesh_counts(zero=True)
            merge, staged = pmesh.MERGE_S, pmesh.STAGED_BYTES
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _mesh_counts()
            require(ok(got), f"{name} over the mesh differs from the "
                             f"single-device run")
            runs.append(dict(s=wall, merge_s=pmesh.MERGE_S - merge,
                             staged=pmesh.STAGED_BYTES - staged,
                             launches=counts))
            missing = [k for k in MESH_NEEDS[name] if counts[k] == 0]
            require(not missing, f"{name}: rank {out['rank']} launched no "
                                 f"{missing} ({counts})")
        out["paths"][name] = runs
    require(out["paths"]["align_subst"][0]["launches"]["K5"] == 1,
            "the first aligner run did not build its seed table by one K5 "
            "launch")
    del fmi, svc, rsvc
    torch.cuda.empty_cache()
    if world > 1:
        out["tp"] = _tp_rank(workdir, world, dev, step, sr, sr_reads, align,
                             rna)
    dist.barrier()
    return out


# phase 11's tp meshes (dp, tp) in the gloo world of four ranks on one card
TP_MESHES = ((1, 4), (2, 2))
TP_SMALL = (16, 1 << 10)  # the tp kernels against the plain tp path:
                          # a 2^16-base genome, 2^10 reads a kernel
# the kernels each tp path must launch through the view, in each run
TP_NEEDS = {"tp_locate": ("K3", "K4"), "search_step": ("K3", "K4"),
            "search_reads": ("anchor_scan",),
            "align_subst": ("K10", "K11a", "K11b"),
            "align_indel": ("K10", "K11a", "K11b"), "rna_seq": ("K9",)}
TP_TIME_REPS = 10


def _card_bytes(fmi) -> int:
    """The card's bytes an index holds: its tensors on a card, and a tp
    view's device tables of block pointers."""
    import torch

    ts = [getattr(fmi, f) for f in ("bwt_words", "buckets", "sa_samples",
                                    "isa_samples", "C", "endloc")]
    if fmi.shard is not None and fmi.shard.tables:
        ts += list(fmi.shard.tables.values())
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor) and t.device.type == "cuda")


def _tp_rank(workdir: Path, world: int, dev, step, sr, sr_reads, align,
             rna) -> dict:
    """One rank's tp meshes of phase 11: for each of TP_MESHES, the index
    loaded from its npz on the host, shard_index + tp_view (the card's
    bytes the view holds beside the whole index's), then twice each
    tp_locate + gather_hits and sharded_search_step on phase 4's 30-mers,
    search_reads on phase 8's reads, align_reads on phase 5's two kinds
    and rna_seq on phase 10's, each equal to the single-device run, with
    its launches through the view; then the tp kernels against the plain
    tp path (the gloo all-reduces) on a 2^16-base genome, 2^10 reads each,
    tolerance 0.  On the first mesh, rank 0 then times each tp kernel at
    the main path's shapes beside the replicated kernel on the same
    inputs, while the others wait at a barrier with their blocks mapped."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import bwt_tpu_torch
    from bwt_tpu_torch import parallel
    from bwt_tpu_torch.models import aligner, exact, rnaseq
    from bwt_tpu_torch.models.batch_exec import QueryService
    from bwt_tpu_torch.parallel import mesh as pmesh

    codes = np.load(workdir / "genome.npy")
    host = bwt_tpu_torch.read_npz_index(workdir / "index.npz", device="cpu")
    whole = sum(getattr(host, f).numel() * 4 for f in (
        "bwt_words", "buckets", "sa_samples", "isa_samples", "C", "endloc"))
    rank = dist.get_rank()
    out = {}
    for dp, tp in TP_MESHES:
        mesh = parallel.make_mesh(world, tp=tp, device=dev)
        dist.barrier()
        t0 = time.perf_counter()
        view = parallel.tp_view(parallel.shard_index(host, mesh))
        torch.cuda.synchronize()
        rec = dict(shard_s=time.perf_counter() - t0, held=_card_bytes(view),
                   whole=whole, paths={})
        svc, rsvc = QueryService(view, codes), QueryService(view)

        def tp_locate():
            p, ln = parallel.shard_patterns(step["pats"], step["lens"], mesh)
            pos, counts = parallel.tp_locate(view, p, ln, mesh)
            return (parallel.gather_hits(pos, mesh),
                    parallel.host_fetch([counts], mesh)[0])

        def search_step():
            p, ln = parallel.shard_patterns(step["pats"], step["lens"], mesh)
            pos, _, total = parallel.sharded_search_step(view, p, ln, mesh)
            return parallel.gather_hits(pos, mesh), int(total)

        def aligned(kind):
            return lambda: _norm(aligner.align_reads(
                view, codes, align[kind][0], service=svc, with_strand=True,
                mesh=mesh))

        paths = (
            ("tp_locate", tp_locate,
             lambda got: (np.array_equal(got[0], step["pos"])
                          and np.array_equal(got[1], step["counts"]))),
            ("search_step", search_step,
             lambda got: (np.array_equal(got[0], step["pos"])
                          and got[1] == int((step["pos"] >= 0).sum()))),
            ("search_reads", lambda: exact.search_reads(view, sr_reads,
                                                        mesh=mesh),
             lambda got: all(np.array_equal(got[k], sr[k]) for k in sr)),
            ("align_subst", aligned("subst"),
             lambda got: got == align["subst"][1]),
            ("align_indel", aligned("indel"),
             lambda got: got == align["indel"][1]),
            ("rna_seq", lambda: rnaseq.rna_seq(view, rna["reads"],
                                               service=rsvc, mesh=mesh),
             lambda got: np.array_equal(got, rna["pos"])))
        for name, fn, ok in paths:
            runs = []
            for _ in range(2):
                dist.barrier()
                _mesh_counts(zero=True)
                tp_launches(zero=True)
                merge = pmesh.MERGE_S
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = {**_mesh_counts(), **tp_launches()}
                require(ok(got), f"{name} over the tp view (dp {dp}, tp {tp}) "
                                 f"differs from the single-device run")
                missing = [k for k in TP_NEEDS[name] if counts[k] == 0]
                require(not missing, f"{name} over the tp view: rank {rank} "
                                     f"launched no {missing} ({counts})")
                runs.append(dict(s=wall, merge_s=pmesh.MERGE_S - merge,
                                 launches=counts))
            rec["paths"][name] = runs
        del svc, rsvc

        if (dp, tp) == TP_MESHES[0]:
            rec["wide"] = _tp_wide(workdir, mesh, dev, step)
            rec["small"] = _tp_small(mesh, dev)
            dist.barrier()
            if rank == 0:
                rec["times"] = _tp_times(host, view, codes, step, sr_reads,
                                         align, rna)
            dist.barrier()  # the others wait here, their blocks mapped
        parallel.release_view(view)
        torch.cuda.empty_cache()
        out[f"dp{dp}tp{tp}"] = rec
    return out


TP_WIDE_READS = 1 << 16  # phase 4's 30-mers the wide tp case serves


def _tp_wide(workdir: Path, mesh, dev, step) -> dict:
    """The wide index over the tp mesh: its npz loaded on the host,
    shard_index + tp_view (blocks of its rows32, derived on each rank from
    its block of the 12-int rows, and the whole bases), sharded_search_step
    on TP_WIDE_READS of phase 4's 30-mers through the view's K3 and K4,
    equal to the replicated wide kernels on the whole wide index on this
    card and to the int32 single-device run, positions int64."""
    import numpy as np
    import torch

    import bwt_tpu_torch
    from bwt_tpu_torch import parallel
    from bwt_tpu_torch.ops import rank as rank_ops

    host = bwt_tpu_torch.read_npz_index(workdir / "wide.npz", device="cpu")
    require(host.wide, "wide.npz is not the wide layout")
    m = TP_WIDE_READS
    pats, lens = step["pats"][:m], step["lens"][:m]
    view = parallel.tp_view(parallel.shard_index(host, mesh))
    require(view.rows32 is not None and view.rows32.shape[0]
            == view.shard.bucket_per and "rows32" in view.shard.tables
            and view.bases.shape[0]
            == rank_ops.superblocks(host.bucket_rows) + 1,
            "the wide tp view lacks its block of rows32 or the whole bases")
    p, ln = parallel.shard_patterns(pats, lens, mesh)
    tp_launches(zero=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pos, counts, total = parallel.sharded_search_step(view, p, ln, mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tp_launches()
    require(launches["K3"] > 0 and launches["K4"] > 0,
            f"sharded_search_step over the wide view launched no K3 or K4: "
            f"{launches}")
    whole = host.to(dev)
    rpos, rcounts, rtotal = parallel.sharded_search_step(whole, p, ln, mesh)
    got = parallel.gather_hits(pos, mesh)
    require(pos.dtype == torch.int64 and torch.equal(pos, rpos)
            and torch.equal(counts, rcounts) and int(total) == int(rtotal)
            and np.array_equal(got, step["pos"][:m]),
            "sharded_search_step over the wide tp view differs from the "
            "replicated wide kernels or the int32 run")
    parallel.release_view(view)
    del whole
    torch.cuda.empty_cache()
    return dict(n=m, s=wall, launches=launches)


def _tp_small(mesh, dev) -> dict:
    """The nine tp kernels against the plain tp path (the gloo all-reduces)
    over a view of a 2^16-base genome's index, 2^10 reads each, tolerance
    0."""
    import numpy as np

    import bwt_tpu_torch
    from bwt_tpu_torch import parallel

    bits, n = TP_SMALL
    rng = np.random.default_rng(bits)
    small_codes = rng.integers(0, 4, 1 << bits).astype(np.uint8)
    small = bwt_tpu_torch.build_index(small_codes, sa_sample_rate=8,
                                      device="cpu")
    sview = parallel.tp_view(parallel.shard_index(small, mesh))
    x = tp_inputs(small, small_codes, rng, dev, n)
    plain = tp_cases(sview, x, plain=True)
    checked = {}
    t0 = time.perf_counter()
    for name, fn in tp_cases(sview, x).items():
        tp_launches(zero=True)
        got = tp_outcome(fn)
        launched = tp_launches()[name]
        want = tp_outcome(plain[name])
        require(tp_equal(got, want), f"the tp form of {name} differs "
                                     f"from the plain tp path")
        require(launched > 0, f"{name} over the view launched nothing")
        checked[name] = "raised" if isinstance(got, type) else "equal"
    parallel.release_view(sview)
    return dict(s=time.perf_counter() - t0, checked=checked)


def _tp_times(host, view, codes, step, sr_reads, align, rna) -> dict:
    """Each tp kernel on ``view`` at the main path's shapes beside the
    same kernel over a view of as many blocks allocated in this process
    (``view_in_process``: the form without IPC mappings) and the
    replicated kernel on the whole index on this card, the same inputs:
    {kernel: {tp_ms, local_ms, replicated_ms, runs, shape}}.  K3 and locate on phase 4's
    2^20 30-mers, K4 on 2^20 rows, the anchor hunt on a search_reads chunk
    of phase 8's reads (uint8, reversed, min_anchor 20), K5 at k = 12, K6
    on 2^16 windows of widths 0..32, K7 on a fuzzed round of 2^16 lanes
    (ext, resolve), K9 and K10 on a chunk of phase 10's and of phase 5's
    substitution reads."""
    import numpy as np
    import torch

    from bwt_tpu_torch.config import DEFAULT
    from bwt_tpu_torch.ops import automaton, search, service

    dev = view.device
    whole = host.to(dev)
    rng = np.random.default_rng(1)
    n = whole.length
    chunk = DEFAULT.search_batch
    kmers = torch.from_numpy(step["pats"]).to(dev)
    klens = torch.from_numpy(step["lens"]).to(dev)
    rows = torch.from_numpy(np.concatenate([
        [0, int(whole.endloc), n], rng.integers(0, n + 1, 1 << 20)])
        .astype(np.int32)).to(dev)
    creads = torch.from_numpy(np.ascontiguousarray(sr_reads[:1 << 15])).to(dev)
    clens = torch.full((creads.shape[0],), creads.shape[1], dtype=torch.int32,
                       device=dev)
    plo = torch.from_numpy(rng.integers(-40, n + 40, 1 << 16)
                           .astype(np.int32)).to(dev)
    wid = torch.from_numpy(rng.integers(0, 33, 1 << 16).astype(np.int32)
                           ).to(dev)
    bank, fields = service_lanes(rng, codes, 1 << 16)
    bank = torch.from_numpy(bank).to(dev)
    fields = torch.from_numpy(fields).to(dev).unbind(0)
    table = search.build_seed_table(whole, k=SEED_K)
    rb = automaton_bank(whole, rna["reads"][:chunk], "rna")
    ab = automaton_bank(whole, align["subst"][0][:chunk], "align")

    def cases(fmi):
        return {
            "K3": (lambda: search.backward_search(fmi, kmers, klens),
                   f"B={kmers.shape[0]} L=30"),
            "K4": (lambda: search.unc_sa(fmi, rows), f"B={rows.shape[0]}"),
            "locate": (lambda: search.locate_kernel(fmi, kmers, klens),
                       f"B={kmers.shape[0]} L=30"),
            "anchor_scan": (lambda: search.anchor_scan_kernel(
                fmi, creads, clens, min_anchor=20, reverse=True),
                f"B={creads.shape[0]} L={creads.shape[1]} uint8 reversed"),
            "K5": (lambda: search._seed_rows(fmi, SEED_K), f"k={SEED_K}"),
            "K6": (lambda: search.isa_window(fmi, plo, wid),
                   f"B={plo.shape[0]} W=32"),
            "K7": (lambda: service.service_round_packed(
                fmi, bank, *fields, resolve=True, ext=True, walk=True),
                f"B={fields[0].shape[0]}"),
            "K9": (lambda: automaton.rna_seq_automaton_packed(
                fmi, *rb[:3], table.rows, ac=DEFAULT.rnaseq_anchor_cutoff,
                cc=DEFAULT.rnaseq_cont_cutoff, resolve=rb[3],
                seed_k=table.k), f"R={rb[0].shape[0]}"),
            "K10": (lambda: automaton.align_automaton_packed(
                fmi, *ab[:3], fmi.length, table.rows,
                anchor_len=DEFAULT.anchor_len, resolve=ab[3],
                seed_k=table.k), f"Bp={ab[1].shape[0]}"),
        }

    from bwt_tpu_torch import parallel

    local = parallel.mesh.view_in_process(whole, view.shard.size)
    out = {}
    forms = dict(tp=cases(view), local=cases(local), replicated=cases(whole))
    for name in forms["tp"]:
        want = tp_outcome(lambda: [torch.as_tensor(t) for t in _flat(
            forms["replicated"][name][0]())])
        for form in ("tp", "local"):
            got = tp_outcome(lambda: [torch.as_tensor(t) for t in _flat(
                forms[form][name][0]())])
            require(tp_equal(got, want), f"the tp form of {name} ({form}) "
                                         f"differs from the replicated kernel")
        runs = {f"{form} {r}": cuda_ms(forms[form][name][0], TP_TIME_REPS,
                                       ahead=True)
                for r in (1, 2) for form in forms}
        out[name] = {f"{form}_ms": (runs[f"{form} 1"] + runs[f"{form} 2"]) / 2
                     for form in forms}
        out[name].update(runs=runs, shape=forms["tp"][name][1])
    parallel.release_view(local)
    del whole, table
    torch.cuda.empty_cache()
    return out


def _flat(out):
    """A wrapper's outputs as a list of tensors (a dict's values, a tuple,
    one tensor)."""
    import torch

    if isinstance(out, dict):
        return [v for v in out.values() if isinstance(v, torch.Tensor)]
    if isinstance(out, torch.Tensor):
        return [out]
    return list(out)


def mesh_child(workdir: Path, backend: str, world: int, rank: int,
               tp_only: bool = False) -> int:
    """A rank of the mesh phase (``--mesh-child``): joins the world, runs
    :func:`_mesh_rank` and writes its JSON beside the inputs."""
    import torch.distributed as dist

    from bwt_tpu_torch import parallel

    parallel.init_distributed(
        backend=backend, init_method=f"file://{workdir}/rdv_{backend}{world}",
        world_size=world, rank=rank, timeout=MESH_TIMEOUT_S)
    try:
        out = _mesh_rank(workdir, world, tp_only=tp_only)
        (workdir / f"rank_{backend}{world}_{rank}.json").write_text(
            json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def mesh_world(workdir: Path, backend: str, world: int,
               tp_only: bool = False) -> list:
    """Start a world's ranks together (``chip_smoke.py --mesh-child``),
    wait for all; a rank that fails or overruns fails the phase, and the
    ranks still running are killed.  Returns each rank's JSON."""
    procs = []
    try:
        for r in range(world):
            with open(workdir / f"rank_{backend}{world}_{r}.log", "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()),
                     "--mesh-child", str(workdir), "--mesh-backend", backend,
                     "--mesh-world", str(world), "--mesh-rank", str(r),
                     *(["--mesh-tp-only"] if tp_only else [])],
                    cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + MESH_TIMEOUT_S + 60
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break  # the others would wait in a collective
            if time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        log = (workdir / f"rank_{backend}{world}_{bad[0]}.log").read_text()
        raise SmokeFailure(f"mesh {backend} x {world}: ranks {bad} failed or "
                           f"ran past {MESH_TIMEOUT_S + 60} s; rank "
                           f"{bad[0]}'s log ends:\n{log[-3000:]}")
    return [json.loads((workdir / f"rank_{backend}{world}_{r}.json")
                       .read_text()) for r in range(world)]


def phase_mesh(fmi, codes_np, keep, tag, workdir: Path, build_peak_gib,
               tp_only: bool = False, wide=None):
    """Phase 11: bwt_tpu_torch.parallel on the card, in child processes
    (the parent's state untouched): a world of one rank over NCCL, then
    four ranks sharing the card over gloo, each rank a process of its own
    on cuda:0.  Every rank builds the 2^25-base index with the sharded sort
    (tp = world; one rank takes the single-device sort) and holds its SA
    and arrays to phase 3's, then runs sharded_search_step + gather_hits on
    phase 4's 30-mers, search_reads, align_reads (both kinds of read) and
    rna_seq with mesh= (dp = world), each equal to the single-device run
    of phases 4, 5, 8 and 10 on every rank; in the gloo world, then the tp
    meshes (:func:`_tp_rank`; with ``tp_only`` the gloo world runs them
    alone; the first tp mesh also serves the wide index, phase 12's or,
    without ``wide``, one built here)."""
    import shutil

    t0 = time.perf_counter()
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    _mesh_inputs(workdir, fmi, codes_np, keep, wide)
    report = dict(inputs_s=time.perf_counter() - t0, worlds={})
    worlds = [w for w in MESH_WORLDS if w[1] > 1] if tp_only else MESH_WORLDS
    for backend, world in worlds:
        t1 = time.perf_counter()
        ranks = mesh_world(workdir, backend, world, tp_only)
        wall = time.perf_counter() - t1
        report["worlds"][f"{backend}x{world}"] = dict(s=wall, ranks=ranks)
        shared = ("; the ranks share one card, so these walls are no "
                  "scaling number" if world > 1 else "")
        if world > 1:
            _print_tp(ranks, len(codes_np), tag)
        if tp_only:
            continue
        b = [r["build"] for r in ranks]
        print(f"phase 11 mesh {backend} x {world} ({wall:.1f} s with the "
              f"processes' start): build_index_sharded n={len(codes_np)} "
              f"sa_rate=4 over tp={world}: the SA and every index array "
              f"equal to phase 3's on every rank; per rank: sort "
              + ", ".join(f"{x['sort_s']:.3f}" for x in b) + " s, peak "
              + ", ".join(f"{x['sort_peak_gib']:.3f}" for x in b)
              + " GiB; finish " + ", ".join(f"{x['finish_s']:.3f}" for x in b)
              + " s, peak " + ", ".join(f"{x['finish_peak_gib']:.3f}"
                                        for x in b)
              + f" GiB (phase 3's single-device build: peak "
                f"{build_peak_gib:.3f} GiB); staged "
              + ", ".join(str(x["staged"]) for x in b) + f" bytes{shared} "
              f"{tag}", flush=True)
        for name in MESH_NEEDS:
            per = [r["paths"][name] for r in ranks]
            shown = MESH_NEEDS[name] + (("K5",) if name == "align_subst"
                                        else ())
            print(f"phase 11 mesh {backend} x {world} {name}: equal to the "
                  f"single-device run on every rank; per rank, first run / "
                  f"second: wall " + ", ".join(
                      f"{a['s']:.4f} / {w['s']:.4f}" for a, w in per)
                  + " s, the merge's share " + ", ".join(
                      f"{a['merge_s'] / a['s']:.3f} / "
                      f"{w['merge_s'] / w['s']:.3f}" for a, w in per)
                  + ", launches " + "; ".join(
                      " ".join(f"{k} {a['launches'][k]}/{w['launches'][k]}"
                               for k in shown) for a, w in per)
                  + ", staged " + ", ".join(
                      f"{a['staged']} / {w['staged']}" for a, w in per)
                  + f" bytes{shared} {tag}", flush=True)
    return report


def _print_tp(ranks, n, tag) -> None:
    """Phase 11's lines for the tp meshes of a world's ranks."""
    for key, rec0 in ranks[0]["tp"].items():
        recs = [r["tp"][key] for r in ranks]
        print(f"phase 11 tp {key}: shard_index + tp_view of the {n}-base "
              f"index from its npz on the host, per rank "
              + ", ".join(f"{r['shard_s']:.3f}" for r in recs)
              + " s; the card holds " + ", ".join(
                  f"{r['held']} ({r['held'] / r['whole']:.4f})" for r in recs)
              + f" bytes of the view (share of the whole index's "
                f"{rec0['whole']} bytes) {tag}", flush=True)
        for name in TP_NEEDS:
            per = [r["paths"][name] for r in recs]
            shown = TP_NEEDS[name] + ("K5", "K7")
            print(f"phase 11 tp {key} {name}: equal to the single-device run "
                  f"on every rank; per rank, first run / second: wall "
                  + ", ".join(f"{a['s']:.4f} / {w['s']:.4f}" for a, w in per)
                  + " s, the merge's share " + ", ".join(
                      f"{a['merge_s'] / a['s']:.3f} / "
                      f"{w['merge_s'] / w['s']:.3f}" for a, w in per)
                  + ", launches through the view " + "; ".join(
                      " ".join(f"{k} {a['launches'][k]}/{w['launches'][k]}"
                               for k in shown) for a, w in per)
                  + f"; the ranks share one card {tag}", flush=True)
        if "wide" in rec0:
            per = [r["wide"] for r in recs]
            print(f"phase 11 tp {key} wide index: sharded_search_step of "
                  f"{rec0['wide']['n']} 30-mers over a tp view of the wide "
                  f"(int64) index, equal on every rank to the replicated "
                  f"wide kernels and the int32 run; per rank wall "
                  + ", ".join(f"{w['s']:.4f}" for w in per)
                  + " s, K3 / K4 launches through the view " + ", ".join(
                      f"{w['launches']['K3']} / {w['launches']['K4']}"
                      for w in per) + f" {tag}", flush=True)
        if "small" in rec0:
            small = rec0["small"]
            print(f"phase 11 tp {key} kernels against the plain tp path (the "
                  f"gloo all-reduces) on a 2^{TP_SMALL[0]}-base genome, "
                  f"{TP_SMALL[1]} reads a kernel: "
                  + ", ".join(f"{k} {v}" for k, v in small["checked"].items())
                  + f", tolerance 0, on every rank ({small['s']:.1f} s on "
                    f"rank 0) {tag}", flush=True)
        for name, t in rec0.get("times", {}).items():
            print(f"phase 11 tp {key} time of {name} {t['shape']} on rank 0, "
                  f"the others at a barrier with their blocks mapped (one "
                  f"card: no NVLink latency): tp view {t['tp_ms']:.4f} ms, "
                  f"a view of blocks allocated in this process "
                  f"{t['local_ms']:.4f} ms, replicated "
                  f"{t['replicated_ms']:.4f} ms on the same inputs (ratios "
                  f"{t['tp_ms'] / t['replicated_ms']:.3f}, "
                  f"{t['local_ms'] / t['replicated_ms']:.3f}; runs "
                  + ", ".join(f"{k} {v:.4f}" for k, v in t["runs"].items())
                  + f" ms) {tag}", flush=True)


def mesh_only(bits: int, seed: int = 0, tp_only: bool = False) -> dict:
    """Phase 11 alone (``--mesh-only BITS``): a 2^BITS-base random genome
    and its index at sa_rate 4, then phase 4, 5, 8 and 10's inputs at their
    sizes and by their recipes, with their single-device outputs, then the
    mesh phase on them."""
    import numpy as np
    import torch

    import bwt_tpu_torch
    from bwt_tpu_torch.models import aligner, exact, rnaseq
    from bwt_tpu_torch.models.batch_exec import QueryService
    from bwt_tpu_torch.ops import search

    tag = f"[{card_line()}]"
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=1 << bits).astype(np.uint8)
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    fmi = bwt_tpu_torch.build_index(codes, sa_sample_rate=4, device=dev)
    peak = torch.cuda.max_memory_allocated() / 2**30
    starts = rng.integers(0, len(codes) - 30, size=1 << 20)
    pats = torch.from_numpy(codes[np.add.outer(starts, np.arange(30))]
                            .astype(np.int32)).to(dev)
    lens = torch.full((1 << 20,), 30, dtype=torch.int32, device=dev)
    keep = dict(kmers=(pats, lens),
                locate_pos=search.locate(fmi, pats, lens).cpu().numpy(),
                counts=search.count_matches(fmi, pats, lens).cpu().numpy())
    svc = QueryService(fmi, codes)
    keep["align"] = {
        what: (r, _norm(aligner.align_reads(fmi, codes, r, service=svc,
                                            with_strand=True)))
        for what, r in (("subst", mutated_reads(rng, codes, 1 << 16)[1]),
                        ("indel", indel_reads(rng, codes, 4096)[1]))}
    starts = rng.integers(0, len(codes) - 50, size=1 << 20)
    sr = codes[np.add.outer(starts, np.arange(50))]
    keep["search_reads"] = (sr, exact.search_reads(fmi, sr))
    rr = complemented_reads(rng, codes, 1 << 16)[1]
    keep["rna_seq"] = (rr, rnaseq.rna_seq(fmi, rr, service=QueryService(fmi)))
    return phase_mesh(fmi, codes, keep, tag,
                      ROOT / "build" / "chip_smoke" / "mesh", peak, tp_only)


ELASTIC_BITS = 16
ELASTIC_READS = dict(align=512, rna=1024, search=1024)
ELASTIC_BATCH = 512      # config.search_batch: two chunks of 1,024 reads
ELASTIC_TIMEOUT_S = 300  # the child's wall
ELASTIC_SURFACES = ("build_index", "align_reads", "rna_seq", "search_reads")
# (a)'s failed launch on the card: the launcher and the call of it that
# refuses (the second chunk's, with the first one's work in flight), or,
# for the build, which launches no kernel, its suffix sort
ELASTIC_INJECT = dict(align_reads=("compose_launch", 1),
                      rna_seq=("rnaseq_automaton_launch", 2),
                      search_reads=("anchor_scan_launch", 3),
                      build_index=("suffix_array_with_isa", 1))


@contextlib.contextmanager
def failing_launch(surface: str, code: int = 719):
    """(a)'s injected failure of ``surface`` on the card (ELASTIC_INJECT):
    a launch the library refuses with CUDA error ``code``
    (``ops._kernels.refusing``; 719, cudaErrorLaunchFailure, a device
    failure), or the build's sort raising ``KernelLaunchError`` once."""
    from bwt_tpu_torch.ops import _kernels, suffix

    name, nth = ELASTIC_INJECT[surface]
    if surface == "build_index":
        orig, calls = suffix.suffix_array_with_isa, []

        def sort(*a, **kw):
            calls.append(1)
            if len(calls) == nth:
                raise _kernels.KernelLaunchError("injected device failure")
            return orig(*a, **kw)

        suffix.suffix_array_with_isa = sort
        try:
            yield
        finally:
            suffix.suffix_array_with_isa = orig
        return
    with _kernels.refusing(name, nth, code):
        yield


def elastic_inputs(seed: int) -> dict:
    """The elastic phase's inputs, made from ``seed``: a 2^16-base random
    genome and, cut from it by phase 5, 10 and 8's recipes, 80-bp reads
    with one substitution, 50-bp reads with one base complemented and
    unmutated 50-bp reads."""
    import numpy as np

    rng = np.random.default_rng([seed, 16])
    codes = rng.integers(0, 4, size=1 << ELASTIC_BITS).astype(np.uint8)
    starts = rng.integers(0, len(codes) - 50, size=ELASTIC_READS["search"])
    return dict(
        codes=codes,
        align=mutated_reads(rng, codes, ELASTIC_READS["align"])[1],
        rna=complemented_reads(rng, codes, ELASTIC_READS["rna"])[1],
        search=codes[np.add.outer(starts, np.arange(50))])


def elastic_run(surface: str, x: dict, fmi, config):
    """One call of ``surface`` on the elastic phase's inputs, its output
    made comparable (the index's arrays, the alignments' rendered CIGARs)."""
    import bwt_tpu_torch
    from bwt_tpu_torch.models import aligner, exact, rnaseq

    if surface == "build_index":
        dev = None if fmi is None else fmi.device
        return bwt_tpu_torch.build_index(x["codes"], sa_sample_rate=4,
                                         config=config,
                                         device=dev).to_numpy()
    if surface == "align_reads":
        return _norm(aligner.align_reads(fmi, x["codes"], x["align"],
                                         config=config, with_strand=True))
    if surface == "rna_seq":
        return rnaseq.rna_seq(fmi, x["rna"], config=config)
    return exact.search_reads(fmi, x["search"], config=config)


def elastic_equal(a, b) -> bool:
    import numpy as np

    if a is None or b is None:
        return False
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(elastic_equal(a[k], b[k]) for k in a))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    return a == b


def elastic_call(surface: str, x: dict, fmi, config) -> dict:
    """``surface`` called once with its stderr captured: its output or the
    error it raised, its wall and its recovery lines."""
    import io

    from bwt_tpu_torch.ops import _kernels

    err = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(err):
            out = dict(out=elastic_run(surface, x, fmi, config))
    except RuntimeError as e:
        out = dict(raised=type(e).__name__,
                   device_failure=_kernels.device_failure(e), message=str(e))
    out.update(s=time.perf_counter() - t0, lines=[
        ln for ln in err.getvalue().splitlines()
        if "(config.elastic_fallback)" in ln])
    return out


def elastic_child(workdir: Path) -> int:
    """The elastic phase's child (``--elastic-child``).  (a) On the card,
    each surface three times: as it is, with an injected failure and the
    flag (its output must equal the first run's, with one stderr line),
    and with the failure without the flag (the error must reach the
    caller); and, but for the build, a fourth with the launch refused for
    its arguments and the flag (a plain RuntimeError must reach the
    caller).  (b) Then a real sticky fault: a launcher of the library
    given an invalid device pointer, and a synchronise, which must raise
    torch.AcceleratorError; after it, with the flag, build_index and
    align_reads must give the CPU's values without the card, and
    search_reads and rna_seq, whose index lives on the dead card, must
    raise a device error.  Prints its checks as one JSON line (``ELASTIC
    {...}``) and leaves with ``os._exit``: the process's CUDA state is
    poisoned, and its teardown is not what is checked."""
    import dataclasses
    import os
    import pickle

    import torch

    import bwt_tpu_torch
    from bwt_tpu_torch.config import DEFAULT
    from bwt_tpu_torch.ops import _kernels, search

    x, want = pickle.loads((workdir / "inputs.pkl").read_bytes())
    plain = dataclasses.replace(DEFAULT, search_batch=ELASTIC_BATCH)
    flag = dataclasses.replace(plain, elastic_fallback=True)
    dev = torch.device("cuda")
    _kernels.library()
    fmi = bwt_tpu_torch.build_index(x["codes"], sa_sample_rate=4, device=dev)
    report = dict(injected={}, fault={}, after={})
    for surface in ELASTIC_SURFACES:
        idx = fmi if surface != "build_index" else None
        base = elastic_call(surface, x, idx, plain)
        with failing_launch(surface):
            got = elastic_call(surface, x, idx, flag)
        with failing_launch(surface):
            bare = elastic_call(surface, x, idx, plain)
        own = {}
        if surface != "build_index":
            # a launch refused for its own arguments (1,
            # cudaErrorInvalidValue) is no device failure
            with failing_launch(surface, code=1):
                own = elastic_call(surface, x, idx, flag)
        report["injected"][surface] = dict(
            card_equals_cpu=elastic_equal(base.get("out"), want[surface]),
            recovered_equal=elastic_equal(got.get("out"), base.get("out")),
            lines=got["lines"], raised_without_flag=bare.get("raised"),
            own_fault=dict(raised=own.get("raised"),
                           device_failure=own.get("device_failure"),
                           lines=own.get("lines")),
            card_s=base["s"], recovered_s=got["s"],
            errors=[r["message"] for r in (base, got) if "raised" in r])
    torch.cuda.synchronize()

    # (b) a real fault: K5's launcher reading its index at address 0x10
    bad = 0x10
    out = torch.empty((4 ** 2, 6), dtype=torch.int32, device=dev)
    err = _kernels.library().seed_rows_launch(
        2, bad, fmi.buckets.shape[0], 0, bad, bad, out.data_ptr(),
        search._stream(dev))
    fault = dict(launch_error=err)
    try:
        torch.cuda.synchronize()
        fault["raised"] = None
    except Exception as e:  # what the synchronise raises is the check
        fault.update(raised=type(e).__name__,
                     accelerator=isinstance(e, torch.AcceleratorError),
                     device_failure=_kernels.device_failure(e))
    try:
        (torch.ones(1, device=dev) + 1).cpu()
        fault["sticky"] = False
    except Exception as e:  # the next CUDA call must fail too
        fault["sticky"] = _kernels.device_failure(e)
    fault["cuda_available"] = torch.cuda.is_available()
    report["fault"] = fault
    for surface in ELASTIC_SURFACES:
        got = elastic_call(surface, x, fmi if surface != "build_index"
                           else None, flag)
        report["after"][surface] = dict(
            equal=elastic_equal(got.get("out"), want[surface]),
            raised=got.get("raised"),
            device_failure=got.get("device_failure"), lines=got["lines"],
            s=got["s"], message=got.get("message"))
    print("ELASTIC " + json.dumps(report), flush=True)
    sys.stderr.flush()
    os._exit(0)


def phase_elastic(tag, seed: int = 0,
                  workdir: Path = ROOT / "build" / "chip_smoke" / "elastic"):
    """The elastic phase (config.elastic_fallback), in a child process so
    that the sticky fault it makes never reaches this one: the inputs and
    their outputs on the CPU are made here and passed by file, the child
    (:func:`elastic_child`) runs the checks on the card, and its JSON line
    is held to them here."""
    import pickle
    import shutil

    import bwt_tpu_torch

    t0 = time.perf_counter()
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    x = elastic_inputs(seed)
    cpu = bwt_tpu_torch.build_index(x["codes"], sa_sample_rate=4,
                                    device="cpu")
    want = {s: elastic_run(s, x, cpu if s != "build_index" else None, None)
            for s in ELASTIC_SURFACES if s != "build_index"}
    want["build_index"] = cpu.to_numpy()
    (workdir / "inputs.pkl").write_bytes(pickle.dumps((x, want)))
    cpu_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    try:
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--elastic-child",
             str(workdir)], cwd=ROOT, capture_output=True, text=True,
            timeout=ELASTIC_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise SmokeFailure(f"elastic: the child ran past "
                           f"{ELASTIC_TIMEOUT_S} s") from e
    child_s = time.perf_counter() - t1
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("ELASTIC ")]
    require(res.returncode == 0 and len(lines) == 1,
            f"elastic: the child exited {res.returncode} without its line; "
            f"stderr ends:\n{res.stderr[-3000:]}")
    rep = json.loads(lines[0][len("ELASTIC "):])
    for surface, r in rep["injected"].items():
        require(r["card_equals_cpu"], f"elastic {surface}: the card's run "
                                      f"differs from the CPU's")
        require(r["recovered_equal"] and len(r["lines"]) == 1
                and "KernelLaunchError" in r["lines"][0],
                f"elastic {surface}: the injected failure was not recovered "
                f"with equal output and one line: {r}")
        require(r["raised_without_flag"] == "KernelLaunchError",
                f"elastic {surface}: without the flag the failure did not "
                f"reach the caller: {r}")
        own = r["own_fault"]
        require(surface == "build_index"
                or (own["raised"] == "RuntimeError"
                    and own["device_failure"] is False
                    and own["lines"] == []),
                f"elastic {surface}: a launch refused with CUDA error 1 (an "
                f"argument error) did not reach the caller as a plain "
                f"RuntimeError with the flag set: {r}")
    f = rep["fault"]
    require(f["raised"] == "AcceleratorError" and f["accelerator"]
            and f["device_failure"] and f["sticky"],
            f"elastic: the invalid pointer did not give a sticky "
            f"torch.AcceleratorError: {f}")
    after = rep["after"]
    for surface in ("build_index", "align_reads"):
        r = after[surface]
        require(r["equal"] and len(r["lines"]) == 1,
                f"elastic {surface} after the fault: not the CPU's values "
                f"with one line: {r}")
    for surface in ("search_reads", "rna_seq"):
        r = after[surface]
        require(r["raised"] is not None and r["device_failure"]
                and len(r["lines"]) == 1,
                f"elastic {surface} after the fault: its index lives on the "
                f"dead card, and the device error did not reach the caller "
                f"after its line: {r}")
    inj = rep["injected"]
    print(f"phase 13 elastic ({cpu_s + child_s:.1f} s: the inputs and their "
          f"CPU outputs {cpu_s:.1f} s, the child {child_s:.1f} s), 2^"
          f"{ELASTIC_BITS}-base genome, search_batch {ELASTIC_BATCH}: (a) an "
          f"injected KernelLaunchError (CUDA error 719) recovered with the "
          f"card's own output and one stderr line, and raised without the "
          f"flag, on each surface, and a launch refused with CUDA error 1 "
          f"raised as a plain RuntimeError with the flag; the card's run / "
          f"the recovered run: " + ", ".join(
              f"{s} {r['card_s']:.4f} / {r['recovered_s']:.4f} s"
              for s, r in inj.items())
          + f"; (b) an invalid pointer in K5's launcher: "
            f"{f['raised']} at the synchronise, sticky (the next copy "
            f"fails; torch.cuda.is_available() {f['cuda_available']}); "
            f"then with the flag build_index "
            f"{after['build_index']['s']:.4f} s and align_reads "
            f"{after['align_reads']['s']:.4f} s equal to the CPU's, "
            f"search_reads and rna_seq raising "
            f"{after['search_reads']['raised']} / "
            f"{after['rna_seq']['raised']} after their lines {tag}",
          flush=True)
    return dict(cpu_s=cpu_s, child_s=child_s, **rep)


def phase_profiles(fmi, table, kmers, reads, rna_reads, report, tag,
                   codes_np, align_reads):
    """Phase 9: one torch.profiler window over each exact-search path and
    over the device engines of rna_seq and single_align, after every
    untraced measurement (the profiler, once started, slows every later
    launch of the process).  Adds to ``report`` in place."""
    from bwt_tpu_torch.models import aligner, exact, rnaseq
    from bwt_tpu_torch.models.batch_exec import QueryService
    from bwt_tpu_torch.ops import search

    pats, lens = kmers
    for key, st in (("plain", None), ("seeded", table)):
        prof = device_profile(
            lambda: search.locate(fmi, pats, lens, seed_table=st))
        report["locate"][key].update(
            traced_s=prof["wall_s"], busy_ms=prof["busy_ms"],
            device_ops=prof["ops"])
        names = ", ".join(f"{n} x {k[:40]}"
                          for k, (n, _) in prof["by_name"].items())
        print(f"phase 9 profile of locate {pats.shape[0]} x "
              f"{pats.shape[1]}-mers ({key}): device busy "
              f"{prof['busy_ms']:.4f} ms in {prof['ops']} device ops "
              f"({names}), {prof['wall_s'] * 1e3:.4f} ms traced wall {tag}",
              flush=True)

    # search_reads: the host's encode alone, then a profiled run
    t0 = time.perf_counter()
    exact._encode_batch(reads, narrow=True)
    encode_s = time.perf_counter() - t0
    prof = device_profile(lambda: exact.search_reads(fmi, reads))
    split = dict(kernels=0.0, upload=0.0, download=0.0, other=0.0)
    for name, (_, ms) in prof["by_name"].items():
        kind = ("kernels" if "anchor_scan_kernel" in name
                else "upload" if "Memcpy HtoD" in name
                else "download" if "Memcpy DtoH" in name else "other")
        split[kind] += ms
    wall_ms = prof["wall_s"] * 1e3
    print(f"phase 9 profile of search_reads {reads.shape[0]} x "
          f"{reads.shape[1]} bp, {wall_ms:.3f} ms traced wall: host encode "
          f"{encode_s * 1e3:.3f} ms "
          f"({encode_s * 1e5 / wall_ms:.2f} %), upload {split['upload']:.3f} "
          f"ms ({100 * split['upload'] / wall_ms:.2f} %), anchor_scan "
          f"kernels {split['kernels']:.3f} ms "
          f"({100 * split['kernels'] / wall_ms:.2f} %), download "
          f"{split['download']:.3f} ms "
          f"({100 * split['download'] / wall_ms:.2f} %), other device ops "
          f"{split['other']:.3f} ms; device busy {prof['busy_ms']:.3f} ms "
          f"({100 * prof['busy_ms'] / wall_ms:.2f} %) in {prof['ops']} "
          f"device ops; the rest is the host staging chunks and gathering "
          f"results {tag}", flush=True)
    report["search_reads"].update(
        encode_s=encode_s, traced_s=prof["wall_s"], busy_ms=prof["busy_ms"],
        device_ops=prof["ops"], split_ms=split)

    # rna_seq's device engine: a K9 launch, an upload of the bank and one
    # of the lengths, and one copy back a chunk
    prof = device_profile(lambda: rnaseq.rna_seq(fmi, rna_reads))
    split = dict(kernels=0.0, upload=0.0, download=0.0, other=0.0)
    for name, (_, ms) in prof["by_name"].items():
        kind = ("kernels" if "rnaseq_automaton_kernel" in name
                else "upload" if "Memcpy HtoD" in name
                else "download" if "Memcpy DtoH" in name else "other")
        split[kind] += ms
    wall_ms = prof["wall_s"] * 1e3
    print(f"phase 9 profile of rna_seq {rna_reads.shape[0]} x "
          f"{rna_reads.shape[1]} bp (the device engine), {wall_ms:.3f} ms "
          f"traced wall: K9 {split['kernels']:.3f} ms "
          f"({100 * split['kernels'] / wall_ms:.2f} %), upload "
          f"{split['upload']:.3f} ms, download {split['download']:.3f} ms, "
          f"other device ops {split['other']:.3f} ms; device busy "
          f"{prof['busy_ms']:.3f} ms ({100 * prof['busy_ms'] / wall_ms:.2f} "
          f"%) in {prof['ops']} device ops; the rest is the host {tag}",
          flush=True)
    report["rna_seq"].update(traced_s=prof["wall_s"], busy_ms=prof["busy_ms"],
                             device_ops=prof["ops"], split_ms=split)

    # single_align's device engine: a K10 launch, the job bucketing, the
    # K11a launches and a K11b launch a chunk, the uploads and the copies
    svc = QueryService(fmi, codes_np)
    aligner.align_reads(fmi, codes_np, align_reads[:64], service=svc)
    prof = device_profile(
        lambda: aligner.align_reads(fmi, codes_np, align_reads, service=svc))
    split = dict(K10=0.0, K11a=0.0, K11b=0.0, upload=0.0, download=0.0,
                 other=0.0)
    for name, (_, ms) in prof["by_name"].items():
        kind = ("K10" if "align_automaton_kernel" in name
                else "K11a" if "LogForm" in name
                else "K11b" if "compose_kernel" in name
                else "upload" if "Memcpy HtoD" in name
                else "download" if "Memcpy DtoH" in name else "other")
        split[kind] += ms
    wall_ms = prof["wall_s"] * 1e3
    parts = ", ".join(f"{k} {v:.3f} ms ({100 * v / wall_ms:.2f} %)"
                      for k, v in split.items())
    names = ", ".join(f"{n} x {k[:48]}" for k, (n, _) in
                      sorted(prof["by_name"].items(), key=lambda kv: -kv[1][1]))
    print(f"phase 9 profile of single_align {len(align_reads)} x "
          f"{READ_LEN} bp (the device engine), {wall_ms:.3f} ms traced wall: "
          f"{parts}; device busy {prof['busy_ms']:.3f} ms "
          f"({100 * prof['busy_ms'] / wall_ms:.2f} %) in {prof['ops']} device "
          f"ops ({names}); the rest is the host {tag}", flush=True)
    report["align"].update(traced_s=prof["wall_s"], busy_ms=prof["busy_ms"],
                           device_ops=prof["ops"], split_ms=split)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the measurements as JSON to this file")
    ap.add_argument("--rna-walls", type=int, default=0, metavar="N",
                    help="only time rna_seq's device engine N times "
                         "(rna_walls) and exit")
    ap.add_argument("--rna-profile", type=int, default=0, metavar="N",
                    help="only profile rna_seq's device engine's host time "
                         "over N runs (rna_profile) and exit; with --out, "
                         "its Chrome trace goes there")
    ap.add_argument("--mesh-only", type=int, default=0, metavar="BITS",
                    help="only run phase 11 (the mesh) on a 2^BITS-base "
                         "genome, its inputs and single-device outputs made "
                         "here (mesh_only), and exit")
    ap.add_argument("--tp-only", type=int, default=0, metavar="BITS",
                    help="only run phase 11's tp meshes on a 2^BITS-base "
                         "genome (as --mesh-only, in the gloo world of four "
                         "ranks alone), and exit")
    ap.add_argument("--elastic-only", action="store_true",
                    help="only run the elastic phase (config.elastic_fallback"
                         ", phase 13) and exit")
    ap.add_argument("--wide-times", default="", metavar="BITS,...",
                    help="only time each wide kernel beside the int32 one "
                         "on 2^BITS-base genomes (wide_times) and exit")
    ap.add_argument("--isa-times", type=int, default=0, metavar="BITS",
                    help="only time K6 on phase 7's windows of a 2^BITS-base "
                         "genome at sa_rate 4 and 32 (isa_times) and exit")
    ap.add_argument("--locate-times", type=int, default=0, metavar="BITS",
                    help="only time the fused locate on a 2^BITS-base genome "
                         "beside K3 and K4 and the presorted reads, with its "
                         "counts, and its wide form at 2^BITS and 2^28 "
                         "(locate_times), and exit")
    ap.add_argument("--elastic-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-tp-only", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh-backend", default="gloo", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-world", type=int, default=1,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh-rank", type=int, default=0,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.elastic_child:
        return elastic_child(Path(args.elastic_child))
    if args.elastic_only:
        phase_elastic(f"[{card_line()}]", args.seed)
        return 0
    if args.mesh_child:
        return mesh_child(Path(args.mesh_child), args.mesh_backend,
                          args.mesh_world, args.mesh_rank, args.mesh_tp_only)
    if args.mesh_only or args.tp_only:
        mesh_only(args.mesh_only or args.tp_only, seed=args.seed,
                  tp_only=bool(args.tp_only))
        return 0
    if args.rna_walls:
        rna_walls(args.rna_walls, seed=args.seed)
        return 0
    if args.wide_times:
        wide_times(tuple(int(b) for b in args.wide_times.split(",")),
                   seed=args.seed)
        return 0
    if args.isa_times:
        isa_times(args.isa_times, seed=args.seed)
        return 0
    if args.locate_times:
        locate_times(args.locate_times, seed=args.seed)
        return 0
    if args.rna_profile:
        rna_profile(args.rna_profile, seed=args.seed, trace=args.out)
        return 0
    from bwt_tpu_torch.ops import _kernels, search

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = card_line()
    tag = f"[{smi}]"
    print(f"phase 0 card: torch {torch.__version__} cuda "
          f"{torch.version.cuda}, {name}, {torch.cuda.device_count()} "
          f"device(s); nvidia-smi: {smi}", flush=True)

    t0 = time.perf_counter()
    tile_builds = start_tile_builds()
    lib = _kernels.build(verbose=True)
    build_s = time.perf_counter() - t0
    regs = re.findall(r"Used (\d+) registers", _kernels.LAST_REPORT)
    frames = _frames(_kernels.LAST_REPORT)
    require(len(regs) >= 21 and len(frames) == len(regs),
            "the compiler's report does not list every kernel")
    require(all(f == ("0", "0") for f in frames),
            f"a kernel keeps values in local memory (stack frame, spill "
            f"stores): {frames}")
    print(f"phase 1 nvcc build of {len(_kernels.sources())} source(s) -> "
          f"{lib.relative_to(ROOT)} in {build_s:.3f} s; {len(regs)} kernels, "
          f"registers {sorted(map(int, regs))}, no stack frame, no spills; "
          f"K5 seed_rows (by levels expanded) "
          f"{registers_of('seed_rows_kernel')}, K11a (warp, block and tall "
          f"forms) {registers_of('LogForm')} {tag}", flush=True)
    forms = registers_by_form()
    require(all(a and len(a) == len(b) for a, b in forms.values()),
            f"a kernel lacks its tp instantiations: {forms}")
    print("phase 1 registers by form, replicated / tp (fm::IndexT<kTp>, "
          "every instantiation): " + ", ".join(
              f"{k} {a} / {b}" for k, (a, b) in forms.items()) + f" {tag}",
          flush=True)
    anchor_regs = anchor_registers()
    require(len(anchor_regs) == 6 * len(set(search.ANCHOR_TILES))
            and len(anchor_registers(wide=True)) == len(anchor_regs),
            f"the anchor hunt lacks an instantiation: {anchor_regs}")
    wide_regs = registers_wide()
    require(all(len(a) == len(b) > 0 for a, b in wide_regs.values()),
            f"a kernel lacks its wide instantiations: {wide_regs}")
    print("phase 1 registers by layout, int32 / wide (fm::IndexT<kTp, "
          "kWide>, replicated and tp forms): " + ", ".join(
              f"{k} {a} / {b}" for k, (a, b) in wide_regs.items())
          + f" {tag}", flush=True)
    print(f"phase 1 anchor_scan's instantiations (tiles forward / reversed "
          f"{search.ANCHOR_TILES}): registers {anchor_regs} {tag}",
          flush=True)
    variants, svc_forms, anchor_forms = finish_tile_builds(tile_builds)
    print("phase 1 anchor_scan built apart, registers by form (int32, "
          "uint8, int8; replicated then tp): " + "; ".join(
              f"{name}: {sorted(anchor_registers(r).values())}"
              for name, (_, r) in anchor_forms.items()) + f" {tag}",
          flush=True)
    print(f"phase 1 the automatons K10 and K9 built apart at tiles "
          f"{sorted(variants)} and K7 in the forms {list(svc_forms)}, to be "
          f"timed beside the package's, in "
          f"{time.perf_counter() - t0:.3f} s from the start of the build; "
          f"registers " + ", ".join(
              f"tile {T}: K10 {registers_of('align_automaton_kernel', r)}, "
              f"K9 {registers_of('rnaseq_automaton_kernel', r)}"
              for T, (_, r) in sorted(variants.items()))
          + ", " + ", ".join(f"K7 {name}: {registers_of('service_kernel', r)}"
                             for name, (_, r) in svc_forms.items())
          + f"; the package's K7 {registers_of('service_kernel')} (uint8 "
            f"and int32 banks at tiles 1 and 4), no stack frame, no spills "
            f"{tag}", flush=True)

    rng = np.random.default_rng(args.seed)
    dp_rows = phase_kernel(rng, tag)
    stitch_rows = phase_stitch(rng, tag)
    report = dict(card=smi, dp=dp_rows, dp_stitch=stitch_rows)
    codes = rng.integers(0, 4, size=1 << 25).astype(np.uint8)
    fmi, report["build"] = phase_build(codes, dev, tag)
    keep = {}  # the single-device outputs phase 11 holds the mesh to
    report["locate"], table, kmers = phase_locate(fmi, codes, rng, 1 << 20,
                                                  tag, keep=keep)
    report["align"], recorded, (sub_reads, ind_reads) = phase_align(
        fmi, codes, rng, 1 << 16, tag, ROOT / "build" / "chip_smoke",
        keep=keep)
    report["nw_batch"] = phase_nw_batch(codes, rng, NW_PAIRS, tag)
    report["cli"] = phase_cli(rng, ROOT / "build" / "chip_smoke", tag)
    latency_us = load_latency(fmi, codes, tag)
    report["kernels"] = phase_search_kernels(fmi, codes, rng, table, tag,
                                             latency_us, anchor_forms)
    report["kernels"] += phase_service_kernels(fmi, codes, rng, table,
                                               recorded, tag, svc_forms,
                                               latency_us)
    del recorded
    from bwt_tpu_torch.models.batch_exec import QueryService

    align_svc = QueryService(fmi, codes)
    report["kernels"] += phase_align_kernels(
        fmi, align_svc, [("subst", sub_reads[:align_svc.config.search_batch]),
                         ("indel", ind_reads)], tag, latency_us,
        variants)
    report["search_reads"], reads = phase_search_reads(fmi, codes, rng,
                                                       1 << 20, tag,
                                                       keep=keep)
    rna_reads, rna = phase_rna_seq(fmi, codes, rng, 1 << 16, tag, latency_us,
                                   variants, svc_forms, keep=keep)
    report["rna_seq"] = rna
    report["kernels"] += [rna["k9"], *rna["k7"]]
    report["wide"], wide_rows, wide = phase_wide(
        fmi, codes, rng, keep, report["build"], tag)
    report["kernels"] += wide_rows
    report["mesh"] = phase_mesh(fmi, codes, keep, tag,
                                ROOT / "build" / "chip_smoke" / "mesh",
                                report["build"]["peak_gib"], wide=wide)
    del wide
    del keep
    report["elastic"] = phase_elastic(tag, args.seed)
    phase_profiles(fmi, table, kmers, reads, rna_reads, report, tag,
                   codes, sub_reads)
    del fmi, table, kmers
    torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))

    def pool_of(kernel):
        return {"dp_wavefront": dp_rows, "dp_stitch": stitch_rows}.get(
            kernel) or [r for r in report["kernels"] if r["kernel"] == kernel]

    def row_of(kernel, case=None, **match):
        return next(r for r in pool_of(kernel)
                    if (case is None or r["case"] == case)
                    and all(r[k] == v for k, v in match.items()))

    def worst(kernel):
        return max(r["max_abs_err"] for r in pool_of(kernel))

    loc, align, sr = report["locate"], report["align"], report["search_reads"]
    # single_align's launches: its default engine's run (K10, K11a, K11b,
    # and its escapes') and its host engine's (K7, the executor's stitch)
    al = {k: align["launches"][k] + align["host_launches"][k]
          for k in align["launches"]}
    # the CLI's runs in process (phase 6): the self-checks' searches,
    # walks and locates, single_align's --sam and FastQ runs
    cl = {k: sum(r.get(k, 0) for r in report["cli"]["launches"].values())
          for k in al}
    entries = [
        # single_align fills inside dp_stitch (fill launches 0 there): the
        # standalone fill's paths are the three batched aligners
        ("dp_wavefront", "bwt_tpu_torch/csrc/dp_wavefront.cu",
         "bwt_tpu/ops/pallas_align.py:44",
         al["fill"] + report["nw_batch"]["fill_launches"],
         row_of("dp_wavefront", B=NW_PAIRS, L1=NW_SHAPE[0], L2=NW_SHAPE[1],
                scoring="default"),
         f"B={NW_PAIRS} L1={NW_SHAPE[0]} L2={NW_SHAPE[1]}"),
        ("dp_stitch", "bwt_tpu_torch/csrc/dp_stitch.cu",
         "bwt_tpu/models/batch_exec.py:721 around "
         "bwt_tpu/ops/pallas_align.py:44", al["stitch"],
         row_of("dp_stitch", B=1024, L1=32, L2=32, scoring="default"),
         "B=1024 L1=32 L2=32"),
        ("backward_search", "bwt_tpu_torch/csrc/backward_search.cu",
         "tools/probe_pallas_lf.py:103",
         loc["count_matches"]["bs_launches"] + al["K3"] + cl["K3"],
         row_of("backward_search", "C[c0], 30-mers"), None),
        # since the service kernel walks inside its own launch, K4's path
        # is the unc_sa_range request (rna_seq without isa_samples)
        ("unc_sa", "bwt_tpu_torch/csrc/unc_sa.cu",
         "bwt_tpu/ops/search.py:359",
         al["K4"] + rna["unc_launches"] + cl["K4"], row_of("unc_sa"), None),
        ("anchor_scan", "bwt_tpu_torch/csrc/anchor_scan.cu",
         "bwt_tpu/models/exact.py:35", sr["launches"],
         row_of("anchor_scan", "a search_reads chunk, uint8, reversed, "
                               "min_anchor=20"), None),
        ("locate", "bwt_tpu_torch/csrc/locate.cu",
         "bwt_tpu/ops/search.py:443",
         loc["plain"]["launches"] + loc["seeded"]["launches"] + cl["locate"],
         row_of("locate", "30-mers, plain"), None),
        ("seed_rows", "bwt_tpu_torch/csrc/seed_rows.cu",
         "bwt_tpu/ops/search.py:256", loc["seed_launches"],
         row_of("seed_rows"), None),
        ("isa_window", "bwt_tpu_torch/csrc/isa_window.cu",
         "bwt_tpu/ops/search.py:454", rna["isa_launches"],
         row_of("isa_window", f"{ISA_CASE}, sa_rate 4"), None),
        # rna_seq's host engine runs K7 (engine="host"); its device engine
        # K9 alone
        ("service", "bwt_tpu_torch/csrc/service.cu",
         "bwt_tpu/models/batch_exec.py:304",
         al["K7"] + rna["launches"] + rna["isa_svc_launches"],
         row_of("service", next(
             r["case"] for r in report["kernels"]
             if r["kernel"] == "service"
             and r["case"].startswith("round 0 of single_align's subst"))),
         None),
        ("rnaseq_automaton", "bwt_tpu_torch/csrc/rnaseq_automaton.cu",
         "bwt_tpu/models/rnaseq.py:265", rna["automaton_launches"],
         row_of("rnaseq_automaton"), None),
        ("align_automaton", "bwt_tpu_torch/csrc/align_automaton.cu",
         "bwt_tpu/models/aligner.py:504", al["K10"] + cl["K10"],
         row_of("align_automaton", "a chunk of phase 5, subst"), None),
        ("dp_log_stitch", "bwt_tpu_torch/csrc/dp_stitch.cu",
         "bwt_tpu/models/aligner.py:1028", al["K11a"] + cl["K11a"],
         row_of("dp_log_stitch", "the buckets of a chunk of phase 5, "
                                "subst"), None),
        ("compose", "bwt_tpu_torch/csrc/compose.cu",
         "bwt_tpu/models/aligner.py:1084", al["K11b"] + cl["K11b"],
         row_of("compose"),
         None),
    ]
    # the wide (int64) index's instantiations: its main path (phase 12)
    wl = report["wide"]["launches"]
    wide_cases = {"backward_search": "C[c0], 30-mers", "unc_sa": None,
                  "anchor_scan": "a search_reads chunk, uint8, reversed, "
                                 "min_anchor=20",
                  "locate": "30-mers, plain", "seed_rows": None}
    entries += [(f"{kernel}_wide", source, replaces,
                 wl[KERNEL_KEYS[kernel]],
                 row_of(f"{kernel}_wide", wide_cases[kernel]), None)
                for kernel, source, replaces, *_ in entries
                if kernel in wide_cases]
    for entry in entries:
        require(entry[3] > 0, f"no main path launched the {entry[0]} kernel")
    # the tp form's launches: rank 0's runs of phase 11's tp paths over
    # its views (the kernels without a tp form read no index)
    tp_runs = [run for m in report["mesh"]["worlds"]["gloox4"]["ranks"][0]
               ["tp"].values() for runs in m["paths"].values()
               for run in runs]
    # the wide tp case of phase 11 (rank 0): its K3 and K4 launches
    wide_tp = report["mesh"]["worlds"]["gloox4"]["ranks"][0]["tp"][
        "dp1tp4"]["wide"]["launches"]
    tp_wide = dict(backward_search_wide=wide_tp["K3"],
                   unc_sa_wide=wide_tp["K4"])
    print(json.dumps({"kernels": [{
        "name": kernel, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": worst(kernel), "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": None,
        "shape": shape or row["shape"],
        "tp_launches": (sum(r["launches"][KERNEL_KEYS[kernel]]
                            for r in tp_runs)
                        if kernel in KERNEL_KEYS else tp_wide.get(kernel)),
    } for kernel, source, replaces, launches, row, shape in entries]}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
