"""Command-line interface: ``python -m bwt_tpu_torch <cmd>``.

The ``build_index``, ``single_align``, ``rnaseq``, ``search_reads``,
``locate`` and ``searchtest`` subcommands, with the arguments and output of
``bwt_tpu``'s (single_align stdout is byte-equal to the reference
binary's).  The other subcommands are not ported yet.
"""

from __future__ import annotations

import argparse
import sys
import time


def _read_genome(path: str) -> str:
    try:
        text = open(path, "r").read()
    except OSError:
        print("Could not open sequence", file=sys.stderr)  # single_align.c:379
        raise SystemExit(1)
    return text.rstrip("\n")


def _read_reads(path: str) -> list[str]:
    try:
        raw = open(path).read()
    except OSError:
        print("Could not open reads file", file=sys.stderr)  # single_align.c:434
        raise SystemExit(1)
    return [ln.rstrip("\r") for ln in raw.splitlines() if ln]


def _device(args):
    import torch

    if args.platform == "cuda" and not torch.cuda.is_available():
        print("bwt_tpu_torch: --platform cuda but no CUDA device",
              file=sys.stderr)
        raise SystemExit(1)
    return torch.device(args.platform)


def _not_ported(what: str) -> int:
    print(f"bwt_tpu_torch: {what} is not ported yet (see ROADMAP.md)",
          file=sys.stderr)
    return 2


def cmd_build_index(args):
    import bwt_tpu_torch
    from bwt_tpu_torch import io as bio

    if args.index_dtype == "int64":
        return _not_ported("the int64 index (--index-dtype int64)")
    t0 = time.perf_counter()
    fmi = bwt_tpu_torch.build_index(_read_genome(args.seqfile),
                                    sa_sample_rate=args.sa_rate,
                                    device=_device(args))
    if args.format == "ref":
        bio.write_ref_index(fmi, args.indexfile)
    else:
        bio.write_npz_index(fmi, args.indexfile)
    print(f"Built index: {fmi.length} bases in "
          f"{time.perf_counter() - t0:.2f}s", file=sys.stderr)
    return 0


def _load(args):
    import bwt_tpu_torch
    from bwt_tpu_torch import io as bio

    dev = _device(args)
    if args.indexfile:
        try:
            if args.indexfile.endswith(".npz"):
                return bio.read_npz_index(args.indexfile, device=dev)
            return bio.read_ref_index(args.indexfile, device=dev)
        except OSError:
            print("Could not open index file", file=sys.stderr)  # single_align.c:426
            raise SystemExit(1)
        except ValueError as e:
            # truncated or corrupt file (fileio.c:57-60)
            print(str(e), file=sys.stderr)
            raise SystemExit(1)
    return bwt_tpu_torch.build_index(_read_genome(args.seqfile), device=dev)


def cmd_single_align(args):
    from bwt_tpu_torch.models import aligner

    if args.sam:
        return _not_ported("single_align --sam")
    if args.readfile.endswith((".fq", ".fastq")):
        return _not_ported("FastQ reads input")
    fmi = _load(args)
    genome = _read_genome(args.seqfile)
    reads = _read_reads(args.readfile)
    res = aligner.align_reads(fmi, genome, reads, anchor_len=args.anchor_len)
    sys.stdout.write(aligner.format_ref_output(res))
    naligned = sum(1 for p, _ in res if p)
    print(f"{naligned} of {len(reads)} reads aligned", file=sys.stderr)
    return 0


def cmd_rnaseq(args):
    from bwt_tpu_torch.models import rnaseq

    fmi = _load(args)
    reads = _read_reads(args.readfile)
    for p in rnaseq.rna_seq(fmi, reads).tolist():
        print(p)
    return 0


def cmd_search_reads(args):
    from bwt_tpu_torch.models import exact

    fmi = _load(args)
    reads = _read_reads(args.readfile)
    res = exact.search_reads(fmi, reads, min_anchor=args.min_anchor,
                             pair_window=args.pair_window)
    sys.stdout.write(exact.format_ref_output(reads, res))
    return 0


def cmd_locate(args):
    from bwt_tpu_torch.models.exact import _encode_batch
    from bwt_tpu_torch.ops import search

    fmi = _load(args)
    pat, lens = _encode_batch(_read_reads(args.readfile))
    for p in search.locate(fmi, pat, lens).tolist():
        print(p)
    return 0


def cmd_searchtest(args):
    """Self-check: locate() of sampled substrings returns their origin
    (searchtest.c:77-94)."""
    import numpy as np

    import bwt_tpu_torch
    from bwt_tpu_torch.ops import search

    rng = np.random.default_rng(args.seed)
    codes = rng.integers(0, 4, size=args.length).astype(np.uint8)
    fmi = bwt_tpu_torch.build_index(codes, device=_device(args))
    bad = 0
    t0 = time.perf_counter()
    done = 0
    while done < args.queries:
        b = min(args.batch, args.queries - done)
        starts = rng.integers(0, args.length - args.plen, size=b)
        pats = codes[np.add.outer(starts, np.arange(args.plen))].astype(
            np.int32)
        lens = np.full((b,), args.plen, np.int32)
        pos = search.locate(fmi, pats, lens).cpu().numpy()
        for got, j in zip(pos, starts):
            if not np.array_equal(codes[got:got + args.plen],
                                  codes[j:j + args.plen]):
                print(f"Ruh roh {got} {j}")  # searchtest.c:87-88
                bad += 1
        done += b
    dt = time.perf_counter() - t0
    print(f"Searched {args.queries} sequences of length {args.plen} in "
          f"{dt:.2f}s ({args.queries / dt:.0f}/s), {bad} mismatches",
          file=sys.stderr)
    return 1 if bad else 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bwt_tpu_torch", description=__doc__)
    p.add_argument(
        "--platform", choices=["cpu", "cuda"], default="cuda",
        help="device for the index and the queries (default: the card; "
        "without one the command exits 1)")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("build_index", help="build + serialize an FM-index")
    s.add_argument("seqfile")
    s.add_argument("indexfile")
    s.add_argument("--format", choices=["ref", "npz"], default="ref")
    s.add_argument(
        "--sa-rate", type=int, default=None,
        help="SA sample rate (power of two; 32 = reference; rates < 32 "
        "still export to ref format by downsampling)")
    s.add_argument("--index-dtype", choices=["auto", "int32", "int64"],
                   default="auto",
                   help="int64 (the wide index) is not ported yet")
    s.set_defaults(fn=cmd_build_index)

    s = sub.add_parser("single_align",
                       help="anchored seed-and-extend aligner (single_align.c)")
    s.add_argument("seqfile")
    s.add_argument("indexfile", nargs="?")
    s.add_argument("readfile")
    s.add_argument("--anchor-len", type=int, default=None)
    s.add_argument("--sam", action="store_true",
                   help="SAM output (not ported yet)")
    s.set_defaults(fn=cmd_single_align)

    s = sub.add_parser("rnaseq",
                       help="spliced-alignment prototype (rnaseqtest.c)")
    s.add_argument("seqfile")
    s.add_argument("readfile")
    s.set_defaults(fn=cmd_rnaseq, indexfile=None)

    s = sub.add_parser("search_reads",
                       help="batched exact anchor search (search_reads.c)")
    s.add_argument("seqfile")
    s.add_argument("indexfile", nargs="?")
    s.add_argument("readfile")
    s.add_argument("--min-anchor", type=int, default=None)
    s.add_argument("--pair-window", type=int, default=None)
    s.set_defaults(fn=cmd_search_reads)

    s = sub.add_parser("locate",
                       help="locate each read (first match position)")
    s.add_argument("seqfile")
    s.add_argument("indexfile", nargs="?")
    s.add_argument("readfile")
    s.set_defaults(fn=cmd_locate)

    s = sub.add_parser("searchtest",
                       help="locate round-trip self-check (searchtest.c)")
    s.add_argument("--length", type=int, default=100000)
    s.add_argument("--queries", type=int, default=10000)
    s.add_argument("--plen", type=int, default=30)
    s.add_argument("--batch", type=int, default=4096)
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=cmd_searchtest)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
