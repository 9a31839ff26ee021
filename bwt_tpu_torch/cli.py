"""Command-line interface: ``python -m bwt_tpu_torch <cmd>``.

The ``build_index`` and ``single_align`` subcommands, with the
arguments and output of ``bwt_tpu``'s (single_align stdout is byte-equal
to the reference binary's).  The other subcommands are not ported yet.
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

    if args.platform == "auto":
        return None  # the card when there is one
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bwt_tpu_torch", description=__doc__)
    p.add_argument(
        "--platform", choices=["auto", "cpu", "cuda"], default="auto",
        help="device for the index and the queries (default: the card "
        "when there is one)")
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
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
