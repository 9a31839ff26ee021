"""The FM-index: a frozen dataclass of tensors on one device.

Fields and semantics follow ``bwt_tpu.index.FMIndex`` (seqindex.h:14-22,
seqindex.c:161-212):

  * ``bwt_words``  — compact BWT (sentinel removed), 16 bases per 32-bit
    word in little-endian 2-bit lanes, plus one zero word; int32 bit
    patterns.
  * ``buckets``    — (nbuckets+1, 8) int32 rows ``[occ_A..occ_T | 4
    words]`` (ops/rank.py).
  * ``sa_samples`` — every ``sa_rate``-th SA entry (seqindex.c:173-176).
  * ``C``          — cumulative counts with ``C[0] = 1``
    (seqindex.c:183-187).
  * ``endloc``     — SA row of the sentinel (where ``SA[i] == 0``).
  * ``isa_samples``— ISA at every ``sa_rate``-th text position, or None
    (reference-format loads store no inverse).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bwt_tpu_torch import codec
from bwt_tpu_torch.ops import rank as rank_ops
from bwt_tpu_torch.ops import suffix

SA_SAMPLE_RATE = 32  # seqindex.c:173-176


def default_device() -> torch.device:
    """The card.  Without one this raises: the port runs on the CPU only
    when the caller asks for it (``device="cpu"``)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "bwt_tpu_torch: no CUDA device; pass device='cpu' to run on the "
            "CPU")
    return torch.device("cuda")


@dataclasses.dataclass(frozen=True)
class FMIndex:
    bwt_words: torch.Tensor  # (nwords+1,) int32 bit patterns
    buckets: torch.Tensor  # (nbuckets+1, 8) int32
    sa_samples: torch.Tensor  # (1 + length//sa_rate,) int32
    C: torch.Tensor  # (5,) int32
    endloc: torch.Tensor  # () int32
    length: int
    sa_rate: int = SA_SAMPLE_RATE  # power of two
    isa_samples: torch.Tensor | None = None  # (1 + length//sa_rate,)

    @property
    def device(self) -> torch.device:
        return self.buckets.device

    def rank(self, c, idx):
        """rank(c, idx) with sentinel skipping (seqindex.c:221-225)."""
        return rank_ops.rank(self.buckets, self.endloc, c, idx)

    def lf(self, idx):
        """LF-mapping (seqindex.c:214-219)."""
        idx = torch.as_tensor(idx, dtype=torch.int32, device=self.device)
        return rank_ops.lf(self.buckets, self.C, self.endloc, idx)

    def to(self, device) -> "FMIndex":
        """The same index with its tensors on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def to_numpy(self) -> dict:
        """The index arrays as numpy, in ``bwt_tpu``'s dtypes (the inverse
        of :func:`from_numpy`)."""
        d = dict(
            bwt_words=self.bwt_words.cpu().numpy().view(np.uint32),
            buckets=self.buckets.cpu().numpy(),
            sa_samples=self.sa_samples.cpu().numpy(),
            C=self.C.cpu().numpy(),
            endloc=self.endloc.cpu().numpy(),
            length=self.length,
            sa_rate=self.sa_rate,
        )
        if self.isa_samples is not None:
            d["isa_samples"] = self.isa_samples.cpu().numpy()
        return d


def _i32(a, device) -> torch.Tensor:
    """numpy integer array -> int32 tensor (uint32 reinterpreted)."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, dtype=np.int32)).to(device)


def from_numpy(arrays, device=None) -> FMIndex:
    """An FMIndex from numpy arrays named like ``bwt_tpu``'s FMIndex
    fields (``bwt_words``, ``buckets``, ``sa_samples``, ``C``,
    ``endloc``, ``length``, ``sa_rate`` and optional ``isa_samples``) —
    e.g. ``{k: np.asarray(getattr(fmi, k)) ...}`` of an index built by
    the JAX package, or an npz file's contents.  The wide (int64) layout,
    12-int bucket rows and int64 ``sa_samples`` / ``C`` / ``endloc`` /
    ``isa_samples``, is not ported and raises ValueError."""
    device = torch.device(device) if device is not None else default_device()
    isa = arrays["isa_samples"] if "isa_samples" in arrays else None
    buckets = np.asarray(arrays["buckets"])
    if buckets.ndim != 2 or buckets.shape[1] != 8:
        raise ValueError(
            f"buckets of shape {buckets.shape}: the wide (int64) index layout "
            f"(12-int bucket rows) is not ported; the port reads the int32 "
            f"layout's (n, 8) rows")
    wide = [k for k in ("sa_samples", "C", "endloc", "isa_samples")
            if k in arrays and arrays[k] is not None
            and np.asarray(arrays[k]).dtype == np.int64]
    if wide:
        raise ValueError(
            f"{', '.join(wide)} int64: the wide (int64) index layout is not "
            f"ported; the port reads the int32 layout")
    return FMIndex(
        bwt_words=_i32(arrays["bwt_words"], device),
        buckets=_i32(arrays["buckets"], device),
        sa_samples=_i32(arrays["sa_samples"], device),
        C=_i32(arrays["C"], device),
        endloc=_i32(arrays["endloc"], device).reshape(()),
        length=int(arrays["length"]),
        sa_rate=int(arrays["sa_rate"]) if "sa_rate" in arrays else 32,
        isa_samples=None if isa is None else _i32(isa, device),
    )


def pack_words(codes: torch.Tensor, length: int) -> torch.Tensor:
    """Codes 0..3 -> 16-lane 2-bit words (int32 bit patterns) plus one
    zero pad word."""
    BW = codec.BASES_PER_WORD
    nwords = (length + BW - 1) // BW
    padded = torch.zeros(nwords * BW, dtype=torch.int64, device=codes.device)
    padded[:length] = codes
    shifts = 2 * torch.arange(BW, dtype=torch.int64, device=codes.device)
    words = (padded.reshape(nwords, BW) << shifts).sum(dim=1)
    words = torch.where(words >= (1 << 31), words - (1 << 32), words)
    return torch.cat([words, words.new_zeros(1)]).to(torch.int32)


def _assemble(bwt_codes, sa_samples, endloc, length: int, sa_rate: int,
              isa_samples=None) -> FMIndex:
    bwt_words = pack_words(bwt_codes, length)
    buckets, totals = rank_ops.make_buckets(bwt_words[:-1], length)
    C = torch.cat([totals.new_ones(1), 1 + torch.cumsum(totals, 0)])
    return FMIndex(
        bwt_words=bwt_words,
        buckets=buckets,
        sa_samples=sa_samples.to(torch.int32).contiguous(),
        C=C.to(torch.int32),
        endloc=endloc.to(torch.int32).reshape(()),
        length=length,
        sa_rate=sa_rate,
        isa_samples=(None if isa_samples is None
                     else isa_samples.to(torch.int32).contiguous()),
    )


def build_index(seq, *, sa_sample_rate: int | None = None,
                verify: bool = False, config=None, device=None) -> FMIndex:
    """Build an FM-index from genome codes (or ASCII text) on ``device``
    (default: the card when there is one).

    Prefix-doubling suffix sort, BWT by the ISA permutation, popcount
    checkpoints (``make_fmi``, seqindex.c:161-212).  ``sa_sample_rate``
    is a power of two, default from config (32, the reference's and the
    file format's).  ``verify=True`` runs the exact suffix-array check
    and raises on failure."""
    from bwt_tpu_torch.config import DEFAULT

    cfg = config or DEFAULT
    if cfg.elastic_fallback:
        raise NotImplementedError(
            "config.elastic_fallback is not ported (ROADMAP Queue 1: "
            "multi-device and recovery)")
    if sa_sample_rate is None:
        sa_sample_rate = cfg.sa_sample_rate
    if cfg.rank_blocksize != codec.BASES_PER_WORD:
        raise ValueError(
            f"config.rank_blocksize={cfg.rank_blocksize} is structural: "
            f"the packed-word layout fixes it at {codec.BASES_PER_WORD}")
    if sa_sample_rate <= 0 or sa_sample_rate & (sa_sample_rate - 1):
        raise ValueError("sa_sample_rate must be a power of two")
    if isinstance(seq, (str, bytes)):
        seq = codec.encode_genome(seq)
    device = torch.device(device) if device is not None else default_device()
    host = np.ascontiguousarray(np.asarray(seq, dtype=np.uint8))
    length = len(host)
    codes = torch.from_numpy(host).to(device).to(torch.int64)
    sa, isa = suffix.suffix_array_with_isa(codes)
    if verify and not suffix.verify_suffix_array(codes, sa):
        raise AssertionError("suffix array verification failed")
    bwt, endloc = suffix.bwt_from_isa(codes, isa)
    return _assemble(bwt, sa[::sa_sample_rate], endloc, length,
                     sa_sample_rate, isa[::sa_sample_rate])


def index_from_parts(*, bwt_codes, sa_samples, endloc, length: int,
                     sa_rate: int = SA_SAMPLE_RATE, device=None) -> FMIndex:
    """Reassemble an FMIndex from serialized parts; rank checkpoints and
    C are rebuilt from the BWT, like read_index (fileio.c:62-63)."""
    device = torch.device(device) if device is not None else default_device()
    return _assemble(
        torch.from_numpy(np.asarray(bwt_codes, np.int64)).to(device),
        torch.from_numpy(np.asarray(sa_samples, np.int32)).to(device),
        torch.tensor(int(endloc), dtype=torch.int32, device=device),
        length, sa_rate)
