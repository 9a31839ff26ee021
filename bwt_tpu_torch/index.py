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

A tp view (``parallel.shard_index`` then ``parallel.tp_view``) holds one
block of each sequence table instead: ``bwt_words``, ``buckets``,
``sa_samples`` and ``isa_samples`` are this rank's contiguous block of
``bwt_tpu``'s tp-padded tables, ``C`` and ``endloc`` whole, and
``shard`` says where the blocks sit (:class:`Shard`).  The global row
counts come from ``length`` (``bucket_rows``, ``sample_rows``), never from
a block's ``shape[0]``.
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


@dataclasses.dataclass(frozen=True, eq=False)
class Shard:
    """Where a tp view's blocks sit.  Each sharded table of ``n`` rows is
    padded with zero rows to a multiple of ``size`` (``bwt_tpu``'s
    ``shard_index``); block ``j`` holds rows ``[j per, (j + 1) per)`` with
    ``per = padded // size``, and this rank holds block ``coord``.

    ``mesh`` (a ``parallel.Mesh``) is the group the plain reads all-reduce
    over along 'tp' (None for a view made in one process, whose plain
    reads need ``size`` 1).  On a card, ``tables`` maps each table the
    kernels read (``buckets``, ``sa_samples``, ``isa_samples``) to a
    (size,) int64 tensor of its blocks' device pointers, uploaded once for
    the view, and ``peers`` holds the blocks this rank allocated and the
    mappings of its peers' blocks it opened (``parallel.peer``)."""
    coord: int
    size: int
    word_per: int
    bucket_per: int
    sample_per: int
    mesh: object = None
    tables: dict | None = None
    peers: object = None

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the tp group (``parallel.mesh._all_reduce``,
        the one place that knows the backend)."""
        if self.size == 1:
            return t
        if self.mesh is None:
            raise RuntimeError(
                "a tp view made in one process has no group: its plain "
                "reads need a view made by parallel.shard_index")
        from bwt_tpu_torch.parallel import mesh as pmesh

        return pmesh._all_reduce(self.mesh, "tp", t)


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
    # a tp view: the mesh axis its reads reduce over ("tp"), as
    # bwt_tpu.FMIndex.tp_axis; set by parallel.tp_view on a shard
    tp_axis: str | None = None
    shard: Shard | None = None  # where the blocks sit (parallel.shard_index)

    @property
    def device(self) -> torch.device:
        return self.buckets.device

    @property
    def tp(self) -> Shard | None:
        """The shard record of a tp view, None for a whole index.  A shard
        that ``tp_view`` has not marked raises: its tensors are blocks, and
        only the tp reads know it."""
        if self.shard is None:
            return None
        if self.tp_axis is None:
            raise ValueError("this index is a shard_index result: query it "
                             "through parallel.tp_view")
        return self.shard

    def require_whole(self, what: str) -> None:
        """Raise for a tp view: ``what`` needs every block of the index."""
        if self.shard is not None:
            raise ValueError(
                f"{what} needs the whole index; this one is a tp view holding "
                f"block {self.shard.coord} of {self.shard.size} of each "
                f"sequence table")

    def rank(self, c, idx):
        """rank(c, idx) with sentinel skipping (seqindex.c:221-225)."""
        return rank_ops.rank(self.buckets, self.endloc, c, idx, self.tp,
                             self.bucket_rows)

    def lf(self, idx):
        """LF-mapping (seqindex.c:214-219)."""
        idx = torch.as_tensor(idx, dtype=torch.int32, device=self.device)
        return rank_ops.lf(self.buckets, self.C, self.endloc, idx, self.tp,
                           self.bucket_rows)

    def sample_at(self, table: torch.Tensor, j: torch.Tensor):
        """``table[j]`` of ``sa_samples`` or ``isa_samples`` like
        ``jnp.take`` (:func:`rank_ops.take_fill`), through the tp reads on
        a view."""
        return rank_ops.take_fill(table, j, self.tp, self.sample_rows)

    @property
    def nwords(self) -> int:
        """Packed words of the BWT (16 bases each), without the pad word."""
        return (self.length + codec.BASES_PER_WORD - 1) // codec.BASES_PER_WORD

    @property
    def bucket_rows(self) -> int:
        """Row count of ``buckets``, from ``length``: the bucket rows and
        the one extra row past them."""
        return max((self.nwords + rank_ops.BUCKET_WORDS - 1)
                   // rank_ops.BUCKET_WORDS, 1) + 1

    @property
    def sample_rows(self) -> int:
        """Row count of ``sa_samples`` (and of ``isa_samples``)."""
        return 1 + self.length // self.sa_rate

    def to(self, device) -> "FMIndex":
        """The same index with its tensors on ``device``."""
        self.require_whole("FMIndex.to")
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def to_numpy(self) -> dict:
        """The index arrays as numpy, in ``bwt_tpu``'s dtypes (the inverse
        of :func:`from_numpy`)."""
        self.require_whole("FMIndex.to_numpy")
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
                verify: bool = False, config=None, sa=None, device=None,
                index_dtype="auto") -> FMIndex:
    """Build an FM-index from genome codes (or ASCII text) on ``device``
    (default: the card when there is one).

    Prefix-doubling suffix sort, BWT by the ISA permutation, popcount
    checkpoints (``make_fmi``, seqindex.c:161-212).  ``sa_sample_rate``
    is a power of two, default from config (32, the reference's and the
    file format's).  ``verify=True`` runs the exact suffix-array check
    and raises on failure.  A precomputed ``sa`` (numpy or a tensor, e.g.
    from :func:`bwt_tpu_torch.parallel.sharded_suffix_array`) skips the
    sort: :func:`_finish_index` rebuilds the ISA from it with one scatter;
    with the int64 layout it raises ValueError, as in ``bwt_tpu``.
    ``index_dtype`` follows ``bwt_tpu``'s rules:
    ``"auto"`` keeps int32 through ``suffix.INT32_MAX_LEN`` and takes the
    wide (int64) layout past it; int32 past the cap raises ValueError; the
    wide layout is not ported and raises NotImplementedError."""
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
    if index_dtype == "auto":
        wide = len(seq) > suffix.INT32_MAX_LEN
    else:
        wide = np.dtype(index_dtype) == np.int64
        if not wide and len(seq) > suffix.INT32_MAX_LEN:
            raise ValueError(
                f"genome length {len(seq)} exceeds the int32 FM-index cap "
                f"({suffix.INT32_MAX_LEN}); pass index_dtype=np.int64")
    if sa is not None and wide:
        raise ValueError(
            "index_dtype=int64 with a precomputed sa= is not supported (the "
            "sharded build is int32; build through the in-process suffix "
            "sort instead)")
    if wide:
        raise NotImplementedError(
            "the int64 (wide) FM-index is not ported (ROADMAP Queue 1 "
            "item 6)")
    device = torch.device(device) if device is not None else default_device()
    host = np.ascontiguousarray(np.asarray(seq, dtype=np.uint8))
    length = len(host)
    codes = torch.from_numpy(host).to(device).to(torch.int64)
    if sa is not None:
        sa = (sa if isinstance(sa, torch.Tensor) else torch.from_numpy(
            np.array(sa, np.int32))).to(device, torch.int32)
        if tuple(sa.shape) != (length + 1,):
            raise ValueError(f"sa of shape {tuple(sa.shape)} for a genome of "
                             f"{length} bases (want ({length + 1},))")
        if verify and not suffix.verify_suffix_array(codes, sa):
            raise AssertionError("suffix array verification failed")
        return _finish_index(codes, sa, length, sa_sample_rate)
    sa, isa = suffix.suffix_array_with_isa(codes)
    if verify and not suffix.verify_suffix_array(codes, sa):
        raise AssertionError("suffix array verification failed")
    bwt, endloc = suffix.bwt_from_isa(codes, isa)
    return _assemble(bwt, sa[::sa_sample_rate], endloc, length,
                     sa_sample_rate, isa[::sa_sample_rate])


def _finish_index(codes: torch.Tensor, sa: torch.Tensor, length: int,
                  sa_rate: int) -> FMIndex:
    """Finish from a given SA (the sharded build, tests): one scatter
    rebuilds the ISA, then the BWT by the ISA permutation."""
    m = sa.shape[0]
    isa = torch.zeros(m, dtype=torch.int32, device=sa.device)
    isa[sa.long()] = torch.arange(m, dtype=torch.int32, device=sa.device)
    bwt, endloc = suffix.bwt_from_isa(codes, isa)
    return _assemble(bwt, sa[::sa_rate], endloc, length, sa_rate,
                     isa[::sa_rate])


def index_from_parts(*, bwt_codes, sa_samples, endloc, length: int,
                     sa_rate: int = SA_SAMPLE_RATE, C=None,
                     device=None) -> FMIndex:
    """Reassemble an FMIndex from serialized parts; rank checkpoints and
    C are rebuilt from the BWT, like read_index (fileio.c:62-63).  A
    stored ``C`` is accepted and ignored, as ``bwt_tpu``'s is: the
    rebuilt one is identical by construction."""
    del C
    device = torch.device(device) if device is not None else default_device()
    return _assemble(
        torch.from_numpy(np.array(bwt_codes, np.int64)).to(device),
        torch.from_numpy(np.array(sa_samples, np.int32)).to(device),
        torch.tensor(int(endloc), dtype=torch.int32, device=device),
        length, sa_rate)


def bwt_codes(fmi: FMIndex) -> np.ndarray:
    """The compact BWT as uint8 codes on the host."""
    fmi.require_whole("bwt_codes")
    words = fmi.bwt_words[:-1].cpu().numpy().view(np.uint32)
    return codec.unpack_words(words, fmi.length)
