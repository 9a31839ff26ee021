"""The FM-index: a frozen dataclass of tensors on one device.

Fields and semantics follow ``bwt_tpu.index.FMIndex`` (seqindex.h:14-22,
seqindex.c:161-212):

  * ``bwt_words``  — compact BWT (sentinel removed), 16 bases per 32-bit
    word in little-endian 2-bit lanes, plus one zero word; int32 bit
    patterns.
  * ``buckets``    — (nbuckets+1, 8) int32 rows ``[occ_A..occ_T | 4
    words]``, or in the wide index (nbuckets+1, 12) rows ``[occ_lo(4) |
    occ_hi(4) | 4 words]`` (ops/rank.py).
  * ``sa_samples`` — every ``sa_rate``-th SA entry (seqindex.c:173-176).
  * ``C``          — cumulative counts with ``C[0] = 1``
    (seqindex.c:183-187).
  * ``endloc``     — SA row of the sentinel (where ``SA[i] == 0``).
  * ``isa_samples``— ISA at every ``sa_rate``-th text position, or None
    (reference-format loads store no inverse).
  * ``rows32``, ``bases`` — a wide index on a card only: the layout its
    kernels read in place of the 12-int rows, (nbuckets+1, 8) int32 rows of
    counts relative to the (nsb+1, 4) int64 ``bases``
    (``ops/rank.py:derive_rows``).  They are no arguments: each FMIndex
    made on a card derives them from its own ``buckets`` (a tp view takes
    its block from its :class:`Shard`), and they are never written out.

``sa_samples``, ``C``, ``endloc`` and ``isa_samples`` are int32, or int64
in the wide index (``build_index(..., index_dtype=np.int64)``, and every
genome past ``suffix.INT32_MAX_LEN`` bases), whose queries return int64
positions and intervals where ``bwt_tpu``'s do (``FMIndex.wide``).

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
from bwt_tpu_torch.ops import _kernels
from bwt_tpu_torch.ops import rank as rank_ops
from bwt_tpu_torch.ops import suffix
from bwt_tpu_torch.utils import profiling

SA_SAMPLE_RATE = 32  # seqindex.c:173-176

# the stages of the latest build_index on this process (build.upload, then
# build.sort, or build.isa from a given SA, build.bwt, build.rows): their
# seconds and, on a card, the allocator's peak at each one's end; replaced
# by each build
LAST_BUILD: profiling.Phases | None = None


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
    mappings of its peers' blocks it opened (``parallel.peer``).  A wide
    view on a card also holds its block of ``rows32`` (an allocation the
    tables point at) and the whole ``bases``, which the kernels index by
    the global row."""
    coord: int
    size: int
    word_per: int
    bucket_per: int
    sample_per: int
    mesh: object = None
    tables: dict | None = None
    peers: object = None
    rows32: torch.Tensor | None = None
    bases: torch.Tensor | None = None

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
    buckets: torch.Tensor  # (nbuckets+1, 8 or 12) int32
    sa_samples: torch.Tensor  # (1 + length//sa_rate,) int32 or int64
    C: torch.Tensor  # (5,) int32 or int64
    endloc: torch.Tensor  # () int32 or int64
    length: int
    sa_rate: int = SA_SAMPLE_RATE  # power of two
    isa_samples: torch.Tensor | None = None  # (1 + length//sa_rate,)
    # a tp view: the mesh axis its reads reduce over ("tp"), as
    # bwt_tpu.FMIndex.tp_axis; set by parallel.tp_view on a shard
    tp_axis: str | None = None
    shard: Shard | None = None  # where the blocks sit (parallel.shard_index)
    # the wide index's device layout, on a card only (__post_init__)
    rows32: torch.Tensor | None = dataclasses.field(
        init=False, default=None, repr=False, compare=False)
    bases: torch.Tensor | None = dataclasses.field(
        init=False, default=None, repr=False, compare=False)

    def __post_init__(self):
        # every index made on a card, a copy or a replace included, derives
        # the layout of its own rows; a tp view takes its block from its
        # shard, and the CPU's plain versions read the 12-int rows
        rows32 = bases = None
        if self.wide and self.device.type == "cuda":
            if self.shard is None:
                rows32, bases = rank_ops.derive_rows(self.buckets)
            else:
                rows32, bases = self.shard.rows32, self.shard.bases
        object.__setattr__(self, "rows32", rows32)
        object.__setattr__(self, "bases", bases)

    @property
    def device(self) -> torch.device:
        return self.buckets.device

    @property
    def wide(self) -> bool:
        """Whether this is the wide (int64) index: 12-int bucket rows."""
        return rank_ops.is_wide(self.buckets)

    @property
    def pos_dtype(self) -> torch.dtype:
        """The type of the index's positions and SA rows: int64 for the
        wide index, int32 for the other."""
        return torch.int64 if self.wide else torch.int32

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
        idx = torch.as_tensor(idx, dtype=self.pos_dtype, device=self.device)
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
        """The same index with its tensors on ``device`` (a wide index's
        device layout made there, or dropped on the CPU)."""
        self.require_whole("FMIndex.to")
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if f.init and isinstance(getattr(self, f.name), torch.Tensor)})

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


def _positions(a, dtype, name: str, device) -> torch.Tensor:
    """An index's value array (``sa_samples``, ``C``, ``endloc``,
    ``isa_samples``) as a tensor of ``dtype``.  Values outside int32 in an
    int32 index raise ValueError (``bwt_tpu`` without x64 would truncate
    them)."""
    a = np.asarray(a)
    if dtype == torch.int32 and a.size and (
            a.min() < np.iinfo(np.int32).min
            or a.max() > np.iinfo(np.int32).max):
        raise ValueError(
            f"{name} holds values outside int32 but the bucket rows are the "
            f"int32 layout's (n, {rank_ops.ROW_INTS}); the wide index has "
            f"(n, {rank_ops.ROW_INTS_WIDE}) rows")
    return torch.from_numpy(np.array(a, dtype=str(dtype)[6:])).to(device)


def from_numpy(arrays, device=None) -> FMIndex:
    """An FMIndex from numpy arrays named like ``bwt_tpu``'s FMIndex
    fields (``bwt_words``, ``buckets``, ``sa_samples``, ``C``,
    ``endloc``, ``length``, ``sa_rate`` and optional ``isa_samples``) —
    e.g. ``{k: np.asarray(getattr(fmi, k)) ...}`` of an index built by
    the JAX package, or an npz file's contents.  The row width says the
    layout: (n, 12) rows are the wide index, whose value arrays become
    int64 (a wide npz that ``bwt_tpu`` wrote without x64 holds them as
    int32); (n, 8) rows are the int32 index, whose value arrays become
    int32.  Any other width raises ValueError."""
    device = torch.device(device) if device is not None else default_device()
    isa = arrays["isa_samples"] if "isa_samples" in arrays else None
    buckets = np.asarray(arrays["buckets"])
    if buckets.ndim != 2 or buckets.shape[1] not in (
            rank_ops.ROW_INTS, rank_ops.ROW_INTS_WIDE):
        raise ValueError(
            f"buckets of shape {buckets.shape}: an index has (n, "
            f"{rank_ops.ROW_INTS}) rows, or (n, {rank_ops.ROW_INTS_WIDE}) "
            f"in the wide (int64) layout")
    dt = (torch.int64 if buckets.shape[1] == rank_ops.ROW_INTS_WIDE
          else torch.int32)
    return FMIndex(
        bwt_words=_i32(arrays["bwt_words"], device),
        buckets=_i32(buckets, device),
        sa_samples=_positions(arrays["sa_samples"], dt, "sa_samples", device),
        C=_positions(arrays["C"], dt, "C", device),
        endloc=_positions(arrays["endloc"], dt, "endloc", device).reshape(()),
        length=int(arrays["length"]),
        sa_rate=int(arrays["sa_rate"]) if "sa_rate" in arrays else 32,
        isa_samples=(None if isa is None
                     else _positions(isa, dt, "isa_samples", device)),
    )


def narrow(fmi: FMIndex) -> FMIndex:
    """An int32 copy of a wide index (the same values in the int32
    layout), on the same device; an int32 index comes back as it is.  A
    genome past ``suffix.INT32_MAX_LEN`` bases has no int32 index and
    raises ValueError."""
    if not fmi.wide:
        return fmi
    fmi.require_whole("narrow")
    if fmi.length > suffix.INT32_MAX_LEN:
        raise ValueError(
            f"genome length {fmi.length} exceeds the int32 FM-index cap "
            f"({suffix.INT32_MAX_LEN}): the wide index has no int32 copy")
    b = fmi.buckets
    return dataclasses.replace(
        fmi,
        buckets=torch.cat([b[:, :4], b[:, 8:]], dim=1).contiguous(),
        sa_samples=fmi.sa_samples.to(torch.int32),
        C=fmi.C.to(torch.int32),
        endloc=fmi.endloc.to(torch.int32),
        isa_samples=(None if fmi.isa_samples is None
                     else fmi.isa_samples.to(torch.int32)))


def refuse_wide(fmi: FMIndex, what: str) -> None:
    """Raise ValueError for a wide index: ``what`` has no wide form, as
    ``bwt_tpu`` serves none."""
    if fmi.wide:
        raise ValueError(
            f"{what} does not run on the wide (int64) index, as bwt_tpu's "
            f"does not; index.narrow(fmi) gives an int32 copy of a genome "
            f"under the int32 cap")


def recovery_copy(fmi: FMIndex, err: BaseException) -> FMIndex:
    """The CPU copy of ``fmi`` that a ``config.elastic_fallback`` re-run
    serves from (``err`` is the device failure it recovers from).  A tp
    view has no whole copy, its other blocks living on its peers' cards:
    ``err`` is raised again with that refusal as its cause.  On a dead card
    the copy itself raises the card's error, as ``bwt_tpu``'s host copy
    does."""
    try:
        fmi.require_whole("config.elastic_fallback's CPU re-run")
    except ValueError as refusal:
        raise err from refusal
    return fmi.to("cpu")


def pack_words(codes: torch.Tensor, length: int) -> torch.Tensor:
    """Codes 0..3 -> 16-lane 2-bit words (int32 bit patterns) plus one
    zero pad word, a lane at a time: a byte a base besides the words."""
    BW = codec.BASES_PER_WORD
    nwords = (length + BW - 1) // BW
    padded = torch.zeros(nwords * BW, dtype=torch.uint8, device=codes.device)
    padded[:length] = codes
    lanes = padded.reshape(nwords, BW)
    words = torch.zeros(nwords + 1, dtype=torch.int32, device=codes.device)
    for j in range(BW):
        words[:nwords] |= lanes[:, j].to(torch.int32) << (2 * j)
    return words


def _assemble(bwt_codes, sa_samples, endloc, length: int, sa_rate: int,
              isa_samples=None, *, wide: bool = False) -> FMIndex:
    """``wide=True`` makes the wide index: 12-int bucket rows and int64
    value arrays (``bwt_tpu/index.py:_assemble``)."""
    dt = torch.int64 if wide else torch.int32
    bwt_words = pack_words(bwt_codes, length)
    buckets, totals = rank_ops.make_buckets(bwt_words[:-1], length,
                                            wide=wide)
    C = torch.cat([totals.new_ones(1), 1 + torch.cumsum(totals, 0)])
    return FMIndex(
        bwt_words=bwt_words,
        buckets=buckets,
        sa_samples=sa_samples.to(dt).contiguous(),
        C=C.to(dt),
        endloc=endloc.to(dt).reshape(()),
        length=length,
        sa_rate=sa_rate,
        isa_samples=(None if isa_samples is None
                     else isa_samples.to(dt).contiguous()),
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
    wide (int64) layout past it; ``np.int64`` takes the wide layout at any
    length; int32 past the cap raises ValueError.

    With ``config.elastic_fallback`` set, a device failure during the
    build (``ops._kernels.device_failure``) prints one line on stderr and
    the index is built again on the CPU from the genome's host copy, with
    the same arguments, as ``bwt_tpu`` rebuilds on its CPU backend."""
    from bwt_tpu_torch.config import DEFAULT

    cfg = config or DEFAULT
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
    host = np.ascontiguousarray(np.asarray(seq, dtype=np.uint8))

    def build(device):
        device = (torch.device(device) if device is not None
                  else default_device())
        return _build(host, sa, device, verify, sa_sample_rate, wide)

    return _kernels.elastic(
        cfg, "build_index device run failed", "rebuilding on the CPU backend",
        lambda: build(device), lambda err: build("cpu"))


def _build(host: np.ndarray, sa, device, verify: bool, sa_rate: int,
           wide: bool) -> FMIndex:
    """The build on ``device`` as the stages of a new :data:`LAST_BUILD`.
    The codes stay one byte a base; the sort's record is
    ``suffix.LAST_SORT``."""
    global LAST_BUILD
    record = LAST_BUILD = profiling.Phases()
    length = len(host)
    with profiling.stage(record, "build.upload", device):
        codes = torch.from_numpy(host).to(device)
        if sa is not None:
            sa = (sa if isinstance(sa, torch.Tensor) else torch.from_numpy(
                np.array(sa, np.int32))).to(device, torch.int32)
    if sa is not None:
        if tuple(sa.shape) != (length + 1,):
            raise ValueError(f"sa of shape {tuple(sa.shape)} for a genome of "
                             f"{length} bases (want ({length + 1},))")
        if verify and not suffix.verify_suffix_array(codes, sa):
            raise AssertionError("suffix array verification failed")
        return _finish_index(codes, sa, length, sa_rate, record)
    with profiling.stage(record, "build.sort", device):
        sa, isa = suffix.suffix_array_with_isa(
            codes, dtype=torch.int64 if wide else torch.int32)
    if verify and not suffix.verify_suffix_array(codes, sa):
        raise AssertionError("suffix array verification failed")
    with profiling.stage(record, "build.bwt", device):
        bwt, endloc = suffix.bwt_from_isa(codes, isa)
    with profiling.stage(record, "build.rows", device):
        # the samples alone outlive the sort's arrays
        samples = sa[::sa_rate].clone(), isa[::sa_rate].clone()
        del codes, sa, isa
        return _assemble(bwt, samples[0], endloc, length, sa_rate,
                         samples[1], wide=wide)


def _finish_index(codes: torch.Tensor, sa: torch.Tensor, length: int,
                  sa_rate: int, record: profiling.Phases) -> FMIndex:
    """Finish from a given SA (the sharded build, tests): one scatter
    rebuilds the ISA, then the BWT by the ISA permutation; stages
    ``build.isa``, ``build.bwt`` and ``build.rows`` of ``record``."""
    m = sa.shape[0]
    dev = sa.device
    with profiling.stage(record, "build.isa", dev):
        isa = torch.zeros(m, dtype=torch.int32, device=dev)
        isa[sa.long()] = torch.arange(m, dtype=torch.int32, device=dev)
    with profiling.stage(record, "build.bwt", dev):
        bwt, endloc = suffix.bwt_from_isa(codes, isa)
    with profiling.stage(record, "build.rows", dev):
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
