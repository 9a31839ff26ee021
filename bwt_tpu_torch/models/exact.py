"""Batched exact anchored search: the search_reads.c model family.

``anchor_scan`` runs the per-read anchor loop of search_reads.c:115-133
over a whole batch.  On the card it is one launch of
``csrc/anchor_scan.cu``: one thread per read runs every trip of the hunt
(a backward search with N resolution over the read's current prefix) and
then the SA walk of its last anchor.  On the CPU it is the plain version,
``anchor_scan_plain``: a host loop of lockstep trips over the plain
backward search, then one plain SA walk.

Semantics note (as in ``bwt_tpu.models.exact``): the reference main never
converts read ASCII to 2-bit codes before calling ``mms``
(search_reads.c:102-118), so the shipped binary indexes ``fmi->C[]`` with
ASCII values and in practice anchors nothing.  This module implements
the intended semantics (reads encoded as single_align encodes them).
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from bwt_tpu_torch import codec
from bwt_tpu_torch.index import FMIndex
from bwt_tpu_torch.ops import search

MIN_ANCHOR = 20  # search_reads.c:115,119
PAIR_WINDOW = 10000  # search_reads.c:154

# the code types _encode_batch(narrow=True) returns, as torch names them
_TORCH_DTYPE = {np.dtype(np.int32): torch.int32,
                np.dtype(np.uint8): torch.uint8,
                np.dtype(np.int8): torch.int8}


def anchor_scan_plain(fmi: FMIndex, patterns, lengths, *,
                      min_anchor: int = MIN_ANCHOR):
    """The plain PyTorch version of the anchor-scan kernel, on any
    device: lockstep trips of :func:`search.backward_search_plain`, then
    one :func:`search.unc_sa_plain` of the last anchors' interval starts.
    Finished reads ride along as length-1 prefixes, which cost one step.
    A trip that is an anchor and consumes nothing (matched + skipped <= 0,
    which needs ``min_anchor <= 0``) would repeat forever: it raises
    RuntimeError."""
    patterns = torch.as_tensor(patterns, dtype=torch.int32,
                               device=fmi.device).contiguous()
    len_b = torch.as_tensor(lengths, dtype=torch.int32, device=fmi.device)
    nmatch = torch.zeros_like(len_b)
    anchor_sp = torch.zeros_like(len_b)
    while True:
        active = len_b > min_anchor
        if not bool(active.any()):
            break
        r = search.backward_search_plain(fmi, patterns,
                                         torch.where(active, len_b, 1),
                                         resolve_n=True)
        m = r["nmatched"] + r["skips"]
        got = active & (m >= min_anchor)
        stuck = got & (m <= 0)
        if bool(stuck.any()):
            raise search.no_progress(int(stuck.to(torch.int8).argmax()),
                                     min_anchor)
        anchor_sp = torch.where(got, r["sp"], anchor_sp)
        nmatch = nmatch + got.to(torch.int32)
        len_b = torch.where(active, torch.where(got, len_b - m, len_b - 1),
                            len_b)
    pos = torch.where(nmatch > 0, search.unc_sa_plain(fmi, anchor_sp), -1)
    return nmatch, pos


def anchor_scan_mesh(mesh, fmi_r, patterns, lengths, *,
                     min_anchor: int = MIN_ANCHOR, reverse: bool = False):
    """:func:`anchor_scan` of this rank's contiguous share of the batch
    along the mesh's 'dp' axis, on its device (one launch of the kernel on
    a card).  The batch must divide the dp size (callers pad).  Returns the
    rank's (B / dp,) shards of ``(n_anchors, last_anchor_pos)``, where
    ``bwt_tpu`` returns global arrays; ``parallel.gather_hits`` joins
    them.  ``fmi_r`` is the index on the rank's device
    (``parallel.replicate_index``), or for a mesh with tp > 1 a tp view of
    its shard (``parallel.shard_index``), whose kernel reads the blocks
    through their table and whose plain version all-reduces over 'tp'."""
    from bwt_tpu_torch.parallel import mesh as pmesh

    served = (pmesh.serving_index(fmi_r, mesh) if mesh.shape["tp"] > 1
              else fmi_r)
    p, ln = pmesh.shard_patterns(patterns, lengths, mesh)
    out = anchor_scan(served, p, ln, min_anchor=min_anchor, reverse=reverse)
    pmesh.done_serving(served, fmi_r)
    return out


def _plain_reverse(pat: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Each read's ``pattern[:len]`` reversed (not complemented),
    left-aligned and zero-padded like ``pat``:
    ``out[b, j] = pat[b, clip(len - 1 - j, 0, L - 1)]`` for ``j < len``."""
    L = pat.shape[1]
    j = torch.arange(L, dtype=torch.int32, device=pat.device)[None, :]
    src = (lens[:, None] - 1 - j).clamp(0, max(L - 1, 0)).long()
    return torch.where(j < lens[:, None], pat.gather(1, src), 0)


def _card_reads(fmi: FMIndex, patterns, lengths):
    """Reads as the anchor-scan kernel takes them: contiguous on the
    index's device, lengths int32, codes int32, uint8 or int8 as they
    came (any other type becomes int32)."""
    patterns = torch.as_tensor(patterns, device=fmi.device)
    if patterns.dtype not in (torch.int32, torch.uint8, torch.int8):
        patterns = patterns.to(torch.int32)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=fmi.device)
    return patterns.contiguous(), lengths.contiguous()


def anchor_scan(fmi: FMIndex, patterns, lengths, *,
                min_anchor: int = MIN_ANCHOR, reverse: bool = False):
    """Anchor hunt.  Per read: repeatedly MMS the current prefix; an
    anchor of >= min_anchor consumes its length, anything else shrinks
    the prefix by one (search_reads.c:115-133).  Returns ``(n_anchors,
    last_anchor_pos)`` as (B,) int32 tensors; the position is the
    locate() of the most recent anchor, -1 if none.  With ``reverse``
    each read is hunted plain-reversed (:func:`_plain_reverse`).  A hunt
    that cannot end (see :func:`anchor_scan_plain`) and a walk from a row
    past the suffix array raise RuntimeError.  On the card this is one
    launch of the anchor-scan kernel; on the CPU, the plain version."""
    if search._on_card(fmi):
        patterns, lengths = _card_reads(fmi, patterns, lengths)
        out = search.anchor_scan_kernel(fmi, patterns, lengths,
                                        min_anchor=min_anchor,
                                        reverse=reverse)
        search.anchor_scan_raise(fmi, out, min_anchor)
        B = lengths.shape[0]
        return out[:B], out[B:2 * B]
    patterns = torch.as_tensor(patterns, dtype=torch.int32, device=fmi.device)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=fmi.device)
    if reverse:
        patterns = _plain_reverse(patterns, lengths)
    return anchor_scan_plain(fmi, patterns, lengths, min_anchor=min_anchor)


def _encode_batch(reads, narrow: bool = False):
    """Reads (strings, bytes or code arrays, or one (B, L) code array) ->
    left-aligned (B, L) int32 codes and (B,) lengths, L the longest read.
    Ragged batches fill with one scatter, not a loop over reads.  With
    ``narrow``, codes that came one byte wide (encoded strings, a uint8
    or int8 array) stay so, uncopied where they can."""
    pat, lens = _encode_codes(reads)
    if narrow and pat.dtype in (np.uint8, np.int8):
        return pat, lens
    return pat.astype(np.int32, copy=False), lens


def _encode_codes(reads):
    if isinstance(reads, np.ndarray) and reads.ndim == 2:
        return reads, np.full((reads.shape[0],), reads.shape[1], np.int32)
    B = len(reads)
    if B and all(type(r) is str for r in reads):
        flat = codec.encode_read("".join(reads))
        lens = np.fromiter(map(len, reads), np.int32, B)
    else:
        arrs = [codec.encode_read(r) if isinstance(r, (str, bytes))
                else np.asarray(r) for r in reads]
        lens = np.fromiter((len(a) for a in arrs), np.int32, B)
        flat = np.concatenate(arrs) if B else np.zeros((0,), np.int32)
    L = int(lens.max()) if B else 1
    if B and (lens == L).all():
        return flat.reshape(B, L), lens
    pat = np.zeros((B, L), flat.dtype)
    rows = np.repeat(np.arange(B), lens)
    starts = np.cumsum(lens) - lens
    pat[rows, np.arange(flat.size) - np.repeat(starts, lens)] = flat
    return pat, lens


def _scan_on_cpu(fmi: FMIndex, pat, lens, min_anchor: int, batch: int):
    """Both directions of every chunk through the plain version."""
    out = [np.zeros((pat.shape[0],), np.int32) for _ in range(4)]
    for lo in range(0, pat.shape[0], batch):
        p = torch.from_numpy(np.ascontiguousarray(pat[lo:lo + batch]))
        ln = torch.from_numpy(lens[lo:lo + batch])
        res = (*anchor_scan(fmi, p, ln, min_anchor=min_anchor),
               *anchor_scan(fmi, p, ln, min_anchor=min_anchor, reverse=True))
        for dst, t in zip(out, res):
            dst[lo:lo + batch] = t.numpy()
    return out


def _scan_on_card(fmi: FMIndex, pat, lens, min_anchor: int, batch: int):
    """Both directions of every chunk through the anchor-scan kernel, two
    chunks in flight.  A chunk is staged in one of two pinned buffers,
    uploaded, scanned forward and reversed into one (2, 2n + 4) output
    (counts, positions and the kernel's flag for each direction) and
    copied back to pinned memory, all on the current stream; an event
    after the copy says when its buffers may be read and reused, which is
    just before the chunk after next is staged."""
    dev = fmi.device
    B, L = pat.shape
    n = min(batch, B)
    out = [np.empty((B,), np.int32) for _ in range(4)]  # chunks fill it
    if not B:
        return out
    slots = [(torch.empty((n, L), dtype=_TORCH_DTYPE[pat.dtype],
                          pin_memory=True),
              torch.empty((n,), dtype=torch.int32, pin_memory=True),
              torch.empty((2 * (2 * n + 4),), dtype=torch.int32,
                          pin_memory=True)) for _ in range(2)]
    pending = collections.deque()

    def harvest():
        lo, nb, host, event = pending.popleft()
        event.synchronize()
        host = host.numpy()
        for d in range(2):
            search.anchor_scan_raise(fmi, host[d], min_anchor, first=lo)
            out[2 * d][lo:lo + nb] = host[d, :nb]
            out[2 * d + 1][lo:lo + nb] = host[d, nb:2 * nb]

    for i, lo in enumerate(range(0, B, batch)):
        if len(pending) == 2:
            harvest()  # frees the slot this chunk takes
        stage_p, stage_l, stage_out = slots[i % 2]
        nb = min(batch, B - lo)
        stage_p[:nb].numpy()[...] = pat[lo:lo + nb]
        stage_l[:nb].numpy()[...] = lens[lo:lo + nb]
        p = stage_p[:nb].to(dev, non_blocking=True)
        ln = stage_l[:nb].to(dev, non_blocking=True)
        res = torch.zeros((2, 2 * nb + 4), dtype=torch.int32, device=dev)
        for d in range(2):
            search.anchor_scan_kernel(fmi, p, ln, min_anchor=min_anchor,
                                      reverse=bool(d), out=res[d])
        host = stage_out[:res.numel()].view_as(res)
        host.copy_(res, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        pending.append((lo, nb, host, event))
    while pending:
        harvest()
    return out


def search_reads(fmi: FMIndex, reads, *, min_anchor: int | None = None,
                 pair_window: int | None = None, config=None, mesh=None):
    """The search_reads pipeline: anchor-scan each read forward and
    PLAIN-REVERSED (reversed but not complemented — the reference's
    deliberate quirk, search_reads.c:112-114), then flag reads whose two
    direction positions fall within ``pair_window``
    (search_reads.c:154-159).  Reads go to the device in chunks of
    ``config.search_batch``: on the card each chunk is one upload from
    pinned memory (one byte a code where the reads came so), two launches
    of the anchor-scan kernel (the second reads the same array reversed)
    and one copy back, the next chunk queued while it runs.

    Returns a dict of numpy arrays: ``fwd_matches, fwd_pos, rev_matches,
    rev_pos, paired``.

    ``mesh``: a :class:`bwt_tpu_torch.parallel.Mesh`: each rank scans its
    contiguous share of the reads along 'dp' (``parallel.mesh.share``,
    shares of ceil(B / dp), so no pad reads) on its own device, chunk by
    chunk as above, and one all-gather along 'dp' gives every rank the
    whole result in read order, equal to the single-device run's.  With
    tp > 1 the ranks of a tp group scan the same share over a tp view
    (``parallel.mesh.serving_index``: ``fmi`` itself if it is one)."""
    from bwt_tpu_torch.config import DEFAULT

    cfg = config or DEFAULT
    if mesh is not None:
        from bwt_tpu_torch.parallel import mesh as pmesh

        given, fmi = fmi, pmesh.serving_index(fmi, mesh)
    if cfg.elastic_fallback:
        raise NotImplementedError(
            "config.elastic_fallback is not ported (ROADMAP Queue 1: "
            "multi-device and recovery)")
    min_anchor = cfg.min_anchor if min_anchor is None else min_anchor
    pair_window = cfg.pair_window if pair_window is None else pair_window
    pat, lens = _encode_batch(reads, narrow=True)
    if pat.shape[1] > cfg.max_read_len:
        raise ValueError(
            f"read length {pat.shape[1]} exceeds config.max_read_len "
            f"{cfg.max_read_len} (search_reads.c:30's 256*256 buffer)")
    if mesh is not None:
        lo, hi = pmesh.share(pat.shape[0], mesh)
        pat, lens = pat[lo:hi], lens[lo:hi]
    scan = _scan_on_card if search._on_card(fmi) else _scan_on_cpu
    fm, fp, bm, bp = scan(fmi, pat, lens, min_anchor, cfg.search_batch)
    if mesh is not None:
        pmesh.done_serving(fmi, given)
        with pmesh.merging():
            fm, fp, bm, bp = pmesh.gather_batch(
                mesh, np.stack([fm, fp, bm, bp], axis=1)).T
    paired = (fm > 0) & (bm > 0) & (np.abs(fp - bp) < pair_window)
    return dict(fwd_matches=fm, fwd_pos=fp, rev_matches=bm, rev_pos=bp,
                paired=paired)


def format_ref_output(reads, result) -> str:
    """Render like the search_reads main loop (search_reads.c:100-161):
    header line, then a three-line block per paired read."""
    out = ["Beginning alignment\n"]
    for n, r in enumerate(reads):
        if result["paired"][n]:
            out.append(
                "\nRead %d: Aligned both forward (%d) and backward (%d)\n"
                % (n, result["fwd_matches"][n], result["rev_matches"][n]))
            out.append("At locations %d and %d respectively\n"
                       % (result["fwd_pos"][n], result["rev_pos"][n]))
            out.append(f"{r}\n" if isinstance(r, str)
                       else codec.decode(r) + "\n")
    return "".join(out)
