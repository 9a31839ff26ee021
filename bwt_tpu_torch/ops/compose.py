"""Phase B's compose: every read's stitch-log run stream merged into its CIGAR
runs, and the per-read result packed for one copy to the host.

The counterpart of ``bwt_tpu.models.aligner._compose_device`` and
``_pack_fetch``.  A read's log, in push order, gives M / I entries as
singleton runs and stitch slots as the blocks the log stitch
(:func:`~bwt_tpu_torch.ops.dp_wavefront.dp_log_stitch`) scattered; the
stream's first ``F2`` runs concatenate and adjacent equal ops merge (count-0
runs are kept: the C stack prints "0M"), at most ``K`` merged runs kept.  Per
read the output row holds, as int32 words:

  0  ``res``, the return value: curpos for mode 2, curpos minus the head
     stitch's endpoint for mode 1, else 0;
  1  ``meta``, ``bwt_tpu``'s bits: mode (2 bits) | strand << 2 | a stitch
     with more runs than the RLE width << 3 | a merged-run overflow (past
     ``K`` runs, past ``F2`` stream entries, or a count past int16) << 4 |
     ovf << 5 | capped << 6 | more than 8 runs or a count past 254 << 7;
  2  the merged run count, at most ``K + 1``;
  3  the first ``K`` ops, 2 bits each (op + 1, 0 for none);
  4..11  the first 8 counts, clipped to 0..255.

A read with bit 3, 4 or 7 set is re-composed on the host (the redo path);
bits 5 and 6 send it to the host generators.  ``bwt_tpu`` squeezed this row
to about 6 bytes for the TPU's host link; here the 48 bytes cross PCIe.

On the card this is one launch of ``csrc/compose.cu`` (K11b), one thread a
read; on the CPU, or anywhere with ``plain``, :func:`compose_plain`.
"""

from __future__ import annotations

import torch

from bwt_tpu_torch.ops import _kernels
from bwt_tpu_torch.ops import automaton as au
from bwt_tpu_torch.ops import dp_wavefront as dpw

RUNS_K = 16   # merged runs a read keeps on the device
F2 = 48       # stream entries a read's merge reads
OUT_W = 12    # int32 words of a read's output row

# kernel launches made by compose (a plain counter)
COMPOSE_LAUNCHES = 0


def compose_runs_plain(kinds, glens, lp, mode, curpos, head_end, runs_oc,
                       bl3, *, K: int = RUNS_K):
    """``bwt_tpu``'s ``_compose_device`` on int32 tensors: (fo, fc, nrun,
    res, over), the merged ops and counts (n, K) with the values of its int8
    and int16 outputs, the run count (at most K + 1), the return value and
    the overflow flag."""
    n, logn, W = runs_oc.shape
    dev = runs_oc.device
    slot = torch.arange(logn, device=dev)[None, :]
    vmask = slot < lp.clamp(max=logn)[:, None]
    mm = vmask & (kinds == au.K_M)
    im = vmask & (kinds == au.K_I)
    single = mm | im
    runs_oc = runs_oc.clone()
    runs_oc[:, :, 0] = torch.where(
        single, (torch.where(mm, 2, 3) << 24) | glens, runs_oc[:, :, 0])
    bl = torch.where(single, 1, torch.where(vmask, bl3, 0))
    offs = torch.cumsum(bl, 1) - bl
    cnt = offs[:, -1] + bl[:, -1]
    p = torch.arange(F2, device=dev)
    sel = (offs[:, :, None] <= p[None, None, :]).sum(1) - 1
    selc = sel.clamp(0, logn - 1)
    wi = p[None, :] - offs.gather(1, selc)
    src = selc * W + wi.clamp(0, W - 1)
    inr = p[None, :] < cnt[:, None]
    soc = torch.where(inr, runs_oc.reshape(n, logn * W).gather(1, src),
                      1 << 24).to(torch.int32)
    so = (soc >> 24) - 2
    sc = soc & 0xFFFFFF
    prev = torch.cat([torch.full((n, 1), -2, dtype=torch.int32, device=dev),
                      so[:, :-1]], 1)
    new = inr & ((p[None, :] == 0) | (so != prev))
    rid = torch.cumsum(new.to(torch.int32), 1) - 1
    nrun = torch.where(inr, rid, -1).amax(1) + 1
    ok = inr & (rid < K)
    rows = torch.arange(n, device=dev)[:, None]
    tgt = torch.where(ok, rows * K + rid, n * K)
    pk = (torch.where(new & ok, (so + 2) << 24, 0)
          + torch.where(ok, sc, 0)).to(torch.int32)
    fpk = torch.zeros(n * K + 1, dtype=torch.int32, device=dev).index_add_(
        0, tgt.reshape(-1), pk.reshape(-1))[:n * K].reshape(n, K)
    fo = torch.where(fpk != 0, (fpk >> 24) - 2, -1)
    fc = fpk & 0xFFFFFF
    res = torch.where(mode == 2, curpos,
                      torch.where(mode == 1, curpos - head_end, 0))
    over = (nrun > K) | (fc > 32767).any(1) | (cnt > F2)
    return (au.wrap_signed(fo, 8), au.wrap_signed(fc, 16), nrun.clamp(max=K + 1).to(torch.int32),
            res.to(torch.int32), over)


def compose_plain(log, acc, *, K: int = RUNS_K) -> torch.Tensor:
    """The plain PyTorch version of K11b, on any device: (Bp, OUT_W) int32
    from the packed automaton output ``log`` and the stitches' accumulators
    ``acc`` (:func:`~bwt_tpu_torch.ops.dp_wavefront.log_acc`)."""
    v = au.align_unpack(log)
    runs_oc, bl3, head_end, over_rle = dpw.acc_unpack(acc)
    fo, fc, nrun, res, over = compose_runs_plain(
        v["kinds"], v["glens"], v["lp"], v["mode"], v["curpos"], head_end,
        runs_oc, bl3, K=K)
    n = fo.shape[0]
    dev = fo.device
    shifts = 2 * torch.arange(K, dtype=torch.int64, device=dev)
    ops = (((fo.to(torch.int64) + 1) & 3) << shifts[None, :]).sum(1)
    fc8 = torch.zeros((n, 8), dtype=torch.int32, device=dev)
    k8 = min(K, 8)
    fc8[:, :k8] = fc[:, :k8].clamp(0, 255)
    over8 = (nrun > 8) | (fc[:, :k8] > 254).any(1)
    meta = (v["mode"] | (v["strand"] << 2)
            | ((over_rle > 0).to(torch.int32) << 3)
            | (over.to(torch.int32) << 4) | (v["ovf"] << 5)
            | (v["capped"] << 6) | (over8.to(torch.int32) << 7))
    return torch.cat([torch.stack([res, meta, nrun,
                                   au.wrap_signed(ops, 32).to(torch.int32)], 1), fc8],
                     1)


def compose(log, acc, *, K: int = RUNS_K, plain: bool = False
            ) -> torch.Tensor:
    """The compose of one chunk: (Bp, OUT_W) int32 rows (see the module's
    docstring).  On the card one launch of K11b, without synchronising; on
    the CPU, or anywhere with ``plain``, :func:`compose_plain`."""
    global COMPOSE_LAUNCHES
    if not 1 <= K <= 16:
        raise ValueError(f"K = {K} outside 1..16 (2-bit ops in one word)")
    dev = log.device
    if plain or dev.type == "cpu":
        return compose_plain(log, acc, K=K)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    Bp = au.align_lanes(log)
    for name, t in (("log", log), ("acc", acc)):
        if (t.device != dev or t.dtype != torch.int32
                or not t.is_contiguous() or t.dim() != 1):
            raise ValueError(f"{name} must be a flat contiguous int32 tensor "
                             f"on {dev}")
    if acc.shape != ((au.LOGN * (dpw.BLOCK_W + 1) + 2) * Bp,):
        raise ValueError(f"acc must be log_acc({Bp})")
    out = torch.empty((Bp, OUT_W), dtype=torch.int32, device=dev)
    if Bp:
        lib = _kernels.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.compose_launch(log.data_ptr(), Bp, acc.data_ptr(),
                                     dpw.BLOCK_W, K, F2, out.data_ptr(),
                                     stream)
        _kernels.check_launch(err, "compose kernel launch")
        COMPOSE_LAUNCHES += 1
    return out
