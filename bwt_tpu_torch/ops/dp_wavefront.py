"""Batched anti-diagonal DP fill: the CUDA kernel's wrapper and its plain
PyTorch twin.

``dp_fill_wavefront(reads, genomes)`` fills, for every job b, the NW DP
matrix of ``reads[b]`` (codes 0-3, 5 = N, zero-padded) against
``genomes[b]`` (codes 0-3, zero-padded) with the reference's scoring
(:mod:`bwt_tpu_torch.ops.align`), and returns ``(vals, ptrs)``, each
(B, L1+L2+1, L1+1) int32, where ``[b, d, i]`` is cell (i, d-i).  It is
bit-equal to ``bwt_tpu.ops.pallas_align.dp_fill_wavefront`` (the Pallas
TPU kernel it replaces), including the cells outside the matrix.

A CUDA tensor runs the hand-written kernel (``csrc/dp_wavefront.cu``)
and nothing else: a build or launch failure raises.  A CPU tensor runs
the plain twin, :func:`dp_fill_wavefront_plain`, which the tests hold
against the JAX package and the card holds the kernel against.
"""

from __future__ import annotations

import torch

from bwt_tpu_torch.ops import _kernels
from bwt_tpu_torch.ops.align import default_scoring

# kernel launches made by dp_fill_wavefront (a plain counter; callers
# reset it to show that a run went through the kernel)
LAUNCHES = 0


def _check(reads: torch.Tensor, genomes: torch.Tensor) -> None:
    for name, t in (("reads", reads), ("genomes", genomes)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if reads.shape[0] != genomes.shape[0]:
        raise ValueError(
            f"batch mismatch: reads {tuple(reads.shape)} vs genomes "
            f"{tuple(genomes.shape)}")
    if reads.device != genomes.device:
        raise ValueError(
            f"reads on {reads.device} but genomes on {genomes.device}")


def dp_fill_wavefront(reads: torch.Tensor, genomes: torch.Tensor, *,
                      scoring=None):
    """(vals, ptrs), each (B, L1+L2+1, L1+1) int32; ``scoring`` =
    (match, mismatch, gap_open, gap_extend), default from config."""
    global LAUNCHES
    _check(reads, genomes)
    scoring = tuple(int(s) for s in (scoring or default_scoring()))
    if reads.device.type == "cpu":
        return dp_fill_wavefront_plain(reads, genomes, scoring=scoring)
    if reads.device.type != "cuda":
        raise ValueError(f"unsupported device {reads.device}")
    B, L1 = reads.shape
    L2 = genomes.shape[1]
    vals = torch.empty((B, L1 + L2 + 1, L1 + 1), dtype=torch.int32,
                       device=reads.device)
    ptrs = torch.empty_like(vals)
    if B == 0:
        return vals, ptrs
    lib = _kernels.library()
    with torch.cuda.device(reads.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dp_wavefront_launch(
            reads.data_ptr(), genomes.data_ptr(), vals.data_ptr(),
            ptrs.data_ptr(), B, L1, L2, *scoring, stream)
    if err != 0:
        raise RuntimeError(f"dp_wavefront kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return vals, ptrs


def dp_fill_wavefront_plain(reads: torch.Tensor, genomes: torch.Tensor, *,
                            scoring=None):
    """The plain PyTorch version of the kernel: one vectorized step per
    anti-diagonal, on any device."""
    MATCH, MISMATCH, GAP_OPEN, GAP_EXTEND = scoring or default_scoring()
    B, L1 = reads.shape
    L2 = genomes.shape[1]
    D, lanes = L1 + L2 + 1, L1 + 1
    dev = reads.device
    vals = torch.zeros((B, D, lanes), dtype=torch.int32, device=dev)
    ptrs = torch.zeros_like(vals)
    i = torch.arange(lanes, device=dev)
    z = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    rvec = torch.cat([z, reads.to(torch.int64)], dim=1)  # rvec[i] = read[i-1]
    # gpad[:, j] = genome[j-1] for j in 1..L2, and 0 for j = 0
    gpad = torch.cat([z, genomes.to(torch.int64)], dim=1)
    prev2 = torch.zeros((B, lanes), dtype=torch.int64, device=dev)
    prev1, pptr1 = prev2, prev2
    for d in range(1, D):
        j = d - i
        g = gpad[:, torch.where((j >= 1) & (j <= L2), j, 0)]
        diag = torch.cat([z, prev2[:, :-1]], dim=1)
        up = torch.cat([z, prev1[:, :-1]], dim=1)
        pup = torch.cat([z, pptr1[:, :-1]], dim=1)
        match = (rvec == 5) | (rvec == g)
        sdiag = diag + torch.where(match, MATCH, MISMATCH)
        sleft = prev1 + GAP_EXTEND + torch.where(pptr1 == 2, 0, GAP_OPEN)
        sup = up + GAP_EXTEND + torch.where(pup == 1, 0, GAP_OPEN)
        v = torch.maximum(torch.maximum(sdiag, sleft), sup)
        p = torch.where(v == sleft, 2, torch.where(v == sup, 1, 0))
        # borders: DP row 0 (i = 0) and column 0 (i = d)
        v[:, 0] = GAP_OPEN + GAP_EXTEND * d
        p[:, 0] = 2
        if d <= L1:
            v[:, d] = GAP_OPEN + GAP_EXTEND * d
            p[:, d] = 1
        vals[:, d] = v.to(torch.int32)
        ptrs[:, d] = p.to(torch.int32)
        prev2, prev1, pptr1 = prev1, v, p
    return vals, ptrs
