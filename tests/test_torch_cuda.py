"""bwt_tpu_torch on an NVIDIA card: the CUDA kernel against its plain
twin, and the port's main path on the card against the same path on the
CPU (which the other test_torch_*.py files hold against bwt_tpu).

Every test carries the ``cuda`` marker and skips without a card.  The
file imports neither jax nor bwt_tpu, so it also runs where jax is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import bwt_tpu_torch
from bwt_tpu_torch import codec
from bwt_tpu_torch.models import aligner
from bwt_tpu_torch.ops import dp_wavefront, search

pytestmark = pytest.mark.cuda

ALT_SCORING = (1, -2, -9, -1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _jobs(rng, B, L1, L2):
    reads = np.zeros((B, L1), np.int32)
    genomes = np.zeros((B, L2), np.int32)
    for b in range(B):
        l1, l2 = int(rng.integers(1, L1 + 1)), int(rng.integers(1, L2 + 1))
        reads[b, :l1] = rng.integers(0, 4, size=l1)
        reads[b, rng.integers(0, l1, size=l1 // 16)] = 5
        genomes[b, :l2] = rng.integers(0, 4, size=l2)
    return reads, genomes


@pytest.mark.parametrize("B,L1,L2", [(1, 2, 3), (8, 32, 32), (64, 32, 64),
                                     (33, 96, 128), (4, 1100, 40)])
def test_kernel_matches_plain(card, B, L1, L2):
    """Bit-equal at the stitch shapes, at an odd batch, and at L1 past
    one block's 1,024 threads."""
    rng = np.random.default_rng(B * 1000 + L1)
    reads, genomes = _jobs(rng, B, L1, L2)
    r = torch.from_numpy(reads).to(card)
    g = torch.from_numpy(genomes).to(card)
    for scoring in (None, ALT_SCORING):
        launches = dp_wavefront.LAUNCHES
        vk, pk = dp_wavefront.dp_fill_wavefront(r, g, scoring=scoring)
        vp, pp = dp_wavefront.dp_fill_wavefront_plain(r, g, scoring=scoring)
        torch.cuda.synchronize()
        assert dp_wavefront.LAUNCHES == launches + 1
        assert torch.equal(vk, vp) and torch.equal(pk, pp)


def test_wrapper_raises_on_card(card):
    r = torch.zeros((4, 8), dtype=torch.int32, device=card)
    g = torch.zeros((4, 16), dtype=torch.int32, device=card)
    launches = dp_wavefront.LAUNCHES
    with pytest.raises(TypeError):
        dp_wavefront.dp_fill_wavefront(r.to(torch.int64), g)
    with pytest.raises(ValueError):
        dp_wavefront.dp_fill_wavefront(r, g.cpu())
    assert dp_wavefront.LAUNCHES == launches


def test_main_path_on_card_matches_cpu(card):
    """build_index, locate and align_reads on the card equal the CPU run,
    and the aligner's DP stitches went through the kernel."""
    g = codec.random_genome(30000, seed=11)
    codes = codec.encode_genome(g)
    on_card = bwt_tpu_torch.build_index(g, sa_sample_rate=8, device=card)
    on_cpu = bwt_tpu_torch.build_index(g, sa_sample_rate=8, device="cpu")
    assert on_card.device.type == "cuda"
    a, b = on_card.to_numpy(), on_cpu.to_numpy()
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k

    rng = np.random.default_rng(3)
    starts = rng.integers(0, len(g) - 30, size=2000)
    pats = codes[np.add.outer(starts, np.arange(30))].astype(np.int32)
    lens = np.full(2000, 30, np.int32)
    want = search.locate(on_cpu, pats, lens).numpy()
    assert np.array_equal(search.locate(on_card, pats, lens).cpu().numpy(),
                          want)

    reads = []
    for k in range(300):
        s = int(rng.integers(0, len(g) - 80))
        r = list(g[s:s + 80])
        r[int(rng.integers(0, 80))] = "ACGT"[int(rng.integers(0, 4))]
        if k % 7 == 0:
            del r[40:42]
        if k % 11 == 0:
            r[10] = "N"
        reads.append("".join(r))
    launches = dp_wavefront.LAUNCHES
    got = aligner.align_reads(on_card, g, reads, with_strand=True)
    assert dp_wavefront.LAUNCHES > launches
    want = aligner.align_reads(on_cpu, g, reads, with_strand=True)
    assert ([(p, c.render() if c else None, s) for p, c, s in got]
            == [(p, c.render() if c else None, s) for p, c, s in want])
    assert sum(1 for p, _, _ in got if p) > 250
