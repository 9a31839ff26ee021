"""The PyTorch port's DP fill held bit-equal against bwt_tpu (CPU).

The port's plain twin of the CUDA wavefront kernel against the Pallas
kernel in interpret mode, the port's batched stitch (``_dp_core``)
against the JAX package's Pallas path, and the host DP
(``ops/align.py``) against its JAX counterpart.  The CUDA kernel itself
runs only on a card: test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from bwt_tpu.models import batch_exec as jexec
from bwt_tpu.ops import align as jalign
from bwt_tpu.ops import pallas_align
from bwt_tpu.utils.cigar import Cigar as JCigar

from bwt_tpu_torch.models import batch_exec as texec
from bwt_tpu_torch.ops import align as talign
from bwt_tpu_torch.ops import dp_wavefront
from bwt_tpu_torch.utils.cigar import Cigar as TCigar

ALT_SCORING = (1, -2, -9, -1)


def _batch(rng, B, L1, L2):
    """Zero-padded jobs of random lengths, some reads with an N."""
    reads = np.zeros((B, L1), np.int32)
    genomes = np.zeros((B, L2), np.int32)
    for b in range(B):
        l1 = int(rng.integers(1, L1 + 1))
        l2 = int(rng.integers(1, L2 + 1))
        reads[b, :l1] = rng.integers(0, 4, size=l1)
        if rng.random() < 0.3:
            reads[b, int(rng.integers(0, l1))] = 5
        genomes[b, :l2] = rng.integers(0, 4, size=l2)
    return reads, genomes


@pytest.mark.parametrize("B,L1,L2,scoring", [
    (12, 17, 23, None), (10, 14, 20, None), (1, 2, 3, None),
    (8, 32, 32, None), (8, 32, 64, None), (8, 32, 64, ALT_SCORING),
])
def test_plain_wavefront_matches_pallas(rng, B, L1, L2, scoring):
    reads, genomes = _batch(rng, B, L1, L2)
    want_v, want_p = pallas_align.dp_fill_wavefront(
        reads, genomes, interpret=True, scoring=scoring)
    launches = dp_wavefront.LAUNCHES
    got_v, got_p = dp_wavefront.dp_fill_wavefront(
        torch.from_numpy(reads), torch.from_numpy(genomes), scoring=scoring)
    assert dp_wavefront.LAUNCHES == launches  # the CPU never launches
    assert got_v.dtype == torch.int32 and got_p.dtype == torch.int32
    assert np.array_equal(got_v.numpy(), np.asarray(want_v))
    assert np.array_equal(got_p.numpy(), np.asarray(want_p))


def test_wrapper_rejects_bad_inputs():
    r = torch.zeros((4, 8), dtype=torch.int32)
    g = torch.zeros((4, 16), dtype=torch.int32)
    with pytest.raises(TypeError):
        dp_wavefront.dp_fill_wavefront(r.to(torch.int64), g)
    with pytest.raises(ValueError):
        dp_wavefront.dp_fill_wavefront(r, g[:3])
    with pytest.raises(ValueError):
        dp_wavefront.dp_fill_wavefront(r[0], g)
    with pytest.raises(ValueError):
        dp_wavefront.dp_fill_wavefront(
            torch.zeros((8, 4), dtype=torch.int32).t(), g)


@pytest.mark.parametrize("L1,L2", [(32, 32), (32, 64)])
def test_dp_core_matches_pallas_path(rng, L1, L2):
    """The port's batched stitch (gather, fill, endpoint, backtrack, RLE)
    against bwt_tpu's Pallas path on the same jobs, nw and sw, forward
    and reversed, some with more runs than the compact RLE holds."""
    B, Lb, G = 16, 48, 400
    bank = rng.integers(0, 4, size=(8, Lb)).astype(np.int32)
    bank[rng.random(bank.shape) < 0.03] = 5
    genome = rng.integers(0, 4, size=G).astype(np.int32)
    rlen = rng.integers(1, L1 + 1, size=B).astype(np.int32)
    glen = rng.integers(0, L2 + 1, size=B).astype(np.int32)
    fields = [rng.integers(0, 8, size=B), rng.integers(0, Lb - L1, size=B),
              rlen, rng.integers(0, 2, size=B),
              rng.integers(0, G - L2, size=B), glen,
              rng.integers(0, 2, size=B), rng.integers(0, 2, size=B)]
    fields = [np.asarray(f, np.int32) for f in fields]
    want = jexec._dp_core(bank, genome, *fields, L1=L1, L2=L2,
                          impl="pallas_interpret")
    got = texec._dp_core(torch.from_numpy(bank), torch.from_numpy(genome),
                         *(torch.from_numpy(f) for f in fields), L1=L1, L2=L2)
    maxloc, i_res, j_res, nrun, vals, counts, ops = (np.asarray(w)
                                                     for w in want)
    for a, b in zip(got[:4], (maxloc, i_res, j_res, nrun)):
        assert np.array_equal(a.numpy(), b)
    assert np.array_equal(got[6].numpy(), ops.astype(np.int32))
    for k in range(B):
        if nrun[k] <= texec._RLE_R:
            n = nrun[k]
            assert np.array_equal(got[4][k, :n].numpy(), vals[k, :n])
            assert np.array_equal(got[5][k, :n].numpy(), counts[k, :n])
        assert (texec._ops_to_runs(got[6][k].numpy(), i_res[k], j_res[k])
                == jexec._ops_to_runs(ops[k], i_res[k], j_res[k]))


def test_host_dp_matches_bwt_tpu(rng):
    for _ in range(20):
        read = rng.integers(0, 4, size=int(rng.integers(0, 25)))
        if read.size and rng.random() < 0.3:
            read[int(rng.integers(0, read.size))] = 5
        genome = rng.integers(0, 4, size=int(rng.integers(1, 30)))
        for scoring in (None, ALT_SCORING):
            if read.size:
                tv, tp = talign.dp_fill(read, genome, scoring)
                jv, jp = jalign.dp_fill(read, genome, scoring)
                assert np.array_equal(tv, jv) and np.array_equal(tp, jp)
            tc, jc = TCigar(), JCigar()
            assert (talign.nw_fast(read, genome, tc, scoring)
                    == jalign.nw_fast(read, genome, jc, scoring))
            assert tc.render() == jc.render()
            if read.size:
                tc, jc = TCigar(), JCigar()
                talign.sw_fast(read, genome, tc, scoring)
                jalign.sw_fast(read, genome, jc, scoring)
                assert tc.render() == jc.render()

