"""The PyTorch port's DP fill and stitch held bit-equal against bwt_tpu
(CPU).

The port's plain twin of the CUDA wavefront kernel against the Pallas
kernel in interpret mode, the port's batched stitch (``_dp_core`` over
``dp_stitch`` / ``dp_stitch_plain``) against the JAX package's Pallas
path, and the host DP (``ops/align.py``) against its JAX counterpart.
The CUDA kernels themselves run only on a card: test_torch_cuda.py."""

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


def _assert_stitch_equal(got, want, fields):
    """The port's seven stitch outputs against bwt_tpu's: the four small
    rows and the op rows everywhere, the runs where the compact form
    holds them, and the decoded runs of every job."""
    maxloc, i_res, j_res, nrun, vals, counts, ops = (np.asarray(w)
                                                     for w in want)
    for a, b in zip(got[:4], (maxloc, i_res, j_res, nrun)):
        assert a.dtype == torch.int32
        assert np.array_equal(a.numpy(), b)
    assert np.array_equal(got[6].numpy(), ops.astype(np.int32))
    for k in range(len(nrun)):
        if nrun[k] <= texec._RLE_R:
            n = nrun[k]
            assert np.array_equal(got[4][k, :n].numpy(), vals[k, :n])
            assert np.array_equal(got[5][k, :n].numpy(), counts[k, :n])
        assert (texec._ops_to_runs(got[6][k].numpy(), i_res[k], j_res[k])
                == jexec._ops_to_runs(ops[k], i_res[k], j_res[k]))


@pytest.mark.parametrize("L1,L2", [(32, 32), (32, 64), (64, 64)])
def test_dp_core_matches_pallas_path(rng, L1, L2):
    """The port's batched stitch (gather, fill, endpoint, backtrack, RLE)
    against bwt_tpu's Pallas path on the same jobs, nw and sw, forward
    and reversed, some with more runs than the compact RLE holds."""
    B, Lb, G = 16, L1 + 16, 400
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
    launches = dp_wavefront.LAUNCHES, dp_wavefront.STITCH_LAUNCHES
    got = texec._dp_core(torch.from_numpy(bank), torch.from_numpy(genome),
                         *(torch.from_numpy(f) for f in fields), L1=L1, L2=L2)
    # the CPU never launches
    assert (dp_wavefront.LAUNCHES, dp_wavefront.STITCH_LAUNCHES) == launches
    _assert_stitch_equal(got, want, fields)


def _edge_jobs(L1, L2):
    """A bank, a genome and (8, B) job fields of the corners of a (L1, L2)
    bucket: rlen 0 and L1, glen 0 and L2, an all-N read, a read cut from
    the genome, a job whose walk has more runs than the compact form
    keeps (every A matches, every C / G pair is an I and a D, under the
    scoring below), reversed slices, and all-zero padding lanes."""
    Lb, G = L1 + 16, 300
    rng = np.random.default_rng(L1 * 100 + L2)
    bank = rng.integers(0, 4, size=(8, Lb)).astype(np.int32)
    genome = rng.integers(0, 4, size=G).astype(np.int32)
    bank[0] = 0
    bank[0, 1::2] = 1          # ACAC...
    genome[:100] = 0
    genome[1:100:2] = 2        # AGAG...
    bank[1] = 5                # all N
    bank[2] = genome[120:120 + Lb]
    jobs = [  # row roff rlen rrev gstart glen grev want_nw
        (0, 0, L1, 0, 0, L2, 0, 0), (0, 0, L1, 0, 0, L2, 0, 1),
        (0, 2, L1, 1, 4, L2, 1, 0),
        (1, 0, L1, 0, 150, L2, 0, 1), (1, 3, 7, 1, 150, 9, 0, 0),
        (2, 0, L1, 0, 120, L2, 0, 0), (2, 0, L1, 0, 120, L2, 0, 1),
        (2, 0, L1, 1, 120, L2, 1, 1),
        (3, 5, 0, 0, 200, L2, 0, 1), (3, 5, 0, 0, 200, L2, 0, 0),
        (4, 0, L1, 0, 200, 0, 0, 1), (4, 0, L1, 1, 200, 0, 0, 0),
        (5, 1, 0, 0, 10, 0, 0, 1), (6, 0, L1, 0, G - L2, L2, 0, 0),
        (7, Lb - 5, 5, 0, G - 3, 3, 0, 1),
    ]
    f = np.zeros((8, 32), np.int32)  # padded to a power of two with zeros
    f[:, : len(jobs)] = np.array(jobs, np.int32).T
    return bank, genome, f


@pytest.mark.parametrize("scoring", [None, (1, -9, 0, 0)],
                         ids=["default", "free-gaps"])
def test_dp_core_edge_jobs_match_pallas_path(scoring):
    L1 = L2 = 32
    bank, genome, f = _edge_jobs(L1, L2)
    want = jexec._dp_core(bank, genome, *f, L1=L1, L2=L2, scoring=scoring,
                          impl="pallas_interpret")
    got = texec._dp_core(torch.from_numpy(bank), torch.from_numpy(genome),
                         *torch.from_numpy(f).unbind(0), L1=L1, L2=L2,
                         scoring=scoring)
    _assert_stitch_equal(got, want, f)
    nrun = got[3].numpy()
    assert not nrun[15:].any()  # the padding lanes walk nowhere
    if scoring is not None:
        assert nrun[0] > texec._RLE_R  # decoded from the op row
    # the stitch itself returns the first six side by side in one tensor
    P, ops = dp_wavefront.dp_stitch(
        torch.from_numpy(bank), torch.from_numpy(genome),
        *torch.from_numpy(f).unbind(0), L1=L1, L2=L2, scoring=scoring)
    assert P.shape == (32, 4 + 2 * texec._RLE_R) and P.dtype == torch.int32
    for a, b in zip(dp_wavefront.unpack(P), got[:6]):
        assert torch.equal(a, b)
    assert torch.equal(P, dp_wavefront.pack(*got[:6]))
    assert torch.equal(ops, got[6])
    via_plain = texec._dp_core(
        torch.from_numpy(bank), torch.from_numpy(genome),
        *torch.from_numpy(f).unbind(0), L1=L1, L2=L2, scoring=scoring,
        plain=True)
    for a, b in zip(via_plain, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("scoring", [None, ALT_SCORING])
def test_stitch_reads_no_cell_outside_the_job(scoring):
    """The stitch's outputs depend only on cells with i <= rlen and
    0 <= j <= glen: a fill whose every other cell is garbage gives the
    same seven outputs (the fused kernel computes none of them)."""
    L1, L2 = 32, 64
    bank, genome, f = _edge_jobs(L1, L2)
    rng = np.random.default_rng(7)
    f[2, 15:] = rng.integers(0, L1 + 1, size=17)
    f[5, 15:] = rng.integers(0, L2 + 1, size=17)
    f[7, 15:] = rng.integers(0, 2, size=17)
    rlen = torch.from_numpy(f[2]).long()
    glen = torch.from_numpy(f[5]).long()

    def spoiled_fill(reads, genomes, scoring=None):
        vals, ptrs = dp_wavefront.dp_fill_wavefront_plain(reads, genomes,
                                                          scoring=scoring)
        D, lanes = vals.shape[1:]
        i = torch.arange(lanes)[None, None, :]
        j = torch.arange(D)[None, :, None] - i
        outside = ((i > rlen[:, None, None]) | (j > glen[:, None, None])
                   | (j < 0))
        junk = torch.from_numpy(
            rng.integers(-9999, 9999, size=tuple(vals.shape)).astype(np.int32))
        return (torch.where(outside, junk, vals),
                torch.where(outside, junk % 3, ptrs))

    args = (torch.from_numpy(bank), torch.from_numpy(genome),
            *torch.from_numpy(f).unbind(0))
    want = dp_wavefront.dp_stitch_plain(*args, L1=L1, L2=L2, scoring=scoring)
    got = dp_wavefront.dp_stitch_plain(*args, L1=L1, L2=L2, scoring=scoring,
                                       fill=spoiled_fill)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_stitch_wrapper_rejects_bad_inputs():
    bank = torch.zeros((4, 48), dtype=torch.int32)
    genome = torch.zeros(100, dtype=torch.int32)
    f = [torch.zeros(8, dtype=torch.int32) for _ in range(8)]
    launches = dp_wavefront.STITCH_LAUNCHES
    with pytest.raises(TypeError):
        dp_wavefront.dp_stitch(bank.to(torch.int64), genome, *f, L1=32, L2=32)
    with pytest.raises(TypeError):
        dp_wavefront.dp_stitch(bank, genome, f[0].to(torch.int64), *f[1:],
                               L1=32, L2=32)
    with pytest.raises(TypeError):
        dp_wavefront.dp_stitch(bank, genome.numpy(), *f, L1=32, L2=32)
    with pytest.raises(ValueError):  # tensors on two devices
        dp_wavefront.dp_stitch(bank, genome.to("meta"), *f, L1=32, L2=32)
    with pytest.raises(ValueError):
        dp_wavefront.dp_stitch(bank, genome, *f[:7], f[7].to("meta"),
                               L1=32, L2=32)
    with pytest.raises(ValueError):
        dp_wavefront.dp_stitch(bank, genome, *f[:7], f[7][:4], L1=32, L2=32)
    with pytest.raises(ValueError):
        dp_wavefront.dp_stitch(bank[0], genome, *f, L1=32, L2=32)
    with pytest.raises(ValueError):
        dp_wavefront.dp_stitch(bank, genome, *f, L1=-1, L2=32)
    assert dp_wavefront.STITCH_LAUNCHES == launches
    P, ops = dp_wavefront.dp_stitch(bank, genome, *f, L1=32, L2=32)
    assert tuple(P.shape) == (8, 84) and tuple(ops.shape) == (8, 65)
    assert [tuple(t.shape) for t in dp_wavefront.unpack(P)] == [
        (8,), (8,), (8,), (8,), (8, 40), (8, 40)]


@pytest.mark.parametrize("B,L1,L2", [(10, 14, 20), (6, 32, 32), (1, 2, 3)])
def test_nw_fast_batch_matches_pallas_and_host(rng, B, L1, L2):
    """The batched nw_fast over the fill against bwt_tpu's over the Pallas
    kernel (interpret mode) and against the host nw_fast pair by pair,
    zero-length reads included."""
    reads, genomes = _batch(rng, B, L1, L2)
    rl = rng.integers(1, L1 + 1, size=B).astype(np.int32)
    gl = rng.integers(1, L2 + 1, size=B).astype(np.int32)
    if B > 1:
        rl[0] = 0
    launches = dp_wavefront.LAUNCHES
    endpos, cigars = dp_wavefront.nw_fast_batch(reads, rl, genomes, gl,
                                                device="cpu")
    assert dp_wavefront.LAUNCHES == launches  # the CPU never launches
    want_pos, want_cig = pallas_align.nw_fast_batch(reads, rl, genomes, gl,
                                                    interpret=True)
    assert endpos.dtype == np.int32 and np.array_equal(endpos, want_pos)
    assert [c.render() for c in cigars] == [c.render() for c in want_cig]
    for b in range(B):
        c = TCigar()
        assert endpos[b] == talign.nw_fast(reads[b, :rl[b]],
                                           genomes[b, :gl[b]], c)
        assert cigars[b].render() == c.render()


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



def test_dp_core_at_the_tall_form_shape(monkeypatch):
    """A 160 x 192 bucket with the read-back form's threshold lowered to 0
    (dp_wavefront._TALL_ROWS, the hook the card tests use to reach that
    form at this shape): the stitch equals bwt_tpu's Pallas path.  On the
    CPU the threshold changes nothing; the card's form is held to this
    plain version in tests/test_torch_cuda.py."""
    monkeypatch.setattr(dp_wavefront, "_TALL_ROWS", 0)
    L1, L2 = 160, 192
    rng = np.random.default_rng(160)
    B, Lb, G = 4, L1 + 16, 600
    bank = rng.integers(0, 4, size=(4, Lb)).astype(np.int32)
    bank[rng.random(bank.shape) < 0.03] = 5
    genome = rng.integers(0, 4, size=G).astype(np.int32)
    bank[0] = genome[100:100 + Lb]
    fields = [np.array(x, np.int32) for x in (
        [0, 1, 2, 3], [0, 3, 0, 7], [L1, 150, 97, L1], [0, 1, 0, 0],
        [100, 40, 300, 0], [L2, 180, 120, 0], [0, 0, 1, 0], [1, 0, 1, 1])]
    want = jexec._dp_core(bank, genome, *fields, L1=L1, L2=L2,
                          impl="pallas_interpret")
    got = texec._dp_core(torch.from_numpy(bank), torch.from_numpy(genome),
                         *(torch.from_numpy(f) for f in fields), L1=L1, L2=L2)
    _assert_stitch_equal(got, want, fields)
