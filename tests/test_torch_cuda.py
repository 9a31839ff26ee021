"""bwt_tpu_torch on an NVIDIA card: the CUDA kernels (DP fill, the fused
DP stitch in all its forms, backward search, SA walk, the fused locate and
anchor scan, the seed-table build, the inverse-SA window, the fused
service round, the rna_seq automaton, the aligner automaton and its phase
B's log stitch and compose) against their plain versions, the tp form of
the nine search kernels against their replicated form, the wide (int64)
index's instantiations of K3, K4, locate, anchor_scan and K5 against
their plain versions and the int32 kernels, the port's main paths
on the card against the same paths on the CPU (which the other
test_torch_*.py files hold against bwt_tpu), the build's memory a base
and its suffix sort in buckets against the CPU's, and a refused launch
at each of the library's launch sites raising KernelLaunchError.

Every test carries the ``cuda`` marker and skips without a card.  The
file imports neither jax nor bwt_tpu, so it also runs where jax is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import sys
from pathlib import Path

import dataclasses

import numpy as np
import pytest
import torch

import bwt_tpu_torch
from bwt_tpu_torch import codec
from bwt_tpu_torch.config import DEFAULT
from bwt_tpu_torch.models import aligner, exact, rnaseq
from bwt_tpu_torch.models.batch_exec import QueryService, _service_core
from bwt_tpu_torch.ops import dp_wavefront, search, service, suffix

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import (ISA_KINDS, WIDE_KERNELS, WIDE_SHIFT,  # noqa: E402
                        compose_edge_rows, isa_windows, log_edge_jobs,
                        mixed_reads,
                        service_lanes, shifted_counts, shifted_index,
                        stitch_jobs, tp_cases, tp_equal, tp_inputs,
                        tp_launches, tp_outcome, wide_inputs)

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
                                     (33, 96, 128), (5, 127, 40),
                                     (7, 128, 40), (4, 1100, 40),
                                     (2, 3000, 8), (2, 12000, 8)])
def test_kernel_matches_plain(card, B, L1, L2):
    """Bit-equal at the stitch shapes, at an odd batch, at the last shape
    a warp takes and the first a block takes, at L1 past one block's
    1,024 threads, with more than 48 KB of carried diagonals in shared
    memory, and at L1 past the diagonals that fit it (the read-back
    form)."""
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


@pytest.mark.parametrize("B,L1,L2", [
    (1, 2, 3), (8, 32, 32), (64, 96, 128), (37, 64, 96), (9, 127, 600),
    (16, 160, 192), (4, 600, 600), (8, 1000, 1000), (2, 3000, 8)])
def test_stitch_kernel_matches_plain(card, B, L1, L2):
    """Both outputs bit-equal, one launch a call: a warp a job (at 127 x
    600 with more than 48 KB of shared memory a block), and a block a job
    with a byte a pointer in device memory (160 x 192 and wider; at L1 =
    3,000 past one block's 1,024 threads and with more than 48 KB of
    carried diagonals in shared memory)."""
    rng = np.random.default_rng(B * 1000 + L1)
    bank, genome, f = stitch_jobs(rng, B, L1, L2)
    args = (torch.from_numpy(bank).to(card), torch.from_numpy(genome).to(card),
            *torch.from_numpy(f).to(card).unbind(0))
    for scoring in (None, ALT_SCORING):
        counts = dp_wavefront.STITCH_LAUNCHES, dp_wavefront.LAUNCHES
        got = dp_wavefront.dp_stitch(*args, L1=L1, L2=L2, scoring=scoring)
        assert (dp_wavefront.STITCH_LAUNCHES, dp_wavefront.LAUNCHES) == (
            counts[0] + 1, counts[1])
        want = dp_wavefront.dp_stitch_plain(*args, L1=L1, L2=L2,
                                            scoring=scoring)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("B,L1,L2,tall_rows", [
    (256, 160, 192, 128), (16, 160, 192, 0), (2, 12000, 12100, None)],
    ids=["hook-160x192", "hook-0", "12000x12100"])
def test_stitch_tall_form_matches_plain(card, monkeypatch, B, L1, L2,
                                        tall_rows):
    """The read-back form, its carried diagonals in device scratch: at
    160 x 192 through the _TALL_ROWS hook, and at a true 12,000-row job
    (past the diagonals that fit shared memory; the plain version's fill
    there takes a few GB).  Both outputs bit-equal, one launch a call."""
    if tall_rows is not None:
        monkeypatch.setattr(dp_wavefront, "_TALL_ROWS", tall_rows)
    rng = np.random.default_rng(B * 7 + L1)
    bank, genome, f = stitch_jobs(rng, B, L1, L2, R=8)
    args = (torch.from_numpy(bank).to(card), torch.from_numpy(genome).to(card),
            *torch.from_numpy(f).to(card).unbind(0))
    launches = dp_wavefront.STITCH_LAUNCHES
    got = dp_wavefront.dp_stitch(*args, L1=L1, L2=L2)
    assert dp_wavefront.STITCH_LAUNCHES == launches + 1
    want = dp_wavefront.dp_stitch_plain(*args, L1=L1, L2=L2)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_nw_fast_batch_on_card_matches_cpu(card):
    """The batched nw_fast launches the fill kernel once and gives the CPU
    run's endpoints and CIGARs."""
    rng = np.random.default_rng(5)
    reads, genomes = _jobs(rng, 64, 32, 64)
    rl = rng.integers(0, 33, size=64)
    gl = rng.integers(1, 65, size=64)
    launches = dp_wavefront.LAUNCHES
    pos, cigars = dp_wavefront.nw_fast_batch(reads, rl, genomes, gl)
    assert dp_wavefront.LAUNCHES == launches + 1
    want_pos, want = dp_wavefront.nw_fast_batch(reads, rl, genomes, gl,
                                                device="cpu")
    assert np.array_equal(pos, want_pos)
    assert [c.render() for c in cigars] == [c.render() for c in want]


@pytest.mark.parametrize("fn", ["nw_endpos_batch", "sw_fast_batch"])
def test_batched_aligners_on_card_match_cpu(card, fn):
    """nw_endpos_batch (all four outputs) and sw_fast_batch launch the fill
    kernel once each and give the CPU run's results, zero-length reads
    included."""
    rng = np.random.default_rng(6)
    reads, genomes = _jobs(rng, 64, 32, 64)
    rl = rng.integers(0, 33, size=64)
    gl = rng.integers(1, 65, size=64)
    reads[np.arange(32)[None, :] >= rl[:, None]] = 0
    genomes[np.arange(64)[None, :] >= gl[:, None]] = 0
    launches = dp_wavefront.LAUNCHES
    got = getattr(dp_wavefront, fn)(reads, rl, genomes, gl)
    assert dp_wavefront.LAUNCHES == launches + 1
    want = getattr(dp_wavefront, fn)(reads, rl, genomes, gl, device="cpu")
    if fn == "sw_fast_batch":
        assert [c.render() for c in got] == [c.render() for c in want]
    else:
        for a, b in zip(got, want):
            assert a.device.type == "cuda" and torch.equal(a.cpu(), b)


def test_stitch_wrapper_raises_on_card(card):
    bank = torch.zeros((4, 48), dtype=torch.int32, device=card)
    genome = torch.zeros(100, dtype=torch.int32, device=card)
    f = [torch.zeros(8, dtype=torch.int32, device=card) for _ in range(8)]
    launches = dp_wavefront.STITCH_LAUNCHES
    with pytest.raises(TypeError):
        dp_wavefront.dp_stitch(bank, genome.to(torch.int64), *f, L1=32, L2=32)
    with pytest.raises(ValueError):
        dp_wavefront.dp_stitch(bank, genome.cpu(), *f, L1=32, L2=32)
    with pytest.raises(ValueError):
        dp_wavefront.dp_stitch(bank, genome, *f[:7], f[7].cpu(), L1=32, L2=32)
    assert dp_wavefront.STITCH_LAUNCHES == launches
    empty = [t[:0] for t in f]
    P, ops = dp_wavefront.dp_stitch(bank, genome, *empty, L1=32, L2=32)
    assert P.shape == (0, 84) and ops.shape == (0, 65)
    assert dp_wavefront.STITCH_LAUNCHES == launches  # nothing to launch


def test_main_path_on_card_matches_cpu(card):
    """build_index, locate and align_reads on the card equal the CPU run,
    and the aligner's DP stitches went through the stitch kernel, which
    fills itself: no launch of the standalone fill."""
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
    want = aligner.align_reads(on_cpu, g, reads, with_strand=True)
    # the default engine stitches from the automaton's log, the host engine
    # through the executor's stitch; neither launches the standalone fill
    for engine, counter in (("auto", "LOG_STITCH_LAUNCHES"),
                            ("host", "STITCH_LAUNCHES")):
        launches = getattr(dp_wavefront, counter), dp_wavefront.LAUNCHES
        got = aligner.align_reads(on_card, g, reads, with_strand=True,
                                  engine=engine)
        assert getattr(dp_wavefront, counter) > launches[0]
        assert dp_wavefront.LAUNCHES == launches[1]
        assert ([(p, c.render() if c else None, s) for p, c, s in got]
                == [(p, c.render() if c else None, s) for p, c, s in want])
    assert sum(1 for p, _, _ in got if p) > 250


@pytest.fixture(scope="module", params=[("rand", 30000, 8), ("zeros", 500, 4)],
                ids=["rand-r8", "zeros-r4"])
def search_env(request):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    kind, n, rate = request.param
    rng = np.random.default_rng(n)
    codes = (np.zeros(n, np.uint8) if kind == "zeros"
             else rng.integers(0, 4, n).astype(np.uint8))
    codes_ext = np.concatenate([codes, rng.integers(0, 4, 128).astype(np.uint8)])
    fmi = bwt_tpu_torch.build_index(codes, sa_sample_rate=rate, device="cuda")
    return codes_ext, fmi, rng


@pytest.mark.parametrize("mode", ["c0", "c0-resolve", "seeded", "given"])
def test_backward_search_kernel_matches_plain(search_env, mode):
    """K3 bit-equal to its plain version on the card in each initial-state
    mode, on mixed reads (N runs, all-N, length 0 and 1, ragged, codes
    outside the tables)."""
    codes, fmi, rng = search_env
    pats, lens = mixed_reads(rng, codes, 4099, L=100)
    pats = torch.from_numpy(pats).cuda()
    lens = torch.from_numpy(lens).cuda()
    n1 = fmi.length + 1
    kw = {
        "c0": {},
        "c0-resolve": dict(resolve_n=True),
        "seeded": dict(seed_table=search.build_seed_table(fmi, k=4)),
        "given": dict(resolve_n=True,
                      start=torch.randint(0, n1, (4099,), dtype=torch.int32,
                                          device="cuda"),
                      end=torch.randint(0, n1, (4099,), dtype=torch.int32,
                                        device="cuda")),
    }[mode]
    launches = search.BS_LAUNCHES
    got = search.search_lanes(fmi, pats, lens, **kw)
    want = search.backward_search_plain(fmi, pats, lens, **kw)
    torch.cuda.synchronize()
    assert search.BS_LAUNCHES == launches + 1
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("shape", [(1, 3), (3, 5), (67, 30)])
@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_kernels_read_an_unaligned_array(search_env, shift, shape):
    """An int32 read array that starts ``shift`` elements past a 16-byte
    boundary (a view into a larger buffer): its first and last 16-byte
    block reach outside it and are read element by element; the three
    kernels that take reads give what their plain versions give."""
    codes, fmi, rng = search_env
    B, L = shape
    pats_np, lens_np = mixed_reads(rng, codes, B, L=L)
    pats_np %= 4  # every walk starts on a real row
    buf = torch.full((B * L + 8,), 3, dtype=torch.int32, device="cuda")
    pats = buf[shift:shift + B * L].view(B, L)
    pats.copy_(torch.from_numpy(pats_np))
    assert pats.data_ptr() % 16 == 4 * shift and pats.is_contiguous()
    lens = torch.from_numpy(lens_np).cuda()
    got = search.search_lanes(fmi, pats, lens)
    want = search.backward_search_plain(fmi, pats, lens)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    calls = [(lambda: [search.locate(fmi, pats, lens)],
              lambda: [search.locate_plain(fmi, pats, lens)])]
    for reverse in (False, True):
        flipped = exact._plain_reverse(pats, lens) if reverse else pats
        calls.append((lambda reverse=reverse: exact.anchor_scan(
                          fmi, pats, lens, min_anchor=2, reverse=reverse),
                      lambda flipped=flipped: exact.anchor_scan_plain(
                          fmi, flipped, lens, min_anchor=2)))
    for kernel, plain in calls:  # on the all-A genome both may raise
        got, want = _outcome(kernel), _outcome(plain)
        if isinstance(want, list):
            for a, b in zip(got, want):
                assert torch.equal(a, b)
        else:
            assert got is want


def test_unc_sa_kernel_matches_plain(search_env):
    codes, fmi, _ = search_env
    idx = torch.arange(fmi.length + 1, dtype=torch.int32, device="cuda")
    launches = search.UNC_LAUNCHES
    got = search.unc_sa(fmi, idx)
    assert search.UNC_LAUNCHES == launches + 1
    assert torch.equal(got, search.unc_sa_plain(fmi, idx))
    assert torch.equal(search.unc_sa(fmi, idx[:64], max_steps=3),
                       search.unc_sa_plain(fmi, idx[:64], max_steps=3))


def test_unc_sa_bound_raises_on_card():
    """A walk from row n + 1 stops at its bound and raises, from K4 and
    from the locate kernel (which walks every lane's start)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    fmi = bwt_tpu_torch.build_index(np.zeros(64, np.uint8), device="cuda")
    launches = search.UNC_LAUNCHES, search.LOCATE_LAUNCHES
    with pytest.raises(RuntimeError, match="row 65"):
        search.unc_sa(fmi, [0, 65, 3])
    with pytest.raises(RuntimeError, match="row 65"):
        search.locate(fmi, np.array([[0], [1]], np.int32),
                      np.array([1, 1], np.int32))
    assert (search.UNC_LAUNCHES, search.LOCATE_LAUNCHES) == (
        launches[0] + 1, launches[1] + 1)


def _outcome(fn):
    """What a call gave: its tensors, or the type of what it raised."""
    try:
        out = fn()
    except RuntimeError as e:
        return type(e)
    torch.cuda.synchronize()
    return [t.cpu() for t in out]


_HUNT_WANT = {}  # the plain version's outcome a case: every view shares it


def _hunt_reads(codes, fmi, shape):
    """The anchor hunt's reads for ``shape``, the same in every case."""
    rng = np.random.default_rng(2051 if shape == "mixed" else 4099)
    if shape == "mixed":
        pats, lens = mixed_reads(rng, codes, 2051, L=100)
    else:
        starts = rng.integers(0, fmi.length - 50, size=4099)
        pats = codes[np.add.outer(starts, np.arange(50))]
        lens = np.full((4099,), 50, np.int32)
    return torch.from_numpy(pats).cuda(), torch.from_numpy(lens).cuda()


@pytest.mark.parametrize("blocks", [0, 1, 2, 3],
                         ids=["replicated", "tp-1", "tp-2", "tp-3"])
@pytest.mark.parametrize("shape", ["mixed", "chunk"])
@pytest.mark.parametrize("min_anchor", [20, 12, 8])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_anchor_scan_kernel_matches_plain(search_env, reverse, min_anchor,
                                          shape, blocks):
    """The fused anchor scan bit-equal to its plain version, both
    directions, for int32 and one-byte codes: on mixed reads (L = 100)
    and at a search_reads chunk's shape (50-bp genome substrings, uint8),
    over the whole index and over tp views of 1, 2 and 3 blocks
    (allocations of this process), each launch at its tile (on the
    30,000-base genome a reversed hunt at min_anchor 8 keeps a thread a
    read, at 12 and 20 it takes the tile of 16)."""
    from bwt_tpu_torch import parallel

    codes, fmi, _ = search_env
    pats, lens = _hunt_reads(codes, fmi, shape)
    view = (parallel.mesh.view_in_process(fmi, blocks, blocks - 1) if blocks
            else fmi)
    try:
        # one byte a code: the odd codes read as a cast reads them
        for dt in (torch.int32, torch.int8, torch.uint8):
            narrow = pats.to(dt)
            launches = (search.ANCHOR_LAUNCHES, search.BS_LAUNCHES,
                        search.UNC_LAUNCHES)
            got = _outcome(lambda: exact.anchor_scan(
                view, narrow, lens, reverse=reverse, min_anchor=min_anchor))
            assert (search.ANCHOR_LAUNCHES, search.BS_LAUNCHES,
                    search.UNC_LAUNCHES) == (launches[0] + 1, *launches[1:])
            key = (fmi.length, shape, min_anchor, reverse, dt)
            if key not in _HUNT_WANT:
                wide = narrow.to(torch.int32)
                flipped = (exact._plain_reverse(wide, lens) if reverse
                           else wide)
                _HUNT_WANT[key] = _outcome(lambda: exact.anchor_scan_plain(
                    fmi, flipped, lens, min_anchor=min_anchor))
            want = _HUNT_WANT[key]
            assert isinstance(want, list)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
            if shape == "mixed" and dt == torch.int32:
                assert (want[0] > 0).any() and (want[0] == 0).any()
    finally:
        if blocks:
            parallel.release_view(view)


@pytest.mark.parametrize("seeded", [False, True], ids=["plain", "seeded"])
def test_locate_kernel_matches_plain(search_env, seeded):
    """The fused locate bit-equal to its plain version on the mixed reads
    whose walk starts on a real row, in one launch and without K3 or K4;
    with the other reads it raises as the plain version does."""
    codes, fmi, rng = search_env
    pats_np, lens_np = mixed_reads(rng, codes, 4099, L=100)
    pats = torch.from_numpy(pats_np).cuda()
    lens = torch.from_numpy(lens_np).cuda()
    table = search.build_seed_table(fmi, k=4) if seeded else None
    start = search.backward_search_plain(fmi, pats, lens,
                                         seed_table=table)["start"]
    real = ((start >= 0) & (start <= fmi.length)) | (start == -2 ** 31)
    assert bool(real.any())
    launches = search.LOCATE_LAUNCHES, search.BS_LAUNCHES, search.UNC_LAUNCHES
    got = search.locate(fmi, pats[real], lens[real], seed_table=table)
    assert (search.LOCATE_LAUNCHES, search.BS_LAUNCHES,
            search.UNC_LAUNCHES) == (launches[0] + 1, *launches[1:])
    want = search.locate_plain(fmi, pats[real], lens[real], seed_table=table)
    assert got.shape == want.shape and torch.equal(got, want)
    assert bool((want == -1).any()) and bool((want >= 0).any())
    if not bool(real.all()):
        got = _outcome(lambda: [search.locate(fmi, pats, lens,
                                              seed_table=table)])
        want = _outcome(lambda: [search.locate_plain(fmi, pats, lens,
                                                     seed_table=table)])
        if isinstance(want, list):
            assert torch.equal(got[0], want[0])
        else:
            assert got is want


def _locate_cases(codes, fmi, case, rng):
    """The fused locate's reads on the card: genome 30-mers; mixed reads
    (L = 100: ragged, N, codes outside the tables); 30-mers of which four
    end in code 4, whose start C[4] = n + 1 lies past the suffix array
    (on the all-A genome their walks overrun); a batch of 4,099 (not a
    multiple of a warp or a block); 33 rows of 3,000 characters (as long
    as the genome allows) with lengths 1 to the row."""
    n = fmi.length
    if case == "mixed":
        return mixed_reads(rng, codes, 4099, L=100)
    if case == "long-rows":
        L, B = min(3000, n), 33
        pats = codes[np.add.outer(rng.integers(0, n - L + 1, size=B),
                                  np.arange(L))].astype(np.int32)
        return pats, rng.integers(1, L + 1, size=B).astype(np.int32)
    B = 4099 if case == "odd-batch" else 1 << 13
    pats = codes[np.add.outer(rng.integers(0, n - 30, size=B),
                              np.arange(30))].astype(np.int32)
    if case == "overrun":
        pats[[5, 77, 4000, 8000], 29] = 4
    return pats, np.full(B, 30, np.int32)


def _locate_raw(fmi, pats, lens, table):
    """What the locate kernel leaves, from the plain versions: each read's
    position, -1 where the interval emptied early, the row it walked from
    where the walk overran; then the flag (the overruns, and B - the first
    of them in the reads' order)."""
    r = search.backward_search_plain(fmi, pats, lens, seed_table=table)
    pos, over = search.unc_sa_flagged(fmi, r["start"])
    emptied = ~r["alive"] & (r["nmatched"] <= lens - 2)
    lanes = over.nonzero().flatten()
    flag = [int(over.sum()), pats.shape[0] - int(lanes[0]) if len(lanes)
            else 0]
    return torch.cat([torch.where(emptied & ~over, -1, pos).cpu(),
                      torch.tensor(flag, dtype=pos.dtype)])


@pytest.mark.parametrize("seeded", [False, True], ids=["plain", "seeded"])
@pytest.mark.parametrize("case", ["30-mers", "mixed", "overrun", "odd-batch",
                                  "long-rows"])
def test_locate_schedule_matches_plain(search_env, case, seeded):
    """The fused locate's whole output (positions, and the flag with the
    first overrunning read in the caller's order), one launch, equal to
    what the plain versions leave: 30-mers (the block's reads staged in
    shared memory), reads of 100 and 3,000 characters (read from global
    memory), a batch that is no multiple of a block; the wrapper raises
    naming that read's row, as the plain version does."""
    codes, fmi, _ = search_env
    rng = np.random.default_rng(sum(map(ord, case)))
    pats, lens = _locate_cases(codes[:fmi.length], fmi, case, rng)
    pats, lens = torch.from_numpy(pats).cuda(), torch.from_numpy(lens).cuda()
    table = search.build_seed_table(fmi, k=4) if seeded else None
    want = _locate_raw(fmi, pats, lens, table)
    launches = search.LOCATE_LAUNCHES
    got = search.locate_kernel(fmi, pats, lens, seed_table=table).cpu()
    assert search.LOCATE_LAUNCHES == launches + 1
    assert torch.equal(got, want)
    if case == "overrun" and not seeded and not codes[:fmi.length].any():
        # on the all-A genome the four walks from row n + 1 overrun
        assert int(want[-2]) == 4 and int(want[-1]) == pats.shape[0] - 5
    if int(want[-2]):
        row = int(want[pats.shape[0] - int(want[-1])])
        with pytest.raises(RuntimeError, match=f"row {row} "):
            search.locate(fmi, pats, lens, seed_table=table)
        with pytest.raises(RuntimeError, match=f"row {row} "):
            search.locate_plain(fmi, pats, lens, seed_table=table)


@pytest.mark.parametrize("form", ["tp-1", "tp-3", "wide", "wide-tp-2"])
def test_locate_schedule_forms_match_plain(search_env, wide_env, form):
    """The fused locate over tp views of 1 and 3 blocks (allocations of
    this process), on the wide index and over a wide view of 2 blocks:
    its whole output equal to the plain version's on the whole index, on
    the mixed reads and on the 30-mers with overrunning reads, plain and
    seeded."""
    from bwt_tpu_torch import parallel

    codes, fmi, _ = search_env
    _, wide, _ = wide_env
    index = wide if form.startswith("wide") else fmi
    blocks = int(form[-1]) if "tp" in form else 0
    view = (parallel.mesh.view_in_process(index, blocks, blocks - 1)
            if blocks else index)
    try:
        for case in ("mixed", "overrun"):
            rng = np.random.default_rng(7)
            pats, lens = _locate_cases(codes[:fmi.length], fmi, case, rng)
            pats = torch.from_numpy(pats).cuda()
            lens = torch.from_numpy(lens).cuda()
            for table in (None, search.build_seed_table(index, k=4)):
                got = search.locate_kernel(view, pats, lens,
                                           seed_table=table).cpu()
                assert torch.equal(got, _locate_raw(index, pats, lens,
                                                    table))
    finally:
        if blocks:
            parallel.release_view(view)


def test_anchor_scan_bounds_raise_on_card(card):
    """The hunt that makes no progress and the walk from a row past the
    suffix array raise on the card, from the kernel's flag."""
    fmi = bwt_tpu_torch.build_index(np.zeros(64, np.uint8), device=card)
    launches = search.ANCHOR_LAUNCHES
    pat = np.array([[0, 0, 0], [0, 1, 0]], np.int32)
    for reverse in (False, True):
        with pytest.raises(RuntimeError, match="read 1 .* never end"):
            exact.anchor_scan(fmi, pat, [3, 2 + reverse], min_anchor=0,
                              reverse=reverse)
    with pytest.raises(RuntimeError, match="never end"):
        exact.search_reads(fmi, ["AAAA", "AAAC"], min_anchor=-1)
    with pytest.raises(RuntimeError, match="row 65"):
        exact.anchor_scan(fmi, np.array([[0, 0, 0, 0], [1, 5, 5, 5]],
                                        np.int32), [4, 4], min_anchor=3)
    with pytest.raises(RuntimeError, match="row 65"):
        exact.search_reads(fmi, ["AAAA", "CNNN"], min_anchor=3)
    assert search.ANCHOR_LAUNCHES == launches + 7
    # min_anchor = 0 ends when every trip consumes something
    pat = np.array([[0, 0, 0, 0, 0, 0], [0, 5, 0, 5, 5, 0],
                    [5, 5, 5, 5, 5, 5]], np.int32)
    lens = np.array([6, 5, 6], np.int32)
    for a, b in zip(exact.anchor_scan(fmi, pat, lens, min_anchor=0),
                    exact.anchor_scan(fmi.to("cpu"), pat, lens, min_anchor=0)):
        assert torch.equal(a.cpu(), b)


def test_search_reads_chunks_on_card_match_cpu(card):
    """search_reads on a uint8 code array in several chunks (the last one
    short), two launches a chunk, equal to the CPU run; strings and int32
    codes give the same."""
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 4, 20000).astype(np.uint8)
    codes[7000:7060] = codes[6700:6760][::-1]  # a read that pairs
    on_card = bwt_tpu_torch.build_index(codes, sa_sample_rate=4, device=card)
    starts = np.concatenate([[6700], rng.integers(0, 19900, 1100)])
    reads = codes[np.add.outer(starts, np.arange(60))]
    reads[3, 50:] = 5
    reads[4] = rng.integers(0, 4, 60)
    cfg = dataclasses.replace(DEFAULT, search_batch=256)
    launches = search.ANCHOR_LAUNCHES, search.BS_LAUNCHES, search.UNC_LAUNCHES
    got = exact.search_reads(on_card, reads, config=cfg)
    assert (search.ANCHOR_LAUNCHES, search.BS_LAUNCHES,
            search.UNC_LAUNCHES) == (launches[0] + 2 * 5, *launches[1:])
    want = exact.search_reads(on_card.to("cpu"), reads, config=cfg)
    texts = [codec.decode(r) for r in reads]
    for other in (exact.search_reads(on_card, texts, config=cfg),
                  exact.search_reads(on_card, reads.astype(np.int32))):
        for k in want:
            assert np.array_equal(other[k], want[k]), k
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert got["paired"][0] and (got["fwd_matches"][5:] >= 1).all()


def test_exact_path_on_card_matches_cpu(card):
    """search_reads, seeded locate and mms_continue on the card equal the
    CPU run, through the kernels."""
    g = codec.random_genome(20000, seed=13)
    on_card = bwt_tpu_torch.build_index(g, sa_sample_rate=4, device=card)
    on_cpu = on_card.to("cpu")
    rng = np.random.default_rng(4)
    reads = [g[s:s + int(ln)] for s, ln in
             zip(rng.integers(0, 19800, 300), rng.integers(20, 120, 300))]
    reads += ["N" * 30, "ACGT" * 10, g[500:560][::-1]]
    launches = search.ANCHOR_LAUNCHES, search.BS_LAUNCHES
    got = exact.search_reads(on_card, reads)
    assert (search.ANCHOR_LAUNCHES, search.BS_LAUNCHES) == (
        launches[0] + 2, launches[1])
    want = exact.search_reads(on_cpu, reads)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    pat, lens = exact._encode_batch(reads)
    for k in (4, 8):
        st_card = search.build_seed_table(on_card, k=k)
        st_cpu = search.build_seed_table(on_cpu, k=k)
        assert torch.equal(st_card.rows.cpu(), st_cpu.rows)
        ok = lens >= k
        assert torch.equal(
            search.locate(on_card, pat[ok], lens[ok], seed_table=st_card).cpu(),
            search.locate(on_cpu, pat[ok], lens[ok], seed_table=st_cpu))
    sp = rng.integers(0, 20001, len(reads)).astype(np.int32)
    ep = np.clip(sp + rng.integers(-1, 4, len(reads)), 0, 20001).astype(np.int32)
    for a, b in zip(search.mms_continue(on_card, pat, lens, sp, ep),
                    search.mms_continue(on_cpu, pat, lens, sp, ep)):
        assert torch.equal(a.cpu(), b)


# --------------------------------------------------------------------------
# the seed-table build (K5), the inverse-SA window (K6), the service (K7)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 7, 12])
def test_seed_rows_kernel_matches_plain(search_env, k):
    _, fmi, _ = search_env
    launches = search.SEED_LAUNCHES
    got = search.build_seed_table(fmi, k=k)
    assert search.SEED_LAUNCHES == launches + 1
    assert got.k == k and got.rows.shape == (4 ** k, 6)
    assert torch.equal(got.rows, search._seed_rows_plain(fmi, k))
    with pytest.raises(ValueError, match="outside 1..15"):
        search.build_seed_table(fmi, k=16)


def test_isa_window_kernel_matches_plain(search_env):
    """Widths -2..40 (past W = 32: the contract's edge), tops across the
    genome, the tail, the anchor at length, plo < 0."""
    _, fmi, rng = search_env
    n = fmi.length
    B = 5000
    plo = rng.integers(-40, n + 40, size=B).astype(np.int32)
    wid = rng.integers(-2, 41, size=B).astype(np.int32)
    plo[:6] = [0, n - 5, n, -3, n - 31, -31]
    wid[:6] = [32, 32, 1, 10, 32, 32]
    launches = search.ISA_LAUNCHES
    got = search.isa_window(fmi, plo, wid)
    assert search.ISA_LAUNCHES == launches + 1
    want = search.isa_window_plain(fmi, plo, wid)
    assert got.shape == want.shape == (B, 32) and torch.equal(got, want)
    assert (got >= 0).any() and (got == -1).any()
    no_isa = dataclasses.replace(fmi, isa_samples=None)
    with pytest.raises(ValueError, match="isa_samples"):
        search.isa_window(no_isa, plo, wid)
    assert search.isa_window(fmi, plo[:0], wid[:0]).shape == (0, 32)
    assert search.ISA_LAUNCHES == launches + 1  # nothing to launch


@pytest.fixture(scope="module", params=[(2048, 4), (2001, 4), (2048, 32),
                                        (2001, 32)],
                ids=["n2048-r4", "n2001-r4", "n2048-r32", "n2001-r32"])
def isa_env(request):
    """Genomes whose length is a multiple of the sample rate and not (the
    tail row 0 at length), at rates 4 and 32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    n, rate = request.param
    rng = np.random.default_rng(n * rate)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    return bwt_tpu_torch.build_index(codes, sa_sample_rate=rate,
                                     device="cuda"), rng


@pytest.mark.parametrize("kind", ISA_KINDS)
def test_isa_window_kernel_edges_match_plain(isa_env, kind):
    """K6 bit-equal to its plain version on chip_smoke.isa_windows' sets:
    the int32 edges, widths past W (the cap's -1 columns), W = 8, 30, 32
    and 64, through the wrapper's tile and at every tile (at W = 64 and a
    tile of 1 or 2 in column chunks), one launch a call; a tile that is no
    power of two up to 32 is refused."""
    fmi, rng = isa_env
    plo, wid, W = isa_windows(kind, fmi.length, rng)
    want = search.isa_window_plain(fmi, plo, wid, W=W)
    for tile in (None, 1, 2, 4, 8, 16, 32):
        launches = search.ISA_LAUNCHES
        got = (search.isa_window(fmi, plo, wid, W=W) if tile is None
               else search._isa_window_kernel(fmi, plo, wid, W=W, tile=tile))
        assert search.ISA_LAUNCHES == launches + 1
        assert got.shape == want.shape and torch.equal(got, want), tile
    for tile in (0, 3, 64):
        with pytest.raises(RuntimeError, match="CUDA error 1$"):
            search._isa_window_kernel(fmi, plo, wid, W=W, tile=tile)


@pytest.mark.parametrize("blocks,coord", [(1, 0), (2, 1), (3, 2)],
                         ids=["1-block", "2-blocks", "3-blocks"])
def test_isa_window_tp_kernel_matches_plain(isa_env, blocks, coord):
    """K6's tp form (samples and rows through the blocks' pointers) over
    a view of the index, bit-equal to the plain version on the whole
    index, on the random and past-W windows."""
    from bwt_tpu_torch import parallel

    fmi, rng = isa_env
    view = parallel.mesh.view_in_process(fmi, blocks, coord)
    try:
        for kind in ("random", "past-W", "W64"):
            plo, wid, W = isa_windows(kind, fmi.length, rng)
            launches = search.ISA_LAUNCHES
            got = search.isa_window(view, plo, wid, W=W)
            assert search.ISA_LAUNCHES == launches + 1
            assert torch.equal(got, search.isa_window_plain(fmi, plo, wid,
                                                            W=W)), kind
    finally:
        parallel.release_view(view)


def _service_both(fmi, bank, f, **kw):
    """The round through the kernel and the plain version on the card:
    both outcomes (the 13 columns, or the type of what was raised)."""
    fields = torch.from_numpy(f).cuda().unbind(0)
    launches = service.SERVICE_LAUNCHES
    got = _outcome(lambda: _service_core(fmi, bank, *fields, **kw))
    assert service.SERVICE_LAUNCHES == launches + 1
    want = _outcome(lambda: _service_core(fmi, bank, *fields, plain=True,
                                          **kw))
    assert service.SERVICE_LAUNCHES == launches + 1
    return got, want


@pytest.mark.parametrize("ops", [tuple(range(8))] + [(op,) for op in range(8)],
                         ids=["mixed", "none", "mms", "cont", "bsearch", "unc",
                              "crank", "mext", "bext"])
@pytest.mark.parametrize("resolve", [False, True], ids=["raw", "resolve"])
@pytest.mark.parametrize("ext", [False, True], ids=["noext", "ext"])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32],
                         ids=["u8", "i32"])
def test_service_kernel_matches_plain(search_env, dtype, ext, resolve, ops):
    """K7 bit-equal to its plain version in all 13 columns on every lane:
    each opcode alone and all mixed, both bank widths.  On the repetitive
    genome a read with an absent symbol walks from a row past the suffix
    array: both versions raise."""
    codes, fmi, rng = search_env
    bank_np, f = service_lanes(rng, codes[:fmi.length], 1031, R=32, Lb=48,
                               ops=ops)
    bank = torch.from_numpy(bank_np).cuda().to(dtype)
    got, want = _service_both(fmi, bank, f, resolve=resolve, ext=ext)
    if isinstance(want, type):
        assert got is want
        return
    assert len(got) == len(want) == service.NCOLS
    for c, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), f"column {c}"


@pytest.mark.parametrize("k", [4, 6])
@pytest.mark.parametrize("resolve", [False, True], ids=["raw", "resolve"])
def test_service_kernel_seeded_matches_plain(search_env, resolve, k):
    codes, fmi, rng = search_env
    table = search.build_seed_table(fmi, k=k)
    bank_np, f = service_lanes(rng, codes[:fmi.length], 1031, R=32, Lb=48)
    bank = torch.from_numpy(bank_np).cuda()
    got, want = _service_both(fmi, bank, f, resolve=resolve, ext=True,
                              seed_rows=table.rows, seed_k=k)
    if isinstance(want, type):
        assert got is want
        return
    for c, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), f"column {c}"


@pytest.mark.parametrize("B", [1, 31, 4096, 8192, 20000])
@pytest.mark.parametrize("ext", [False, True], ids=["noext", "ext"])
def test_service_kernel_by_round_size_matches_plain(search_env, ext, B):
    """K7 in both of its built forms, picked by the round's size: a tile of
    four threads a lane (at most 16,384 lanes; an ext lane's window in
    slices) and a thread a lane (past it): bit-equal to its plain version,
    and to the plain version's sliced window, in all 13 columns and the
    flag."""
    codes, fmi, rng = search_env
    bank_np, f = service_lanes(rng, codes[:fmi.length], B, R=32, Lb=48)
    bank = torch.from_numpy(bank_np).cuda()
    got, want = _service_both(fmi, bank, f, resolve=True, ext=ext)
    if isinstance(want, type):
        assert got is want
        return
    for c, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), f"column {c}"
    fields = torch.from_numpy(f).cuda().unbind(0)
    sliced = service.service_round_plain(fmi, bank, *fields, resolve=True,
                                         ext=ext, width=4)
    for c, (a, b) in enumerate(zip(got, sliced.cpu())):
        assert torch.equal(a, b), f"column {c} against width 4"


def test_service_bound_and_arguments_raise_on_card(card):
    """A walk from a row past the suffix array raises through K7, consumed
    or not; a wrong argument raises before any launch."""
    fmi = bwt_tpu_torch.build_index(np.zeros(64, np.uint8), sa_sample_rate=4,
                                    device=card)
    bank = torch.ones((8, 16), dtype=torch.uint8, device=card)  # 'C', absent
    f = torch.zeros((7, 8), dtype=torch.int32, device=card)
    f[0, 2], f[3, 2] = 3, 4
    launches = service.SERVICE_LAUNCHES
    with pytest.raises(RuntimeError, match="row 65"):
        _service_core(fmi, bank, *f.unbind(0), resolve=False)
    assert service.SERVICE_LAUNCHES == launches + 1
    with pytest.raises(RuntimeError, match="row 65"):
        _service_core(fmi, bank, *f.unbind(0), resolve=False, plain=True)
    # an ext round without a lane that consumes the walk does not walk
    f[0, 2] = 6
    out = _service_core(fmi, bank, *f.unbind(0), resolve=False, ext=True)
    assert int(out[service.POS].abs().sum()) == 0
    with pytest.raises(ValueError, match="bank"):
        _service_core(fmi, bank.cpu(), *f.unbind(0), resolve=False)
    with pytest.raises(ValueError, match="lane fields"):
        _service_core(fmi, bank, *f.cpu().unbind(0), resolve=False)
    no_isa = dataclasses.replace(fmi, isa_samples=None)
    with pytest.raises(ValueError, match="isa_samples"):
        _service_core(no_isa, bank, *f.unbind(0), resolve=False, ext=True)
    assert service.SERVICE_LAUNCHES == launches + 2


def test_rna_seq_on_card_matches_cpu_and_plain(card):
    """rna_seq's host engine on the card: one K7 launch a service call,
    equal to the CPU run and, through ``svc_impl = "plain"``, to the plain
    service on the card; without isa_samples the chunk scan walks through
    K4."""
    rng = np.random.default_rng(9)
    g = rng.integers(0, 4, 40000).astype(np.uint8)
    on_card = bwt_tpu_torch.build_index(g, sa_sample_rate=8, device=card)
    on_cpu = on_card.to("cpu")
    starts = rng.integers(0, len(g) - 50, size=600)
    reads = g[starts[:, None] + np.arange(50)].copy()
    mpos = rng.integers(0, 50, size=600)
    reads[np.arange(600), mpos] ^= 1
    reads[::50, 7] = 5
    want = rnaseq.rna_seq(on_cpu, reads, engine="host")
    svc = QueryService(on_card)
    service.SERVICE_LAUNCHES = 0
    got = rnaseq.rna_seq(on_card, reads, service=svc, engine="host")
    stats = svc.last_stats
    assert service.SERVICE_LAUNCHES == stats["svc_calls"] > 0
    assert stats["svc_launches"] == stats["svc_calls"]
    assert np.array_equal(got, want)
    svc.svc_impl = "plain"
    assert np.array_equal(
        rnaseq.rna_seq(on_card, reads, service=svc, engine="host"), want)
    assert svc.last_stats["svc_launches"] == 0
    no_isa = dataclasses.replace(on_card, isa_samples=None)
    unc = search.UNC_LAUNCHES
    assert np.array_equal(rnaseq.rna_seq(no_isa, reads), want)
    assert search.UNC_LAUNCHES > unc
    # a mutation in the last bases leaves a prefix that anchors at its origin
    assert (got == starts)[(mpos >= 40) & (reads[:, 7] != 5)].mean() > 0.5


def _automaton_mix(g, rng):
    """tests/test_torch_automaton.py's mix: 50-mers with 0 to 4
    substitutions, random reads whose anchor hunt runs out, the lengths
    around the cutoffs, reads with N's."""
    reads = []
    for _ in range(300):
        j = int(rng.integers(0, len(g) - 55))
        r = g[j:j + 50].copy()
        for _ in range(int(rng.integers(0, 5))):
            r[int(rng.integers(0, 50))] = rng.integers(0, 4)
        reads.append(r)
    reads += [rng.integers(0, 4, 50).astype(np.uint8) for _ in range(60)]
    for ln in (1, 5, 13, 14, 15, 18, 19, 21, 22, 25):
        j = int(rng.integers(0, len(g) - ln))
        reads.append(g[j:j + ln].copy())
    for k in range(40):
        j = int(rng.integers(0, len(g) - 50))
        r = g[j:j + 50].copy()
        r[int(rng.integers(0, 50))] = 5
        if k % 4 == 0:
            r[-1] = 5
        reads.append(r)
    return reads


@pytest.mark.parametrize("cap", [0, 1, 2, 3, 4, 5],
                         ids=["uncapped", "cap-1", "cap-2", "cap-3", "cap-4",
                              "cap-5"])
@pytest.mark.parametrize("seed_k", [0, 8], ids=["no-seed", "seed-8"])
@pytest.mark.parametrize("resolve", [False, True], ids=["raw", "resolve"])
def test_automaton_kernel_matches_plain(card, cap, seed_k, resolve):
    """K9 against its plain version on the card, bit-equal in res, capped,
    the iterations and the flag: the automaton tests' mix, with and without
    a seed table and N resolution, uncapped and at caps that fall inside a
    tile's round; against the plain version's lockstep and at the kernel's
    tile width."""
    from bwt_tpu_torch.ops import automaton

    rng = np.random.default_rng(17 + seed_k)
    g = rng.integers(0, 4, 40000).astype(np.uint8)
    fmi = bwt_tpu_torch.build_index(g, sa_sample_rate=8, device=card)
    svc = QueryService(fmi)
    _, rl = svc.add_reads_batch(_automaton_mix(g, rng))
    R = svc.bank8.shape[0]
    lens = np.zeros(R, np.int32)
    lens[:len(rl)] = rl
    args = (svc.bank8, torch.from_numpy(lens).to(card),
            torch.arange(R, device=card) < len(rl),
            search.build_seed_table(fmi, seed_k).rows if seed_k else None)
    kw = dict(ac=14, cc=10, resolve=resolve, cap_steps=cap, seed_k=seed_k)
    launches = automaton.AUTOMATON_LAUNCHES
    got = automaton.rna_seq_automaton_packed(fmi, *args, **kw)
    assert automaton.AUTOMATON_LAUNCHES == launches + 1
    want = automaton.rna_seq_automaton_packed(fmi, *args, plain=True, **kw)
    assert torch.equal(got, want)
    at_tile = automaton.rna_seq_automaton_plain(fmi, *args,
                                                width=automaton.TILE, **kw)
    assert torch.equal(got[:3 * R], torch.cat(at_tile))
    assert automaton.AUTOMATON_LAUNCHES == launches + 1
    res, capped, iters = automaton.unpack(got)
    assert bool(capped.any()) == (cap > 0)
    assert int(iters.max()) == cap if cap else int(iters.max()) > 4


def test_rna_seq_device_engine_on_card_matches_cpu(card, monkeypatch):
    """rna_seq's default engine on the card: one K9 launch a chunk and no
    K7 launch, equal to the CPU run, to the host engine and, through
    svc_impl = "plain", to the plain automaton on the card; with a forced
    cap the capped reads re-run on the host and the values hold."""
    from bwt_tpu_torch.ops import automaton

    rng = np.random.default_rng(19)
    g = rng.integers(0, 4, 40000).astype(np.uint8)
    on_card = bwt_tpu_torch.build_index(g, sa_sample_rate=8, device=card)
    reads = _automaton_mix(g, rng)
    want = rnaseq.rna_seq(on_card.to("cpu"), reads)
    cfg = dataclasses.replace(DEFAULT, search_batch=128)
    svc = QueryService(on_card, config=cfg)
    launches = automaton.AUTOMATON_LAUNCHES, service.SERVICE_LAUNCHES
    got = rnaseq.rna_seq(on_card, reads, service=svc)
    assert automaton.AUTOMATON_LAUNCHES == launches[0] + 4
    assert service.SERVICE_LAUNCHES == launches[1]
    stats = svc.last_stats
    assert stats["chunks"] == stats["automaton_launches"] == 4
    assert np.array_equal(got, want)
    assert np.array_equal(rnaseq.rna_seq(on_card, reads, engine="host"), want)
    svc.svc_impl = "plain"
    assert np.array_equal(rnaseq.rna_seq(on_card, reads, service=svc), want)
    assert svc.last_stats["automaton_launches"] == 0
    monkeypatch.setattr(rnaseq, "_TEST_CAP", 4)
    svc = QueryService(on_card)
    assert np.array_equal(rnaseq.rna_seq(on_card, reads, service=svc), want)
    assert svc.last_stats["capped"] > 0


def test_automaton_overrun_raises_on_card(card):
    """On a np.zeros genome a read ending in C walks from a row past the
    suffix array: K9 raises as its plain version does, naming the row."""
    from bwt_tpu_torch.ops import automaton

    fmi = bwt_tpu_torch.build_index(np.zeros(64, np.uint8), sa_sample_rate=4,
                                    device=card)
    bank = torch.zeros((8, 32), dtype=torch.uint8, device=card)
    bank[3, 19] = 1  # 'C', absent
    lens = torch.full((8,), 20, dtype=torch.int32, device=card)
    live0 = torch.arange(8, device=card) < 6
    launches = automaton.AUTOMATON_LAUNCHES
    for plain in (False, True):
        with pytest.raises(RuntimeError, match="row 65"):
            automaton.rna_seq_automaton(fmi, bank, lens, live0, ac=14, cc=10,
                                        resolve=False, plain=plain)
    assert automaton.AUTOMATON_LAUNCHES == launches + 1
    with pytest.raises(ValueError, match="bank"):
        automaton.rna_seq_automaton(fmi, bank.to(torch.int32), lens, live0,
                                    ac=14, cc=10, resolve=False)
    with pytest.raises(ValueError, match="isa_samples"):
        automaton.rna_seq_automaton(
            dataclasses.replace(fmi, isa_samples=None), bank, lens, live0,
            ac=14, cc=10, resolve=False)
    assert automaton.AUTOMATON_LAUNCHES == launches + 1


# -- the aligner's device engine: K10, K11a, K11b -------------------------


def _align_mix(g, rng, n=600):
    """80-bp reads with one substitution, a 1-3-base indel, N's, random
    reads, short reads, and 200-bp reads whose logs overflow."""
    reads = []
    for k in range(n):
        j = int(rng.integers(0, len(g) - 90))
        r = g[j:j + 83].copy()
        r[int(rng.integers(0, 80))] = rng.integers(0, 4)
        if k % 5 == 1:
            d = int(rng.integers(1, 4))
            r = np.concatenate([r[:40], r[40 + d:]])
        if k % 5 == 2:
            r = np.concatenate([r[:40], rng.integers(0, 4, 2).astype(np.uint8),
                                r[40:]])
        if k % 13 == 0:
            r[int(rng.integers(0, 80))] = 5
        if k % 7 == 0:  # the reverse complement, N staying N
            r = np.where(r[:80] == 5, 5, 3 - r[:80])[::-1].astype(np.uint8)
        reads.append(r[:80].copy())
    reads += [rng.integers(0, 4, 80).astype(np.uint8) for _ in range(20)]
    reads += [g[j:j + ln].copy() for j, ln in zip(
        rng.integers(0, len(g) - 30, 9), (1, 4, 5, 11, 12, 13, 15, 20, 22))]
    for _ in range(4):
        j = int(rng.integers(0, len(g) - 200))
        r = g[j:j + 200].copy()
        r[8::16] = (r[8::16] + 1) % 4
        reads.append(r)
    return reads


def _align_env(card, seed, seed_k):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, 60000).astype(np.uint8)
    fmi = bwt_tpu_torch.build_index(g, sa_sample_rate=8, device=card)
    svc = QueryService(fmi, g)
    reads = _align_mix(g, rng)
    svc.add_reads_batch(reads, with_revcomp=True)
    Bp = svc.bank8.shape[0] // 2
    lens = np.zeros(Bp, np.int32)
    lens[:len(reads)] = [len(r) for r in reads]
    seed_rows = search.build_seed_table(fmi, seed_k).rows if seed_k else None
    return g, fmi, svc, (svc.bank8, torch.from_numpy(lens).to(card),
                         torch.arange(Bp, device=card) < len(reads), len(g),
                         seed_rows)


@pytest.mark.parametrize("cap", [0, 1, 2, 3, 5, 6],
                         ids=["uncapped", "cap-1", "cap-2", "cap-3", "cap-5",
                              "cap-6"])
@pytest.mark.parametrize("seed_k", [0, 12], ids=["no-seed", "seed-12"])
@pytest.mark.parametrize("resolve", [False, True], ids=["raw", "resolve"])
def test_align_automaton_kernel_matches_plain(card, cap, seed_k, resolve):
    """K10 against its plain version on the card, bit-equal in every column,
    the log and the flag: uncapped and at caps that fall inside a tile's
    round, with and without a k = 12 seed table and N resolution; against
    the plain version's lockstep and at the kernel's tile width.  The mix
    holds indel reads
    (curgaps accepted late, all nine rejected: a RESET) and reads whose
    forward strand fails (the strand retry)."""
    from bwt_tpu_torch.ops import automaton

    _, fmi, _, args = _align_env(card, 41, seed_k)
    kw = dict(anchor_len=12, resolve=resolve, cap_steps=cap, seed_k=seed_k)
    launches = automaton.ALIGN_LAUNCHES
    got = automaton.align_automaton_packed(fmi, *args, **kw)
    assert automaton.ALIGN_LAUNCHES == launches + 1
    want = automaton.align_automaton_packed(fmi, *args, plain=True, **kw)
    assert torch.equal(got, want)
    v = automaton.align_unpack(got)
    at_tile = automaton.align_automaton_plain(fmi, *args,
                                              width=automaton.TILE, **kw)
    for c in automaton.ALIGN_COLS + automaton.LOG_COLS:
        assert torch.equal(v[c], at_tile[c]), c
    assert automaton.ALIGN_LAUNCHES == launches + 1
    assert bool(v["capped"].any()) == (cap > 0)
    if cap == 0:  # the long reads' logs overflow once they run to their end
        assert bool(v["ovf"].any()) and bool((v["mode"] == 1).any())


def test_log_stitch_and_compose_kernels_match_plain(card, monkeypatch):
    """K11a on every bucket of one chunk's log against its plain version,
    the accumulators bit-equal after each bucket, in the warp forms, the
    block form (a bucket padded past 128 rows) and the read-back form (the
    threshold's test hook at 0); then K11b against its plain version, at
    the compose's width and at a width of 1."""
    from bwt_tpu_torch.ops import automaton, compose

    _, fmi, svc, args = _align_env(card, 43, 0)
    log = automaton.align_automaton_packed(fmi, *args, anchor_len=12,
                                           resolve=True)
    v = automaton.align_unpack(log)
    Lb = svc.bank8.shape[1]
    NL2 = -(-(Lb + 10) // aligner._DP_GRAN)
    order, counts = aligner._job_bucket_sort(
        v["mode"], v["lp"], v["ovf"], v["kinds"], v["rlens"], v["glens"],
        NB=-(-Lb // aligner._DP_GRAN) * NL2, NL2=NL2)
    counts = counts.cpu().numpy()
    offs = np.concatenate([[0], np.cumsum(counts)])
    Bp = automaton.align_lanes(log)
    got, want = dp_wavefront.log_acc(Bp, card), dp_wavefront.log_acc(Bp, card)
    launches = dp_wavefront.LOG_STITCH_LAUNCHES
    n = 0
    for form, pad, tall in (("warp", 0, None), ("block", 160, None),
                            ("tall", 0, 0)):
        if tall is not None:
            monkeypatch.setattr(dp_wavefront, "_TALL_ROWS", tall)
        for b in np.nonzero(counts)[0].tolist():
            l1, l2 = divmod(b, NL2)
            jk, jt = aligner._bucket_ids(order, int(offs[b]), int(counts[b]))
            kw = dict(L1=aligner._DP_GRAN * (l1 + 1) + pad,
                      L2=aligner._DP_GRAN * (l2 + 1))
            dp_wavefront.dp_log_stitch(log, svc.bank, svc.genome_dev, jk, jt,
                                       got, **kw)
            dp_wavefront.dp_log_stitch(log, svc.bank, svc.genome_dev, jk, jt,
                                       want, plain=True, **kw)
            n += 1
            assert torch.equal(got, want), (form, b)
    assert dp_wavefront.LOG_STITCH_LAUNCHES == launches + n
    assert int(dp_wavefront.acc_unpack(got)[1].sum()) > 0
    launches = compose.COMPOSE_LAUNCHES
    for K in (compose.RUNS_K, 1):
        rows = compose.compose(log, got, K=K)
        assert torch.equal(rows, compose.compose(log, got, K=K, plain=True))
    assert compose.COMPOSE_LAUNCHES == launches + 2


@pytest.mark.parametrize("K", [16, 8, 1])
@pytest.mark.parametrize("Bp", [1, 31, 33, 4103])
def test_compose_kernel_edge_rows_match_plain(card, Bp, K):
    """K11b against its plain version on chip_smoke.compose_edge_rows, warps
    full and partial: log pointers past the 16 slots, blocks past BLOCK_W,
    streams past F2, counts past 254 and int16, more runs than K and 8."""
    from bwt_tpu_torch.ops import compose

    log, acc = (t.to(card) for t in compose_edge_rows(
        np.random.default_rng(Bp + K), Bp))
    launches = compose.COMPOSE_LAUNCHES
    rows = compose.compose(log, acc, K=K)
    assert compose.COMPOSE_LAUNCHES == launches + 1
    assert torch.equal(rows, compose.compose(log, acc, K=K, plain=True))


@pytest.mark.parametrize("L1,L2", [(32, 32), (32, 64), (32, 96), (64, 64),
                                   (96, 96), (160, 96)])
def test_log_stitch_edge_jobs_kernel_matches_plain(card, L1, L2):
    """K11a on chip_smoke.log_edge_jobs (rlen 0, glen < 0 and 0, rlen = 32,
    clamped slices, more runs than kept, two head stitches on one read)
    against its plain version, in the warp form with one, two and four
    stripes of rows 1..L1 and in the block form; and the same accumulators
    with the jobs in another order."""
    from bwt_tpu_torch.ops import automaton

    log, bank, genome, jk, jt = (t.to(card) for t in log_edge_jobs(
        np.random.default_rng(L1 * L2)))
    Bp = automaton.align_lanes(log)
    got, want = dp_wavefront.log_acc(Bp, card), dp_wavefront.log_acc(Bp, card)
    launches = dp_wavefront.LOG_STITCH_LAUNCHES
    dp_wavefront.dp_log_stitch(log, bank, genome, jk, jt, got, L1=L1, L2=L2)
    dp_wavefront.dp_log_stitch(log, bank, genome, jk, jt, want, L1=L1, L2=L2,
                               plain=True)
    assert dp_wavefront.LOG_STITCH_LAUNCHES == launches + 1
    assert torch.equal(got, want)
    perm = torch.randperm(jk.shape[0], device=card)
    again = dp_wavefront.log_acc(Bp, card)
    dp_wavefront.dp_log_stitch(log, bank, genome, jk[perm].contiguous(),
                               jt[perm].contiguous(), again, L1=L1, L2=L2)
    assert torch.equal(again, want)


def test_align_device_engine_on_card_matches_cpu(card, monkeypatch):
    """align_reads' default engine on the card: one K10 and one K11b launch
    a chunk, one K11a launch a non-empty bucket, no K7 launch outside the
    escapes; equal to the CPU run, to the host engine and, through the plain
    versions (svc_impl, dp_impl), on the card; with a forced cap and a
    compose width of 1 the escapes hold the results."""
    from bwt_tpu_torch.ops import automaton, compose

    g, on_card, _, _ = _align_env(card, 47, 0)
    reads = _align_mix(g, np.random.default_rng(5), n=300)

    def norm(rs):
        return [(p, c.render() if c else None, s) for p, c, s in rs]

    want = norm(aligner.align_reads(on_card.to("cpu"), g, reads,
                                    with_strand=True))
    cfg = dataclasses.replace(DEFAULT, search_batch=128)
    svc = QueryService(on_card, g, cfg)
    before = (automaton.ALIGN_LAUNCHES, compose.COMPOSE_LAUNCHES,
              dp_wavefront.LOG_STITCH_LAUNCHES)
    got = aligner.align_reads(on_card, g, reads, service=svc,
                              with_strand=True)
    st = svc.last_stats
    assert norm(got) == want
    assert st["chunks"] == -(-len(reads) // 128) == st["align_launches"]
    assert automaton.ALIGN_LAUNCHES == before[0] + st["chunks"]
    assert compose.COMPOSE_LAUNCHES == before[1] + st["chunks"]
    assert dp_wavefront.LOG_STITCH_LAUNCHES == before[2] + st["buckets"]
    assert st["fallback"] >= 4  # the overflowing logs
    assert norm(aligner.align_reads(on_card, g, reads, engine="host",
                                    with_strand=True)) == want
    svc.svc_impl = svc.dp_impl = "plain"
    assert norm(aligner.align_reads(on_card, g, reads, service=svc,
                                    with_strand=True)) == want
    assert svc.last_stats["align_launches"] == 0
    monkeypatch.setattr(aligner, "_TEST_CAP", 4)
    monkeypatch.setattr(aligner, "_RUNS_K", 1)
    svc = QueryService(on_card, g)
    assert norm(aligner.align_reads(on_card, g, reads, service=svc,
                                    with_strand=True)) == want
    assert svc.last_stats["capped"] > 0 and svc.last_stats["redo"] > 0


@pytest.mark.parametrize("where", ["first", "retry"])
def test_align_automaton_overrun_raises_on_card(card, where):
    """On a np.zeros genome a read ending in C starts the anchor's walk
    from a row past the suffix array: K10 raises as its plain version does,
    naming the row; on the first attempt, and on a retry
    (A*36 C AAA misses, then overruns at ln = 37, in a round that also
    issues later retries, misses and a stop); a wrong bank or an index
    without isa_samples raises before any launch."""
    from bwt_tpu_torch.ops import automaton

    fmi = bwt_tpu_torch.build_index(np.zeros(64, np.uint8), sa_sample_rate=4,
                                    device=card)
    svc = QueryService(fmi, np.zeros(64, np.uint8))
    last = (np.array([0] * 19 + [1], np.uint8) if where == "first" else
            np.array([0] * 36 + [1] + [0] * 3, np.uint8))
    svc.add_reads_batch([np.zeros(20, np.uint8)] * 3 + [last] * 2,
                        with_revcomp=True)
    Bp = svc.bank8.shape[0] // 2
    lens = torch.full((Bp,), 20, dtype=torch.int32, device=card)
    lens[3:5] = len(last)
    live0 = torch.arange(Bp, device=card) < 5
    launches = automaton.ALIGN_LAUNCHES
    for plain in (False, True):
        with pytest.raises(RuntimeError, match="row 65 did not reach"):
            out = automaton.align_automaton_packed(
                fmi, svc.bank8, lens, live0, 64, anchor_len=12,
                resolve=False, plain=plain)
            automaton.align_automaton_raise(fmi, out)
    assert automaton.ALIGN_LAUNCHES == launches + 1
    with pytest.raises(ValueError, match="bank"):
        automaton.align_automaton_packed(fmi, svc.bank, lens, live0, 64,
                                         anchor_len=12, resolve=False)
    with pytest.raises(ValueError, match="isa_samples"):
        automaton.align_automaton_packed(
            dataclasses.replace(fmi, isa_samples=None), svc.bank8, lens,
            live0, 64, anchor_len=12, resolve=False)
    assert automaton.ALIGN_LAUNCHES == launches + 1


# --------------------------------------------------------------------------
# the tp form of the search kernels (fm::IndexT<true>) over views made in
# this process: K3, K4, locate, anchor_scan, K5, K6, K7, K9 and K10
# --------------------------------------------------------------------------


@pytest.mark.parametrize("blocks,coord", [(1, 0), (2, 1), (3, 2)],
                         ids=["1-block", "2-blocks", "3-blocks"])
def test_tp_kernels_match_replicated(search_env, blocks, coord):
    """Every kernel over a view of ``blocks`` blocks (a table of one
    entry; two and three allocations of this process, no IPC) equals the
    replicated kernel on the whole index, outputs and raises alike; the
    view's runs launch the kernels (no plain version)."""
    from bwt_tpu_torch import parallel

    codes, fmi, _ = search_env
    rng = np.random.default_rng(13)
    x = tp_inputs(fmi, codes[:fmi.length], rng, fmi.device, 1024)
    view = parallel.mesh.view_in_process(fmi, blocks, coord)
    assert view.buckets.shape[0] == -(-fmi.bucket_rows // blocks)
    try:
        want = {k: tp_outcome(fn) for k, fn in tp_cases(fmi, x).items()}
        tp_launches(zero=True)
        got = {k: tp_outcome(fn) for k, fn in tp_cases(view, x).items()}
        launched = tp_launches()
    finally:
        parallel.release_view(view)
    for k in want:
        assert tp_equal(got[k], want[k]), k
        assert launched[k] > 0, k
    assert not any(isinstance(v, type) for v in want.values()) or (
        fmi.length == 500)  # only the repetitive genome raises


def test_tp_view_refuses_without_tables(card):
    """A CPU shard moved to the card has no device tables: the kernels
    refuse it rather than read its block as the whole table; a released
    view refuses too."""
    from bwt_tpu_torch import parallel

    g = np.random.default_rng(3).integers(0, 4, 5000).astype(np.uint8)
    fmi = bwt_tpu_torch.build_index(g, device=card)
    view = parallel.mesh.view_in_process(fmi, 2)
    pats = torch.zeros((4, 8), dtype=torch.int32, device=card)
    lens = torch.full((4,), 8, dtype=torch.int32, device=card)
    search.backward_search(view, pats, lens)
    no_tables = dataclasses.replace(
        view, shard=dataclasses.replace(view.shard, tables=None))
    with pytest.raises(ValueError, match="device tables"):
        search.backward_search(no_tables, pats, lens)
    parallel.release_view(view)
    with pytest.raises(ValueError, match="released"):
        search.backward_search(view, pats, lens)


# --------------------------------------------------------------------------
# the wide (int64) index: K3, K4, locate, anchor_scan and K5 in their wide
# instantiations (fm::IndexT<kTp, true>)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wide_env(search_env):
    """search_env's genome as the wide index on the card, with the inputs
    of the wide kernels (chip_smoke.wide_inputs)."""
    codes, fmi, _ = search_env
    wide = bwt_tpu_torch.build_index(codes[:fmi.length], sa_sample_rate=fmi.sa_rate,
                                     index_dtype=np.int64, device="cuda")
    rng = np.random.default_rng(17)
    x = tp_inputs(fmi, codes[:fmi.length], rng, fmi.device, 1024)
    return fmi, wide, wide_inputs(x, rng)


@pytest.mark.parametrize("shift", ["wide", "shifted", "counts"])
def test_wide_kernels_match_plain(wide_env, shift):
    """Each wide instantiation bit-equal to its plain version (outputs, and
    raises alike), on the wide index, on the shifted-samples one, whose
    positions pass int32, and on the shifted-counts one, whose counts'
    high halves are not 0 (its device layout derived on the card); each
    call launches its kernel."""
    _, wide, x = wide_env
    fmi = {"wide": wide, "shifted": shifted_index(wide),
           "counts": shifted_counts(wide)}[shift]
    assert fmi.rows32.device == fmi.device and fmi.bases.device == fmi.device
    want = {k: tp_outcome(fn)
            for k, fn in tp_cases(fmi, x, plain=True).items()
            if k in WIDE_KERNELS}
    for k, fn in tp_cases(fmi, x).items():
        if k not in WIDE_KERNELS:
            continue
        tp_launches(zero=True)
        got = tp_outcome(fn)
        assert tp_launches()[k] > 0, k
        assert tp_equal(got, want[k]), k
        if isinstance(got, list):
            assert all(t.dtype in (torch.int64, torch.int32) for t in got)
    if shift == "shifted":  # the walks' sums wrap by length + 1: past int32
        pos = want["locate"][0]
        assert (pos > torch.iinfo(torch.int32).max).any()
    if shift == "counts":  # its LF steps are the index's own
        assert (fmi.bases[:-1, :] >> 32 == 192).all()
        assert tp_equal(want["K4"], tp_outcome(tp_cases(wide, x)["K4"]))


def test_wide_kernels_match_int32_kernels(wide_env):
    """On clean inputs (genome 30-mers and 50-bp reads, rows of the suffix
    array) the wide kernels give the int32 kernels' values, in int64."""
    fmi, wide, x = wide_env
    rows = x["rows"][x["rows"] <= fmi.length]
    pairs = [
        (lambda f: [search.locate(f, x["kmers"], x["klens"])]),
        (lambda f: [search.unc_sa(f, rows.to(f.pos_dtype))]),
        (lambda f: list(search.backward_search(f, x["kmers"],
                                               x["klens"]).values())),
        (lambda f: list(exact.anchor_scan(f, x["sr"], x["srlens"],
                                          min_anchor=20, reverse=True))),
        (lambda f: [search.build_seed_table(f, k=5).rows]),
    ]
    for fn in pairs:
        got, want = tp_outcome(lambda: fn(wide)), tp_outcome(lambda: fn(fmi))
        assert isinstance(got, list) and len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype in (torch.int64, torch.bool, torch.int32)
            assert torch.equal(a.long(), b.long())


@pytest.mark.parametrize("blocks,coord", [(1, 0), (2, 1), (3, 2)],
                         ids=["1-block", "2-blocks", "3-blocks"])
def test_wide_tp_kernels_match_replicated(wide_env, blocks, coord):
    """The tp form of each wide kernel (48-byte rows through the table of
    block pointers) equals the replicated wide kernel."""
    from bwt_tpu_torch import parallel

    _, wide, x = wide_env
    want = {k: tp_outcome(fn) for k, fn in tp_cases(wide, x).items()
            if k in WIDE_KERNELS}
    view = parallel.mesh.view_in_process(wide, blocks, coord)
    try:
        assert view.wide
        tp_launches(zero=True)
        got = {k: tp_outcome(fn) for k, fn in tp_cases(view, x).items()
               if k in WIDE_KERNELS}
        launched = tp_launches()
    finally:
        parallel.release_view(view)
    for k in want:
        assert tp_equal(got[k], want[k]), k
        assert launched[k] > 0, k


def test_wide_device_layout_on_card(wide_env):
    """A wide index on the card holds rows32 and bases, derived there by
    each index made (the build, from_numpy, to, a replace of its rows)
    and equal to the CPU's derivation of its own rows; to() between
    devices makes or drops them, narrow drops them, and a kernel refuses
    a wide index on the card without them rather than read its 12-int
    rows."""
    import copy

    from bwt_tpu_torch import index as tindex
    from bwt_tpu_torch.ops import rank as rank_ops

    _, wide, x = wide_env
    rows32, bases = rank_ops.derive_rows(wide.buckets.cpu())
    host = wide.to("cpu")
    assert host.rows32 is None and host.bases is None
    for fmi in (wide, host.to(wide.device),
                bwt_tpu_torch.from_numpy(host.to_numpy(), device="cuda")):
        assert torch.equal(fmi.rows32.cpu(), rows32)
        assert torch.equal(fmi.bases.cpu(), bases)
    again = wide.to(wide.device)  # its own rows, derived anew
    assert torch.equal(again.rows32, wide.rows32)
    assert torch.equal(again.bases, wide.bases)
    assert tindex.narrow(wide).rows32 is None
    moved = shifted_counts(wide)  # a replace of the rows derives anew
    want = rank_ops.derive_rows(moved.buckets.cpu())
    assert torch.equal(moved.rows32.cpu(), want[0])
    assert torch.equal(moved.bases.cpu(), want[1])
    assert not torch.equal(moved.bases, wide.bases)
    bare = copy.copy(wide)
    object.__setattr__(bare, "rows32", None)
    before = tp_launches()
    with pytest.raises(ValueError, match="device layout"):
        search.locate(bare, x["kmers"], x["klens"])
    assert tp_launches() == before


def test_wide_index_refusals_on_card(wide_env):
    """The drivers bwt_tpu serves no wide index through raise ValueError
    before any launch."""
    _, wide, x = wide_env
    before = (tp_launches(), service.SERVICE_LAUNCHES)
    reads = ["ACGT" * 10]
    for fn in (lambda: aligner.align_reads(wide, "ACGT" * 100, reads),
               lambda: rnaseq.rna_seq(wide, reads),
               lambda: search.isa_window(wide, x["plo"], x["wid"]),
               lambda: QueryService(wide)):
        with pytest.raises(ValueError, match="wide"):
            fn()
    assert (tp_launches(), service.SERVICE_LAUNCHES) == before


def test_wide_main_path_on_card_matches_cpu(card):
    """build_index(index_dtype=int64) on the card equals the CPU build,
    and search_reads and locate on it equal the CPU's, int64 positions."""
    g = np.random.default_rng(5).integers(0, 4, 20000).astype(np.uint8)
    on_card = bwt_tpu_torch.build_index(g, sa_sample_rate=8,
                                        index_dtype=np.int64, device=card)
    on_cpu = bwt_tpu_torch.build_index(g, sa_sample_rate=8,
                                       index_dtype=np.int64, device="cpu")
    a, b = on_card.to_numpy(), on_cpu.to_numpy()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        assert np.array_equal(a[k], b[k]), k
    rng = np.random.default_rng(6)
    starts = rng.integers(0, len(g) - 50, size=300)
    reads = g[np.add.outer(starts, np.arange(50))]
    got = exact.search_reads(on_card, reads)
    want = exact.search_reads(on_cpu, reads)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k]), k
    assert got["fwd_pos"].dtype == np.int64
    assert np.array_equal(got["fwd_pos"], starts)
    pats = reads[:, :30].astype(np.int32)
    lens = np.full(300, 30, np.int32)
    pos = search.locate(on_card, pats, lens)
    assert pos.dtype == torch.int64
    assert torch.equal(pos.cpu(), search.locate(on_cpu, pats, lens))
    shifted = search.locate(shifted_index(on_card), pats, lens).cpu()
    assert torch.equal(shifted, search.locate(shifted_index(on_cpu), pats,
                                              lens))
    assert bool((shifted > WIDE_SHIFT - len(g) - 2).all())


# --------------------------------------------------------------------------
# a refused launch at each of the library's launch sites: KernelLaunchError
# for a device-failure code, a plain RuntimeError for an argument error
# (config.elastic_fallback recovers from it; ops._kernels.device_failure)
# --------------------------------------------------------------------------

LAUNCH_SITES = ("dp_wavefront_launch", "dp_stitch_launch",
                "dp_log_stitch_launch", "compose_launch",
                "backward_search_launch", "unc_sa_launch", "locate_launch",
                "anchor_scan_launch", "isa_window_launch", "seed_rows_launch",
                "service_launch", "rnaseq_automaton_launch",
                "align_automaton_launch", "peer_alloc")


@pytest.mark.parametrize("code", (719, 1))
@pytest.mark.parametrize("launcher", LAUNCH_SITES)
def test_refused_launch_raises_by_its_code(card, launcher, code):
    """The library's ``launcher`` refusing its first call with CUDA error
    ``code``, without launching (``ops._kernels.refusing``), makes the
    path that reaches it raise: KernelLaunchError, a device failure, for
    719 (cudaErrorLaunchFailure); a plain RuntimeError, which no recovery
    catches, for 1 (cudaErrorInvalidValue, the launchers' own argument
    checks)."""
    from bwt_tpu_torch import parallel
    from bwt_tpu_torch.ops import _kernels

    from chip_smoke import mutated_reads

    rng = np.random.default_rng(16)
    codes = rng.integers(0, 4, 1 << 14).astype(np.uint8)
    fmi = bwt_tpu_torch.build_index(codes, sa_sample_rate=4, device=card)
    starts, reads = mutated_reads(rng, codes, 64)  # with DP stitches to do
    pats = torch.from_numpy(reads[:, :30].astype(np.int32)).to(card)
    lens = torch.full((64,), 30, dtype=torch.int32, device=card)
    jr, jg = _jobs(rng, 8, 32, 64)
    paths = {
        "dp_wavefront_launch": lambda: dp_wavefront.nw_fast_batch(
            jr, np.full(8, 32), jg, np.full(8, 64)),
        "dp_stitch_launch": lambda: aligner.align_reads(
            fmi, codes, reads, engine="host"),
        "service_launch": lambda: rnaseq.rna_seq(
            fmi, reads[:, :50], engine="host"),
        "rnaseq_automaton_launch": lambda: rnaseq.rna_seq(
            fmi, reads[:, :50]),
        "backward_search_launch": lambda: search.count_matches(
            fmi, pats, lens),
        "unc_sa_launch": lambda: search.unc_sa(fmi, lens),
        "locate_launch": lambda: search.locate(fmi, pats, lens),
        "anchor_scan_launch": lambda: exact.search_reads(fmi, reads),
        "isa_window_launch": lambda: search.isa_window(
            fmi, starts.astype(np.int32), np.full(64, 8, np.int32)),
        "seed_rows_launch": lambda: search.build_seed_table(fmi, k=4),
        "peer_alloc": lambda: parallel.mesh.view_in_process(fmi, 2),
    }
    # the aligner's device engine reaches K10, then K11a, then K11b
    for name in ("align_automaton_launch", "dp_log_stitch_launch",
                 "compose_launch"):
        paths[name] = lambda: aligner.align_reads(fmi, codes, reads)
    assert set(paths) == set(LAUNCH_SITES)
    cls = _kernels.KernelLaunchError if code == 719 else RuntimeError
    with _kernels.refusing(launcher, 1, code):
        with pytest.raises(cls, match=f"CUDA error {code}$") as info:
            paths[launcher]()
    assert type(info.value) is cls
    assert _kernels.device_failure(info.value) == (code == 719)
    torch.cuda.synchronize()  # the card is unharmed


def test_build_memory_and_buckets_on_card(card, monkeypatch):
    """The build of a 2^25-base genome allocates at most 24 bytes a base
    on the card beyond what was there before it, its suffix sort split
    into buckets; the card's SA and ISA of a 2^20-base genome sorted in
    at least 4 buckets equal the CPU's single-bucket sort, int32 and
    int64."""
    rng = np.random.default_rng(25)
    n = 1 << 25
    g = rng.integers(0, 4, n).astype(np.uint8)
    torch.cuda.synchronize(card)
    before = torch.cuda.memory_allocated(card)
    torch.cuda.reset_peak_memory_stats(card)
    fmi = bwt_tpu_torch.build_index(g, device=card)
    torch.cuda.synchronize(card)
    used = torch.cuda.max_memory_allocated(card) - before
    assert used <= 24 * n, used / n
    assert suffix.LAST_SORT.buckets[0] > 1
    del fmi
    small = torch.from_numpy(rng.integers(0, 4, 1 << 20).astype(np.uint8))
    for dtype in (torch.int32, torch.int64):
        want = suffix.suffix_array_with_isa(small, dtype=dtype)
        assert suffix.LAST_SORT.buckets == [1] * suffix.LAST_SORT.rounds
        with monkeypatch.context() as mp:
            mp.setattr(suffix, "BUCKET", 1 << 18)
            got = suffix.suffix_array_with_isa(small.to(card), dtype=dtype)
        assert suffix.LAST_SORT.buckets[0] >= 4
        for w, c in zip(want, got):
            assert torch.equal(c.cpu(), w)
