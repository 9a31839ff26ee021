"""The port's single_align device engine against bwt_tpu's, on the CPU.

``bwt_tpu_torch.models.aligner.align_reads`` on its device engine (the
plain versions of K10, K11a and K11b on a CPU index) against ``bwt_tpu``'s
device and host engines on the same reads: positions, CIGAR strings,
strands and the reference-format text, tolerance 0.  The plain automaton
against ``bwt_tpu.models.aligner._align_automaton`` on one bank, every
output (capped, uncapped, seeded, without N resolution); the phase-B units
(``dp_blocks``, the log stitch, the bucket sort, the compose and its packed
row, the host compose) against bwt_tpu's on the same inputs; the escapes
(redo, forced cap), the chunk pipeline, engine selection and
``align_read_anchored``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bwt_tpu.models import aligner as jaligner
from bwt_tpu.models import batch_exec as jbatch

from bwt_tpu_torch.config import Config as TConfig
from bwt_tpu_torch.models import aligner as taligner
from bwt_tpu_torch.models import batch_exec as tbatch
from bwt_tpu_torch.ops import automaton as au
from bwt_tpu_torch.ops import compose as cmp
from bwt_tpu_torch.ops import dp_wavefront as dpw
from bwt_tpu_torch.ops import service

from test_torch_automaton import env  # noqa: F401  (the shared fixture)


def _mix(g, seed):
    """80 reads of 50-80 bp with 0-4 substitutions (a third reverse
    complemented), 20 with a 1-3-base insertion or deletion, 10 random reads
    whose anchor hunt runs out, reads of the lengths around the anchor and
    the cutoffs, reads with N's (inner, trailing), and two 200-bp reads with a
    substitution every 16 bases, whose logs overflow their 16 slots."""
    rng = np.random.default_rng(seed)
    reads = []
    for _ in range(80):
        L = int(rng.integers(50, 81))
        j = int(rng.integers(0, len(g) - L))
        r = g[j:j + L].copy()
        for _ in range(int(rng.integers(0, 5))):
            r[int(rng.integers(0, L))] = rng.integers(0, 4)
        if rng.random() < 0.3:
            r = (3 - r)[::-1].copy()
        reads.append(r)
    for _ in range(20):
        j = int(rng.integers(0, len(g) - 90))
        r = g[j:j + 83].copy()
        k, d = int(rng.integers(10, 70)), int(rng.integers(1, 4))
        if rng.random() < 0.5:
            r = np.concatenate([r[:k], r[k + d:]])[:80]
        else:
            r = np.concatenate([r[:k], rng.integers(0, 4, d).astype(np.uint8),
                                r[k:]])[:80]
        reads.append(r)
    reads += [rng.integers(0, 4, 80).astype(np.uint8) for _ in range(10)]
    for ln in (1, 4, 5, 11, 12, 13, 15, 20, 22):
        j = int(rng.integers(0, len(g) - ln))
        reads.append(g[j:j + ln].copy())
    for k in range(8):
        j = int(rng.integers(0, len(g) - 60))
        r = g[j:j + 60].copy()
        r[int(rng.integers(0, 60))] = 5
        if k % 3 == 0:
            r[-1] = 5
        reads.append(r)
    for _ in range(2):
        j = int(rng.integers(0, len(g) - 200))
        r = g[j:j + 200].copy()
        r[8::16] = (r[8::16] + 1) % 4
        reads.append(r)
    return reads


@pytest.fixture(scope="module")
def mix(env):  # noqa: F811
    return _mix(env[0], 31)


def _norm(results):
    return [(p, c.render() if c else None, s) for p, c, s in results]


@pytest.fixture(scope="module")
def jax_results(env, mix):  # noqa: F811
    """bwt_tpu's two engines on the mix, once for the module."""
    g, jfmi, _ = env
    return tuple(jaligner.align_reads(jfmi, g, mix, engine=eng,
                                      with_strand=True)
                 for eng in ("device", "host"))


def _banks(env, reads):  # noqa: F811
    g, jfmi, tfmi = env
    jsvc, tsvc = jbatch.QueryService(jfmi, g), tbatch.QueryService(tfmi, g)
    jsvc.add_reads_batch(reads, with_revcomp=True)
    tsvc.add_reads_batch(reads, with_revcomp=True)
    Bp = tsvc.bank8.shape[0] // 2
    lens = np.zeros(Bp, np.int32)
    lens[:len(reads)] = [len(r) for r in reads]
    return jsvc, tsvc, lens, np.arange(Bp) < len(reads)


@pytest.fixture(scope="module")
def logs(env, mix):  # noqa: F811
    """One bank of the mix through both automatons (uncapped, resolving
    N's): bwt_tpu's outputs, the port's packed output and the services."""
    g, jfmi, tfmi = env
    jsvc, tsvc, lens, live0 = _banks(env, mix)
    jout = jaligner._align_automaton(
        jfmi, jsvc.bank, jnp.asarray(lens), jnp.asarray(live0),
        jnp.int32(len(g)), None, anchor_len=12, resolve=True)
    tout = au.align_automaton_packed(
        tfmi, tsvc.bank8, torch.from_numpy(lens), torch.from_numpy(live0),
        len(g), anchor_len=12, resolve=True)
    return jsvc, tsvc, [np.asarray(x) for x in jout], tout


_OUTS = ("mode", "curpos", "strand", "lp", "ovf", "kinds", "roffs", "rlens",
         "glens", "gstarts", "capped")


def test_plain_automaton_matches_bwt_tpu_uncapped(logs):
    _, _, jout, tout = logs
    v = au.align_unpack(tout)
    for name, want in zip(_OUTS, jout):
        assert np.array_equal(v[name].numpy(), want.astype(np.int64)), name
    # the round count of bwt_tpu's loop is the longest read's iterations
    assert int(v["iters"].max()) == int(jout[11][0])
    assert int(v["ovf"].sum()) >= 2  # the 200-bp reads overflow their log
    assert not int(tout[-4:].abs().sum())  # no walk overran
    modes = np.bincount(v["mode"].numpy(), minlength=3)
    assert modes[0] and modes[1] and modes[2]


def _edges(g, seed):
    """Reads for the edges of the tile schedule: a 9-base insertion (its
    curgap accepted at g = 9), a 12-base insertion (all nine curgaps
    rejected, then a RESET), random reads (the forward hunt runs out, then
    the strand retry), and a substitution in the last bases."""
    rng = np.random.default_rng(seed)
    reads = []
    for k in range(24):
        j = int(rng.integers(0, len(g) - 100))
        ins = rng.integers(0, 4, 9 if k % 3 == 0 else 12).astype(np.uint8)
        if k % 3 == 2:
            r = g[j:j + 80].copy()
            r[int(rng.integers(70, 80))] ^= 1
        else:
            r = np.concatenate([g[j:j + 38], ins, g[j + 38:j + 80]])[:80]
        reads.append(r)
    reads += [rng.integers(0, 4, 80).astype(np.uint8) for _ in range(6)]
    return reads


@pytest.fixture(scope="module")
def width1():
    """The width-1 plain runs' iteration counts, by case."""
    return {}


@pytest.mark.parametrize("width", [1, 2, 4, 8])
@pytest.mark.parametrize("cap,seed_k,resolve,reads", [
    (6, 0, True, "mix"), (0, 8, True, "mix"), (0, 0, False, "mix"),
    (1, 0, True, "mix"), (2, 0, True, "mix"), (3, 0, True, "mix"),
    (5, 0, True, "mix"), (0, 0, True, "edges"), (5, 0, True, "edges")],
    ids=["cap-6", "seed-8", "raw", "cap-1", "cap-2", "cap-3", "cap-5",
         "edges", "edges-cap-5"])
def test_plain_automaton_matches_bwt_tpu(env, mix, cap, seed_k,  # noqa: F811
                                         resolve, reads, width, width1):
    """Every output of the plain automaton equals _align_automaton's on the
    same bank: at caps of 6 iterations (bwt_tpu's _TEST_CAP route) and of
    1, 2, 3 and 5 (inside a tile's round), from a k = 8 seed table, without
    N resolution (on the reads without N's), and on the schedule's edge
    reads (a curgap accepted at g = 9, nine rejected and a RESET, a strand
    retry after an exhausted hunt, each seen in the events); at tile widths
    1, 2, 4 and 8, whose iteration counts equal width 1's.  The card holds
    K10 to the plain version at k = 12."""
    g, jfmi, tfmi = env
    edges = reads == "edges"
    reads = (_edges(g, 9) if edges else
             mix if resolve else [r for r in mix if not (r == 5).any()])
    jsvc, tsvc, lens, live0 = _banks(env, reads)
    jseed = jbatch._seed_for(jfmi, seed_k).rows if seed_k else None
    tseed = tbatch._seed_for(tfmi, seed_k).rows if seed_k else None
    kw = dict(anchor_len=12, resolve=resolve, cap_steps=cap, seed_k=seed_k)
    jout = jaligner._align_automaton(
        jfmi, jsvc.bank, jnp.asarray(lens), jnp.asarray(live0),
        jnp.int32(len(g)), jseed, **kw)
    events = []

    def on_round(fields, cols, ev):
        ext = fields[0] == service.OP_MEXT
        events.append((fields[5][ext], ev[ext], ev))

    args = (tfmi, tsvc.bank8, torch.from_numpy(lens), torch.from_numpy(live0),
            len(g), tseed)
    got = au.align_automaton_plain(*args, width=width, on_round=on_round,
                                   **kw)
    for name, want in zip(_OUTS, jout):
        assert np.array_equal(got[name].numpy(),
                              np.asarray(want).astype(np.int64)), name
    assert (int(got["capped"].sum()) > 0) == (cap > 0)
    assert int(got["iters"].max()) == int(np.asarray(jout[11])[0])
    key = (edges, cap, seed_k, resolve)
    if key not in width1:
        width1[key] = (got["iters"] if width == 1 else
                        au.align_automaton_plain(*args, **kw)["iters"])
    assert torch.equal(got["iters"], width1[key])
    if edges and cap == 0:
        flags = torch.cat([e for *_, e in events])
        assert any(bool(((gq == 9) & ((e & 7) == au.EV_EXT_ACCEPT)).any())
                   for gq, e, _ in events)
        assert bool(((flags & au.EV_RESET) != 0).any())
        assert bool(((flags & au.EV_RETRY) != 0).any())
        assert bool((flags == au.EV_SPEC).any()) == (width > 1)


@pytest.mark.parametrize("width", [1, 2, 4, 8])
@pytest.mark.parametrize("where", ["first", "retry"])
def test_automaton_walk_past_the_sa_raises(where, width):
    """On a np.zeros genome a read ending in C starts the anchor's walk from
    a row past the suffix array: the plain automaton raises as the walk
    does, naming the row of the first such read, at every tile width, and
    so does the packed wrapper on a CPU index.  On the first attempt, and
    on a retry:
    A*36 C AAA misses first (AAA, a real row), then overruns at ln = 37
    (ending in C).  From width 2 on the round that overruns also issues
    the later retries (misses, the last one exhausting the hunt, a stop):
    the earlier overrun wins."""
    from bwt_tpu_torch import build_index

    tfmi = build_index(np.zeros(64, np.uint8), sa_sample_rate=4,
                       device="cpu")
    svc = tbatch.QueryService(tfmi, np.zeros(64, np.uint8))
    last = (np.array([0] * 19 + [1], np.uint8) if where == "first" else
            np.array([0] * 36 + [1] + [0] * 3, np.uint8))
    svc.add_reads_batch([np.zeros(20, np.uint8), last], with_revcomp=True)
    Bp = svc.bank8.shape[0] // 2
    lens = torch.zeros(Bp, dtype=torch.int32)
    lens[:2] = torch.tensor([20, len(last)])
    live0 = torch.arange(Bp) < 2
    events = []
    for fn, kw in ((au.align_automaton_plain, dict(
            width=width, on_round=lambda f, c, e: events.append(e))),
                   (au.align_automaton_packed, {})):
        with pytest.raises(RuntimeError, match="row 65 did not reach"):
            fn(tfmi, svc.bank8, lens, live0, 64, anchor_len=12,
               resolve=False, **kw)
    assert bool((torch.cat(events) == au.EV_SPEC).any()) == (width > 1)


@pytest.mark.parametrize("engine", ["device", "auto"])
def test_device_engine_matches_bwt_tpu(env, mix, jax_results,  # noqa: F811
                                       engine):
    """align_reads on the device engine equals bwt_tpu's device and host
    engines on every read, and the reference-format text; a CPU index
    launches no kernel."""
    g, _, tfmi = env
    jdev, jhost = jax_results
    assert _norm(jdev) == _norm(jhost)
    svc = tbatch.QueryService(tfmi, g)
    before = (au.ALIGN_LAUNCHES, dpw.LOG_STITCH_LAUNCHES,
              cmp.COMPOSE_LAUNCHES, service.SERVICE_LAUNCHES,
              dpw.STITCH_LAUNCHES)
    got = taligner.align_reads(tfmi, g, mix, engine=engine, service=svc,
                               with_strand=True)
    assert (au.ALIGN_LAUNCHES, dpw.LOG_STITCH_LAUNCHES, cmp.COMPOSE_LAUNCHES,
            service.SERVICE_LAUNCHES, dpw.STITCH_LAUNCHES) == before
    assert _norm(got) == _norm(jdev)
    assert (taligner.format_ref_output(got)
            == jaligner.format_ref_output([(p, c) for p, c, _ in jdev]))
    stats = svc.last_stats
    assert stats["chunks"] == 1 and stats["buckets"] >= 1
    assert stats["fallback"] >= 2  # the overflowing logs
    assert sum(1 for p, _, _ in got if p) > len(mix) // 2
    assert any(s for p, _, s in got if p)  # reverse-strand hits
    # a code matrix of equal-length reads takes the same path
    sub = [r for r in mix if len(r) == 80][:16]
    mat = taligner.align_reads(tfmi, g, np.stack(sub), with_strand=True)
    assert _norm(mat) == _norm([got[k] for k, r in enumerate(mix)
                                if len(r) == 80][:16])


def test_redo_and_forced_cap_match(env, mix, jax_results,  # noqa: F811
                                   monkeypatch):
    """With the compose's width at 1 run every multi-run read is
    re-composed on the host from its log (the redo path); with the cap at 4
    iterations the capped reads re-run on the host engine.  The results do
    not change."""
    g, _, tfmi = env
    want = _norm(jax_results[0])
    monkeypatch.setattr(taligner, "_RUNS_K", 1)
    svc = tbatch.QueryService(tfmi, g)
    assert _norm(taligner.align_reads(tfmi, g, mix, service=svc,
                                      with_strand=True)) == want
    assert svc.last_stats["redo"] > 10
    monkeypatch.setattr(taligner, "_RUNS_K", cmp.RUNS_K)
    monkeypatch.setattr(taligner, "_TEST_CAP", 4)
    svc = tbatch.QueryService(tfmi, g)
    assert _norm(taligner.align_reads(tfmi, g, mix, service=svc,
                                      with_strand=True)) == want
    assert svc.last_stats["capped"] > 10
    assert svc.last_stats["fallback"] >= svc.last_stats["capped"]


def test_chunk_pipeline_matches(env, mix, jax_results):  # noqa: F811
    """search_batch 64: two chunks, each with its own service, in order."""
    g, _, tfmi = env
    svc = tbatch.QueryService(tfmi, g, TConfig(search_batch=64))
    got = taligner.align_reads(tfmi, g, mix, service=svc, with_strand=True)
    assert _norm(got) == _norm(jax_results[0])
    assert svc.last_stats["chunks"] == -(-len(mix) // 64)


def test_engine_selection(env, monkeypatch):  # noqa: F811
    """"auto" takes the device engine on an index with isa_samples and
    reads of at most 32,767 bases, the host engine past that or without
    isa_samples; "device" raises past it, as in bwt_tpu."""
    g, jfmi, tfmi = env
    took = []
    monkeypatch.setattr(taligner, "_align_reads_device",
                        lambda *a: took.append("device") or [])
    monkeypatch.setattr(taligner, "_align_reads_host",
                        lambda *a: took.append("host") or [])
    for n, engine, fmi in ((32767, "auto", tfmi), (32768, "auto", tfmi),
                           (80, "auto", dataclasses.replace(
                               tfmi, isa_samples=None)),
                           (80, "host", tfmi), (32768, "host", tfmi)):
        taligner.align_reads(fmi, g, [np.zeros(n, np.uint8)], engine=engine)
    assert took == ["device", "host", "host", "host", "host"]
    for mod, fmi in ((taligner, tfmi), (jaligner, jfmi)):
        with pytest.raises(ValueError, match="int16 stitch-log width"):
            mod.align_reads(fmi, g, [np.zeros(32768, np.uint8)],
                            engine="device")


def test_align_read_anchored_matches_bwt_tpu(env, mix):  # noqa: F811
    g, jfmi, tfmi = env
    for r in mix[:6] + mix[80:84] + mix[-12:-8]:
        jp, jc = jaligner.align_read_anchored(jfmi, g, r)
        tp, tc = taligner.align_read_anchored(tfmi, g, r)
        assert (tp, tc.render()) == (jp, jc.render())


# -- phase B's units ---------------------------------------------------------


def test_dp_blocks_matches_bwt_tpu():
    """dp_blocks against _dp_blocks_core on random walk rows, both flip
    parities, over-long rows included."""
    from bwt_tpu.models.batch_exec import _dp_blocks_core, _rle_device

    rng = np.random.default_rng(5)
    J, S = 64, 120
    ops = np.full((J, S), 3, np.int8)
    for j in range(J):
        if j % 8 == 0:  # more runs than RLE_R
            ops[j, :S - j // 8] = np.arange(S - j // 8) % 2
            continue
        t = 0
        while t < 40 and rng.random() < 0.95:
            ln = int(rng.integers(1, 6))
            ops[j, t:min(t + ln, 40)] = int(rng.integers(0, 3))
            t += ln
    i_res = rng.integers(0, 3, size=J).astype(np.int32)
    j_res = rng.integers(0, 3, size=J).astype(np.int32)
    flip = np.arange(J) % 2 == 0
    jr = _rle_device(jnp.asarray(ops))
    want = _dp_blocks_core(jnp.zeros(J, jnp.int32), jnp.asarray(i_res),
                           jnp.asarray(j_res), *jr, jnp.asarray(flip))
    tr = dpw._rle_device(torch.from_numpy(ops.astype(np.int32)))
    got = dpw.dp_blocks(torch.zeros(J, dtype=torch.int32),
                        torch.from_numpy(i_res), torch.from_numpy(j_res), *tr,
                        torch.from_numpy(flip))
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b)), (a, b)
    assert got[3].any() and not got[3].all()  # some rows overflow


def test_log_stitch_and_compose_match_bwt_tpu(env, logs):  # noqa: F811
    """One recorded log through phase B of both packages: the bucket sort
    (on bwt_tpu's 16-granule grid), every bucket's log stitch into the
    accumulators (bwt_tpu's DP through its Pallas kernel in interpret mode,
    whose walk makes a run of each diagonal step, as the port's does), the compose and its packed row, and the same accumulators
    when the buckets are padded to the port's 32 grid or to one wider
    shape: a stitch's result does not depend on its padding."""
    g, jfmi, tfmi = env
    jsvc, tsvc, jout, tout = logs
    mode_d, curpos_d, strand_d, lp_d, ovf_d, kinds_d, roffs_d, rlens_d, \
        glens_d, gstarts_d, capped_d = (jnp.asarray(x) for x in jout[:11])
    Bp = lp_d.shape[0]
    Lb = int(jsvc.bank.shape[1])
    G = jaligner._DP_GRAN
    NL2 = -(-(Lb + 10) // G)
    NB = -(-Lb // G) * NL2
    order_d, counts_d, offs_d = jaligner._job_bucket_sort(
        mode_d, lp_d, ovf_d, kinds_d, rlens_d, glens_d, NB=NB, NL2=NL2)
    v = au.align_unpack(tout)
    old = taligner._DP_GRAN
    try:
        taligner._DP_GRAN = G
        order, counts = taligner._job_bucket_sort(
            v["mode"], v["lp"], v["ovf"], v["kinds"], v["rlens"], v["glens"],
            NB=NB, NL2=NL2)
    finally:
        taligner._DP_GRAN = old
    assert np.array_equal(counts.numpy(), np.asarray(counts_d))
    assert np.array_equal(order.numpy(), np.asarray(order_d))

    W = dpw.BLOCK_W
    zeros = (jnp.zeros((Bp, au.LOGN, W), jnp.int32),
             jnp.zeros((Bp, au.LOGN), jnp.int32), jnp.zeros((Bp,), jnp.int32),
             jnp.zeros((Bp,), jnp.int32))
    acc_j = zeros
    accs = [dpw.log_acc(Bp, "cpu") for _ in range(3)]
    cnt, offs = np.asarray(counts_d), np.asarray(offs_d)
    for b in np.nonzero(cnt)[0]:
        l1, l2 = divmod(int(b), NL2)
        jk, jt = jaligner._bucket_ids(order_d, offs[b], cnt[b], np.int32(Bp),
                                      J=int(jbatch._pow2(int(cnt[b]))))
        acc_j = jaligner._dp_scatter_bucket(
            jsvc.bank, jsvc.genome_dev, strand_d, kinds_d, roffs_d, rlens_d,
            glens_d, gstarts_d, jk, jt, *acc_j, L1=G * (l1 + 1),
            L2=G * (l2 + 1), impl="pallas_interpret")
        tjk, tjt = taligner._bucket_ids(order, int(offs[b]), int(cnt[b]))
        for acc, (L1, L2) in zip(accs, (
                (G * (l1 + 1), G * (l2 + 1)),
                tbatch.dp_shape(G * (l1 + 1), G * (l2 + 1)),
                (G * (l1 + 1) + 40, G * (l2 + 1) + 24))):
            dpw.dp_log_stitch(tout, tsvc.bank, tsvc.genome_dev, tjk, tjt, acc,
                              L1=L1, L2=L2)
    for acc in accs:
        assert torch.equal(acc, accs[0])
    for got, want in zip(dpw.acc_unpack(accs[0]), acc_j):
        assert np.array_equal(got.numpy(), np.asarray(want))

    (fo, fc, nrunm, res, overm, over8, strand8, mode8) = \
        jaligner._compose_device(kinds_d, glens_d, lp_d, mode_d, curpos_d,
                                 acc_j[2], acc_j[0], acc_j[1], strand_d,
                                 acc_j[3], K=cmp.RUNS_K)
    runs_oc, bl3, head_end, _ = dpw.acc_unpack(accs[0])
    got = cmp.compose_runs_plain(v["kinds"], v["glens"], v["lp"], v["mode"],
                                 v["curpos"], head_end, runs_oc, bl3,
                                 K=cmp.RUNS_K)
    for a, b in zip(got, (fo, fc, nrunm, res, overm)):
        assert np.array_equal(a.numpy().astype(np.int64),
                              np.asarray(b).astype(np.int64))
    lens_d = jnp.asarray(np.pad(jsvc.read_lengths(),
                                (0, Bp - len(jsvc.read_lengths()))))
    (res_j, meta, nm1, *_), (fo_packed, fc8) = jaligner._pack_fetch(
        fo, fc, nrunm, res, overm, over8, strand8, mode8, ovf_d, capped_d,
        lens_d)
    rows = cmp.compose(tout, accs[0])
    assert np.array_equal(rows[:, 0].numpy(), np.asarray(res_j))
    assert np.array_equal(rows[:, 1].numpy(), np.asarray(meta))
    assert np.array_equal(rows[:, 2].numpy(), np.asarray(nm1) & 0x7F)
    assert np.array_equal(rows[:, 3].numpy().view(np.uint32),
                          np.asarray(fo_packed))
    assert np.array_equal(rows[:, 4:].numpy(), np.asarray(fc8))


@pytest.mark.parametrize("L1,L2", [(32, 32), (32, 64), (64, 64)])
def test_log_stitch_edge_jobs_match_bwt_tpu(L1, L2):
    """The plain log stitch against bwt_tpu's _dp_scatter_bucket (its Pallas
    kernel in interpret mode) on chip_smoke.log_edge_jobs: rlen 0, glen < 0
    and 0, rlen = L1 (the last row), clamped slices, more runs than kept
    (``over``), the longest block (runs + 1: a walk ends on row or column
    0, so never both residuals), two head stitches on one read; and the same
    accumulators with the jobs in another order."""
    import chip_smoke

    log, bank, genome, jk, jt = chip_smoke.log_edge_jobs(
        np.random.default_rng(L1 + L2))
    Bp = au.align_lanes(log)
    v = au.align_unpack(log)
    acc = dpw.log_acc(Bp, "cpu")
    dpw.dp_log_stitch(log, bank, genome, jk, jt, acc, L1=L1, L2=L2)
    W = dpw.BLOCK_W
    want = jaligner._dp_scatter_bucket(
        jnp.asarray(bank.numpy()), jnp.asarray(genome.numpy()),
        *(jnp.asarray(v[c].numpy()) for c in ("strand", "kinds", "roffs",
                                              "rlens", "glens", "gstarts")),
        jnp.asarray(jk.numpy()), jnp.asarray(jt.numpy()),
        jnp.zeros((Bp, au.LOGN, W), jnp.int32),
        jnp.zeros((Bp, au.LOGN), jnp.int32), jnp.zeros((Bp,), jnp.int32),
        jnp.zeros((Bp,), jnp.int32), L1=L1, L2=L2, impl="pallas_interpret")
    for got, w in zip(dpw.acc_unpack(acc), want):
        assert np.array_equal(got.numpy(), np.asarray(w))
    runs_oc, bl3, head_end, over = dpw.acc_unpack(acc)
    bl = bl3[jk.long(), jt.long()]
    assert int(bl.max()) == dpw.RLE_R + 1 or L1 == 32 and L2 == 32
    assert bool(over.any()) or L2 == 32
    assert int((bl == 0).sum()) > 0  # rlen 0 and glen 0 jobs: empty blocks
    perm = torch.from_numpy(np.random.default_rng(1).permutation(len(jk)))
    again = dpw.log_acc(Bp, "cpu")
    dpw.dp_log_stitch(log, bank, genome, jk[perm].contiguous(),
                      jt[perm].contiguous(), again, L1=L1, L2=L2)
    assert torch.equal(again, acc)


def test_host_compose_matches_bwt_tpu(env, logs):  # noqa: F811
    """_assemble_logs (the redo path's compose) of both packages on the
    recorded log, over the reads' own lanes and over a subset named by
    ``lanes``."""
    jsvc, tsvc, jout, tout = logs
    n = len(tsvc.read_lengths())
    v = {k: x.numpy() for k, x in au.align_unpack(tout).items()}
    args = [v[c] for c in ("mode", "curpos", "strand", "lp", "ovf", "kinds",
                           "roffs", "rlens", "glens", "gstarts")]
    want = jaligner._assemble_logs(jsvc, n, *jout[:10], jout[10])
    got = taligner._assemble_logs(tsvc, n, *args, v["capped"])
    assert _norm(r for r in got[0] if r) == _norm(r for r in want[0] if r)
    assert got[1] == want[1] and len(got[1]) >= 2
    sel = np.arange(1, n, 3)
    sub = [a[sel] for a in args]
    want = jaligner._assemble_logs(jsvc, len(sel), *(a[sel] for a in jout[:10]),
                                   lanes=sel)
    got = taligner._assemble_logs(tsvc, len(sel), *sub, lanes=sel)
    assert _norm(r for r in got[0] if r) == _norm(r for r in want[0] if r)
    assert got[1] == want[1]


def _compose_case(build):
    """test_fused_assemble.py's hand-made compose inputs through
    _compose_device and compose_runs_plain."""
    n, W = build["n"], dpw.BLOCK_W
    kinds = np.zeros((n, au.LOGN), np.int32)
    glens = np.zeros((n, au.LOGN), np.int32)
    lp = np.zeros(n, np.int32)
    runs_o = np.zeros((n, au.LOGN, W), np.int32)
    runs_c = np.zeros((n, au.LOGN, W), np.int32)
    bl3 = np.zeros((n, au.LOGN), np.int32)
    build["fill"](kinds, glens, lp, runs_o, runs_c, bl3)
    mode, curpos, head_end = (np.asarray(build[k], np.int32)
                              for k in ("mode", "curpos", "head_end"))
    runs_oc = ((runs_o + 2) << 24) | runs_c
    want = jaligner._compose_device(
        jnp.asarray(kinds.astype(np.int8)), jnp.asarray(glens.astype(np.int16)),
        jnp.asarray(lp), jnp.asarray(mode), jnp.asarray(curpos),
        jnp.asarray(head_end), jnp.asarray(runs_oc), jnp.asarray(bl3))
    got = cmp.compose_runs_plain(*(torch.from_numpy(x) for x in (
        kinds, glens, lp, mode, curpos, head_end, runs_oc, bl3)))
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy().astype(np.int64),
                              np.asarray(b).astype(np.int64))
    return [x.numpy() for x in got]


def _merge_case(kinds, glens, lp, runs_o, runs_c, bl3):
    # lane 0: NW block [M2, I1]; M 5; I 0 -> M2 I1 M5 I0 (0-count kept)
    kinds[0, :3] = [au.K_NW, au.K_M, au.K_I]
    runs_o[0, 0, :2] = [0, 1]
    runs_c[0, 0, :2] = [2, 1]
    bl3[0, 0] = 2
    glens[0, 1:3] = [5, 0]
    lp[0] = 3
    # lane 1: M 3; M 4 -> M 7
    kinds[1, :2] = [au.K_M, au.K_M]
    glens[1, :2] = [3, 4]
    lp[1] = 2
    # lane 3: a 3-run block and 15 alternating M / I entries: 18 runs
    kinds[3, 0] = au.K_NW
    runs_o[3, 0, :3] = [1, 2, 1]
    runs_c[3, 0, :3] = [1, 1, 1]
    bl3[3, 0] = 3
    kinds[3, 1:] = ([au.K_M, au.K_I] * au.LOGN)[:au.LOGN - 1]
    glens[3] = 1
    lp[3] = au.LOGN


def _count_case(kinds, glens, lp, runs_o, runs_c, bl3):
    # lane 0: M 20000; M 15000 -> 35000 > 32767: overflow
    kinds[0, :2] = [au.K_M, au.K_M]
    glens[0, :2] = [20000, 15000]
    lp[0] = 2
    # lane 1: a block M 30000; M 2000 -> 32000, exact
    kinds[1, :2] = [au.K_NW, au.K_M]
    runs_c[1, 0, 0] = 30000
    bl3[1, 0] = 1
    glens[1, 1] = 2000
    lp[1] = 2


def test_compose_merge_and_count_overflow():
    """The compose's merge (singletons and blocks in log order, count-0
    runs kept, past RUNS_K runs the overflow flag) and its count overflow
    (a merged count past int16 flags, one at 32,000 stays), against
    _compose_device on test_fused_assemble.py's cases."""
    fo, fc, nr, res, over = _compose_case(dict(
        n=4, fill=_merge_case, mode=[1, 1, 2, 1], curpos=[100, 50, 7, 900],
        head_end=[10, 0, 0, 0]))
    assert res.tolist() == [90, 50, 7, 900]
    assert fo[0, :4].tolist() == [0, 1, 0, 1] and fc[0, :4].tolist() == [
        2, 1, 5, 0]
    assert nr[1] == 1 and fc[1, 0] == 7 and nr[2] == 0
    assert over[3] and nr[3] == cmp.RUNS_K + 1
    fo, fc, nr, res, over = _compose_case(dict(
        n=2, fill=_count_case, mode=[1, 1], curpos=[500, 500],
        head_end=[0, 0]))
    assert over[0] and not over[1] and nr[1] == 1 and fc[1, 0] == 32000


@pytest.mark.parametrize("Bp", [1, 33, 300])
def test_compose_edge_rows_match_bwt_tpu(Bp):
    """compose_runs_plain against _compose_device on chip_smoke's
    compose_edge_rows: log pointers past the 16 slots, every kind, blocks
    longer than BLOCK_W and streams past F2, counts past 254 and int16,
    more runs than K and than 8; and the packed rows' fields from them."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from chip_smoke import compose_edge_rows

    log, acc = compose_edge_rows(np.random.default_rng(Bp), Bp)
    v = au.align_unpack(log)
    runs_oc, bl3, head_end, over_rle = dpw.acc_unpack(acc)
    want = jaligner._compose_device(
        jnp.asarray(v["kinds"].numpy().astype(np.int8)),
        jnp.asarray(v["glens"].numpy().astype(np.int16)),
        jnp.asarray(v["lp"].numpy()), jnp.asarray(v["mode"].numpy()),
        jnp.asarray(v["curpos"].numpy()), jnp.asarray(head_end.numpy()),
        jnp.asarray(runs_oc.numpy()), jnp.asarray(bl3.numpy()))
    got = cmp.compose_runs_plain(v["kinds"], v["glens"], v["lp"], v["mode"],
                                 v["curpos"], head_end, runs_oc, bl3)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy().astype(np.int64),
                              np.asarray(b).astype(np.int64))
    fo, fc, nrun, res, over = got
    rows = cmp.compose(log, acc)
    assert torch.equal(rows[:, 0], res) and torch.equal(rows[:, 2], nrun)
    assert torch.equal((rows[:, 1] >> 4) & 1, over.to(torch.int32))
    assert torch.equal(rows[:, 4:], fc[:, :8].clamp(0, 255))
    if Bp > 1:  # the edges are reached
        assert bool(over.any()) and bool((nrun > 8).any())
        assert bool(((rows[:, 1] >> 7) & 1).any())
