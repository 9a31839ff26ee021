"""The port's rna_seq device automaton against bwt_tpu's, on the CPU.

``bwt_tpu_torch.models.rnaseq.rna_seq(engine="device")`` (the plain
version of the K9 kernel on a CPU index) against ``bwt_tpu``'s device and
host engines on the same reads, values equal; the plain automaton against
``bwt_tpu.models.rnaseq._rna_seq_automaton`` on the same bank, tolerance
0; and the executor's bulk registration (``add_reads_batch``,
``read_lengths``) and seed cache against ``bwt_tpu``'s ``QueryService``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bwt_tpu
from bwt_tpu.config import Config as JConfig
from bwt_tpu.models import batch_exec as jbatch
from bwt_tpu.models import rnaseq as jrnaseq

from bwt_tpu_torch.config import Config as TConfig
from bwt_tpu_torch.models import batch_exec as tbatch
from bwt_tpu_torch.models import rnaseq as trnaseq
from bwt_tpu_torch.ops import automaton, service

from test_torch_index import to_port


@pytest.fixture(scope="module")
def env():
    rng = np.random.default_rng(23)
    g = rng.integers(0, 4, 20000).astype(np.uint8)
    jfmi = bwt_tpu.build_index(g, sa_sample_rate=8)
    return g, jfmi, to_port(jfmi)


def _mix(g, seed, n_n=16):
    """The mix of bwt_tpu's device-vs-host test: 50-mers with 0 to 4
    substitutions, random reads whose anchor hunt runs out, reads of the
    lengths around the cutoffs, and reads with N's (inner ones, a trailing
    one): the resolve path."""
    rng = np.random.default_rng(seed)
    reads = []
    for _ in range(100):
        j = int(rng.integers(0, len(g) - 55))
        r = g[j:j + 50].copy()
        for _ in range(int(rng.integers(0, 5))):
            r[int(rng.integers(0, 50))] = rng.integers(0, 4)
        reads.append(r)
    reads += [rng.integers(0, 4, 50).astype(np.uint8) for _ in range(24)]
    for ln in (1, 5, 13, 14, 15, 18, 19, 21, 22, 25):
        j = int(rng.integers(0, len(g) - ln))
        reads.append(g[j:j + ln].copy())
    for k in range(n_n):
        j = int(rng.integers(0, len(g) - 50))
        r = g[j:j + 50].copy()
        r[int(rng.integers(0, 50))] = 5
        if k % 4 == 0:
            r[-1] = 5
        reads.append(r)
    return reads


@pytest.fixture(scope="module")
def mix(env):
    g = env[0]
    return {"default": (_mix(g, 1), {}),
            "cutoffs-18-8": (_mix(g, 2), dict(rnaseq_anchor_cutoff=18,
                                              rnaseq_cont_cutoff=8))}


@pytest.fixture(scope="module")
def jax_results(env, mix):
    """bwt_tpu's two engines on each mix, once for the module."""
    _, jfmi, _ = env
    out = {}
    for name, (reads, cfg) in mix.items():
        out[name] = tuple(
            np.asarray(jrnaseq.rna_seq(jfmi, reads, engine=eng,
                                       config=JConfig(**cfg)))
            for eng in ("device", "host"))
    return out


@pytest.mark.parametrize("case", ["default", "cutoffs-18-8"])
def test_device_engine_matches_bwt_tpu(env, mix, jax_results, case):
    _, _, tfmi = env
    reads, cfg = mix[case]
    jdev, jhost = jax_results[case]
    assert np.array_equal(jdev, jhost)
    svc = tbatch.QueryService(tfmi, config=TConfig(**cfg))
    before = automaton.AUTOMATON_LAUNCHES, service.SERVICE_LAUNCHES
    got = trnaseq.rna_seq(tfmi, reads, engine="device", service=svc)
    # a CPU index runs the plain version: no launch
    assert (automaton.AUTOMATON_LAUNCHES, service.SERVICE_LAUNCHES) == before
    assert got.dtype == np.int32 and np.array_equal(got, jdev)
    stats = svc.last_stats
    assert stats["chunks"] == 1 and stats["capped"] == 0
    assert stats["automaton_launches"] == 0
    # hunt-exhausting reads take tens of iterations, under the cap
    assert 20 < stats["max_iters"] < automaton.default_cap(64)
    assert (got[:100] >= 0).sum() > 50


def test_forced_cap_reruns_on_the_host(env, mix, jax_results, monkeypatch):
    """With the cap at 4 iterations most reads come back capped and re-run
    on the host generators: the values do not change."""
    _, _, tfmi = env
    reads, _ = mix["default"]
    monkeypatch.setattr(trnaseq, "_TEST_CAP", 4)
    svc = tbatch.QueryService(tfmi)
    got = trnaseq.rna_seq(tfmi, reads, engine="device", service=svc)
    assert svc.last_stats["capped"] > 0
    assert svc.last_stats["max_iters"] == 4
    assert np.array_equal(got, jax_results["default"][0])


def _bank(reads, Lb=64):
    R = 1 << (len(reads) - 1).bit_length()
    bank = np.zeros((R, Lb), np.uint8)
    lens = np.zeros(R, np.int32)
    for k, r in enumerate(reads):
        bank[k, :len(r)] = r
        lens[k] = len(r)
    live0 = np.arange(R) < len(reads)
    return bank, lens, live0


@pytest.mark.parametrize("cap,seed_k,resolve", [(4, 0, False), (0, 0, False),
                                                (0, 6, True)])
def test_plain_automaton_matches_bwt_tpu(env, mix, cap, seed_k, resolve):
    """(res, capped) of the plain automaton equal _rna_seq_automaton's on
    the same bank: at a cap of 4 iterations, uncapped, and from a k = 6
    seed table with N resolution."""
    _, jfmi, tfmi = env
    reads = mix["default"][0][:40] + mix["default"][0][-8:]
    bank, lens, live0 = _bank(reads)
    jseed = jbatch._seed_for(jfmi, seed_k).rows if seed_k else None
    tseed = tbatch._seed_for(tfmi, seed_k).rows if seed_k else None
    kw = dict(ac=14, cc=10, resolve=resolve, cap_steps=cap, seed_k=seed_k)
    jres, jcapped = jrnaseq._rna_seq_automaton(
        jfmi, jnp.asarray(bank.astype(np.int32)), jnp.asarray(lens),
        jnp.asarray(live0), jseed, **kw)
    args = (torch.from_numpy(bank), torch.from_numpy(lens),
            torch.from_numpy(live0), tseed)
    res, capped, iters = automaton.rna_seq_automaton_plain(tfmi, *args, **kw)
    assert np.array_equal(res.numpy(), np.asarray(jres))
    assert np.array_equal(capped.numpy(), np.asarray(jcapped).astype(np.int32))
    assert (capped.sum() > 0) == (cap == 4)
    assert int(iters.max()) <= (cap or automaton.default_cap(64))
    assert not iters[len(reads):].any()  # padding rows never run
    # the wrapper on a CPU index: the plain version, packed
    res2, capped2 = automaton.rna_seq_automaton(tfmi, *args, **kw)
    assert torch.equal(res2, res) and torch.equal(capped2, capped)


def test_automaton_walk_past_the_sa_raises():
    """On a repetitive genome a read whose last symbol is absent starts a
    walk past the suffix array: the plain automaton raises as the walk
    does, naming the row."""
    from bwt_tpu_torch import build_index

    tfmi = build_index(np.zeros(64, np.uint8), sa_sample_rate=4,
                       device="cpu")
    bank, lens, live0 = _bank([np.zeros(20, np.uint8),
                               np.array([0] * 19 + [1], np.uint8)])
    with pytest.raises(RuntimeError, match="did not reach a sampled row"):
        automaton.rna_seq_automaton(
            tfmi, torch.from_numpy(bank), torch.from_numpy(lens),
            torch.from_numpy(live0), ac=14, cc=10, resolve=False)


def test_chunk_pipeline_matches_host(env):
    """130 reads in chunks of 40: four chunks, in order, equal to
    bwt_tpu's host engine; "auto" takes the automaton."""
    g, jfmi, tfmi = env
    rng = np.random.default_rng(7)
    reads = []
    for _ in range(130):
        j = int(rng.integers(0, len(g) - 55))
        r = g[j:j + 50].copy()
        r[int(rng.integers(0, 50))] ^= 1
        reads.append(r)
    want = np.asarray(jrnaseq.rna_seq(jfmi, reads, engine="host"))
    svc = tbatch.QueryService(tfmi, config=TConfig(search_batch=40))
    got = trnaseq.rna_seq(tfmi, reads, service=svc)
    assert np.array_equal(got, want)
    assert svc.last_stats["chunks"] == 4
    # a 2-D code matrix takes the same path
    mat = np.stack(reads)
    assert np.array_equal(trnaseq.rna_seq(
        tfmi, mat, engine="device", config=TConfig(search_batch=40)), want)


@pytest.mark.parametrize("why", ["cont-cutoff-27", "no-isa"])
def test_engine_selection(env, why):
    """Where the automaton cannot run, "auto" takes the host engine and
    "device" raises ValueError, as in bwt_tpu."""
    g, jfmi, tfmi = env
    cfg = {}
    if why == "no-isa":
        jfmi = dataclasses.replace(jfmi, isa_samples=None)
        tfmi = dataclasses.replace(tfmi, isa_samples=None)
    else:
        cfg = dict(rnaseq_cont_cutoff=27)
    reads = [g[100:180], g[5000:5060].copy()]
    reads[1][30] ^= 2
    svc = tbatch.QueryService(tfmi, config=TConfig(**cfg))
    got = trnaseq.rna_seq(tfmi, reads, service=svc)
    assert svc.last_stats["svc_calls"] > 0  # the executor's counters
    want = jrnaseq.rna_seq(jfmi, reads, config=JConfig(**cfg))
    assert np.array_equal(got, np.asarray(want))
    with pytest.raises(ValueError, match="rna_seq_device requires"):
        trnaseq.rna_seq(tfmi, reads, engine="device", config=TConfig(**cfg))
    with pytest.raises(ValueError, match="rna_seq_device requires"):
        jrnaseq.rna_seq(jfmi, reads, engine="device", config=JConfig(**cfg))


# -- the executor's bulk registration and seed cache -----------------------


def _services(jfmi, tfmi):
    return jbatch.QueryService(jfmi), tbatch.QueryService(tfmi)


@pytest.mark.parametrize("kind", ["ragged", "uniform-list", "matrix"])
@pytest.mark.parametrize("revcomp", [False, True], ids=["fwd", "revcomp"])
def test_add_reads_batch_matches_bwt_tpu(env, kind, revcomp):
    g, jfmi, tfmi = env
    rng = np.random.default_rng(3)
    if kind == "ragged":
        reads = [g[s:s + n].copy() for s, n in zip(
            rng.integers(0, 19000, 21), rng.integers(0, 90, 21))]
        reads[3][2] = 5
    else:
        reads = [g[s:s + 33].copy() for s in rng.integers(0, 19000, 21)]
        reads[5][7] = 5
        if kind == "matrix":
            reads = np.stack(reads)
    jsvc, tsvc = _services(jfmi, tfmi)
    jbase, jl = jsvc.add_reads_batch(reads, with_revcomp=revcomp)
    tbase, tl = tsvc.add_reads_batch(reads, with_revcomp=revcomp)
    assert tbase == jbase == 0
    assert tl.dtype == np.int32 and np.array_equal(tl, jl)
    want = np.asarray(jsvc.bank)
    assert tsvc.bank8.dtype == torch.uint8
    assert np.array_equal(tsvc.bank8.numpy().astype(np.int32), want)
    assert tsvc.bank.dtype == torch.int32
    assert np.array_equal(tsvc.bank.numpy(), want)
    assert tsvc._has_n == jsvc._has_n
    assert np.array_equal(tsvc.read_lengths(), jsvc.read_lengths())
    assert tsvc._reads._src is not None  # the views are still lazy
    with pytest.raises(ValueError, match="empty bank"):
        tsvc.add_reads_batch(reads)
    with pytest.raises(ValueError, match="empty bank"):
        jsvc.add_reads_batch(reads)
    # add_read after a batch materializes the views and rebuilds the bank
    extra = g[:70].copy()
    assert tsvc.add_read(extra) == jsvc.add_read(extra)
    assert tsvc.bank8 is None
    assert np.array_equal(tsvc.bank.numpy(), np.asarray(jsvc._ensure_bank()))
    assert tsvc.bank8.dtype == torch.uint8
    assert np.array_equal(tsvc.read_lengths(), jsvc.read_lengths())


def test_add_reads_batch_empty_and_reset(env):
    _, jfmi, tfmi = env
    jsvc, tsvc = _services(jfmi, tfmi)
    assert tsvc.add_reads_batch([])[0] == jsvc.add_reads_batch([])[0] == 0
    assert tuple(tsvc.bank8.shape) == tuple(jsvc.bank.shape)
    assert tsvc.read_lengths().shape == (0,)
    tsvc.reset_reads()
    assert tsvc.bank8 is None and len(tsvc._reads) == 0
    assert tsvc.add_reads_batch([np.array([0, 1, 5], np.uint8)])[1].tolist() \
        == [3]
    assert tsvc._has_n


def test_seed_cache_matches_bwt_tpu(env):
    """On the CPU the seed table is built at min(k, 6), as bwt_tpu's is
    off the TPU; the cache gives every service of one index the same
    table, and a fifth entry empties it."""
    _, jfmi, tfmi = env
    a, b = tbatch.QueryService(tfmi), tbatch.QueryService(tfmi)
    assert a.seed.k == 6 and a.seed is b.seed
    assert np.array_equal(a.seed.rows.numpy(),
                          np.asarray(jbatch._seed_for(jfmi, 6).rows))
    assert jbatch.QueryService(jfmi).seed.k == 6
    none = tbatch.QueryService(tfmi, config=TConfig(automaton_seed_k=0))
    assert none.seed is None
    tbatch._SEED_CACHE.clear()
    first = tbatch._seed_for(tfmi, 2)
    assert tbatch._seed_for(tfmi, 2) is first
    for k in (3, 4, 5):
        tbatch._seed_for(tfmi, k)
    assert len(tbatch._SEED_CACHE) == 4
    tbatch._seed_for(tfmi, 1)
    assert len(tbatch._SEED_CACHE) == 1
    assert tbatch._seed_for(tfmi, 2) is not first
