"""The port's rna_seq host engine against bwt_tpu's, on the CPU: the same
reads through ``bwt_tpu.models.rnaseq.rna_seq(engine="host")`` and
``bwt_tpu_torch.models.rnaseq.rna_seq(engine="host")``, values equal.
Reads with an N are held to bwt_tpu's host engine too (the C binary is
undefined there).  The device automaton: tests/test_torch_automaton.py."""

import dataclasses

import numpy as np
import pytest

import bwt_tpu
from bwt_tpu.config import Config as JConfig
from bwt_tpu.models import rnaseq as jrnaseq

from bwt_tpu_torch.config import Config as TConfig
from bwt_tpu_torch.models import rnaseq as trnaseq
from bwt_tpu_torch.models.batch_exec import QueryService
from bwt_tpu_torch.ops import service

from test_torch_index import to_port


def _mutated(g, rng, n, length=50, nmut=1):
    """Reads cut from the genome with ``nmut`` substitutions each (the
    self-benchmark's recipe, rnaseqtest.c:313-327)."""
    starts = rng.integers(0, len(g) - length, size=n)
    reads = g[starts[:, None] + np.arange(length)].copy()
    for _ in range(nmut):
        at = rng.integers(0, length, size=n)
        reads[np.arange(n), at] ^= rng.integers(1, 4, size=n).astype(np.uint8)
    return starts, [r for r in reads]


@pytest.fixture(scope="module")
def env():
    rng = np.random.default_rng(11)
    g = rng.integers(0, 4, 20000).astype(np.uint8)
    jfmi = bwt_tpu.build_index(g)
    return g, jfmi, to_port(jfmi), rng


def _both(jfmi, tfmi, reads, **cfg):
    want = jrnaseq.rna_seq(jfmi, reads, engine="host",
                           config=JConfig(**cfg))
    before = service.SERVICE_LAUNCHES
    got = trnaseq.rna_seq(tfmi, reads, engine="host", config=TConfig(**cfg))
    assert service.SERVICE_LAUNCHES == before  # a CPU index launches nothing
    assert got.dtype == np.int32 and np.array_equal(got, np.asarray(want))
    return got


@pytest.mark.parametrize("isa", [True, False], ids=["isa", "no-isa"])
@pytest.mark.parametrize("spec", [1, 24])
def test_rna_seq_matches_bwt_tpu_host(env, isa, spec):
    """Mutated 50-mers (one and three substitutions, and some unmutated),
    through the fused bsearch_ext path and, without isa_samples, the
    unc_sa_range chunk scan."""
    g, jfmi, tfmi, _ = env
    rng = np.random.default_rng(spec)
    starts, reads = _mutated(g, rng, 48)
    _, more = _mutated(g, rng, 24, nmut=3)
    reads = reads + more + [g[100:150], g[7000:7050]]
    if not isa:
        jfmi = dataclasses.replace(jfmi, isa_samples=None)
        tfmi = dataclasses.replace(tfmi, isa_samples=None)
    got = _both(jfmi, tfmi, reads, rnaseq_spec_depth=spec)
    assert got[-2] == 100 and got[-1] == 7000
    # a read whose substitution lies before its last 14 bases anchors there
    assert (got[:48] >= 0).sum() > 24


def test_rna_seq_short_and_odd_reads(env):
    """Reads shorter than the cutoffs, of the cutoffs' lengths, long reads
    and strings."""
    g, jfmi, tfmi, rng = env
    reads = [g[s:s + ln] for s, ln in zip(rng.integers(0, 19000, 40),
                                          [1, 2, 9, 10, 13, 14, 15, 18, 19, 20,
                                           22, 30, 75, 100, 150, 200] * 3)]
    reads += ["ACGTACGTACGTACGTACGTAC", "A", "TTTTTTTTTTTTTTTTTTTTTTTTT"]
    _both(jfmi, tfmi, reads)


def test_rna_seq_repetitive_genome():
    rng = np.random.default_rng(5)
    unit = rng.integers(0, 4, 37).astype(np.uint8)
    g = np.tile(unit, 60)
    jfmi = bwt_tpu.build_index(g, sa_sample_rate=8)
    tfmi = to_port(jfmi)
    _, reads = _mutated(g, rng, 32)
    _both(jfmi, tfmi, reads + [g[:50], g[5:90]])


def test_rna_seq_reads_with_n(env):
    g, jfmi, tfmi, rng = env
    _, reads = _mutated(g, rng, 24)
    for k, r in enumerate(reads):
        r[rng.integers(0, len(r))] = 5
        if k % 3 == 0:
            r[rng.integers(0, 20)] = 5
        if k % 8 == 0:
            r[-1] = 5  # a trailing N
    _both(jfmi, tfmi, reads)


def test_rna_seq_cutoffs_and_service_reuse(env):
    """Other cutoffs (one past the fused window's 32 positions, which
    takes the chunk scan with isa_samples present), and a service carried
    across calls."""
    g, jfmi, tfmi, rng = env
    _, reads = _mutated(g, rng, 32, length=80)
    _both(jfmi, tfmi, reads, rnaseq_anchor_cutoff=18, rnaseq_cont_cutoff=8)
    _both(jfmi, tfmi, reads, rnaseq_cont_cutoff=27)
    svc = QueryService(tfmi)
    a = trnaseq.rna_seq(tfmi, reads, service=svc, engine="host")
    b = trnaseq.rna_seq(tfmi, reads[:8], service=svc, engine="host")
    assert np.array_equal(a[:8], b)
    assert svc.last_stats["svc_calls"] > 0
    assert svc.last_stats["svc_launches"] == 0
    # "auto" takes the device automaton on this index: its own counters
    c = trnaseq.rna_seq(tfmi, reads[:8], service=svc)
    assert np.array_equal(c, b)
    assert svc.last_stats["chunks"] == 1
    assert svc.last_stats["automaton_launches"] == 0


def test_unported_engines_raise(env):
    """The device engine needs isa_samples, as in bwt_tpu;
    config.elastic_fallback is accepted and, without a device failure,
    changes no result (tests/test_torch_elastic.py drives the
    recovery)."""
    g, _, tfmi, _ = env
    with pytest.raises(ValueError, match="isa_samples"):
        trnaseq.rna_seq(dataclasses.replace(tfmi, isa_samples=None),
                        [g[:50]], engine="device")
    with pytest.raises(ValueError, match="unknown engine"):
        trnaseq.rna_seq(tfmi, [g[:50]], engine="tpu")
    reads = [g[:50], g[700:750]]
    for engine in ("device", "host"):
        got = trnaseq.rna_seq(tfmi, reads, engine=engine,
                              config=TConfig(elastic_fallback=True))
        assert np.array_equal(got, trnaseq.rna_seq(tfmi, reads,
                                                   engine=engine))


def _norm(x):
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def test_executor_replies_match_bwt_tpu(env):
    """Every request of the protocol that the service answers, alone and
    inside a "par", through both executors: the replies are equal, keys,
    types and values."""
    from bwt_tpu.models.batch_exec import BatchExecutor as JExecutor
    from bwt_tpu.models.batch_exec import QueryService as JService
    from bwt_tpu_torch.models.batch_exec import BatchExecutor as TExecutor

    g, jfmi, tfmi, _ = env
    reads = [g[300:350].copy(), g[900:960].copy()]
    reads[0][20] ^= 1
    reads[1][[5, 59]] = 5

    def gen(row, ln, origin):
        reqs = [("mms", row, 0, ln), ("mms_ext", row, 0, ln - 3, origin + ln, 2),
                ("mms_continue", row, 0, 10, 5, 900),
                ("mms_continue_full", row, 0, 10, 7, 7),
                ("bsearch", row, 4, ln - 4),
                ("bsearch_ext", row, 30, 15, origin + 20, 24),
                ("unc_sa", 77), ("crank", 2, 500), ("unc_sa_range", 10, 14),
                ("isa_range", origin, origin + 9)]
        out = []
        for r in reqs:
            out.append((yield r))
        out.append((yield ("par", reqs)))
        return out

    def run(executor, service):
        rows = [service.add_read(r) for r in reads]
        return executor(service).run(
            [gen(rows[0], 50, 300), gen(rows[1], 60, 900)])

    want = _norm(run(JExecutor, JService(jfmi)))
    got = _norm(run(TExecutor, QueryService(tfmi)))
    assert got == want
    for a, b in zip(got[0], want[0]):
        if isinstance(a, dict):
            assert list(a) and {k: type(v) for k, v in a.items()} == {
                k: type(v) for k, v in b.items()}
    assert got[0][5]["wrow"] >= 0  # the window scan found the origin's row
