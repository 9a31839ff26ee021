"""The PyTorch port's single_align path held against bwt_tpu (CPU).

``align_reads(..., engine="host")`` of both packages on the same index
and reads (mutated, reverse-complement, N-bearing, junk and tiny
reads), with bwt_tpu's DP stitches through its Pallas kernel in
interpret mode; positions, CIGARs, strands and the reference-format
text must be equal.  Also align_read (the mms_mismatch driver) and the
port's CLI."""

import dataclasses

import numpy as np
import pytest

import bwt_tpu
from bwt_tpu import codec as jcodec
from bwt_tpu import io as jio
from bwt_tpu.models import aligner as jaligner
from bwt_tpu.models.batch_exec import QueryService as JQueryService

import bwt_tpu_torch
from bwt_tpu_torch import cli as tcli
from bwt_tpu_torch.models import aligner as taligner
from bwt_tpu_torch.ops import dp_wavefront

from test_models import make_reads
from test_torch_index import to_port

GLEN = 20000


@pytest.fixture(scope="module")
def env():
    g = jcodec.random_genome(GLEN, seed=99)
    return g, bwt_tpu.build_index(g)


def _reads(g, seed, n):
    rng = np.random.default_rng(seed)
    reads = make_reads(rng, g, n)
    for ln in (1, 4, 5, 11, 12, 13, 15):
        j = int(rng.integers(0, len(g) - ln))
        reads.append(g[j:j + ln])
    return reads


def _norm(results):
    return [(p, c.render() if c else None, s) for p, c, s in results]


@pytest.mark.parametrize("isa", [True, False], ids=["isa", "no-isa"])
def test_align_reads_matches_bwt_tpu_host(env, isa):
    g, jfmi = env
    if not isa:
        jfmi = dataclasses.replace(jfmi, isa_samples=None)
    reads = _reads(g, 5 if isa else 6, 40)
    svc = JQueryService(jfmi, jcodec.encode_genome(g))
    svc.dp_impl = "pallas_interpret"
    want = jaligner.align_reads(jfmi, g, reads, engine="host",
                                with_strand=True, service=svc)
    tfmi = to_port(jfmi)
    assert (tfmi.isa_samples is not None) == isa
    launches = dp_wavefront.LAUNCHES
    got = taligner.align_reads(tfmi, g, reads, engine="host",
                               with_strand=True)
    assert dp_wavefront.LAUNCHES == launches  # the CPU never launches
    assert _norm(got) == _norm(want)
    assert sum(1 for p, _, _ in want if p) > len(reads) // 2
    assert any(s for p, _, s in want if p)  # some reverse-strand hits
    assert (taligner.format_ref_output(got)
            == jaligner.format_ref_output([(p, c) for p, c, _ in want]))
    # "auto": the device engine with isa_samples, else the host engine
    auto = taligner.align_reads(tfmi, g, reads[:8], with_strand=True)
    assert _norm(auto) == _norm(got[:8])


def test_align_read_matches_bwt_tpu(env):
    g, jfmi = env
    rng = np.random.default_rng(7)
    reads = [r.replace("N", "A")
             for r in make_reads(rng, g, 12, revcomp_frac=0.0, junk_frac=0.1)]
    tfmi = to_port(jfmi)
    assert ([taligner.align_read(tfmi, g, r) for r in reads]
            == [jaligner.align_read(jfmi, g, r) for r in reads])


def test_unported_engines_raise(env):
    """elastic_fallback is not ported and raises; the device engine is,
    and runs."""
    g, jfmi = env
    tfmi = to_port(jfmi)
    reads = ["ACGT", g[100:180]]
    got = taligner.align_reads(tfmi, g, reads, engine="device",
                               with_strand=True)
    assert _norm(got) == _norm(taligner.align_reads(
        tfmi, g, reads, engine="host", with_strand=True))
    assert got[1][0] == 101
    cfg = dataclasses.replace(bwt_tpu_torch.DEFAULT_CONFIG,
                              elastic_fallback=True)
    with pytest.raises(NotImplementedError):
        taligner.align_reads(tfmi, g, ["ACGT"], config=cfg)
    with pytest.raises(ValueError):
        taligner.align_reads(tfmi, g, ["ACGT"], engine="gpu")


def test_cli_build_index_and_single_align(env, tmp_path, capsys):
    g, jfmi = env
    reads = _reads(g, 8, 12)
    seq, idx, rf = tmp_path / "g.txt", tmp_path / "g.idx", tmp_path / "r.txt"
    seq.write_text(g + "\n")
    rf.write_text("\n".join(reads) + "\n")
    assert tcli.main(["--platform", "cpu", "build_index", str(seq),
                      str(idx)]) == 0
    jio.write_ref_index(jfmi, tmp_path / "j.idx")
    assert idx.read_bytes() == (tmp_path / "j.idx").read_bytes()
    assert "Built index: 20000 bases in" in capsys.readouterr().err
    assert tcli.main(["--platform", "cpu", "single_align", str(seq),
                      str(idx), str(rf)]) == 0
    out = capsys.readouterr()
    want = jaligner.align_reads(jio.read_ref_index(idx), g, reads)
    assert out.out == jaligner.format_ref_output(want)
    naligned = sum(1 for p, _ in want if p)
    assert out.err == f"{naligned} of {len(reads)} reads aligned\n"
