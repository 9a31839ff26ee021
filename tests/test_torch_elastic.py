"""config.elastic_fallback on the port, held to bwt_tpu on the CPU.

The drivers' device runs are made to fail (the engine functions that
tests/test_elastic.py patches in bwt_tpu, or their counterparts in the
port: ``_align_reads_device``, ``rna_seq_device``, the card scan of
``search_reads``, the suffix sort of ``build_index``) with each error
class that ``ops._kernels.device_failure`` accepts.  With the flag set,
each surface prints one line on stderr and re-runs on the CPU, and its
output equals bwt_tpu's on the same inputs, tolerance 0, with the card
refused (``index.default_device`` raises) while the re-run runs.  The
fallback does not widen: without the flag the failure propagates, and
with it a plain RuntimeError, a launch refused for its own arguments, a
bound violation, a failed kernel build and a missing card still
propagate.

The port's CPU path is plain torch, so this runs in process (bwt_tpu's
own test runs in a subprocess for its XLA state); bwt_tpu's wide
(int64) build alone runs in a subprocess, under ``jax_enable_x64``.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bwt_tpu
from bwt_tpu import codec as jcodec
from bwt_tpu.models import aligner as jaligner
from bwt_tpu.models import exact as jexact
from bwt_tpu.models import rnaseq as jrnaseq

import bwt_tpu_torch
from bwt_tpu_torch import index as tindex
from bwt_tpu_torch.models import aligner as taligner
from bwt_tpu_torch.models import exact as texact
from bwt_tpu_torch.models import rnaseq as trnaseq
from bwt_tpu_torch.ops import _kernels
from bwt_tpu_torch.ops import search as tsearch
from bwt_tpu_torch.ops import suffix as tsuffix

from test_torch_index import FIELDS, assert_same_index, to_port

FLAG = dataclasses.replace(bwt_tpu_torch.DEFAULT_CONFIG,
                           elastic_fallback=True)
RATE = 8
FAILURES = {
    "KernelLaunchError": _kernels.KernelLaunchError,
    "AcceleratorError": torch.AcceleratorError,
    "OutOfMemoryError": torch.OutOfMemoryError,
}
SURFACES = ("build_index", "align_reads", "rna_seq", "search_reads")
LINES = {
    "build_index": "bwt_tpu_torch: build_index device run failed ({}); "
                   "rebuilding on the CPU backend (config.elastic_fallback)",
    "align_reads": "bwt_tpu_torch: device engine failed ({}); rebuilding on "
                   "the CPU backend and re-running (config.elastic_fallback)",
    "rna_seq": "bwt_tpu_torch: rna_seq device engine failed ({}); "
               "re-running on the CPU backend (config.elastic_fallback)",
    "search_reads": "bwt_tpu_torch: search_reads device scan failed ({}); "
                    "re-running on the CPU backend "
                    "(config.elastic_fallback)",
}

_WIDE_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
import bwt_tpu
from bwt_tpu import codec

g = codec.random_genome(4000, seed=31)
f = bwt_tpu.build_index(g, sa_sample_rate=int(sys.argv[2]),
                        index_dtype=np.int64)
np.savez(sys.argv[1], **{k: np.asarray(getattr(f, k)) for k in (
    "bwt_words", "buckets", "sa_samples", "C", "endloc", "isa_samples")})
"""


@pytest.fixture(scope="module")
def env():
    """tests/test_elastic.py's inputs: a 4,000-base genome (sa_rate 8) and
    24 reads of 60 bp with one substitution (N among them), made from a
    seed; bwt_tpu's outputs on them."""
    g = jcodec.random_genome(4000, seed=31)
    jfmi = bwt_tpu.build_index(g, sa_sample_rate=RATE)
    codes = jcodec.encode_genome(g)
    rng = np.random.default_rng(3)
    reads = []
    for _ in range(24):
        j = int(rng.integers(0, len(codes) - 60))
        r = codes[j:j + 60].copy()
        r[int(rng.integers(0, 60))] = int(rng.integers(0, 6))
        reads.append(r)
    rr = [r[:50] for r in reads]
    want = dict(
        align_reads=_norm(jaligner.align_reads(jfmi, g, reads, engine="host",
                                               with_strand=True)),
        rna_seq=np.asarray(jrnaseq.rna_seq(jfmi, rr, engine="host")),
        search_reads={k: np.asarray(v)
                      for k, v in jexact.search_reads(jfmi, reads).items()})
    return dict(g=g, jfmi=jfmi, tfmi=to_port(jfmi), reads=reads, rr=rr,
                want=want)


@pytest.fixture(scope="module")
def wide_want(tmp_path_factory):
    """bwt_tpu's wide (int64) index of the same genome, built under x64 in
    a subprocess (x64 is process-global)."""
    out = tmp_path_factory.mktemp("elastic") / "wide.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    res = subprocess.run([sys.executable, "-c", _WIDE_SCRIPT, str(out),
                          str(RATE)], capture_output=True, text=True,
                         env=env, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return dict(np.load(out))


def _norm(results):
    return [(p, c.render() if c else None, s) for p, c, s in results]


def _refuse_card():
    raise AssertionError("the elastic re-run asked for the card")


def _inject(monkeypatch, env, surface, fail):
    """Make the device run of ``surface`` call ``fail()`` (once, for the
    build's suffix sort, whose re-run sorts again) in place of its work;
    the run on ``env``'s index, or the build of its genome, then raises
    what ``fail`` raises."""
    tfmi = env["tfmi"]
    if surface == "build_index":
        orig = tsuffix.suffix_array_with_isa
        calls = []

        def sort_once(*a, **kw):
            if not calls:
                calls.append(1)
                fail()
            return orig(*a, **kw)

        monkeypatch.setattr(tsuffix, "suffix_array_with_isa", sort_once)
    elif surface == "align_reads":
        monkeypatch.setattr(taligner, "_align_reads_device",
                            lambda *a, **kw: fail())
    elif surface == "rna_seq":
        monkeypatch.setattr(trnaseq, "rna_seq_device",
                            lambda *a, **kw: fail())
    else:
        # the index "on the card": search_reads takes its card scan, and
        # the card scan fails
        on_card = tsearch._on_card
        monkeypatch.setattr(tsearch, "_on_card",
                            lambda fmi: fmi is tfmi or on_card(fmi))
        monkeypatch.setattr(texact, "_scan_on_card",
                            lambda *a, **kw: fail())


def _call(env, surface, config=None):
    if surface == "build_index":
        return bwt_tpu_torch.build_index(env["g"], sa_sample_rate=RATE,
                                         config=config, device="cpu")
    if surface == "align_reads":
        return _norm(taligner.align_reads(env["tfmi"], env["g"], env["reads"],
                                          engine="device", with_strand=True,
                                          config=config))
    if surface == "rna_seq":
        return trnaseq.rna_seq(env["tfmi"], env["rr"], engine="device",
                               config=config)
    return texact.search_reads(env["tfmi"], env["reads"], config=config)


def _check_output(env, surface, got):
    want = env["want"].get(surface)
    if surface == "build_index":
        assert_same_index(env["jfmi"], got)
    elif surface == "search_reads":
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k
    elif surface == "rna_seq":
        assert got.dtype == want.dtype and np.array_equal(got, want)
    else:
        assert got == want


def _failing(monkeypatch, cls):
    """A failure of class ``cls`` that also refuses the card for the rest
    of the test: everything after it, the re-run, must stay on the CPU."""
    def fail():
        monkeypatch.setattr(tindex, "default_device", _refuse_card)
        raise cls("injected device failure")
    return fail


@pytest.mark.parametrize("failure", list(FAILURES))
@pytest.mark.parametrize("surface", SURFACES)
def test_elastic_recovery_matches_bwt_tpu(env, surface, failure, monkeypatch,
                                          capsys):
    """Each surface, its device run failing with each device-failure
    class, recovers on the CPU with bwt_tpu's outputs and one line on
    stderr."""
    _inject(monkeypatch, env, surface, _failing(monkeypatch,
                                                FAILURES[failure]))
    got = _call(env, surface, FLAG)
    _check_output(env, surface, got)
    err = capsys.readouterr().err
    assert err.splitlines() == [LINES[surface].format(failure)]


def test_elastic_wide_build_matches_bwt_tpu(env, wide_want, monkeypatch,
                                            capsys):
    """A wide (int64) build that fails is rebuilt wide, with bwt_tpu's
    wide arrays."""
    _inject(monkeypatch, env, "build_index",
            _failing(monkeypatch, _kernels.KernelLaunchError))
    got = bwt_tpu_torch.build_index(env["g"], sa_sample_rate=RATE,
                                    config=FLAG, device="cpu",
                                    index_dtype=np.int64).to_numpy()
    assert got["buckets"].shape[1] == 12
    for f in FIELDS:
        assert got[f].dtype == wide_want[f].dtype, f
        assert np.array_equal(got[f], wide_want[f]), f
    assert capsys.readouterr().err.splitlines() == [
        LINES["build_index"].format("KernelLaunchError")]


def _bound_violation():
    """A real bound check of the port: the anchor hunt of a read ending in
    a symbol absent from an all-A genome, with min_anchor 0, whose anchor
    consumes nothing (``search.no_progress``)."""
    zeros = bwt_tpu_torch.build_index(np.zeros(64, np.uint8), device="cpu")
    texact.anchor_scan(zeros, np.array([[0, 0, 1]], np.int32),
                       np.array([3], np.int32), min_anchor=0)


def _build_failure(monkeypatch, tmp_path):
    """A real failed build of the kernels: an ``nvcc`` that exits 1, into
    an empty build directory."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\nexit 1\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_kernels, "_lib", None)
    return _kernels.library


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    return tindex.default_device


CHECKS = ("no-flag", "plain-RuntimeError", "launch-argument-error",
          "bound-violation", "build-failure", "no-CUDA-device",
          "stderr-line", "no-card-asked")


@pytest.mark.parametrize("surface", SURFACES)
@pytest.mark.parametrize("check", CHECKS)
def test_elastic_fallback_does_not_widen(env, check, surface, monkeypatch,
                                         capsys, tmp_path):
    """Without the flag a device failure propagates; with it, a plain
    RuntimeError, a launch refused for its arguments, a bound violation, a
    failed kernel build and a missing card propagate too (none of them is
    a failed card), with nothing on stderr.  A device failure with the
    flag prints its one line, and no step of the re-run asks for the
    card."""
    config = FLAG
    if check == "no-flag":
        fail, want = _failing(monkeypatch, _kernels.KernelLaunchError), (
            _kernels.KernelLaunchError, "injected")
        config = None
    elif check == "plain-RuntimeError":
        def fail():
            raise RuntimeError("plain")
        want = RuntimeError, "plain"
    elif check == "launch-argument-error":
        # a launcher's own argument check refusing (cudaErrorInvalidValue)
        def fail():
            _kernels.check_launch(1, "compose kernel launch")
        want = RuntimeError, "compose kernel launch failed: CUDA error 1$"
    elif check == "bound-violation":
        fail, want = _bound_violation, (RuntimeError, "never end")
    elif check == "build-failure":
        fail, want = (_build_failure(monkeypatch, tmp_path),
                      (RuntimeError, "nvcc failed"))
    elif check == "no-CUDA-device":
        fail, want = _no_card(monkeypatch), (RuntimeError, "no CUDA device")
    elif check == "stderr-line":
        def fail():
            raise _kernels.KernelLaunchError("injected")
        want = None
    else:
        fail, want = _failing(monkeypatch, _kernels.KernelLaunchError), None
    _inject(monkeypatch, env, surface, fail)
    if want is None:
        _check_output(env, surface, _call(env, surface, config))
        assert capsys.readouterr().err.splitlines() == [
            LINES[surface].format("KernelLaunchError")]
        if check == "no-card-asked":
            assert tindex.default_device is _refuse_card
        return
    cls, match = want
    with pytest.raises(cls, match=match) as info:
        _call(env, surface, config)
    assert type(info.value) is cls
    assert _kernels.device_failure(info.value) == (check == "no-flag")
    assert capsys.readouterr().err == ""


def test_device_failure_classes():
    """The predicate: the three device-failure classes, all RuntimeErrors,
    and none of the port's other RuntimeErrors."""
    for cls in FAILURES.values():
        assert issubclass(cls, RuntimeError)
        assert _kernels.device_failure(cls("x"))
    for e in (RuntimeError("x"), tsearch.no_progress(3, 0),
              tsearch._overrun(7, 10, 9), ValueError("x")):
        assert not _kernels.device_failure(e)


@pytest.mark.parametrize("code", (0, 2, 214, 700, 710, 719, -1, 1, 9, 98,
                                  209, 701))
def test_check_launch_classifies_codes(code):
    """A launcher's return: 0 passes; a code that says the card or its
    context failed raises KernelLaunchError, a device failure; any other
    (an argument, configuration or image error of the launch itself)
    raises a plain RuntimeError, which no recovery catches."""
    if code == 0:
        assert _kernels.check_launch(0, "locate kernel launch") is None
        return
    with pytest.raises(RuntimeError,
                       match=f"^locate kernel launch failed: CUDA error "
                             f"{code}$") as info:
        _kernels.check_launch(code, "locate kernel launch")
    failed = code in (2, 214, 700, 710, 719)
    assert isinstance(info.value, _kernels.KernelLaunchError) == failed
    assert _kernels.device_failure(info.value) == failed


@pytest.mark.parametrize("surface", ("align_reads", "rna_seq"))
def test_elastic_rerun_has_the_flag_off(env, surface, monkeypatch, capsys):
    """The CPU re-run of align_reads (its index rebuilt, then the host
    engine) and of rna_seq (the host engine) runs with a copy of the
    config whose flag is off, so that it nests no recovery of its own."""
    seen = []

    def spy(module, name):
        orig = getattr(module, name)

        def call(*a, **kw):
            seen.append(kw.get("config", next(
                (x for x in a if isinstance(x, type(FLAG))), None)))
            return orig(*a, **kw)
        monkeypatch.setattr(module, name, call)

    _inject(monkeypatch, env, surface, _failing(
        monkeypatch, _kernels.KernelLaunchError))
    if surface == "align_reads":
        spy(tindex, "build_index")
        spy(taligner, "_align_reads_host")
    else:
        spy(trnaseq, "_rna_seq_host")
    _check_output(env, surface, _call(env, surface, FLAG))
    assert len(seen) == (2 if surface == "align_reads" else 1)
    assert all(c is not None and not c.elastic_fallback for c in seen)
    assert len(capsys.readouterr().err.splitlines()) == 1


def test_recovery_copy_refuses_a_tp_view(env):
    """The CPU copy a re-run of search_reads or rna_seq serves from: a
    whole index gives its copy; a tp view has none, and the device error
    is raised again with the refusal as its cause."""
    from bwt_tpu_torch import parallel

    from test_torch_parallel import tp_mesh

    copy = tindex.recovery_copy(env["tfmi"], RuntimeError("unused"))
    assert_same_index(env["jfmi"], copy)
    view = parallel.tp_view(parallel.shard_index(env["tfmi"], tp_mesh(2, 1)))
    err = _kernels.KernelLaunchError("injected device failure")
    with pytest.raises(_kernels.KernelLaunchError) as info:
        tindex.recovery_copy(view, err)
    assert info.value is err
    assert isinstance(err.__cause__, ValueError)
    assert "whole index" in str(err.__cause__)
