"""The port's fused service round against bwt_tpu's, on the CPU: the same
numpy-seeded lanes through ``bwt_tpu.models.batch_exec._service_core`` and
``bwt_tpu_torch.models.batch_exec._service_core``, tolerance 0 in all 13
result columns on every lane.  The lanes (chip_smoke.service_lanes) mix
all eight opcodes over slices of a bank with leading, inner, trailing and
only N's, slices of length <= 0 and 1, the whole row, past the row's end
and rows outside the bank, empty incoming intervals, windows that hit and
miss, out-of-table symbols."""

import functools
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import bwt_tpu
from bwt_tpu.models import batch_exec as jbe
from bwt_tpu.ops import search as jsearch

from bwt_tpu_torch.models import batch_exec as tbe
from bwt_tpu_torch.ops import search as tsearch
from bwt_tpu_torch.ops import service

from test_torch_index import to_port

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import service_lanes  # noqa: E402

B = 256
COLS = ("mms_m", "cont_m", "start", "end", "osp", "oep", "nm", "alive",
        "skips", "pos", "crank", "wbest", "wrow")


@functools.lru_cache(maxsize=None)
def _env(n, rate):
    rng = np.random.default_rng(n + rate)
    g = rng.integers(0, 4, n).astype(np.uint8)
    jfmi = bwt_tpu.build_index(g, sa_sample_rate=rate)
    return g, jfmi, to_port(jfmi)


@functools.lru_cache(maxsize=None)
def _jcore(resolve, ext, seed_k):
    return jax.jit(functools.partial(jbe._service_core, resolve=resolve,
                                     ext=ext, seed_k=seed_k))


def _both(n, rate, bank, f, *, resolve, ext, seed_k=0):
    _, jfmi, tfmi = _env(n, rate)
    jseed = tseed = None
    if seed_k:
        jseed = jsearch._seed_rows(jfmi, seed_k)
        tseed = tsearch._seed_rows(tfmi, seed_k)
    want = _jcore(resolve, ext, seed_k)(jfmi, bank.astype(np.int32), *f,
                                        seed_rows=jseed)
    got = tbe._service_core(tfmi, torch.from_numpy(bank),
                            *torch.from_numpy(f).unbind(0), resolve=resolve,
                            ext=ext, seed_rows=tseed, seed_k=seed_k)
    assert len(got) == len(want) == len(COLS)
    for name, a, b in zip(COLS, got, want):
        a, b = a.numpy(), np.asarray(b)
        bad = np.flatnonzero(a != b)
        assert a.shape == b.shape and not bad.size, (
            f"column {name} differs on lanes {bad[:8]} (opcodes "
            f"{f[0][bad[:8]]}): {a[bad[:8]]} != {b[bad[:8]]}")
    return got


@pytest.mark.parametrize("ext", [False, True], ids=["noext", "ext"])
@pytest.mark.parametrize("resolve", [False, True], ids=["raw", "resolve"])
@pytest.mark.parametrize("n,rate", [(3001, 4), (2999, 32)],
                         ids=["r4", "r32"])
def test_service_core_matches_bwt_tpu(n, rate, resolve, ext):
    g, _, _ = _env(n, rate)
    rng = np.random.default_rng(7 * n + 2 * resolve + ext)
    bank, f = service_lanes(rng, g, B, R=32, Lb=48)
    got = _both(n, rate, bank, f, resolve=resolve, ext=ext)
    opc = f[0]
    # the case exercises what it claims to
    assert set(opc.tolist()) == set(range(8))
    assert (got[service.SKIPS][(opc == 1) | (opc == 6)] > 0).any() == resolve
    assert (got[service.CONT_M][opc == 2] == -1).any()
    assert (got[service.ALIVE][opc == 3] == 0).any()
    assert (got[service.ALIVE][opc == 3] == 1).any()
    if ext:
        for op in (6, 7):
            assert (got[service.WBEST][opc == op] >= 0).any()
            assert (got[service.WBEST][opc == op] == -1).any()
    else:
        assert (got[service.WBEST] == -1).all()


@pytest.mark.parametrize("resolve", [False, True], ids=["raw", "resolve"])
@pytest.mark.parametrize("k", [4, 6])
def test_service_core_seeded_matches_bwt_tpu(k, resolve):
    n, rate = 3001, 4
    g, _, _ = _env(n, rate)
    rng = np.random.default_rng(100 + 2 * k + resolve)
    bank, f = service_lanes(rng, g, B, R=32, Lb=48)
    got = _both(n, rate, bank, f, resolve=resolve, ext=True, seed_k=k)
    # lanes long enough to have started from the table
    deep = np.isin(f[0], (1, 3, 6, 7)) & (got[service.NM].numpy() > k)
    assert deep.sum() > B // 16


@pytest.mark.parametrize("ops,what", [
    ((0, 1, 2, 3, 4, 5), "no ext lane"),
    ((0, 5, 6), "no lane that consumes the walk"),
    ((7,), "bsearch_ext alone"),
    ((0,), "padding alone"),
])
def test_service_core_ext_round_without(ops, what):
    """``ext`` rounds that lack an ext lane, or a lane that reads the
    walk's column: what a lane that does not consume a column reads there
    is bwt_tpu's too."""
    n, rate = 3001, 4
    g, _, _ = _env(n, rate)
    rng = np.random.default_rng(len(what))
    bank, f = service_lanes(rng, g, B, R=32, Lb=48, ops=ops)
    got = _both(n, rate, bank, f, resolve=True, ext=True)
    if 7 not in ops and 6 not in ops:
        assert (got[service.WBEST] == -1).all()
    if not set(ops) & {1, 2, 3, 4, 7}:
        assert (got[service.POS] == 0).all()


def test_service_n_under_bsearch_is_not_resolved():
    """A raw backward search steps over an N with rank(5) as it is, in a
    round whose mms lanes resolve theirs."""
    n, rate = 2999, 32
    g, _, tfmi = _env(n, rate)
    bank = np.zeros((8, 48), np.uint8)
    bank[0, :40] = g[100:140]
    bank[0, 30] = 5
    f = np.zeros((7, 8), np.int32)
    f[0, :3] = (1, 3, 7)  # mms, bsearch, bsearch_ext over the same slice
    f[3, :3] = 40
    got = _both(n, rate, bank, f, resolve=True, ext=True)
    assert int(got[service.MMS_M][0]) == 40  # resolved: the read matches
    assert int(got[service.NM][1]) == int(got[service.NM][2]) < 40


def test_service_walk_bound_raises():
    """A walk from a row past the suffix array raises, consumed or not
    (bwt_tpu never returns there, so the port alone is probed)."""
    tfmi = to_port(bwt_tpu.build_index(np.zeros(64, np.uint8),
                                       sa_sample_rate=4))
    bank = torch.ones((8, 16), dtype=torch.uint8)  # 'C', absent
    f = torch.zeros((7, 8), dtype=torch.int32)
    f[0, 2], f[3, 2] = 3, 4
    with pytest.raises(RuntimeError, match="row 65"):
        tbe._service_core(tfmi, bank, *f.unbind(0), resolve=False)
    assert service.SERVICE_LAUNCHES == 0  # a CPU index launches nothing


@pytest.mark.parametrize("width", [1, 2, 4, 8])
@pytest.mark.parametrize("resolve,seed_k", [(False, 0), (True, 0), (True, 4)],
                         ids=["raw", "resolve", "seeded"])
def test_service_plain_width_matches_bwt_tpu(width, resolve, seed_k):
    """The plain round's ``width`` (the kernel's tile on an ext round: the
    window in slices, each chained from its own sample) against bwt_tpu's
    round, all eight opcodes and all 13 columns, on windows whose slices
    start on and off a sample (rate 4 and 32)."""
    for n, rate in ((3001, 4), (2999, 32)):
        g, jfmi, tfmi = _env(n, rate)
        rng = np.random.default_rng(31 * width + 2 * resolve + seed_k + rate)
        bank, f = service_lanes(rng, g, B, R=32, Lb=48)
        jseed = tseed = None
        if seed_k:
            jseed = jsearch._seed_rows(jfmi, seed_k)
            tseed = tsearch._seed_rows(tfmi, seed_k)
        want = _jcore(resolve, True, seed_k)(jfmi, bank.astype(np.int32), *f,
                                             seed_rows=jseed)
        got = service.service_round_plain(
            tfmi, torch.from_numpy(bank), *torch.from_numpy(f).unbind(0),
            resolve=resolve, ext=True, seed_rows=tseed, seed_k=seed_k,
            width=width)
        for name, a, b in zip(COLS, got.numpy(), want):
            b = np.asarray(b)
            bad = np.flatnonzero(a != b)
            assert not bad.size, (f"width {width}: column {name} differs on "
                                  f"lanes {bad[:8]}: {a[bad[:8]]} != "
                                  f"{b[bad[:8]]}")
        # the windows hit in more than one slice
        ext = np.isin(f[0], (6, 7))
        assert (got[service.WBEST].numpy()[ext] >= 0).sum() > 4


def test_service_plain_width_rejects_a_non_power_of_two():
    g, _, tfmi = _env(3001, 4)
    bank, f = service_lanes(np.random.default_rng(0), g, 32, R=32, Lb=48)
    with pytest.raises(ValueError, match="power of two"):
        service.service_round_plain(
            tfmi, torch.from_numpy(bank), *torch.from_numpy(f).unbind(0),
            resolve=True, ext=True, width=3)
