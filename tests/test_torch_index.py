"""The PyTorch port's codec, index build and persistence held bit-equal
against bwt_tpu on the same inputs (CPU)."""

import dataclasses

import numpy as np
import pytest
import torch

import bwt_tpu
from bwt_tpu import codec as jcodec
from bwt_tpu import io as jio
from bwt_tpu.ops import search as jsearch

import bwt_tpu_torch
from bwt_tpu_torch import codec as tcodec
from bwt_tpu_torch import io as tio
from bwt_tpu_torch.ops import search as tsearch
from bwt_tpu_torch.ops import suffix as tsuffix

FIELDS = ("bwt_words", "buckets", "sa_samples", "C", "endloc",
          "isa_samples")


def to_port(fmi):
    """A bwt_tpu FMIndex carried into the port through numpy."""
    d = {f: np.asarray(getattr(fmi, f)) for f in FIELDS
         if getattr(fmi, f) is not None}
    d.update(length=fmi.length, sa_rate=fmi.sa_rate)
    return bwt_tpu_torch.from_numpy(d, device="cpu")


def assert_same_index(jfmi, tfmi):
    got = tfmi.to_numpy()
    assert got["length"] == jfmi.length and got["sa_rate"] == jfmi.sa_rate
    for f in FIELDS:
        want = getattr(jfmi, f)
        if want is None:
            assert f not in got
            continue
        want = np.asarray(want)
        assert got[f].dtype == want.dtype, f
        assert np.array_equal(got[f], want), f


def _genome(n, kind):
    if kind == "zeros":
        return np.zeros(n, np.uint8)
    return np.random.default_rng(n).integers(0, 4, n).astype(np.uint8)


# -- codec -----------------------------------------------------------------


def test_codec_matches_bwt_tpu(rng):
    text = "ACGTNacgtXYZ" + jcodec.random_genome(997, seed=3)
    assert np.array_equal(tcodec.encode_genome(text),
                          jcodec.encode_genome(text))
    assert np.array_equal(tcodec.encode_read(text), jcodec.encode_read(text))
    codes = tcodec.encode_read(text)
    assert np.array_equal(tcodec.revcomp(codes), jcodec.revcomp(codes))
    assert np.array_equal(tcodec._COMPLEMENT, jcodec._COMPLEMENT)
    assert tcodec.decode(codes) == jcodec.decode(codes)
    for n, seed in ((0, 0), (1, 5), (1000, 7)):
        assert tcodec.random_genome(n, seed) == jcodec.random_genome(n, seed)
    g = tcodec.encode_genome(text)
    for n in (1, 15, 16, 17, len(g)):
        w = tcodec.pack_words(g[:n])
        assert w.dtype == np.uint32
        assert np.array_equal(w, jcodec.pack_words(g[:n]))
        assert np.array_equal(tcodec.unpack_words(w, n), g[:n])
        b = tcodec.pack_ref_bytes(g[:n])
        assert np.array_equal(b, jcodec.pack_ref_bytes(g[:n]))
        assert np.array_equal(tcodec.unpack_ref_bytes(b, n), g[:n])


def test_config_matches_bwt_tpu():
    from bwt_tpu import config as jconfig
    from bwt_tpu_torch import config as tconfig

    assert ([(f.name, f.default) for f in dataclasses.fields(tconfig.Config)]
            == [(f.name, f.default)
                for f in dataclasses.fields(jconfig.Config)])
    alt = dict(match=1, mismatch=-2, gap_open=-9, gap_extend=-1)
    assert (dataclasses.replace(tconfig.DEFAULT, **alt).dp_scoring
            == dataclasses.replace(jconfig.DEFAULT, **alt).dp_scoring
            == (1, -2, -9, -1))


# -- build -----------------------------------------------------------------


@pytest.mark.parametrize("rate", [4, 8, 32])
@pytest.mark.parametrize("n,kind", [
    (1, "rand"), (2, "rand"), (63, "rand"), (64, "rand"), (65, "rand"),
    (1000, "rand"), (20000, "rand"), (1000, "zeros"),
])
def test_build_index_matches_bwt_tpu(n, kind, rate):
    g = _genome(n, kind)
    jfmi = bwt_tpu.build_index(g, sa_sample_rate=rate)
    tfmi = bwt_tpu_torch.build_index(g, sa_sample_rate=rate, verify=True,
                                     device="cpu")
    assert_same_index(jfmi, tfmi)


def test_build_index_text_and_validation():
    g = jcodec.random_genome(300, seed=4)
    assert_same_index(bwt_tpu.build_index(g),
                      bwt_tpu_torch.build_index(g, device="cpu"))
    with pytest.raises(ValueError):
        bwt_tpu_torch.build_index(g, sa_sample_rate=12, device="cpu")
    cfg = dataclasses.replace(bwt_tpu_torch.DEFAULT_CONFIG, rank_blocksize=8)
    with pytest.raises(ValueError):
        bwt_tpu_torch.build_index(g, config=cfg, device="cpu")
    cfg = dataclasses.replace(bwt_tpu_torch.DEFAULT_CONFIG,
                              elastic_fallback=True)
    with pytest.raises(NotImplementedError):
        bwt_tpu_torch.build_index(g, config=cfg, device="cpu")


def test_verify_suffix_array_rejects_bad_sa():
    codes = torch.from_numpy(_genome(500, "rand")).to(torch.int64)
    sa, isa = tsuffix.suffix_array_with_isa(codes)
    assert tsuffix.verify_suffix_array(codes, sa)
    assert torch.equal(isa[sa.long()], torch.arange(501, dtype=torch.int32))
    bad = sa.clone()
    bad[[10, 11]] = bad[[11, 10]]
    assert not tsuffix.verify_suffix_array(codes, bad)
    bad = sa.clone()
    bad[3] = bad[4]
    assert not tsuffix.verify_suffix_array(codes, bad)


# -- state carried across --------------------------------------------------


def test_from_numpy_gives_identical_queries(rng):
    g = jcodec.random_genome(5000, seed=8)
    jfmi = bwt_tpu.build_index(g, sa_sample_rate=8)
    tfmi = to_port(jfmi)
    assert_same_index(jfmi, tfmi)
    codes = jcodec.encode_genome(g)
    starts = rng.integers(0, 5000 - 25, size=64)
    pats = codes[np.add.outer(starts, np.arange(25))].astype(np.int32)
    pats[:8] = rng.integers(0, 4, size=(8, 25))  # mostly absent
    lens = np.full(64, 25, np.int32)
    want = np.asarray(jsearch.locate(jfmi, pats, lens))
    got = tsearch.locate(tfmi, pats, lens).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got[8:], starts[8:])  # 25-mers are unique here
    assert np.array_equal(tfmi.lf(np.arange(5001)).numpy(),
                          np.asarray(jfmi.lf(np.arange(5001, dtype=np.int32))))


def test_npz_written_by_bwt_tpu_loads(tmp_path):
    g = jcodec.random_genome(3000, seed=9)
    jfmi = bwt_tpu.build_index(g, sa_sample_rate=4)
    jio.write_npz_index(jfmi, tmp_path / "j.npz")
    tfmi = tio.read_npz_index(tmp_path / "j.npz", device="cpu")
    assert_same_index(jfmi, tfmi)
    # and back: the port's npz loads into bwt_tpu unchanged
    tio.write_npz_index(tfmi, tmp_path / "t.npz")
    assert_same_index(jio.read_npz_index(tmp_path / "t.npz"), tfmi)


@pytest.mark.parametrize("rate", [8, 32])
def test_ref_format_bytes_equal(tmp_path, rate):
    g = jcodec.random_genome(4099, seed=rate)
    jfmi = bwt_tpu.build_index(g, sa_sample_rate=rate)
    tfmi = bwt_tpu_torch.build_index(g, sa_sample_rate=rate, device="cpu")
    jio.write_ref_index(jfmi, tmp_path / "j.idx")
    tio.write_ref_index(tfmi, tmp_path / "t.idx")
    raw = (tmp_path / "j.idx").read_bytes()
    assert (tmp_path / "t.idx").read_bytes() == raw
    assert_same_index(jio.read_ref_index(tmp_path / "j.idx"),
                      tio.read_ref_index(tmp_path / "j.idx", device="cpu"))
    (tmp_path / "short.idx").write_bytes(raw[:-3])
    with pytest.raises(ValueError, match="truncated"):
        tio.read_ref_index(tmp_path / "short.idx")
    (tmp_path / "head.idx").write_bytes(raw[:10])
    with pytest.raises(ValueError, match="truncated"):
        tio.read_ref_index(tmp_path / "head.idx")
