"""The PyTorch port's codec, index build and persistence held bit-equal
against bwt_tpu on the same inputs (CPU)."""

import dataclasses
import functools

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


@pytest.mark.parametrize("rate", [1, 4])
@pytest.mark.parametrize("n,kind", [(4096, "rand"), (512, "zeros"),
                                    (3001, "rand")])
def test_seed_levels_match_bwt_tpu_tables(n, kind, rate):
    """Each level of the seed table's level order, grown from the one-
    character states by _seed_children (child c of row p at p + c * 4^t),
    equals bwt_tpu's whole table at that depth: the schedule's every step,
    on a random genome, an all-A one and one whose length is not a multiple
    of 64."""
    jfmi = bwt_tpu.build_index(_genome(n, kind), sa_sample_rate=rate)
    tfmi = to_port(jfmi)
    states = tsearch._seed_rows_plain(tfmi, 1)
    for k in range(2, 7):
        states = tsearch._seed_children(tfmi, states).reshape(-1, 6)
        assert np.array_equal(states.numpy(),
                              np.asarray(jsearch._seed_rows(jfmi, k))), k


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
    # config.elastic_fallback is accepted and, without a device failure,
    # changes nothing (tests/test_torch_elastic.py drives the recovery)
    cfg = dataclasses.replace(bwt_tpu_torch.DEFAULT_CONFIG,
                              elastic_fallback=True)
    assert_same_index(bwt_tpu.build_index(g),
                      bwt_tpu_torch.build_index(g, config=cfg, device="cpu"))


@pytest.mark.parametrize("dtype", ["auto", "int32", np.int32])
def test_index_dtype_matches_bwt_tpu(dtype):
    """index_dtype int32 (as a name or a numpy type) and "auto" build the
    default index, as in bwt_tpu."""
    g = _genome(2000, "rand")
    jfmi = bwt_tpu.build_index(g, sa_sample_rate=8, index_dtype=dtype)
    assert_same_index(jfmi, bwt_tpu_torch.build_index(
        g, sa_sample_rate=8, device="cpu", index_dtype=dtype))
    assert_same_index(jfmi, bwt_tpu_torch.build_index(
        g, sa_sample_rate=8, device="cpu"))


def test_index_dtype_past_the_cap_and_int64(monkeypatch):
    """With the int32 cap lowered (both packages read it at call time), an
    int32 index of a longer genome raises bwt_tpu's ValueError; the wide
    (int64) layout, asked for or taken by "auto" past the cap, holds
    bwt_tpu's int32 index's values in the wide layout (tests/test_torch_
    wide.py holds it to bwt_tpu's own wide build under x64), and so it
    does under the cap when asked for."""
    from bwt_tpu.ops import suffix as jsuffix

    g = _genome(300, "rand")
    want = bwt_tpu.build_index(g)
    monkeypatch.setattr(jsuffix, "INT32_MAX_LEN", 100)
    monkeypatch.setattr(tsuffix, "INT32_MAX_LEN", 100)
    for build in (bwt_tpu.build_index, functools.partial(
            bwt_tpu_torch.build_index, device="cpu")):
        with pytest.raises(ValueError,
                           match="exceeds the int32 FM-index cap"):
            build(g, index_dtype=np.int32)
    for seq, dtype in ((g, np.int64), (g, "int64"), (g, "auto"),
                       (g[:50], np.int64)):
        got = bwt_tpu_torch.build_index(seq, device="cpu", index_dtype=dtype)
        assert got.wide and got.sa_samples.dtype == torch.int64
        if len(seq) == len(g):
            d = got.to_numpy()
            b = d["buckets"]
            assert not b[:, 4:8].any()
            assert np.array_equal(b[:, [0, 1, 2, 3, 8, 9, 10, 11]],
                                  np.asarray(want.buckets))
            for f in ("sa_samples", "C", "endloc", "isa_samples"):
                assert d[f].dtype == np.int64
                assert np.array_equal(d[f], np.asarray(getattr(want, f))), f


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


@pytest.mark.parametrize("case", ["rows12", "int64-arrays", "int64-isa"])
def test_wide_index_round_trips(tmp_path, case):
    """An index in bwt_tpu's wide (int64) layout, laid out in numpy as
    bwt_tpu writes one (rank.ROW_INTS_WIDE rows: occ split into lo / hi
    halves, then the words; int64 sa_samples, C, endloc and ISA), loads
    through from_numpy and an npz file as the wide index, every array and
    dtype as given, and answers locate as bwt_tpu's index does; int64
    value arrays beside 8-int rows load as the int32 index, as bwt_tpu
    loads them (jnp.asarray without x64)."""
    jfmi = bwt_tpu.build_index(jcodec.random_genome(3000, seed=2),
                               sa_sample_rate=8)
    d = {f: np.asarray(getattr(jfmi, f)) for f in FIELDS}
    d.update(length=jfmi.length, sa_rate=jfmi.sa_rate)
    if case == "rows12":
        b = d["buckets"]
        d["buckets"] = np.concatenate(
            [b[:, :4], np.zeros_like(b[:, :4]), b[:, 4:]], axis=1)
        for f in ("sa_samples", "C", "endloc", "isa_samples"):
            d[f] = d[f].astype(np.int64)
    elif case == "int64-arrays":
        for f in ("sa_samples", "C", "endloc"):
            d[f] = d[f].astype(np.int64)
    else:
        d["isa_samples"] = d["isa_samples"].astype(np.int64)
    np.savez(tmp_path / "wide.npz", version=np.int32(2), **d)
    pats = np.asarray(jcodec.encode_genome(
        jcodec.random_genome(3000, seed=2)))[np.add.outer(
            np.arange(0, 2900, 37), np.arange(20))].astype(np.int32)
    lens = np.full(pats.shape[0], 20, np.int32)
    want = np.asarray(jsearch.locate(jfmi, pats, lens))
    for tfmi in (bwt_tpu_torch.from_numpy(d, device="cpu"),
                 tio.read_npz_index(tmp_path / "wide.npz", device="cpu")):
        if case == "rows12":
            assert tfmi.wide
            got = tfmi.to_numpy()
            for f in FIELDS:
                assert got[f].dtype == d[f].dtype, f
                assert np.array_equal(got[f], d[f]), f
        else:
            assert not tfmi.wide
            assert_same_index(jio.read_npz_index(tmp_path / "wide.npz"),
                              tfmi)
        pos = tsearch.locate(tfmi, pats, lens)
        assert pos.dtype == (torch.int64 if case == "rows12"
                             else torch.int32)
        assert np.array_equal(pos.numpy(), want)


def test_no_card_without_device_raises(tmp_path, monkeypatch):
    """Without a card, an entry point called with no device raises and
    names device="cpu": the port never falls back to the CPU by itself.
    The CLI's default platform is the card, and exits 1 without one."""
    from bwt_tpu_torch import cli as tcli
    from bwt_tpu_torch.ops import dp_wavefront

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = jcodec.random_genome(300, seed=4)
    jfmi = bwt_tpu.build_index(g)
    jio.write_ref_index(jfmi, tmp_path / "g.idx")
    arrays = {f: np.asarray(getattr(jfmi, f)) for f in FIELDS
              if getattr(jfmi, f) is not None}
    arrays.update(length=jfmi.length, sa_rate=jfmi.sa_rate)
    calls = (lambda: bwt_tpu_torch.build_index(g),
             lambda: bwt_tpu_torch.from_numpy(arrays),
             lambda: tio.read_ref_index(tmp_path / "g.idx"),
             lambda: dp_wavefront.nw_fast_batch(
                 np.zeros((1, 4), np.int32), [4], np.zeros((1, 4), np.int32),
                 [4]))
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    (tmp_path / "g.txt").write_text(g)
    (tmp_path / "r.txt").write_text(g[10:40] + "\n")
    with pytest.raises(SystemExit) as e:
        tcli.main(["locate", str(tmp_path / "g.txt"), str(tmp_path / "g.idx"),
                   str(tmp_path / "r.txt")])
    assert e.value.code == 1


@pytest.mark.parametrize("rate", [4, 32])
def test_index_from_parts_matches_bwt_tpu(rate):
    """bwt_tpu's index_from_parts keywords, the stored C included (dropped
    and rebuilt by both), give bwt_tpu's arrays; index_from_parts and
    fm_rank are exported as bwt_tpu exports them."""
    from bwt_tpu import index as jindex

    from bwt_tpu_torch.ops import rank as trank

    g = _genome(3001, "rand")
    jfmi = bwt_tpu.build_index(g, sa_sample_rate=rate)
    kw = dict(bwt_codes=jindex.bwt_codes(jfmi),
              sa_samples=np.asarray(jfmi.sa_samples), C=np.asarray(jfmi.C),
              endloc=int(jfmi.endloc), length=jfmi.length, sa_rate=rate)
    want = bwt_tpu.index_from_parts(**kw)
    got = bwt_tpu_torch.index_from_parts(**kw, device="cpu")
    assert_same_index(want, got)
    assert {"index_from_parts", "fm_rank", "from_numpy"} <= set(
        bwt_tpu_torch.__all__)
    assert bwt_tpu_torch.fm_rank is trank.rank
    idx = np.arange(0, jfmi.length + 2, 7, dtype=np.int32)
    for c in range(4):
        assert np.array_equal(
            bwt_tpu_torch.fm_rank(got.buckets, got.endloc, c, idx).numpy(),
            np.asarray(bwt_tpu.fm_rank(want.buckets, want.endloc, c, idx)))


@pytest.mark.parametrize("n,rate", [(5, 32), (63, 4), (64, 4), (3001, 8),
                                    (4096, 32)])
def test_index_sizes_and_bwt_codes_match_bwt_tpu(n, rate):
    from bwt_tpu import index as jindex

    from bwt_tpu_torch import index as tindex

    g = _genome(n, "rand")
    jfmi = bwt_tpu.build_index(g, sa_sample_rate=rate)
    tfmi = bwt_tpu_torch.build_index(g, sa_sample_rate=rate, device="cpu")
    for name in ("nwords", "bucket_rows", "sample_rows"):
        assert getattr(tfmi, name) == getattr(jfmi, name), name
    assert tfmi.bucket_rows == tfmi.buckets.shape[0]
    assert tfmi.sample_rows == tfmi.sa_samples.shape[0]
    got = tindex.bwt_codes(tfmi)
    assert got.dtype == np.uint8
    assert np.array_equal(got, jindex.bwt_codes(jfmi))


@pytest.mark.parametrize("n,kind", [(1, "rand"), (700, "rand"),
                                    (512, "zeros"), (3001, "rand")])
def test_suffix_array_and_bwt_from_sa_match_bwt_tpu(n, kind):
    from bwt_tpu.ops import suffix as jsuffix

    g = _genome(n, kind)
    want = np.asarray(jsuffix.suffix_array(g))
    got = tsuffix.suffix_array(g, device="cpu")
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    # a tensor's own device is the default
    assert torch.equal(tsuffix.suffix_array(torch.from_numpy(g)), got)
    jb, je = jsuffix.bwt_from_sa(g, want)
    tb, te = tsuffix.bwt_from_sa(torch.from_numpy(g), got)
    assert np.array_equal(tb.numpy(), np.asarray(jb)) and int(te) == int(je)


@pytest.mark.parametrize("text", ["mississippi", "banana", "AACGT", "a",
                                  "abracadabra", ""])
def test_naive_bwt_ascii_matches_bwt_tpu(text):
    from bwt_tpu.ops import suffix as jsuffix

    assert tsuffix.naive_bwt_ascii(text) == jsuffix.naive_bwt_ascii(text)


def test_suffix_array_int32_cap_and_int64(monkeypatch):
    """With the cap lowered in both packages, suffix_array raises bwt_tpu's
    ValueError, before any upload (a card asked for on a machine without
    one is never reached); the int64 variant has no cap and gives bwt_tpu's
    suffix array as int64 (under x64 in tests/test_torch_wide.py)."""
    from bwt_tpu.ops import suffix as jsuffix

    g = _genome(300, "rand")
    want = {n: np.asarray(jsuffix.suffix_array(g[:n])) for n in (50, 300)}
    monkeypatch.setattr(jsuffix, "INT32_MAX_LEN", 100)
    monkeypatch.setattr(tsuffix, "INT32_MAX_LEN", 100)
    for fn in (jsuffix.suffix_array,
               functools.partial(tsuffix.suffix_array, device="cpu"),
               functools.partial(tsuffix.suffix_array, device="cuda")):
        with pytest.raises(ValueError,
                           match="exceeds the int32 suffix-array cap"):
            fn(g)
    for dtype in (np.int64, torch.int64):
        for n, sa in want.items():  # under the cap and past it
            got = tsuffix.suffix_array(g[:n], device="cpu", dtype=dtype)
            assert got.dtype == torch.int64
            assert np.array_equal(got.numpy(), sa)
    with pytest.raises(ValueError, match="unsupported SA dtype"):
        tsuffix.suffix_array(g[:50], device="cpu", dtype=np.float32)
