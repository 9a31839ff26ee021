"""The check that decides ``correct``: a sound run passes; the control and
each fault that a locate cell can have, planted under the timed path, come
out not correct.  CPU rehearsals at a tiny size, past the look for a card."""

import pytest

from bwt_tpu_torch.ops import search

CELLS = ["chr1.kmer30", "ecoli.kmer30", "chr1.reads150"]


def checks(result):
    return {k: v["value"] for k, v in result["checks"].items()}


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(rehearse, workload):
    result, _ = rehearse(workload)
    assert result["correct"], result["checks"]
    assert all(v == 0 for v in checks(result).values())
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
def test_control_walk_cap_is_not_correct(rehearse, workload):
    result, _ = rehearse(workload, control="walk_cap")
    assert not result["correct"]
    assert checks(result)["wrong_answers"] > 0


def _half_left_out(fmi, patterns, lengths, seed_table=None):
    """Answers only the first half of the batch."""
    B = patterns.shape[0]
    return _real(fmi, patterns[:B // 2], lengths[:B // 2], seed_table)


def _half_filled(fmi, patterns, lengths, seed_table=None):
    """Answers the first half; the rest left as -1."""
    out = _real(fmi, patterns, lengths, seed_table).clone()
    out[out.shape[0] // 2:] = -1
    return out


def _one_altered(fmi, patterns, lengths, seed_table=None):
    """One answer a batch altered where it is produced."""
    out = _real(fmi, patterns, lengths, seed_table).clone()
    i = out.shape[0] // 3
    out[i] = out[i] + 1
    return out


_calls = [0]


def _raises(fmi, patterns, lengths, seed_table=None):
    """Every call past the warm-up's three fails."""
    _calls[0] += 1
    if _calls[0] > 3:
        raise RuntimeError("planted failure")
    return _real(fmi, patterns, lengths, seed_table)


_real = search.locate


@pytest.mark.parametrize("fault,number", [
    (_half_left_out, "missing_answers"), (_half_filled, "wrong_answers"),
    (_one_altered, "wrong_answers"), (_raises, "failed_calls")])
@pytest.mark.parametrize("workload", ["ecoli.kmer30", "chr1.reads150"])
def test_fault_is_not_correct(rehearse, monkeypatch, workload, fault,
                              number):
    monkeypatch.setattr(search, "locate", fault)
    _calls[0] = 0
    result, _ = rehearse(workload)
    assert not result["correct"]
    assert checks(result)[number] > 0


def test_wrong_index_samples_are_not_correct(rehearse, monkeypatch):
    import bwt_tpu_torch

    real_build = bwt_tpu_torch.build_index

    def build(*a, **k):
        fmi = real_build(*a, **k)
        fmi.sa_samples[5] += 1
        return fmi

    monkeypatch.setattr(bwt_tpu_torch, "build_index", build)
    result, _ = rehearse("ecoli.kmer30")
    assert not result["correct"]
    assert checks(result)["wrong_sa_samples"] == 1


def test_traced_rehearsal_reads_what_it_can(rehearse):
    result, notes = rehearse("chr1.kmer30", trace=True)
    assert result["correct"]
    # on the CPU no device operation runs: every device metric stays out
    assert set(result["metrics"]) <= {"index_build_s", "build_peak_gib"}
    assert "index_build_s" in result["metrics"]
    assert "breakdown" in result and result["device"]["busy_s"] == 0
    assert any(n.startswith("work per pool batch") for n in notes)
