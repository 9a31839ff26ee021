"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

import json
import re

import pytest
from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def manifest():
    raw = (ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    return json.loads(raw)


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(manifest):
    assert set(manifest) == KEYS["top"]
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    files = [w for w in cmd if "/" in w]
    assert all(any(f.startswith(p + "/") for p in manifest["paths"])
               for f in files)
    rs = manifest["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits in its 43,200 seconds
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units(manifest):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in manifest[group]:
            key = group[:-1] if group.endswith("s") else group
            allowed = KEYS.get(key, KEYS.get(group))
            assert set(entry) - {"workloads"} == allowed, entry["name"]
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
                assert entry["source"] in SOURCES
            for k in ("why", "layer", "source"):
                if k in entry and group != "end_to_end":
                    assert line(entry[k]), (entry["name"], k)
    for group in ("configs", "workloads"):
        got = [n for g, n in names if g == group]
        assert len(got) == len(set(got))
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))


def test_configs(manifest):
    used = {w["config"] for w in manifest["workloads"]}
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    for c in manifest["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in manifest["paths"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert sorted(body["reduced"]) == sorted(c["reduced"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert body["assumed"] and body["guarantees"]


def test_workloads_find_their_files(manifest):
    configs = {c["name"] for c in manifest["configs"]}
    pairs = set()
    for w in manifest["workloads"]:
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        assert (BENCH / "entries" / f"{mix['entry']}.py").is_file()
        assert (BENCH / "generators" / f"{mix['generator']}.py").is_file()
        conf = next(c for c in manifest["configs"] if c["name"] == w["config"])
        genome = json.loads((ROOT / conf["file"]).read_text())["genome"]
        assert (BENCH / "genomes" / f"{genome}.py").is_file()
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, len(manifest["workloads"]) // 4)


def test_metrics_have_readers_and_cover_every_cell(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in manifest["workloads"]}
    layers = {}
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        layers.setdefault(m["layer"], []).append(m["name"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    for cell in cells:
        reports = [m["name"] for m in manifest["end_to_end"]
                   if cell in m.get("workloads", cells)]
        assert "setup_s" in reports and len(reports) >= 2
        layer = [m for m in manifest["per_layer"]
                 if cell in m.get("workloads", cells)]
        assert layer
        for m in layer:  # it reports the metric its layer metric moves
            assert m["moves"] in reports


def test_layers_are_named_in_perf_md(manifest):
    perf = (ROOT / "PERF.md").read_text()
    for m in manifest["per_layer"]:
        assert m["layer"] in perf, m["layer"]
