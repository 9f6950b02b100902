"""BENCHMARK.json against the benchmark's contract: keys, names, units,
lengths, the files each entry is found by, and the time a full check of
24 cells would take at ``run_seconds``."""

import json
import re

import pytest

from harness import cell as cells
from harness.cell import BENCH_DIR, ROOT

SPEC = json.load(open(ROOT / "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
WORKLOADS = [w["name"] for w in SPEC["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert all(PATH.match(p) and ".." not in p for p in SPEC["paths"])
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    names = [c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"]) and \
            _line(c["source"]) and c["source"].startswith("https://")
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        body = json.load(open(ROOT / c["file"]))
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"] == []
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


def test_workloads():
    assert len(WORKLOADS) == len(set(WORKLOADS)) and 1 <= len(WORKLOADS) <= 24
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(WORKLOADS)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
        assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH_DIR / "checks" / f"{w['name']}.json").is_file()
        cell = cells.load_cell(w["name"])
        assert (BENCH_DIR / "generators" / f"{cell.kind}.py").is_file()
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer


def test_end_to_end_metrics():
    names = [m["name"] for m in SPEC["end_to_end"]]
    assert "setup_s" in names and len(names) == len(set(names))
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", WORKLOADS)) <= set(WORKLOADS)


def test_per_layer_metrics():
    names = [m["name"] for m in SPEC["per_layer"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 128
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert _line(m["layer"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m["workloads"]:
            reports = e2e[m["moves"]].get("workloads", WORKLOADS)
            assert w in reports, (m["name"], w)
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
        assert callable(cells.reader(m["name"]))
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    # metrics of one layer name it letter for letter alike
    assert all(len(v) == 1 for v in layers.values())
    # every name the harness finds a file by is a name's characters and /
    for f in (BENCH_DIR / "metrics").glob("*.py"):
        assert NAME.match(f.stem)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_checks_files_hold_limits(workload):
    limits = json.load(open(BENCH_DIR / "checks" / f"{workload}.json"))
    assert set(limits) == {"limits"} and limits["limits"]
    assert all(0 < v < 1 for v in limits["limits"].values())
