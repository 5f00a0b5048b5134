"""BENCHMARK.json against the benchmark's contract, and the harness finding
every cell, configuration, traffic mix and metric by name, including one
more cell and metric added as files alone."""

import json
import os
import re
import shutil
import types

import pytest

from benchmark import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return harness.spec()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"][0] == "python3" and len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert all(not os.path.isabs(p) and ".." not in p.split("/")
               and re.match(r"^[A-Za-z0-9_./-]{1,200}$", p)
               for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    # a full check with 24 cells fits its 43,200 s
    assert 1200 + (2 + 14 * 24) * (bench["run_seconds"] + 60) \
        + 24 * 2 * 90 <= 43200
    assert len(json.dumps(bench)) <= 64 * 1024


def test_configs(bench):
    used = {c["config"] for c in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        body = json.load(open(os.path.join(ROOT, c["file"])))
        assert body["reduced"] == c["reduced"] == []


def test_cells(bench):
    names = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    seen = set()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= cells
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        reported = [m for m in bench["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in bench["per_layer"])


def test_every_file_is_found_by_name(bench):
    here = os.path.join(ROOT, "benchmark")
    for w in bench["workloads"]:
        run = harness.make_run(w["name"], 1, 1, False, 0.0, device="cpu")
        assert callable(harness.driver(run).run)
        assert os.path.isfile(os.path.join(here, "traffic",
                                           w["traffic"] + ".json"))
    for m in bench["per_layer"]:
        mod = harness.load_module(os.path.join(here, "metrics",
                                               m["name"] + ".py"), "m")
        assert mod.read({}) is None      # nothing to read: no number


def test_a_cell_and_a_metric_added_as_files(tmp_path):
    """A copy of the benchmark with one more cell (an existing driver, a
    new traffic file and workload file) and one more metric (a new
    reader): the harness runs the one and reads the other with no code
    changed."""
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = harness.spec()
    bench["workloads"].append({"name": "diff.complete_open",
                               "config": "lidiff_diff",
                               "traffic": "open_road", "chips": 1,
                               "why": "open road"})
    bench["per_layer"].append({"name": "scans_traced", "unit": "scans",
                               "better": "higher",
                               "source": "program_span",
                               "layer": "pipeline", "moves": "scan_s",
                               "workloads": ["diff.complete_open"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.load(open(os.path.join(
        ROOT, "benchmark", "traffic", "street_drive.json")))
    traffic["scene"]["street_half_width"] = [20.0, 30.0]
    (tmp_path / "benchmark" / "traffic" / "open_road.json").write_text(
        json.dumps(traffic))
    shutil.copy(os.path.join(ROOT, "benchmark", "workloads",
                             "diff.complete.json"),
                tmp_path / "benchmark" / "workloads"
                / "diff.complete_open.json")
    (tmp_path / "benchmark" / "metrics" / "scans_traced.py").write_text(
        "def read(layer):\n"
        "    t = layer.get('stage_times')\n"
        "    return float(len(t)) if t else None\n")
    run = harness.make_run("diff.complete_open", 3, 1, True, 0.0,
                           device="cpu", root=str(tmp_path))
    assert run.traffic["scene"]["street_half_width"] == [20.0, 30.0]
    assert run.workload["driver"] == "complete"
    out = types.SimpleNamespace(e2e={}, layer={"stage_times": [{}, {}]})
    got = harness.per_layer(run, out)
    assert got == {"scans_traced": {"value": 2.0, "unit": "scans"}}
