"""The harness finds its files by name, and a run's line has the keys the
benchmark's contract names."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness, run
import _tiny

BENCH = harness.benchmark_json()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    wl = harness.workload(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert (wl["config"], wl["traffic"]) == (entry["config"],
                                             entry["traffic"])
    assert callable(harness.module("drivers", wl["driver"]).run)
    cfg = next(c for c in BENCH["configs"] if c["name"] == wl["config"])
    assert os.path.exists(os.path.join(harness.ROOT, cfg["file"]))
    assert wl["cfg"]["reduced"] == cfg["reduced"]
    for m in harness.metrics_of(cell, BENCH, traced=True):
        assert callable(harness.module("metrics", m["name"]).read)
    e2e = {m["name"] for m in harness.metrics_of(cell, BENCH, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_of(cell, BENCH, True)


def test_every_metric_moves_an_end_to_end_metric_of_its_cells():
    for m in BENCH["per_layer"]:
        e2e = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(e2e.get("workloads", m["workloads"]))


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", sorted(_tiny.SIZES))
def test_line_has_the_contracts_keys(cell, trace):
    line = _tiny.line(cell, trace=trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[:5] == keys and list(line)[-1] == "checks"
    assert ("breakdown" in line) == trace
    assert set(line) == set(keys) | {"checks"} | (
        {"breakdown"} if trace else set())
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if not trace:
        assert set(line["metrics"]) == {
            m["name"] for m in harness.metrics_of(cell, BENCH, False)}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_no_card_no_result(capsys):
    assert run.main(["--workload", "lego.lsa", "--seed", "1", "--seconds",
                     "1"]) != 0
    assert capsys.readouterr().out == ""


def test_no_result_beside_only_the_benchmark(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "lego.lsa",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
