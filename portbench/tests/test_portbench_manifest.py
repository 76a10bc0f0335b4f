"""BENCHMARK.json against the benchmark's contract, and the lookup by name
that lets a later change add a configuration, a traffic mix, a cell or a
per-layer metric with new files and new entries only."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys_and_paths():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "portbench/run.py"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in M["paths"])
    assert 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) <= 64 * 1024


def test_names_units_and_keys():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in M[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in M[k]}) == len(M[k])
    metric_names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in M["end_to_end"]}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in M["end_to_end"]}


def test_every_named_file_exists():
    for c in M["configs"]:
        assert c["file"].startswith("portbench/configs/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == \
            c["name"]
        assert all(NAME.match(k) for k in c["reduced"])
    for w in M["workloads"]:
        assert (ROOT / "portbench" / "traffic"
                / f"{w['traffic']}.json").exists()
        assert (ROOT / "portbench" / "limits" / f"{w['name']}.json").exists()
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in M["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("w", [w["name"] for w in M["workloads"]])
def test_each_cell_reports_setup_another_end_to_end_and_a_layer(w):
    from portbench import run
    e2e = run.metric_names(M, w, False)
    assert "setup_s" in e2e and len(e2e) >= 2
    assert run.metric_names(M, w, True)


def test_a_full_check_fits_with_24_cells():
    rs = M["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_no_benchmark_file_is_hidden_by_gitignore():
    """The repository ignores _*.py: the benchmark's files never start
    with an underscore, except package markers."""
    for p in (ROOT / "portbench").rglob("*.py"):
        assert not p.name.startswith("_") or p.name in ("__init__.py",
                                                        "__main__.py")
