"""``BENCHMARK.json`` keeps to its contract, the harness finds every file a
cell names, and a run on a machine without a card gives no result."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest

import perfbench_helpers  # noqa: F401
from perfbench import core

MANIFEST = json.loads((core.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"][:2] == ["python3", "perfbench/run.py"] and len(MANIFEST["command"]) <= 32
    assert MANIFEST["paths"] == ["perfbench"]
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its budget
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic")) and _line(w["why"])
        assert w["chips"] == 1
        names.append(w["name"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock") and _line(m["layer"])
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" and "workloads" not in m and m["bound"] <= 0.25 for m in MANIFEST["end_to_end"])
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("workload", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_files_are_found_by_name(workload):
    cell = core.load_cell(workload)
    entry = next(c for c in MANIFEST["configs"] if c["name"] == cell.workload["config"])
    assert entry["file"].startswith("perfbench/configs/") and cell.config["source"] == entry["source"]
    assert cell.config["reduced"] == entry["reduced"]
    assert (core.PB / "drivers" / f"{cell.traffic['kind']}.py").exists()
    assert cell.limits, "the cell has no correctness limits"
    e2e = core.metric_names(cell, trace=False)
    per_layer = core.metric_names(cell, trace=True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per_layer
    for m in e2e + per_layer:
        assert (core.PB / "metrics" / f"{m['name']}.py").exists(), m["name"]
    # every per-layer metric moves an end-to-end metric that the cell reports
    assert {m["moves"] for m in per_layer} <= {m["name"] for m in e2e}


def test_every_config_and_metric_is_used():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert set(m.get("workloads", [])) <= {w["name"] for w in MANIFEST["workloads"]}


def _no_result(cwd):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", MANIFEST["workloads"][0]["name"],
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=cwd, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.strip().startswith("{")], out.stdout


def test_no_card_no_result():
    """Here there is no CUDA device: the run fails and falls back to no
    CPU run (a card test of the same command is the benchmark itself)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present; the benchmark's own runs cover this path")
    _no_result(core.ROOT)


def test_no_program_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files."""
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(core.PB, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    _no_result(tmp_path)
