"""The harness: finds a cell's configuration, traffic, limits and metric
readers by the names in ``BENCHMARK.json``, runs the traffic's driver and
assembles the result line.

Everything that belongs to one configuration, one traffic mix or one
metric is a file of its own, found by name:

* ``perfbench/configs/<config>.json``: the configuration as it is run
  (``cfg``, the whole option tree), with its source, ``reduced`` and
  ``assumed``;
* ``perfbench/traffic/<traffic>.json``: the mix's parameters; its ``kind``
  names the driver, ``perfbench/drivers/<kind>.py``, that runs it;
* ``perfbench/limits/<workload>.json``: the limit of each number the
  cell's correctness check compares, with the readings it was set from;
* ``perfbench/metrics/<metric>.py``: a ``read(ctx)`` that returns the
  metric from what the run recorded, or None where it finds nothing to
  read.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
PB = ROOT / "perfbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "autonomous_driving_with_diffusion_model_tpu")
PORT = "autonomous_driving_with_diffusion_model_tpu_torch"

__all__ = ["ROOT", "FORBIDDEN", "Cell", "load_cell", "metric_names", "read_metrics", "forbidden_modules",
           "build_cfg", "plain"]


def _load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell(SimpleNamespace):
    """One workload of the manifest: ``name``, ``workload`` (its entry),
    ``config`` (the configuration file's contents), ``traffic`` (the mix's
    parameters), ``limits`` and ``manifest``."""

    def driver(self) -> ModuleType:
        return _load_module(PB / "drivers" / f"{self.traffic['kind']}.py", f"perfbench_driver_{self.traffic['kind']}")


def load_cell(name: str) -> Cell:
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    workload = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if workload is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{', '.join(w['name'] for w in manifest['workloads'])}")
    entry = next(c for c in manifest["configs"] if c["name"] == workload["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((PB / "traffic" / f"{workload['traffic']}.json").read_text())
    limits_path = PB / "limits" / f"{name}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.exists() else {}
    return Cell(name=name, workload=workload, config=config, traffic=traffic, limits=limits, manifest=manifest)


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric["workloads"] if "workloads" in metric else True


def metric_names(cell: Cell, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones, or with
    ``trace`` the per-layer ones (those without a ``workloads`` key in
    every cell that reports the end-to-end metric they move)."""
    e2e = [m for m in cell.manifest["end_to_end"] if _applies(m, cell.name)]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in cell.manifest["per_layer"]
            if (cell.name in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def read_metrics(cell: Cell, ctx: SimpleNamespace, trace: bool) -> Dict[str, dict]:
    """Each metric's reader on ``ctx``; a metric whose reader finds
    nothing is left out."""
    out = {}
    for m in metric_names(cell, trace):
        reader = _load_module(PB / "metrics" / f"{m['name']}.py", "perfbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules(modules=None) -> List[str]:
    """The modules loaded whose top-level name (before the first dot) is
    JAX's, one of its libraries', or the JAX package's, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def plain(node):
    """A configuration tree as plain dicts and lists."""
    if isinstance(node, dict):
        return {k: plain(v) for k, v in node.items()}
    if isinstance(node, tuple):
        return [plain(v) for v in node]
    return node


def build_cfg(config: dict, overrides: Optional[Dict[str, object]] = None):
    """The program's configuration object holding ``config['cfg']``, then
    ``overrides`` (dotted keys, as ``--opts`` takes them)."""
    from autonomous_driving_with_diffusion_model_tpu_torch.utils.config import create_cfg

    cfg = create_cfg()
    cfg.merge_from_other_cfg(config["cfg"])
    for key, value in (overrides or {}).items():
        node = cfg
        *path, leaf = key.split(".")
        for part in path:
            node = node[part]
        if leaf not in node:
            raise KeyError(f"no configuration key {key}")
        node[leaf] = value
    return cfg
