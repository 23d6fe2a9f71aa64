#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA planner on an NVIDIA GPU.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the root of a checkout: set-up
(weights and inputs made from the seed, the program built and warmed), a
measured window of ``--seconds``, with ``--trace 1`` a profiled stretch
after it, then the plain reference over what the window produced. The last
line of standard output is the result: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device`` and, last, ``checks``: each number the
correctness check compares, with its limit. Standard error ends with the
same numbers, one a line.

It exits with a code other than 0 and prints no result where there is no
CUDA device or fewer than the cell asks for, where the program cannot be
imported, or where JAX, one of its libraries or the JAX package was loaded
by the time the window closed. Build and kernel caches stay inside the
checkout (``build/``).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
sys.path.insert(0, str(ROOT))


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def execute(cell, seed: int, seconds: float, trace: bool, device, t_start: float, overrides=None) -> dict:
    """A run of ``cell`` on ``device``: the driver's record and the result
    line's fields (without the card's checks, which ``main`` makes)."""
    import torch

    from perfbench import check, core

    cfg = core.build_cfg(cell.config, overrides)
    run = SimpleNamespace(cell=cell, cfg=cfg, cfgd=core.plain(cfg), seed=seed, seconds=seconds, trace=trace,
                          device=torch.device(device), t_start=t_start,
                          device_name=torch.cuda.get_device_name(device) if torch.device(device).type == "cuda"
                          else "cpu")
    out = cell.driver().run(run)
    rows = check.judge(out["numbers"], cell.limits)
    metrics = core.read_metrics(cell, out["ctx"], trace)
    result = {"correct": bool(rows) and all(r["ok"] for r in rows) and out["failed"] == 0,
              "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
              "device": {"platform": "gpu", "kind": run.device_name, "count": 1,
                         "memory_peak_bytes": out["memory_peak_bytes"]}}
    tr = out["ctx"].trace
    if trace and tr is not None:
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["wall_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    return {"result": result, "rows": rows, "out": out}


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from perfbench import core

    cell = core.load_cell(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"perfbench: {args.workload} needs {chips} CUDA device(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 2
    done = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    found = core.forbidden_modules()
    if found:
        log(f"perfbench: loaded by the time the window closed, and not allowed: {', '.join(found)}: no result")
        return 3
    result, rows, out = done["result"], done["rows"], done["out"]
    result["card"] = _power_limit()
    result["checks"] = {r["name"]: {"value": r["value"], "limit": r["limit"]} for r in rows}
    log("perfbench: set-up parts (s): " + json.dumps(out["setup_parts"]))
    log(f"perfbench: reference over {out['checked']} of the window's {out['attempted']} took "
        f"{out['reference_s']:.2f} s; other readings: "
        + json.dumps({k: v for k, v in out["numbers"].items() if k not in result["checks"]}))
    print(json.dumps(result), flush=True)
    for r in rows:
        log(f"check {r['name']} = {r['value']:.6g} (limit {r['limit']:.6g}) {'ok' if r['ok'] else 'FAIL'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
