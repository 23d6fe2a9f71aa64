#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from, on the card, at
the cell's own size, many seeds in one process:

    python3 perfbench/calibrate.py --workload <name> --seeds 11 12 ...

For every seed, the program's reading: a sound run's numbers, the
program's output against the plain reference (plans: a window of a second at
the cell's own load, as many plans checked as a run checks; training: the
checked iterations). For the first three seeds, the control's: the
reference computed in TF32 (the precision below the configuration's
float32 with TF32 off) in the program's place, against the float32
reference; and for training the planted half-batch fault's: the reference
with the loss over half of each batch, against the whole one. Prints one
JSON line and writes it to ``chiprun_out/calibrate/<name>.json``. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
CONTROL_SEEDS = 3


def _run(cell, seed: int, seconds: float, device, overrides=None):
    import torch

    from perfbench import core

    cfg = core.build_cfg(cell.config, overrides)
    return SimpleNamespace(cell=cell, cfg=cfg, cfgd=core.plain(cfg), seed=seed, seconds=seconds, trace=False,
                           device=torch.device(device), t_start=time.perf_counter(),
                           device_name=torch.cuda.get_device_name(device) if torch.device(device).type == "cuda"
                           else "cpu")


def plan_readings(cell, seeds, control: int, seconds: float, device, overrides=None) -> dict:
    import numpy as np

    from perfbench import check
    from perfbench.device import release

    drv = cell.driver()
    out = {"sound": [], "control": []}
    state = None
    for n, seed in enumerate(seeds):
        run = _run(cell, seed, seconds, device, overrides)
        state = drv.setup(run, state)
        rec = drv.window(state, seconds, min_plans=cell.traffic["check_plans"])
        pos = drv.sample(rec, cell.traffic["check_plans"], seed)
        requests = [rec.requests[p] for p in pos]
        prog = (np.stack([rec.outputs[p][0] for p in pos]), np.asarray([rec.outputs[p][1] for p in pos]))
        ref = drv.reference(run, state, requests)
        out["sound"].append({"seed": seed, **check.plan_gap(prog[0], prog[1], ref[0], ref[1])})
        if n < control:
            tf32 = drv.reference(run, state, requests, "tf32")
            out["control"].append({"seed": seed, **check.plan_gap(tf32[0], tf32[2], ref[0], ref[1])})
        release(device)
        print(f"calibrate {cell.name} seed {seed}: {out['sound'][-1]}"
              + (f" control {out['control'][-1]}" if n < control else ""), file=sys.stderr, flush=True)
    return out


def train_readings(cell, seeds, control: int, seconds: float, device, overrides=None) -> dict:
    import shutil
    import tempfile

    from perfbench import check
    from perfbench.device import release

    drv = cell.driver()
    out = {"sound": [], "control": [], "half_batch": []}
    for n, seed in enumerate(seeds):
        run = _run(cell, seed, seconds, device, overrides)
        root = tempfile.mkdtemp(prefix="perfbench_calibrate_")
        try:
            st = drv.setup(run, root)
            for name in ("state", "step", "augment", "loader", "data_iter", "model"):
                setattr(st, name, None)
            release(device)
            ref = drv.reference(run, st)
            out["sound"].append({"seed": seed, **check.train_gaps(st.prog, ref)})
            if n < control:
                out["control"].append({"seed": seed, **check.train_gaps(drv.reference(run, st, "tf32"), ref)})
                out["half_batch"].append({"seed": seed, **check.train_gaps(
                    drv.reference(run, st, half_batch=True), ref)})
        finally:
            shutil.rmtree(root, ignore_errors=True)
        del st
        release(device)
        print(f"calibrate {cell.name} seed {seed}: {out['sound'][-1]}"
              + (f" control {out['control'][-1]} half batch {out['half_batch'][-1]}" if n < control else ""),
              file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)

    from perfbench import core

    cell = core.load_cell(args.workload)
    kind = cell.traffic["kind"]
    read = plan_readings if kind == "closed_loop_plan" else train_readings
    t0 = time.perf_counter()
    readings = read(cell, args.seeds, CONTROL_SEEDS, 1.0, "cuda:0")
    result = {"workload": cell.name, "device": _run(cell, 0, 0, "cuda:0").device_name,
              "seconds": time.perf_counter() - t0, **readings}
    for key in [k for k in readings if readings[k]]:
        names = [k for k in readings[key][0] if k != "seed"]
        result.setdefault("summary", {})[key] = {
            k: {"min": min(r[k] for r in readings[key]), "max": max(r[k] for r in readings[key])} for k in names}
    line = json.dumps(result)
    print(line)
    out = ROOT / "chiprun_out" / "calibrate" / f"{cell.name}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
