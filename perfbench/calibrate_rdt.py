#!/usr/bin/env python3
"""The readings the ``rdt_1b-plan`` cell's limit is set from, on the card, at
the cell's own size, many seeds in one process:

    python3 perfbench/calibrate_rdt.py --seeds 11 12 ... [--lengths 8 16 ... 32]

For every seed, the sound reading: a window of a second at the cell's own
load, as many plans checked as a run checks, the program's plans against
the float32 reference's (``plan_gap`` and ``plan_rms_gap``). For the first three seeds, the
reference with each of ``perfbench/reference/rdt.py``'s planted variants
against the sound reference: ``float8`` (the precision below the
configuration's bfloat16) and the faults ``mask_ignored``,
``alternation_swapped`` and ``t_off_by_one``; and, for each of
``--lengths``, the ``mask_ignored`` fault against the sound reference with
the seed's instruction cut to that many valid tokens (the fault moves a
plan by what the mask hides, nothing at a full instruction). Prints one
JSON line and writes it to ``chiprun_out/calibrate/rdt_1b-plan.json``. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
CELL = "rdt_1b-plan"
CONTROL_SEEDS = 3
VARIANTS = ("float8", "mask_ignored", "alternation_swapped", "t_off_by_one")


def readings(seeds, seconds: float, device, overrides=None, traffic=None, lengths=()) -> dict:
    """The readings of ``seeds`` (``overrides`` and ``traffic``: changes to
    the configuration and the traffic, for a rehearsal at a small size;
    ``lengths``: the instruction's valid lengths of the mask sweep)."""
    import numpy as np

    from perfbench import calibrate, core
    from perfbench.device import release

    cell = core.load_cell(CELL)
    cell.traffic.update(traffic or {})
    drv = cell.driver()
    out = {"sound": [], **{v: [] for v in VARIANTS}, "mask_by_length": []}
    state = None
    for n, seed in enumerate(seeds):
        run = calibrate._run(cell, seed, seconds, device, overrides)
        state = drv.setup(run, state)
        rec = drv.window(state, seconds, min_plans=cell.traffic["check_plans"])
        pos = drv.sample(rec, cell.traffic["check_plans"], seed)
        requests = [rec.requests[p] for p in pos]
        prog = (np.stack([rec.outputs[p][0] for p in pos]), np.asarray([rec.outputs[p][1] for p in pos]))
        ref = drv.reference(run, state, requests)
        out["sound"].append({"seed": seed, "instruction_tokens": int(state.lang[1].sum()),
                             **drv.gaps(prog[0], prog[1], ref[0], ref[1])})
        line = f"calibrate {CELL} seed {seed}: sound {out['sound'][-1]}"
        if n < CONTROL_SEEDS:
            gots = {}
            for v in VARIANTS:
                got = gots[v] = drv.reference(run, state, requests, variant=v)
                out[v].append({"seed": seed, **drv.gaps(got[0], got[2], ref[0], ref[1])})
                line += f" {v} {out[v][-1]['plan_gap']:.4g} (rms {out[v][-1]['plan_rms_gap']:.4g})"
            tokens, mask = state.lang
            got = gots["mask_ignored"]  # it attends to every slot, whatever the valid length
            for length in lengths:
                state.lang = (tokens, np.arange(len(mask)) < length)
                ref_l = drv.reference(run, state, requests)
                out["mask_by_length"].append({"seed": seed, "valid": int(length),
                                              **drv.gaps(got[0], got[2], ref_l[0], ref_l[1])})
                line += f" mask@{length} {out['mask_by_length'][-1]['plan_rms_gap']:.4g}"
            state.lang = (tokens, mask)
        release(device)
        print(line, file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--lengths", type=int, nargs="*", default=[],
                   help="the instruction's valid lengths of the mask fault's sweep, on the first three seeds")
    args = p.parse_args(argv)
    import torch

    t0 = time.perf_counter()
    got = readings(args.seeds, 1.0, "cuda:0", lengths=args.lengths)
    result = {"workload": CELL, "device": torch.cuda.get_device_name(0), "seconds": time.perf_counter() - t0, **got,
              "summary": {k: {n: {"min": min(r[n] for r in v), "max": max(r[n] for r in v)}
                              for n in ("plan_gap", "plan_rms_gap")}
                          for k, v in got.items() if v and k != "mask_by_length"}}
    line = json.dumps(result)
    print(line)
    out = ROOT / "chiprun_out" / "calibrate" / f"{CELL}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
