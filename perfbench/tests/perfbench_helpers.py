"""Shared by the benchmark's tests: runs of a cell on the CPU at a small
size, with the harness's look for a card skipped."""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# widths cut for the CPU; the networks keep their layers
TINY = {"MODEL.DIM": 16, "TRAIN.IMAGE_HEIGHT": 32, "TRAIN.IMAGE_WIDTH": 64, "EVAL.SAMPLE_STEPS": 3,
        "TRAIN.BATCH_SIZE": 4}
TINY_TRAFFIC = {"frames": 8, "check_plans": 6, "check_block": 4}


def run_tiny(workload: str, seed: int = 2**31 + 77, seconds: float = 0.3, overrides=None) -> dict:
    """A whole run of ``workload`` on the CPU at :data:`TINY`: the driver's
    record and the result line."""
    from perfbench import core
    from perfbench import run as run_module

    cell = core.load_cell(workload)
    cell.traffic.update(TINY_TRAFFIC)
    return run_module.execute(cell, seed, seconds, False, "cpu", time.perf_counter(), {**TINY, **(overrides or {})})
