"""Experiment tracking (the port's copy of the JAX package's
``utils/tracker.py``; aim-tracker equivalent, reference: train.py:121,280).

The reference logs metrics through accelerate's aim integration; this is a
dependency-free JSONL tracker with the same role: one ``{"step", "time",
**metrics}`` line per log call, written under ``{run_dir}/metrics.jsonl`` and
greppable/plottable offline.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

__all__ = ["Tracker"]


class Tracker:
    def __init__(self, run_dir: str, run_name: str = "run", enabled: bool = True):
        self.enabled = enabled
        self.path = os.path.join(run_dir, "metrics.jsonl")
        if enabled:
            os.makedirs(run_dir, exist_ok=True)
            with open(self.path, "a") as f:
                f.write(
                    json.dumps({"event": "run_start", "run": run_name, "time": time.time()})
                    + "\n"
                )

    def log(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        if not self.enabled:
            return
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
