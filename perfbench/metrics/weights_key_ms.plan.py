"""Median host milliseconds of ``plan.weights_key``, the plan program's walk
over every parameter and buffer before each plan (``driving/program.py:
weights_key``, a host span), over the traced stretch's plans."""

import statistics


def read(ctx):
    if getattr(ctx, "kind", None) != "plan":
        return None
    from autonomous_driving_with_diffusion_model_tpu_torch.utils import profiling

    report = getattr(profiling, "report", None)  # None: a program without spans
    if report is None:
        return None
    ms = [(s["end_ns"] - s["start_ns"]) / 1e6 for s in report()["spans"] if s["name"] == "plan.weights_key"]
    return statistics.median(ms) if ms else None
