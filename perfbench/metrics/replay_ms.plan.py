"""Median device milliseconds of a plan graph's replay, from its first
marker to its last (``utils/profiling.py``'s device spans: the device's ns
timer, written by the markers the graph holds), over the traced stretch's
plans."""

import statistics


def read(ctx):
    if getattr(ctx, "kind", None) != "plan":
        return None
    from autonomous_driving_with_diffusion_model_tpu_torch.utils import profiling

    report = getattr(profiling, "report", None)  # None: a program without spans
    if report is None:
        return None
    ms = [r["replay_ms"] for r in report()["device_spans"] if r["graph"] == "plan"]
    return statistics.median(ms) if ms else None
