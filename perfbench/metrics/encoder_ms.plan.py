"""Median device milliseconds of the plan graph's ``plan.encode`` span (the
frame's normalization and the ResNet encoder, once a plan under
``TPU.HOIST_PERCEPTION``), over the traced stretch's plans."""

import statistics


def read(ctx):
    if getattr(ctx, "kind", None) != "plan":
        return None
    from autonomous_driving_with_diffusion_model_tpu_torch.utils import profiling

    report = getattr(profiling, "report", None)  # None: a program without spans
    if report is None:
        return None
    ms = [r["spans"]["plan.encode"] for r in report()["device_spans"]
          if r["graph"] == "plan" and "plan.encode" in r["spans"]]
    return statistics.median(ms) if ms else None
