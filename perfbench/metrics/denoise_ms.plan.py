"""Median device milliseconds of the plan graph's ``plan.denoise`` span (the
sampler: every step's U-Net forward, the guidance's combine and the
update), over the traced stretch's plans."""

import statistics


def read(ctx):
    if getattr(ctx, "kind", None) != "plan":
        return None
    from autonomous_driving_with_diffusion_model_tpu_torch.utils import profiling

    report = getattr(profiling, "report", None)  # None: a program without spans
    if report is None:
        return None
    ms = [r["spans"]["plan.denoise"] for r in report()["device_spans"]
          if r["graph"] == "plan" and "plan.denoise" in r["spans"]]
    return statistics.median(ms) if ms else None
