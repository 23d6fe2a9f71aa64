"""Median device milliseconds of the train graph's ``step.optimizer`` span
(the gradients' averaging and scrub, AdamW and the EMA), over the traced
stretch's steps."""

import statistics


def read(ctx):
    if getattr(ctx, "kind", None) != "train":
        return None
    from autonomous_driving_with_diffusion_model_tpu_torch.utils import profiling

    report = getattr(profiling, "report", None)  # None: a program without spans
    if report is None:
        return None
    ms = [r["spans"]["step.optimizer"] for r in report()["device_spans"]
          if r["graph"] == "step" and "step.optimizer" in r["spans"]]
    return statistics.median(ms) if ms else None
