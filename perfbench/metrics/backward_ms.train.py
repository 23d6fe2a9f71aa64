"""Median device milliseconds of the train graph's ``step.backward`` spans
(each micro-batch's backward, summed), over the traced stretch's steps."""

import statistics


def read(ctx):
    if getattr(ctx, "kind", None) != "train":
        return None
    from autonomous_driving_with_diffusion_model_tpu_torch.utils import profiling

    report = getattr(profiling, "report", None)  # None: a program without spans
    if report is None:
        return None
    ms = [r["spans"]["step.backward"] for r in report()["device_spans"]
          if r["graph"] == "step" and "step.backward" in r["spans"]]
    return statistics.median(ms) if ms else None
