"""Median device milliseconds of the augmentation graph's replay, its one
device span ``augment`` (the draws and copies before it are host work),
over the traced stretch's steps."""

import statistics


def read(ctx):
    if getattr(ctx, "kind", None) != "train":
        return None
    from autonomous_driving_with_diffusion_model_tpu_torch.utils import profiling

    report = getattr(profiling, "report", None)  # None: a program without spans
    if report is None:
        return None
    ms = [r["spans"]["augment"] for r in report()["device_spans"]
          if r["graph"] == "augment" and "augment" in r["spans"]]
    return statistics.median(ms) if ms else None
