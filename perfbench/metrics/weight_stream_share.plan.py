"""The share of the card's memory bandwidth the plan graph's denoising
streams as weights: a plan's residual-block weight bytes (``ctx.work``'s
``weight_bytes``, counted from the configuration's shapes) over each
replay's ``plan.denoise`` device time, over the data sheet's bytes/s; the
median over the traced stretch's plans."""

import statistics


def read(ctx):
    work = getattr(ctx, "work", None)
    if getattr(ctx, "kind", None) != "plan" or not work or not work.get("weight_bytes"):
        return None
    from autonomous_driving_with_diffusion_model_tpu_torch.utils import profiling

    report = getattr(profiling, "report", None)  # None: a program without spans
    if report is None:
        return None
    shares = [100.0 * work["weight_bytes"] / (r["spans"]["plan.denoise"] / 1e3) / ctx.rates["bytes_s"]
              for r in report()["device_spans"] if r["graph"] == "plan" and r["spans"].get("plan.denoise")]
    return statistics.median(shares) if shares else None
