"""The roofline bound of RDT-1B's denoising (``ctx.work``'s ``dit_bound_s``,
counted from the configuration's shapes by ``perfbench/work_rdt.py``: the
solver's forwards, each operation's larger of operations over the bfloat16
peak and bytes over the memory bandwidth, each condition's keys and values
once a plan) over each replay's ``plan.denoise`` device time; the median
over the traced stretch's plans."""

import statistics


def read(ctx):
    work = getattr(ctx, "work", None)
    if getattr(ctx, "kind", None) != "plan" or not work or not work.get("dit_bound_s"):
        return None
    from autonomous_driving_with_diffusion_model_tpu_torch.utils import profiling

    report = getattr(profiling, "report", None)  # None: a program without spans
    if report is None:
        return None
    shares = [100.0 * work["dit_bound_s"] / (r["spans"]["plan.denoise"] / 1e3)
              for r in report()["device_spans"] if r["graph"] == "plan" and r["spans"].get("plan.denoise")]
    return statistics.median(shares) if shares else None
