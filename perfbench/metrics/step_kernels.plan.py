"""Kernels a denoising step launches inside the plan graph: the kernel
nodes of its ``plan.denoise`` span, counted once at capture from the
captured graph, over the sampler's steps; the median over the traced
stretch's plans (each read from the graph it replayed)."""

import statistics


def read(ctx):
    if getattr(ctx, "kind", None) != "plan":
        return None
    from autonomous_driving_with_diffusion_model_tpu_torch.utils import profiling

    report = getattr(profiling, "report", None)  # None: a program without spans
    if report is None:
        return None
    rep = report()
    graphs = {g["id"]: g for g in rep["graphs"]}
    per_step = []
    for r in rep["device_spans"]:
        g = graphs.get(r["graph_id"])
        if r["graph"] != "plan" or g is None or not g["kernels"] or not g["attrs"].get("steps"):
            continue
        if "plan.denoise" in g["kernels"]:
            per_step.append(g["kernels"]["plan.denoise"] / g["attrs"]["steps"])
    return statistics.median(per_step) if per_step else None
