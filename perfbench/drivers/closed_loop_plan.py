"""Traffic kind ``closed_loop_plan``: one agent plans in a closed loop, as
``InteractAgent.compute_control`` calls the planner in sequential mode: the
next plan starts when the last one has returned.

A request is a host uint8 frame (one of ``frames`` made from the seed,
cycled) and a target point (one per request, from the seed). A plan is
timed on the host clock from handing both to the planner until its
trajectories are on the host: ``plan_begin`` (the inputs copied into the
plan program's buffers, the replay queued), then the copy back of all K
hypotheses and the chosen index, which is what ``DiffusionPlanner.plan``
does before it indexes the best. ``plan_begin``'s own host time is kept
beside it.

Parameters (the traffic file): ``frames``, ``targets`` (distinct target
points, cycled), ``warm_plans`` and ``warm_seconds`` (before the window;
the first plan builds the plan program), ``check_plans`` (the window's
plans the reference recomputes, drawn from the seed, the first and the
last among them), ``check_block`` (plans the reference computes at once)
and ``profile_seconds`` / ``profile_min_plans`` (the traced stretch). The warm
plans run for ``warm_seconds`` at least: the first seconds of a process's
replays often run up to 8% slower than later ones, and the warm plans keep
most of them out of the window.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from perfbench import check, inputs, trace, work
from perfbench.device import peak_bytes, release, sync
from perfbench.reference.models import build_reference
from perfbench.reference.planner import plan_batch, precision
from perfbench.weights import make_state_dict

__all__ = ["setup", "window", "sample", "reference", "run"]


def _free(d: dict) -> bool:
    return d["GUIDANCE"]["USE_COND"] == "FREE_GUIDANCE"


def setup(run, state=None) -> SimpleNamespace:
    """The planner with the seed's weights, the requests, and the plan
    program built by the warm plans. ``state`` (an earlier setup's) keeps
    its planner and loads the new weights into it."""
    from autonomous_driving_with_diffusion_model_tpu_torch.driving.plan import DiffusionPlanner
    from autonomous_driving_with_diffusion_model_tpu_torch.ops import build, kernels

    d, dev, traffic = run.cfgd, run.device, run.cell.traffic
    marks = [("start", time.perf_counter())]
    template = build_reference(d["MODEL"], _free(d), "meta").state_dict()
    sd = make_state_dict(template, inputs.stream_seed(run.seed, "weights"), dev)
    sync(dev)
    marks.append(("weights", time.perf_counter()))
    planner = state.planner if state is not None else DiffusionPlanner(run.cfg, seed=0, device=dev)
    planner.model.load_state_dict(sd, strict=True)
    planner.init_trajs = inputs.init_trajs(run.seed, planner.init_trajs.shape).to(dev)
    marks.append(("planner", time.perf_counter()))
    frames = inputs.frames(run.seed, traffic["frames"], d["TRAIN"]["IMAGE_HEIGHT"], d["TRAIN"]["IMAGE_WIDTH"], dev)
    targets = inputs.targets(run.seed, traffic["targets"])
    marks.append(("inputs", time.perf_counter()))
    if torch.device(dev).type == "cuda":
        build.library(kernels.SOURCE)
        build.library(kernels.HEAD_SOURCE)
    marks.append(("library", time.perf_counter()))
    t0, i = time.perf_counter(), 0
    while i < traffic["warm_plans"] or time.perf_counter() - t0 < traffic["warm_seconds"]:
        trajs, best = planner.plan_begin(frames[i % len(frames)], targets[-1 - i % len(targets)])
        trajs.cpu(), int(best)
        i += 1
    marks.append(("warm_plans", time.perf_counter()))
    prog = planner._program.programs.get(planner._program.key)
    parts = {b[0]: round(b[1] - a[1], 4) for a, b in zip(marks, marks[1:])}
    parts.update(program_warm_s=round(getattr(prog, "warm_s", 0.0), 4),
                 program_capture_s=round(getattr(prog, "capture_s", 0.0), 4))
    return SimpleNamespace(planner=planner, sd=sd, frames=frames, targets=targets,
                           init=planner.init_trajs.detach().clone(), parts=parts, next_request=0)


def window(state, seconds: float, min_plans: int = 1) -> SimpleNamespace:
    """Closed-loop plans until ``seconds`` have passed since the first and
    at least ``min_plans`` were made: ``start``, ``end``, and per plan its
    request, its output, its latency and ``plan_begin``'s host time."""
    rec = SimpleNamespace(requests=[], outputs=[], latency_s=[], host_s=[])
    planner, frames, targets = state.planner, state.frames, state.targets
    rec.start = rec.end = time.perf_counter()
    while len(rec.latency_s) < min_plans or time.perf_counter() - rec.start < seconds:
        t0 = time.perf_counter()
        i = state.next_request
        trajs, best = planner.plan_begin(frames[i % len(frames)], targets[i % len(targets)])
        t1 = time.perf_counter()
        out = (trajs.cpu().numpy(), int(best))
        rec.end = time.perf_counter()
        rec.requests.append(i)
        rec.outputs.append(out)
        rec.latency_s.append(rec.end - t0)
        rec.host_s.append(t1 - t0)
        state.next_request += 1
    return rec


def sample(rec, n: int, seed: int) -> np.ndarray:
    """Up to ``n`` positions of the window's plans, drawn from ``seed``,
    the first and the last among them."""
    total = len(rec.requests)
    if total <= n:
        return np.arange(total)
    rng = np.random.default_rng(inputs.stream_seed(seed, "check"))
    middle = rng.choice(np.arange(1, total - 1), n - 2, replace=False)
    return np.sort(np.concatenate([[0, total - 1], middle]))


def reference(run, state, requests, kind: str = "float32"):
    """The plain reference's (trajectories, scores, best) of ``requests``
    in ``kind`` precision (``float32``, or ``tf32`` for the control)."""
    d, dev, block = run.cfgd, run.device, run.cell.traffic["check_block"]
    model = build_reference(d["MODEL"], _free(d), dev)
    model.load_state_dict(state.sd, strict=True)
    outs = []
    with precision(kind):
        for lo in range(0, len(requests), block):
            idx = np.asarray(requests[lo:lo + block])
            fr = torch.from_numpy(state.frames[idx % len(state.frames)]).to(dev)
            tg = torch.from_numpy(state.targets[idx % len(state.targets)]).to(dev)
            outs.append([a.cpu().numpy() for a in plan_batch(model, d, fr, tg, state.init.to(dev))])
    del model
    return tuple(np.concatenate(parts) for parts in zip(*outs))


def run(run) -> dict:
    """A run of the cell: set-up, the window, the traced stretch where
    ``run.trace``, then the reference over a sample of the window's plans."""
    traffic, dev = run.cell.traffic, run.device
    state = setup(run)
    rec = window(state, run.seconds)
    setup_s = rec.start - run.t_start
    profiled = None
    if run.trace:
        def stretch():
            rec = window(state, traffic["profile_seconds"], traffic["profile_min_plans"])
            return len(rec.requests)
        profiled = trace.profile(stretch, dev)
    peak = peak_bytes(dev)
    pos = sample(rec, traffic["check_plans"], run.seed)
    requests = [rec.requests[p] for p in pos]
    prog_trajs = np.stack([rec.outputs[p][0] for p in pos])
    prog_best = np.asarray([rec.outputs[p][1] for p in pos])
    failed = sum(not np.isfinite(t).all() for t, _ in rec.outputs)
    state.planner = None  # the program's state goes before the reference runs
    release(dev)
    t_ref = time.perf_counter()
    ref_trajs, ref_scores, _ = reference(run, state, requests)
    reference_s = time.perf_counter() - t_ref
    numbers = check.plan_gap(prog_trajs, prog_best, ref_trajs, ref_scores)
    rates = work.card_rates(run.device_name)
    # the work counts serve the per-layer readers only (a first count on the
    # meta device loads parts of torch for seconds)
    ctx = SimpleNamespace(kind="plan", cfg=run.cfgd, rates=rates,
                          work=work.plan_work(run.cfgd, rates) if run.trace else None,
                          setup_s=setup_s, window_s=rec.end - rec.start, units=len(rec.requests),
                          latency_s=rec.latency_s, host_s=rec.host_s, trace=profiled)
    return {"ctx": ctx, "attempted": len(rec.requests), "failed": int(failed), "numbers": numbers,
            "memory_peak_bytes": peak, "setup_parts": state.parts, "reference_s": reference_s,
            "checked": len(requests)}
