"""Traffic kind ``closed_loop_plan_history``: one agent plans in a closed
loop, as ``closed_loop_plan`` does, with a planner that conditions each
plan on an observation history (``MODEL.N_OBS_STEPS`` (frame, target)
pairs; Diffusion Policy's CNN, ``MODEL.ARCH`` ``conditional_unet1d``).

A request is a host uint8 frame (one of ``frames`` made from the seed,
cycled) and a target point (one per request, from the seed). The planner
keeps the history; the driver keeps its own account of what it sent, so
that the reference recomputes every checked plan from its exact history:
the requests before it since the history began (the first padded with
copies of itself, as Diffusion Policy's env runner pads), and the plan's
own init draw and step noise, which the planner draws fresh every plan from
its CPU generator, seeded from the run's seed, and which the driver records
as they are drawn. Timing is ``closed_loop_plan``'s: from handing the
request to ``plan_begin`` until the trajectories and the choice are on the
host.

Parameters (the traffic file): ``closed_loop_plan``'s.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from perfbench import check, inputs, trace, work, work_diffusion_policy
from perfbench.device import peak_bytes, release, sync
from perfbench.reference.diffusion_policy import build_reference, plan_batch
from perfbench.reference.planner import precision
from perfbench.weights import make_state_dict

__all__ = ["setup", "window", "sample", "reference", "run"]


def _recorded_draws(planner) -> list:
    """Record every (init, step noise) draw the planner makes, in order."""
    draws, draw = [], planner._draw

    def recording(shape):
        out = draw(shape)
        draws.append(out)
        return out

    planner._draw = recording
    return draws


def _send(state, frame: int, target: int):
    """One plan of the request (frame, target): its handle, its history
    (oldest first, of (frame, target) indices) and the index of its draws."""
    prev = state.sent or [(frame, target)] * state.n_obs  # the first pads with copies of itself
    state.sent = (prev + [(frame, target)])[-state.n_obs:]
    at = len(state.draws)
    handle = state.planner.plan_begin(state.frames[frame], state.targets[target])
    return handle, tuple(state.sent), at


def setup(run, state=None) -> SimpleNamespace:
    """The planner with the seed's weights, draws and requests, and the plan
    program built by the warm plans. ``state`` (an earlier setup's) keeps
    its planner: new weights, a new generator seed, an empty history."""
    from autonomous_driving_with_diffusion_model_tpu_torch.driving.plan import DiffusionPlanner
    from autonomous_driving_with_diffusion_model_tpu_torch.ops import build, kernels

    d, dev, traffic = run.cfgd, run.device, run.cell.traffic
    marks = [("start", time.perf_counter())]
    template = build_reference(d["MODEL"], "meta").state_dict()
    sd = make_state_dict(template, inputs.stream_seed(run.seed, "weights"), dev)
    sync(dev)
    marks.append(("weights", time.perf_counter()))
    if state is None:
        planner = DiffusionPlanner(run.cfg, seed=0, device=dev)
        draws = _recorded_draws(planner)
    else:
        planner, draws = state.planner, state.draws
        draws.clear()
    planner.model.load_state_dict(sd, strict=True)
    planner._generator.manual_seed(inputs.stream_seed(run.seed, "init"))
    planner.reset_history()
    marks.append(("planner", time.perf_counter()))
    frames = inputs.frames(run.seed, traffic["frames"], d["TRAIN"]["IMAGE_HEIGHT"], d["TRAIN"]["IMAGE_WIDTH"], dev)
    targets = inputs.targets(run.seed, traffic["targets"])
    marks.append(("inputs", time.perf_counter()))
    if torch.device(dev).type == "cuda":
        build.library(kernels.SOURCE)
        build.library(kernels.HEAD_SOURCE)
    marks.append(("library", time.perf_counter()))
    st = SimpleNamespace(planner=planner, sd=sd, frames=frames, targets=targets, draws=draws, sent=None,
                         n_obs=int(d["MODEL"]["N_OBS_STEPS"]), next_request=0)
    t0, i = time.perf_counter(), 0
    while i < traffic["warm_plans"] or time.perf_counter() - t0 < traffic["warm_seconds"]:
        (trajs, best), _, _ = _send(st, i % len(frames), (-1 - i) % len(targets))
        trajs.cpu(), int(best)
        i += 1
    marks.append(("warm_plans", time.perf_counter()))
    prog = planner._program.programs.get(planner._program.key)
    st.parts = {b[0]: round(b[1] - a[1], 4) for a, b in zip(marks, marks[1:])}
    st.parts.update(program_warm_s=round(getattr(prog, "warm_s", 0.0), 4),
                    program_capture_s=round(getattr(prog, "capture_s", 0.0), 4))
    return st


def window(state, seconds: float, min_plans: int = 1) -> SimpleNamespace:
    """Closed-loop plans until ``seconds`` have passed since the first and
    at least ``min_plans`` were made: ``start``, ``end``, and per plan its
    request (its history and the index of its draws), its output, its
    latency and ``plan_begin``'s host time."""
    rec = SimpleNamespace(requests=[], outputs=[], latency_s=[], host_s=[])
    rec.start = rec.end = time.perf_counter()
    while len(rec.latency_s) < min_plans or time.perf_counter() - rec.start < seconds:
        t0 = time.perf_counter()
        i = state.next_request
        (trajs, best), history, at = _send(state, i % len(state.frames), i % len(state.targets))
        t1 = time.perf_counter()
        out = (trajs.cpu().numpy(), int(best))
        rec.end = time.perf_counter()
        rec.requests.append((history, at))
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
    model = build_reference(d["MODEL"], dev)
    model.load_state_dict(state.sd, strict=True)
    outs = []
    with precision(kind):
        for lo in range(0, len(requests), block):
            part = requests[lo:lo + block]
            fr = torch.from_numpy(np.stack([state.frames[[f for f, _ in h]] for h, _ in part])).to(dev)
            tg = torch.from_numpy(np.stack([state.targets[[t for _, t in h]] for h, _ in part])).to(dev)
            init = torch.stack([state.draws[at][0] for _, at in part]).to(dev)
            noise = torch.stack([state.draws[at][1] for _, at in part]).to(dev)
            outs.append([a.cpu().numpy() for a in plan_batch(model, d, fr, tg, init, noise)])
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
    ctx = SimpleNamespace(kind="plan", cfg=run.cfgd, rates=rates,
                          work=work_diffusion_policy.plan_work(run.cfgd, rates) if run.trace else None,
                          setup_s=setup_s, window_s=rec.end - rec.start, units=len(rec.requests),
                          latency_s=rec.latency_s, host_s=rec.host_s, trace=profiled)
    return {"ctx": ctx, "attempted": len(rec.requests), "failed": int(failed), "numbers": numbers,
            "memory_peak_bytes": peak, "setup_parts": state.parts, "reference_s": reference_s,
            "checked": len(requests)}
