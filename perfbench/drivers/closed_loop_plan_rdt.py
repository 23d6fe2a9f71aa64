"""Traffic kind ``closed_loop_plan_rdt``: one agent plans in a closed loop
with RDT-1B (``MODEL.ARCH`` ``rdt``), as ``closed_loop_plan_history`` does:
each plan conditions on the last ``MODEL.N_OBS_STEPS`` frames (RDT's image
history; the first plan of the history padded with copies of its own frame)
and the newest request's target point, under one instruction for the whole
run.

The instruction stands in for a T5-v1.1-XXL embedding: ``LANG_SLOTS``
tokens at ``LANG_DIM`` wide, standard normal from the seed, the first
``instruction_min`` to ``instruction_max`` of them valid (the length drawn
from the seed), the rest padding the mask hides. The planner draws each
plan's initial noise fresh from its CPU generator, seeded from the run's
seed; the driver records every draw, so the reference recomputes each
checked plan from its exact history, instruction and draw. Timing, the
window, the sample of checked plans and the traced stretch are
``closed_loop_plan_history``'s.

Weights come from ``perfbench/weights_rdt.py``: each a bfloat16 value,
loaded into the program's bfloat16 model and given to the float32 reference
as they are.

Parameters (the traffic file): ``closed_loop_plan``'s, and
``instruction_min`` / ``instruction_max``.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from perfbench import check, inputs, trace, work, work_rdt
from perfbench.device import peak_bytes, release, sync
from perfbench.drivers.closed_loop_plan_history import _recorded_draws, _send, sample, window
from perfbench.reference.planner import precision
from perfbench.reference.rdt import MAGIC_NUM, build_reference, plan_batch
from perfbench.weights_rdt import make_state_dict

__all__ = ["instruction", "gaps", "setup", "window", "sample", "reference", "run"]

INSTRUCTION_STREAM = 22  # the instruction's stream of the run's seed (inputs.py's tags are 1-9)


def instruction(seed: int, slots: int, dim: int, lo: int, hi: int):
    """(tokens (slots, dim) float32, mask (slots,) bool) of the run's
    instruction: the first ``lo`` to ``hi`` tokens valid."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), INSTRUCTION_STREAM]))
    valid = int(rng.integers(lo, hi + 1))
    return rng.standard_normal((slots, dim)).astype(np.float32), np.arange(slots) < valid


def gaps(prog_trajs, prog_best, ref_trajs, ref_scores) -> dict:
    """``check.plan_gap``'s numbers, and ``plan_rms_gap``: the root mean
    square of the element gaps in the same units (xy over 23.315 m), which
    weighs a change of every plan above one element's rounding."""
    d = np.asarray(prog_trajs, np.float64) - np.asarray(ref_trajs, np.float64)
    d[..., :2] /= MAGIC_NUM
    return {**check.plan_gap(prog_trajs, prog_best, ref_trajs, ref_scores),
            "plan_rms_gap": float(np.sqrt(np.mean(d * d)))}


def setup(run, state=None) -> SimpleNamespace:
    """The planner with the seed's weights, draws, instruction and requests,
    and the plan program built by the warm plans. ``state`` (an earlier
    setup's) keeps its planner: new weights, a new generator seed, a new
    instruction, an empty history."""
    from autonomous_driving_with_diffusion_model_tpu_torch.driving.plan import DiffusionPlanner
    from autonomous_driving_with_diffusion_model_tpu_torch.ops import build
    from autonomous_driving_with_diffusion_model_tpu_torch.utils import profiling

    d, dev, traffic = run.cfgd, run.device, run.cell.traffic
    r = d["MODEL"]["RDT"]
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
    lang = instruction(run.seed, r["LANG_SLOTS"], r["LANG_DIM"], traffic["instruction_min"],
                       traffic["instruction_max"])
    planner.reset_history(instruction=lang)
    marks.append(("planner", time.perf_counter()))
    frames = inputs.frames(run.seed, traffic["frames"], d["TRAIN"]["IMAGE_HEIGHT"], d["TRAIN"]["IMAGE_WIDTH"], dev)
    targets = inputs.targets(run.seed, traffic["targets"])
    marks.append(("inputs", time.perf_counter()))
    if torch.device(dev).type == "cuda":
        build.library(profiling.STAMP_SOURCE)  # the device spans' markers, which the capture launches
    marks.append(("library", time.perf_counter()))
    st = SimpleNamespace(planner=planner, sd=sd, frames=frames, targets=targets, draws=draws, sent=None,
                         n_obs=int(d["MODEL"]["N_OBS_STEPS"]), next_request=0, lang=lang)
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


def reference(run, state, requests, kind: str = "float32", variant: str = "sound"):
    """The plain reference's (trajectories, scores, best) of ``requests``
    in ``kind`` precision (``float32``; ``tf32``), with ``variant``'s planted
    fault or control (``reference/rdt.py``)."""
    d, dev, block = run.cfgd, run.device, run.cell.traffic["check_block"]
    model = build_reference(d["MODEL"], dev)
    model.load_state_dict(state.sd, strict=True)
    tokens, mask = (torch.from_numpy(a).to(dev) for a in state.lang)
    outs = []
    with precision(kind):
        for lo in range(0, len(requests), block):
            part = requests[lo:lo + block]
            fr = torch.from_numpy(np.stack([state.frames[[f for f, _ in h]] for h, _ in part])).to(dev)
            tg = torch.from_numpy(np.stack([state.targets[[t for _, t in h]] for h, _ in part])).to(dev)
            init = torch.stack([state.draws[at][0] for _, at in part]).to(dev)
            n = len(part)
            outs.append([a.cpu().numpy() for a in plan_batch(model, d, fr, tg, init, tokens.expand(n, -1, -1),
                                                              mask.expand(n, -1), variant)])
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
    numbers = gaps(prog_trajs, prog_best, ref_trajs, ref_scores)
    rates = work.card_rates(run.device_name)
    ctx = SimpleNamespace(kind="plan", cfg=run.cfgd, rates=rates,
                          work=work_rdt.plan_work(run.cfgd, rates) if run.trace else None,
                          setup_s=setup_s, window_s=rec.end - rec.start, units=len(rec.requests),
                          latency_s=rec.latency_s, host_s=rec.host_s, trace=profiled)
    return {"ctx": ctx, "attempted": len(rec.requests), "failed": int(failed), "numbers": numbers,
            "memory_peak_bytes": peak, "setup_parts": state.parts, "reference_s": reference_s,
            "checked": len(requests)}
