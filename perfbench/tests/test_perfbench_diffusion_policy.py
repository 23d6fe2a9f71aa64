"""The ``diffusion_policy_cnn-plan`` cell's pieces on the CPU at a small size:
its plain reference (``perfbench/reference/diffusion_policy.py``) against
the planner and against its copy in ``tests/``, its work count at the
published widths, the ``weight_stream_share.plan`` reader, and whole runs
of the cell, unbroken and with the history or the step noise planted wrong;
on a card (``gpu``), the program within the limit and the TF32 control
beyond it."""

from __future__ import annotations

import importlib.util
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import perfbench_helpers  # noqa: F401
from perfbench import check, core, inputs, work, work_diffusion_policy
from perfbench.reference import diffusion_policy as ref_dp
from perfbench.weights import make_state_dict
from perfbench_helpers import run_tiny

from autonomous_driving_with_diffusion_model_tpu_torch.utils import profiling

CELL = "diffusion_policy_cnn-plan"
SMALL = {"MODEL.DIM": 16, "TRAIN.IMAGE_HEIGHT": 32, "TRAIN.IMAGE_WIDTH": 64, "EVAL.SAMPLE_STEPS": 10}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config(overrides=None):
    cfg = core.build_cfg(core.load_cell(CELL).config, {**SMALL, **(overrides or {})})
    return cfg, core.plain(cfg)


def _tests_copy():
    spec = importlib.util.spec_from_file_location("plain_diffusion_policy",
                                                  core.ROOT / "tests" / "plain_diffusion_policy.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_plans_match_the_planner():
    """Three closed-loop requests through the planner, the first padded;
    the reference recomputes each from its history and the planner's draws."""
    from autonomous_driving_with_diffusion_model_tpu_torch.driving.plan import DiffusionPlanner

    cfg, d = _config()
    sd = make_state_dict(ref_dp.build_reference(d["MODEL"], "meta").state_dict(), 2**31 + 11, "cpu")
    planner = DiffusionPlanner(cfg, seed=5, device="cpu")
    planner.model.load_state_dict(sd, strict=True)
    draws, draw = [], planner._draw
    planner._draw = lambda shape: draws.append(draw(shape)) or draws[-1]
    frames = inputs.frames(7, 3, 32, 64, "cpu")
    targets = inputs.targets(7, 3)
    got = [planner.plan_hypotheses(f, t) for f, t in zip(frames, targets)]
    ref = ref_dp.build_reference(d["MODEL"], "cpu")
    ref.load_state_dict(sd, strict=True)
    hist = [[0, 0], [0, 1], [1, 2]]
    want, scores, best = ref_dp.plan_batch(
        ref, d, torch.from_numpy(np.stack([frames[h] for h in hist])),
        torch.from_numpy(np.stack([targets[h] for h in hist])), torch.stack([a for a, _ in draws]),
        torch.stack([n for _, n in draws]))
    gap = check.plan_gap(np.stack([g[0] for g in got]), np.asarray([g[1] for g in got]), want.numpy(),
                         scores.numpy())
    assert gap["plan_gap"] < 1e-5, gap  # float32 rounding
    assert [g[1] for g in got] == best.tolist()


def test_reference_agrees_with_its_copy_in_tests():
    """The benchmark's reference and the tests' copy: one plan on one state
    dict, bit for bit."""
    _, d = _config({"EVAL.SAMPLE_STEPS": 3})
    other = _tests_copy()
    sd = make_state_dict(ref_dp.build_reference(d["MODEL"], "meta").state_dict(), 3, "cpu")
    g = torch.Generator().manual_seed(0)
    frames = torch.randint(0, 256, (2, 2, 32, 64, 3), generator=g, dtype=torch.uint8)
    targets, init = torch.rand(2, 2, 2, generator=g), torch.randn(2, 1, 16, 7, generator=g)
    noise = torch.randn(2, 3, 1, 16, 7, generator=g)
    outs = []
    for mod in (ref_dp, other):
        model = mod.build_reference(d["MODEL"], "cpu")
        model.load_state_dict(sd, strict=True)
        outs.append(mod.plan_batch(model, d, frames, targets, init, noise))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_work_count_at_the_published_widths():
    """251.5M U-Net parameters, 1.006 GB of weights a batch-1 forward; the
    12 FiLM calls' weights, counted by hand for the first block."""
    d = core.plain(core.build_cfg(core.load_cell(CELL).config))
    assert work_diffusion_policy.unet_parameters(d["MODEL"]) == 251_529_863
    assert 4 * work_diffusion_policy.unet_parameters(d["MODEL"]) == pytest.approx(1.006e9, rel=1e-3)
    calls = work_diffusion_policy.block_work(d["MODEL"], 1)
    assert len(calls) == 12
    cin, C, E, L = 7, 512, 260, 16
    weights = 5 * cin * C + 5 * C * C + E * 2 * C + 8 * C + (cin + 1) * C
    ops = 2 * (L * 5 * cin * C + L * 5 * C * C + E * 2 * C + L * cin * C)
    assert calls[0] == (ops, 4 * (L * cin + E + weights + L * C), 4 * weights)
    pw = work_diffusion_policy.plan_work(d, work.card_rates("NVIDIA H100 80GB HBM3"))
    assert pw["forwards"] == 100 and pw["weight_bytes"] == pytest.approx(96.36e9, rel=1e-3)
    # a plan's blocks are bound by their bytes: 28.8 ms at 3.35 TB/s
    assert pw["residual_bound_s"] == pytest.approx(0.02879, rel=1e-3)


def _reader():
    return core._load_module(core.PB / "metrics" / "weight_stream_share.plan.py", "perfbench_metric_test_wss")


def _report():
    spans = [{"plan.encode": 3.0, "plan.denoise": d, "plan.score": 0.1} for d in (60.0, 64.0, 80.0)]
    return {"spans": [], "counters": {},
            "device_spans": [{"graph": "plan", "graph_id": 1, "replay": i, "request": i, "spans": s,
                              "replay_ms": sum(s.values())} for i, s in enumerate(spans)],
            "graphs": [{"id": 1, "name": "plan", "markers": 4, "spans": list(spans[0]), "kernels": None,
                        "kernel_nodes": None, "attrs": {"steps": 100}}]}


def test_weight_stream_reader(monkeypatch):
    """A plan's weight bytes from the work count over the median replay's
    denoising time, over the card's bytes/s; None for a training cell, a
    work count without weight bytes (the temporal U-Net's cells), or a
    program without spans."""
    rates = {"bytes_s": 3.35e12}
    ctx = SimpleNamespace(kind="plan", rates=rates, work={"flops": 1.0, "weight_bytes": 96.4e9})
    monkeypatch.setattr(profiling, "report", _report)
    assert _reader().read(ctx) == pytest.approx(100 * 96.4e9 / 0.064 / 3.35e12)
    assert _reader().read(SimpleNamespace(kind="train", rates=rates, work=ctx.work)) is None
    assert _reader().read(SimpleNamespace(kind="plan", rates=rates, work={"flops": 1.0})) is None
    assert _reader().read(SimpleNamespace(kind="plan", rates=rates, work=None)) is None
    monkeypatch.delattr(profiling, "report")
    assert _reader().read(ctx) is None


def test_the_manifest_lists_the_cell():
    m = core.load_cell(CELL).manifest
    per_layer = {x["name"]: x for x in m["per_layer"]}
    assert per_layer["weight_stream_share.plan"]["workloads"] == [CELL]
    e2e = {x["name"] for x in core.metric_names(core.load_cell(CELL), False)}
    assert e2e == {"plan_p50_ms", "plan_p95_ms", "setup_s"}


def test_unbroken_run_is_correct():
    done = run_tiny(CELL)
    assert done["result"]["correct"], done["rows"]
    assert done["result"]["attempted"] >= 1 and done["result"]["failed"] == 0


def test_history_planted_wrong(monkeypatch):
    """The planner conditions every plan on its current request alone."""
    from autonomous_driving_with_diffusion_model_tpu_torch.driving.plan import DiffusionPlanner

    def current_only(self, frame, target):
        return np.stack([frame, frame]), np.concatenate([target, target])

    monkeypatch.setattr(DiffusionPlanner, "_observe", current_only)
    assert not run_tiny(CELL)["result"]["correct"]


def test_step_noise_planted_wrong(monkeypatch):
    """The DDPM step adds no noise."""
    from autonomous_driving_with_diffusion_model_tpu_torch.diffusion import sampler

    step = sampler.ddpm_step
    monkeypatch.setattr(sampler, "ddpm_step", lambda s, c, o, t, p, x, noise=None: step(s, c, o, t, p, x, None))
    assert not run_tiny(CELL)["result"]["correct"]


@pytest.mark.gpu
def test_control_fails_and_program_passes_on_card():
    """On the card at the cell's own size, one seed: the program within the
    limit, the TF32 control beyond it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from perfbench import calibrate

    cell = core.load_cell(CELL)
    r = calibrate.plan_readings(cell, [2**31 + 4242], 1, 1.0, "cuda:0")
    assert all(row["ok"] for row in check.judge(r["sound"][0], cell.limits)), r
    assert not all(row["ok"] for row in check.judge(r["control"][0], cell.limits)), r
