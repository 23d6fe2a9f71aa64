"""A run with its timed path broken underneath comes out not correct.

Each test drives the rest of a run (set-up, window, the reference and the
comparison) on the CPU at a small size, the harness's look for a card
skipped, with one fault planted in the program: once for each fault the
cell can have. The unbroken run is correct.
"""

from __future__ import annotations

import pytest
import torch

from perfbench_helpers import run_tiny

PLAN_CELLS = ["default-plan", "free_guidance-plan", "free_guidance-plan-k8"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", PLAN_CELLS + ["default-train"])
def test_unbroken_run_is_correct(workload):
    done = run_tiny(workload)
    assert done["result"]["correct"], done["rows"]
    assert done["result"]["attempted"] >= 1 and done["result"]["failed"] == 0


@pytest.mark.parametrize("workload", PLAN_CELLS)
def test_plan_step_returning_its_state(workload, monkeypatch):
    from autonomous_driving_with_diffusion_model_tpu_torch.diffusion import sampler

    monkeypatch.setattr(sampler, "ddim_step", lambda schedule, cfg, out, t, prev, sample, noise=None: (sample, out))
    assert not run_tiny(workload)["result"]["correct"]


@pytest.mark.parametrize("workload", PLAN_CELLS)
def test_plan_answer_altered(workload, monkeypatch):
    from autonomous_driving_with_diffusion_model_tpu_torch.driving.plan import DiffusionPlanner

    body = DiffusionPlanner._plan

    def altered(self, *args):
        trajs, best = body(self, *args)
        return trajs + torch.tensor([0.0] * 6 + [0.01]), best  # the brake of every waypoint

    monkeypatch.setattr(DiffusionPlanner, "_plan", altered)
    assert not run_tiny(workload)["result"]["correct"]


@pytest.mark.parametrize("workload", ["free_guidance-plan", "free_guidance-plan-k8"])
def test_plan_half_batch(workload, monkeypatch):
    """The U-Net computes the first half of its rows and hands them out
    for the rest too (under guidance the rest is the unconditioned half)."""
    from autonomous_driving_with_diffusion_model_tpu_torch.models.temporal_unet import TemporalMapUnet

    forward = TemporalMapUnet.forward

    def half(self, x, img=None, time=None, cond=None, img_feature=None, **kw):
        h = x.shape[0] // 2  # time and the image feature come with h rows
        out = forward(self, x[:h], img=img, time=time[:h], cond=cond[:h], img_feature=img_feature[:h], **kw)
        return torch.cat([out, out])

    monkeypatch.setattr(TemporalMapUnet, "forward", half)
    assert not run_tiny(workload)["result"]["correct"]


def test_train_step_returning_its_state(monkeypatch):
    from autonomous_driving_with_diffusion_model_tpu_torch.train import state

    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    monkeypatch.setattr(state, "ema_apply", lambda ema, params: None)
    done = run_tiny("default-train")
    assert not done["result"]["correct"]
    assert done["out"]["numbers"]["change_gap"] == pytest.approx(1.0)


def test_train_half_batch(monkeypatch):
    """The loss is the mean over the first half of the batch only."""
    from autonomous_driving_with_diffusion_model_tpu_torch.train.state import TrainStep

    loss = TrainStep.micro_loss

    def half(self, forward, image, trajs, target, t, noise, keep, gen):
        h = trajs.shape[0] // 2
        return loss(self, forward, image[:h], trajs[:h], target[:h], t[:h], noise[:h], keep, gen)

    monkeypatch.setattr(TrainStep, "micro_loss", half)
    assert not run_tiny("default-train")["result"]["correct"]
