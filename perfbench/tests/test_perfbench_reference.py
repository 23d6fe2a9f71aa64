"""The plain reference against the program, on the CPU at a small size:
the same weights, inputs and draws give the same plans, the same
augmentation and the same training steps. (The test imports both; the
reference itself imports nothing of the program.)"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import perfbench_helpers  # noqa: F401  (puts the checkout on sys.path)
from perfbench import check, core, inputs
from perfbench.reference import training as ref_train
from perfbench.reference.models import build_reference
from perfbench.reference.planner import plan_batch
from perfbench.weights import make_state_dict

SMALL = {"MODEL.DIM": 16, "TRAIN.IMAGE_HEIGHT": 32, "TRAIN.IMAGE_WIDTH": 64, "EVAL.SAMPLE_STEPS": 4}


def _config(name: str, overrides=None):
    cell = core.load_cell({"default": "default-plan", "free_guidance_k8": "free_guidance-plan-k8"}[name])
    cfg = core.build_cfg(cell.config, {**SMALL, **(overrides or {})})
    return cfg, core.plain(cfg)


def _weights(d, seed):
    free = d["TRAIN"]["USE_COND"] == "FREE_GUIDANCE"
    sd = make_state_dict(build_reference(d["MODEL"], free, "meta").state_dict(), seed, "cpu")
    ref = build_reference(d["MODEL"], free, "cpu")
    ref.load_state_dict(sd, strict=True)
    return sd, ref


@pytest.mark.parametrize("name", ["default", "free_guidance_k8"])
def test_plans_match_the_planner(name):
    from autonomous_driving_with_diffusion_model_tpu_torch.driving.plan import DiffusionPlanner

    cfg, d = _config(name)
    sd, ref = _weights(d, 123456789012)
    planner = DiffusionPlanner(cfg, seed=0, device="cpu")
    planner.model.load_state_dict(sd, strict=True)
    planner.init_trajs = inputs.init_trajs(7, planner.init_trajs.shape)
    frames = inputs.frames(7, 3, 32, 64, "cpu")
    targets = inputs.targets(7, 3)
    got = [planner.plan_hypotheses(f, t) for f, t in zip(frames, targets)]
    want, scores, best = plan_batch(ref, d, torch.from_numpy(frames), torch.from_numpy(targets), planner.init_trajs)
    gap = check.plan_gap(np.stack([g[0] for g in got]), np.asarray([g[1] for g in got]), want.numpy(),
                         scores.numpy())
    # float32 rounding, which classifier-free guidance's combine multiplies
    # by up to 1 + 2 x FREE_SCALE
    scale = 1 + 2 * d["GUIDANCE"]["FREE_SCALE"] if d["GUIDANCE"]["USE_COND"] == "FREE_GUIDANCE" else 1
    assert gap["plan_gap"] < 1e-4 * scale, gap
    assert [g[1] for g in got] == best.tolist()


def test_augmentation_matches_the_program():
    from autonomous_driving_with_diffusion_model_tpu_torch.data.augment import augment_batch

    images = torch.from_numpy(inputs.frames(3, 6, 24, 40, "cpu"))
    it = 20_000_000  # every op applies to half of the images, half of them per channel
    got = augment_batch(images, torch.Generator().manual_seed(5), it)
    draws = ref_train.augment_draws(torch.Generator().manual_seed(5), images.shape, it, "cpu")
    assert int(draws["apply"].sum()) > 10
    want = ref_train.augment(images, draws)
    assert torch.allclose(got, want, atol=1e-3, rtol=0), float((got - want).abs().max())


def test_training_steps_match_the_program():
    from autonomous_driving_with_diffusion_model_tpu_torch.data import AugmentProgram, normalize_images
    from autonomous_driving_with_diffusion_model_tpu_torch.diffusion import make_schedule_from_cfg
    from autonomous_driving_with_diffusion_model_tpu_torch.models import build_model
    from autonomous_driving_with_diffusion_model_tpu_torch.train.program import TrainProgram
    from autonomous_driving_with_diffusion_model_tpu_torch.train.state import (StepDraws, create_train_state,
                                                                               make_train_step)

    cfg, d = _config("default", {"TRAIN.BATCH_SIZE": 4, "TRAIN.LR_WARMUP": 2})
    sd, ref = _weights(d, 98765)
    model = build_model(cfg, device="cpu", seed=0)
    model.load_state_dict(sd, strict=True)
    state = create_train_state(model, cfg)
    program = TrainProgram(make_train_step(make_schedule_from_cfg(cfg, "cpu"), cfg), "cpu")
    augment = AugmentProgram("cpu")
    params = dict(ref.named_parameters())
    opt = ref_train.AdamW({k: p.detach() for k, p in params.items()})
    rng = np.random.default_rng(1)
    prog = {"losses": []}
    want = {"losses": []}
    for it in range(3):
        images = torch.from_numpy(rng.integers(0, 256, (4, 32, 64, 3), dtype=np.uint8))
        trajs = torch.from_numpy(rng.uniform(-1, 1, (4, 16, 7)).astype(np.float32))
        target = torch.from_numpy(rng.uniform(-1, 1, (4, 2)).astype(np.float32))
        g = torch.Generator().manual_seed(100 + it)
        t, noise, keep = torch.randint(0, 100, (4,), generator=g), torch.randn(4, 16, 7, generator=g), \
            torch.rand(1, generator=g) < 0.7
        aug = augment(images, torch.Generator().manual_seed(50 + it), 3_000_000 * it)
        out = program(state, {"image": normalize_images(aug), "trajs": trajs, "target": target},
                      draws=StepDraws(t, noise, keep, None))
        prog["losses"].append(float(out["loss"]))
        if it == 0:
            prog["grad"] = {k: float(state.optimizer.state[p]["exp_avg"].norm()) / (1 - check.BETA1)
                            for k, p in model.named_parameters()}
        ref_aug = ref_train.augment(images, ref_train.augment_draws(torch.Generator().manual_seed(50 + it),
                                                                    images.shape, 3_000_000 * it, "cpu"))
        loss = ref_train.train_loss(ref, d, ref_aug, trajs, target, t, noise, keep)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        ref_train.scrub_(grads)
        if it == 0:
            want["grad"] = {k: float(gr.norm()) for k, gr in grads.items()}
        opt.step({k: p.detach() for k, p in params.items()}, grads, ref_train.lr_at(it, d["TRAIN"]["LR"], 2))
        want["losses"].append(float(loss.detach()))
    prog["change"] = prog["ema_change"] = {k: float((p.detach() - sd[k]).norm()) for k, p in model.named_parameters()}
    want["change"] = want["ema_change"] = {k: float((p.detach() - sd[k]).norm()) for k, p in params.items()}
    gaps = check.train_gaps(prog, want)
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4 and gaps["change_gap"] < 1e-3, gaps
