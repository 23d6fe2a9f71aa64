"""The port's distill CLI (``python -m autonomous_driving_with_diffusion_model_tpu_torch.distill``)
on the CPU at a tiny size: a two-stage run from a teacher ``.pth`` writes
``student_2.pth``, ``student_1.pth`` and ``distill.json`` with the JAX CLI's
keys; each student loads in the JAX planner and in the port's planner and
plans the same on its recorded grid (``tests/test_torch_plan.py``'s
tolerance); the students carry their EMA in both slots, fresh moments and
the stage's iterations; another encoder reads and writes the port's own
checkpoint; and without a card or ``--device`` the CLI raises."""

import json
import os

import numpy as np
import pytest
import torch

from autonomous_driving_with_diffusion_model_tpu.driving.plan import DiffusionPlanner as JaxPlanner
from autonomous_driving_with_diffusion_model_tpu.utils.config import create_cfg as jax_create_cfg
from autonomous_driving_with_diffusion_model_tpu_torch import distill
from autonomous_driving_with_diffusion_model_tpu_torch.driving import DiffusionPlanner
from autonomous_driving_with_diffusion_model_tpu_torch.models import build_model
from autonomous_driving_with_diffusion_model_tpu_torch.train import (
    create_train_state,
    export_torch_checkpoint,
    load_eval_state_dict,
    save_checkpoint,
)
from autonomous_driving_with_diffusion_model_tpu_torch.utils.config import create_cfg

torch.set_num_threads(1)

# meters, as tests/test_torch_plan.py holds the port's planner to JAX's
TOL = dict(atol=5e-3, rtol=1e-4)
# the JAX CLI's distill.json (the repo root's distill.py:126-135, 204-210)
MANIFEST_KEYS = {"teacher_checkpoint", "start_steps", "iters_per_stage", "lr", "snr_weight", "use_cond",
                 "free_scale", "stages"}
STAGE_KEYS = {"num_steps", "timesteps", "checkpoint", "final_loss", "seconds"}


def opts(tmp_path, perception="resnet34"):
    return ["MODEL.DIM", "8", "MODEL.DIM_MULTS", "[1, 2]", "MODEL.PERCEPTION", perception,
            "TRAIN.ROOT", str(tmp_path / "data"), "TRAIN.BATCH_SIZE", "2", "TRAIN.NUM_WORKERS", "1",
            "TRAIN.TIME_STEPS", "10", "TRAIN.SAMPLE_STEPS", "10", "TRAIN.IMAGE_HEIGHT", "32",
            "TRAIN.IMAGE_WIDTH", "48"]


def teacher_file(tmp_path, perception="resnet34"):
    from test_torch_train_cli import write_dataset

    write_dataset(str(tmp_path / "data"))
    cfg = create_cfg()
    cfg.merge_from_list(opts(tmp_path, perception))
    state = create_train_state(build_model(cfg, device="cpu", seed=5), cfg)
    if perception == "resnet34":
        path = str(tmp_path / "teacher.pth")
        export_torch_checkpoint(state, cfg, path)
    else:
        path = str(tmp_path / "teacher.pt")
        save_checkpoint(state, path)
    return cfg, path


def run(tmp_path, path, perception="resnet34", *more):
    argv = ["--checkpoint", path, "--workdir", str(tmp_path / "distill"), "--start-steps", "4", "--iters", "2",
            "--lr", "1e-3", "--warmup", "0", *more, "--opts", *opts(tmp_path, perception)]
    return distill.main(distill.parse_args(argv))


def test_two_stages_write_students_that_both_planners_load(tmp_path, capsys):
    cfg, path = teacher_file(tmp_path)
    manifest = run(tmp_path, path, "resnet34", "--device", "cpu", "--stages", "2")
    workdir = tmp_path / "distill"
    assert sorted(os.listdir(workdir)) == ["distill.json", "student_1.pth", "student_2.pth"]
    assert json.loads((workdir / "distill.json").read_text()) == manifest
    assert set(manifest) == MANIFEST_KEYS and all(set(s) == STAGE_KEYS for s in manifest["stages"])
    assert [s["num_steps"] for s in manifest["stages"]] == [2, 1]
    assert [s["timesteps"] for s in manifest["stages"]] == [[6, 2], [6]]
    assert manifest["start_steps"] == 4 and manifest["iters_per_stage"] == 2
    assert all(np.isfinite(s["final_loss"]) for s in manifest["stages"])
    out = capsys.readouterr().out
    assert 'deploy 1-step: --opts EVAL.CHECKPOINT' in out and 'TPU.SAMPLE_TIMESTEPS "[6]"' in out

    frame = np.random.default_rng(2).integers(0, 256, (32, 48, 3), dtype=np.uint8)
    for stage in manifest["stages"]:
        saved = torch.load(stage["checkpoint"], weights_only=False)
        assert saved["iter"] == 2 and saved["ema_state_dict"]["optimization_step"] == 2
        names = [n for n, _ in build_model(cfg, device="cpu").named_parameters()]
        for name, shadow in zip(names, saved["ema_state_dict"]["shadow_params"], strict=True):
            assert torch.equal(saved["state_dict"][name], shadow), name
        assert all(not e["exp_avg"].any() and not e["exp_avg_sq"].any() for e in saved["optimizer"]["state"].values())

        pcfg = create_cfg()
        pcfg.merge_from_list(opts(tmp_path))
        pcfg.TPU.SAMPLE_TIMESTEPS = stage["timesteps"]
        port = DiffusionPlanner(pcfg, checkpoint=stage["checkpoint"], device="cpu")
        jcfg = jax_create_cfg()
        jcfg.merge_from_other_cfg(pcfg)
        theirs = JaxPlanner(jcfg, checkpoint=stage["checkpoint"])
        port.init_trajs = torch.from_numpy(np.array(theirs.init_trajs))
        np.testing.assert_allclose(port.plan(frame), np.asarray(theirs.plan(frame)), **TOL)


def test_other_encoders_use_the_ports_checkpoint(tmp_path):
    """A tiny-encoder teacher from the port's own checkpoint; the student is
    the port's own file, whose serving weights are the student's EMA."""
    cfg, path = teacher_file(tmp_path, "tiny")
    manifest = run(tmp_path, path, "tiny", "--device", "cpu", "--stages", "1")
    assert [s["checkpoint"] for s in manifest["stages"]] == [str(tmp_path / "distill" / "student_2.pt")]
    saved = torch.load(manifest["stages"][0]["checkpoint"], weights_only=False)
    assert saved["step"] == 2
    weights = load_eval_state_dict(manifest["stages"][0]["checkpoint"], cfg)
    teacher = load_eval_state_dict(path, cfg)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(weights)
    for (name, p), s in zip(model.named_parameters(), saved["ema"]["shadow_params"]):
        assert torch.equal(p.detach(), s), name
    assert any(not torch.equal(weights[n], teacher[n]) for n, _ in model.named_parameters())
    # deployed through the port's planner on its recorded grid
    pcfg = create_cfg()
    pcfg.merge_from_list(opts(tmp_path, "tiny"))
    pcfg.TPU.SAMPLE_TIMESTEPS = manifest["stages"][0]["timesteps"]
    planner = DiffusionPlanner(pcfg, checkpoint=manifest["stages"][0]["checkpoint"], device="cpu")
    for (name, p), s in zip(planner.model.named_parameters(), saved["ema"]["shadow_params"]):
        assert torch.equal(p.detach(), s), name
    plan = planner.plan(np.zeros((32, 48, 3), np.uint8))
    assert plan.shape == (1, 16, 7) and np.isfinite(plan).all()


def test_cli_needs_a_card_or_device_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, path = teacher_file(tmp_path, "tiny")
    with pytest.raises(RuntimeError, match="CUDA"):
        run(tmp_path, path, "tiny", "--stages", "1")
    assert not (tmp_path / "distill").exists()
