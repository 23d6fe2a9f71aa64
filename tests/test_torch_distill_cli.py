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
from port_jax_cfg import jax_cfg_of
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
        jcfg = jax_cfg_of(pcfg)
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


def _cfg_opts(tmp_path):
    """The CFG stage loop's size: MODEL.DIM 8, tiny perception, FREE_GUIDANCE at
    scale 7.5, float32."""
    return opts(tmp_path, "tiny") + ["TRAIN.USE_COND", "FREE_GUIDANCE", "GUIDANCE.USE_COND", "FREE_GUIDANCE",
                                     "GUIDANCE.FREE_SCALE", "7.5", "TPU.COMPUTE_DTYPE", "float32"]


def test_cfg_stage_loop_matches_jax_cli(tmp_path, monkeypatch):
    """The port's distill CLI against the JAX CLI (the repo root's
    ``distill.py``) end to end under CFG: 2 stages (4 -> 2 -> 1 steps) of 3
    iterations from the same teacher weights, the JAX CLI's per-iteration
    draws (``fold_in(PRNGKey(seed), it)``, split as its step splits it)
    injected into the port's draw function. Held to JAX, at
    ``tests/test_torch_distill.py:test_distill_steps_match_jax``'s
    tolerances: each stage's grid, the student's initialisation (the
    previous stage's deployed EMA), each iteration's cosine LR and loss, the
    deployed weights (the student's EMA) and each stage's exported
    checkpoint."""
    import sys

    import jax
    import jax.numpy as jnp
    import optax

    import autonomous_driving_with_diffusion_model_tpu.diffusion as jdiff
    import autonomous_driving_with_diffusion_model_tpu.train as jtrain
    import autonomous_driving_with_diffusion_model_tpu_torch.diffusion as tdiff
    import autonomous_driving_with_diffusion_model_tpu_torch.diffusion.distill as tdistill
    from autonomous_driving_with_diffusion_model_tpu.models import build_model as jax_build_model
    from autonomous_driving_with_diffusion_model_tpu_torch.models import from_jax_variables
    from autonomous_driving_with_diffusion_model_tpu_torch.train.program import DistillProgram
    from test_torch_train_cli import write_dataset

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(repo)
    import distill as jax_cli  # the repo root's distill.py

    write_dataset(str(tmp_path / "data"))
    cfg = create_cfg()
    cfg.merge_from_list(_cfg_opts(tmp_path))
    jcfg = jax_cfg_of(cfg)
    H, W = cfg.TRAIN.IMAGE_HEIGHT, cfg.TRAIN.IMAGE_WIDTH
    jmodel = jax_build_model(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(7), jnp.zeros((1, 16, 7)), img=jnp.zeros((1, H, W, 3)),
                            time=jnp.asarray([1.0]))
    jax_teacher = str(tmp_path / "teacher_orbax")
    jtrain.save_orbax(jax_teacher, jtrain.create_train_state(jmodel, variables, cfg=jcfg))
    port_model = build_model(cfg, device="cpu")
    port_model.load_state_dict(from_jax_variables(variables, cfg))
    port_teacher = str(tmp_path / "teacher.pt")
    save_checkpoint(create_train_state(port_model, cfg), port_teacher)
    args = ["--start-steps", "4", "--stages", "2", "--iters", "3", "--lr", "1e-3", "--warmup", "1", "--seed", "3"]

    # the JAX CLI, each stage's grid, initial student and per-iteration state recorded
    jax_rec = []
    real_make, real_jit, real_save = jdiff.make_distill_step, jax.jit, jtrain.save_orbax

    def jax_make(model, schedule, grid, **kw):
        init_state, step = real_make(model, schedule, grid, **kw)
        stage = {"grid": grid, "states": [], "losses": [], "exported": None}
        jax_rec.append(stage)

        def init(params):
            stage["init"] = jax.tree.map(lambda a: np.array(a, copy=True), params)
            return init_state(params)

        def recorded(*a):
            return step(*a)

        recorded.stage = stage
        return init, recorded

    def jax_jit(fn, *a, **kw):
        jitted = real_jit(fn, *a, **kw)
        stage = getattr(fn, "stage", None)
        if stage is None:
            return jitted

        def call(*args):
            state, metrics = jitted(*args)
            stage["states"].append(jax.tree.map(lambda x: np.array(x, copy=True), state))
            stage["losses"].append(float(metrics["loss"]))
            return state, metrics

        return call

    def jax_save(path, state, *a, **kw):
        jax_rec[-1]["exported"] = jax.tree.map(lambda x: np.array(x, copy=True), state)
        return real_save(path, state, *a, **kw)

    monkeypatch.setattr(jdiff, "make_distill_step", jax_make)
    monkeypatch.setattr(jax, "jit", jax_jit)
    monkeypatch.setattr(jtrain, "save_orbax", jax_save)
    monkeypatch.setattr(sys, "argv", ["distill.py", "--checkpoint", jax_teacher, "--workdir", str(tmp_path / "jax"),
                                      *args, "--opts", *_cfg_opts(tmp_path)])
    jax_cli.main()
    monkeypatch.setattr(jax, "jit", real_jit)

    # the port's CLI with JAX's draws, each stage's grid, initial student and per-iteration metrics recorded
    port_rec = []
    real_tmake, real_call = tdiff.make_distill_step, DistillProgram.__call__

    class Iteration:
        def __init__(self, it):
            self.it, self.device = it, torch.device("cpu")

    def jax_draws(batch_size, n_grid, shape, generator):
        rng_i, rng_n = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(3), generator.it))
        i = np.asarray(jax.random.randint(rng_i, (batch_size,), 0, n_grid))
        noise = np.asarray(jax.random.normal(rng_n, (batch_size, *shape), jnp.float32))
        return tdistill.DistillDraws(torch.from_numpy(i.copy()), torch.from_numpy(noise.copy()))

    def port_make(schedule, grid, **kw):
        init_state, step = real_tmake(schedule, grid, **kw)
        stage = {"grid": grid, "lrs": [], "losses": []}
        port_rec.append(stage)

        def init(teacher):
            stage["init"] = {n: p.detach().clone() for n, p in teacher.named_parameters()}
            state = init_state(teacher)
            stage["state"] = state
            return state

        return init, step

    def port_call(self, state, teacher, batch, draws=None, generator=None):
        m = real_call(self, state, teacher, batch, draws, generator)
        port_rec[-1]["lrs"].append(m["lr"])
        port_rec[-1]["losses"].append(float(m["loss"]))
        return m

    monkeypatch.setattr(distill, "iteration_generator", lambda seed, it, device: Iteration(it))
    monkeypatch.setattr(tdistill, "draw_distill", jax_draws)
    monkeypatch.setattr(tdiff, "make_distill_step", port_make)
    monkeypatch.setattr(DistillProgram, "__call__", port_call)
    manifest = distill.main(distill.parse_args(["--checkpoint", port_teacher, "--workdir", str(tmp_path / "port"),
                                                *args, "--device", "cpu", "--opts", *_cfg_opts(tmp_path)]))

    jax_manifest = json.loads((tmp_path / "jax" / "distill.json").read_text())
    assert [s["timesteps"] for s in manifest["stages"]] == [s["timesteps"] for s in jax_manifest["stages"]] \
        == [[6, 2], [6]]
    assert len(port_rec) == len(jax_rec) == 2
    as_port = lambda tree: from_jax_variables({"params": tree, "batch_stats": variables.get("batch_stats", {})}, cfg)
    schedules = [optax.warmup_cosine_decay_schedule(init_value=0.0, peak_value=1e-3, warmup_steps=1, decay_steps=3,
                                                    end_value=0.0)]
    for n, (ours, theirs) in enumerate(zip(port_rec, jax_rec)):
        for field in ("ts", "mids", "prev", "single"):
            assert np.array_equal(getattr(ours["grid"], field), getattr(theirs["grid"], field)), (n, field)
        # the student starts from the teacher, then from the previous stage's deployed EMA
        start = as_port(theirs["init"])
        for name, p in ours["init"].items():
            tol = 0.0 if n == 0 else 2 * sum(float(schedules[0](k)) for k in range(3)) * n
            assert (p - start[name]).abs().max() <= tol + 1e-7, (n, name)
        jax_lrs = [float(schedules[0](k)) for k in range(3)]
        np.testing.assert_allclose(ours["lrs"], jax_lrs, rtol=1e-6)
        np.testing.assert_allclose(ours["losses"], theirs["losses"], rtol=2e-5)
        # the deployed weights: the student's EMA after the stage
        state, final = ours["state"], theirs["states"][-1]
        g_jax = {k: v / (1.0 - 0.95) for k, v in as_port(theirs["states"][0].opt_state[0].mu).items()}
        shadow = as_port(final.ema.shadow_params)
        own_start = {name: p for name, p in ours["init"].items()}
        for (name, _), s in zip(state.student.named_parameters(), state.ema.shadow_params):
            noise = g_jax[name].abs() < max(1e-6, 1e-3 * float(g_jax[name].abs().max()))
            assert ((s - shadow[name]).abs() <= 2 * sum(jax_lrs)).all(), (n, name)
            if (~noise).any():
                moved, jax_moved = (s - own_start[name])[~noise], (shadow[name] - start[name])[~noise]
                assert (moved - jax_moved).norm() <= 1e-3 * jax_moved.norm() + 1e-6, (n, name)
        # the exported checkpoint: the deployed EMA in both slots, the stage's iterations
        saved = torch.load(manifest["stages"][n]["checkpoint"], weights_only=False)
        exported = theirs["exported"]
        assert saved["step"] == int(exported.step) == 3
        assert saved["ema"]["optimization_step"] == int(exported.ema.optimization_step) == 3
        weights = load_eval_state_dict(manifest["stages"][n]["checkpoint"], cfg)
        for name, s in zip((n_ for n_, _ in state.student.named_parameters()), state.ema.shadow_params):
            assert torch.equal(weights[name], s), (n, name)
        np.testing.assert_allclose(
            np.concatenate([v.ravel() for v in jax.tree.leaves(exported.params)]),
            np.concatenate([v.ravel() for v in jax.tree.leaves(final.ema.shadow_params)]), atol=0)
