"""The port's evaluation of distilled students (``learnability.py``:
``evaluate_distilled``, ``distill_draws``): ``distill()``'s JSON keys, and its
values equal to the factored-out evaluation of the same run; the evaluation
per init-noise draw (the planners' own seeds, and JAX's draw injected from
``tests/fixtures/jax_init_trajs_seed0.npy``, which is the JAX planner's
seed-0 draw); a tiny CPU run of the harness's train and distill."""

import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from autonomous_driving_with_diffusion_model_tpu_torch import learnability as tl  # noqa: E402

torch.set_num_threads(1)

HW = (64, 96)
FIXTURE = os.path.join(REPO, "tests", "fixtures", "jax_init_trajs_seed0.npy")
# the root script's distill JSON keys (learnability.py), and the port's seed
DISTILL_KEYS = ["start_steps", "iters_per_stage", "stage_steps", "grids", "teacher", "students", "seconds",
                "seed", "gates", "pass"]
POINT_KEYS = {"heldout_rms_m", "completion", "mean_abs_lat_m", "curved_completion", "curved_mean_dev_m"}


def test_fixture_is_the_jax_planners_seed0_draw():
    """The fixture equals ``JaxPlanner(cfg, seed=0).init_trajs`` for the CFG
    evaluation config (its draw depends on the trajectory shape alone, which
    the full-size config shares)."""
    from autonomous_driving_with_diffusion_model_tpu.driving.plan import DiffusionPlanner as JaxPlanner
    from port_jax_cfg import jax_cfg_of

    full = tl.make_cfg("FREE_GUIDANCE")
    shape = (full.TPU.NUM_HYPOTHESES, full.MODEL.HORIZON, full.MODEL.TRANSITION_DIM)
    jcfg = jax_cfg_of(tl.make_cfg("FREE_GUIDANCE", hw=HW, quick=True))
    want = np.asarray(JaxPlanner(jcfg, seed=0).init_trajs)
    got = np.load(FIXTURE)
    assert got.shape == want.shape == shape == (1, 16, 7) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def distilled(tmp_path_factory):
    """A tiny CFG teacher (2 iterations) and its distillation 4 -> 2 -> 1
    in the harness's layout (``run/``, ``distill/``), with distill()'s
    result."""
    work = str(tmp_path_factory.mktemp("distilled"))
    data_root = os.path.join(work, "data")
    tl.write_dataset(data_root, 2, seed=0, hw=HW)
    trained = tl.train(data_root, os.path.join(work, "run"), hw=HW, max_iter=2, batch=2, use_cond="FREE_GUIDANCE",
                       quick=True, device="cpu")
    heldout = tl.heldout_samples(1)
    result = tl.distill(trained["checkpoint"], data_root, heldout, HW, use_cond="FREE_GUIDANCE", quick=True,
                        device="cpu", batch=2, start=4, iters=1, stages=2, workdir=work, cl_steps=3, cv_steps=3)
    return work, trained["checkpoint"], heldout, result


def test_distill_keeps_its_keys_and_values(distilled):
    """distill()'s JSON has the keys it had, and its teacher, students and
    gates are the factored-out evaluation's at seed 0 with no injection."""
    work, ckpt, heldout, result = distilled
    assert list(result) == DISTILL_KEYS
    assert result["stage_steps"] == [2, 1] and set(result["students"]) == {"2", "1"}
    assert set(result["teacher"]) == {"4", "2", "1"}
    assert all(set(p) == POINT_KEYS for p in (*result["teacher"].values(), *result["students"].values()))
    with open(os.path.join(work, "distill", "distill.json")) as f:
        manifest = json.load(f)
    again = tl.evaluate_distilled(manifest, ckpt, heldout, HW, use_cond="FREE_GUIDANCE", quick=True, device="cpu",
                                  start=4, cl_steps=3, cv_steps=3)
    assert again == {"teacher": result["teacher"], "students": result["students"], "gates": result["gates"]}
    assert result["gates"] == tl.distill_gates(result["teacher"], result["students"], ["2", "1"], 4)


def test_distill_draws_per_draw(distilled, tmp_path):
    """One record per draw: seed 0 is distill()'s own evaluation, JAX's
    draw is the evaluation with the fixture injected, float32 a draw again
    with every planner in float32; the students' graph plans against their
    eager body (the CPU runs the body: equal); the device named."""
    work, ckpt, heldout, result = distilled
    out = str(tmp_path / "draws.json")
    rec = tl.distill_draws(work, out, seeds=[0, 1], jax_init_trajs=FIXTURE, float32_draws=("jax",), quick=True,
                           device="cpu", cl_steps=3, cv_steps=3)
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(rec))
    assert list(rec["draws"]) == ["seed 0", "seed 1", "jax", "jax float32"]
    assert rec["device"] == "cpu" and rec["manifest"]["start_steps"] == 4
    # distill_draws reads 3 held-out samples per class; distill() above 1
    heldout3 = tl.heldout_samples(3)
    manifest = rec["manifest"]
    kw = dict(use_cond="FREE_GUIDANCE", quick=True, device="cpu", start=4, cl_steps=3, cv_steps=3)
    for name, extra in (("seed 1", dict(seed=1)), ("jax", dict(init_trajs=np.load(FIXTURE))),
                        ("jax float32", dict(init_trajs=np.load(FIXTURE), COMPUTE_DTYPE="float32"))):
        want = tl.evaluate_distilled(manifest, ckpt, heldout3, HW, **kw, **extra)
        assert rec["draws"][name] == {**want, "pass": all(want["gates"].values())}, name
    assert rec["draws"]["seed 0"]["teacher"] != rec["draws"]["seed 1"]["teacher"]
    assert set(rec["graph_vs_eager_max_abs_m"]) == {"2", "1"}
    assert all(v == 0.0 for v in rec["graph_vs_eager_max_abs_m"].values())


def test_injected_draw_is_what_the_planner_plans_from(distilled):
    """``init_trajs`` replaces the planner's own draw: a planner of another
    seed given seed 0's draw plans what seed 0's planner plans."""
    from autonomous_driving_with_diffusion_model_tpu_torch.driving import DiffusionPlanner

    work, ckpt, heldout, _ = distilled
    cfg = tl.make_cfg("FREE_GUIDANCE", hw=HW, quick=True)
    ref = DiffusionPlanner(cfg, checkpoint=ckpt, seed=0, device="cpu")
    other = DiffusionPlanner(cfg, checkpoint=ckpt, seed=5, device="cpu")
    frame = tl.heldout_frame(heldout[0], HW)
    target = heldout[0]["traj"][-1, :2]
    assert not np.array_equal(ref.plan(frame, target), other.plan(frame, target))
    other.init_trajs = ref.init_trajs.clone()
    np.testing.assert_array_equal(ref.plan(frame, target), other.plan(frame, target))
