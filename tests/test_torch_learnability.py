"""The port's learnability harness (``..._torch/learnability.py``) against
the repo root's ``learnability.py``: the renderer, the expert, the routes and
the gates bit-equal; the dataset the port writes (with ``data/png.py``) read
by the JAX ``TrajDataset`` as the JAX writer's files are; the closed loops,
the counterfactual labels and the outcome dataset equal when both packages'
envs are driven by one deterministic stub planner; ``heldout_l2_m`` through
both ``DiffusionPlanner``s on the same weights; the analytic scorers'
regrets; and one ``--quick --device cpu`` run end to end."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import learnability as jl  # noqa: E402  (the JAX package's script)

from autonomous_driving_with_diffusion_model_tpu_torch import learnability as tl  # noqa: E402

HW = (64, 96)
# meters: float32 plans of DDIM-2 on both sides, x 23.3 m (tests/test_torch_plan.py)
PLAN_TOL = dict(atol=5e-3, rtol=1e-4)
# the result keys of the JAX script's JSON (learnability.py:937-973)
JAX_KEYS = {
    "quick", "use_cond", "bn_mode", "model_dim", "perception", "image_hw", "train_iters", "train_seconds",
    "n_train", "n_heldout", "heldout_waypoint_rms_m_trained", "heldout_waypoint_rms_m_untrained",
    "class_separation_ok", "final_lateral_mean_by_class_m", "closedloop_completion_trained",
    "closedloop_completion_untrained", "closedloop_completion_expert_pace", "closedloop_mean_abs_lat_m_trained",
    "closedloop_mean_abs_lat_m_untrained", "curved_completion_trained", "curved_completion_untrained",
    "curved_mean_dev_m_trained", "curved_mean_dev_m_untrained", "k8_scorer_closedloop", "learned_scorer",
    "controllability", "distill", "pass",
}


@pytest.mark.parametrize("curv", [-0.12, -0.05, -0.003, 0.0, 0.021, 0.05, 0.1])
@pytest.mark.parametrize("hw", [(64, 96), (256, 900)])
def test_render_frame_bit_equal(curv, hw):
    a = jl.render_frame(curv, np.random.default_rng(5), hw)
    b = tl.render_frame(curv, np.random.default_rng(5), hw)
    assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b)


@pytest.mark.parametrize("curv", [-0.05, 0.0, 0.0042, 0.05])
def test_expert_trajectory_bit_equal(curv):
    a = jl.expert_trajectory(curv, np.random.default_rng(3))
    b = tl.expert_trajectory(curv, np.random.default_rng(3))
    assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("step_m", [0.5, 0.7])
def test_routes_and_lookahead_bit_equal(step_m):
    (pa, sa), (pb, sb) = jl.build_s_curve_route(step_m), tl.build_s_curve_route(step_m)
    assert np.array_equal(pa, pb) and np.array_equal(sa, sb)
    rng = np.random.default_rng(1)
    for _ in range(20):
        pos, yaw = rng.uniform([-5, -5], [90, 40]), float(rng.uniform(-np.pi, np.pi))
        assert jl.ego_lookahead(pa, sa, pos, yaw) == tl.ego_lookahead(pb, sb, pos, yaw)
        assert jl.route_deviation_and_progress(pa, pos) == tl.route_deviation_and_progress(pb, pos)
        geom = tl._route_geometry(pb)
        assert jl.route_deviation_and_progress(pa, pos, jl._route_geometry(pa)) == \
            tl.route_deviation_and_progress(pb, pos, geom)


def test_distill_gates_bit_equal():
    """The committed JAX DISTILL.json re-gated by both, and a failing variant."""
    with open(os.path.join(REPO, "DISTILL.json")) as f:
        rec = json.load(f)
    measured = list(rec["students"])
    args = (rec["teacher"], rec["students"], measured, rec["start_steps"])
    assert tl.distill_gates(*args) == jl.distill_gates(*args) == rec["gates"]
    worse = json.loads(json.dumps(rec["students"]))
    for k in worse:
        worse[k]["mean_abs_lat_m"] *= 10.0
        worse[k]["heldout_rms_m"] *= 2.0
    args = (rec["teacher"], worse, measured, rec["start_steps"])
    assert tl.distill_gates(*args) == jl.distill_gates(*args)
    assert not all(tl.distill_gates(*args).values())


@pytest.mark.parametrize("name", ["LEARNABILITY.json", "LEARNABILITY_CFG.json", "LEARNABILITY_CLS.json"])
def test_gates_of_the_committed_jax_results(name):
    """``gates_pass`` is the JAX script's gate: it passes the committed JAX
    results, as their ``pass`` says, and fails them with the trained RMS
    raised to the untrained one's."""
    with open(os.path.join(REPO, name)) as f:
        rec = json.load(f)
    assert tl.gates_pass(rec, rec["quick"]) == rec["pass"] is True
    rec["heldout_waypoint_rms_m_trained"] = rec["heldout_waypoint_rms_m_untrained"]
    assert tl.gates_pass(rec, rec["quick"]) is False


def test_heldout_samples_match_the_jax_construction():
    rng_h = np.random.default_rng(7)  # learnability.py:577-585
    want = [{"curv": c + rng_h.uniform(-0.004, 0.004), "traj": None, "frame_idx": 900 + i}
            for i, c in enumerate([cl for cl in jl.CLASSES for _ in range(3)])]
    for s in want:
        s["traj"] = jl.expert_trajectory(s["curv"], np.random.default_rng(50 + s["frame_idx"]))
    got = tl.heldout_samples(3)
    assert [(s["curv"], s["frame_idx"]) for s in got] == [(s["curv"], s["frame_idx"]) for s in want]
    assert all(np.array_equal(a["traj"], b["traj"]) for a, b in zip(got, want))


def test_dataset_items_equal_the_jax_writers(tmp_path):
    """The JAX ``TrajDataset`` reads the port's files (RGB PNGs by
    ``data/png.py``) as it reads the JAX writer's (``cv2``, BGR): every item
    equal, the BEV crops equal, the waypoint text identical."""
    import cv2

    from autonomous_driving_with_diffusion_model_tpu.data.dataset import TrajDataset

    port_root, jax_root = str(tmp_path / "port"), str(tmp_path / "jax")
    got = tl.write_dataset(port_root, n_per_class=2, seed=0, hw=HW)
    want = jl.write_dataset(jax_root, n_per_class=2, seed=0, hw=HW)
    assert [(s["curv"], s["frame_idx"]) for s in got] == [(s["curv"], s["frame_idx"]) for s in want]
    a, b = TrajDataset(port_root), TrajDataset(jax_root)
    assert len(a) == len(b) == 6
    for i in range(len(a)):
        ia, ib = a[i], b[i]
        assert set(ia) == set(ib)
        for k in ia:
            assert np.array_equal(ia[k], ib[k]), (i, k)
        name = f"{i:06d}"
        assert np.array_equal(cv2.imread(f"{port_root}/bev/{name}.png"), cv2.imread(f"{jax_root}/bev/{name}.png"))
        with open(f"{port_root}/waypoints/{name}.txt") as fa, open(f"{jax_root}/waypoints/{name}.txt") as fb:
            assert fa.read() == fb.read()


class StubPlanner:
    """A deterministic planner of the frame it sees: the marking's column
    centroid in the road's lower half sets the steer, the target adds to it;
    K hypotheses spread the steer. Both packages' loops drive it."""

    def __init__(self, k=4):
        self.k = k

    def plan_hypotheses(self, frame, target=None):
        frame = np.asarray(frame)
        h, w = frame.shape[:2]
        lower = frame[h // 2:].astype(np.int32)
        bright = lower[..., 0] > 200
        cx = float(np.nonzero(bright)[1].mean()) if bright.any() else w / 2
        steer = np.clip((cx - w / 2) / (w / 4), -1.0, 1.0) * 0.4
        if target is not None:
            steer += 2.0 * float(np.asarray(target).reshape(-1)[0])
        trajs = []
        for j in range(self.k):
            s = float(np.clip(steer + 0.1 * (j - (self.k - 1) / 2), -1, 1))
            t = np.zeros((16, 7), np.float32)
            t[:, 0] = np.arange(1, 17) * s * 0.3
            t[:, 1] = -np.arange(1, 17) * 0.5
            t[:, 4:] = (0.55 + 0.02 * j, s, 0.01 * j)
            trajs.append(t)
        return np.stack(trajs), self.k // 2

    def plan(self, frame, target=None):
        trajs, best = self.plan_hypotheses(frame, target)
        return trajs[best][None]


@pytest.mark.parametrize("use_target", [False, True])
def test_closed_loops_equal_under_a_stub_planner(use_target):
    stub = StubPlanner()
    assert tl.closed_loop_completion(stub, HW, steps=60, use_target=use_target) == \
        jl.closed_loop_completion(stub, HW, steps=60, use_target=use_target)
    assert tl.closed_loop_curved(stub, HW, max_steps=80, use_target=use_target) == \
        jl.closed_loop_curved(stub, HW, max_steps=80, use_target=use_target)


@pytest.mark.parametrize("steps", [40, 120])
def test_expert_pace_equal(steps):
    assert tl.closed_loop_expert_pace(steps) == jl.closed_loop_expert_pace(steps)


def test_candidate_outcome_equal_and_state_restored():
    from autonomous_driving_with_diffusion_model_tpu.driving.fake_env import FakeDrivingEnv as JaxEnv
    from autonomous_driving_with_diffusion_model_tpu_torch.driving.fake_env import FakeDrivingEnv as PortEnv

    route, _ = tl.build_s_curve_route()
    cams = lambda e: tl.render_frame(0.01, np.random.default_rng(e.steps), HW)
    envs = [cls(route=route, image_hw=HW, seed=4, image_fn=cams) for cls in (JaxEnv, PortEnv)]
    for env in envs:
        env.reset()
        for _ in range(5):
            env.step({0: np.array([0.6, 0.1, 0.0])})
    trajs, _ = StubPlanner(k=3).plan_hypotheses(tl.render_frame(0.05, np.random.default_rng(0), HW))
    for cand in trajs:
        pos = [env.pos.copy() for env in envs]
        got = tl.candidate_outcome(envs[1], cand)
        assert got == jl.candidate_outcome(envs[0], cand)
        assert all(np.array_equal(p, env.pos) for p, env in zip(pos, envs))  # restored


def test_outcome_dataset_equal_under_a_stub_planner():
    got = tl.collect_outcome_dataset(StubPlanner(), HW, episodes=2, steps_per_ep=6, seed=1)
    want = jl.collect_outcome_dataset(StubPlanner(), HW, episodes=2, steps_per_ep=6, seed=1)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_analytic_scorer_regrets_match_jax():
    rng = np.random.default_rng(2)
    n, k = 40, 8
    trajs = rng.standard_normal((n, k, 16, 7)).astype(np.float32)
    trajs[..., 1] -= np.arange(1, 17, dtype=np.float32) * 0.5  # forward, so the guard picks either branch
    targets = (0.2 * rng.standard_normal((n, 2))).astype(np.float32)
    outcomes = rng.uniform(0, 3, (n, k)).astype(np.float32)
    idx = np.arange(3, n, 2)
    got = tl.analytic_scorer_regrets(trajs, targets, outcomes, idx)
    want = jl.analytic_scorer_regrets(trajs, targets, outcomes, idx)
    assert set(got) == set(want) == {"distance", "jerk", "guidance_loss"}
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-6, (key, got[key], want[key])


@pytest.mark.parametrize("use_target", [False, True])
def test_heldout_l2_matches_the_jax_planner(use_target):
    """``heldout_l2_m`` through the port's and the JAX ``DiffusionPlanner``:
    the JAX planner's weights converted by ``from_jax_variables``, its init
    noise injected, MODEL.DIM 8, tiny perception, DDIM-2, float32 (a bf16
    forward rounds at other places on the two sides)."""
    from autonomous_driving_with_diffusion_model_tpu.driving.plan import DiffusionPlanner as JaxPlanner
    from port_jax_cfg import jax_cfg_of
    from autonomous_driving_with_diffusion_model_tpu_torch.driving import DiffusionPlanner
    from autonomous_driving_with_diffusion_model_tpu_torch.models.convert import from_jax_variables

    cfg = tl.make_cfg(hw=HW, quick=True)
    cfg.EVAL.SAMPLE_STEPS = 2
    cfg.TPU.COMPUTE_DTYPE = "float32"
    jcfg = jax_cfg_of(cfg)
    jax_planner = JaxPlanner(jcfg, seed=1)
    port = DiffusionPlanner(cfg, device="cpu")
    port.model.load_state_dict(from_jax_variables(jax_planner.variables, cfg), strict=True)
    port.init_trajs = torch.from_numpy(np.array(jax_planner.init_trajs))
    heldout = tl.heldout_samples(2)
    rms, sep, lats = tl.heldout_l2_m(port, heldout, HW, use_target)
    j_rms, j_sep, j_lats = jl.heldout_l2_m(jax_planner, heldout, HW, use_target)
    np.testing.assert_allclose(rms, j_rms, **PLAN_TOL)
    assert set(lats) == set(j_lats)
    np.testing.assert_allclose([lats[k] for k in sorted(lats)], [j_lats[k] for k in sorted(lats)], **PLAN_TOL)
    assert sep == j_sep


class RecordingPlanner:
    """A planner whose every plan is kept, in meters."""

    def __init__(self, planner):
        self.planner, self.plans = planner, []

    def plan(self, frame, target=None):
        out = np.asarray(self.planner.plan(frame, target))
        self.plans.append(out.copy())
        return out


def test_cfg_student_closed_loop_matches_the_jax_planner():
    """``closed_loop_completion`` of a CFG student deployed as the distill
    CLI says (its 2-step grid, ``GUIDANCE.FREE_SCALE`` 1.0, one conditional
    pass a step) through the port's and the JAX ``DiffusionPlanner`` on the
    same weights (``from_jax_variables``), float32, the JAX planner's init
    noise injected: every tick's plan within 1e-4 m, and the completion and
    mean |lateral| too."""
    from autonomous_driving_with_diffusion_model_tpu.driving.plan import DiffusionPlanner as JaxPlanner
    from port_jax_cfg import jax_cfg_of
    from autonomous_driving_with_diffusion_model_tpu_torch.driving import DiffusionPlanner
    from autonomous_driving_with_diffusion_model_tpu_torch.models.convert import from_jax_variables

    cfg = tl.make_cfg("FREE_GUIDANCE", hw=HW, quick=True, SAMPLE_TIMESTEPS=[98, 34])
    cfg.GUIDANCE.FREE_SCALE = 1.0
    cfg.TPU.COMPUTE_DTYPE = "float32"
    jcfg = jax_cfg_of(cfg)
    jax_planner = RecordingPlanner(JaxPlanner(jcfg, seed=2))
    port = DiffusionPlanner(cfg, device="cpu")
    port.model.load_state_dict(from_jax_variables(jax_planner.planner.variables, cfg), strict=True)
    port.init_trajs = torch.from_numpy(np.array(jax_planner.planner.init_trajs))
    port = RecordingPlanner(port)
    got = tl.closed_loop_completion(port, HW, use_target=True)
    want = jl.closed_loop_completion(jax_planner, HW, use_target=True)
    assert len(port.plans) == len(jax_planner.plans) > 0
    for tick, (a, b) in enumerate(zip(port.plans, jax_planner.plans)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=f"tick {tick}")
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_meter_times_reads_the_train_log(tmp_path):
    log = tmp_path / "train.log"
    log.write_text("2026 | INFO | iter: [20/60]\ttime: 0.092 (0.092)\teta: 0:00:03\tlr: 1.9e-06\tloss 0.2447\n"
                   "2026 | INFO | Device-resident dataset: 24 samples\n"
                   "2026 | INFO | iter: [40/60]\ttime: 0.036 (0.064)\teta: 0:00:01\tlr: 3.9e-06\tloss 0.2550\n")
    assert tl.meter_times(str(log)) == [0.092, 0.036]


def test_without_a_card_and_without_device_cpu_it_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.main(["--quick", "--workdir", str(tmp_path), "--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


# ``--quick --device cpu`` end to end, in a fresh interpreter where jax,
# flax, cv2 and PIL cannot be imported: the dataset, the train CLI, the
# evaluation, the JSON with the JAX script's keys
_QUICK = r"""
import json, sys
for name in ("jax", "flax", "cv2", "PIL"):
    sys.modules[name] = None
sys.path.insert(0, REPO)
import torch
torch.set_num_threads(2)
from autonomous_driving_with_diffusion_model_tpu_torch import learnability
learnability.main(["--quick", "--device", "cpu", "--workdir", TMP + "/work", "--out", TMP + "/out.json"])
mods = [m for m in sys.modules if sys.modules[m] is not None]
print(json.dumps({"blocked": sorted(m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "flax", "cv2", "PIL")),
                  "jax_side": sorted(m for m in mods if m.split(".")[0] in
                                     ("autonomous_driving_with_diffusion_model_tpu", "learnability"))}))
"""


def test_quick_cpu_run_writes_the_json(tmp_path):
    code = _QUICK.replace("REPO", repr(REPO)).replace("TMP", repr(str(tmp_path)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=str(tmp_path), env=env,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"blocked": [], "jax_side": []}
    with open(tmp_path / "out.json") as f:
        result = json.load(f)
    assert JAX_KEYS <= set(result)
    assert result["quick"] is True and result["model_dim"] == 8 and result["perception"] == "tiny"
    assert result["train_iters"] == 60 and result["n_train"] == 24 and result["n_heldout"] == 9
    assert result["device"] == "cpu" and result["train_samples_per_s"] > 0
    assert np.isfinite(result["heldout_waypoint_rms_m_trained"]) and isinstance(result["pass"], bool)
    assert result["pass"] == tl.gates_pass(result, True)
    assert os.path.exists(tmp_path / "work" / "run" / "checkpoints" / "final.pt")
