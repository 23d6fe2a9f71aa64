"""The port imports neither JAX nor anything of the JAX package: every module
of ``autonomous_driving_with_diffusion_model_tpu_torch`` and ``chip_smoke``
import in a fresh interpreter where ``import jax`` and ``import flax`` fail;
the leaderboard agent, loaded by file path as the harness loads it, ticks
with neither them nor ``cv2`` and ``PIL``; the PNG reader and the train
CLI read and train with neither; and the simulator layer imports with no
``carla``, ``cv2``, ``PIL`` or ``h5py``, and collects and audits a dataset
from its CARLA env (over ``tests/mock_carla.py``) without ``cv2`` and ``PIL``."""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.path.insert(0, REPO)
import autonomous_driving_with_diffusion_model_tpu_torch as port
names = [port.__name__] + [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
jax_side = sorted(m for m in sys.modules
                  if m == "autonomous_driving_with_diffusion_model_tpu"
                  or m.startswith("autonomous_driving_with_diffusion_model_tpu.")
                  or m == "learnability")
print(json.dumps({"imported": names, "jax_side": jax_side,
                  "jax": [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax")
                          and sys.modules[m] is not None]}))
"""


def _probe():
    code = _PROBE.replace("REPO", repr(REPO))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_without_jax_or_the_jax_package():
    result = _probe()
    # every subpackage of the slice was reached
    for sub in ("utils.config", "ops.kernels", "ops.build", "models.temporal_unet",
                "models.convert", "models.resnet", "models.scorer", "diffusion.sampler",
                "diffusion.dpm", "diffusion.steps", "data.augment", "driving.plan",
                "utils.watchdog", "driving.pid", "driving.controller", "driving.gps",
                "driving.planner", "driving.fake_env", "driving.interact_agent",
                "driving.leaderboard_agent", "driving.scoring", "driving.statistics",
                "driving.leaderboard_stats", "driving.routes", "driving.evaluator",
                "driving.evaluate_cli", "sim.suites", "interact", "data.png", "data.dataset",
                "train.ema", "train.state", "train.checkpoint", "train.cli", "utils.meters",
                "utils.tracker", "utils.profiling", "diffusion.distill", "distill", "parallel",
                "parallel.distributed", "parallel.ddp", "parallel.check", "data.validate",
                "sim.server_utils", "sim.weather", "sim.criteria", "sim.obs", "sim.reward",
                "sim.terminal", "sim.traffic_lights", "sim.expert", "sim.route_planner",
                "sim.scenario_actors", "sim.scenario_injection", "sim.birdview", "sim.map_raster",
                "sim.carla_env", "sim.create_agent", "sim.obs_handler", "sim.noiser", "sim.collector",
                "sim.collect_loop", "sim.collect_cli", "learnability", "entry", "driving.program",
                "models.conditional_unet1d"):
        assert f"autonomous_driving_with_diffusion_model_tpu_torch.{sub}" in result["imported"]
    assert result["jax_side"] == []
    assert result["jax"] == []


# The harness's way: the bare file by path, no parent package, with jax,
# flax, cv2 and PIL unimportable; then one agent ticks past its warm-up on
# the CPU at a tiny size.
_LEADERBOARD_PROBE = r"""
import importlib.util, json, os, sys
for name in ("jax", "flax", "cv2", "PIL"):
    sys.modules[name] = None
path = os.path.join(REPO, "autonomous_driving_with_diffusion_model_tpu_torch", "driving",
                    "leaderboard_agent.py")
spec = importlib.util.spec_from_file_location("leaderboard_agent", path)
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
import numpy as np
agent = getattr(mod, mod.get_entry_point())(CFG, device="cpu")
agent.set_global_plan(None, [((float(i * 5), 0.0), 4) for i in range(20)])
rng = np.random.default_rng(0)
controls = []
for step in range(3):
    c = agent.run_step({
        "rgb": (step, rng.integers(0, 255, (32, 48, 4), dtype=np.uint8)),
        "bev": (step, rng.integers(0, 255, (64, 64, 4), dtype=np.uint8)),
        "gps": (step, np.array([1.0 * step, 0.0, 0.0])),
        "speed": (step, {"speed": 1.0}),
        "imu": (step, np.zeros(7)),
    }, 0.05 * step)
    controls.append([c.throttle, c.steer, c.brake])
mods = [m for m in sys.modules if sys.modules[m] is not None]
print(json.dumps({
    "package": mod.DiffusionPlanner.__module__,
    "controls": controls,
    "jax_side": sorted(m for m in mods if m.split(".")[0] == "autonomous_driving_with_diffusion_model_tpu"),
    "blocked": sorted(m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "flax", "cv2", "PIL")),
}))
"""


def test_leaderboard_agent_by_file_path_imports_no_jax_and_no_cv2(tmp_path):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("MODEL:\n  DIM: 8\n  PERCEPTION: tiny\nEVAL:\n  SAMPLE_STEPS: 2\n"
                   "TRAIN:\n  IMAGE_HEIGHT: 32\n  IMAGE_WIDTH: 48\n")
    code = _LEADERBOARD_PROBE.replace("REPO", repr(REPO)).replace("CFG", repr(str(cfg)))
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "SAVE_PATH", "AGENT_OPTS")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(tmp_path), env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    # the fallback imports reached the port, not the JAX package
    assert result["package"] == "autonomous_driving_with_diffusion_model_tpu_torch.driving.plan"
    assert result["jax_side"] == [] and result["blocked"] == []
    assert result["controls"][0] == [0.0, 0.0, 0.0]  # the warm-up tick
    assert all(np.isfinite(c).all() for c in result["controls"])


# The train CLI's machine has neither OpenCV nor PIL: with them, jax and
# flax blocked, data/png.py writes and reads a frame and the CLI trains one
# iteration on the CPU (no sampling, which paints with cv2).
_TRAIN_PROBE = r"""
import json, os, sys
for name in ("jax", "flax", "cv2", "PIL"):
    sys.modules[name] = None
sys.path.insert(0, REPO)
import numpy as np
from autonomous_driving_with_diffusion_model_tpu_torch.data.png import read_png, write_png
from autonomous_driving_with_diffusion_model_tpu_torch.train import cli
root = os.path.join(TMP, "data")
for sub in ("front", "waypoints"):
    os.makedirs(os.path.join(root, sub))
rng = np.random.default_rng(0)
frames = rng.integers(0, 256, (2, 32, 48, 3), dtype=np.uint8)
for i, frame in enumerate(frames):
    write_png(os.path.join(root, "front", f"{i:06d}.png"), frame, 4)
    with open(os.path.join(root, "waypoints", f"{i:06d}.txt"), "w") as f:
        f.write("0.1 0.2\n" + "\n".join(["0 0 0 0 0 0 0"] * 16) + "\n")
same = bool((read_png(os.path.join(root, "front", "000001.png")) == frames[1]).all())
state = cli.main(cli.parse_args(["--device", "cpu", "--max-iter", "1", "--opts", "MODEL.DIM", "8",
    "MODEL.PERCEPTION", "tiny", "TRAIN.ROOT", root, "PROJECT_DIR", os.path.join(TMP, "run"),
    "TRAIN.BATCH_SIZE", "2", "TRAIN.SAMPLE_INTERVAL", "0", "TRAIN.LOG_INTERVAL", "1"]))
mods = [m for m in sys.modules if sys.modules[m] is not None]
print(json.dumps({"same": same, "step": state.step,
                  "blocked": sorted(m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "flax", "cv2", "PIL")),
                  "jax_side": sorted(m for m in mods if m.split(".")[0] == "autonomous_driving_with_diffusion_model_tpu")}))
"""


def test_png_and_train_cli_need_no_cv2_or_pil(tmp_path):
    code = _TRAIN_PROBE.replace("REPO", repr(REPO)).replace("TMP", repr(str(tmp_path)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=str(tmp_path),
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result == {"same": True, "step": 1, "blocked": [], "jax_side": []}


# The simulator layer: importing it needs none of carla (imported inside
# the functions that talk to a server), cv2, PIL or h5py (the birdview and
# the map rasterizer import them when they run); with cv2 and PIL blocked,
# the collector writes 2 samples from CarlaDrivingEnv over the mock, the
# audit reads them clean, and the port's dataset loads them.
_SIM_PROBE = r"""
import json, os, sys
for name in ("jax", "flax", "cv2", "PIL", "h5py", "carla"):
    sys.modules[name] = None
sys.path.insert(0, REPO)
import autonomous_driving_with_diffusion_model_tpu_torch.sim as sim
import autonomous_driving_with_diffusion_model_tpu_torch.data.validate as validate
mods = [m for m in sys.modules if sys.modules[m] is not None]
imported = {"blocked": sorted(m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "flax", "cv2", "PIL", "h5py", "carla")),
            "jax_side": sorted(m for m in mods if m.split(".")[0] == "autonomous_driving_with_diffusion_model_tpu")}
sys.path.insert(0, os.path.join(REPO, "tests"))
import mock_carla
sys.modules["carla"] = mock_carla
from autonomous_driving_with_diffusion_model_tpu_torch.sim.carla_env import CarlaDrivingEnv
env = CarlaDrivingEnv(seed=2)
root = os.path.join(TMP, "data")
saved = sim.DataCollector(env, root, total_to_save=2, save_every_n_frame=1, buffer_frames=2).run(max_env_steps=200)
env.close()
report = validate.validate_dataset(root)
from autonomous_driving_with_diffusion_model_tpu_torch.data import TrajDataset
item = TrajDataset(root)[1]
mods = [m for m in sys.modules if sys.modules[m] is not None]
print(json.dumps({"imported": imported, "saved": saved, "ok": report["ok"], "hw": report["image_hw"],
                  "trajs": list(item["trajs"].shape),
                  "blocked": sorted(m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "flax", "cv2", "PIL", "h5py")),
                  "jax_side": sorted(m for m in mods if m.split(".")[0] == "autonomous_driving_with_diffusion_model_tpu")}))
"""


def test_sim_imports_without_carla_and_collects_without_cv2_or_pil(tmp_path):
    code = _SIM_PROBE.replace("REPO", repr(REPO)).replace("TMP", repr(str(tmp_path)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=str(tmp_path),
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result == {"imported": {"blocked": [], "jax_side": []}, "saved": 2, "ok": True, "hw": [256, 900],
                      "trajs": [16, 7], "blocked": [], "jax_side": []}


# The learnability harness and the entry points: with jax, flax, cv2 and PIL
# blocked they import, the harness writes its dataset (data/png.py) and the
# port's dataset reads it back; neither reaches the root learnability.py.
_LEARNABILITY_PROBE = r"""
import json, os, sys
for name in ("jax", "flax", "cv2", "PIL"):
    sys.modules[name] = None
sys.path.insert(0, REPO)
from autonomous_driving_with_diffusion_model_tpu_torch import entry, learnability
from autonomous_driving_with_diffusion_model_tpu_torch.data import TrajDataset
from autonomous_driving_with_diffusion_model_tpu_torch.utils import profiling
samples = learnability.write_dataset(os.path.join(TMP, "d"), 1, 0, (32, 48))
item = TrajDataset(os.path.join(TMP, "d"))[2]
mods = [m for m in sys.modules if sys.modules[m] is not None]
print(json.dumps({"n": len(samples), "same": bool((item["trajs"] == samples[2]["traj"]).all()),
                  "image": list(item["image"].shape),
                  "blocked": sorted(m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "flax", "cv2", "PIL")),
                  "jax_side": sorted(m for m in mods if m.split(".")[0] in
                                     ("autonomous_driving_with_diffusion_model_tpu", "learnability"))}))
"""


def test_learnability_and_entry_need_no_jax_cv2_or_pil(tmp_path):
    code = _LEARNABILITY_PROBE.replace("REPO", repr(REPO)).replace("TMP", repr(str(tmp_path)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=str(tmp_path),
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result == {"n": 3, "same": True, "image": [32, 48, 3], "blocked": [], "jax_side": []}
