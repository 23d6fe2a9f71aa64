"""The port's data collection on the CPU against the JAX package's: the
collector on the same env in both packages (the fake env and the CARLA env
over ``tests/mock_carla.py``, with its red-light synthesis), the collection
CLI, the crash-restart supervisor and the shard merge. Waypoint files must
be byte-equal and the decoded ``front/`` and ``bev/`` images pixel-equal:
the JAX collector writes with PIL and paints with ``cv2.circle``, the port
with ``data/png.py`` and ``sim/collector.py:fill_disc``."""

import importlib
import os
import os.path as osp
import sys

import cv2
import numpy as np
import pytest

from test_torch_sim_env import JAX, PORT, integration_task, mock, sim  # noqa: F401  (mock: a fixture)


def _files(root):
    return {sub: sorted(os.listdir(osp.join(root, sub))) for sub in ("front", "bev", "waypoints")}


def assert_same_dataset(got_root, want_root, n):
    files = _files(want_root)
    assert files == _files(got_root)
    # a sample writes its front image first: one cut short leaves it alone
    assert len(files["bev"]) == len(files["waypoints"]) == n <= len(files["front"]) <= n + 1
    for name in files["waypoints"]:
        with open(osp.join(got_root, "waypoints", name), "rb") as a, open(osp.join(want_root, "waypoints", name), "rb") as b:
            assert a.read() == b.read(), name
    for sub in ("front", "bev"):
        for name in files[sub]:
            got, want = (cv2.imread(osp.join(r, sub, name), cv2.IMREAD_UNCHANGED) for r in (got_root, want_root))
            assert got is not None and want is not None
            assert got.shape == want.shape and np.array_equal(got, want), f"{sub}/{name}"


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_fill_disc_matches_cv2_circle(channels):
    """The radius-3 disc against ``cv2.circle(img, c, 3, (0, 255, 0), -1)``,
    with centres on, near and off the image's edges."""
    from autonomous_driving_with_diffusion_model_tpu_torch.sim.collector import fill_disc

    rng = np.random.default_rng(channels)
    for _ in range(300):
        h, w = (int(v) for v in rng.integers(1, 24, 2))
        img = rng.integers(0, 256, (h, w, channels), np.uint8)
        img = img[..., 0].copy() if channels == 1 else img
        center = (int(rng.integers(-6, w + 6)), int(rng.integers(-6, h + 6)))
        want = cv2.circle(img.copy(), center, 3, (0, 255, 0), -1)
        got = fill_disc(img.copy(), center)
        assert np.array_equal(got, want), (h, w, center)


class FakeLayout:
    """The JAX collector reads observations as the fake env lays them out
    (``next_waypoint`` (1, 2), the BEV in a list of one) and raises on
    ``CarlaDrivingEnv``'s own (``test_jax_collector_raises_on_its_carla_env``).
    This gives the JAX collector that layout and changes nothing else, so
    the port's collector on the bare env is held to it."""

    def __init__(self, env):
        self.env = env

    @staticmethod
    def _layout(obs):
        obs = dict(obs)
        obs["next_waypoint"] = np.asarray(obs["next_waypoint"]).reshape(-1, 2)
        obs["bev"] = [obs["bev"]]
        return obs

    def reset(self):
        return self._layout(self.env.reset())

    def step(self, action):
        obs, *rest = self.env.step(action)
        return (self._layout(obs), *rest)

    def close(self):
        self.env.close()


def _collect(pkg, root, env_kind, mock_carla, monkeypatch):
    col = sim(pkg, "collector")
    kwargs = dict(total_to_save=3, save_every_n_frame=1, buffer_frames=2, step_to_reset=10000)
    if env_kind == "fake":
        fake = importlib.import_module(f"{pkg}.driving.fake_env")
        env = fake.FakeDrivingEnv(image_hw=(32, 48), bev_hw=(512, 512), seed=4)
        return col.DataCollector(env, root, **kwargs).run(max_env_steps=500)
    monkeypatch.setattr(mock_carla._Vehicle, "_next_id", 1)
    wrap = FakeLayout if pkg == JAX else (lambda env: env)
    if env_kind == "carla":
        env = wrap(sim(pkg, "carla_env").CarlaDrivingEnv(seed=2, num_zombie_vehicles=2))
        saved = col.DataCollector(env, root, **dict(kwargs, save_every_n_frame=2)).run(max_env_steps=300)
    else:  # the integration route's red light: the synthesized full-brake samples
        env = sim(pkg, "carla_env").CarlaDrivingEnv(seed=0, tasks=[integration_task(pkg)])
        light = mock_carla.TrafficLight(x=57.0, state="Red")
        env.world.actors.append(light)
        env = wrap(env)
        saved = col.DataCollector(
            env, root, **dict(kwargs, total_to_save=8, save_every_n_frame=2),
            is_at_red_light=lambda: light.state == "Red",
            force_green_light=lambda: setattr(light, "state", "Green"),
        ).run(max_env_steps=450)
    env.close()
    return saved


@pytest.mark.parametrize("env_kind", ["fake", "carla", "carla_red_light"])
def test_collector_matches_jax(tmp_path, mock, monkeypatch, env_kind):
    saved = {pkg: _collect(pkg, str(tmp_path / pkg), env_kind, mock, monkeypatch) for pkg in (JAX, PORT)}
    assert saved[PORT] == saved[JAX] > 0
    assert_same_dataset(str(tmp_path / PORT), str(tmp_path / JAX), saved[JAX])
    # the waypoints are painted: pure green pixels on every BEV
    for name in sorted(os.listdir(tmp_path / PORT / "bev")):
        bev = cv2.imread(str(tmp_path / PORT / "bev" / name))
        assert ((bev[..., 0] == 0) & (bev[..., 1] == 255) & (bev[..., 2] == 0)).sum() >= 21
    from autonomous_driving_with_diffusion_model_tpu_torch.data import TrajDataset

    ds = TrajDataset(str(tmp_path / PORT))
    assert len(ds) in (saved[PORT], saved[PORT] + 1) and ds[0]["trajs"].shape == (16, 7)
    if env_kind == "carla_red_light":
        rows = [np.loadtxt(tmp_path / PORT / "waypoints" / n, skiprows=1) for n in sorted(os.listdir(
            tmp_path / PORT / "waypoints"))]
        assert any(np.all(r == r[0]) and r[0, 6] == 1.0 for r in rows), "no red-light sample"


def test_jax_collector_raises_on_its_carla_env(tmp_path, mock):
    """The difference FakeLayout bridges: the JAX collector unpacks
    CarlaDrivingEnv's (1, 2) target as a point and raises; the port's reads
    the env's layout (``sim/collector.py:_first_image``)."""
    kwargs = dict(total_to_save=1, save_every_n_frame=1, buffer_frames=2)
    env = sim(JAX, "carla_env").CarlaDrivingEnv(seed=2)
    with pytest.raises(ValueError, match="not enough values to unpack"):
        sim(JAX, "collector").DataCollector(env, str(tmp_path / JAX), **kwargs).run(max_env_steps=60)
    env = sim(PORT, "carla_env").CarlaDrivingEnv(seed=2)
    assert sim(PORT, "collector").DataCollector(env, str(tmp_path / PORT), **kwargs).run(max_env_steps=60) == 1


@pytest.mark.parametrize("env_kind", ["fake", "carla_native"])
def test_collect_cli_matches_jax(tmp_path, mock, monkeypatch, env_kind):
    """Each package's collect_cli with the same seed: the fake env, and the
    ``carla_native`` factory over the mock with ``create_server`` stubbed
    (there is no CarlaUE4.sh to start)."""
    argv = ["--save-num", "2", "--save-every-n-frame", "1", "--seed", "7", "--max-env-steps", "400"]
    argv += ["--fake-env"] if env_kind == "fake" else ["--env-factory", "carla_native", "--town", "Town01"]
    servers = []

    class Server:
        def stop(self):
            servers.append("stopped")

    for pkg in (JAX, PORT):
        ca = sim(pkg, "create_agent")
        monkeypatch.setattr(ca, "create_server", lambda config, off_screen=False: servers.append(config) or Server())
        if pkg == JAX:
            real = ca.create_env
            monkeypatch.setattr(ca, "create_env", lambda config, seed=0: FakeLayout(real(config, seed)))
        monkeypatch.setattr(mock._Vehicle, "_next_id", 1)
        root = str(tmp_path / pkg)
        cli = sim(pkg, "collect_cli")
        if pkg == JAX:
            monkeypatch.setattr(sys, "argv", ["collect_cli", "--save-path", root, *argv])
            cli.main()
        else:
            assert cli.main(["--save-path", root, *argv]) == 2
    assert_same_dataset(str(tmp_path / PORT), str(tmp_path / JAX), 2)
    if env_kind == "carla_native":
        config = {"factory": "carla_native", "town": "Town01", "port": 2000}
        assert servers == [config, "stopped", config, "stopped"]
    assert sim(PORT, "collect_cli").get_random_seed() >= 0


def _make_shard(root, n, start=0, drop_waypoints_for=()):
    for sub in ("front", "bev", "waypoints"):
        os.makedirs(osp.join(root, sub), exist_ok=True)
    rng = np.random.default_rng(start)
    for i in range(start, start + n):
        cv2.imwrite(osp.join(root, "front", f"{i:06d}.png"), rng.integers(0, 255, (8, 12, 3), np.uint8))
        if i % 2 == 0:
            cv2.imwrite(osp.join(root, "bev", f"{i:06d}.png"), rng.integers(0, 255, (8, 8, 3), np.uint8))
        if i in drop_waypoints_for:
            continue
        rows = rng.uniform(-1, 1, (16, 7))
        with open(osp.join(root, "waypoints", f"{i:06d}.txt"), "w") as f:
            f.write("\n".join(["0.1 0.2"] + [" ".join(f"{v:.4f}" for v in r) for r in rows]))


@pytest.mark.parametrize("hardlink", [False, True])
def test_merge_shards_matches_jax(tmp_path, hardlink):
    """Both packages merge the same shards (one incomplete sample, some
    BEVs missing) into the same files, then re-merge fewer and truncate."""
    shards = [str(tmp_path / "shard_0"), str(tmp_path / "shard_1")]
    _make_shard(shards[0], 3)
    _make_shard(shards[1], 4, start=5, drop_waypoints_for=(6,))
    out = {}
    for pkg in (JAX, PORT):
        merge = importlib.import_module(f"{pkg}.sim.collect_loop").merge_shards
        dest = str(tmp_path / pkg)
        n = merge(shards, dest, hardlink=hardlink)
        first = {sub: {f: open(osp.join(dest, sub, f), "rb").read() for f in fs} for sub, fs in _files(dest).items()}
        m = merge(shards[:1], dest, hardlink=hardlink)
        out[pkg] = (n, m, first, _files(dest))
    assert out[PORT] == out[JAX]
    assert out[PORT][:2] == (6, 3)


def test_collect_loop_matches_jax(monkeypatch, tmp_path):
    """The supervisor relaunches its package's collect_cli until the quota
    is on disk, headless by default, and splits a sharded quota by port."""
    argvs = {}
    for pkg in (JAX, PORT):
        cl = importlib.import_module(f"{pkg}.sim.collect_loop")
        calls = argvs[pkg] = []
        saved = {}

        class Popen:  # a collector run that saves its quota
            def __init__(self, argv, **kw):
                calls.append(argv)
                saved[argv[argv.index("--save-path") + 1]] = int(argv[argv.index("--save-num") + 1])

            def wait(self):
                return 0

        monkeypatch.setattr(cl.subprocess, "Popen", Popen)
        monkeypatch.setattr(cl, "count_current_saved", lambda d: saved.get(d, 0))
        cl.collect_loop(5, str(tmp_path / "a"), ["--fake-env"])
        cl.collect_loop(3, str(tmp_path / "b"), ["--off-screen"])
        assert cl.collect_sharded(5, str(tmp_path), 2, base_port=3000, merge=False) == 5
    assert argvs[PORT][0][2] == f"{PORT}.sim.collect_cli"
    strip = [[a for a in argv if a not in (f"{JAX}.sim.collect_cli", f"{PORT}.sim.collect_cli")]
             for argv in argvs[PORT]]
    assert strip == [[a for a in argv if a != f"{JAX}.sim.collect_cli"] for argv in argvs[JAX]]
    assert all(argv.count("--off-screen") == 1 for argv in argvs[PORT])


def test_collect_sharded_runs_the_ports_cli(tmp_path):
    """Two fake-env shards, each collected by a real subprocess of the port's
    collect_cli, merged into one dataset the port's loader reads."""
    from autonomous_driving_with_diffusion_model_tpu_torch.data import TrajDataset
    from autonomous_driving_with_diffusion_model_tpu_torch.sim import collect_sharded

    out = str(tmp_path / "data")
    n = collect_sharded(3, out, num_shards=2,
                        extra_args=["--fake-env", "--save-every-n-frame", "1", "--max-env-steps", "600"])
    assert n == 3
    ds = TrajDataset(out)
    assert len(ds) == 3
    assert all(np.all(np.abs(ds[i]["trajs"]) <= 1.0) for i in range(3))
    assert os.path.isdir(osp.join(out, "shard_0")) and os.path.isdir(osp.join(out, "shard_1"))
