"""The port's dataset audit (``data/validate.py``) on the CPU against the
JAX package's: the same directories, clean and broken in each way the
audit reports, give equal reports (the JAX copy decodes with
``cv2.imread``, the port with ``data/png.py``), equal text and equal exit
codes from the CLI."""

import json
import os

import cv2
import numpy as np
import pytest

from autonomous_driving_with_diffusion_model_tpu.data import validate as jval
from autonomous_driving_with_diffusion_model_tpu_torch.data import validate as tval


def _sample(root, idx, rng, rows=None, image=True, waypoints=True, channels=3):
    for sub in ("front", "waypoints", "bev"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    if image:
        img = rng.integers(0, 255, (16, 24, channels), np.uint8)
        cv2.imwrite(os.path.join(root, "front", f"{idx:06d}.png"), img[..., 0] if channels == 1 else img)
        if idx % 2 == 0:
            cv2.imwrite(os.path.join(root, "bev", f"{idx:06d}.png"), np.zeros((8, 8, 3), np.uint8))
    if waypoints:
        rows = rng.uniform(-0.9, 0.9, (16, 7)) if rows is None else rows
        lines = [" ".join(f"{v:.6f}" for v in rng.uniform(-0.5, 0.5, 2))]
        lines += [" ".join(f"{v:.6f}" for v in r) for r in rows]
        with open(os.path.join(root, "waypoints", f"{idx:06d}.txt"), "w") as f:
            f.write("\n".join(lines))


def _front(root, idx):
    return os.path.join(root, "front", f"{idx:06d}.png")


def _build(root, case):
    rng = np.random.default_rng(0)
    for i in range(5):
        _sample(root, i, rng, channels=(1, 3, 4)[i % 3])
    _sample(root, 5, rng, rows=np.tile([0.3, -0.1, 0.0, 0.0, 0.0, 0.0, 1.0], (16, 1)))  # red-light
    _sample(root, 6, rng, rows=np.full((16, 7), 1.5))  # out-of-range rows
    if case == "not_a_png":
        with open(_front(root, 2), "wb") as f:
            f.write(b"not a png at all")
    elif case == "truncated_png":
        data = open(_front(root, 3), "rb").read()
        with open(_front(root, 3), "wb") as f:
            f.write(data[: len(data) // 2])
    elif case == "unpaired":
        _sample(root, 7, rng, waypoints=False)  # a front image without waypoints
        _sample(root, 8, rng, image=False)  # waypoints without a front image
    elif case == "bad_schema":
        with open(os.path.join(root, "waypoints", "000004.txt"), "w") as f:
            f.write("0.1 0.2\n" + "\n".join(["0 0 0 0 0 0"] * 16))
        with open(os.path.join(root, "waypoints", "000001.txt"), "w") as f:
            f.write("0.1\n" + "\n".join(["0 0 0 0 0 0 0"] * 16))
    elif case == "empty":
        for sub in ("front", "waypoints", "bev"):
            for name in os.listdir(os.path.join(root, sub)):
                os.remove(os.path.join(root, sub, name))


CASES = ["clean", "not_a_png", "truncated_png", "unpaired", "bad_schema", "empty"]


@pytest.mark.parametrize("case", CASES)
def test_validate_dataset_matches_jax(tmp_path, case):
    root = str(tmp_path / case)
    _build(root, case)
    for kwargs in ({}, {"sample": 3}, {"check_images": False}):
        got, want = tval.validate_dataset(root, **kwargs), jval.validate_dataset(root, **kwargs)
        assert got == want, kwargs
        assert tval.format_report(got) == jval.format_report(want)
    report = tval.validate_dataset(root)
    assert report["ok"] == (case == "clean")
    if case in ("not_a_png", "truncated_png"):
        assert report["corrupt_images"] == [os.path.basename(_front(root, 2 if case == "not_a_png" else 3))]


@pytest.mark.parametrize("case", ["clean", "not_a_png"])
def test_validate_cli_matches_jax(tmp_path, capsys, case):
    root = str(tmp_path / case)
    _build(root, case)
    outs = []
    for mod in (tval, jval):
        for flags in ([], ["--json"], ["--sample", "2"]):
            rc = mod.main(["--root", root, *flags])
            outs.append((rc, capsys.readouterr().out))
    assert outs[:3] == outs[3:]
    assert outs[0][0] == (0 if case == "clean" else 1)
    assert json.loads(outs[1][1])["num_valid_samples"] == 7
