"""The port's train CLI (``python -m autonomous_driving_with_diffusion_model_tpu_torch.train``)
on the CPU at a tiny size: two iterations on a dataset under ``tmp_path``,
a resumed run to 4 from their checkpoint, the port's own
checkpoint for a non-ResNet-34 encoder, per-iteration draws that depend on
the iteration alone, ``--generate-only``, the CLI as a module, and its
start from an ImageNet backbone."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from autonomous_driving_with_diffusion_model_tpu_torch.data import write_png
from autonomous_driving_with_diffusion_model_tpu_torch.models import PERCEPTION_BUILDERS, init_parameters
from autonomous_driving_with_diffusion_model_tpu_torch.train import cli

# one intra-op thread per process: the suite runs in several worker
# processes at once, and torch's default of a thread per core in each makes
# them contend for the cores (these files ran 3.6x as long)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (32, 48)


def write_dataset(root, n=4, seed=0):
    rng = np.random.default_rng(seed)
    for sub in ("front", "bev", "waypoints"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n):
        write_png(os.path.join(root, "front", f"{i:06d}.png"), rng.integers(0, 256, (*HW, 3), dtype=np.uint8), 4)
        write_png(os.path.join(root, "bev", f"{i:06d}.png"), rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
        lines = [" ".join(f"{v:.5f}" for v in rng.uniform(-1, 1, 2))]
        lines += [" ".join(f"{v:.5f}" for v in rng.uniform(-1, 1, 7)) for _ in range(16)]
        with open(os.path.join(root, "waypoints", f"{i:06d}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


def opts(tmp_path, project, perception="resnet34", **more):
    out = ["MODEL.DIM", "8", "MODEL.PERCEPTION", perception, "TRAIN.ROOT", str(tmp_path / "data"),
           "PROJECT_DIR", str(tmp_path / project), "TRAIN.BATCH_SIZE", "2", "TRAIN.NUM_WORKERS", "1",
           "TRAIN.SAVE_INTERVAL", "2", "TRAIN.SAMPLE_INTERVAL", "0", "TRAIN.LOG_INTERVAL", "1",
           "TRAIN.TIME_STEPS", "10", "TRAIN.SAMPLE_STEPS", "10", "TRAIN.LR_WARMUP", "1",
           "TRAIN.IMAGE_HEIGHT", str(HW[0]), "TRAIN.IMAGE_WIDTH", str(HW[1])]
    return out + [str(v) for kv in more.items() for v in kv]


def run(*argv):
    return cli.main(cli.parse_args(["--device", "cpu", *argv]))


def test_train_then_resume(tmp_path):
    """Two iterations write final.pth (the reference layout: ResNet-34); a
    run resumed from it starts with its step, AdamW moments and EMA
    restored exactly and goes on to 4."""
    write_dataset(str(tmp_path / "data"))
    first = run("--max-iter", "2", "--opts", *opts(tmp_path, "a"))
    ck = tmp_path / "a" / "checkpoints"
    assert sorted(os.listdir(ck)) == ["final.pth"]
    assert first.step == 2
    log = (tmp_path / "a" / "train.log").read_text()
    assert "iter: [2/2]" in log and "Save checkpoint" in log
    assert len((tmp_path / "a" / "metrics.jsonl").read_text().splitlines()) == 3  # run start + 2 logs

    saved = torch.load(ck / "final.pth", weights_only=False)
    seen = {}
    from autonomous_driving_with_diffusion_model_tpu_torch.train import checkpoint

    real = checkpoint._import

    def spy(ckpt, cfg, state):
        out = real(ckpt, cfg, state)
        seen["step"] = state.step
        seen["moments"] = [{k: v.clone() for k, v in state.optimizer.state[p].items()}
                           for p in state.model.parameters()]
        seen["ema"] = ([s.clone() for s in state.ema.shadow_params], state.ema.optimization_step)
        return out

    checkpoint._import = spy
    try:
        second = run("--max-iter", "4", "--opts", *opts(tmp_path, "b", **{"TRAIN.RESUME": str(ck / "final.pth"),
                                                                           "TRAIN.SAVE_INTERVAL": 5}))
    finally:
        checkpoint._import = real
    assert seen["step"] == 2 and seen["ema"][1] == 2
    for i, st in enumerate(seen["moments"]):
        want = saved["optimizer"]["state"][i]
        assert torch.equal(st["exp_avg"], want["exp_avg"]) and torch.equal(st["exp_avg_sq"], want["exp_avg_sq"])
        assert float(st["step"]) == 2.0
    assert all(torch.equal(a, b) for a, b in zip(seen["ema"][0], saved["ema_state_dict"]["shadow_params"]))
    assert second.step == 4 and second.ema.optimization_step == 4
    assert sorted(os.listdir(tmp_path / "b" / "checkpoints")) == ["final.pth"]
    assert torch.load(tmp_path / "b" / "checkpoints" / "final.pth", weights_only=False)["iter"] == 4


def test_other_encoders_save_the_ports_own_checkpoint(tmp_path):
    """Another encoder saves the port's own checkpoint every SAVE_INTERVAL
    iterations (checkpoint_{it}) and at the end (final), through the host
    loader (TPU.DEVICE_DATA off); a run resumes from it."""
    write_dataset(str(tmp_path / "data"))
    run("--max-iter", "2", "--opts", *opts(tmp_path, "a", "tiny", **{"TPU.DEVICE_DATA": "'off'",
                                                                     "TRAIN.SAVE_INTERVAL": 1}))
    ck = tmp_path / "a" / "checkpoints"
    assert sorted(os.listdir(ck)) == ["checkpoint_1.pt", "final.pt"]
    state = run("--max-iter", "3", "--opts", *opts(tmp_path, "b", "tiny", **{"TRAIN.RESUME": str(ck / "final.pt")}))
    assert state.step == 3


def test_pretrained_backbone_is_refused(tmp_path):
    """``TRAIN.PRETRAINED_BACKBONE``: the CLI starts the encoder from a
    torchvision ResNet-34 ``.pth`` (a 1000-way fc, distinct running
    statistics) and trains a step from it. The first step's LR is 0 and
    BatchNorm is frozen, so the trained encoder is still the file's, bit for
    bit, while the fc head is the model's own."""
    write_dataset(str(tmp_path / "data"))
    net = init_parameters(PERCEPTION_BUILDERS["resnet34"](num_classes=1000), torch.Generator().manual_seed(7))
    net.train()
    with torch.no_grad():
        net(torch.randn(2, *HW, 3, generator=torch.Generator().manual_seed(7)))
    tv = {k: v.clone() for k, v in net.state_dict().items()}
    torch.save(tv, tmp_path / "resnet34.pth")
    state = run("--max-iter", "1", "--opts", *opts(tmp_path, "a", **{"TRAIN.PRETRAINED_BACKBONE":
                                                                     str(tmp_path / "resnet34.pth")}))
    assert state.step == 1 and (tmp_path / "a" / "checkpoints" / "final.pth").exists()
    got = state.model.perception.state_dict()
    for k, v in tv.items():
        if k.startswith("fc.") or k.endswith("num_batches_tracked"):
            continue
        torch.testing.assert_close(got[k], v, atol=0, rtol=0, msg=k)
    assert got["fc.weight"].shape == (8, 512)


def test_draws_depend_on_the_iteration_alone():
    a = [g.initial_seed() for g in cli.iteration_generators(7, "cpu")]
    b = [g.initial_seed() for g in cli.iteration_generators(7, "cpu")]
    c = [g.initial_seed() for g in cli.iteration_generators(8, "cpu")]
    assert a == b and a != c and a[0] != a[1]


def test_generate_only_paints_the_ema_plans(tmp_path, monkeypatch):
    """``--generate-only``: the training DDPM sampler from the EMA weights,
    painted on the frame's BEV png (cv2 and PIL only here)."""
    write_dataset(str(tmp_path / "data"))
    monkeypatch.chdir(tmp_path)
    run("--generate-only", "--opts", *opts(tmp_path, "a", "tiny", **{"EVAL.BATCH_SIZE": 2}))
    from PIL import Image

    assert Image.open(tmp_path / "test.png").size == (64, 64)


def test_module_entry_point(tmp_path):
    """``python -m ...train --device cpu`` runs the CLI; without
    ``--device`` it needs a card, and on a machine without one it says so."""
    write_dataset(str(tmp_path / "data"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    args = [sys.executable, "-m", "autonomous_driving_with_diffusion_model_tpu_torch.train", "--max-iter", "1",
            "--opts", *opts(tmp_path, "m", "tiny")]
    out = subprocess.run(args[:3] + ["--device", "cpu"] + args[3:], capture_output=True, text=True, cwd=REPO,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert sorted(os.listdir(tmp_path / "m" / "checkpoints")) == ["final.pt"]
    if not torch.cuda.is_available():
        out = subprocess.run(args, capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
        assert out.returncode != 0 and "no CUDA device" in out.stderr
