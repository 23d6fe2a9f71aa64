"""The port's entry points (``..._torch/entry.py``), the counterpart of
the root ``__graft_entry__.py``: the flagship forward on the CPU, and the
multi-card dry run as two gloo ranks, the counterpart of JAX's virtual CPU
mesh, with its phases' elapsed-stamped lines and its budget's skip rule."""

import numpy as np
import pytest
import torch

from autonomous_driving_with_diffusion_model_tpu_torch.entry import dryrun_multichip, entry


def test_entry_is_the_flagship_forward():
    torch.set_num_threads(2)
    fn, args = entry(device="cpu")
    model, x, img, t = args
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    # dims 64 x (1, 2, 4, 8): the first block 7 -> 64, the middle at 512
    assert shapes["downs.0.0.blocks.0.block.0.weight"] == (64, 7, 5)
    assert shapes["mid_block1.blocks.0.block.0.weight"] == (512, 512, 5)
    assert shapes["perception.conv1.weight"][0] == 64 and "perception.layer4.2.conv2.weight" in shapes  # ResNet-34
    assert tuple(x.shape) == (1, 16, 7) and tuple(img.shape) == (1, 256, 900, 3) and float(t) == 5.0
    out = fn(*args)
    assert tuple(out.shape) == (1, 16, 7) and bool(torch.isfinite(out).all())
    assert torch.equal(out, fn(*args))  # eval mode: a forward is a function of its inputs


def test_entry_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2)


def _phases(out):
    return [line for line in out.splitlines() if line.startswith("dryrun_multichip(2) [")]


def test_dryrun_two_gloo_ranks(capfd, monkeypatch):
    monkeypatch.delenv("ADM_DRYRUN_BUDGET_S", raising=False)
    dryrun_multichip(2, device="cpu")
    lines = _phases(capfd.readouterr().out)
    text = "\n".join(lines)
    assert "phase 0: 2-rank all-reduce over gloo ok" in text
    assert "phase 1: flagship DIM=64 resnet34" in text and "loss=" in text
    assert "phase 2: checkpoint save/restore/resume ok" in text
    assert lines[-1].endswith("done")
    stamps = [float(line.split("[")[1].split("s]")[0]) for line in lines]
    assert stamps == sorted(stamps)  # elapsed, in order


def test_dryrun_budget_skips_phase_2(capfd, monkeypatch):
    monkeypatch.setenv("ADM_DRYRUN_BUDGET_S", "1")
    dryrun_multichip(2, device="cpu")
    text = "\n".join(_phases(capfd.readouterr().out))
    assert "SKIP phase 2" in text and "phase 2: checkpoint" not in text
    assert "phase 1: flagship" in text and text.endswith("done")
