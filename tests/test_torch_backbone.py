"""The port's torchvision backbone import (``models/convert.py:
import_torchvision_backbone``, ``TRAIN.PRETRAINED_BACKBONE``) against the
JAX package's (``models/torch_convert.py:330-405``), exactly (atol 0), in
the cases of ``tests/test_pretrained_backbone.py``. The torchvision-layout
``state_dict`` is the port's own ResNet-34 ``state_dict`` minus its
``perception.`` prefix, from another seed, with running statistics made
distinct by one train-mode forward and a 1000-way ``fc`` (no download: the
layout is what is under test). The JAX side's result comes back through
``from_jax_variables``."""

import numpy as np
import pytest
import torch

from autonomous_driving_with_diffusion_model_tpu.models.torch_convert import (
    import_torchvision_backbone as jax_import,
)
from autonomous_driving_with_diffusion_model_tpu_torch.models import build_model
from autonomous_driving_with_diffusion_model_tpu_torch.models.convert import (
    from_jax_variables,
    import_torchvision_backbone,
    load_torchvision_backbone,
)
from test_torch_models import _cfg, _jax_tree

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tv_state_dict():
    """A torchvision resnet34 ``state_dict``: seeded weights, running
    statistics from one train-mode forward, a 1000-way fc."""
    net = build_model(_cfg("NO_GUIDANCE", "resnet34"), device="cpu", seed=7).perception
    net.fc = torch.nn.Linear(512, 1000)
    net.train()
    with torch.no_grad():
        net(torch.randn(2, 64, 96, 3, generator=torch.Generator().manual_seed(7)))
    return {k: v.clone() for k, v in net.state_dict().items()}


def _both(cfg, tv):
    """(the port's import on its state_dict, JAX's import on the same weights
    as a JAX tree, carried back), or the exceptions each raised."""
    model = build_model(cfg, device="cpu", seed=0)
    sd = model.state_dict()
    out = []
    for run in (lambda: import_torchvision_backbone(sd, tv, cfg),
                lambda: from_jax_variables(jax_import(_jax_tree(model, cfg), tv), cfg)):
        try:
            out.append(run())
        except (KeyError, ValueError) as e:
            out.append(e)
    return sd, out


def _broken(tv, case):
    bad = dict(tv)
    if case == "param_shape":
        bad["conv1.weight"] = torch.zeros(64, 3, 3, 3)  # 7x7 in the real layout
    elif case == "stats_shape":
        bad["bn1.running_mean"] = torch.zeros(32)  # 64 in the real layout
    elif case == "missing":
        bad = {k: v for k, v in tv.items() if "layer4" not in k}
    return bad


@pytest.mark.parametrize("mode", ["NO_GUIDANCE", "FREE_GUIDANCE", "CLASSIFIER_GUIDANCE"])
def test_import_equals_jax_import(tv_state_dict, mode):
    """Every key equal to JAX's result; the encoder is the file's, the fc
    head and every other entry the model's own."""
    cfg = _cfg(mode, "resnet34", dim=16 if mode != "CLASSIFIER_GUIDANCE" else None)
    sd, (got, want) = _both(cfg, tv_state_dict)
    assert list(got) == list(sd)
    for k in sd:
        if k.endswith("num_batches_tracked"):
            torch.testing.assert_close(got[k], sd[k], atol=0, rtol=0)  # the port's own counter
            continue
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0, msg=k)
        if k.startswith("perception.") and not k.startswith("perception.fc."):
            torch.testing.assert_close(got[k], tv_state_dict[k[len("perception."):]], atol=0, rtol=0, msg=k)
        else:
            torch.testing.assert_close(got[k], sd[k], atol=0, rtol=0, msg=k)


def test_fc_head_and_rest_preserved(tv_state_dict):
    cfg = _cfg("NO_GUIDANCE", "resnet34", dim=16)
    sd, (got, _) = _both(cfg, tv_state_dict)
    before = {k: v.clone() for k, v in sd.items()}
    assert got["perception.fc.weight"].shape == (cfg.MODEL.DIM, 512)  # not torchvision's (1000, 512)
    torch.testing.assert_close(got["perception.fc.weight"], sd["perception.fc.weight"], atol=0, rtol=0)
    torch.testing.assert_close(got["mid_block1.blocks.0.block.0.weight"],
                               sd["mid_block1.blocks.0.block.0.weight"], atol=0, rtol=0)
    assert got["perception.bn1.running_mean"].abs().max() > 0  # the warmed statistics
    assert not torch.equal(got["perception.conv1.weight"], sd["perception.conv1.weight"])
    for k, v in before.items():  # the input is not changed
        assert torch.equal(sd[k], v), k


@pytest.mark.parametrize("case,error,match", [
    ("param_shape", ValueError, "conv1.weight"),
    ("stats_shape", ValueError, "bn1.running_mean"),
    ("missing", KeyError, "layer4"),
])
def test_bad_state_dict_raises_like_jax(tv_state_dict, case, error, match):
    _, (got, want) = _both(_cfg("NO_GUIDANCE", "resnet34", dim=16), _broken(tv_state_dict, case))
    for e in (got, want):
        assert isinstance(e, error) and match in str(e), e


def test_non_resnet34_raises_like_jax(tv_state_dict):
    _, (got, want) = _both(_cfg("NO_GUIDANCE", "tiny", dim=16), tv_state_dict)
    for e in (got, want):
        assert isinstance(e, ValueError) and "MODEL.PERCEPTION=resnet34" in str(e), e


@pytest.mark.parametrize("form", ["bare", "wrapped", "module"])
def test_load_reads_every_pth_form(tmp_path, tv_state_dict, form):
    """A bare state_dict, one under ``state_dict``, or a saved module."""
    cfg = _cfg("NO_GUIDANCE", "resnet34", dim=16)
    if form == "module":
        net = build_model(cfg, device="cpu", seed=7).perception
        net.fc = torch.nn.Linear(512, 1000)
        net.load_state_dict(tv_state_dict)
        obj = net
    else:
        obj = tv_state_dict if form == "bare" else {"state_dict": tv_state_dict, "epoch": 90}
    path = tmp_path / "resnet34.pth"
    torch.save(obj, path)
    sd = build_model(cfg, device="cpu", seed=0).state_dict()
    got = load_torchvision_backbone(str(path), sd, cfg)
    want = import_torchvision_backbone(sd, tv_state_dict, cfg)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0, msg=k)
    np.testing.assert_array_equal(got["perception.layer4.2.bn2.running_var"].numpy(),
                                  tv_state_dict["layer4.2.bn2.running_var"].numpy())
