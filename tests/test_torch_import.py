"""The port imports neither JAX nor anything of the JAX package: every module
of ``autonomous_driving_with_diffusion_model_tpu_torch`` and ``chip_smoke``
import in a fresh interpreter where ``import jax`` and ``import flax`` fail."""

import json
import os
import subprocess
import sys

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
                  or m.startswith("autonomous_driving_with_diffusion_model_tpu."))
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
                "models.convert", "diffusion.sampler", "data.augment", "driving.plan"):
        assert f"autonomous_driving_with_diffusion_model_tpu_torch.{sub}" in result["imported"]
    assert result["jax_side"] == []
    assert result["jax"] == []
