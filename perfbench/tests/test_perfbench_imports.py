"""Nothing the benchmark runs imports JAX, its libraries or the JAX
package, and the plain reference imports nothing of the program.

Names are compared by their top-level part (before the first dot), whole:
the program's package name begins with the JAX package's."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import perfbench_helpers  # noqa: F401
from perfbench import core

PB = core.ROOT / "perfbench"


def _imports(path) -> set:
    """Top-level names of the modules a source file imports (relative
    imports are the benchmark's own)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub=""):
    return [p for p in (PB / sub).rglob("*.py") if "tests" not in p.relative_to(PB).parts]


def test_forbidden_names_are_compared_whole():
    loaded = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "optax", "orbax.checkpoint",
              "autonomous_driving_with_diffusion_model_tpu", "autonomous_driving_with_diffusion_model_tpu.ops",
              "autonomous_driving_with_diffusion_model_tpu_torch", "autonomous_driving_with_diffusion_model_tpu_torch.ops",
              "jaxtyping", "flaxen", "numpy"]
    assert core.forbidden_modules(loaded) == sorted(loaded[:8])


def test_harness_sources_import_no_jax():
    for path in _sources():
        assert not _imports(path) & set(core.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        names = _imports(path)
        assert not names & set(core.FORBIDDEN), path
        assert core.PORT not in names, path
        assert names <= {"__future__", "math", "os", "contextlib", "numpy", "torch"}, (path, names)


def test_a_run_loads_no_jax():
    """A whole run of every cell on the CPU at a small size, in a fresh
    process: what it has loaded afterwards."""
    code = (
        "import sys, json; sys.path.insert(0, 'perfbench/tests'); import perfbench_helpers as h\n"
        "import torch; torch.set_num_threads(2)\n"
        "from perfbench import core, calibrate\n"
        "for w in ('default-plan', 'default-train'):\n"
        "    assert h.run_tiny(w)['result']['correct']\n"
        "print(json.dumps(core.forbidden_modules()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=core.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
