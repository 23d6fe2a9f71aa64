"""The port's learned hypothesis scorer against the JAX package's
``models/scorer.py``: one ``.npz`` format both ways, the same features and
scores (tanh GELU), the same parameter tree."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from autonomous_driving_with_diffusion_model_tpu.models import scorer as jscorer
from autonomous_driving_with_diffusion_model_tpu_torch.models import scorer as tscorer
from autonomous_driving_with_diffusion_model_tpu_torch.utils.constants import MAGIC_NUM

# float32 on both sides, a 146-wide first layer and two tanh GELUs
SCORE_TOL = dict(atol=1e-5, rtol=1e-5)


def _candidates(rng, k=5, horizon=16, dim=7):
    trajs = rng.standard_normal((k, horizon, dim)).astype(np.float32)
    trajs[..., :2] *= MAGIC_NUM * 0.3
    return trajs, (0.3 * rng.standard_normal(2)).astype(np.float32)


@pytest.mark.parametrize("hidden", [(64, 64), (32, 16), (48,)])
def test_jax_npz_scores_like_jax(tmp_path, rng, hidden):
    params = jscorer.init_scorer(seed=2, hidden=hidden)
    path = str(tmp_path / "scorer.npz")
    jscorer.save_scorer(path, params, hidden=hidden)
    loaded, got_hidden = tscorer.load_scorer(path)
    assert got_hidden == hidden
    trajs, target = _candidates(rng)
    want = np.asarray(jscorer.score_trajs(params, jnp.asarray(trajs), jnp.asarray(target), hidden))
    got = tscorer.score_trajs(loaded, torch.from_numpy(trajs), torch.from_numpy(target), got_hidden)
    assert got.shape == (5,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **SCORE_TOL)
    assert int(torch.argmin(got)) == int(np.argmin(want))


def test_port_npz_loads_in_jax(tmp_path, rng):
    params = tscorer.init_scorer(seed=4, hidden=(32, 16))
    path = str(tmp_path / "port_scorer.npz")
    tscorer.save_scorer(path, params, hidden=(32, 16))
    loaded, hidden = jscorer.load_scorer(path)
    assert hidden == (32, 16)
    trajs, target = _candidates(rng, k=3)
    want = np.asarray(jscorer.score_trajs(jax.tree.map(jnp.asarray, loaded), jnp.asarray(trajs),
                                          jnp.asarray(target), hidden))
    got = tscorer.score_trajs(params, torch.from_numpy(trajs), torch.from_numpy(target), (32, 16))
    np.testing.assert_allclose(got.numpy(), want, **SCORE_TOL)


@pytest.mark.parametrize("horizon,dim", [(16, 7), (16, 2), (8, 4)])
def test_init_scorer_tree_matches_jax(horizon, dim):
    """The same flax paths and shapes; kernels LeCun-scaled like flax's."""
    want = jscorer.init_scorer(seed=0, horizon=horizon, transition_dim=dim)
    got = tscorer.init_scorer(seed=0, horizon=horizon, transition_dim=dim)
    flat = lambda tree: {(a, b): np.shape(v) for a, leaves in tree.items() for b, v in leaves.items()}
    assert flat(got) == flat(want)
    k0 = got["Dense_0"]["kernel"]
    assert np.abs(k0).max() <= 2.0 / 0.87962566103423978 / np.sqrt(k0.shape[0]) + 1e-6
    assert np.all(got["Dense_0"]["bias"] == 0.0)


def test_module_holds_the_params_and_is_permutation_equivariant(rng):
    params = tscorer.init_scorer(seed=1)
    net = tscorer.HypothesisScorer.from_params(params)
    for i, layer in enumerate(net.layers):
        np.testing.assert_array_equal(layer.weight.detach().numpy().T, params[f"Dense_{i}"]["kernel"])
        np.testing.assert_array_equal(layer.bias.detach().numpy(), params[f"Dense_{i}"]["bias"])
    trajs, target = (torch.from_numpy(a) for a in _candidates(rng, k=6))
    with torch.no_grad():
        scores = net(trajs, target)
        perm = torch.tensor([3, 0, 5, 1, 4, 2])
        torch.testing.assert_close(net(trajs[perm], target), scores[perm])


def test_gelu_is_the_tanh_approximation():
    """flax's nn.gelu defaults to approximate=True."""
    x = np.linspace(-4, 4, 101).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.abs(torch.nn.functional.gelu(torch.from_numpy(x)).numpy() - want).max() > 1e-4
