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


def _outcome_set(seed=0, n=60, k=4):
    """Candidate sets, targets, outcomes and episode groups of 5 rows."""
    rng = np.random.default_rng(seed)
    trajs = rng.standard_normal((n, k, 16, 7)).astype(np.float32)
    trajs[..., :2] *= 5.0
    targets = (0.3 * rng.standard_normal((n, 2))).astype(np.float32)
    outcomes = (rng.standard_normal((n, k)) ** 2).astype(np.float32)
    return trajs, targets, outcomes, np.repeat(np.arange(n // 5), 5)


@pytest.mark.parametrize("grouped", [True, False])
def test_train_scorer_matches_jax(grouped):
    """50 full-batch AdamW steps from JAX's init_scorer(seed): the same split,
    standardization and metrics, and parameters within 1e-4 of each tensor's
    largest move plus 1e-7 (float32 sums of 45 x 4 candidates in other
    orders, through Adam's normalization; measured 7e-7 of moves of 0.1)."""
    trajs, targets, outcomes, groups = _outcome_set()
    kw = dict(seed=3, steps=50, groups=groups if grouped else None)
    start = jscorer.init_scorer(3, 16, 7)
    want_params, want = jscorer.train_scorer(trajs, targets, outcomes, **kw)
    got_params, got = tscorer.train_scorer(trajs, targets, outcomes, params=jax.tree.map(np.asarray, start),
                                           device="cpu", **kw)
    assert got.keys() == want.keys()
    assert got["val_indices"] == want["val_indices"]
    for key in ("n_train", "n_val", "val_top1_regret_oracle"):
        assert got[key] == want[key], key
    for key in ("final_train_loss", "val_mse", "val_top1_regret", "val_top1_regret_random", "outcome_mu",
                "outcome_sd"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
    for layer, leaves in want_params.items():
        for name, w in leaves.items():
            w, s0 = np.asarray(w), np.asarray(start[layer][name])
            tol = 1e-4 * np.abs(w - s0).max() + 1e-7
            np.testing.assert_allclose(got_params[layer][name], w, atol=tol, rtol=0, err_msg=f"{layer}/{name}")


def test_train_scorer_holds_out_whole_groups():
    """Whole episodes go to validation, until at least val_fraction of the
    rows, in JAX's order; without groups a row permutation of JAX's."""
    trajs, targets, outcomes, groups = _outcome_set(seed=1, n=50)
    for frac in (0.2, 0.33):
        _, got = tscorer.train_scorer(trajs, targets, outcomes, seed=7, steps=1, val_fraction=frac,
                                      groups=groups, device="cpu")
        _, want = jscorer.train_scorer(trajs, targets, outcomes, seed=7, steps=1, val_fraction=frac, groups=groups)
        val = np.asarray(got["val_indices"])
        assert got["val_indices"] == want["val_indices"]
        held = np.unique(groups[val])
        assert set(val) == set(np.flatnonzero(np.isin(groups, held)))  # whole groups only
        assert len(val) >= round(50 * frac) and len(val) - 5 < round(50 * frac)
        assert got["n_train"] + got["n_val"] == 50
    _, got = tscorer.train_scorer(trajs, targets, outcomes, seed=7, steps=1, device="cpu")
    assert got["val_indices"] == list(np.random.default_rng(7).permutation(50)[:10])


def test_train_scorer_runs_on_the_card_unless_asked(monkeypatch):
    """No card and no device: it raises rather than train on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trajs, targets, outcomes, _ = _outcome_set(n=10)
    with pytest.raises(RuntimeError, match="CUDA"):
        tscorer.train_scorer(trajs, targets, outcomes, steps=1)


def test_batched_scores_equal_per_set_scores(rng):
    """The (N, K, H, C) form the fit uses scores each set as the (K, H, C) form."""
    net = tscorer.HypothesisScorer.from_params(tscorer.init_scorer(seed=5))
    sets = [_candidates(rng, k=3) for _ in range(4)]
    with torch.no_grad():
        batched = net(torch.from_numpy(np.stack([t for t, _ in sets])), torch.from_numpy(np.stack([g for _, g in sets])))
        for i, (t, g) in enumerate(sets):
            torch.testing.assert_close(batched[i], net(torch.from_numpy(t), torch.from_numpy(g)), atol=1e-6, rtol=1e-6)
    params = net.params()
    assert all(np.array_equal(params[k][n], tscorer.init_scorer(seed=5)[k][n]) for k in params for n in params[k])
