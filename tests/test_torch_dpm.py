"""The port's DPM-Solver++(2M) tables and update against the JAX package's
``diffusion/dpm.py``, and its first-order step against eta-0 DDIM (as JAX
``tests/test_dpm.py:59`` checks)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from autonomous_driving_with_diffusion_model_tpu import diffusion as jdiff
from autonomous_driving_with_diffusion_model_tpu_torch import diffusion as tdiff

SCHEDULES = ["squaredcos_cap_v2", "linear", "scaled_linear"]
NOCLIP = dict(prediction_type="sample", clip_sample=False, thresholding=False)


@pytest.mark.parametrize("kind", SCHEDULES)
@pytest.mark.parametrize("steps,lam", [(2, -5.1), (10, -5.1), (25, -5.1), (10, -3.0), (10, -100.0)])
def test_dpm_timesteps_equal_jax(kind, steps, lam):
    want = jdiff.dpm_timesteps(jdiff.make_schedule(kind, 100), steps, lam)
    got = tdiff.dpm_timesteps(tdiff.make_schedule(kind, 100), steps, lam)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_dpm_timesteps_refuse_like_jax():
    for args in ((99, -5.1), (10, 50.0)):
        with pytest.raises(ValueError):
            jdiff.dpm_timesteps(jdiff.make_schedule(), *args)
        with pytest.raises(ValueError):
            tdiff.dpm_timesteps(tdiff.make_schedule(), *args)


@pytest.mark.parametrize("kind", SCHEDULES)
@pytest.mark.parametrize("grid", ["dpm10", "dpm2", "explicit"])
def test_dpm_coeffs_match_jax(kind, grid):
    """Host float64 tables, handed over as float32: equal to 1e-7."""
    sj, st = jdiff.make_schedule(kind, 100), tdiff.make_schedule(kind, 100)
    if grid == "explicit":
        ts = np.array([90, 61, 30, 4], np.int64)
    else:
        ts = jdiff.dpm_timesteps(sj, int(grid[3:]))
    prev = np.concatenate([ts[1:], [-1]])
    want, got = jdiff.dpm_coeffs(sj, ts, prev), tdiff.dpm_coeffs(st, ts, prev)
    for name in ("sigma_ratio", "phi", "inv_r"):
        g = getattr(got, name)
        assert g.dtype == torch.float32 and g.shape == (len(ts),)
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(want, name)), atol=1e-7, rtol=0, err_msg=name)
    # first-order first and last steps; the terminal limit sigma_prev = 0 exact
    assert float(got.inv_r[0]) == 0.0 and float(got.inv_r[-1]) == 0.0
    assert float(got.sigma_ratio[-1]) == 0.0


def test_first_order_update_equals_eta0_ddim(rng):
    """DPM++(1) is the eta-0 DDIM step in x0 form; the terminal step is x0."""
    schedule = tdiff.make_schedule("squaredcos_cap_v2", 100)
    c = tdiff.dpm_coeffs(schedule, np.array([60, 30]), np.array([30, -1]))
    x = torch.from_numpy(rng.standard_normal((2, 16, 7)).astype(np.float32))
    x0 = torch.from_numpy(0.3 * rng.standard_normal((2, 16, 7)).astype(np.float32))
    assert float(c.inv_r[0]) == 0.0
    got = tdiff.dpm_pp_2m_update(x, x0, torch.zeros_like(x), c.sigma_ratio[0], c.phi[0], c.inv_r[0])
    want, _ = tdiff.ddim_step(schedule, tdiff.StepConfig(**NOCLIP), x0, 60, 30, x)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    got = tdiff.dpm_pp_2m_update(x, x0, torch.zeros_like(x), c.sigma_ratio[1], c.phi[1], c.inv_r[1])
    torch.testing.assert_close(got, x0, atol=1e-6, rtol=0)


def test_second_order_update_matches_jax(rng):
    sj, st = jdiff.make_schedule(), tdiff.make_schedule()
    ts = jdiff.dpm_timesteps(sj, 10)
    prev = np.concatenate([ts[1:], [-1]])
    cj, ct = jdiff.dpm_coeffs(sj, ts, prev), tdiff.dpm_coeffs(st, ts, prev)
    x, x0, x0_prev = (rng.standard_normal((2, 16, 7)).astype(np.float32) for _ in range(3))
    for i in range(len(ts)):
        want = jdiff.dpm_pp_2m_update(jnp.asarray(x), jnp.asarray(x0), jnp.asarray(x0_prev),
                                      cj.sigma_ratio[i], cj.phi[i], cj.inv_r[i])
        got = tdiff.dpm_pp_2m_update(torch.from_numpy(x), torch.from_numpy(x0), torch.from_numpy(x0_prev),
                                     ct.sigma_ratio[i], ct.phi[i], ct.inv_r[i])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6, err_msg=f"step {i}")


def test_registries_name_the_same_schedulers():
    assert set(tdiff.SCHEDULER_FUNC) == set(jdiff.SCHEDULER_FUNC)
    assert set(tdiff.INPAINTING_SCHEDULER_FUNC) == set(jdiff.INPAINTING_SCHEDULER_FUNC)
