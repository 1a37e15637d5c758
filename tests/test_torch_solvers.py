"""The port's outer solvers (lanpaint_tpu_torch.samplers), alone and against
the JAX package's.

1. Alone, as tests/test_samplers.py checks the JAX solvers: for unit-Gaussian
   data the exact denoiser is D(x, sigma) = x / (1 + sigma^2), the
   probability-flow ODE maps x(sigma0) to x(sigma0) / sqrt(1 + sigma0^2),
   and an exact stochastic sampler maps N(0, (1 + sigma0^2) I) to N(0, I).
   Each deterministic solver against the closed form, each stochastic one
   against the output's mean and std, at that file's tolerances.
2. Against JAX in fp32: each of the 22 names through both packages'
   `samplers.sample` on one numpy input, with a denoiser that also refines
   x (x_new = 0.98 x + 0.02 D), the port's `_noise_like` fed the draws the
   JAX solver takes (`normal(fold_in(fold_in(key, step), slot))`).  Limit:
   rtol 1e-4 with atol 1e-5 * max|want| (scalars computed in float32 on
   both sides, elementwise work in a different order).
3. `model_step`, the outer step of a model call (the nearest ladder sigma).

The host tables' copies (`_deis_coeffs`, `prepare_tables`,
`dpm_fast_groups`) are checked in tests/test_torch_host_copies.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanpaint_tpu import samplers as jsamplers
from lanpaint_tpu_torch import samplers as tsamplers
from lanpaint_tpu_torch.sigmas import karras

SIGMA_MAX = 10.0
# tests/test_samplers.py's closed-form tolerances
ODE_SOLVERS = {"euler": 0.05, "heun": 0.01, "heunpp2": 0.05, "dpm_2": 0.01, "dpmpp_2m": 0.01,
               "res_multistep": 0.02, "gradient_estimation": 0.05, "deis": 0.01,
               "dpm_fast": 0.02}
SDE_SOLVERS = ["euler_ancestral", "dpm_2_ancestral", "ddpm", "dpmpp_sde", "dpmpp_2m_sde",
               "dpmpp_3m_sde", "res_multistep_ancestral", "er_sde", "seeds_2", "seeds_3"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's tests: their tensors are tiny,
    and under pytest-xdist the workers share the machine's cores, where
    torch's default (a thread per core in every worker) slows them tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gaussian(x, sigma, step):
    return x / (1.0 + sigma**2), x


def _normal(seed, shape, scale=1.0):
    return torch.from_numpy(
        (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32))


@pytest.mark.parametrize("name,tol", sorted(ODE_SOLVERS.items()))
def test_ode_solver_matches_closed_form(name, tol):
    x0 = _normal(1, (2, 4, 8, 8), SIGMA_MAX)
    out, den_all = tsamplers.sample(gaussian, x0, karras(30, 0.03, SIGMA_MAX), sampler=name,
                                    generator=torch.Generator().manual_seed(1))
    want = x0 / np.sqrt(1 + SIGMA_MAX**2)
    err = float((out - want).abs().max() / want.abs().max())
    assert err < tol, f"{name}: rel err {err:.4f}"
    # dpm_fast: one denoised per group of its 29 grid steps (9 order-3 groups,
    # an order-2 tail) and the final denoise
    assert den_all.shape[0] == (11 if name == "dpm_fast" else 30)


@pytest.mark.parametrize("name", SDE_SOLVERS)
def test_sde_solver_output_statistics(name):
    x0 = _normal(2, (8, 4, 32, 32), np.sqrt(1 + SIGMA_MAX**2))
    out, _ = tsamplers.sample(gaussian, x0, karras(50, 0.02, SIGMA_MAX), sampler=name,
                              generator=torch.Generator().manual_seed(2))
    o = out.numpy()
    assert np.isfinite(o).all(), name
    assert abs(o.mean()) < 0.05, f"{name}: mean {o.mean():.4f}"
    np.testing.assert_allclose(o.std(), 1.0, rtol=0.08, err_msg=name)


@pytest.mark.parametrize("name", ["seeds_2", "seeds_3"])
def test_seeds_eta0_is_a_deterministic_exponential_rk(name, monkeypatch):
    """With eta = 0 SEEDS is a deterministic exponential Runge-Kutta method
    and meets the closed form at 1e-2, as tests/test_samplers.py checks."""
    step = functools.partial(tsamplers.get_solver(name), eta=0.0)
    monkeypatch.setitem(tsamplers._SOLVERS, name, step)
    x0 = _normal(3, (1, 2, 8, 8), SIGMA_MAX)
    out, _ = tsamplers.sample(gaussian, x0, karras(30, 0.03, SIGMA_MAX), sampler=name,
                              generator=torch.Generator().manual_seed(3))
    want = x0 / np.sqrt(1 + SIGMA_MAX**2)
    assert float((out - want).abs().max() / want.abs().max()) < 0.01


def test_solver_continues_from_the_refined_x():
    def refining(x, sigma, step):
        return torch.zeros_like(x), torch.full_like(x, 7.0)

    out, _ = tsamplers.sample(refining, torch.ones((1, 2, 4, 4)), [1.0, 0.0])
    torch.testing.assert_close(out, torch.zeros((1, 2, 4, 4)))  # 7 + (7 - 0) / 1 * (0 - 1)


# --------------------------------------------------------------------------
# against JAX


def j_model(x, sigma, key):
    den = x / (1.0 + sigma**2)
    return den, 0.98 * x + 0.02 * den


def t_model(x, sigma, step):
    den = x / (1.0 + sigma**2)
    return den, 0.98 * x + 0.02 * den


def jax_draws(key):
    """The port's `_noise_like` replaced by the JAX solver's own draws."""

    def noise_like(x, generator, step, slot):
        k = jax.random.fold_in(jax.random.fold_in(key, step), slot)
        return torch.from_numpy(np.array(jax.random.normal(k, tuple(x.shape), jnp.float32)))

    return noise_like


def _close(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("name", jsamplers.SAMPLER_NAMES)
def test_solver_matches_jax(name, monkeypatch):
    sigmas = karras(9, 0.05, SIGMA_MAX).astype(np.float32)
    x0 = (np.random.default_rng(4).standard_normal((2, 3, 8, 8)) * SIGMA_MAX).astype(np.float32)
    key = jax.random.PRNGKey(5)
    sig = jnp.asarray(sigmas)
    want, want_den = jax.jit(lambda x: jsamplers.sample(j_model, x, sig, sampler=name,
                                                        key=key))(jnp.asarray(x0))
    monkeypatch.setattr(tsamplers, "_noise_like", jax_draws(key))
    got, got_den = tsamplers.sample(t_model, torch.from_numpy(x0), sigmas, sampler=name)
    _close(got_den, want_den)
    _close(got, want)


@pytest.mark.parametrize("name", ["dpmpp_3m_sde", "er_sde"])
def test_history_solver_carry_matches_jax(name, monkeypatch):
    """The carry a segment returns (history slots and their step sizes)
    equals the JAX solver's, and a second segment continued from it equals
    JAX's continuation."""
    sigmas = karras(8, 0.05, SIGMA_MAX).astype(np.float32)
    x0 = (np.random.default_rng(6).standard_normal((1, 2, 8, 8)) * SIGMA_MAX).astype(np.float32)
    key = jax.random.PRNGKey(7)
    monkeypatch.setattr(tsamplers, "_noise_like", jax_draws(key))
    jx, _, jc = jsamplers.sample(j_model, jnp.asarray(x0), jnp.asarray(sigmas[:4]),
                                 sampler=name, key=key, return_carry=True)
    tx, _, tc = tsamplers.sample(t_model, torch.from_numpy(x0), sigmas[:4], sampler=name,
                                 return_carry=True)
    for got, want in ((tc.hist1, jc.hist1), (tc.hist2, jc.hist2), (tx, jx)):
        _close(got, want)
    np.testing.assert_allclose([tc.h1, tc.h2], [float(jc.h1), float(jc.h2)], rtol=1e-6)
    assert tc.nhist == int(jc.nhist) == 3
    want, _ = jsamplers.sample(j_model, jx, jnp.asarray(sigmas[3:]), sampler=name, key=key,
                               step_offset=3, carry_in=jc)
    got, _ = tsamplers.sample(t_model, tx, sigmas[3:], sampler=name, step_offset=3,
                              carry_in=tc)
    _close(got, want)


def test_model_step_is_the_nearest_ladder_sigma():
    sigmas = np.asarray([14.6, 6.0, 6.0, 1.0, 0.0], np.float32)
    assert tsamplers.model_step(sigmas, 14.6) == 0
    assert tsamplers.model_step(sigmas, 6.0) == 1  # a tie takes the first, as jnp.argmin
    assert tsamplers.model_step(sigmas, 3.4, step_offset=10) == 13  # nearer 1.0 than 6.0
    assert tsamplers.model_step(sigmas, 0.0, step_offset=2) == 6
