"""The port's fused think-step kernels (lanpaint_tpu_torch.ops.fused), on the CPU.

1. The coefficient tables against `lanpaint_tpu.ops.fused.pack_branch_coeffs`.
2. The plain versions of the half step and the warm and cold finish against
   the JAX package's Pallas kernels, run in interpret mode as
   tests/test_fused.py runs them, on one shared table and the same inputs.
   At noise_mult=0 the normals must not matter.  At noise_mult=1: the TPU
   PRNG returns zeros in interpret mode, so every Box-Muller pair is
   exactly (r, 0) with r = sqrt(-2 ln 2^-25); the plain versions fed
   (ey, ev, vs) = (r, 0, r) must match, which pins where each noise
   coefficient enters.  A table with a non-finite damped entry must select
   the overdamped branch as the kernels do.
3. The engine's fused path (`use_fused_kernels=True`, the plain versions on
   the CPU) through the 12 golden `CASES` at 2e-4, with the unfused path's
   draws mapped onto the kernels' normals (engine.py's docstring).

The kernels themselves run only on the card (`chip_smoke.py` holds them
against these plain versions there).

Tolerances: tables rtol 1e-6 where fp32 allows it (see the test);
kernels rtol 1e-5, atol 1e-6 (tests/test_fused.py's); golden cases 2e-4
(the reference's own, docs/parity.md).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanpaint_tpu.config import LanPaintConfig as JConfig
from lanpaint_tpu.config import ModelKind as JKind
from lanpaint_tpu.ops import fused as jfused
from lanpaint_tpu.ops import sho as jsho
from lanpaint_tpu.schedule import unify_times as j_unify
from lanpaint_tpu_torch.config import LanPaintConfig, ModelKind
from lanpaint_tpu_torch.ops import fused
from lanpaint_tpu_torch.schedule import unify_times
from test_reference_golden import CASES, DATA
from test_torch_engine import run_reference_case

B, M = 2, 256
R = math.sqrt(-2.0 * math.log(2.0**-25))  # Box-Muller radius of an all-zero PRNG draw
KERNEL_TOL = dict(rtol=1e-5, atol=1e-6)
SIGMAS = {"eps": [0.03, 0.5, 2.0, 14.6], "flow": [0.05, 0.3, 0.7, 0.97]}


def _tables64(params, sigma, kind):
    """The JAX package's coefficient formulas in float64, packed as
    `pack_branch_coeffs` packs them: the float64 value of each entry."""
    with jax.enable_x64():
        cfg = JConfig(**params)
        abt = j_unify(jnp.asarray(sigma, jnp.float64), JKind(kind)).abt
        one_m = 1.0 - abt
        d = jnp.sqrt(jnp.asarray(2.0, jnp.float64))
        tables = []
        for sig, a in ((1.0, 1.0 / one_m), (cfg.beta, (1.0 + cfg.lamb) / one_m)):
            dt = cfg.step_size * one_m * sig
            gamma = cfg.friction**2 * cfg.step_size * sig / 0.1 / 2.0 / dt
            half = [*jsho.sho_coeffs(gamma, a, d, dt / 2.0), *jsho.ou_coeffs(a, d, dt / 2.0),
                    a, jnp.sqrt(gamma) * dt]
            full = [*jsho.sho_coeffs(gamma, a, d, dt), *jsho.ou_coeffs(a, d, dt), a, dt]
            tables.append(np.stack([np.asarray(f) for f in half + full], axis=-1))
        return tables


@pytest.mark.parametrize("kind", ["eps", "flow"])
@pytest.mark.parametrize("params", [
    {}, dict(lamb=4.0, step_size=0.05, beta=2.5, friction=3.0),
    dict(lamb=30.0, step_size=0.9, beta=0.3, friction=40.0)],
    ids=["defaults", "small_step", "large_step"])
def test_coefficient_tables_match_jax(kind, params):
    """rtol 1e-6 against the JAX tables for at least 90% of the entries.
    The rest cancel badly in fp32 (wv_v = ee - a t (1 - z1), and the
    Cholesky terms of a stiff oscillator): there the two packages' ulp-level
    differences in exp and expm1 grow to a few 1e-6 relative, or 1e-7
    absolute on entries ~1e-4 that lie 0.2 (relative) from their float64
    value in BOTH packages.  Every entry is held to the rule
    tests/test_torch_numerics.py holds the same coefficient functions to:
    rtol 1e-5, atol 1e-6 against JAX, or no further from the float64 value
    than the JAX fp32 table's worst entry, plus that tolerance."""
    sigma = np.asarray(SIGMAS[kind], np.float32)
    jx, jy = jfused.pack_branch_coeffs(JConfig(**params), j_unify(jnp.asarray(sigma), JKind(kind)))
    tx, ty = fused.pack_branch_coeffs(LanPaintConfig(**params),
                                      unify_times(torch.from_numpy(sigma), ModelKind(kind)))
    assert tx.shape == (len(sigma), 2 * fused.N_COEF) and tx.dtype == torch.float32
    for got, want, want64 in zip((tx, ty), (jx, jy), _tables64(params, sigma, kind)):
        got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
        tight = np.abs(got - want) <= 1e-6 * np.abs(want)
        ok = (np.abs(got - want) <= 1e-6 + 1e-5 * np.abs(want)) | (
            np.abs(got - want64) <= 1e-6 + 1e-5 * np.abs(want64) + np.abs(want - want64).max())
        assert ok.all(), f"entries out of tolerance at {np.argwhere(~ok).tolist()}"
        assert tight.mean() >= 0.9, f"only {tight.mean():.0%} of the entries within rtol 1e-6"


def _case(seed, bad=False):
    """Shared table (the port's, as numpy) and (B, M) inputs."""
    tx, ty = fused.pack_branch_coeffs(LanPaintConfig(n_steps=3),
                                      unify_times(torch.tensor([1.0, 2.0]), ModelKind.EPS))
    tx, ty = tx.numpy(), ty.numpy()
    if bad:  # a damped entry that overflows batch row 0, half and full rows
        tx[0, 0] = tx[0, fused.N_COEF] = np.inf
    rng = np.random.default_rng(seed)
    arr = lambda scale=1.0: (rng.standard_normal((B, M)) * scale).astype(np.float32)
    x, v, c, c2 = arr(), arr(0.1), arr(), arr()
    mask = (rng.uniform(size=(B, M)) > 0.5).astype(np.float32)
    return tx, ty, x, v, c, c2, mask, rng


def _run_both(phase, noise_mult, bad=False):
    """(port outputs, JAX outputs) for one phase.  The finish phases take
    the JAX half step's outputs as their inputs on both sides."""
    tx, ty, x, v, c, c2, mask, rng = _case(11, bad)
    j = lambda a: jnp.asarray(a)  # noqa: E731
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    if noise_mult == 0.0:  # any normals: noise_mult=0 must cancel them
        normals = tuple(t(rng.standard_normal((B, M)).astype(np.float32)) for _ in range(3))
    else:
        normals = (t(np.full((B, M), R, np.float32)), t(np.zeros((B, M), np.float32)),
                   t(np.full((B, M), R, np.float32)))
    jh = jfused.fused_half_step(0, j(tx), j(ty), noise_mult, j(x), j(v), j(c), j(mask),
                                interpret=True)
    if phase == "half":
        got = fused.fused_half_step(t(tx), t(ty), noise_mult, t(x), t(v), t(c), t(mask),
                                    normals=normals)
        return got, jh
    warm = phase == "warm_finish"
    want = jfused.fused_finish(1, j(tx), j(ty), noise_mult, int(warm), j(x), *jh, j(c), j(c2),
                               j(mask), interpret=True)
    got = fused.fused_finish(t(tx), t(ty), noise_mult, warm, t(x), *(t(a) for a in jh), t(c),
                             t(c2), t(mask), normals=normals)
    return got, want


@pytest.mark.parametrize("noise_mult", [0.0, 1.0], ids=["noise0", "noise1"])
@pytest.mark.parametrize("phase", ["half", "warm_finish", "cold_finish"])
def test_plain_versions_match_jax_kernels(phase, noise_mult):
    got, want = _run_both(phase, noise_mult)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == (B, M)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **KERNEL_TOL)


@pytest.mark.parametrize("phase", ["half", "warm_finish", "cold_finish"])
def test_non_finite_damped_step_selects_overdamped_like_jax(phase):
    got, want = _run_both(phase, 1.0, bad=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **KERNEL_TOL)
        assert np.isfinite(g.numpy()).all()
    if phase == "half":  # row 0 is wholly overdamped: x_half == x_half_overdamped
        np.testing.assert_array_equal(got[0][0].numpy(), got[2][0].numpy())
        np.testing.assert_array_equal(got[1][0].numpy(), np.full(M, R, np.float32))


def test_wrappers_refuse_what_they_cannot_run():
    tx, ty, x, v, c, _, mask, _ = _case(3)
    args = [torch.from_numpy(a) for a in (tx, ty)] + [1.0] + [
        torch.from_numpy(a) for a in (x, v, c, mask)]
    with pytest.raises(ValueError, match="needs its normals"):
        fused.fused_half_step(*args)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        fused.fused_half_step(*meta, normals=(meta[3],) * 3)
    assert fused.fused_half_step.launches == 0 and fused.fused_finish.launches == 0


@pytest.fixture(scope="module")
def goldens():
    return np.load(DATA)


@pytest.mark.parametrize("name", CASES)
def test_reference_cases_through_fused_engine(goldens, name):
    run_reference_case(goldens, name, use_fused_kernels=True)
