"""The port's numerics core against the JAX package, in fp32 on the CPU.

`ops/stable.py`, `ops/sho.py` and `schedule.py` over seeded grids that
include the critical band gamma^2 ~ 4a (Delta ~ 0), the oscillatory
regime (Delta < 0), the Taylor-fallback thresholds, and the ends of the
schedule (abt -> 0 and abt -> 1).

Two checks per function:

* float64: the port's formula against the JAX package's, both evaluated in
  float64, at rtol 1e-9 - the math is the same, term for term;
* fp32: rtol 1e-5, atol 1e-6 against the JAX function in fp32.  Both
  sides evaluate the same formulas in fp32, and their exp/expm1/cos differ
  by an ulp or two.  Where a formula cancels badly (the Cholesky terms of a
  very stiff oscillator, gamma ~ 1e3 with t ~ 5e-5; the `Zcoefs` square
  root of 1 - c1^2 - c2^2) that ulp grows past the tolerance in BOTH
  packages, each landing up to ~3e-3 from the float64 value.  At such an
  element the port passes if it is no further from the float64 value than
  the JAX package's worst fp32 result on the same grid, plus the tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanpaint_tpu import schedule as jsched
from lanpaint_tpu.config import ModelKind as JKind
from lanpaint_tpu.ops import sho as jsho
from lanpaint_tpu.ops import stable as jstable
from lanpaint_tpu_torch import schedule as tsched
from lanpaint_tpu_torch.config import ModelKind as TKind
from lanpaint_tpu_torch.ops import sho as tsho
from lanpaint_tpu_torch.ops import stable as tstable

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, name="", want64=None):
    """|got - want| within tolerance, or (given the float64 value `want64`
    of the JAX formula) got no further from it than the JAX fp32 result's
    worst error over the grid."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    excess = np.abs(got - want) - (ATOL + RTOL * np.abs(want))
    if want64 is not None:
        want64 = np.asarray(want64, np.float64)
        excess = np.minimum(excess, np.abs(got - want64) - (
            ATOL + RTOL * np.abs(want64) + np.abs(want - want64).max()))
    bad = np.flatnonzero(excess > 0)
    assert bad.size == 0, (f"{name}: {bad.size} of {excess.size} elements out of "
                           f"tolerance, worst excess {excess.max():.3g} at flat "
                           f"index {int(np.argmax(excess))}")


def _same64(got64, want64, name):
    for k, (a, b) in enumerate(zip(got64, want64)):
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-9, atol=1e-12,
                                   err_msg=f"{name}[{k}] in float64")


def _jax64(fn, *args):
    """`fn` of the JAX package on float64 copies of `args`."""
    with jax.enable_x64():
        out = fn(*(jnp.asarray(np.asarray(a), jnp.float64) for a in args))
        return jax.tree.map(np.asarray, out)


def _grid():
    """(gamma_t, delta) pairs: Taylor bands, the critical band, both regimes."""
    rng = np.random.default_rng(0)
    g = np.concatenate([np.logspace(-4, 2, 25), [5e-3, 1e-2, 0.1, 0.22, 0.45, 1.0],
                        rng.uniform(0.0, 30.0, 10)])
    d = np.concatenate([-np.logspace(-7, 2, 12), [0.0], np.logspace(-7, 0, 12),
                        1.0 - np.logspace(-7, -1, 5), rng.uniform(-20.0, 1.0, 6)])
    gg, dd = np.meshgrid(g, d, indexing="ij")
    return gg.ravel().astype(np.float32), dd.ravel().astype(np.float32)


ONE_ARG = ["epxm1_x", "epxm1mx_x2", "expm1mxmhx2_x3"]
TWO_ARG = [n for n in jstable.__all__ if n not in ONE_ARG]


@pytest.mark.parametrize("name", ONE_ARG)
def test_stable_one_arg(name):
    x = np.concatenate([np.linspace(-40, 40, 801), np.logspace(-8, 0.5, 60),
                        -np.logspace(-8, 0.5, 60), [0.0, 0.1, -0.1, 0.2154, -0.2154]])
    x = x.astype(np.float32)
    _close(getattr(tstable, name)(torch.from_numpy(x)),
           getattr(jstable, name)(jnp.asarray(x)), name)


@pytest.mark.parametrize("name", TWO_ARG)
def test_stable_two_arg(name):
    g, d = _grid()
    got = getattr(tstable, name)(torch.from_numpy(g), torch.from_numpy(d))
    want = getattr(jstable, name)(jnp.asarray(g), jnp.asarray(d))
    want64 = _jax64(getattr(jstable, name), g, d)
    got64 = getattr(tstable, name)(*(torch.from_numpy(v).double() for v in (g, d)))
    _same64(*((got64, want64) if isinstance(want, tuple) else ((got64,), (want64,))), name)
    if isinstance(want, tuple):
        for k, (a, b, c) in enumerate(zip(got, want, want64)):
            _close(a, b, f"{name}[{k}]", c)
    else:
        _close(got, want, name, want64)


def _engine_scalars():
    """(gamma, a, dt) per branch as the engine builds them
    (lanpaint_tpu/engine.py::_prepare_region_params), over abt from ~0 to
    ~1, plus points on the critical band gamma = 4a."""
    rows = []
    for abt in (1e-6, 1e-3, 0.1, 0.5, 0.9, 0.999, 1.0 - 1e-6):
        for friction in (0.5, 2.0, 15.0, 50.0):
            for step in (1e-4, 0.2, 1.0):
                for sig, lam in ((1.0, 0.0), (1.0, 16.0), (2.5, 16.0)):
                    dt = step * (1.0 - abt) * sig
                    gamma = friction**2 * step * sig / 0.1 / 2.0 / dt
                    a = (1.0 + lam) / (1.0 - abt)
                    rows.append((gamma, a, dt))
    for a in (1.0, 3.0, 50.0, 1e3):
        for eps in (-1e-3, -1e-6, 0.0, 1e-6, 1e-3):
            rows.append((4.0 * a * (1.0 + eps), a, 0.05))
    return np.asarray(rows, np.float32).T


@pytest.mark.parametrize("half", [True, False], ids=["half_step", "full_step"])
def test_sho_and_ou_coeffs(half):
    gamma, a, dt = _engine_scalars()
    t = dt / 2.0 if half else dt
    d = np.float32(np.sqrt(2.0))
    tt = [torch.from_numpy(v) for v in (gamma, a, t)]
    jj = [jnp.asarray(v) for v in (gamma, a, t)]
    got = tsho.sho_coeffs(tt[0], tt[1], torch.tensor(d), tt[2])
    want = jsho.sho_coeffs(jj[0], jj[1], jnp.float32(d), jj[2])
    want64 = _jax64(jsho.sho_coeffs, gamma, a, d, t)
    _same64(tsho.sho_coeffs(*(torch.from_numpy(np.asarray(v)).double()
                              for v in (gamma, a, d, t))), want64, "sho_coeffs")
    for k, field in enumerate(jsho.SHOCoeffs._fields):
        _close(getattr(got, field), getattr(want, field), f"sho.{field}", want64[k])
    got = tsho.ou_coeffs(tt[1], torch.tensor(d), tt[2])
    want = jsho.ou_coeffs(jj[1], jnp.float32(d), jj[2])
    want64 = _jax64(jsho.ou_coeffs, a, d, t)
    _same64(tsho.ou_coeffs(*(torch.from_numpy(np.asarray(v)).double() for v in (a, d, t))),
            want64, "ou_coeffs")
    for k, field in enumerate(jsho.OUCoeffs._fields):
        _close(getattr(got, field), getattr(want, field), f"ou.{field}", want64[k])


def test_sho_and_ou_apply():
    rng = np.random.default_rng(1)
    shape = (3, 4, 5)
    y0, v0, c, ey, ev = (rng.standard_normal(shape).astype(np.float32) for _ in range(5))
    coef = rng.standard_normal((7,) + shape).astype(np.float32)
    a = rng.uniform(0.5, 5.0, shape).astype(np.float32)
    got = tsho.sho_apply(tsho.SHOCoeffs(*torch.from_numpy(coef)), *map(torch.from_numpy,
                                                                       (y0, v0, a, c, ey, ev)))
    want = jsho.sho_apply(jsho.SHOCoeffs(*jnp.asarray(coef)), *map(jnp.asarray,
                                                                   (y0, v0, a, c, ey, ev)))
    for g_, w_ in zip(got, want):
        _close(g_, w_)
    _close(tsho.ou_apply(tsho.OUCoeffs(*torch.from_numpy(coef[:3])), *map(torch.from_numpy,
                                                                          (y0, c, ey))),
           jsho.ou_apply(jsho.OUCoeffs(*jnp.asarray(coef[:3])), *map(jnp.asarray,
                                                                     (y0, c, ey))))


@pytest.mark.parametrize("kind", ["eps", "flow"])
def test_schedule(kind):
    tk, jk = TKind(kind), JKind(kind)
    rng = np.random.default_rng(2)
    if kind == "eps":
        sig = np.asarray([1e-4, 0.0291675, 0.5, 1.0, 3.17, 14.6146, 80.0], np.float32)
    else:
        sig = np.asarray([1e-5, 0.05, 0.3, 0.5, 0.8, 0.999, 1.0 - 1e-6], np.float32)
    b = sig.shape[0]
    tt = tsched.unify_times(torch.from_numpy(sig), tk)
    jt = jsched.unify_times(jnp.asarray(sig), jk)
    for field in jsched.Times._fields:
        _close(getattr(tt, field), getattr(jt, field), f"times.{field}")
    # abt -> 0 / 1 at the ends of the ladder
    assert float(tt.abt.min()) < 1e-3 or kind == "flow"
    assert float(tt.abt.max()) > 0.999

    for ndim in (4, 5):
        shape = (b, 2) + (3,) * (ndim - 2)
        x, noise, lat = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
        tx, tn, tl = map(torch.from_numpy, (x, noise, lat))
        jx, jn, jl = map(jnp.asarray, (x, noise, lat))
        _close(tsched.bcast_to(torch.from_numpy(sig), ndim),
               jsched.bcast_to(jnp.asarray(sig), ndim))
        for md in (False, True):
            _close(tsched.noise_scaling(tk, torch.from_numpy(sig), tn, tl, max_denoise=md),
                   jsched.noise_scaling(jk, jnp.asarray(sig), jn, jl, max_denoise=md))
        _close(tsched.inverse_noise_scaling(tk, torch.from_numpy(sig), tx),
               jsched.inverse_noise_scaling(jk, jnp.asarray(sig), jx))
        for fn in ("to_vp", "from_vp"):
            _close(getattr(tsched, fn)(tk, tx, tt, ndim), getattr(jsched, fn)(jk, jx, jt, ndim),
                   fn)
        (gx, gt), (wx, wt) = (tsched.vp_to_model_coords(tk, tx, tt, ndim),
                              jsched.vp_to_model_coords(jk, jx, jt, ndim))
        _close(gx, wx)
        _close(gt, wt)
