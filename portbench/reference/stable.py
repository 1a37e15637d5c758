"""Numerically-stable special functions for the exact SHO integrator.

A frozen copy of `lanpaint_tpu_torch/ops/stable.py` (reference
src/LanPaint/utils.py:2-201).  Every function is a branchless combination of
``expm1``/``cosh``/``sinh`` terms with a Taylor fallback near the singular
point and a trigonometric branch for the oscillatory regime (Delta < 0);
all selects are ``torch.where``, so both branches are evaluated and the
result never depends on host control flow.

All functions compute in the dtype of their tensor inputs; the engine feeds
float32.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "epxm1_x",
    "epxm1mx_x2",
    "expm1mxmhx2_x3",
    "exp_1mcosh_GD",
    "exp_sinh_GsqrtD",
    "exp_cosh",
    "exp_sinh_sqrtD",
    "zeta1",
    "zeta2",
    "sig11",
    "sig22",
    "exp_cosh_minus_terms",
    "Zcoefs",
    "Zcoefs_asymp",
]


def _nan_to_zero(x):
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def epxm1_x(x):
    """(exp(x) - 1) / x, Taylor-stabilized near x = 0."""
    direct = _nan_to_zero(torch.expm1(x) / x)
    taylor = 1.0 + x / 2.0 + x * x / 6.0
    return torch.where(torch.abs(x) < 1e-2, taylor, direct)


def epxm1mx_x2(x):
    """(exp(x) - 1 - x) / x**2, Taylor-stabilized near x = 0."""
    direct = _nan_to_zero((torch.expm1(x) - x) / (x * x))
    taylor = 0.5 + x / 6.0 + x**2 / 24.0 + x**3 / 120.0
    return torch.where(torch.abs(x * x) < 1e-2, taylor, direct)


def expm1mxmhx2_x3(x):
    """(exp(x) - 1 - x - x**2/2) / x**3, Taylor-stabilized near x = 0."""
    direct = _nan_to_zero((torch.expm1(x) - x - x * x / 2.0) / (x**3))
    taylor = 1.0 / 6.0 + x / 24.0 + x**2 / 120.0 + x**3 / 720.0 + x**4 / 5040.0
    return torch.where(torch.abs(x**3) < 1e-2, taylor, direct)


def exp_1mcosh_GD(gamma_t, delta):
    """exp(-g) * (1 - cosh(g*sqrt(d))) / (g**2 * d), g = Gamma*t, d = Delta."""
    is_pos = delta > 0
    sqrt_ad = torch.sqrt(torch.abs(delta))
    g_sd = gamma_t * sqrt_ad
    # d > 0: cosh via two exponentials sharing the e^{-g} damping, so no
    # intermediate overflows for large g*sqrt(d) <= g.
    num_pos = torch.exp(-gamma_t) - 0.5 * (
        torch.exp(gamma_t * (sqrt_ad - 1.0)) + torch.exp(gamma_t * (-sqrt_ad - 1.0))
    )
    # d < 0: cosh(i z) = cos(z).
    num_neg = torch.exp(-gamma_t) * (1.0 - torch.cos(g_sd))
    numerator = torch.where(is_pos, num_pos, num_neg)
    direct = _nan_to_zero(numerator / (delta * gamma_t**2))
    taylor = (
        -0.5 - gamma_t**2 * delta / 24.0 - gamma_t**4 * delta**2 / 720.0
    ) * torch.exp(-gamma_t)
    return torch.where(torch.abs(g_sd * g_sd) < 5e-2, taylor, direct)


def exp_sinh_GsqrtD(gamma_t, delta):
    """exp(-g) * sinh(g*sqrt(d)) / (g*sqrt(d)); sinc in the d < 0 regime."""
    is_pos = delta > 0
    sqrt_ad = torch.sqrt(torch.abs(delta))
    g_sd = gamma_t * sqrt_ad
    num_pos = 0.5 * (
        torch.exp(gamma_t * (sqrt_ad - 1.0)) - torch.exp(gamma_t * (-sqrt_ad - 1.0))
    )
    res_pos = _nan_to_zero(num_pos / g_sd)
    taylor = (
        1.0 + gamma_t**2 * delta / 6.0 + gamma_t**4 * delta**2 / 120.0
    ) * torch.exp(-gamma_t)
    res_pos = torch.where(torch.abs(g_sd) < 1e-2, taylor, res_pos)
    # d < 0: sinh(i z)/(i z) = sin(z)/z = sinc(z / pi) (normalized sinc).
    res_neg = torch.exp(-gamma_t) * torch.sinc(g_sd / math.pi)
    return torch.where(is_pos, res_pos, res_neg)


def exp_cosh(gamma_t, delta):
    """exp(-g) * cosh(g*sqrt(d)), built from exp_1mcosh_GD for stability."""
    return torch.exp(-gamma_t) - gamma_t**2 * delta * exp_1mcosh_GD(gamma_t, delta)


def exp_sinh_sqrtD(gamma_t, delta):
    """exp(-g) * sinh(g*sqrt(d)) / sqrt(d)."""
    return gamma_t * exp_sinh_GsqrtD(gamma_t, delta)


def zeta1(gamma_t, delta):
    """First SHO relaxation coefficient (reference utils.py:113-136)."""
    half = gamma_t / 2.0
    num = 1.0 - (exp_cosh(half, delta) + exp_sinh_sqrtD(half, delta))
    den = gamma_t * (1.0 - delta) / 4.0
    direct = _nan_to_zero(1.0 - num / den)
    t1 = epxm1_x(-gamma_t)
    t2 = epxm1mx_x2(-gamma_t)
    t3 = expm1mxmhx2_x3(-gamma_t)
    taylor = (
        t1
        + (0.5 + t1 - 3.0 * t2) * den
        + (-1.0 / 6.0 + t1 / 2.0 - 4.0 * t2 + 10.0 * t3) * den**2
    )
    return torch.where(torch.abs(den) < 5e-3, taylor, direct)


def zeta2(gamma_t, delta):
    """Second SHO relaxation coefficient: exp(-g/2)*sinh((g/2)sqrt(d))/((g/2)sqrt(d))."""
    return exp_sinh_GsqrtD(gamma_t / 2.0, delta)


def sig11(gamma_t, delta):
    """Velocity-velocity covariance shape factor (reference utils.py:180-181)."""
    return (
        1.0
        - torch.exp(-gamma_t)
        + gamma_t**2 * exp_1mcosh_GD(gamma_t, delta)
        + exp_sinh_sqrtD(gamma_t, delta)
    )


def sig22(gamma_t, delta):
    """Position-position covariance shape factor (reference utils.py:228-229)."""
    return 1.0 - zeta1(2.0 * gamma_t, delta) + 2.0 * gamma_t * exp_1mcosh_GD(gamma_t, delta)


def exp_cosh_minus_terms(gamma_t, delta):
    """exp(-g)*(cosh(g) - 1 - (cosh(g sqrt(d)) - 1)/d) / (g (1 - d)).

    Kept for numerics-library parity; not used by the sampler hot path.
    """
    exp_term = torch.exp(-gamma_t)
    one = torch.ones_like(delta)
    cosh_term = exp_cosh(gamma_t, one) - exp_term
    cosh_delta_term = -(gamma_t**2) * exp_1mcosh_GD(gamma_t, delta)
    num = cosh_term - cosh_delta_term
    den = gamma_t * (1.0 - delta)
    direct = _nan_to_zero(num / den)
    e1 = exp_1mcosh_GD(gamma_t, one)
    es = exp_sinh_GsqrtD(gamma_t, one)
    taylor = (
        gamma_t * e1
        + 0.5 * gamma_t * es
        - den / 4.0 * (0.5 * exp_cosh(gamma_t, one) - 4.0 * e1 - 2.5 * es)
    )
    return torch.where(torch.abs(den) < 1e-1, taylor, direct)


def Zcoefs(gamma_t, delta):
    """Noise-amplitude decomposition coefficients (reference utils.py:184-197)."""
    z1 = zeta1(gamma_t, delta)
    z2 = zeta2(gamma_t, delta)
    sq_total = 1.0 - z1 + gamma_t * (delta - 1.0) * (z1 - 1.0) ** 2 / 8.0
    amplitude = torch.sqrt(sq_total)
    sqrt2 = torch.sqrt(torch.tensor(2.0, dtype=z2.dtype, device=z2.device))
    c1 = (torch.sqrt(gamma_t) * z2 / sqrt2) / amplitude
    c2 = c1 * gamma_t * torch.sqrt(
        -2.0 * exp_1mcosh_GD(gamma_t, delta) / sig11(gamma_t, delta)
    )
    c3 = torch.sqrt(torch.clamp_min(1.0 - c1**2 - c2**2, 0.0))
    return c1 * amplitude, c2 * amplitude, c3 * amplitude, amplitude


def Zcoefs_asymp(gamma_t, delta):
    """Overdamped asymptotic amplitude (reference utils.py:199-201)."""
    a_t = gamma_t * (1.0 - delta) / 4.0
    return epxm1_x(-2.0 * a_t)
