"""Exact stochastic-harmonic-oscillator (SHO) exponential integrator.

PyTorch counterpart of `lanpaint_tpu/ops/sho.py` (reference
src/LanPaint/utils.py:203-300).  The process is

    dy = q dt
    dq = -Gamma * A * y dt + Gamma * C dt + Gamma * D dw - Gamma * q dt

with the velocity variable v = q / sqrt(Gamma).  The exact one-step
transition is a 2D Gaussian in (y, v); its mean map and a manual 2x2
Cholesky factor are computed once per branch on per-batch scalars, and the
noise is passed in by the caller (the engine owns the draw order).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .stable import sig11, sig22, zeta1, zeta2

CHOL_TOL = 1e-8


class SHOCoeffs(NamedTuple):
    """Scalar coefficients of the exact SHO transition over time t.

    `y(t) = mean(y0, v0, C) + L @ eps`; they depend only on (Gamma, A, D, t).
    """

    # mean map: y_mean = y0 + wy_cy*(C - A*y0) + wy_v*v0
    wy_cy: torch.Tensor
    wy_v: torch.Tensor
    # v_mean = wv_cy*(C - A*y0) + wv_v*v0
    wv_cy: torch.Tensor
    wv_v: torch.Tensor
    # Cholesky of the (y, v) covariance: [[l_yy, 0], [l_vy, l_vv]]
    l_yy: torch.Tensor
    l_vy: torch.Tensor
    l_vv: torch.Tensor


def sho_coeffs(gamma, a, d, t) -> SHOCoeffs:
    """Exact transition coefficients (fp32 recommended), as the reference
    `dynamics` (utils.py:230-288) factored so the state enters linearly."""
    delta = 1.0 - 4.0 * a / gamma
    gamma_hat = gamma * t
    z1 = zeta1(gamma_hat, delta)
    z2 = zeta2(gamma_hat, delta)
    ee = 1.0 - gamma_hat * z2
    sqrt_gamma = torch.sqrt(gamma)

    wy_cy = (1.0 - z1) * t
    wy_v = z2 * sqrt_gamma * t
    wv_cy = (1.0 - ee) / sqrt_gamma
    wv_v = ee - a * t * (1.0 - z1)

    cov_yy = d * d * t * sig22(gamma_hat, delta)
    cov_vv = d * d * sig11(gamma_hat, delta) / 2.0
    cov_yv = (z2 * gamma_hat * d) ** 2 / 2.0 / sqrt_gamma

    cov_yy = torch.clamp_min(cov_yy, CHOL_TOL)
    l_yy = torch.sqrt(cov_yy)
    l_vy = cov_yv / l_yy
    l_vv = torch.sqrt(torch.clamp_min(cov_vv - cov_yv * cov_yv / cov_yy, CHOL_TOL))

    return SHOCoeffs(wy_cy, wy_v, wv_cy, wv_v, l_yy, l_vy, l_vv)


def sho_apply(coeffs: SHOCoeffs, y0, v0, a, c, eps_y, eps_v):
    """Apply a precomputed SHO transition to (y0, v0) with noise (eps_y, eps_v).

    Returns (y_t, v_t).  `a` must match the `a` used to build `coeffs`.
    """
    drive = c - a * y0
    y_mean = y0 + coeffs.wy_cy * drive + coeffs.wy_v * v0
    v_mean = coeffs.wv_cy * drive + coeffs.wv_v * v0
    y_t = y_mean + coeffs.l_yy * eps_y
    v_t = v_mean + coeffs.l_vy * eps_y + coeffs.l_vv * eps_v
    return y_t, v_t


class OUCoeffs(NamedTuple):
    """Coefficients of the overdamped (Gamma -> inf) OU limit over time t.

    x_t = decay * x0 + k * C + noise_scale * eps  (reference lanpaint.py:187-209).
    """

    decay: torch.Tensor
    k: torch.Tensor
    noise_scale: torch.Tensor


def ou_coeffs(a, d, t, eps: float = 1e-8) -> OUCoeffs:
    """Exact OU transition: dx = -A x dt + C dt + D dW."""
    a_dt = a * t
    decay = torch.exp(-a_dt)
    small = torch.abs(a) < eps
    safe_a = torch.where(small, torch.ones_like(a), a)
    k = torch.where(small, t, -torch.expm1(-a_dt) / safe_a)
    k2 = torch.where(small, t, -torch.expm1(-2.0 * a_dt) / (2.0 * safe_a))
    noise_scale = d * torch.sqrt(torch.clamp_min(k2, 0.0))
    return OUCoeffs(decay, k, noise_scale)


def ou_apply(coeffs: OUCoeffs, x0, c, eps):
    """Apply a precomputed OU transition with standard-normal noise `eps`."""
    return coeffs.decay * x0 + coeffs.k * c + coeffs.noise_scale * eps
