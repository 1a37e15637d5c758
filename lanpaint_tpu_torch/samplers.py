"""Outer denoising solvers as a host-side Python loop.

PyTorch counterpart of `lanpaint_tpu/samplers.py`: the same 22 solvers
(`SAMPLER_NAMES`), the same `SolverCarry` history slots, the same host
tables (`prepare_tables`: the deis coefficients and heunpp2's full-ladder
rows) and the same dpm_fast grouping.  The contract differs from stock
k-diffusion the same way: the model callback returns `(denoised, x_new)`
and the solver continues from `x_new`, the Langevin-refined iterate (the
reference's in-place `input_x.copy_`, lanpaint.py:122).

ModelFn signature: (x, sigma, step) -> (denoised, x_new).  `sigma` is the
call's host np.float32 sigma; `step` is the outer step the JAX package's
inpaint wrapper gives the call (lanpaint_tpu/api.py:184): the index of the
ladder sigma nearest to `sigma` (the first on a tie, as `jnp.argmin`) plus
`step_offset`.  For a one-call solver it is the loop counter; heun's second
stage (at sigma_next) belongs to the next step, and dpm_fast's calls, on
their own uniform-t grid, to the nearest ladder step.

Where the JAX package computes a solver's scalars in float32 on the
device, this module computes them in np.float32 on the host from the host
ladder, so a step waits on no device sync.  The final-step branches (`sn >
0`, the stage skips) are Python `if`s on those host values.  JAX's
`_staged` (one XLA call site for a multi-stage step) becomes plain
sequential model calls, with its stage skips: no second-stage call on the
final step.

Solver noise: every draw goes through `_noise_like(x, generator, step,
slot)`; slot k of step i is the draw the JAX package takes as
`normal(fold_in(fold_in(key, i + step_offset), k))`, and a slot is drawn
once a step even where JAX reads it twice (seeds_2 and seeds_3 reuse their
stage noise in the final update).  By default it is a `torch.randn` from
the sampler's generator in call order, taken only where the result is used
(JAX also draws where a `jnp.where` discards it: the final step, su = 0).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

ModelFn = Callable[[torch.Tensor, np.float32, int], Tuple[torch.Tensor, torch.Tensor]]

_F = np.float32


class SolverCarry(NamedTuple):
    x: torch.Tensor
    hist1: torch.Tensor   # previous denoised (multistep slot 1)
    hist2: torch.Tensor   # slot 2 (3m methods)
    h1: np.float32        # previous log-step h
    h2: np.float32        # h before that
    nhist: int            # number of valid history entries


def init_carry(x: torch.Tensor) -> SolverCarry:
    """Fresh solver state for a ladder starting at latent `x`."""
    zero = torch.zeros_like(x)
    return SolverCarry(x=x, hist1=zero, hist2=zero, h1=_F(0.0), h2=_F(0.0), nhist=0)


def _to_d(x, sigma, denoised):
    return (x - denoised) / float(np.maximum(_F(sigma), _F(1e-10)))


def _ancestral_step(sigma, sigma_next, eta=1.0):
    """sigma_down/sigma_up split of an ancestral step (k-diffusion)."""
    s, sn = _F(sigma), _F(sigma_next)
    su = np.minimum(sn, _F(eta) * np.sqrt(np.maximum(
        sn**2 * (s**2 - sn**2) / np.maximum(s**2, _F(1e-20)), _F(0.0))))
    sd = np.sqrt(np.maximum(sn**2 - su**2, _F(0.0)))
    return sd, su


def _noise_like(x, generator, step: int, slot: int):
    """Standard normals of x's shape (drawn in fp32, cast to x's dtype):
    slot `slot` of global step `step` (see the module docstring)."""
    return torch.randn(x.shape, generator=generator, dtype=torch.float32,
                       device=x.device).to(x.dtype)


def _neg_log(s):
    return -np.log(np.maximum(_F(s), _F(1e-10)))


# --------------------------------------------------------------------------
# Solvers.  Each: fn(model, carry, sigma, sigma_next, step, generator[, row])
# -> (carry, denoised); `model(x, sigma) -> (denoised, x_new)`, `step` the
# global step index (the noise slots'), `row` the step's table row.


def _euler(model, c, s, sn, i, gen):
    den, x = model(c.x, s)
    x = x + _to_d(x, s, den) * (_F(sn) - _F(s))
    return c._replace(x=x), den


def _euler_ancestral(model, c, s, sn, i, gen):
    den, x = model(c.x, s)
    sd, su = _ancestral_step(s, sn)
    x = x + _to_d(x, s, den) * (sd - s)
    if su > 0:
        x = x + _noise_like(x, gen, i, 0) * su
    return c._replace(x=x), den


def _heun(model, c, s, sn, i, gen):
    den, x = model(c.x, s)
    d = _to_d(x, s, den)
    dt = _F(sn) - _F(s)
    if sn > 0:
        den2, x2 = model(x + d * dt, sn)
        x = x + (d + _to_d(x2, sn, den2)) / 2.0 * dt
    else:
        x = x + d * dt
    return c._replace(x=x), den


def _heunpp2(model, c, s, sn, i, gen, row):
    """Heun++2: 1/2/3-stage scheme selected by distance to the ladder end
    (the public k-diffusion `sample_heunpp2`): the last step is Euler, the
    second-to-last Heun with w2 = sigma_{i+1}/(2 sigma_0), every earlier
    step adds a third Euler extrapolation to sigma_{i+2} with w_k =
    sigma_{i+k-1}/(3 sigma_0).  `row` = [sigma_0, s_end, sigma_{i+2}] of the
    full ladder (`prepare_tables`)."""
    sigma0, s_end, snn = (_F(v) for v in row)
    s, sn = _F(s), _F(sn)
    den, x = model(c.x, s)
    d = _to_d(x, s, den)
    dt = sn - s
    if sn == s_end:
        return c._replace(x=x + d * dt), den
    den2, x2 = model(x + d * dt, sn)
    d2 = _to_d(x2, sn, den2)
    if snn == s_end:
        w2h = sn / (_F(2.0) * sigma0)
        return c._replace(x=x + (d * (1.0 - w2h) + d2 * w2h) * dt), den
    den3, x3 = model(x2 + d2 * (snn - sn), snn)
    d3 = _to_d(x3, snn, den3)
    w2 = sn / (_F(3.0) * sigma0)
    w3 = snn / (_F(3.0) * sigma0)
    x = x + (d * (_F(1.0) - w2 - w3) + d2 * w2 + d3 * w3) * dt
    return c._replace(x=x), den


def _dpm_2(model, c, s, sn, i, gen):
    s, sn = _F(s), _F(sn)
    s_mid = np.exp(_F(0.5) * (np.log(s) + np.log(np.maximum(sn, _F(1e-10)))))
    den, x = model(c.x, s)
    d = _to_d(x, s, den)
    if sn > 0:
        den2, x2 = model(x + d * (s_mid - s), s_mid)
        x = x + _to_d(x2, s_mid, den2) * (sn - s)
    else:
        x = x + d * (sn - s)
    return c._replace(x=x), den


def _dpm_2_ancestral(model, c, s, sn, i, gen):
    s, sn = _F(s), _F(sn)
    sd, su = _ancestral_step(s, sn)
    s_mid = np.exp(_F(0.5) * (np.log(s) + np.log(np.maximum(sd, _F(1e-10)))))
    den, x = model(c.x, s)
    d = _to_d(x, s, den)
    if sd > 0:
        den2, x2 = model(x + d * (s_mid - s), s_mid)
        x = x + _to_d(x2, s_mid, den2) * (sd - s)
        x = x + _noise_like(x, gen, i, 0) * su
    else:
        x = x + d * (sn - s)
    return c._replace(x=x), den


def _ddpm(model, c, s, sn, i, gen):
    """DDPM ancestral step in VP coords (ComfyUI DDPMSampler_step)."""
    s, sn = _F(s), _F(sn)
    den, x = model(c.x, s)
    eps = _to_d(x, s, den)
    x_vp = x / np.sqrt(_F(1.0) + s**2)
    ac = _F(1.0) / (s**2 + _F(1.0))
    ac_prev = _F(1.0) / (sn**2 + _F(1.0))
    alpha = ac / ac_prev
    mu = (x_vp - eps * (_F(1.0) - alpha) / np.sqrt(_F(1.0) - ac)) * (_F(1.0) / np.sqrt(alpha))
    if sn > 0:
        amt = np.sqrt((_F(1.0) - alpha) * (_F(1.0) - ac_prev) / (_F(1.0) - ac))
        mu = mu + _noise_like(mu, gen, i, 0) * amt
    return c._replace(x=mu * np.sqrt(_F(1.0) + sn**2)), den


def _dpmpp_2m(model, c, s, sn, i, gen):
    s, sn = _F(s), _F(sn)
    den, x = model(c.x, s)
    h = _neg_log(sn) - _neg_log(s)
    den_use = den
    if c.nhist >= 1 and sn > 0:
        r = c.h1 / (_F(1.0) if h == 0 else h)
        den_use = den * (_F(1.0) + _F(1.0) / (_F(2.0) * r)) - c.hist1 * (_F(1.0) / (_F(2.0) * r))
    x = x * (sn / s) - den_use * np.expm1(-h)
    return c._replace(x=x, hist1=den, h1=h, nhist=c.nhist + 1), den


def _dpmpp_2m_sde(model, c, s, sn, i, gen, eta=1.0):
    s, sn = _F(s), _F(sn)
    den, x = model(c.x, s)
    h = _F(0.0)
    if sn > 0:
        h = _neg_log(sn) - _neg_log(s)
        eta_h = _F(eta) * h
        x = x * ((sn / s) * np.exp(-eta_h)) + den * (-np.expm1(-h - eta_h))
        if c.nhist >= 1:
            x = x + (den - c.hist1) * (_F(0.5) * (-np.expm1(-h - eta_h)) * (_F(1.0) / (c.h1 / h)))
        nz = np.sqrt(np.maximum(-np.expm1(_F(-2.0) * eta_h), _F(0.0))) * sn
        x = x + _noise_like(x, gen, i, 0) * nz
    else:
        x = den
    return c._replace(x=x, hist1=den, h1=h, nhist=c.nhist + 1), den


def _dpmpp_3m_sde(model, c, s, sn, i, gen, eta=1.0):
    s, sn = _F(s), _F(sn)
    den, x = model(c.x, s)
    h = _F(0.0)
    if sn > 0:
        h = _neg_log(sn) - _neg_log(s)
        h_eta = h * _F(eta + 1.0)
        x = x * np.exp(-h_eta) + den * (-np.expm1(-h_eta))
        phi2 = np.expm1(-h_eta) / h_eta + _F(1.0)
        if c.nhist >= 1:
            safe0 = c.h1 / h
            d1_0 = (den - c.hist1) / safe0
            if c.nhist >= 2:
                safe1 = c.h2 / h
                d1_1 = (c.hist1 - c.hist2) / safe1
                d1 = d1_0 + (d1_0 - d1_1) * safe0 / (safe0 + safe1)
                d2 = (d1_0 - d1_1) / (safe0 + safe1)
                phi3 = phi2 / h_eta - _F(0.5)
                x = x + d1 * phi2 - d2 * phi3
            else:
                x = x + d1_0 * phi2
        nz = np.sqrt(np.maximum(-np.expm1(_F(-2.0) * h * _F(eta)), _F(0.0))) * sn
        x = x + _noise_like(x, gen, i, 0) * nz
    else:
        x = den
    return c._replace(x=x, hist1=den, hist2=c.hist1, h1=h, h2=c.h1, nhist=c.nhist + 1), den


def _dpmpp_sde(model, c, s, sn, i, gen, eta=1.0, r=0.5):
    s, sn = _F(s), _F(sn)
    den, x = model(c.x, s)
    if sn <= 0:
        return c._replace(x=x + _to_d(x, s, den) * (sn - s)), den
    t, tn = _neg_log(s), _neg_log(sn)
    h = tn - t
    s_mid_t = t + h * _F(r)
    sig_t = np.exp(-t)
    # stage 1: to the midpoint, with its own ancestral split
    sd1, su1 = _ancestral_step(sig_t, np.exp(-s_mid_t), eta)
    t_mid_d = _neg_log(sd1)
    x2 = x * (np.exp(-t_mid_d) / sig_t) - den * np.expm1(t - t_mid_d)
    x2 = x2 + _noise_like(x2, gen, i, 0) * su1
    den2, _ = model(x2, np.exp(-s_mid_t))
    # stage 2: the full step
    sd2, su2 = _ancestral_step(sig_t, np.exp(-tn), eta)
    tn_d = _neg_log(sd2)
    fac = _F(1.0 / (2.0 * r))
    den_d = den * (_F(1.0) - fac) + den2 * fac
    x = x * (np.exp(-tn_d) / sig_t) - den_d * np.expm1(t - tn_d)
    x = x + _noise_like(x, gen, i, 1) * su2
    return c._replace(x=x), den


def _res_multistep_core(model, c, s, sn, i, gen, eta):
    s, sn = _F(s), _F(sn)
    den, x = model(c.x, s)
    sd, su = _ancestral_step(s, sn, eta) if eta > 0 else (sn, _F(0.0))
    h = _neg_log(np.maximum(sd, _F(1e-10))) - _neg_log(s)
    if c.nhist < 1 or sd <= 0:  # first or final step: Euler to sigma_down
        x1 = x + _to_d(x, s, den) * (sd - s)
    else:  # second-order RES multistep (phi-function form)
        neg_h = _F(1.0) if h == 0 else -h
        phi1 = np.expm1(-h) / neg_h
        phi2 = (phi1 - _F(1.0)) / neg_h
        c2 = -c.h1 / (_F(1.0) if h == 0 else h)  # t_old - t = -h1, over h
        b2 = phi2 / (_F(1.0) if c2 == 0 else c2)
        b1 = phi1 - b2
        x1 = x * (sd / s) + (den * b1 + c.hist1 * b2) * h
    if su > 0:
        x1 = x1 + _noise_like(x1, gen, i, 0) * su
    return c._replace(x=x1, hist1=den, h1=h, nhist=c.nhist + 1), den


def _res_multistep(model, c, s, sn, i, gen):
    return _res_multistep_core(model, c, s, sn, i, gen, eta=0.0)


def _res_multistep_ancestral(model, c, s, sn, i, gen):
    return _res_multistep_core(model, c, s, sn, i, gen, eta=1.0)


def _seeds_2(model, c, s, sn, i, gen, eta=1.0, r=0.5, s_noise=1.0):
    """SEEDS-2: 2-stage stochastic exponential derivative-free solver
    (Gonzalez et al. 2023)."""
    s, sn = _F(s), _F(sn)
    den, x = model(c.x, s)
    if sn <= 0:
        return c._replace(x=den), den
    t, tn = _neg_log(s), _neg_log(sn)
    h = tn - t
    h_eta = h * _F(eta + 1.0)
    r, eta = _F(r), _F(eta)
    sigma_mid = np.exp(-(t + r * h))
    fac = _F(1.0) / (_F(2.0) * r)
    coeff_1, coeff_2 = np.expm1(-r * h_eta), np.expm1(-h_eta)
    nc_1 = np.sqrt(np.maximum(-np.expm1(_F(-2.0) * r * h * eta), _F(0.0)))
    nc_2 = np.sqrt(np.maximum(np.expm1(_F(-2.0) * r * h * eta) - np.expm1(_F(-2.0) * h * eta),
                              _F(0.0)))
    n1 = _noise_like(x, gen, i, 0)
    x_2 = x * (coeff_1 + _F(1.0)) - den * coeff_1 + n1 * (sigma_mid * nc_1) * s_noise
    den2, _ = model(x_2, sigma_mid)
    n2 = _noise_like(x, gen, i, 1)
    den_d = den * (_F(1.0) - fac) + den2 * fac
    x = x * (coeff_2 + _F(1.0)) - den_d * coeff_2
    x = x + (n1 * nc_2 + n2 * nc_1) * sn * s_noise
    return c._replace(x=x), den


def _seeds_3(model, c, s, sn, i, gen, eta=1.0, r_1=1.0 / 3.0, r_2=2.0 / 3.0, s_noise=1.0):
    """SEEDS-3: 3-stage stochastic exponential solver."""
    s, sn = _F(s), _F(sn)
    den, x = model(c.x, s)
    if sn <= 0:
        return c._replace(x=den), den
    t, tn = _neg_log(s), _neg_log(sn)
    h = tn - t
    h_eta = h * _F(eta + 1.0)
    eta, r_1, r_2 = _F(eta), _F(r_1), _F(r_2)
    sig_1, sig_2 = np.exp(-(t + r_1 * h)), np.exp(-(t + r_2 * h))
    coeff_1, coeff_2, coeff_3 = (np.expm1(-r_1 * h_eta), np.expm1(-r_2 * h_eta),
                                 np.expm1(-h_eta))
    e1, e2, e3 = (np.expm1(_F(-2.0) * r * h * eta) for r in (r_1, r_2, _F(1.0)))
    nc_1 = np.sqrt(np.maximum(-e1, _F(0.0)))
    nc_2 = np.sqrt(np.maximum(e1 - e2, _F(0.0)))
    nc_3 = np.sqrt(np.maximum(e2 - e3, _F(0.0)))
    n1 = _noise_like(x, gen, i, 0)
    x_2 = x * (coeff_1 + _F(1.0)) - den * coeff_1 + n1 * (sig_1 * nc_1) * s_noise
    den2, _ = model(x_2, sig_1)
    n2 = _noise_like(x, gen, i, 1)
    x_3 = (x * (coeff_2 + _F(1.0)) - den * coeff_2
           + (den2 - den) * ((r_2 / r_1) * (coeff_2 / (r_2 * h_eta) + _F(1.0))))
    x_3 = x_3 + (n1 * nc_2 + n2 * nc_1) * sig_2 * s_noise
    den3, _ = model(x_3, sig_2)
    n3 = _noise_like(x, gen, i, 2)
    x = (x * (coeff_3 + _F(1.0)) - den * coeff_3
         + (den3 - den) * ((_F(1.0) / r_2) * (coeff_3 / h_eta + _F(1.0))))
    x = x + (n1 * nc_3 + n2 * nc_2 + n3 * nc_1) * sn * s_noise
    return c._replace(x=x), den


def _er_psi(sig):
    """ER-SDE customary noise-scale function psi(s) = s (exp(s^0.3) + 10)."""
    sig = np.asarray(sig, _F)
    return sig * (np.exp(np.maximum(sig, _F(1e-10)) ** _F(0.3)) + _F(10.0))


def _er_sde(model, c, s, sn, i, gen):
    """Extended reverse-time SDE solver, max order 3 (VE ER-SDE-Solver-3,
    arXiv 2309.06169; k-diffusion `sample_er_sde`): stage k = min(3, nhist +
    1) of the carried history count, 200-point quadratures of 1/psi and
    (sigma - s)/psi over [sn, s].  Carry: hist1 = previous denoised, hist2 =
    previous divided difference, h1 / h2 = sigma_{i-1} / sigma_{i-2}."""
    s, sn = _F(s), _F(sn)
    den, x = model(c.x, s)
    psi_s, psi_sn = _er_psi(s), _er_psi(sn)
    r = psi_sn / psi_s
    dt = sn - s
    step_sz = -dt / _F(200.0)
    sigma_pos = np.maximum(sn, _F(1e-10)) + np.arange(200, dtype=_F) * step_sz
    scaled_pos = _er_psi(sigma_pos)
    den_d = (den - c.hist1) / ((s - c.h1) if c.nhist >= 1 else _F(1.0))
    stage = min(3, c.nhist + 1)
    if sn > 0:
        x = x * r + den * (_F(1.0) - r)
        if stage >= 2:  # first divided difference of the denoised history
            s_int = np.sum(_F(1.0) / scaled_pos) * step_sz
            x = x + den_d * (dt + s_int * psi_sn)
        if stage >= 3:  # second divided difference
            s_u = np.sum((sigma_pos - s) / scaled_pos) * step_sz
            den_u = (den_d - c.hist2) / ((s - c.h2) / _F(2.0))
            x = x + den_u * (dt**2 / _F(2.0) + s_u * psi_sn)
        amt = np.sqrt(np.maximum(sn**2 - s**2 * r**2, _F(0.0)))
        x = x + _noise_like(x, gen, i, 0) * amt
    else:
        x = den
    return c._replace(x=x, hist1=den, hist2=den_d, h1=s, h2=c.h1, nhist=c.nhist + 1), den


def _gradient_estimation(model, c, s, sn, i, gen, ge_gamma=2.0):
    den, x = model(c.x, s)
    d = _to_d(x, s, den)
    dt = _F(sn) - _F(s)
    if c.nhist >= 1 and sn > 0:
        x = x + (d * _F(ge_gamma) + c.hist1 * _F(1.0 - ge_gamma)) * dt
    else:
        x = x + d * dt
    return c._replace(x=x, hist1=d, nhist=c.nhist + 1), den


# --------------------------------------------------------------------------
# DEIS: exponential Adams-Bashforth in eps space (Zhang & Chen, DEIS).  In
# VE coords the probability-flow ODE is dx/dsigma = eps(x, sigma), so the
# AB-k update is x_{n+1} = x_n + sum_j C_j eps_{n-j}, C_j the exact integrals
# of the Lagrange basis over [sigma_n, sigma_{n+1}], from the host ladder.


def _deis_coeffs(sigmas, max_order: int = 3):
    """A copy of lanpaint_tpu/samplers.py's `_deis_coeffs` (numpy only)."""
    sig = np.asarray(sigmas, np.float64)
    n = len(sig) - 1
    coeffs = np.zeros((n, max_order), np.float64)
    for i in range(n):
        order = min(i + 1, max_order, n - i)
        nodes = sig[i - order + 1: i + 1][::-1]  # sigma_i, sigma_{i-1}, ...
        for j in range(order):
            # Lagrange basis L_j over `nodes`, integrated sigma_i -> sigma_{i+1}
            poly = np.poly1d([1.0])
            for l in range(order):
                if l == j:
                    continue
                poly *= np.poly1d([1.0, -nodes[l]]) / (nodes[j] - nodes[l])
            P = poly.integ()
            coeffs[i, j] = P(sig[i + 1]) - P(sig[i])
    return coeffs.astype("float32")


def _deis(model, c, s, sn, i, gen, row):
    den, x = model(c.x, s)
    eps = _to_d(x, s, den)
    # history: hist1 = eps_{i-1}, hist2 = eps_{i-2}
    if sn > 0:
        x = x + (eps * row[0] + c.hist1 * row[1] + c.hist2 * row[2])
    else:
        x = den
    return c._replace(x=x, hist1=eps, hist2=c.hist1, nhist=c.nhist + 1), den


def prepare_tables(sampler: str, sigmas) -> dict:
    """Per-step table rows from a host ladder: deis's coefficients and
    heunpp2's [sigma_0, s_end, sigma_{i+2}], one row per step.  Built from
    the FULL ladder and sliced per segment, a chunked run equals one run."""
    if sampler == "deis":
        return {"deis": _deis_coeffs(sigmas)}
    if sampler == "heunpp2":
        sig = np.asarray(sigmas, np.float32)
        n = len(sig) - 1
        return {"heunpp2": np.stack([np.full((n,), sig[0], np.float32),
                                     np.full((n,), sig[-1], np.float32),
                                     sig[np.minimum(np.arange(n) + 2, n)]], axis=1)}
    return {}


# --------------------------------------------------------------------------
# dpm_fast: DPM-Solver fast variant, a uniform grid in t = -log sigma with
# steps grouped into order-3 blocks plus an order-1/2 tail (k-diffusion's
# grouping).  Here `model(x, sigma) -> (denoised, x_new)`.


def _dpm1(model, x, t, t_next):
    sig, sign = np.exp(-t), np.exp(-t_next)
    den, x = model(x, sig)
    return x - _to_d(x, sig, den) * (sign * np.expm1(t_next - t)), den


def _dpm2(model, x_in, t, t_next, r1=0.5):
    sig = np.exp(-t)
    h = t_next - t
    sig1 = np.exp(-(t + _F(r1) * h))
    den, x = model(x_in, sig)
    eps = _to_d(x, sig, den)
    den1, x1 = model(x - eps * (sig1 * np.expm1(_F(r1) * h)), sig1)
    eps1 = _to_d(x1, sig1, den1)
    sign = np.exp(-t_next)
    x = x - eps * (sign * np.expm1(h)) - (eps1 - eps) * (sign / _F(2 * r1) * np.expm1(h))
    return x, den


def _dpm3(model, x_in, t, t_next, r1=1.0 / 3.0, r2=2.0 / 3.0):
    r1, r2 = _F(r1), _F(r2)
    sig = np.exp(-t)
    h = t_next - t
    sig1, sig2 = np.exp(-(t + r1 * h)), np.exp(-(t + r2 * h))
    den, x = model(x_in, sig)
    eps = _to_d(x, sig, den)
    den1, x1 = model(x - eps * (sig1 * np.expm1(r1 * h)), sig1)
    eps1 = _to_d(x1, sig1, den1)
    u2 = (x - eps * (sig2 * np.expm1(r2 * h))
          - (eps1 - eps) * (sig2 * (r2 / r1) * (np.expm1(r2 * h) / (r2 * h) - _F(1.0))))
    den2, x2 = model(u2, sig2)
    eps2 = _to_d(x2, sig2, den2)
    sign = np.exp(-t_next)
    x = (x - eps * (sign * np.expm1(h))
         - (eps2 - eps) * (sign / r2 * (np.expm1(h) / h - _F(1.0))))
    return x, den


def _dpm_fast_orders(m: int):
    """k-diffusion dpm_solver_fast step grouping for m solver steps."""
    if m < 3:
        return [1] * m
    if m % 3 == 0:
        return [3] * (m // 3 - 1) + [2, 1]
    if m % 3 == 1:
        return [3] * (m // 3) + [1]
    return [3] * (m // 3) + [2]


def dpm_fast_groups(total_steps: int):
    """The order grouping of a `total_steps`-step ladder.  Groups are atomic
    multi-call updates, the chunkable unit of dpm_fast."""
    return _dpm_fast_orders(max(total_steps - 1, 1))


def _sample_dpm_fast(model, noise_x, sigmas, callback=None, g_range=None):
    """DPM-Solver-fast: a uniform grid in t = -log sigma between the
    ladder's endpoints, its groups in order, then a final denoise at
    sigma_min (the ladder is assumed to end at 0).  `g_range = (g0, g1,
    include_final)` runs groups [g0, g1) only, plus the final denoise when
    include_final: the chunked path; `sigmas` is still the full ladder, from
    which grid and grouping come.  `callback(g, denoised, x)` after each
    group (g = the group count after the final denoise).  Returns (x,
    [denoised per group run])."""
    sigmas = np.asarray(sigmas, np.float32)
    m = max(len(sigmas) - 2, 1)
    orders = _dpm_fast_orders(m)
    bounds = np.cumsum([0] + orders)
    t0, t1 = -np.log(sigmas[0]), -np.log(sigmas[-2])
    ts = t0 + (t1 - t0) * np.arange(m + 1, dtype=np.float32) / _F(m)
    g0, g1, include_final = (0, len(orders), True) if g_range is None else g_range
    x, dens = noise_x, []
    for g in range(g0, g1):
        group = {1: _dpm1, 2: _dpm2, 3: _dpm3}[orders[g]]
        x, den = group(model, x, ts[bounds[g]], ts[bounds[g + 1]])
        if callback is not None:
            callback(g, den, x)
        dens.append(den)
    if include_final:
        den, _ = model(x, sigmas[-2])
        x = den
        if callback is not None:
            callback(len(orders), den, x)
        dens.append(den)
    return x, dens


_SOLVERS = {
    "euler": _euler, "euler_ancestral": _euler_ancestral, "heun": _heun,
    "heunpp2": _heunpp2, "dpm_2": _dpm_2, "dpm_2_ancestral": _dpm_2_ancestral,
    "ddpm": _ddpm, "dpmpp_2m": _dpmpp_2m, "dpmpp_2m_sde": _dpmpp_2m_sde,
    "dpmpp_2m_sde_gpu": _dpmpp_2m_sde, "dpmpp_3m_sde": _dpmpp_3m_sde,
    "dpmpp_3m_sde_gpu": _dpmpp_3m_sde, "dpmpp_sde": _dpmpp_sde, "dpmpp_sde_gpu": _dpmpp_sde,
    "res_multistep": _res_multistep, "res_multistep_ancestral": _res_multistep_ancestral,
    "seeds_2": _seeds_2, "seeds_3": _seeds_3, "er_sde": _er_sde,
    "gradient_estimation": _gradient_estimation, "deis": _deis,
    "dpm_fast": _sample_dpm_fast,  # runs a whole ladder; sample() dispatches it
}
# Every solver name, in the JAX package's registration order.
SAMPLER_NAMES = list(_SOLVERS)
_TABLE_SOLVERS = ("deis", "heunpp2")  # solvers that take their step's table row


def get_solver(name: str):
    """The step function of solver `name` (dpm_fast: `_sample_dpm_fast`,
    which runs a whole ladder); ValueError for a name the JAX package does
    not register."""
    try:
        return _SOLVERS[name]
    except KeyError:
        raise ValueError(f"unknown sampler {name!r}; available: {sorted(_SOLVERS)}") from None


def model_step(sigmas, sigma, step_offset: int = 0) -> int:
    """The outer step of a model call at `sigma`: the index of the nearest
    sigma of the launch's ladder (the first on a tie, as `jnp.argmin`) plus
    `step_offset` (lanpaint_tpu/api.py:184)."""
    return int(np.argmin(np.abs(np.asarray(sigmas, np.float32) - _F(sigma)))) + step_offset


def sample(
    model: ModelFn,
    noise_x: torch.Tensor,
    sigmas,
    *,
    sampler: str = "euler",
    generator: torch.Generator = None,
    callback=None,
    tables: dict = None,
    step_offset: int = 0,
    carry_in: SolverCarry = None,
    return_carry: bool = False,
    collect_aux: bool = False,
    dpm_fast_range=None,
):
    """Run the outer sampling loop.

    `noise_x` is the initial latent AFTER initial noise scaling (reference
    nodes.py:221); `sigmas` the host [steps+1] descending ladder (for
    dpm_fast always the full ladder).  Returns (samples, all_denoised) with
    all_denoised[i] the x0 prediction of step i (of group i for dpm_fast).

    `step_offset`: the global index of this ladder's first step when a run
    is cut into segments (api.LanPaintSampler chunk_steps): `callback(i,
    denoised, x)` (after each step), the noise slots and the model's step
    see global indices.  `tables`: `prepare_tables` of the full ladder,
    sliced to the segment (built from `sigmas` when None).
    `dpm_fast_range`: the (g0, g1, include_final) group range of a chunked
    dpm_fast launch.  `carry_in`/`return_carry`: the solver state threads
    from one segment to the next (pass the previous segment's carry, with
    `noise_x` its output); with `return_carry` the result is (samples,
    all_denoised, carry).  `collect_aux`: the model returns (denoised,
    x_new, aux) and the aux of each step's first model call is kept;
    all_denoised becomes the pair (denoised_stack, [aux per step]).
    """
    step_fn = get_solver(sampler)
    sigmas = np.asarray(sigmas, dtype=np.float32)
    auxs = []
    step = [0]  # the local index of the running step (dpm_fast: group)

    def call(x, s):
        out = model(x, s, model_step(sigmas, s, step_offset))
        if not collect_aux:
            return out
        den, x_new, aux = out
        if len(auxs) == step[0]:  # the step's first call
            auxs.append(aux)
        return den, x_new

    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        if sampler == "dpm_fast":
            def on_group(g, den, x):
                step[0] += 1
                if callback is not None:
                    callback(g, den, x)

            x, dens = _sample_dpm_fast(call, noise_x, sigmas, on_group, dpm_fast_range)
            carry = init_carry(x)
        else:
            if sampler in _TABLE_SOLVERS and (tables is None or sampler not in tables):
                tables = prepare_tables(sampler, sigmas)
            carry = init_carry(noise_x) if carry_in is None else carry_in._replace(x=noise_x)
            dens = []
            for i in range(sigmas.shape[0] - 1):
                step[0] = i
                kw = {"row": tables[sampler][i]} if sampler in _TABLE_SOLVERS else {}
                carry, den = step_fn(call, carry, sigmas[i], sigmas[i + 1], i + step_offset,
                                     generator, **kw)
                if callback is not None:
                    callback(i + step_offset, den, carry.x)
                dens.append(den)
            x = carry.x
    den_all = (torch.stack(dens) if dens
               else noise_x.new_zeros((0,) + tuple(noise_x.shape)))
    if collect_aux:
        den_all = (den_all, auxs)
    return (x, den_all, carry) if return_carry else (x, den_all)
