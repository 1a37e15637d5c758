"""Plain LanPaint inpainting step: sigma ladders, the think loop, CFG, the
known-region blend and the euler step, in float32.

A frozen copy of the parts of `lanpaint_tpu_torch` that one outer step of
`api.ksampler` runs on the unfused path with the semantic stop off (its
defaults): `sigmas.karras` / `simple_scheduler`, `schedule`,
`ops/sho.py`, `engine.lanpaint_update`, `guidance.make_cfg_double_denoiser`,
`masks.reshape_mask` and `samplers._euler`.  The draws are replayed from
the job's seed through one `torch.Generator` on the job's device, in the
order `api.LanPaintSampler` documents: the initial noise, then per outer
step one draw of the latent's shape and one (5, *shape) draw for each
Langevin iteration.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .stable import sig11, sig22, zeta1, zeta2

CHOL_TOL = 1e-8
# LanPaint_KSampler's fixed defaults (reference nodes.py:329-336)
LAMB, STEP_SIZE, BETA, FRICTION, OUTER_EARLY_STOP = 16.0, 0.2, 1.0, 15.0, 1


# ---------------------------------------------------------------- ladders


def flow_table(shift: float, n: int = 1000) -> np.ndarray:
    t = np.arange(1, n + 1, dtype=np.float64) / n
    return shift * t / (1 + (shift - 1) * t)


def ladder(scheduler: str, steps: int, table: np.ndarray) -> np.ndarray:
    """The descending sigma (EPS) or flow-t (FLOW) ladder of `steps` steps
    over the model's ascending table, a trailing 0."""
    if scheduler == "karras":
        ramp = np.linspace(0, 1, steps, dtype=np.float64)
        lo, hi = float(table[0]) ** (1 / 7.0), float(table[-1]) ** (1 / 7.0)
        sig = (hi + ramp * (lo - hi)) ** 7.0
    elif scheduler == "simple":
        stride = len(table) / steps
        sig = np.asarray([float(table[-(1 + int(i * stride))]) for i in range(steps)])
    else:
        raise ValueError(f"the reference has no scheduler {scheduler!r}")
    return np.append(sig, 0.0).astype(np.float32)


# ---------------------------------------------------------------- times


class Times(NamedTuple):
    ve_sigma: torch.Tensor
    abt: torch.Tensor
    flow_t: torch.Tensor


def unify(sigma: torch.Tensor, kind: str) -> Times:
    if kind == "flow":
        t = sigma
        abt = (1.0 - t) ** 2 / ((1.0 - t) ** 2 + t**2)
        return Times(t / (1.0 - t), abt, t)
    abt = 1.0 / (1.0 + sigma**2)
    r = torch.sqrt(1.0 - abt)
    return Times(sigma, abt, r / (r + torch.sqrt(abt)))


def col(a, ndim):
    return a.reshape(a.shape[:1] + (1,) * (ndim - 1))


def noise_scaling(kind, sigma, noise, latent, max_denoise=False):
    s = col(sigma, noise.ndim)
    if kind == "flow":
        return s * noise + (1.0 - s) * latent
    if max_denoise:
        return latent + noise * torch.sqrt(1.0 + s**2)
    return latent + noise * s


def to_vp(kind, x, tm: Times):
    if kind == "flow":
        abt = col(tm.abt, x.ndim)
        return x * (torch.sqrt(abt) + torch.sqrt(1.0 - abt))
    return x / torch.sqrt(1.0 + col(tm.ve_sigma, x.ndim) ** 2)


def from_vp(kind, x, tm: Times):
    if kind == "flow":
        abt = col(tm.abt, x.ndim)
        return x / (torch.sqrt(abt) + torch.sqrt(1.0 - abt))
    return x * torch.sqrt(1.0 + col(tm.ve_sigma, x.ndim) ** 2)


def model_coords(kind, x_t, tm: Times):
    if kind == "flow":
        return from_vp(kind, x_t, tm), tm.flow_t
    return from_vp(kind, x_t, tm), tm.ve_sigma


# ---------------------------------------------------------------- SHO / OU


class SHO(NamedTuple):
    wy_cy: torch.Tensor
    wy_v: torch.Tensor
    wv_cy: torch.Tensor
    wv_v: torch.Tensor
    l_yy: torch.Tensor
    l_vy: torch.Tensor
    l_vv: torch.Tensor


def sho_coeffs(gamma, a, d, t) -> SHO:
    delta = 1.0 - 4.0 * a / gamma
    gh = gamma * t
    z1, z2 = zeta1(gh, delta), zeta2(gh, delta)
    ee = 1.0 - gh * z2
    sg = torch.sqrt(gamma)
    cov_yy = torch.clamp_min(d * d * t * sig22(gh, delta), CHOL_TOL)
    cov_vv = d * d * sig11(gh, delta) / 2.0
    cov_yv = (z2 * gh * d) ** 2 / 2.0 / sg
    l_yy = torch.sqrt(cov_yy)
    return SHO((1.0 - z1) * t, z2 * sg * t, (1.0 - ee) / sg, ee - a * t * (1.0 - z1), l_yy,
               cov_yv / l_yy, torch.sqrt(torch.clamp_min(cov_vv - cov_yv * cov_yv / cov_yy,
                                                         CHOL_TOL)))


def sho_apply(c: SHO, y0, v0, a, drive_c, eps_y, eps_v):
    drive = drive_c - a * y0
    y = y0 + c.wy_cy * drive + c.wy_v * v0 + c.l_yy * eps_y
    v = c.wv_cy * drive + c.wv_v * v0 + c.l_vy * eps_y + c.l_vv * eps_v
    return y, v


class OU(NamedTuple):
    decay: torch.Tensor
    k: torch.Tensor
    noise_scale: torch.Tensor


def ou_coeffs(a, d, t, eps: float = 1e-8) -> OU:
    a_dt = a * t
    small = torch.abs(a) < eps
    safe = torch.where(small, torch.ones_like(a), a)
    k = torch.where(small, t, -torch.expm1(-a_dt) / safe)
    k2 = torch.where(small, t, -torch.expm1(-2.0 * a_dt) / (2.0 * safe))
    return OU(torch.exp(-a_dt), k, d * torch.sqrt(torch.clamp_min(k2, 0.0)))


def ou_apply(c: OU, x0, drive_c, eps):
    return c.decay * x0 + c.k * drive_c + c.noise_scale * eps


# ---------------------------------------------------------------- one outer step


def mix(a, b, known):
    return a + (b - a) * known


def cfg_denoiser(model_x0, cond, uncond, cfg: float, cfg_big: float):
    """(x, t) -> (x0, x0_big): one batched cond | uncond pass and the two
    CFG mixes; at cfg 1 the cond pass alone, for both."""
    if uncond is None or math.isclose(cfg, 1.0):
        def single(x, t):
            x0 = model_x0(x, t, cond)
            return x0, x0
        return single
    both = {k: torch.cat([cond[k], uncond[k]]) if torch.is_tensor(cond[k])
            else {n: torch.cat([cond[k][n], uncond[k][n]]) for n in cond[k]} for k in cond}

    def double(x, t):
        b = x.shape[0]
        tb = torch.broadcast_to(t, (b,))
        out = model_x0(torch.cat([x, x]), torch.cat([tb, tb]), both)
        c, u = out[:b], out[b:]
        return u + (c - u) * cfg, u + (c - u) * cfg_big
    return double


def think_step(denoise, x, *, latent, noise, known, tm: Times, n_steps: int, kind: str, gen):
    """One outer step's think loop and final denoise: (blended x0, the
    refined latent), `engine.lanpaint_update` on its unfused path."""
    shape, dev = tuple(x.shape), x.device
    xf, lat = x.float(), latent.float()
    abt = tm.abt.float()
    one_m = 1.0 - abt
    d = torch.sqrt(torch.tensor(2.0, device=abt.device))

    def branch(sig, a):
        dt = STEP_SIZE * one_m * sig
        gamma = FRICTION**2 * STEP_SIZE * sig / 0.1 / 2.0 / torch.where(dt > 0, dt,
                                                                        torch.ones_like(dt))
        return [a, dt, torch.sqrt(gamma) * dt, *sho_coeffs(gamma, a, d, dt / 2.0),
                *sho_coeffs(gamma, a, d, dt), *ou_coeffs(a, d, dt / 2.0), *ou_coeffs(a, d, dt)]

    fx = branch(1.0, 1.0 / torch.clamp_min(one_m, 1e-20))
    fy = branch(BETA, (1.0 + LAMB) / torch.clamp_min(one_m, 1e-20))
    dt_pos = bool(torch.mean(fx[1]) > 0.0)
    nd = x.ndim
    m = [mix(col(a.to(dev), nd), col(b.to(dev), nd), known) for a, b in zip(fx, fy)]
    a_mix, dt, sg_dt = m[0], m[1], m[2]
    sho_h, sho_f = SHO(*m[3:10]), SHO(*m[10:17])
    ou_h, ou_f = OU(*m[17:20]), OU(*m[20:23])
    tm = Times(*(t.float().to(dev) for t in tm))
    abt_b = col(tm.abt, nd)

    regen = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
    noise_f = torch.where(torch.mean(torch.abs(noise.float())) < 1e-8, regen, noise.float())
    known_xt = noise_scaling(kind, tm.ve_sigma if kind == "eps" else tm.flow_t, noise_f, lat)
    xf = xf * (1.0 - known) + known_xt * known
    x_t = to_vp(kind, xf, tm)

    def drift(x_eval, x0, x0_big):
        sx = -(x_eval - x0)
        sy = -(1.0 + LAMB) * (x_eval - lat) + LAMB * (x_eval - x0_big)
        x0_eff = x_eval + mix(sx, sy, known)
        return (torch.sqrt(abt_b) * x0_eff - x_eval) / torch.clamp_min(1.0 - abt_b, 1e-20) \
            + a_mix * x_eval

    v = torch.zeros_like(x_t)
    c_old = torch.zeros_like(x_t)
    for i in range(n_steps if dt_pos else 0):
        eps = torch.randn((5,) + shape, generator=gen, dtype=torch.float32, device=dev)
        e_y1, e_v1, e_y2, e_v2, e_v0 = eps.unbind(0)
        v_stat = e_v0 * d.to(dev) / math.sqrt(2.0)
        if i > 0:
            xh_d, vh_d = sho_apply(sho_h, x_t, v, a_mix, c_old, e_y1, e_v1)
            xh_o = ou_apply(ou_h, x_t, c_old, e_y1)
            bad_h = ~(torch.isfinite(xh_d) & torch.isfinite(vh_d))
            xh, vh = torch.where(bad_h, xh_o, xh_d), torch.where(bad_h, v_stat, vh_d)
            x_eval = xh
        else:
            x_eval = x_t
        x0, x0_big = denoise(*model_coords(kind, x_eval, tm))
        c_new = drift(x_eval, x0.float(), x0_big.float())
        if i > 0:
            v_kick = vh + sg_dt * (c_new - c_old)
            xf_d, vf_d = sho_apply(sho_h, xh, v_kick, a_mix, c_old, e_y2, e_v2)
            xf_o = ou_apply(ou_h, xh_o + (c_new - c_old) * dt, c_old, e_y2)
            bad = bad_h | ~(torch.isfinite(xf_d) & torch.isfinite(vf_d))
        else:
            xf_d, vf_d = sho_apply(sho_f, x_t, v_stat, a_mix, c_new, e_y1, e_v1)
            xf_o = ou_apply(ou_f, x_t, c_new, e_y1)
            bad = ~(torch.isfinite(xf_d) & torch.isfinite(vf_d))
        x_t, v = torch.where(bad, xf_o, xf_d), torch.where(bad, v_stat, vf_d)
        c_old = c_new
    x0, _ = denoise(*model_coords(kind, x_t, tm))
    return x0.float() * (1.0 - known) + lat * known, from_vp(kind, x_t, tm)


# ---------------------------------------------------------------- masks


def latent_mask(mask: torch.Tensor, shape) -> torch.Tensor:
    """A (H, W) pixel mask, 1 = repaint, on the latent grid by nearest-exact
    (source index floor((i + 0.5) in / out)), as (B, C, h, w) float: 1 on
    the KNOWN region."""
    m = mask[None, None].float()
    for axis, target in ((2, shape[2]), (3, shape[3])):
        i = torch.arange(target, dtype=torch.float32, device=m.device)
        src = torch.clamp(torch.floor((i + 0.5) * (m.shape[axis] / target)).long(), 0,
                          m.shape[axis] - 1)
        m = torch.index_select(m, axis, src)
    m = m.expand(shape[0], shape[1], -1, -1)
    return 1.0 - (m > 0.5).float()


# ---------------------------------------------------------------- following a job


def follow(model_x0, job: dict, states: dict, check: list) -> dict:
    """The reference's (denoised, next latent) of each outer step in `check`
    of an euler LanPaint job.  Step 0 starts from the reference's own
    initial latent, drawn and scaled here; step i > 0 from `states[i]`,
    the latent the program handed on after step i - 1.  Every draw of
    every outer step is replayed so that the checked steps get theirs.

    `job`: latent, mask (H, W pixel, 1 = repaint), cond, uncond (or None),
    seed, kind ("eps" | "flow"), sigmas (the host ladder), sigma_max (the
    model table's), n_steps, cfg, cfg_big; `model_x0(x, t, cond)` the denoiser, whose `prepare(cond)`, where it
    has one, runs once a job."""
    latent = job["latent"].float()
    dev, shape = latent.device, tuple(latent.shape)
    kind, sig = job["kind"], np.asarray(job["sigmas"], np.float32)
    total = sig.shape[0] - 1
    gen = torch.Generator(device=dev).manual_seed(int(job["seed"]) & 0xFFFFFFFF)
    noise = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
    known = latent_mask(job["mask"].to(dev), shape)
    prep = getattr(model_x0, "prepare", lambda c: c)
    den = cfg_denoiser(model_x0, prep(job["cond"]),
                       None if job["uncond"] is None else prep(job["uncond"]),
                       job["cfg"], job["cfg_big"])
    b = shape[0]
    s0 = torch.full((b,), float(sig[0]), device=dev)
    top = float(job["sigma_max"])
    x = noise_scaling(kind, s0, noise, latent,
                      max_denoise=math.isclose(float(sig[0]), top, rel_tol=1e-5)
                      or float(sig[0]) > top)
    out = {}
    for i in range(total):
        n = 0 if total - i <= OUTER_EARLY_STOP else job["n_steps"]
        if i not in check:  # keep the stream in step: the same draws, unused
            torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
            for _ in range(n if sig[i] > 0 else 0):
                torch.randn((5,) + shape, generator=gen, dtype=torch.float32, device=dev)
            continue
        x_in = x if i == 0 else states[i].float()
        tm = unify(torch.full((b,), float(sig[i]), dtype=torch.float32), kind)
        den_i, x_ref = think_step(den, x_in, latent=latent, noise=noise, known=known, tm=tm,
                                  n_steps=n, kind=kind, gen=gen)
        d = (x_ref - den_i) / float(np.maximum(sig[i], np.float32(1e-10)))
        out[i] = (den_i, x_ref + d * float(np.float32(sig[i + 1]) - np.float32(sig[i])), x_in)
    return out
