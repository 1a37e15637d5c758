"""LanPaint inner "think loop": masked Langevin dynamics in eager PyTorch.

PyTorch counterpart of `lanpaint_tpu/engine.py` (reference
src/LanPaint/lanpaint.py:40-288 and earlystop.py).  The math is the same:
step-size/friction/lambda parameterization (lanpaint.py:255-288),
bidirectional score (lanpaint.py:125-141), Strang-like split with velocity
kick (lanpaint.py:211-225), per-element NaN -> overdamped select, and the
semantic early stop with boundary ring, drift anchor, abt-scaled threshold
and patience+1 semantics (earlystop.py:97-101, 273-311).

Host control flow.  The JAX package runs the loop as a `lax.while_loop`
whose exit reads device values.  Here the loop is a Python loop, and:

* with the semantic stop statically off (`inner_threshold == 0`, the
  default and the main path) it runs exactly `n_steps + 1` iterations —
  `n_steps` Langevin steps, then the final denoise — decided on the host.
  The positive-step test (`dt_pos`) reads the per-batch `times`, which the
  sampler API builds on the CPU from the host sigma ladder, so the loop
  issues no device->host sync at all;
* with the semantic stop on, the loop reads the device-side `stopped` flag
  once per inner step (one sync per step, as the reference's `.item()`).

The per-branch SHO/OU coefficients are computed on [B] scalars on the
device of `times` and moved to the latent's device in ONE copy, then
mixed by mask; the per-element work is pure multiply-add.

RNG draw order (this port's own; it cannot match JAX's threefry stream).
One `torch.Generator` is consumed, per `lanpaint_update` call:

1. one standard-normal draw of `x.shape` (fp32): the replacement for an
   all-zero `noise` (reference lanpaint.py:44-45).  It is always drawn, so
   the stream does not depend on the noise's value and the choice stays
   on the device;
2. for every Langevin iteration i (not the final denoise), one draw of
   shape (5, *x.shape) (fp32), slots [eps_y1, eps_v1, eps_y2, eps_v2,
   v_stat] — the layout of the `noise_feed` replay tensor.  The cold step
   (i = 0) reads slots 0, 1 and 4 only.

`noise_feed` (parity/replay mode): (n_max, 5, *x.shape) standard-normal
draws consumed instead of step 2, row i for iteration i (row index clamped
to n_max - 1), exactly as `lanpaint_tpu/engine.py` consumes it.  Draw 1 is
still taken from the generator.

Fused kernels (`config.use_fused_kernels`, ops/fused.py).  The pointwise
work of an iteration runs as two launches on flat (B, M) views of the
latent: the half step before the model (warm iterations only: the cold
step evaluates the model at x_t) and the finish after it (every Langevin
iteration, warm or cold as a compile-time flag).  Only the mask-mixed `a`
is built latent-sized; every other coefficient stays in two (B, 24)
tables.  On a CUDA latent the kernels draw their own normals: step 2 is
replaced by ONE int64 draw (a one-element tensor on the card) from the
generator per call, the Philox4x32-10 key.  Launch 2i (half) and 2i + 1
(finish) put their index in the counter: stream j of flat element e of
the (B, M) view is lane e % 4 of Philox(counter (e >> 2, launch, j, 0),
key (seed_lo, seed_hi)), so the streams of different launches are
disjoint by construction, and `ops/fused.philox_normals` draws the same
numbers on the CPU.  `noise_feed` is refused there.  On
the CPU the plain fused versions take step 2's draws (or the feed's),
mapped as half (eps_y1, eps_v1, v_stat), warm finish (eps_y2, eps_v2,
v_stat) and cold finish (eps_y1, eps_v1, v_stat), which reproduces the
unfused path's draws.  The one difference from the unfused path, as in
the TPU kernel: the warm finish's non-finite select does not OR in the
half step's (identical results unless a damped half step overflowed from
finite coefficients).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from .config import LanPaintConfig, ModelKind
from .ops import fused as fused_ops
from .ops.sho import OUCoeffs, SHOCoeffs, ou_apply, ou_coeffs, sho_apply, sho_coeffs
from .schedule import Times, bcast_to, from_vp, noise_scaling, to_vp, vp_to_model_coords

TRACE_WIDTH = 8  # [inner_step, dist, dist_inpaint, dist_ring, dist_drift,
#                  threshold_used, patience_counter, stopped]


class ThinkAux(NamedTuple):
    steps_done: int            # model forwards spent on Langevin steps
    trace: torch.Tensor        # (n_max, TRACE_WIDTH) per-inner-step stop trace


def _mix(a, b, mask):
    """Region mix: a on the unknown region, b on the known region."""
    return a + (b - a) * mask


def _wmse(a, b, w):
    """Weighted MSE in fp32 (reference earlystop.py:52-55, minus the .item())."""
    d = (a - b).float()
    return torch.sum(d * d * w) / (torch.sum(w) + 1e-12)


def _abt_scale(abt_val):
    """4*a*(1-a) clipped to [0,1] (reference earlystop.py:21-29)."""
    a = torch.clamp(abt_val, 0.0, 1.0)
    return torch.clamp(4.0 * a * (1.0 - a), 0.0, 1.0)


def boundary_ring_weight(latent_mask, inpaint_weight):
    """4-neighbour boundary: unknown pixels adjacent to known pixels.

    Defined for 4D (B, C, H, W) masks only; None otherwise, as the
    reference (earlystop.py:32-49)."""
    if latent_mask.ndim != 4:
        return None
    known = latent_mask > 0.5
    nb = torch.zeros_like(known)
    nb[:, :, 1:, :] |= known[:, :, :-1, :]
    nb[:, :, :-1, :] |= known[:, :, 1:, :]
    nb[:, :, :, 1:] |= known[:, :, :, :-1]
    nb[:, :, :, :-1] |= known[:, :, :, 1:]
    ring = (~known) & nb
    return ring.float() * inpaint_weight


class _RegionParams(NamedTuple):
    """Mask-mixed per-element Langevin parameters."""

    a: torch.Tensor
    dt: torch.Tensor
    sqrt_gamma_dt: torch.Tensor
    d: torch.Tensor
    sho_half: SHOCoeffs
    sho_full: SHOCoeffs
    ou_half: OUCoeffs
    ou_full: OUCoeffs


def _branch_scalars(config: LanPaintConfig, abt):
    """Per-branch [B] scalars for the unknown (x) and known (y) regions.

    Parameterization from reference lanpaint.py:255-288:
        dt_branch = step_size * (1 - abt) * sigma_branch
        Gamma     = friction^2 * step_size * sigma_branch / 0.1 / 2 / dt_branch
        A_x = 1 / (1 - abt);  A_y = (1 + lambda) / (1 - abt);  D = sqrt(2)
    with sigma_x = 1 and sigma_y = beta.  Returns (fields_x, fields_y, d,
    dt_x), each field list ordered [a, dt, sqrt_gamma_dt, *sho_half,
    *sho_full, *ou_half, *ou_full].
    """
    abt = abt.float()
    one_m_abt = 1.0 - abt
    step_eff = config.step_size * one_m_abt
    d_noise = torch.sqrt(torch.tensor(2.0, dtype=torch.float32, device=abt.device))

    def branch(sig, a):
        dt = step_eff * sig
        gam_hat = config.friction**2 * config.step_size * sig / 0.1 / 2.0
        # Gamma = Gamma_hat / dt; guard dt = 0 (abt = 1): the loop is skipped then.
        gamma = gam_hat / torch.where(dt > 0, dt, torch.ones_like(dt))
        return [a, dt, torch.sqrt(gamma) * dt,
                *sho_coeffs(gamma, a, d_noise, dt / 2.0),
                *sho_coeffs(gamma, a, d_noise, dt),
                *ou_coeffs(a, d_noise, dt / 2.0),
                *ou_coeffs(a, d_noise, dt)]

    a_x = 1.0 / torch.clamp_min(one_m_abt, 1e-20)
    a_y = (1.0 + config.lamb) / torch.clamp_min(one_m_abt, 1e-20)
    fx = branch(1.0, a_x)
    fy = branch(config.beta, a_y)
    return fx, fy, d_noise, fx[1]


def lanpaint_update(
    denoise: Callable[[torch.Tensor, torch.Tensor], tuple],
    x: torch.Tensor,
    *,
    latent_image: torch.Tensor,
    noise: torch.Tensor,
    latent_mask: torch.Tensor,
    times: Times,
    n_steps: int,
    config: LanPaintConfig,
    kind: ModelKind,
    generator: Optional[torch.Generator] = None,
    noise_feed: Optional[torch.Tensor] = None,
):
    """One outer-step LanPaint update (think loop + final denoise).

    Equivalent of `LanPaint.__call__` -> `LanPaint.LanPaint` (reference
    lanpaint.py:40-123).  `x` is the sampler-native latent, `latent_mask` is
    1 on the KNOWN region, `n_steps` a host int (the outer early stop passes
    0), `times` the per-batch unified times — on the CPU for a sync-free
    loop (see the module docstring).  `denoise(x_model, t_model)` returns
    (x0, x0_big).  Returns (denoised_blend, x_refined, ThinkAux) with the
    blended x0, the Langevin-refined native latent the outer solver
    continues from (the reference's in-place `input_x.copy_`,
    lanpaint.py:122), and diagnostics.
    """
    device = x.device
    fused = config.use_fused_kernels
    on_card = fused and device.type == "cuda"
    if on_card and noise_feed is not None:
        raise ValueError("use_fused_kernels on a CUDA latent: the kernels draw their own "
                         "normals, so noise_feed cannot be replayed; turn the flag off")
    in_dtype = x.dtype
    ndim = x.ndim
    shape = tuple(x.shape)
    b = shape[0]
    xf = x.float()
    latent_f = latent_image.float()
    mask = latent_mask.float()

    # Per-branch scalars on the device of `times`; the host reads dt_pos
    # there, then everything moves to the latent's device in one copy.
    fx, fy, d_noise, dt_x = _branch_scalars(config, times.abt)
    dt_pos = bool(torch.mean(dt_x) > 0.0)
    n_f = len(fx)
    rows = [*fx, *fy, times.ve_sigma.float(), times.abt.float(), times.flow_t.float()]
    if fused:  # the kernels' (B, 24) coefficient tables, x branch then y
        rows += [fx[j] for j in fused_ops.TABLE_FIELDS] + [fy[j] for j in fused_ops.TABLE_FIELDS]
    packed = torch.stack(rows).to(device)
    bc = lambda t: bcast_to(t, ndim)
    a_mix = _mix(bc(packed[0]), bc(packed[n_f]), mask)
    if fused:
        n_t = len(fused_ops.TABLE_FIELDS)
        coef_x, coef_y = (packed[2 * n_f + 3 + k * n_t:2 * n_f + 3 + (k + 1) * n_t].T.contiguous()
                          for k in (0, 1))
        mask2 = torch.broadcast_to(mask, shape).reshape(b, -1)
    else:
        mixed = [_mix(bc(packed[j]), bc(packed[n_f + j]), mask) for j in range(n_f)]
        params = _RegionParams(
            a=a_mix, dt=mixed[1], sqrt_gamma_dt=mixed[2], d=d_noise.to(device),
            sho_half=SHOCoeffs(*mixed[3:10]), sho_full=SHOCoeffs(*mixed[10:17]),
            ou_half=OUCoeffs(*mixed[17:20]), ou_full=OUCoeffs(*mixed[20:23]))
    times = Times(*packed[2 * n_f:2 * n_f + 3])
    abt_b = bc(times.abt)
    lamb = config.lamb

    # Zero noise (e.g. add_noise=disable) is regenerated so the replace step
    # still injects schedule-consistent randomness (reference lanpaint.py:44-45).
    noise_f = noise.float()
    regen = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    noise_f = torch.where(torch.mean(torch.abs(noise_f)) < 1e-8, regen, noise_f)

    # Replace step: re-noise the known region to its schedule-consistent value.
    known_xt = noise_scaling(kind, times.ve_sigma if kind is ModelKind.EPS else times.flow_t,
                             noise_f, latent_f)
    xf = xf * (1.0 - mask) + known_xt * mask
    x_t = to_vp(kind, xf, times, ndim).contiguous()
    flat = lambda t: t.reshape(b, -1)  # the fused kernels' (B, M) view, no copy
    # the kernels' Philox seed, drawn on the card: no host sync in the loop
    seed = (torch.randint(0, 2**31 - 1, (1,), generator=generator, device=device)
            if on_card else None)

    def score_to_c(x_eval, x0, x0_big):
        """Bidirectional score -> drift C (lanpaint.py:125-141, 174-177)."""
        x0 = x0.float()
        x0_big = x0_big.float()
        score_x = -(x_eval - x0)
        score_y = -(1.0 + lamb) * (x_eval - latent_f) + lamb * (x_eval - x0_big)
        x0_eff = x_eval + _mix(score_x, score_y, mask)
        c = (torch.sqrt(abt_b) * x0_eff - x_eval) / torch.clamp_min(1.0 - abt_b, 1e-20) \
            + a_mix * x_eval
        return c, x0_eff

    # ---- semantic early stop set-up (device-side state) ----
    semantic = config.semantic_stop_possible or config.record_trace
    w_inpaint = 1.0 - mask
    w_ring = boundary_ring_weight(mask, w_inpaint) if semantic else None
    zero_f = torch.zeros((), dtype=torch.float32, device=device)
    if semantic:
        threshold_eff = config.inner_threshold * _abt_scale(torch.mean(times.abt))
        stop_enabled = (threshold_eff > 0.0) & (torch.sum(w_inpaint) > 1e-6)
    patience_eff = config.patience_eff
    patience = torch.zeros((), dtype=torch.int32, device=device)
    anchor = torch.zeros_like(x_t)
    anchor_valid = torch.zeros((), dtype=torch.bool, device=device)
    stopped = torch.zeros((), dtype=torch.bool, device=device)

    n_max = max(config.n_steps, 1)
    trace = torch.zeros((n_max, TRACE_WIDTH), dtype=torch.float32, device=device)
    n_run = min(int(n_steps), n_max) if dt_pos else 0
    v = torch.zeros_like(x_t)
    c_old = torch.zeros_like(x_t)
    x0_prev = torch.zeros_like(x_t)

    i = 0
    while True:
        # The only data-dependent exit reads the stop flag (semantic stop on).
        if i >= n_run or (config.semantic_stop_possible and bool(stopped)):
            break
        warm = i > 0
        if not on_card:  # on the card the kernels draw their own normals
            if noise_feed is not None:
                eps = noise_feed[min(i, noise_feed.shape[0] - 1)].to(device=device,
                                                                      dtype=torch.float32)
            else:
                eps = torch.randn((5,) + shape, generator=generator, dtype=torch.float32,
                                  device=device)
            eps_y1, eps_v1, eps_y2, eps_v2, eps_v0 = (eps.reshape(5, b, -1) if fused
                                                      else eps).unbind(0)
        if not fused:
            # Stationary velocity ~ N(0, D^2/2) (reference utils.py:253-254); the
            # cold-start velocity and the fallback where the damped step NaN'd.
            v_stat = eps_v0 * params.d / math.sqrt(2.0)

        # pre-model phase: the warm half step with the old C (the cold step
        # evaluates the model at x_t)
        if fused and warm:
            xh, vh, xh_o = fused_ops.fused_half_step(
                coef_x, coef_y, 1.0, flat(x_t), flat(v), flat(c_old), mask2, seed=seed,
                launch=2 * i, normals=None if on_card else (eps_y1, eps_v1, eps_v0))
            x_eval = xh.view(shape)
        elif warm:
            xh_d, vh_d = sho_apply(params.sho_half, x_t, v, params.a, c_old, eps_y1, eps_v1)
            xh_o = ou_apply(params.ou_half, x_t, c_old, eps_y1)
            bad_h = ~(torch.isfinite(xh_d) & torch.isfinite(vh_d))
            xh = torch.where(bad_h, xh_o, xh_d)
            vh = torch.where(bad_h, v_stat, vh_d)
            x_eval = xh
        else:
            xh = vh = xh_o = None
            x_eval = x_t

        x_model, t_model = vp_to_model_coords(kind, x_eval, times, ndim)
        x0_raw, x0_big = denoise(x_model, t_model)
        c_new, x0_eff = score_to_c(x_eval, x0_raw, x0_big)

        # post-model phase
        if fused:
            normals = None if on_card else (
                (eps_y2, eps_v2, eps_v0) if warm else (eps_y1, eps_v1, eps_v0))
            x_new, v_new = (t.view(shape) for t in fused_ops.fused_finish(
                coef_x, coef_y, 1.0, warm, flat(x_t), xh, vh, xh_o, flat(c_old), flat(c_new),
                mask2, seed=seed, launch=2 * i + 1, normals=normals))
        elif warm:
            v_kick = vh + params.sqrt_gamma_dt * (c_new - c_old)
            xf_d, vf_d = sho_apply(params.sho_half, xh, v_kick, params.a, c_old, eps_y2, eps_v2)
            xk_o = xh_o + (c_new - c_old) * params.dt
            xf_o = ou_apply(params.ou_half, xk_o, c_old, eps_y2)
            bad_f = bad_h | ~(torch.isfinite(xf_d) & torch.isfinite(vf_d))
            x_new = torch.where(bad_f, xf_o, xf_d)
            v_new = torch.where(bad_f, v_stat, vf_d)
        else:
            # cold start: one full step with the freshly evaluated C
            xc_d, vc_d = sho_apply(params.sho_full, x_t, v_stat, params.a, c_new, eps_y1, eps_v1)
            xc_o = ou_apply(params.ou_full, x_t, c_new, eps_y1)
            bad_c = ~(torch.isfinite(xc_d) & torch.isfinite(vc_d))
            x_new = torch.where(bad_c, xc_o, xc_d)
            v_new = torch.where(bad_c, v_stat, vc_d)

        # ---- semantic early stop (earlystop.py:238-313) ----
        if semantic:
            if config.distance_fn is not None:
                ctx = {"step": i, "n_steps": n_steps, "mask": mask,
                       "latent_image": latent_f, "times": times}
                dist = torch.as_tensor(config.distance_fn(x_t, x_new, ctx),
                                       dtype=torch.float32, device=device)
                threshold_used = torch.tensor(config.inner_threshold, dtype=torch.float32,
                                              device=device)
                d_in = d_ring = d_drift = zero_f
                # custom metric: no drift guard
                below = dist <= threshold_used
                patience = torch.where(below, patience + 1, 0).to(torch.int32)
            else:
                if warm:
                    d_in = _wmse(x0_eff, x0_prev, w_inpaint)
                    d_ring = _wmse(x0_eff, x0_prev, w_ring) if w_ring is not None else d_in
                    dist = torch.maximum(d_in, d_ring)
                else:
                    d_ring = (_wmse(x0_eff, x0_prev, w_ring) if w_ring is not None
                              else _wmse(x0_eff, x0_prev, w_inpaint))
                    dist = d_in = _wmse(x_new, x_t, w_inpaint)
                threshold_used = threshold_eff
                below0 = dist <= threshold_used
                # Drift anchor (earlystop.py:295-305): on the first stable
                # step record x0; afterwards fold in drift-from-anchor.
                drift_in = _wmse(x0_eff, anchor, w_inpaint)
                drift_ring = _wmse(x0_eff, anchor, w_ring) if w_ring is not None else drift_in
                d_drift = torch.maximum(drift_in, drift_ring)
                dist = torch.where(below0 & anchor_valid, torch.maximum(dist, d_drift), dist)
                anchor = torch.where(below0 & ~anchor_valid, x0_eff, anchor)
                anchor_valid0 = below0 & (anchor_valid | below0)
                below = dist <= threshold_used
                patience = torch.where(below, patience + 1, 0).to(torch.int32)
                anchor_valid = below & anchor_valid0
            stopped = stop_enabled & (patience >= patience_eff)
            patience = torch.where(stop_enabled, patience, 0).to(torch.int32)
            trace[i] = torch.stack([
                torch.tensor(float(i + 1), device=device), dist.float(), d_in.float(),
                d_ring.float(), d_drift.float(), torch.as_tensor(threshold_used).float(),
                patience.float(), stopped.float()])

        x_t, v, c_old, x0_prev = x_new, v_new, c_new, x0_eff
        i += 1

    # Final iteration: one more model call at x_t, then the known-region blend.
    x_model, t_model = vp_to_model_coords(kind, x_t, times, ndim)
    x0_raw, _ = denoise(x_model, t_model)
    out = x0_raw.float() * (1.0 - mask) + latent_f * mask

    x_out = from_vp(kind, x_t, times, ndim)
    return out.to(in_dtype), x_out.to(in_dtype), ThinkAux(steps_done=i, trace=trace)
