"""The plain LanPaint job of `lanpaint.py` on a video latent: the pixel
mask of every frame on the (F, h, w) latent grid, and a job followed outer
step by outer step on (B, C, F, h, w) latents (`lanpaint.follow`, whose
mask is an image's).  The think loop, CFG, the blend and the euler step
are `lanpaint.py`'s, which take latents of any rank."""

from __future__ import annotations

import math

import numpy as np
import torch

from .lanpaint import OUTER_EARLY_STOP, cfg_denoiser, noise_scaling, think_step, unify


def latent_mask(mask: torch.Tensor, shape) -> torch.Tensor:
    """A (T, H, W) pixel mask, or (H, W) for every frame, 1 = repaint, on
    the latent grid (F, h, w) by nearest-exact (source index
    floor((i + 0.5) in / out)) on each axis, as (B, C, F, h, w) float: 1 on
    the KNOWN region."""
    m = mask.float()
    m = (m if m.ndim == 3 else m[None])[None, None]
    for axis, target in ((2, shape[2]), (3, shape[3]), (4, shape[4])):
        i = torch.arange(target, dtype=torch.float32, device=m.device)
        src = torch.clamp(torch.floor((i + 0.5) * (m.shape[axis] / target)).long(), 0,
                          m.shape[axis] - 1)
        m = torch.index_select(m, axis, src)
    m = m.expand(shape[0], shape[1], -1, -1, -1)
    return 1.0 - (m > 0.5).float()


def follow(model_x0, job: dict, states: dict, check: list) -> dict:
    """`lanpaint.follow` for a video job: the reference's (denoised, next
    latent, the step's input latent) of each outer step in `check`, step 0
    from the reference's own initial latent, step i > 0 from `states[i]`;
    every draw of every outer step replayed in the sampler's order."""
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
