"""The comparison that decides `correct` for a video inpainting job
(`api.inpaint_video`): `compare.judge`'s step numbers on (B, C, F, h, w)
latents with the video mask, the VAE's encode and decode against the
chunked reference VAE, and the blend's exactness beyond its overlap.

* `step_err`, `known_err`: as `compare.judge` defines them, the reference
  following the job from the latent the program encoded;
* `encode_err`: |z_prog - z_ref| / |z_ref| (L2), the program's latent
  against the reference's encode of the same clip;
* `decode_err`: |x_prog - x_ref| / |x_ref|, the program's decoded clip
  against the reference's decode of the program's final latent;
* `blend_err`: the largest |out - video| over the pixels of every frame
  farther than the blend overlap from the mask's rectangle, which the
  blend leaves exactly as they were (limit 0).
"""

from __future__ import annotations

import torch

from ..reference import nn as rnn
from ..reference import video as ref
from .compare import _finite, l2


def judge_steps(model_x0, job: dict, record: list, steps: list, step_err_from: int = 0) -> dict:
    """`compare.judge` on a video job: the numbers `step_err` and
    `known_err`, and each checked step's readings."""
    states = {i: record[i - 1][1] for i in steps if i > 0}
    with torch.no_grad(), rnn.precision("fp32"):
        out = ref.follow(model_x0, job, states, steps)
    known = ref.latent_mask(job["mask"].to(job["latent"].device), tuple(job["latent"].shape))
    numbers = {"step_err": 0.0, "known_err": 0.0}
    per_step = {}
    for i in steps:
        den_r, x_r, x_in = out[i]
        den_p, x_p = (t.float() for t in record[i])
        step = _finite(l2(x_p - x_r) / max(l2(x_r - x_in), 1e-30))
        if i >= step_err_from:
            numbers["step_err"] = max(numbers["step_err"], step)
        kn = _finite(float(((den_p - job["latent"].float()).abs() * known).max()))
        numbers["known_err"] = max(numbers["known_err"], kn)
        per_step[i] = {"step_err": step,
                       "x0_gap": _finite(l2(den_p - den_r) / max(l2(den_r), 1e-30))}
    return {"numbers": numbers, "per_step": per_step}


def relative(got, want) -> float:
    """|got - want| / |want|, L2 over every element."""
    return _finite(l2(got.float() - want.float()) / max(l2(want.float()), 1e-30))


def blend_err(out, video, rect: tuple, overlap: int) -> float:
    """The largest |out - video| outside the rectangle (top, left, height,
    width) grown by `overlap` pixels on each side, over every frame."""
    top, left, hh, ww = rect
    far = torch.ones(video.shape[-2:], dtype=torch.bool, device=video.device)
    rows = slice(max(0, top - overlap), top + hh + overlap)
    far[rows, max(0, left - overlap):left + ww + overlap] = False
    if not far.any():  # no pixel lies beyond the blend
        return 0.0
    return _finite(float((out.float() - video.float()).abs()[..., far].max()))
