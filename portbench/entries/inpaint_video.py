"""Entry `inpaint_video`: `lanpaint_tpu_torch.api.inpaint_video`, one job
at a time, one client in a closed loop, every job's inputs drawn from the
seed.

A job repaints a rectangle of a clip: the clip, uniform in [-1, 1], a
rectangular pixel mask of varying place and size on the VAE's 16-pixel
grid, the same on every frame, the positive and negative conditioning at
the text encoder's output shape and the noise seed.  The pipeline encodes
the clip, samples (the callback records each outer step's x0 and next
latent), decodes and blends each frame.  Of the jobs that finish, one drawn
from the seed (a draw of one kept as the jobs come) is held, with the
latent the VAE encoded, the latent it decoded, the decoded clip and the
output, for the comparison once the window has closed
(`harness/video.py`)."""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness import compare, video, weights, window
from portbench.harness.seeds import derive
from portbench.reference import lanpaint as ref
from portbench.reference import nn as rnn

GRID = 16  # the Wan2.2 VAE's spatial stride


def _rect(seed: int, i: int, size) -> tuple:
    """A rectangle of 1/4 to 3/4 of each side, on the VAE's 16-pixel grid,
    at a place drawn from the seed; (top, left, height, width)."""
    rng = np.random.default_rng(derive(seed, "mask", i))
    out = []
    for side in size:
        n = int(rng.integers(-(-side // (4 * GRID)), 3 * side // (4 * GRID) + 1)) * GRID
        out.append((int(rng.integers(0, (side - n) // GRID + 1)) * GRID, n))
    (top, hh), (left, ww) = out
    return top, left, hh, ww


def inputs(ctx, i: int) -> dict:
    """Job i's inputs, on the device (i = -1: the warm-up job)."""
    s = ctx.sizes
    frames, size = s["num_frames"], (s["height"], s["width"])
    gen = torch.Generator(device=ctx.device).manual_seed(derive(ctx.seed, "job", i))
    clip = torch.rand((ctx.traffic["batch"], 3, frames, *size), generator=gen,
                      device=ctx.device).mul_(2.0).sub_(1.0)
    rect = _rect(ctx.seed, i, size)
    top, left, hh, ww = rect
    mask = torch.zeros((frames, *size), device=ctx.device)
    mask[:, top:top + hh, left:left + ww] = 1.0
    cond = ctx.config.conditioning(s, gen, ctx.device)
    uncond = ctx.config.conditioning(s, gen, ctx.device)
    return {"video": clip, "mask": mask, "rect": rect, "cond": cond, "uncond": uncond,
            "seed": derive(ctx.seed, "noise", i) & 0xFFFFFFFF}


class Recorded:
    """The VAE as `inpaint_video` calls it, keeping what it encoded and
    decoded: "latent" (encode's output), "final" (decode's input) and
    "decoded" (decode's output)."""

    def __init__(self, vae):
        self.vae, self.seen = vae, {}

    def encode(self, pixels):
        self.seen["latent"] = z = self.vae.encode(pixels)
        return z

    def decode(self, latent):
        self.seen["final"] = latent
        self.seen["decoded"] = x = self.vae.decode(latent)
        return x


def _shapes(module) -> dict:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def setup(ctx) -> None:
    """Weights from the seed, the program's DiT and VAE, one short warm-up
    job."""
    c, s = ctx.config, ctx.sizes
    ctx.shapes = _shapes(c.build_reference(s)[1])
    state = weights.draw(ctx.shapes, ctx.seed, ctx.device)
    ctx.denoiser, ctx.module = c.build_program(s, state, ctx.device)
    del state
    ctx.vae_shapes = _shapes(c.build_reference_vae(s))
    ctx.vae = c.build_vae(s, c.draw_vae(ctx.vae_shapes, ctx.seed, ctx.device), ctx.device)
    run_job(ctx, -1, steps=ctx.traffic["warmup_steps"])
    ctx.kept, ctx.finished = None, 0
    ctx.draw = np.random.default_rng(derive(ctx.seed, "check"))


def run_window(ctx, seconds: float, sync) -> window.Window:
    return window.closed_loop(lambda i: run_job(ctx, i), seconds, sync)


def run_job(ctx, i: int, steps: int = None) -> bool:
    """Run job i to its end on the device; True if its output is finite.
    Job i >= 0 that finishes replaces the kept record with chance one in
    the number finished so far, so the one kept is a uniform draw."""
    from lanpaint_tpu_torch import api

    t = ctx.traffic
    job = inputs(ctx, i)
    record = []
    vae = Recorded(ctx.vae)
    out = api.inpaint_video(
        ctx.denoiser, vae, video=job["video"], mask=job["mask"], positive=job["cond"],
        negative=job["uncond"], seed=job["seed"], steps=t["steps"] if steps is None else steps,
        cfg=t["cfg"], sampler_name=t["sampler"], scheduler=t["scheduler"],
        num_steps=t["think"], blend_overlap=t["blend_overlap"],
        callback=lambda step, den, x: record.append((den, x)))
    ok = bool(torch.isfinite(out).all())
    if i >= 0 and record:
        ctx.finished += 1
        if ctx.draw.integers(ctx.finished) == 0:
            ctx.kept = (i, record, vae.seen, out)
    return ok


def release(ctx) -> None:
    """Free the program's weights before the reference runs."""
    ctx.module.to("meta")
    ctx.vae.to("meta")
    ctx.denoiser = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(ctx) -> dict:
    """The comparison of the kept job with the plain reference: the VAE's
    encode and decode, the blend, then the sampler's checked steps."""
    c, s, t = ctx.config, ctx.sizes, ctx.traffic
    if ctx.kept is None:  # every job raised: nothing to compare, nothing correct
        inf = float("inf")
        return {"numbers": dict.fromkeys(
                    ("step_err", "known_err", "encode_err", "decode_err", "blend_err"), inf),
                "per_step": {}, "job": None, "steps": []}
    j, record, seen, out = ctx.kept
    release(ctx)
    job = inputs(ctx, j)
    numbers = {"blend_err": video.blend_err(out, job["video"], job["rect"], t["blend_overlap"])}
    del out
    ref_vae = c.build_reference_vae(s)
    ref_vae.load_state_dict(c.draw_vae(ctx.vae_shapes, ctx.seed, ctx.device), assign=True)
    ref_vae.requires_grad_(False)
    with torch.no_grad(), rnn.precision("fp32"):
        numbers["encode_err"] = video.relative(seen["latent"], ref_vae.encode(job["video"]))
        numbers["decode_err"] = video.relative(seen["decoded"], ref_vae.decode(seen["final"]))
    del ref_vae
    ref_x0, ref_module = c.build_reference(s)
    ref_module.load_state_dict(weights.draw(ctx.shapes, ctx.seed, ctx.device), assign=True)
    ref_module.requires_grad_(False)
    table = c.sigma_table(s)
    with torch.no_grad():
        job.update(latent=seen["latent"], kind=c.KIND,
                   sigmas=ref.ladder(t["scheduler"], t["steps"], table),
                   sigma_max=float(table[-1]), n_steps=t["think"], cfg=float(t["cfg"]),
                   cfg_big=c.cfg_big(float(t["cfg"])))
    steps = compare.checked_steps(derive(ctx.seed, "check", j), len(job["sigmas"]) - 1,
                                  t["check_middle_steps"])
    result = video.judge_steps(ref_x0, job, record, steps, t["step_err_from"])
    result["numbers"].update(numbers)
    result["job"], result["steps"] = j, steps
    return result
