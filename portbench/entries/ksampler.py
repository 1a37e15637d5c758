"""Entry `ksampler`: `lanpaint_tpu_torch.api.ksampler`, one job at a time,
one client in a closed loop, every job's inputs drawn from the seed.

A job repaints a rectangle of one image: its latent, a rectangular pixel
mask of varying place and size, the conditioning at the encoders' output
shapes (and the negative's, where cfg is not 1) and the noise seed.  The
callback records each outer step's x0 and next latent; of the jobs that
finish, one drawn from the seed (a draw of one kept as the jobs come) is
held for the comparison once the window has closed."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.harness import compare, weights, window
from portbench.harness.seeds import derive
from portbench.reference import lanpaint as ref


def _rect(seed: int, i: int, size) -> tuple:
    """A rectangle of 1/4 to 3/4 of each side, on the 8-pixel grid of the
    latent, at a place drawn from the seed; (top, left, height, width)."""
    rng = np.random.default_rng(derive(seed, "mask", i))
    out = []
    for side in size:
        n = int(rng.integers(-(-side // 32), 3 * side // 32 + 1)) * 8
        out.append((int(rng.integers(0, (side - n) // 8 + 1)) * 8, n))
    (top, hh), (left, ww) = out
    return top, left, hh, ww


def inputs(ctx, i: int) -> dict:
    """Job i's inputs, on the device (i = -1: the warm-up job)."""
    s, t = ctx.sizes, ctx.traffic
    gen = torch.Generator(device=ctx.device).manual_seed(derive(ctx.seed, "job", i))
    latent = torch.randn((t["batch"], *s["latent_shape"]), generator=gen, device=ctx.device)
    top, left, hh, ww = _rect(ctx.seed, i, s["image_size"])
    mask = torch.zeros(tuple(s["image_size"]), device=ctx.device)
    mask[top:top + hh, left:left + ww] = 1.0
    batch = lambda c: {k: v.expand(t["batch"], *v.shape[1:]) for k, v in c.items()}
    cond = batch(ctx.config.conditioning(s, gen, ctx.device))
    uncond = (None if math.isclose(t["cfg"], 1.0)
              else batch(ctx.config.conditioning(s, gen, ctx.device)))
    return {"latent": latent, "mask": mask, "cond": cond, "uncond": uncond,
            "seed": derive(ctx.seed, "noise", i) & 0xFFFFFFFF}


def setup(ctx) -> None:
    """Weights from the seed, the program's model, one short warm-up job."""
    _, ref_module = ctx.config.build_reference(ctx.sizes)
    ctx.shapes = {k: tuple(v.shape) for k, v in ref_module.state_dict().items()}
    state = weights.draw(ctx.shapes, ctx.seed, ctx.device)
    ctx.denoiser, ctx.module = ctx.config.build_program(ctx.sizes, state, ctx.device)
    del state
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
    samples = api.ksampler(
        ctx.denoiser, seed=job["seed"], steps=t["steps"] if steps is None else steps,
        cfg=t["cfg"], sampler_name=t["sampler"], scheduler=t["scheduler"],
        positive=job["cond"], negative=job["uncond"], latent=job["latent"], mask=job["mask"],
        num_steps=t["think"], callback=lambda step, den, x: record.append((den, x)))
    ok = bool(torch.isfinite(samples).all())
    if i >= 0 and record:
        ctx.finished += 1
        if ctx.draw.integers(ctx.finished) == 0:
            ctx.kept = (i, record)
    return ok


def release(ctx) -> None:
    """Free the program's weights before the reference runs."""
    ctx.module.to("meta")
    ctx.denoiser = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(ctx) -> dict:
    """The comparison of the kept job with the plain reference."""
    s, t = ctx.sizes, ctx.traffic
    if ctx.kept is None:  # every job raised: nothing to compare, nothing correct
        inf = float("inf")
        return {"numbers": {"step_err": inf, "known_err": inf},
                "per_step": {}, "job": None, "steps": []}
    j, record = ctx.kept
    release(ctx)
    ref_x0, ref_module = ctx.config.build_reference(s)
    ref_module.load_state_dict(weights.draw(ctx.shapes, ctx.seed, ctx.device), assign=True)
    ref_module.requires_grad_(False)
    job = inputs(ctx, j)
    table = ctx.config.sigma_table(s)
    with torch.no_grad():
        job.update(kind=ctx.config.KIND, sigmas=ref.ladder(t["scheduler"], t["steps"], table),
                   sigma_max=float(table[-1]), n_steps=t["think"], cfg=float(t["cfg"]),
                   cfg_big=ctx.config.cfg_big(float(t["cfg"])))
    steps = compare.checked_steps(derive(ctx.seed, "check", j), len(job["sigmas"]) - 1,
                                  t["check_middle_steps"])
    result = compare.judge(ref_x0, job, record, steps, t["step_err_from"])
    result["job"], result["steps"] = j, steps
    return result
