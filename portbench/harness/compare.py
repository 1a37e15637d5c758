"""The comparison that decides `correct` for an inpainting job: the plain
reference follows the job's outer steps and the program's outputs are
judged against it.

For each checked outer step i the reference computes the blended x0 and
the next latent from the state the step started from (step 0: the
reference's own initial latent, drawn from the job's seed; later steps:
the latent the program handed on).  Two numbers:

* `step_err`: the largest, over the checked steps from `step_err_from` on,
  of |x_prog - x_ref| / |x_ref - x_in|, the L2 gap of the program's next
  latent from the reference's, over the reference's own change of the
  latent in that step;
* `known_err`: the largest |x0_prog - latent| on the known region of any
  checked step, which the blend makes exact (limit 0).
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import lanpaint as ref
from ..reference import nn as rnn
from .seeds import derive


def checked_steps(seed: int, total: int, middle: int) -> list:
    """Step 0, the last step and `middle` others between them drawn from
    the seed."""
    rng = np.random.default_rng(derive(seed, "steps"))
    inner = list(range(1, total - 1))
    picks = rng.choice(inner, size=min(middle, len(inner)), replace=False) if inner else []
    return sorted({0, total - 1, *(int(p) for p in picks)})


def l2(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _finite(v: float) -> float:
    return v if np.isfinite(v) else float("inf")


def judge(model_x0, job: dict, record: list, steps: list, step_err_from: int = 0) -> dict:
    """Follow `steps` of a job whose program outputs are `record` (the
    callback's (x0, next latent) of every outer step) with the float32
    reference; returns the numbers and each step's readings."""
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
