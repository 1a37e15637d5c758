"""Sigma schedules (noise schedules) for the outer sampling loop.

Host-side (numpy-light, tiny arrays) generation of the per-step sigma ladder,
covering the scheduler families the reference exposes through ComfyUI's
`KSampler.SCHEDULERS` (reference src/LanPaint/nodes.py:308).  Sigmas follow
the k-diffusion convention: descending, with a trailing 0.0.

Two backbone sigma spaces exist (see schedule.py):
* EPS models: a 1000-entry discrete sigma table derived from the beta
  schedule; model-based schedulers (normal/simple/ddim/beta/...) resample it.
* FLOW models: sigma == flow-t in [0, 1] with an optional resolution shift
  (sigma = shift*t / (1 + (shift-1)*t)).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

# ---------------------------------------------------------------------------
# Model sigma tables


def betas_to_sigmas(betas: np.ndarray) -> np.ndarray:
    """VE sigmas from a discrete VP beta schedule: sigma = sqrt((1-abar)/abar)."""
    alphas = 1.0 - betas
    abar = np.cumprod(alphas)
    return np.sqrt((1.0 - abar) / abar)


def make_beta_schedule(
    schedule: str = "scaled_linear",
    n: int = 1000,
    linear_start: float = 0.00085,
    linear_end: float = 0.012,
) -> np.ndarray:
    if schedule == "scaled_linear":  # SD1.5/SDXL
        return np.linspace(linear_start**0.5, linear_end**0.5, n, dtype=np.float64) ** 2
    if schedule == "linear":
        return np.linspace(linear_start, linear_end, n, dtype=np.float64)
    if schedule == "cosine":
        steps = np.arange(n + 1, dtype=np.float64) / n
        s = 0.008
        f = np.cos((steps + s) / (1 + s) * math.pi / 2) ** 2
        betas = np.clip(1 - f[1:] / f[:-1], 0, 0.999)
        return betas
    raise ValueError(f"unknown beta schedule {schedule!r}")


class EpsSigmaTable:
    """Discrete sigma table of an EPS backbone (ComfyUI ModelSamplingDiscrete
    analogue).  sigmas[i] is ascending in timestep i (0..999)."""

    def __init__(self, betas: Optional[np.ndarray] = None):
        if betas is None:
            betas = make_beta_schedule()
        self.sigmas = betas_to_sigmas(betas)

    @property
    def sigma_min(self) -> float:
        return float(self.sigmas[0])

    @property
    def sigma_max(self) -> float:
        return float(self.sigmas[-1])

    def timestep(self, sigma: np.ndarray) -> np.ndarray:
        """Fractional timestep via log-sigma interpolation."""
        log_s = np.log(np.maximum(sigma, 1e-10))
        log_t = np.log(self.sigmas)
        return np.interp(log_s, log_t, np.arange(len(self.sigmas), dtype=np.float64))

    def sigma(self, timestep: np.ndarray) -> np.ndarray:
        t = np.clip(timestep, 0, len(self.sigmas) - 1)
        lo = np.floor(t).astype(int)
        hi = np.ceil(t).astype(int)
        w = t - lo
        log_s = (1 - w) * np.log(self.sigmas[lo]) + w * np.log(self.sigmas[hi])
        return np.exp(log_s)


class FlowSigmaTable:
    """Flow-matching sigma space with resolution shift (Flux/SD3 style):
    sigma(t) = shift * t / (1 + (shift - 1) * t),  t in (0, 1]."""

    def __init__(self, shift: float = 1.0, n: int = 1000):
        t = np.arange(1, n + 1, dtype=np.float64) / n
        self.sigmas = shift * t / (1 + (shift - 1) * t)
        self.shift = shift

    @property
    def sigma_min(self) -> float:
        return float(self.sigmas[0])

    @property
    def sigma_max(self) -> float:
        return float(self.sigmas[-1])

    def timestep(self, sigma):
        return np.interp(sigma, self.sigmas, np.arange(len(self.sigmas), dtype=np.float64))

    def sigma(self, timestep):
        t = np.clip(timestep, 0, len(self.sigmas) - 1)
        lo = np.floor(t).astype(int)
        hi = np.ceil(t).astype(int)
        w = t - lo
        return (1 - w) * self.sigmas[lo] + w * self.sigmas[hi]


# ---------------------------------------------------------------------------
# Schedulers (n steps -> n+1 descending sigmas ending in 0)


def karras(n: int, sigma_min: float, sigma_max: float, rho: float = 7.0) -> np.ndarray:
    ramp = np.linspace(0, 1, n, dtype=np.float64)
    min_r = sigma_min ** (1 / rho)
    max_r = sigma_max ** (1 / rho)
    sig = (max_r + ramp * (min_r - max_r)) ** rho
    return np.append(sig, 0.0)


def exponential(n: int, sigma_min: float, sigma_max: float) -> np.ndarray:
    sig = np.exp(np.linspace(math.log(sigma_max), math.log(sigma_min), n))
    return np.append(sig, 0.0)


def flux_time_shift(mu: float, sigma: float, t: np.ndarray) -> np.ndarray:
    """The public Flux time-shift map exp(mu) / (exp(mu) + (1/t - 1)^sigma).

    With sigma=1 and mu=log(s) this is exactly the static flow shift
    s*t / (1 + (s-1)*t) (FlowSigmaTable) — tested equivalent."""
    t = np.asarray(t, np.float64)
    return np.exp(mu) / (np.exp(mu) + (1.0 / np.maximum(t, 1e-12) - 1.0) ** sigma)


def resolution_shift_sigmas(steps: int, width: int, height: int,
                            base_shift: float = 0.5,
                            max_shift: float = 1.15) -> np.ndarray:
    """Resolution-dependent flow schedule (the public Flux sampling rule:
    mu lerps base_shift -> max_shift over image_seq_len 256..4096, applied
    as flux_time_shift over linspace(1, 0)).

    This is the scheduler surface behind the reference workflows'
    resolution-aware nodes: `Flux2Scheduler [steps, W, H]`
    (Flux.2.Dev_Inpaint.json / Flux2_Klein_inpainting.json) and
    `Ideogram4Scheduler [steps, W, H, base, max]` — whose trailing widgets
    (0.5, 1.75) are exactly (base_shift, max_shift)
    (Ideogram4_LanPaint_Inpaint.json).  image_seq_len = (W/16)*(H/16)
    packed-latent tokens.  Returns steps+1 descending sigmas ending in 0."""
    seq_len = (width // 16) * (height // 16)
    m = (max_shift - base_shift) / (4096 - 256)
    b = base_shift - m * 256
    mu = m * seq_len + b
    t = np.linspace(1.0, 0.0, steps + 1, dtype=np.float64)
    out = np.where(t > 0, flux_time_shift(mu, 1.0, t), 0.0)
    return out.astype(np.float32)


def normal_scheduler(table, n: int, sgm: bool = False) -> np.ndarray:
    """Uniform in timestep-percent through the model table (ComfyUI
    'normal' / 'sgm_uniform')."""
    start_t = table.timestep(np.asarray(table.sigma_max))
    end_t = table.timestep(np.asarray(table.sigma_min))
    if sgm:
        ts = np.linspace(start_t, end_t, n + 1)[:-1]
    else:
        ts = np.linspace(start_t, end_t, n)
    sig = table.sigma(ts)
    return np.append(sig, 0.0)


def simple_scheduler(table, n: int) -> np.ndarray:
    """Uniform stride over the raw sigma table (ComfyUI 'simple')."""
    ss = len(table.sigmas) / n
    sig = [float(table.sigmas[-(1 + int(i * ss))]) for i in range(n)]
    return np.append(np.asarray(sig), 0.0)


def ddim_uniform(table, n: int) -> np.ndarray:
    ss = max(len(table.sigmas) // n, 1)
    out = []
    x = 1
    while x < len(table.sigmas):
        out.append(float(table.sigmas[x]))
        x += ss
    out = list(reversed(out))
    return np.append(np.asarray(out), 0.0)


def beta_scheduler(table, n: int, alpha: float = 0.6, beta: float = 0.6) -> np.ndarray:
    """Beta-distribution-quantile timestep spacing."""
    import scipy.stats

    total = len(table.sigmas)
    ts = 1.0 - np.linspace(0, 1, n, endpoint=False)
    ts = np.rint(scipy.stats.beta.ppf(ts, alpha, beta) * (total - 1))
    sig = [float(table.sigmas[int(t)]) for t in ts]
    return np.append(np.asarray(sig), 0.0)


def linear_quadratic(n: int, sigma_max: float, threshold_noise: float = 0.025,
                     linear_steps: Optional[int] = None) -> np.ndarray:
    """Mochi-style linear-then-quadratic schedule (flow sigma space).

    Denoised fraction x(i) rises linearly to `threshold_noise` over the first
    `linear_steps`, then continues quadratically (C1-continuous) to reach 1
    at step n; sigmas = (1 - x) * sigma_max, descending to 0.
    """
    if n == 1:
        return np.array([float(sigma_max), 0.0])
    L = n // 2 if linear_steps is None else min(linear_steps, n - 1)
    th = threshold_noise
    lin = [i * th / L for i in range(L)]
    # quadratic q(i) = a i^2 + b i + c with q(L) = th, q'(L) = th/L, q(n) = 1
    d = n - L
    a = (1.0 - th - (th / L) * d) / (d * d)
    b = th / L - 2.0 * a * L
    c = th - a * L * L - b * L
    quad = [a * i * i + b * i + c for i in range(L, n)]
    x = np.array(lin + quad + [1.0])
    sig = (1.0 - x) * sigma_max
    sig[-1] = 0.0
    return sig


def kl_optimal(n: int, sigma_min: float, sigma_max: float) -> np.ndarray:
    """KL-optimal schedule (arXiv 2404.14507 eq. 33, as adopted by ComfyUI)."""
    adj = np.arange(n + 1, dtype=np.float64) / n
    sig = np.tan(
        adj * np.arctan(sigma_min) + (1.0 - adj) * np.arctan(sigma_max)
    )
    sig[-1] = 0.0
    return sig


SCHEDULERS = {
    "karras": lambda table, n: karras(n, table.sigma_min, table.sigma_max),
    "exponential": lambda table, n: exponential(n, table.sigma_min, table.sigma_max),
    "normal": lambda table, n: normal_scheduler(table, n),
    "sgm_uniform": lambda table, n: normal_scheduler(table, n, sgm=True),
    "simple": lambda table, n: simple_scheduler(table, n),
    "ddim_uniform": lambda table, n: ddim_uniform(table, n),
    "beta": lambda table, n: beta_scheduler(table, n),
    "linear_quadratic": lambda table, n: linear_quadratic(n, table.sigma_max),
    "kl_optimal": lambda table, n: kl_optimal(n, table.sigma_min, table.sigma_max),
}


def calculate_sigmas(table, scheduler: str, steps: int) -> np.ndarray:
    try:
        fn = SCHEDULERS[scheduler]
    except KeyError:
        raise ValueError(
            f"unknown scheduler {scheduler!r}; available: {sorted(SCHEDULERS)}"
        ) from None
    return fn(table, steps).astype(np.float32)


def apply_denoise(table, scheduler: str, steps: int, denoise: float) -> np.ndarray:
    """Partial denoise: generate a longer ladder and keep the tail
    (ComfyUI KSampler denoise semantics)."""
    if denoise >= 0.9999:
        return calculate_sigmas(table, scheduler, steps)
    if denoise <= 0.0:
        return np.asarray([], dtype=np.float32)
    new_steps = int(steps / denoise)
    sig = calculate_sigmas(table, scheduler, new_steps)
    return sig[-(steps + 1):]
