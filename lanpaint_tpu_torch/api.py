"""User-facing sampling API, inpaint path.

PyTorch counterpart of `lanpaint_tpu/api.py` for the main path:
`LanPaintSampler.__call__` with a mask, and `ksampler` (LanPaint_KSampler,
reference nodes.py:298-349).  The JAX package compiles the whole run into
one XLA program; here it is an eager loop on `latent`'s device: prep
(initial noise, noise scaling, mask to the latent grid), the run-constant
conditioning `precompute` once per call, the outer solver loop with the
per-step think loop and CFG double pass, and the terminal inverse noise
scaling.

Not ported yet (they raise): the mask-less plain path, `chunk_steps`,
callbacks and `decoupled_noise`; `ksampler_advanced` and `sample_custom*`
are absent.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import torch

from . import samplers
from .config import LanPaintConfig
from .engine import lanpaint_update
from .guidance import make_cfg_double_denoiser, resolve_cfg_big
from .masks import prepare_mask
from .models.base import Denoiser
from .schedule import inverse_noise_scaling, noise_scaling, unify_times
from .sigmas import apply_denoise


def _max_denoise(sigmas, sigma_table) -> bool:
    if sigma_table is None:
        return True
    s0 = float(sigmas[0])
    mx = float(sigma_table.sigma_max)
    return math.isclose(s0, mx, rel_tol=1e-5) or s0 > mx


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return torch.as_tensor(tree, device=device)


class LanPaintSampler:
    """A LanPaint sampling run for one (model, config, solver).

    Hyperparameters are constructor arguments; latents, masks,
    conditioning and seeds are call arguments.  The run happens on the
    device of `latent`; conditioning is moved there."""

    def __init__(
        self,
        model: Denoiser,
        *,
        config: LanPaintConfig = LanPaintConfig(),
        sampler_name: str = "euler",
        cfg: float = 5.0,
        cfg_big: Optional[float] = None,
        prompt_mode: str = "Image First",
        disable_cfg1_optimization: bool = False,
        pre_cfg_fns: Optional[list] = None,
        sequential_cfg: bool = False,
    ):
        samplers.get_solver(sampler_name)  # unknown / unported names raise here
        self.model = model
        self.config = config
        self.sampler_name = sampler_name
        self.cfg = float(cfg)
        if cfg_big is None:
            cfg_big = resolve_cfg_big(prompt_mode, cfg, model.is_flux)
        self.cfg_big = float(cfg_big)
        self.disable_cfg1_optimization = disable_cfg1_optimization
        self.pre_cfg_fns = pre_cfg_fns
        # two B-sized model calls instead of one 2B-sized (same math)
        self.sequential_cfg = sequential_cfg

    def __call__(
        self,
        *,
        latent,
        sigmas,
        cond: Any,
        uncond: Any = None,
        mask=None,
        seed: int = 0,
        noise=None,
        add_noise: bool = True,
        video: bool = False,
        noise_feed=None,
    ):
        """Run sampling.  Returns (samples, denoised_history).

        `noise` overrides the seed-derived initial noise.  `noise_feed`
        (parity/replay mode): (total_steps, n_max, 5, *latent.shape)
        standard-normal draws the think loop consumes instead of the
        generator, row per outer step (engine.lanpaint_update contract).

        RNG order: one `torch.Generator` on the latent's device, seeded with
        `seed`, draws the initial noise (unless `noise` is given or
        add_noise is off), then serves every think loop in outer-step order
        (engine.py documents its draws)."""
        if mask is None:
            raise NotImplementedError("the mask-less (plain) sampling path is not ported yet")
        latent = torch.as_tensor(latent)
        device = latent.device
        sig_host = np.asarray(sigmas, dtype=np.float32)
        kind = self.model.kind
        total = int(sig_host.shape[0]) - 1
        gen = torch.Generator(device=device).manual_seed(int(seed) & 0xFFFFFFFF)

        if noise is not None:
            noise = torch.as_tensor(noise, device=device, dtype=torch.float32)
        elif add_noise:
            noise = torch.randn(latent.shape, generator=gen, dtype=torch.float32, device=device)
        else:
            noise = torch.zeros(latent.shape, dtype=torch.float32, device=device)
        b = latent.shape[0]
        x_init = noise_scaling(
            kind, torch.full((b,), float(sig_host[0]), device=device), noise, latent,
            max_denoise=_max_denoise(sig_host, self.model.sigma_table))
        if total <= 0:
            return (inverse_noise_scaling(kind, torch.as_tensor(sig_host[-1:], device=device),
                                          x_init),
                    x_init.new_zeros((0,) + tuple(x_init.shape)))
        denoise_mask = prepare_mask(torch.as_tensor(mask, device=device), latent.shape, video)
        latent_mask = 1.0 - (denoise_mask > 0.5).float()

        cond = _to_device(cond, device)
        uncond = None if uncond is None else _to_device(uncond, device)
        if self.model.precompute is not None:
            cond = self.model.precompute(cond)
            if uncond is not None:
                uncond = self.model.precompute(uncond)
        denoise = make_cfg_double_denoiser(
            self.model.apply, cond, uncond, self.cfg, self.cfg_big,
            self.disable_cfg1_optimization, self.pre_cfg_fns,
            sequential=self.sequential_cfg)
        if noise_feed is not None:
            noise_feed = torch.as_tensor(noise_feed)
        cfg_ = self.config

        def wrapped(x, sigma, step):
            # Unified times on the CPU from the host sigma: the engine decides
            # its loop length there without a device sync.
            times = unify_times(torch.full((b,), float(sigma), dtype=torch.float32), kind)
            # Outer early stop: zero think steps in the tail (nodes.py:177-183).
            n = 0 if total - step <= cfg_.outer_early_stop else cfg_.n_steps
            out, x_new, _ = lanpaint_update(
                denoise, x, latent_image=latent, noise=noise, latent_mask=latent_mask,
                times=times, n_steps=n, config=cfg_, kind=kind, generator=gen,
                noise_feed=None if noise_feed is None else noise_feed[step])
            return out, x_new

        x, den_all = samplers.sample(wrapped, x_init, sig_host, sampler=self.sampler_name,
                                     generator=gen)
        samples = inverse_noise_scaling(kind, torch.as_tensor(sig_host[-1:], device=device), x)
        return samples, den_all


def ksampler(
    model: Denoiser,
    *,
    seed: int = 0,
    steps: int = 30,
    cfg: float = 5.0,
    sampler_name: str = "euler",
    scheduler: str = "karras",
    positive: Any,
    negative: Any = None,
    latent,
    mask=None,
    denoise: float = 1.0,
    num_steps: int = 5,
    prompt_mode: str = "Image First",
    video: bool = False,
    sequential_cfg: bool = False,
    noise=None,
):
    """LanPaint_KSampler equivalent with the reference defaults
    (StepSize=0.2, Lambda=16, Beta=1, Friction=15, EarlyStop=1; reference
    nodes.py:329-336).  Returns the samples."""
    if model.sigma_table is None:
        raise ValueError("model has no sigma_table; pass explicit sigmas")
    sam = LanPaintSampler(model, config=LanPaintConfig(n_steps=num_steps),
                          sampler_name=sampler_name, cfg=cfg, prompt_mode=prompt_mode,
                          sequential_cfg=sequential_cfg)
    sigmas = apply_denoise(model.sigma_table, scheduler, steps, denoise)
    samples, _ = sam(latent=latent, sigmas=sigmas, cond=positive, uncond=negative,
                     mask=mask, seed=seed, video=video, noise=noise)
    return samples

