"""Denoiser protocol: the model contract the sampler consumes.

PyTorch counterpart of `lanpaint_tpu/models/base.py`.  The engine only needs
an x0-prediction function; prediction-type conversion (eps / v / flow
velocity) happens here, as ComfyUI's `calculate_denoised` wrappers do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..config import ModelKind
from ..schedule import bcast_to


def x0_from_eps(raw: Callable) -> Callable:
    """eps-prediction -> x0: x0 = x - sigma * eps  (VE sigma space)."""

    def apply(x, sigma, cond):
        return x - bcast_to(sigma, x.ndim) * raw(x, sigma, cond)

    return apply


def x0_from_v(raw: Callable) -> Callable:
    """v-prediction -> x0: x0 = x/(1+sigma^2) - sigma/sqrt(1+sigma^2) * v."""

    def apply(x, sigma, cond):
        s = bcast_to(sigma, x.ndim)
        return x / (1.0 + s**2) - s / torch.sqrt(1.0 + s**2) * raw(x, sigma, cond)

    return apply


def x0_from_flow_velocity(raw: Callable) -> Callable:
    """Rectified-flow velocity -> x0: x0 = x - t * v  (v = noise - x0)."""

    def apply(x, t, cond):
        return x - bcast_to(t, x.ndim) * raw(x, t, cond)

    return apply


@dataclasses.dataclass
class Denoiser:
    """A diffusion backbone packaged for the sampler.

    apply(x, t, cond) returns the x0 prediction.  `sigma_table` supplies the
    model-based schedulers (sigmas.py); `is_flux` triggers the cfg_big = 1.0
    rule (reference nodes.py:217-218).  `precompute(cond) -> cond` is the
    run-constant conditioning hoist (e.g. the UNet cross-attention k/v,
    zoo.unet_precompute_kv): the sampler applies it once per call, outside
    the solver and think loops; the enriched cond must also give correct
    results when passed straight to apply().  The weights live in `module`.
    `route(t) -> apply`, for a model of several experts
    (zoo.switching_denoiser): the apply of the expert that serves model time
    `t`, a host float (the batch mean); the sampler calls it once per model
    call from its host sigma, so a forward reads nothing from the device.
    """

    apply: Callable[[torch.Tensor, torch.Tensor, Any], torch.Tensor]
    kind: ModelKind
    sigma_table: Any = None
    is_flux: bool = False
    name: str = "denoiser"
    latent_channels: int = 4
    process_latent_out: Optional[Callable] = None
    module: Optional[torch.nn.Module] = None
    precompute: Optional[Callable[[Any], Any]] = None
    route: Optional[Callable[[float], Callable]] = None
