"""Schedule unification and noise scaling across backbone families.

PyTorch counterpart of `lanpaint_tpu/schedule.py`: maps a backbone's native
time variable to the common triple (VE sigma, abar_t, flow t) the LanPaint
math is written in (reference src/LanPaint/nodes.py:150-166), plus the
noise-scaling pair of the replace step (reference lanpaint.py:55-60,
nodes.py:221, 248).

Relations (exact):
    EPS/VE:  abt = 1 / (1 + sigma^2),   t = sqrt(1-abt) / (sqrt(1-abt) + sqrt(abt))
    FLOW:    abt = (1-t)^2 / ((1-t)^2 + t^2),   sigma = t / (1-t)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import ModelKind


class Times(NamedTuple):
    """Unified time coordinates, one scalar per batch element (shape [B])."""

    ve_sigma: torch.Tensor
    abt: torch.Tensor
    flow_t: torch.Tensor


def unify_times(sigma, kind: ModelKind) -> Times:
    """Map the sampler's native time (sigma or flow-t) to unified coords."""
    sigma = torch.as_tensor(sigma)
    if kind is ModelKind.FLOW:
        t = sigma
        one_m_t = 1.0 - t
        abt = one_m_t**2 / (one_m_t**2 + t**2)
        ve_sigma = t / one_m_t
        return Times(ve_sigma, abt, t)
    ve_sigma = sigma
    abt = 1.0 / (1.0 + ve_sigma**2)
    sq1mabt = torch.sqrt(1.0 - abt)
    flow_t = sq1mabt / (sq1mabt + torch.sqrt(abt))
    return Times(ve_sigma, abt, flow_t)


def bcast_to(arr, ndim: int):
    """Reshape a [B] per-batch scalar to [B, 1, ..., 1] with `ndim` dims
    (the reference's add_none_dims, lanpaint.py:22-25)."""
    arr = torch.as_tensor(arr)
    return arr.reshape(tuple(arr.shape[:1]) + (1,) * (ndim - 1))


def noise_scaling(kind: ModelKind, sigma, noise, latent_image, max_denoise: bool = False):
    """Forward noise scaling: the noisy latent of the known region.

    EPS: latent + sigma * noise (sqrt(1+sigma^2) * noise at max denoise);
    FLOW: t * noise + (1 - t) * latent.
    """
    sigma = bcast_to(sigma, noise.ndim)
    if kind is ModelKind.FLOW:
        return sigma * noise + (1.0 - sigma) * latent_image
    if max_denoise:
        return latent_image + noise * torch.sqrt(1.0 + sigma**2)
    return latent_image + noise * sigma


def inverse_noise_scaling(kind: ModelKind, sigma, latent):
    """Undo the terminal scaling: identity for EPS, / (1 - t) for FLOW."""
    if kind is ModelKind.FLOW:
        sigma = bcast_to(sigma, latent.ndim)
        return latent / (1.0 - sigma)
    return latent


def to_vp(kind: ModelKind, x, times: Times, ndim: int):
    """Native sampler coords -> variance-preserving x_t (lanpaint.py:62-65)."""
    if kind is ModelKind.FLOW:
        abt = bcast_to(times.abt, ndim)
        return x * (torch.sqrt(abt) + torch.sqrt(1.0 - abt))
    sig = bcast_to(times.ve_sigma, ndim)
    return x / torch.sqrt(1.0 + sig**2)


def from_vp(kind: ModelKind, x_t, times: Times, ndim: int):
    """Variance-preserving x_t -> native sampler coords (lanpaint.py:110-113)."""
    if kind is ModelKind.FLOW:
        abt = bcast_to(times.abt, ndim)
        return x_t / (torch.sqrt(abt) + torch.sqrt(1.0 - abt))
    sig = bcast_to(times.ve_sigma, ndim)
    return x_t * torch.sqrt(1.0 + sig**2)


def vp_to_model_coords(kind: ModelKind, x_t, times: Times, ndim: int):
    """VP x_t -> (x_model, t_model): EPS models eat VE x at time sigma,
    FLOW models the rectified-flow x at time t (lanpaint.py:127-137)."""
    if kind is ModelKind.FLOW:
        abt = bcast_to(times.abt, ndim)
        return x_t / (torch.sqrt(abt) + torch.sqrt(1.0 - abt)), times.flow_t
    sig = bcast_to(times.ve_sigma, ndim)
    return x_t * torch.sqrt(1.0 + sig**2), times.ve_sigma
