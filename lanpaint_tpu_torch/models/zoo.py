"""Model zoo: packaged Denoisers (the eps-prediction UNets and the
flow-matching MMDiTs for now).

PyTorch counterpart of the UNet and MMDiT parts of
`lanpaint_tpu/models/zoo.py`.  `build_unet` and `build_dit` return
(Denoiser, module).  Without a state_dict the weights are random, drawn on
the target device from a seeded generator with the rule of
`lanpaint_tpu.models.zoo.init_params_host`: kernels N(0, 0.02^2), biases
zero, norm scales one (the numbers differ from numpy's; carry a flax tree
across with models/bridge.py for identical weights).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import ModelKind
from ..schedule import bcast_to
from ..sigmas import EpsSigmaTable, FlowSigmaTable
from .base import Denoiser
from .dit import FLUX_DEV_CONFIG, FLUX_SCHNELL_CONFIG, TINY_DIT_CONFIG, DiTConfig, MMDiT
from .layers import GroupNorm32, LayerNormF32, RMSNorm
from .unet import SDXL_CONFIG, TINY_UNET_CONFIG, UNetConfig, UNetModel


def _interp(x, xp, fp):
    """jnp.interp: piecewise-linear, clamped to fp[0] / fp[-1] outside xp."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    x0, x1 = xp[i - 1], xp[i]
    f0, f1 = fp[i - 1], fp[i]
    dx = x1 - x0
    f = f0 + (x - x0) / torch.where(dx == 0, torch.ones_like(dx), dx) * (f1 - f0)
    f = torch.where(dx == 0, f1, f)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


@torch.no_grad()
def init_params_(module: torch.nn.Module, seed: int = 0, scale: float = 0.02):
    """Fill `module`'s parameters in place, on their device, from a seeded
    generator: weights N(0, scale^2), biases zero, norm scales one."""
    device = next(module.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    for mod in module.modules():
        is_norm = isinstance(mod, (GroupNorm32, LayerNormF32, RMSNorm))
        for pname, p in mod.named_parameters(recurse=False):
            if pname == "bias":
                p.zero_()
            elif is_norm:
                p.fill_(1.0)
            else:
                p.normal_(0.0, scale, generator=gen)


def _materialize(cls, config, state_dict, device, param_dtype, seed):
    """`cls(config)` created on the meta device and materialized on `device`
    directly (a full-size model never passes through host memory), with
    `state_dict`'s weights or random ones."""
    with torch.device("meta"):
        module = cls(config).to(param_dtype)
    module = module.to_empty(device=device)
    if state_dict is None:
        init_params_(module, seed=seed)
    else:
        module.load_state_dict(state_dict)
    return module.eval().requires_grad_(False)


def build_unet(
    config: UNetConfig,
    state_dict: Optional[dict] = None,
    *,
    device="cpu",
    param_dtype: torch.dtype = torch.float32,
    seed: int = 0,
    name: str = "unet",
):
    """Build the UNet Denoiser on `device` with `param_dtype` parameters."""
    module = _materialize(UNetModel, config, state_dict, device, param_dtype, seed)

    table = EpsSigmaTable()
    log_sigmas = torch.log(torch.tensor(table.sigmas, dtype=torch.float32, device=device))
    steps = torch.arange(log_sigmas.shape[0], dtype=torch.float32, device=device)

    def sigma_to_timestep(sigma):
        # log-sigma interpolation into the discrete table (ComfyUI
        # ModelSamplingDiscrete.timestep analogue)
        return _interp(torch.log(torch.clamp_min(sigma, 1e-10)), log_sigmas, steps)

    # eps: x0 = x - sigma * eps, with eps predicted from the VP-scaled input
    # (c_in scaling, ComfyUI EPS.calculate_denoised analogue)
    @torch.no_grad()
    def apply(x, sigma, cond):
        s = bcast_to(sigma, x.ndim)
        x_in = x / torch.sqrt(1.0 + s**2)
        t_disc = sigma_to_timestep(sigma)
        y = cond.get("y") if isinstance(cond, dict) else None
        ctx = cond["context"] if isinstance(cond, dict) else cond
        kvc = cond.get("kv_cache") if isinstance(cond, dict) else None
        eps = module(x_in, t_disc, ctx, y, kv_cache=kvc)
        return x - s * eps

    den = Denoiser(apply=apply, kind=ModelKind.EPS, sigma_table=table, name=name,
                   latent_channels=config.in_channels, module=module,
                   precompute=lambda cond: unet_precompute_kv(module, cond))
    return den, module


@torch.no_grad()
def unet_precompute_kv(module: UNetModel, cond):
    """Hoist every cross-attention k|v projection out of the sampling loops:
    the text context is constant within a run, so `context @ kv_cross` per
    SpatialTransformer is computed ONCE per sampler call instead of once per
    forward.  Returns cond with a "kv_cache" dict {name: (B, depth, T, 2*ch)}
    (batch-major, so a batched-CFG cond concat composes)."""
    if not isinstance(cond, dict) or "context" not in cond:
        return cond
    cache = {name: st.cross_kv(cond["context"]) for name, st in module.spatial_transformers()}
    if not cache:
        return cond
    return dict(cond, kv_cache=cache)


def build_sdxl(state_dict=None, **kw):
    return build_unet(SDXL_CONFIG, state_dict, name="sdxl", **kw)


def build_tiny_unet(state_dict=None, **kw):
    return build_unet(TINY_UNET_CONFIG, state_dict, name="tiny-unet", **kw)


# --------------------------------------------------------------------------
# flow-matching DiTs (Flux family)


def build_dit(
    config: DiTConfig,
    state_dict: Optional[dict] = None,
    *,
    shift: float = 1.0,
    is_flux: bool = True,
    device="cpu",
    param_dtype: torch.dtype = torch.float32,
    seed: int = 0,
    name: str = "dit",
):
    """Build the MMDiT Denoiser on `device` with `param_dtype` parameters.

    The model predicts the flow velocity v = noise - x0, so x0 = x - t * v.
    `cond` is {"context", "vec", "guidance", "ref_tokens"} (all but the
    context optional)."""
    module = _materialize(MMDiT, config, state_dict, device, param_dtype, seed)

    @torch.no_grad()
    def apply(x, t, cond):
        is_dict = isinstance(cond, dict)
        ctx = cond["context"] if is_dict else cond
        extras = [cond.get(k) if is_dict else None for k in ("vec", "guidance", "ref_tokens")]
        vel = module(x, t, ctx, *extras)
        return x - bcast_to(t, x.ndim) * vel

    den = Denoiser(apply=apply, kind=ModelKind.FLOW, sigma_table=FlowSigmaTable(shift=shift),
                   is_flux=is_flux, name=name, latent_channels=config.latent_channels,
                   module=module)
    return den, module


def build_flux_dev(state_dict=None, **kw):
    return build_dit(FLUX_DEV_CONFIG, state_dict, shift=1.15, is_flux=True, name="flux-dev",
                     **kw)


def build_flux_schnell(state_dict=None, **kw):
    return build_dit(FLUX_SCHNELL_CONFIG, state_dict, shift=1.0, is_flux=True,
                     name="flux-schnell", **kw)


def build_tiny_dit(state_dict=None, **kw):
    return build_dit(TINY_DIT_CONFIG, state_dict, is_flux=False, name="tiny-dit", **kw)
