"""Model zoo: packaged Denoisers (the eps- and v-prediction UNets, the
flow-matching MMDiTs with Qwen-Image and the stand-in families, SD3 /
SD3.5, HiDream-I1, HunyuanVideo, Z-Image and the Wan video DiTs), the
image and video VAEs, the CLIP, T5 and Llama / Qwen text encoders and the
Qwen2.5-VL vision tower.

PyTorch counterpart of `lanpaint_tpu/models/zoo.py` but for its ControlNet
and sequence-parallel Wan builders, with its two-model wrappers
(`switching_denoiser`, the Wan2.2 high/low-noise expert pair, and
`dual_model_denoiser`) and the checkpoint key census
(`family_expected_keys`, `family_census`).
`build_unet`, `build_dit`, `build_sd3`, `build_hidream`, `build_hyvideo`,
`build_zimage` and `build_wan` return (Denoiser, module); `build_vae`,
`build_wan_vae`, `build_clip`, `build_t5`, `build_llama` and
`build_vision` return the module.
Every `build_*` function builds on the CUDA card unless `device` names
another (`utils.resolve_device`).
Without a state_dict the weights are random, drawn on the target device
from a seeded generator with the rule of
`lanpaint_tpu.models.zoo.init_params_host`: kernels N(0, 0.02^2), biases
zero, norm scales one (the numbers differ from numpy's; carry a flax tree
across with models/bridge.py for identical weights).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..config import ModelKind
from ..schedule import bcast_to
from ..sigmas import EpsSigmaTable, FlowSigmaTable
from ..utils import resolve_device
from .base import Denoiser
from .dit import (ANIMA_CONFIG, FLUX2_DEV_CONFIG, FLUX2_KLEIN_CONFIG, FLUX_DEV_CONFIG,
                  FLUX_SCHNELL_CONFIG, KREA2_CONFIG, QWEN_IMAGE_CONFIG, TINY_DIT_CONFIG, DiTConfig,
                  MMDiT)
from .layers import GroupNorm32, LayerNormF32, RMSNorm
from . import textenc
from .textenc import (CLIP_L_CONFIG, QWEN3_4B_CONFIG, T5_XXL_CONFIG, CLIPTextConfig,
                      CLIPTextEncoder, LlamaConfig, LlamaEncoder, T5Config, T5Encoder)
from .unet import SD15_CONFIG, SD21_CONFIG, SDXL_CONFIG, TINY_UNET_CONFIG, UNetConfig, UNetModel
from .vae import SDXL_VAE_CONFIG, VAE, VAEConfig
from .video_vae import WAN22_VAE_CONFIG, RMSNorm3d, WanVAE, WanVAEConfig
from .wan import TINY_WAN_CONFIG, WanConfig, WanModel, _WanQKNorm


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
        is_norm = isinstance(mod, (GroupNorm32, LayerNormF32, RMSNorm, RMSNorm3d, _WanQKNorm,
                                   textenc.LayerNorm, textenc.RMSNorm))
        # raw RMS-scale parameters of a module (the vision tower's)
        norm_params = getattr(mod, "_NORM_PARAMS", ())
        for pname, p in mod.named_parameters(recurse=False):
            if pname == "bias":
                p.zero_()
            elif is_norm or pname in norm_params:
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
    v_prediction: bool = False,
    device=None,
    param_dtype: torch.dtype = torch.float32,
    seed: int = 0,
    name: str = "unet",
):
    """Build the UNet Denoiser on `device` (the CUDA card when None) with
    `param_dtype` parameters.  `v_prediction` reads the model's output as
    v (SD2.x-v): x0 = x / (1 + s^2) - s / sqrt(1 + s^2) * v."""
    device = resolve_device(device)
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
        if v_prediction:
            return x / (1.0 + s**2) - s / torch.sqrt(1.0 + s**2) * eps
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


def build_sd15(state_dict=None, **kw):
    return build_unet(SD15_CONFIG, state_dict, name="sd15", **kw)


def build_sd21_v(state_dict=None, **kw):
    return build_unet(SD21_CONFIG, state_dict, v_prediction=True, name="sd21-v", **kw)


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
    device=None,
    param_dtype: torch.dtype = torch.float32,
    seed: int = 0,
    name: str = "dit",
):
    """Build the MMDiT Denoiser on `device` (the CUDA card when None) with
    `param_dtype` parameters.

    The model predicts the flow velocity v = noise - x0, so x0 = x - t * v.
    `cond` is {"context", "vec", "guidance", "ref_tokens"} (all but the
    context optional)."""
    module = _materialize(MMDiT, config, state_dict, resolve_device(device), param_dtype, seed)

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


def build_qwen_image(state_dict=None, **kw):
    return build_dit(QWEN_IMAGE_CONFIG, state_dict, shift=2.2, is_flux=False, name="qwen-image",
                     **kw)


def build_flux2_dev(state_dict=None, **kw):
    return build_dit(FLUX2_DEV_CONFIG, state_dict, shift=1.15, is_flux=True, name="flux2-dev",
                     **kw)


def build_flux2_klein(state_dict=None, **kw):
    return build_dit(FLUX2_KLEIN_CONFIG, state_dict, shift=1.15, is_flux=False,
                     name="flux2-klein", **kw)


def build_krea2(state_dict=None, **kw):
    """Krea 2 turbo (reference Krea2_LanPaint_Inpaint.json): stand-in
    topology; encoder / VAE pairing per the workflow (docs/family_facts.md)."""
    return build_dit(KREA2_CONFIG, state_dict, shift=3.0, is_flux=False, name="krea2", **kw)


def build_anima(state_dict=None, **kw):
    """Anima preview3 (reference README.md:272-286): stand-in topology;
    Qwen3-0.6B text features + the Qwen-Image VAE per the embedded workflow."""
    return build_dit(ANIMA_CONFIG, state_dict, shift=3.0, is_flux=False, name="anima", **kw)


def build_tiny_dit(state_dict=None, **kw):
    return build_dit(TINY_DIT_CONFIG, state_dict, is_flux=False, name="tiny-dit", **kw)


# --------------------------------------------------------------------------
# Z-Image S3-DiT


def build_zimage(
    config=None,
    state_dict: Optional[dict] = None,
    *,
    shift: float = 3.0,
    device=None,
    param_dtype: torch.dtype = torch.float32,
    seed: int = 0,
    name: str = "z-image",
):
    """Build the Z-Image S3-DiT Denoiser (models/zimage.py, the Lumina2 /
    NextDiT graph the reference's Z_image workflows load; shift 3.0 is the
    workflow's ModelSamplingAuraFlow value) on `device` (the CUDA card when
    None) with `param_dtype` parameters.  `config` defaults to
    Z_IMAGE_S3_CONFIG; the model predicts the flow velocity, x0 = x - t * v;
    `cond` is {"context"} (Qwen3-4B hidden states)."""
    from .zimage import Z_IMAGE_S3_CONFIG, ZImageModel

    config = Z_IMAGE_S3_CONFIG if config is None else config
    module = _materialize(ZImageModel, config, state_dict, resolve_device(device), param_dtype,
                          seed)

    @torch.no_grad()
    def apply(x, t, cond):
        ctx = cond["context"] if isinstance(cond, dict) else cond
        return x - bcast_to(t, x.ndim) * module(x, t, ctx)

    den = Denoiser(apply=apply, kind=ModelKind.FLOW, sigma_table=FlowSigmaTable(shift=shift),
                   is_flux=False, name=name, latent_channels=config.in_channels, module=module)
    return den, module


def build_tiny_zimage(state_dict=None, **kw):
    from .zimage import TINY_ZIMAGE_CONFIG

    return build_zimage(TINY_ZIMAGE_CONFIG, state_dict, name="tiny-z-image", **kw)


def build_z_image(state_dict=None, **kw):
    """The full-size Z-Image S3-DiT (the JAX package's back-compat alias)."""
    return build_zimage(state_dict=state_dict, **kw)


# --------------------------------------------------------------------------
# HunyuanVideo DiT


def build_hyvideo(
    config=None,
    state_dict: Optional[dict] = None,
    *,
    shift: float = 7.0,
    device=None,
    param_dtype: torch.dtype = torch.float32,
    seed: int = 0,
    name: str = "hunyuan-video",
):
    """Build the HunyuanVideo DiT Denoiser (models/hyvideo.py, the backbone
    the reference's Hunyuan workflow samples as a single-frame T2I model) on
    `device` (the CUDA card when None) with `param_dtype` parameters.
    `config` defaults to HUNYUAN_VIDEO_720P_CONFIG; shift 7.0 is
    HunyuanVideo's flow-schedule default.  A 4D (B, C, H, W) image latent
    runs as one frame (unsqueezed to T = 1 and squeezed back), a 5D one as
    a video; x0 = x - t * v; `cond` is {"context", "vec", "guidance"}."""
    from .hyvideo import HUNYUAN_VIDEO_720P_CONFIG, HYVideoDiT

    config = HUNYUAN_VIDEO_720P_CONFIG if config is None else config
    module = _materialize(HYVideoDiT, config, state_dict, resolve_device(device), param_dtype,
                          seed)

    @torch.no_grad()
    def apply(x, t, cond):
        squeeze = x.ndim == 4  # an image latent: one frame of video
        xv = x[:, :, None] if squeeze else x
        is_dict = isinstance(cond, dict)
        ctx = cond["context"] if is_dict else cond
        vec, guidance = (cond.get(k) if is_dict else None for k in ("vec", "guidance"))
        x0 = xv - bcast_to(t, xv.ndim) * module(xv, t, ctx, vec, guidance)
        return x0[:, :, 0] if squeeze else x0

    den = Denoiser(apply=apply, kind=ModelKind.FLOW, sigma_table=FlowSigmaTable(shift=shift),
                   name=name, latent_channels=config.in_channels, module=module)
    return den, module


def build_tiny_hyvideo(state_dict=None, **kw):
    from .hyvideo import TINY_HYVIDEO_CONFIG

    return build_hyvideo(TINY_HYVIDEO_CONFIG, state_dict, name="tiny-hyvideo", **kw)


# --------------------------------------------------------------------------
# HiDream-I1 MoE-MMDiT


def build_hidream(
    config=None,
    state_dict: Optional[dict] = None,
    *,
    shift: float = 3.0,
    device=None,
    param_dtype: torch.dtype = torch.float32,
    seed: int = 0,
    name: str = "hidream",
):
    """Build the HiDream-I1 Denoiser (models/hidream.py) on `device` (the
    CUDA card when None) with `param_dtype` parameters.  `config` defaults
    to HIDREAM_I1_CONFIG; x0 = x - t * v; `cond` is {"context", "vec",
    "llama"} (`text.hidream_cond`)."""
    from .hidream import HIDREAM_I1_CONFIG, HiDreamModel

    config = HIDREAM_I1_CONFIG if config is None else config
    module = _materialize(HiDreamModel, config, state_dict, resolve_device(device), param_dtype,
                          seed)

    @torch.no_grad()
    def apply(x, t, cond):
        is_dict = isinstance(cond, dict)
        ctx = cond["context"] if is_dict else cond
        vec, llama = (cond.get(k) if is_dict else None for k in ("vec", "llama"))
        return x - bcast_to(t, x.ndim) * module(x, t, ctx, vec, llama)

    den = Denoiser(apply=apply, kind=ModelKind.FLOW, sigma_table=FlowSigmaTable(shift=shift),
                   is_flux=False, name=name, latent_channels=config.latent_channels,
                   module=module)
    return den, module


def build_tiny_hidream(state_dict=None, **kw):
    from .hidream import TINY_HIDREAM_CONFIG

    return build_hidream(TINY_HIDREAM_CONFIG, state_dict, name="tiny-hidream", **kw)


# --------------------------------------------------------------------------
# SD3 / SD3.5 rectified-flow MMDiT


def build_sd3(
    config,
    state_dict: Optional[dict] = None,
    *,
    shift: float = 3.0,
    device=None,
    param_dtype: torch.dtype = torch.float32,
    seed: int = 0,
    name: str = "sd3",
):
    """Build the SD3 / SD3.5 MMDiT Denoiser (models/sd3.py) of `config` on
    `device` (the CUDA card when None) with `param_dtype` parameters.
    x0 = x - t * v on the shift-3 flow ladder; `cond` is {"context", "vec"}
    (`text.sd3_cond`)."""
    from .sd3 import SD3MMDiT

    module = _materialize(SD3MMDiT, config, state_dict, resolve_device(device), param_dtype, seed)

    @torch.no_grad()
    def apply(x, t, cond):
        is_dict = isinstance(cond, dict)
        ctx = cond["context"] if is_dict else cond
        vec = cond.get("vec") if is_dict else None
        return x - bcast_to(t, x.ndim) * module(x, t, ctx, vec)

    den = Denoiser(apply=apply, kind=ModelKind.FLOW, sigma_table=FlowSigmaTable(shift=shift),
                   is_flux=False, name=name, latent_channels=config.in_channels, module=module)
    return den, module


def build_sd35_large(state_dict=None, **kw):
    from .sd3 import SD35_LARGE_CONFIG

    return build_sd3(SD35_LARGE_CONFIG, state_dict, name="sd3.5-large", **kw)


def build_sd35_large_turbo(state_dict=None, **kw):
    from .sd3 import SD35_LARGE_TURBO_CONFIG

    return build_sd3(SD35_LARGE_TURBO_CONFIG, state_dict, name="sd3.5-large-turbo", **kw)


def build_sd35_medium(state_dict=None, **kw):
    from .sd3 import SD35_MEDIUM_CONFIG

    return build_sd3(SD35_MEDIUM_CONFIG, state_dict, name="sd3.5-medium", **kw)


def build_sd3_medium(state_dict=None, **kw):
    from .sd3 import SD3_MEDIUM_CONFIG

    return build_sd3(SD3_MEDIUM_CONFIG, state_dict, name="sd3-medium", **kw)


def build_tiny_sd3(state_dict=None, **kw):
    from .sd3 import TINY_SD3_CONFIG

    return build_sd3(TINY_SD3_CONFIG, state_dict, name="tiny-sd3", **kw)


# --------------------------------------------------------------------------
# image autoencoders


def build_vae(config: VAEConfig = SDXL_VAE_CONFIG, state_dict: Optional[dict] = None, *,
              device=None, param_dtype: torch.dtype = torch.float32, seed: int = 0) -> VAE:
    """The AutoencoderKL of `config` on `device` (the CUDA card when None)
    with `param_dtype` parameters (random from `seed` without a
    state_dict), in eval mode."""
    return _materialize(VAE, config, state_dict, resolve_device(device), param_dtype, seed)


# --------------------------------------------------------------------------
# text encoders


def build_clip(config: CLIPTextConfig = CLIP_L_CONFIG, state_dict: Optional[dict] = None, *,
               device=None, param_dtype: torch.dtype = torch.float32,
               seed: int = 0) -> CLIPTextEncoder:
    """The CLIP text encoder of `config` on `device` (the CUDA card when
    None) with `param_dtype` parameters (random from `seed` without a
    state_dict), in eval mode."""
    return _materialize(CLIPTextEncoder, config, state_dict, resolve_device(device), param_dtype,
                        seed)


def build_t5(config: T5Config = T5_XXL_CONFIG, state_dict: Optional[dict] = None, *,
             device=None, param_dtype: torch.dtype = torch.float32, seed: int = 0) -> T5Encoder:
    """The T5 / UMT5 encoder of `config` on `device` (the CUDA card when
    None) with `param_dtype` parameters (random from `seed` without a
    state_dict), in eval mode."""
    return _materialize(T5Encoder, config, state_dict, resolve_device(device), param_dtype, seed)


def build_llama(config: LlamaConfig = QWEN3_4B_CONFIG, state_dict: Optional[dict] = None, *,
                device=None, param_dtype: torch.dtype = torch.float32,
                seed: int = 0) -> LlamaEncoder:
    """The Llama / Qwen text trunk of `config` on `device` (the CUDA card
    when None) with `param_dtype` parameters (random from `seed` without a
    state_dict), in eval mode."""
    return _materialize(LlamaEncoder, config, state_dict, resolve_device(device), param_dtype,
                        seed)


def build_vision(config=None, state_dict: Optional[dict] = None, *, device=None,
                 param_dtype: torch.dtype = torch.float32, seed: int = 0):
    """The Qwen2.5-VL vision tower of `config` (QWEN25_VL_VISION_CONFIG when
    None) on `device` (the CUDA card when None) with `param_dtype`
    parameters (random from `seed` without a state_dict), in eval mode."""
    from .vision import QWEN25_VL_VISION_CONFIG, QwenVLVision

    config = QWEN25_VL_VISION_CONFIG if config is None else config
    return _materialize(QwenVLVision, config, state_dict, resolve_device(device), param_dtype,
                        seed)


# --------------------------------------------------------------------------
# Wan2.2 video DiT


def build_wan(
    config: WanConfig,
    state_dict: Optional[dict] = None,
    *,
    shift: float = 5.0,
    device=None,
    param_dtype: torch.dtype = torch.float32,
    seed: int = 0,
    name: str = "wan",
):
    """Build the Wan Denoiser on `device` (the CUDA card when None) with
    `param_dtype` parameters.

    The model predicts the flow velocity, so x0 = x - t * v, on the
    `FlowSigmaTable(shift)` ladder.  `cond` is {"context"} (T5 features);
    the `precompute` hook adds "kv_cache", every block's cross-attention
    k/v, once per sampler call (`WanModel.precompute_kv`)."""
    module = _materialize(WanModel, config, state_dict, resolve_device(device), param_dtype,
                          seed)

    @torch.no_grad()
    def apply(x, t, cond):
        is_dict = isinstance(cond, dict)
        ctx = cond["context"] if is_dict else cond
        kvc = cond.get("kv_cache") if is_dict else None
        vel = module(x, t, ctx, kv_cache=kvc)
        return x - bcast_to(t, x.ndim) * vel

    @torch.no_grad()
    def precompute(cond):
        if not isinstance(cond, dict) or "context" not in cond:
            return cond
        return dict(cond, kv_cache=module.precompute_kv(cond["context"]))

    den = Denoiser(apply=apply, kind=ModelKind.FLOW, sigma_table=FlowSigmaTable(shift=shift),
                   name=name, latent_channels=config.in_channels, module=module,
                   precompute=precompute)
    return den, module


def build_tiny_wan(state_dict=None, **kw):
    return build_wan(TINY_WAN_CONFIG, state_dict, name="tiny-wan", **kw)


def build_wan_vae(config: WanVAEConfig = WAN22_VAE_CONFIG, state_dict: Optional[dict] = None, *,
                  device=None, param_dtype: torch.dtype = torch.float32,
                  seed: int = 0) -> WanVAE:
    """The Wan video VAE of `config` on `device` (the CUDA card when None)
    with `param_dtype` parameters (random from `seed` without a
    state_dict), in eval mode."""
    return _materialize(WanVAE, config, state_dict, resolve_device(device), param_dtype, seed)


# --------------------------------------------------------------------------
# two-model wrappers


def _expert_cond(cond, name: str):
    """Expert `name`'s cond: its own precomputed one where the pair's
    precompute made it, the pair's cond otherwise."""
    if isinstance(cond, dict) and "experts" in cond:
        return cond["experts"][name]
    return cond


def switching_denoiser(high: Denoiser, low: Denoiser, boundary: float = 0.875,
                       name: str = "wan22-moe") -> Denoiser:
    """Two-expert timestep-switched denoiser: the Wan2.2 high-noise +
    low-noise pair (reference README.md:219-225).  The high-noise expert
    serves model time t >= boundary (the batch mean, compared in float32),
    the low-noise one the rest, as the JAX package's `lax.cond`.

    The sampler routes each model call through `route` from its host sigma,
    so only the chosen expert runs and no forward reads the device; `apply`,
    for direct callers, reads t's mean itself (a device sync when t is on
    the card).  `precompute` hoists each expert's run-constant conditioning
    (the Wan cross-attention k/v) under cond["experts"][name]: the JAX pair
    hoists nothing, and the port's hoist gives the forward's own bits
    (tests/test_torch_wan.py).  `module` is an nn.ModuleDict {"high",
    "low"}; `bridge.pair_params_from_flax` maps the JAX pair's parameters
    onto its state_dict."""
    if high.kind is not low.kind:
        raise ValueError(f"the experts' kinds differ: {high.kind} and {low.kind}")
    experts = {"high": high, "low": low}

    def expert_apply(key):
        den = experts[key]
        return lambda x, t, cond: den.apply(x, t, _expert_cond(cond, key))

    applies = {k: expert_apply(k) for k in experts}

    def route(t: float):
        return applies["high" if np.float32(t) >= np.float32(boundary) else "low"]

    def apply(x, t, cond):
        return route(float(torch.as_tensor(t, dtype=torch.float32).mean()))(x, t, cond)

    def precompute(cond):
        if not isinstance(cond, dict):
            return cond
        return dict(cond, experts={k: cond if d.precompute is None else d.precompute(cond)
                                   for k, d in experts.items()})

    return Denoiser(apply=apply, kind=high.kind, sigma_table=high.sigma_table,
                    is_flux=high.is_flux, name=name, latent_channels=high.latent_channels,
                    module=nn.ModuleDict({"high": high.module, "low": low.module}),
                    precompute=precompute, route=route)


def dual_model_denoiser(positive: Denoiser, negative: Denoiser,
                        name: str = "dual-cfg") -> Denoiser:
    """Two-model CFG, the reference Ideogram4 workflow's `DualModelGuider`
    (docs/family_facts.md): the positive CFG branch runs `positive`, the
    negative branch `negative`, and CFG mixes across the two.

    Usage: put `"model_select": 1` in the NEGATIVE cond dict and sample with
    `sequential_cfg=True`: each CFG pass then runs one model.  The batched
    2B pass cannot route per half; it raises ValueError (cond and uncond
    differ in their keys), as the JAX package's `jax.tree.map` does.  A
    cond's model_select (its mean > 0.5 picks `negative`) is read on the
    host: `precompute` turns it into a Python float once per sampler call,
    and `apply` reads a Python number or a tensor (a device sync for one on
    the card).  `module` is an nn.ModuleDict {"pos", "neg"}."""
    if positive.kind is not negative.kind:
        raise ValueError(f"the models' kinds differ: {positive.kind} and {negative.kind}")

    def select(sel) -> float:
        return float(torch.as_tensor(sel, dtype=torch.float32).mean())

    def apply(x, t, cond):
        sel, inner = 0.0, cond
        if isinstance(cond, dict):
            sel = cond.get("model_select", 0.0)
            inner = {k: v for k, v in cond.items() if k != "model_select"}
        return (negative if select(sel) > 0.5 else positive).apply(x, t, inner)

    def precompute(cond):
        if isinstance(cond, dict) and "model_select" in cond:
            return dict(cond, model_select=select(cond["model_select"]))
        return cond

    return Denoiser(apply=apply, kind=positive.kind, sigma_table=positive.sigma_table,
                    is_flux=positive.is_flux, name=name,
                    latent_channels=positive.latent_channels,
                    module=nn.ModuleDict({"pos": positive.module, "neg": negative.module}),
                    precompute=precompute)


# --------------------------------------------------------------------------
# checkpoint key census

def family_expected_keys(family: str):
    """The full checkpoint key set each family's importer consumes, from
    the import tables alone (no tensor is allocated): the key census of
    `lanpaint_tpu.models.zoo.family_expected_keys`.  An unknown family
    raises ValueError as the JAX package does."""
    from . import load as L

    if family in ("sd15", "sd21", "sdxl"):
        cfg = {"sd15": SD15_CONFIG, "sd21": SD21_CONFIG, "sdxl": SDXL_CONFIG}[family]
        return L.expected_keys(L._unet_entries(cfg), "model.diffusion_model.")
    if family in ("flux-dev", "flux-schnell"):
        cfg = FLUX_DEV_CONFIG if family == "flux-dev" else FLUX_SCHNELL_CONFIG
        return L.expected_keys(L._dit_entries(cfg), "")
    if family in ("flux2-dev", "flux2-klein", "krea2", "anima"):
        cfg = {"flux2-dev": FLUX2_DEV_CONFIG, "flux2-klein": FLUX2_KLEIN_CONFIG,
               "krea2": KREA2_CONFIG, "anima": ANIMA_CONFIG}[family]
        return L.expected_keys(L._dit_entries(cfg), "")
    if family == "qwen":
        return L.qwen_expected_keys(QWEN_IMAGE_CONFIG)
    if family == "zimage":
        from .zimage import Z_IMAGE_S3_CONFIG

        return L.expected_keys(L._zimage_entries(Z_IMAGE_S3_CONFIG), "")
    if family in ("wan-14b", "wan-5b"):
        from .wan import WAN22_T2V_14B_CONFIG, WAN22_TI2V_5B_CONFIG

        cfg = WAN22_T2V_14B_CONFIG if family == "wan-14b" else WAN22_TI2V_5B_CONFIG
        return L.expected_keys(L._wan_entries(cfg), "")
    if family == "hidream":
        from .hidream import HIDREAM_I1_CONFIG

        return L.hidream_expected_keys(HIDREAM_I1_CONFIG)
    if family in ("sd35-large", "sd35-medium", "sd3-medium"):
        from .sd3 import SD3_MEDIUM_CONFIG, SD35_LARGE_CONFIG, SD35_MEDIUM_CONFIG

        cfg = {"sd35-large": SD35_LARGE_CONFIG, "sd35-medium": SD35_MEDIUM_CONFIG,
               "sd3-medium": SD3_MEDIUM_CONFIG}[family]
        return L.expected_keys(L._sd3_entries(cfg), "model.diffusion_model.")
    if family == "hyvideo":
        from .hyvideo import HUNYUAN_VIDEO_720P_CONFIG

        return L.expected_keys(L._hyvideo_entries(HUNYUAN_VIDEO_720P_CONFIG), "")
    raise ValueError(
        f"no key census for family {family!r}; supported: sd15 sd21 sdxl "
        "flux-dev flux-schnell flux2-dev flux2-klein krea2 anima qwen "
        "hidream sd35-large sd35-medium sd3-medium zimage wan-14b wan-5b "
        "hyvideo")


def family_census(checkpoint_path: str, family: str) -> dict:
    """Header-only key census of a checkpoint vs a family's import table."""
    from . import load as L

    have = L.safetensors_header_keys(checkpoint_path)
    return L.key_census(have, family_expected_keys(family), family)
