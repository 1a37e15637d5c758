"""Wan causal 3D video VAE: pixel video <-> latent video.

PyTorch counterpart of `lanpaint_tpu/models/video_vae.py`: the public Wan2.1
VAE graph (also Qwen-Image's) and the Wan2.2 VAE of TI2V-5B (patch-2
pixel-unshuffle, parameter-free stage shortcuts), a causal 3D conv
autoencoder with RMS-normalized residual blocks and one spatial attention in
the middle, `1+4k` pixel frames <-> `1+k` latent frames.

Layout: NDHWC, (B, T, H, W, C), between layers, as the JAX module keeps it.
Every 3D convolution hands torch an NCDHW view of its input (a permute, no
copy: torch's channels_last_3d memory format, for which cuDNN has
channels-last kernels), and 1x1x1 convolutions are dense layers over the
channel axis.  So the pure data movements (`_avg_down3d`, `_dup_up3d`,
`_patchify` / `_unpatchify` and the upsample's frame interleave) are the
JAX module's reshapes and transposes, unchanged.

dtypes as the JAX module's: the convolutions compute in `cfg.dtype` (bf16 by
default); the RMS norms in fp32 with rsqrt(sum of squares + 1e-12), plain
torch (not the row-norm kernel's mean + eps, as the JAX package computes
them in jnp); `head_conv` and the quant convs in fp32.  Causal convolution
over the full sequence (front zero-pad in time), no streaming cache.

The mid attention is one head of D = C over each frame's grid, one launch
over the B*T frames: D = 384 for the Wan2.1 VAE, 640 for the Wan2.2 VAE.
Its q/k/v are column slices of one fused `to_qkv` output, (B*T, S, 1, 3C)
split three ways: strided views with a unit head stride, which
`attention_bshd` sends to the wide-head attention kernel on CUDA
(ops/attention.py) without a copy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import attention_bshd

# Per-channel latent normalization of the public Wan2.1 release (the DiT
# consumes (z - mean) / std), as in the JAX module.
WAN21_LATENTS_MEAN = (
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
)
WAN21_LATENTS_STD = (
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
)


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    dim: int = 96
    z_channels: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    # one temporal flag per down/up stage (len(dim_mult)-1 resamples)
    temporal_downsample: Tuple[bool, ...] = (False, True, True)
    # Wan2.2: pixel-unshuffle patch at input/output, per-stage shortcuts,
    # upsample convs keep their width
    patch: int = 1
    stage_shortcuts: bool = False
    latents_mean: Optional[Tuple[float, ...]] = WAN21_LATENTS_MEAN
    latents_std: Optional[Tuple[float, ...]] = WAN21_LATENTS_STD
    dtype: torch.dtype = torch.bfloat16


# The configurations of lanpaint_tpu/models/video_vae.py, which documents
# each one's source.
WAN21_VAE_CONFIG = WanVAEConfig()
QWEN_IMAGE_VAE_CONFIG = WanVAEConfig(latents_mean=None, latents_std=None)
WAN22_VAE_CONFIG = WanVAEConfig(
    dim=160, z_channels=48, patch=2, stage_shortcuts=True,
    temporal_downsample=(True, True, False), latents_mean=None, latents_std=None)
TINY_WAN_VAE_CONFIG = WanVAEConfig(
    dim=8, z_channels=4, dim_mult=(1, 2), num_res_blocks=1,
    temporal_downsample=(True,), latents_mean=None, latents_std=None)
TINY_WAN22_VAE_CONFIG = WanVAEConfig(
    dim=8, z_channels=4, dim_mult=(1, 2, 2), num_res_blocks=1,
    temporal_downsample=(True, False), patch=2, stage_shortcuts=True,
    latents_mean=None, latents_std=None)


def _pad_time(x, front: int):
    """Zero frames in front of an NDHWC tensor (the causal pad)."""
    return F.pad(x, (0, 0, 0, 0, 0, 0, front, 0)) if front else x


class Conv3d(nn.Conv3d):
    """flax-style Conv on NDHWC tensors: computes in `compute_dtype` (inputs
    and weights cast); torch sees an NCDHW (channels_last_3d) view."""

    def __init__(self, in_ch: int, out_ch: int, kernel=(3, 3, 3), stride=(1, 1, 1),
                 padding=(0, 0, 0), compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=padding)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        w, b = self.weight.to(dt), self.bias.to(dt)
        if self.kernel_size == (1, 1, 1) and self.stride == (1, 1, 1):
            return F.linear(x.to(dt), w.flatten(1), b)
        y = F.conv3d(x.to(dt).permute(0, 4, 1, 2, 3), w, b, self.stride, self.padding)
        return y.permute(0, 2, 3, 4, 1).contiguous()


class CausalConv3d(nn.Module):
    """Conv3d with causal time padding (front-pad kt - 1, no future taps)
    and same spatial padding; NDHWC in and out."""

    def __init__(self, in_ch: int, out_ch: int, kernel=(3, 3, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kt, kh, kw = kernel
        self.conv = Conv3d(in_ch, out_ch, kernel, padding=(0, kh // 2, kw // 2),
                           compute_dtype=dtype)

    def forward(self, x):
        return self.conv(_pad_time(x, self.conv.kernel_size[0] - 1))


class RMSNorm3d(nn.Module):
    """Wan `RMS_norm(dim, images=False)`: x / sqrt(sum over channels of x^2
    + 1e-12) * sqrt(dim) * gamma, in fp32; returns x's dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        # one fp32 copy normalized in place (the JAX module's products in its
        # order): at full resolution every fp32 temporary is ~10 GB
        xf = x.to(torch.float32, copy=True)
        inv = torch.rsqrt(torch.sum(xf * xf, dim=-1, keepdim=True) + 1e-12)
        return xf.mul_(inv).mul_(self.dim ** 0.5).mul_(self.gamma.float()).to(x.dtype)


class WanVAEResBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = RMSNorm3d(in_ch)
        self.conv1 = CausalConv3d(in_ch, out_ch, dtype=dtype)
        self.norm2 = RMSNorm3d(out_ch)
        self.conv2 = CausalConv3d(out_ch, out_ch, dtype=dtype)
        self.shortcut = (CausalConv3d(in_ch, out_ch, (1, 1, 1), dtype=dtype)
                         if in_ch != out_ch else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return x + h


class WanVAEAttnBlock(nn.Module):
    """Single-head spatial self-attention applied per frame (middle block)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = RMSNorm3d(channels)
        self.to_qkv = Conv3d(channels, 3 * channels, (1, 1, 1), compute_dtype=dtype)
        self.proj = Conv3d(channels, channels, (1, 1, 1), compute_dtype=dtype)

    def forward(self, x):
        b, t, hh, ww, c = x.shape
        qkv = self.to_qkv(self.norm(x)).reshape(b * t, hh * ww, 1, 3 * c)
        q, k, v = qkv.chunk(3, dim=-1)
        o = attention_bshd(q, k, v).reshape(b, t, hh, ww, c)
        return x + self.proj(o)


class SpatialResample(nn.Module):
    """Per-frame spatial resample (Wan `Resample.resample`): down is a
    (0, 1) bottom/right zero pad and a stride-2 valid conv, up a nearest 2x
    and a same-padded conv."""

    def __init__(self, in_ch: int, out_ch: int, down: bool, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.down = down
        self.conv = Conv3d(in_ch, out_ch, (1, 3, 3), stride=(1, 2, 2) if down else (1, 1, 1),
                           padding=(0, 0, 0) if down else (0, 1, 1), compute_dtype=dtype)

    def forward(self, x):
        if self.down:
            return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))
        b, t, hh, ww, c = x.shape
        x = x[:, :, :, None, :, None].expand(b, t, hh, 2, ww, 2, c)
        return self.conv(x.reshape(b, t, 2 * hh, 2 * ww, c))


class WanDownsample(nn.Module):
    """downsample2d / downsample3d: the spatial stride-2 conv, then (3d) a
    causal stride-2 time conv (T -> (T - 1) // 2 + 1)."""

    def __init__(self, dim: int, temporal: bool, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resample = SpatialResample(dim, dim, down=True, dtype=dtype)
        self.time_conv = (Conv3d(dim, dim, (3, 1, 1), stride=(2, 1, 1), compute_dtype=dtype)
                          if temporal else None)

    def forward(self, x):
        x = self.resample(x)
        if self.time_conv is not None:
            x = self.time_conv(_pad_time(x, 2))
        return x


class WanUpsample(nn.Module):
    """upsample2d / upsample3d: (3d) a causal time conv to two channel
    groups interleaved along time, the first interleaved frame dropped
    (1+k -> 1+2k), then the nearest 2x spatial conv; `halve` (Wan2.1)
    halves the width there."""

    def __init__(self, dim: int, temporal: bool, halve: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim = dim
        self.time_conv = Conv3d(dim, 2 * dim, (3, 1, 1), compute_dtype=dtype) if temporal else None
        self.resample = SpatialResample(dim, dim // 2 if halve else dim, down=False, dtype=dtype)

    def forward(self, x):
        if self.time_conv is not None:
            x = _interleave_frames(self.time_conv(_pad_time(x, 2)), self.dim)
        return self.resample(x)


def _interleave_frames(h, dim: int):
    """(B, T, H, W, 2*dim) -> (B, 2T - 1, H, W, dim): the channel pair of
    each frame becomes two consecutive frames; the first is dropped."""
    b, t, hh, ww, _ = h.shape
    h = h.reshape(b, t, hh, ww, 2, dim).permute(0, 1, 4, 2, 3, 5).reshape(b, 2 * t, hh, ww, dim)
    return h[:, 1:]


def _avg_down3d(x, out_ch: int, ft: int, fs: int):
    """Wan2.2 AvgDown3D (parameter-free stage shortcut): front-pad T to a
    multiple of ft, fold (ft, fs, fs) blocks into channels (C-major order),
    group-mean down to out_ch."""
    b, t, hh, ww, c = x.shape
    x = _pad_time(x, (-t) % ft)
    t2 = x.shape[1]
    x = x.reshape(b, t2 // ft, ft, hh // fs, fs, ww // fs, fs, c).permute(0, 1, 3, 5, 7, 2, 4, 6)
    return x.reshape(b, t2 // ft, hh // fs, ww // fs, out_ch, -1).mean(dim=-1)


def _dup_up3d(x, out_ch: int, ft: int, fs: int):
    """Wan2.2 DupUp3D (parameter-free stage shortcut): channel
    repeat-interleave, unfold to (ft, fs, fs) pixel blocks, drop the ft - 1
    causal lead frames."""
    b, t, hh, ww, c = x.shape
    x = x.repeat_interleave(out_ch * ft * fs * fs // c, dim=-1)
    x = x.reshape(b, t, hh, ww, out_ch, ft, fs, fs).permute(0, 1, 5, 2, 6, 3, 7, 4)
    x = x.reshape(b, t * ft, hh * fs, ww * fs, out_ch)
    return x[:, ft - 1:] if ft > 1 else x


def _patchify(x, p: int):
    """(B,T,H,W,C) -> (B,T,H/p,W/p,C*p*p), channel order (c, r, q) with q
    the H-subpixel and r the W-subpixel (the Wan2.2 rearrange)."""
    if p == 1:
        return x
    b, t, hh, ww, c = x.shape
    x = x.reshape(b, t, hh // p, p, ww // p, p, c).permute(0, 1, 2, 4, 6, 5, 3)
    return x.reshape(b, t, hh // p, ww // p, c * p * p)


def _unpatchify(x, p: int):
    if p == 1:
        return x
    b, t, hh, ww, cpp = x.shape
    c = cpp // (p * p)
    x = x.reshape(b, t, hh, ww, c, p, p).permute(0, 1, 2, 6, 3, 5, 4)
    return x.reshape(b, t, hh * p, ww * p, c)


class WanVAEEncoder(nn.Module):
    """(B, T, H, W, 3) -> (B, T', H/s, W/s, 2z) moments."""

    def __init__(self, cfg: WanVAEConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        self.dims = dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
        self.conv1 = CausalConv3d(3 * cfg.patch ** 2, dims[0], dtype=dt)
        for i in range(len(cfg.dim_mult)):
            c = dims[i]
            for j in range(cfg.num_res_blocks):
                self.add_module(f"down_{i}_block_{j}", WanVAEResBlock(c, dims[i + 1], dt))
                c = dims[i + 1]
            if i != len(cfg.dim_mult) - 1:
                self.add_module(f"down_{i}_ds",
                                WanDownsample(c, cfg.temporal_downsample[i], dtype=dt))
        c = dims[-1]
        self.mid_block_1 = WanVAEResBlock(c, c, dt)
        self.mid_attn = WanVAEAttnBlock(c, dt)
        self.mid_block_2 = WanVAEResBlock(c, c, dt)
        self.head_norm = RMSNorm3d(c)
        self.head_conv = CausalConv3d(c, 2 * cfg.z_channels)

    def forward(self, x):
        cfg, dims = self.cfg, self.dims
        h = self.conv1(_patchify(x, cfg.patch))
        for i in range(len(cfg.dim_mult)):
            down = i != len(cfg.dim_mult) - 1
            h_in = h
            for j in range(cfg.num_res_blocks):
                h = getattr(self, f"down_{i}_block_{j}")(h)
            if down:
                h = getattr(self, f"down_{i}_ds")(h)
            if cfg.stage_shortcuts:  # Wan2.2 Down_ResidualBlock avg path
                ft = 2 if (down and cfg.temporal_downsample[i]) else 1
                fs = 2 if down else 1
                h = h + _avg_down3d(h_in, dims[i + 1], ft, fs).to(h.dtype)
        h = self.mid_block_2(self.mid_attn(self.mid_block_1(h)))
        return self.head_conv(F.silu(self.head_norm(h)).float())


class WanVAEDecoder(nn.Module):
    """(B, T', h, w, z) -> (B, T, H, W, 3)."""

    def __init__(self, cfg: WanVAEConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        rev = tuple(reversed(cfg.dim_mult))
        self.dims = dims = [cfg.dim * u for u in (rev[0],) + rev]
        self.temporal_up = temporal_up = tuple(reversed(cfg.temporal_downsample))
        self.conv1 = CausalConv3d(cfg.z_channels, dims[0], dtype=dt)
        c = dims[0]
        self.mid_block_1 = WanVAEResBlock(c, c, dt)
        self.mid_attn = WanVAEAttnBlock(c, dt)
        self.mid_block_2 = WanVAEResBlock(c, c, dt)
        for i in range(len(cfg.dim_mult)):
            out_dim = dims[i + 1]
            for j in range(cfg.num_res_blocks + 1):
                self.add_module(f"up_{i}_block_{j}", WanVAEResBlock(c, out_dim, dt))
                c = out_dim
            if i != len(cfg.dim_mult) - 1:
                halve = not cfg.stage_shortcuts
                self.add_module(f"up_{i}_us", WanUpsample(c, temporal_up[i], halve=halve,
                                                          dtype=dt))
                c = c // 2 if halve else c
        self.head_norm = RMSNorm3d(c)
        self.head_conv = CausalConv3d(c, 3 * cfg.patch ** 2)

    def forward(self, z):
        cfg, dims, temporal_up = self.cfg, self.dims, self.temporal_up
        h = self.conv1(z)
        h = self.mid_block_2(self.mid_attn(self.mid_block_1(h)))
        for i in range(len(cfg.dim_mult)):
            h_in = h
            for j in range(cfg.num_res_blocks + 1):
                h = getattr(self, f"up_{i}_block_{j}")(h)
            if i != len(cfg.dim_mult) - 1:
                h = getattr(self, f"up_{i}_us")(h)
                if cfg.stage_shortcuts:  # Wan2.2 Up_ResidualBlock dup path
                    ft = 2 if temporal_up[i] else 1
                    h = h + _dup_up3d(h_in, dims[i + 1], ft, 2).to(h.dtype)
        out = self.head_conv(F.silu(self.head_norm(h)).float())
        return _unpatchify(out, cfg.patch)


class WanVAE(nn.Module):
    """encode(pixels, generator=None) -> normalized latent; decode -> pixels.

    Pixel videos are (B, 3, T, H, W) in [-1, 1] with T = 1 + 4k (T = 1 is
    the image case); latents are (B, z, 1 + k, H/s, W/s) with s = 8 for
    Wan2.1 and 16 for Wan2.2, normalized per channel when the config
    carries latents_mean/std."""

    def __init__(self, cfg: WanVAEConfig):
        super().__init__()
        self.cfg = cfg
        z = cfg.z_channels
        self.encoder = WanVAEEncoder(cfg)
        self.quant_conv = CausalConv3d(2 * z, 2 * z, (1, 1, 1))
        self.post_quant_conv = CausalConv3d(z, z, (1, 1, 1))
        self.decoder = WanVAEDecoder(cfg)

    def _norm(self, device):
        cfg = self.cfg
        if cfg.latents_mean is None:
            return None
        shape = (1, -1, 1, 1, 1)
        return (torch.tensor(cfg.latents_mean, device=device).reshape(shape),
                torch.tensor(cfg.latents_std, device=device).reshape(shape))

    def encode(self, x_pixels, generator: Optional[torch.Generator] = None):
        """The posterior mean, or a sample of it drawn from `generator`
        (log-variance clipped to [-30, 20]), normalized per channel."""
        x = x_pixels.permute(0, 2, 3, 4, 1).contiguous().to(self.cfg.dtype)
        moments = self.quant_conv(self.encoder(x)).permute(0, 4, 1, 2, 3)
        mean, logvar = moments.chunk(2, dim=1)
        if generator is not None:
            logvar = torch.clamp(logvar, -30.0, 20.0)
            eps = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                              device=mean.device)
            mean = mean + torch.exp(0.5 * logvar) * eps
        norm = self._norm(mean.device)
        return mean if norm is None else (mean - norm[0]) / norm[1]

    def decode(self, latent):
        norm = self._norm(latent.device)
        z = latent if norm is None else latent * norm[1] + norm[0]
        z = z.permute(0, 2, 3, 4, 1).float().contiguous()
        out = self.decoder(self.post_quant_conv(z).to(self.cfg.dtype))
        return out.permute(0, 4, 1, 2, 3)

    def forward(self, x_pixels, generator: Optional[torch.Generator] = None):
        return self.decode(self.encode(x_pixels, generator))
