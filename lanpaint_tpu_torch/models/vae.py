"""AutoencoderKL (the LDM/SGM image VAE): pixel <-> latent.

PyTorch counterpart of `lanpaint_tpu/models/vae.py`: the public
AutoencoderKL graph (conv encoder and decoder of GroupNorm ResNet blocks
with one mid attention each), configs for the 4-channel SD1.x/SD2.x/SDXL
family and the 16-channel SD3/Flux family (same graph; z width, scaling and
the quant convs differ).

Layout is NCHW.  Convolutions compute in the config's dtype (bf16 by
default) with fp32 GroupNorm statistics; the encoder's `conv_out` and
`quant_conv` and the decoder's `conv_out` compute in fp32, as the JAX
module's do.  The LDM downsample pads (0, 1) on the bottom and right before
a stride-2 VALID convolution; the upsample is nearest x2.

The mid attention is one head of D = C = 512 over the H/8 x W/8 grid
(16,384 tokens at 1024^2).  Its q/k/v are three dense projections of the
channels-last (B, S, C) map, each a contiguous (B, S, 1, C) tensor with a
unit-stride head dim, which `attention_bshd` sends to the wide-head
attention kernel on CUDA (ops/attention.py) without a further copy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, GroupNorm32, attention_bshd


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 4
    scale_factor: float = 0.18215   # SD1.x/2.x
    shift_factor: float = 0.0
    quant_conv: bool = True         # SD family; absent in the SD3/Flux VAEs
    dtype: torch.dtype = torch.bfloat16


SD_VAE_CONFIG = VAEConfig()
SDXL_VAE_CONFIG = VAEConfig(scale_factor=0.13025)
FLUX_VAE_CONFIG = VAEConfig(z_channels=16, scale_factor=0.3611,
                            shift_factor=0.1159, quant_conv=False)
SD3_VAE_CONFIG = VAEConfig(z_channels=16, scale_factor=1.5305,
                           shift_factor=0.0609, quant_conv=False)
TINY_VAE_CONFIG = VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4)


class VAEResBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = GroupNorm32(in_ch)
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1, compute_dtype=dtype)
        self.norm2 = GroupNorm32(out_ch)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1, compute_dtype=dtype)
        self.nin_shortcut = (Conv2d(in_ch, out_ch, 1, compute_dtype=dtype)
                             if in_ch != out_ch else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


def _dense(conv: Conv2d, x):
    """A 1x1 convolution applied as a dense layer to channels-last (B, S, C)."""
    dt = conv.compute_dtype
    w = conv.weight.to(dt).reshape(conv.out_channels, conv.in_channels)
    return F.linear(x.to(dt), w, conv.bias.to(dt))


class VAEAttnBlock(nn.Module):
    """Single-head self-attention over the spatial grid, residual."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = GroupNorm32(channels)
        self.q, self.k, self.v, self.proj_out = (
            Conv2d(channels, channels, 1, compute_dtype=dtype) for _ in range(4))

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        q, k, v = (_dense(conv, h).view(b, hh * ww, 1, c) for conv in (self.q, self.k, self.v))
        o = _dense(self.proj_out, attention_bshd(q, k, v).reshape(b, hh * ww, c))
        return x + o.view(b, hh, ww, c).permute(0, 3, 1, 2)


class VAEEncoder(nn.Module):
    """(B, 3, H, W) in [-1, 1] -> (B, 2*z, H/2^(L-1), W/2^(L-1)) moments."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        self.conv_in = Conv2d(3, cfg.ch, 3, padding=1, compute_dtype=dt)
        ch = cfg.ch
        for level, mult in enumerate(cfg.ch_mult):
            for j in range(cfg.num_res_blocks):
                self.add_module(f"down_{level}_block_{j}", VAEResBlock(ch, cfg.ch * mult, dt))
                ch = cfg.ch * mult
            if level != len(cfg.ch_mult) - 1:
                self.add_module(f"down_{level}_ds", Conv2d(ch, ch, 3, stride=2,
                                                           compute_dtype=dt))
        self.mid_block_1 = VAEResBlock(ch, ch, dt)
        self.mid_attn_1 = VAEAttnBlock(ch, dt)
        self.mid_block_2 = VAEResBlock(ch, ch, dt)
        self.norm_out = GroupNorm32(ch)
        self.conv_out = Conv2d(ch, 2 * cfg.z_channels, 3, padding=1)
        self.quant_conv = Conv2d(2 * cfg.z_channels, 2 * cfg.z_channels, 1) \
            if cfg.quant_conv else None

    def forward(self, x_pixels):
        cfg = self.cfg
        h = self.conv_in(x_pixels.to(cfg.dtype))
        for level in range(len(cfg.ch_mult)):
            for j in range(cfg.num_res_blocks):
                h = getattr(self, f"down_{level}_block_{j}")(h)
            if level != len(cfg.ch_mult) - 1:
                # asymmetric pad + stride-2 VALID conv (the LDM VAE downsample)
                h = getattr(self, f"down_{level}_ds")(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        h = self.conv_out(F.silu(self.norm_out(h)).float())
        if self.quant_conv is not None:
            h = self.quant_conv(h)
        return h


class VAEDecoder(nn.Module):
    """(B, z, h, w) unscaled latent -> (B, 3, h*2^(L-1), w*2^(L-1)) pixels."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        self.post_quant_conv = (Conv2d(cfg.z_channels, cfg.z_channels, 1, compute_dtype=dt)
                                if cfg.quant_conv else None)
        ch = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = Conv2d(cfg.z_channels, ch, 3, padding=1, compute_dtype=dt)
        self.mid_block_1 = VAEResBlock(ch, ch, dt)
        self.mid_attn_1 = VAEAttnBlock(ch, dt)
        self.mid_block_2 = VAEResBlock(ch, ch, dt)
        for level in reversed(range(len(cfg.ch_mult))):
            for j in range(cfg.num_res_blocks + 1):
                self.add_module(f"up_{level}_block_{j}",
                                VAEResBlock(ch, cfg.ch * cfg.ch_mult[level], dt))
                ch = cfg.ch * cfg.ch_mult[level]
            if level != 0:
                self.add_module(f"up_{level}_us", Conv2d(ch, ch, 3, padding=1,
                                                         compute_dtype=dt))
        self.norm_out = GroupNorm32(ch)
        self.conv_out = Conv2d(ch, 3, 3, padding=1)

    def forward(self, z):
        cfg = self.cfg
        h = z.to(cfg.dtype)
        if self.post_quant_conv is not None:
            h = self.post_quant_conv(h)
        h = self.conv_in(h)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        for level in reversed(range(len(cfg.ch_mult))):
            for j in range(cfg.num_res_blocks + 1):
                h = getattr(self, f"up_{level}_block_{j}")(h)
            if level != 0:
                h = getattr(self, f"up_{level}_us")(F.interpolate(h, scale_factor=2,
                                                                  mode="nearest"))
        return self.conv_out(F.silu(self.norm_out(h)).float())


class VAE(nn.Module):
    """encode(pixels, generator=None) -> scaled latent; decode(latent) -> pixels."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = VAEEncoder(cfg)
        self.decoder = VAEDecoder(cfg)

    def encode(self, x_pixels, generator: Optional[torch.Generator] = None):
        """The posterior mean, or a sample of it drawn from `generator`
        (log-variance clipped to [-30, 20]), as (mean - shift) * scale."""
        cfg = self.cfg
        mean, logvar = self.encoder(x_pixels).chunk(2, dim=1)
        if generator is not None:
            logvar = torch.clamp(logvar, -30.0, 20.0)
            eps = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                              device=mean.device)
            mean = mean + torch.exp(0.5 * logvar) * eps
        return (mean - cfg.shift_factor) * cfg.scale_factor

    def decode(self, latent):
        cfg = self.cfg
        return self.decoder(latent / cfg.scale_factor + cfg.shift_factor)

    def forward(self, x_pixels, generator: Optional[torch.Generator] = None):
        return self.decode(self.encode(x_pixels, generator))
