"""Stable-Diffusion UNet family (SD1.5 / SD2.x / SDXL) as a torch module.

PyTorch counterpart of `lanpaint_tpu/models/unet.py`, fused-QKV layout.
NCHW layout, compute in `config.dtype` (bf16 by default), GroupNorm in
fp32, the output convolution in fp32.  Submodule names follow the flax
module names (`down_1_0_attn`, `mid_res1`, ...) so models/bridge.py maps a
flax parameter tree onto this module's state_dict one to one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (
    Conv2d,
    Downsample,
    GroupNorm32,
    MLPEmbedder,
    ResBlock,
    SpatialTransformer,
    Upsample,
    timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    # transformer depth per resolution level; 0 = no attention at that level
    transformer_depth: Tuple[int, ...] = (1, 1, 1, 0)
    transformer_depth_middle: int = 1
    context_dim: int = 768
    # None => fixed num_heads (SD1.x); an int => fixed head_dim (SDXL: 64)
    head_dim: Optional[int] = None
    num_heads: int = 8
    # SDXL micro-conditioning: pooled text (1280) + 6x256 size embeds -> 2816
    adm_in_channels: Optional[int] = None
    dtype: torch.dtype = torch.bfloat16


SD15_CONFIG = UNetConfig()
SD21_CONFIG = UNetConfig(context_dim=1024, head_dim=64)
SDXL_CONFIG = UNetConfig(
    channel_mult=(1, 2, 4),
    transformer_depth=(0, 2, 10),
    transformer_depth_middle=10,
    context_dim=2048,
    head_dim=64,
    adm_in_channels=2816,
)
TINY_UNET_CONFIG = UNetConfig(  # test-size config
    model_channels=32,
    channel_mult=(1, 2),
    num_res_blocks=1,
    transformer_depth=(1, 1),
    transformer_depth_middle=1,
    context_dim=32,
    head_dim=16,
)


class UNetModel(nn.Module):
    """SD UNet.  forward(x_nchw, timesteps, context, y, kv_cache) -> eps."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        mc = cfg.model_channels
        emb_dim = mc * 4
        self.time_embed = MLPEmbedder(mc, emb_dim, dtype=dt)
        if cfg.adm_in_channels is not None:
            self.label_emb = MLPEmbedder(cfg.adm_in_channels, emb_dim, dtype=dt)
        self.input_conv = Conv2d(cfg.in_channels, mc, 3, padding=1, compute_dtype=dt)

        # (name, kind) in execution order; skip channel bookkeeping as in the
        # flax module, which infers input widths lazily
        self.down_plan = []
        skip_chs = [mc]
        ch_in = mc
        for level, mult in enumerate(cfg.channel_mult):
            ch = mc * mult
            for i in range(cfg.num_res_blocks):
                self.add_module(f"down_{level}_{i}_res", ResBlock(ch_in, ch, emb_dim, dtype=dt))
                attn = None
                if cfg.transformer_depth[level] > 0:
                    attn = f"down_{level}_{i}_attn"
                    self.add_module(attn, self._transformer(ch, cfg.transformer_depth[level]))
                self.down_plan.append((f"down_{level}_{i}_res", attn, None))
                ch_in = ch
                skip_chs.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self.add_module(f"down_{level}_ds", Downsample(ch, dtype=dt))
                self.down_plan.append((None, None, f"down_{level}_ds"))
                skip_chs.append(ch)

        ch = mc * cfg.channel_mult[-1]
        self.mid_res1 = ResBlock(ch_in, ch, emb_dim, dtype=dt)
        self.mid_attn = (self._transformer(ch, cfg.transformer_depth_middle)
                         if cfg.transformer_depth_middle > 0 else None)
        self.mid_res2 = ResBlock(ch, ch, emb_dim, dtype=dt)
        ch_in = ch

        self.up_plan = []
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            ch = mc * mult
            for i in range(cfg.num_res_blocks + 1):
                name = f"up_{level}_{i}_res"
                self.add_module(name, ResBlock(ch_in + skip_chs.pop(), ch, emb_dim, dtype=dt))
                attn = None
                if cfg.transformer_depth[level] > 0:
                    attn = f"up_{level}_{i}_attn"
                    self.add_module(attn, self._transformer(ch, cfg.transformer_depth[level]))
                self.up_plan.append((name, attn))
                ch_in = ch
            if level != 0:
                self.add_module(f"up_{level}_us", Upsample(ch, dtype=dt))
                self.up_plan.append((None, f"up_{level}_us"))

        self.out_norm = GroupNorm32(mc)
        self.out_conv = Conv2d(mc, cfg.out_channels, 3, padding=1,
                               compute_dtype=torch.float32)

    def _heads(self, ch: int) -> int:
        if self.cfg.head_dim is not None:
            return ch // self.cfg.head_dim
        return self.cfg.num_heads

    def _transformer(self, ch: int, depth: int) -> SpatialTransformer:
        return SpatialTransformer(ch, self.cfg.context_dim, self._heads(ch), depth=depth,
                                  dtype=self.cfg.dtype)

    def forward(self, x, timesteps, context, y=None, kv_cache=None):
        """`kv_cache`: optional dict SpatialTransformer name -> precomputed
        cross-attention k|v (B, depth, T, 2*ch), see zoo.unet_precompute_kv."""
        cfg = self.cfg
        kv_cache = kv_cache or {}
        x = x.to(cfg.dtype)
        context = context.to(cfg.dtype)
        emb = self.time_embed(timestep_embedding(timesteps, cfg.model_channels).to(cfg.dtype))
        if cfg.adm_in_channels is not None:
            if y is None:
                raise ValueError("SDXL UNet needs pooled conditioning y")
            emb = emb + self.label_emb(y.to(cfg.dtype))

        h = self.input_conv(x)
        skips = [h]
        for res, attn, ds in self.down_plan:
            if ds is not None:
                h = getattr(self, ds)(h)
            else:
                h = getattr(self, res)(h, emb)
                if attn is not None:
                    h = getattr(self, attn)(h, context, kv_pre=kv_cache.get(attn))
            skips.append(h)

        h = self.mid_res1(h, emb)
        if self.mid_attn is not None:
            h = self.mid_attn(h, context, kv_pre=kv_cache.get("mid_attn"))
        h = self.mid_res2(h, emb)

        for res, attn in self.up_plan:
            if res is None:
                h = getattr(self, attn)(h)  # upsample
                continue
            h = getattr(self, res)(torch.cat([h, skips.pop()], dim=1), emb)
            if attn is not None:
                h = getattr(self, attn)(h, context, kv_pre=kv_cache.get(attn))

        h = F.silu(self.out_norm(h))
        return self.out_conv(h.float())

    def spatial_transformers(self):
        """(name, SpatialTransformer) pairs, in registration order."""
        return [(n, m) for n, m in self.named_children() if isinstance(m, SpatialTransformer)]


def sdxl_pooled_y(pooled_text: torch.Tensor, height: int = 1024, width: int = 1024,
                  crop_h: int = 0, crop_w: int = 0, target_h: Optional[int] = None,
                  target_w: Optional[int] = None) -> torch.Tensor:
    """Assemble SDXL's 2816-dim micro-conditioning vector: pooled CLIP text
    (1280) + sinusoidal embeds of (orig_h, orig_w, crop_h, crop_w, target_h,
    target_w), 256 each."""
    target_h = height if target_h is None else target_h
    target_w = width if target_w is None else target_w
    b = pooled_text.shape[0]
    sizes = torch.tensor([[height, width, crop_h, crop_w, target_h, target_w]],
                         dtype=torch.float32, device=pooled_text.device).repeat(b, 1)
    embs = [timestep_embedding(sizes[:, i], 256) for i in range(6)]
    return torch.cat([pooled_text] + embs, dim=-1)
