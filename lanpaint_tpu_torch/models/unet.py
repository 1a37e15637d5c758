"""Stable-Diffusion UNet family (SD1.5 / SD2.x / SDXL) as a torch module.

PyTorch counterpart of `lanpaint_tpu/models/unet.py`, fused-QKV layout.
NCHW layout, compute in `config.dtype` (bf16 by default), GroupNorm in
fp32, the output convolution in fp32.  Submodule names follow the flax
module names (`down_1_0_attn`, `mid_res1`, ...) so models/bridge.py maps a
flax parameter tree onto this module's state_dict one to one.

Tensor and layer parallelism (`UNetModel(cfg, mesh, tp_axis=...,
layer_axis=...)`, over the process groups of a `parallel.make_mesh` mesh,
the weights cut by `parallel.unet_tp_rules`): the spatial transformers run
on a rank's heads (layers.SpatialTransformer), each whole where the axis
does not divide its head count; convolutions, GroupNorm and the time
embedding stay whole, as in the JAX package.  `zoo.build_unet(...,
mesh=...)` builds the denoiser.

On the card a whole model's forward replays as a CUDA graph, one a
signature of its inputs (`models/graphs.py`): its ~2,550 launches at SDXL
are issued as one.  `.to(...)`, `load_state_dict` and the like drop the
graphs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import NO_AXIS, Axis, axis_of
from . import graphs
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


def _transformer(cfg: UNetConfig, ch: int, depth: int, tp: Axis = NO_AXIS,
                 layers: Axis = NO_AXIS) -> SpatialTransformer:
    heads = ch // cfg.head_dim if cfg.head_dim is not None else cfg.num_heads
    return SpatialTransformer(ch, cfg.context_dim, heads, depth=depth, dtype=cfg.dtype, tp=tp,
                              layers=layers)


def build_encoder(module: nn.Module, cfg: UNetConfig, tp: Axis = NO_AXIS,
                  layers: Axis = NO_AXIS) -> tuple:
    """Register the encoder half that the UNet and its ControlNet share on
    `module`, under the flax module names: the time (and label) embedding,
    the input conv, the down path's blocks and the middle block.  Returns
    (the down path as (res, attn, downsample) names in execution order,
    the channels of every skip in production order)."""
    dt = cfg.dtype
    mc = cfg.model_channels
    emb_dim = mc * 4
    module.time_embed = MLPEmbedder(mc, emb_dim, dtype=dt)
    if cfg.adm_in_channels is not None:
        module.label_emb = MLPEmbedder(cfg.adm_in_channels, emb_dim, dtype=dt)
    module.input_conv = Conv2d(cfg.in_channels, mc, 3, padding=1, compute_dtype=dt)

    # skip channel bookkeeping as in the flax module, which infers input
    # widths lazily
    plan = []
    skip_chs = [mc]
    ch_in = mc
    for level, mult in enumerate(cfg.channel_mult):
        ch = mc * mult
        for i in range(cfg.num_res_blocks):
            module.add_module(f"down_{level}_{i}_res", ResBlock(ch_in, ch, emb_dim, dtype=dt))
            attn = None
            if cfg.transformer_depth[level] > 0:
                attn = f"down_{level}_{i}_attn"
                module.add_module(attn, _transformer(cfg, ch, cfg.transformer_depth[level], tp,
                                                     layers))
            plan.append((f"down_{level}_{i}_res", attn, None))
            ch_in = ch
            skip_chs.append(ch)
        if level != len(cfg.channel_mult) - 1:
            module.add_module(f"down_{level}_ds", Downsample(ch, dtype=dt))
            plan.append((None, None, f"down_{level}_ds"))
            skip_chs.append(ch)

    ch = mc * cfg.channel_mult[-1]
    module.mid_res1 = ResBlock(ch_in, ch, emb_dim, dtype=dt)
    module.mid_attn = (_transformer(cfg, ch, cfg.transformer_depth_middle, tp, layers)
                       if cfg.transformer_depth_middle > 0 else None)
    module.mid_res2 = ResBlock(ch, ch, emb_dim, dtype=dt)
    return plan, skip_chs


def embed(module: nn.Module, timesteps, y):
    """The time (plus label) embedding of a module `build_encoder` built."""
    cfg = module.cfg
    emb = module.time_embed(timestep_embedding(timesteps, cfg.model_channels).to(cfg.dtype))
    if cfg.adm_in_channels is not None:
        if y is None:
            raise ValueError("this UNet config needs pooled conditioning y (SDXL)")
        emb = emb + module.label_emb(y.to(cfg.dtype))
    return emb


class UNetModel(nn.Module):
    """SD UNet.  forward(x_nchw, timesteps, context, y, control, kv_cache) -> eps.

    `mesh` (a `parallel.make_mesh` DeviceMesh, or a `parallel.plan_mesh`
    to lay out one rank's state on the meta device) resolves `tp_axis`
    (the spatial transformers' tensor parallelism) and `layer_axis` (their
    blocks depth-sharded); without a mesh the model is whole."""

    def __init__(self, cfg: UNetConfig, mesh=None, tp_axis: Optional[str] = None,
                 layer_axis: Optional[str] = None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        mc = cfg.model_channels
        emb_dim = mc * 4
        tp, layers = axis_of(mesh, tp_axis), axis_of(mesh, layer_axis)
        self.down_plan, skip_chs = build_encoder(self, cfg, tp, layers)

        ch_in = mc * cfg.channel_mult[-1]
        self.up_plan = []
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            ch = mc * mult
            for i in range(cfg.num_res_blocks + 1):
                name = f"up_{level}_{i}_res"
                self.add_module(name, ResBlock(ch_in + skip_chs.pop(), ch, emb_dim, dtype=dt))
                attn = None
                if cfg.transformer_depth[level] > 0:
                    attn = f"up_{level}_{i}_attn"
                    self.add_module(attn, _transformer(cfg, ch, cfg.transformer_depth[level],
                                                       tp, layers))
                self.up_plan.append((name, attn))
                ch_in = ch
            if level != 0:
                self.add_module(f"up_{level}_us", Upsample(ch, dtype=dt))
                self.up_plan.append((None, f"up_{level}_us"))

        self.out_norm = GroupNorm32(mc)
        self.out_conv = Conv2d(mc, cfg.out_channels, 3, padding=1,
                               compute_dtype=torch.float32)
        self._whole = mesh is None
        self._graphs = graphs.Graphs()

    def forward(self, x, timesteps, context, y=None, control=None, kv_cache=None):
        """The forward (`_forward`), replayed as a CUDA graph where
        `graphs.Graphs` can (on the card, grad off) and the forward allows:
        no `control` and a model built without a mesh (its collectives run
        inside the forward)."""
        eager = control is not None or not self._whole
        return self._graphs(self._forward, x, timesteps, context, y, control, kv_cache,
                            eager=eager)

    def _apply(self, fn, recurse=True):
        self._graphs.clear()  # `.to(...)`, `.half()`: a graph holds the old weights
        return super()._apply(fn, recurse)

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        self._graphs.clear()
        return super().load_state_dict(state_dict, strict=strict, assign=assign)

    def _forward(self, x, timesteps, context, y=None, control=None, kv_cache=None):
        """`control` (ControlNet residual injection): optional dict with
        "input" (list added to each skip activation as it is produced),
        "middle" (added after the middle block) and/or "output" (list added
        to each skip as it is consumed in the up path).  Both lists are
        indexed by the skip's production order, so a ControlNet's
        encoder-order residuals plug into "output" directly; entries may be
        None and the lists shorter than the skips (missing entries add
        nothing); each residual is cast to the activation's dtype first.

        `kv_cache`: optional dict SpatialTransformer name -> precomputed
        cross-attention k|v (B, depth, T, 2*ch), see zoo.unet_precompute_kv."""
        cfg = self.cfg
        kv_cache = kv_cache or {}
        ctl_in = list((control or {}).get("input") or [])
        ctl_out = list((control or {}).get("output") or [])
        ctl_mid = (control or {}).get("middle")

        def add_ctl(h, entries, idx):
            if idx < len(entries) and entries[idx] is not None:
                h = h + entries[idx].to(h.dtype)
            return h

        x = x.to(cfg.dtype)
        context = context.to(cfg.dtype)
        emb = embed(self, timesteps, y)

        h = add_ctl(self.input_conv(x), ctl_in, 0)
        skips = [h]
        for res, attn, ds in self.down_plan:
            if ds is not None:
                h = getattr(self, ds)(h)
            else:
                h = getattr(self, res)(h, emb)
                if attn is not None:
                    h = getattr(self, attn)(h, context, kv_pre=kv_cache.get(attn))
            h = add_ctl(h, ctl_in, len(skips))
            skips.append(h)

        h = self.mid_res1(h, emb)
        if self.mid_attn is not None:
            h = self.mid_attn(h, context, kv_pre=kv_cache.get("mid_attn"))
        h = self.mid_res2(h, emb)
        if ctl_mid is not None:
            h = h + ctl_mid.to(h.dtype)

        for res, attn in self.up_plan:
            if res is None:
                h = getattr(self, attn)(h)  # upsample
                continue
            idx = len(skips) - 1
            skip = add_ctl(skips.pop(), ctl_out, idx)
            h = getattr(self, res)(torch.cat([h, skip], dim=1), emb)
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
