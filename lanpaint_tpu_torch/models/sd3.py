"""SD3 / SD3.5 MMDiT backbone (rectified flow) as a torch module.

PyTorch counterpart of `lanpaint_tpu/models/sd3.py` (the public MMDiT-X):
a conv patch embed with a learned positional embedding cropped about the
grid's centre (no RoPE), joint blocks whose context and x streams
(`DismantledBlock`) share one attention over [ctx; x], per-head RMS
`ln_q` / `ln_k` (SD3.5), a pre-only context block in the last layer (it
gives k and v, and no context output), SD3.5-Medium's second x-only
self-attention on a prefix of dual-attention layers, and an AdaLN final
layer whose projection runs in fp32.

Depth runs in the three groups of the flax scans, named as they are so
that models/bridge.py maps a flax tree one to one: `joint_dual.<i>` (the
dual-attention prefix), `joint.<i>` (the plain middle) and `joint_last`.
Compute in `cfg.dtype` (bf16 by default); the blocks' affine-free
LayerNorms are `layers.layernorm_centred`, the JAX module's `_layernorm`
(plain jnp there, not its row-norm kernel); the modulation runs in fp32
before the downcast.

Kernels on CUDA: the joint and the dual self-attention through
`layers.attention_bshd` (SD3.5-Large at 1024^2: S = n_ctx + 4,096, H = 38,
D = 64), and `ln_q` / `ln_k` through the row-norm kernel, in place on the
strided q / k column views of the fused `qkv` projection (rows (B*S, H),
row stride 3 * hidden).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .dit import _gelu, _modulate
from .layers import (Conv2d, Linear, MLPEmbedder, RMSNorm, attention_bshd, layernorm_centred,
                     timestep_embedding)


@dataclasses.dataclass(frozen=True)
class SD3Config:
    in_channels: int = 16
    patch: int = 2
    hidden: int = 2432            # = 64 * depth
    depth: int = 38
    num_heads: int = 38
    mlp_ratio: float = 4.0
    context_dim: int = 4096       # T5-XXL (+ zero-padded CLIP) features
    vec_dim: int = 2048           # CLIP-L + CLIP-G pooled
    pos_embed_max: int = 192      # learned pos-embed grid side
    qk_norm: bool = True          # SD3.5 (3.0 medium ships without)
    dual_attn_layers: Tuple[int, ...] = ()  # SD3.5-Medium MMDiT-X prefix
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden // self.num_heads


# The configurations of lanpaint_tpu/models/sd3.py.
SD35_LARGE_CONFIG = SD3Config()
SD35_LARGE_TURBO_CONFIG = SD35_LARGE_CONFIG  # the same graph, distilled weights
SD35_MEDIUM_CONFIG = SD3Config(
    hidden=1536, depth=24, num_heads=24, pos_embed_max=384,
    dual_attn_layers=tuple(range(13)),
)
SD3_MEDIUM_CONFIG = SD3Config(hidden=1536, depth=24, num_heads=24, qk_norm=False)
TINY_SD3_CONFIG = SD3Config(
    in_channels=4, hidden=64, depth=4, num_heads=4, context_dim=32,
    vec_dim=16, pos_embed_max=16, dual_attn_layers=(0,),
)


class _SelfAttnPre(nn.Module):
    """qkv projection and the optional per-head RMS q/k norm -> (q, k, v)
    BSHD, q and k normalized in place of the fused projection's columns."""

    def __init__(self, cfg: SD3Config):
        super().__init__()
        self.cfg = cfg
        self.qkv = Linear(cfg.hidden, 3 * cfg.hidden, compute_dtype=cfg.dtype)
        if cfg.qk_norm:
            self.ln_q = RMSNorm(cfg.head_dim)
            self.ln_k = RMSNorm(cfg.head_dim)

    def forward(self, x):
        cfg = self.cfg
        q, k, v = (t.unflatten(-1, (cfg.num_heads, cfg.head_dim))
                   for t in self.qkv(x).chunk(3, dim=-1))
        if cfg.qk_norm:
            q, k = self.ln_q(q), self.ln_k(k)
        return q, k, v


class DismantledBlock(nn.Module):
    """One stream of a joint block: AdaLN modulation, the attention's pre
    and post halves, the MLP.  `pre_only` is the last context block (k/v
    only); `dual_attn` adds the MMDiT-X second self-attention over x."""

    def __init__(self, cfg: SD3Config, pre_only: bool = False, dual_attn: bool = False):
        super().__init__()
        self.cfg = cfg
        self.pre_only = pre_only
        self.dual_attn = dual_attn
        h, dt = cfg.hidden, cfg.dtype
        n = 2 if pre_only else (9 if dual_attn else 6)
        self.adaLN_modulation = Linear(h, n * h, compute_dtype=dt)
        self.attn = _SelfAttnPre(cfg)
        if dual_attn:
            self.attn2 = _SelfAttnPre(cfg)
            self.attn2_proj = Linear(h, h, compute_dtype=dt)
        if not pre_only:
            self.attn_proj = Linear(h, h, compute_dtype=dt)
            mlp_h = int(h * cfg.mlp_ratio)
            self.mlp_fc1 = Linear(h, mlp_h, compute_dtype=dt)
            self.mlp_fc2 = Linear(mlp_h, h, compute_dtype=dt)

    def pre(self, x, c):
        """-> (q, k, v) and the state for `post`."""
        dt = self.cfg.dtype
        mod = self.adaLN_modulation(F.silu(c))[:, None, :]
        parts = mod.chunk(mod.shape[-1] // self.cfg.hidden, dim=-1)
        xn = layernorm_centred(x)
        qkv = self.attn(_modulate(xn, parts[0], parts[1]).to(dt))
        qkv2 = self.attn2(_modulate(xn, parts[6], parts[7]).to(dt)) if self.dual_attn else None
        return qkv, (parts, qkv2)

    def post(self, x, attn_out, state):
        parts, qkv2 = state
        x = x + parts[2] * self.attn_proj(attn_out)
        if self.dual_attn:
            a2 = attention_bshd(*qkv2)
            x = x + parts[8] * self.attn2_proj(a2.flatten(2))
        h = self.mlp_fc1(_modulate(layernorm_centred(x), parts[3], parts[4]).to(self.cfg.dtype))
        return x + parts[5] * self.mlp_fc2(_gelu(h))


class JointBlock(nn.Module):
    """A context / x pair of dismantled blocks with one joint attention
    over [ctx; x]."""

    def __init__(self, cfg: SD3Config, pre_only_ctx: bool = False, dual_attn: bool = False):
        super().__init__()
        self.pre_only_ctx = pre_only_ctx
        self.context_block = DismantledBlock(cfg, pre_only=pre_only_ctx)
        self.x_block = DismantledBlock(cfg, dual_attn=dual_attn)

    def forward(self, x, ctx, c):
        (cq, ck, cv), cstate = self.context_block.pre(ctx, c)
        (xq, xk, xv), xstate = self.x_block.pre(x, c)
        n_ctx = ctx.shape[1]
        attn = attention_bshd(torch.cat([cq, xq], dim=1), torch.cat([ck, xk], dim=1),
                              torch.cat([cv, xv], dim=1)).flatten(2)
        x = self.x_block.post(x, attn[:, n_ctx:], xstate)
        if not self.pre_only_ctx:
            ctx = self.context_block.post(ctx, attn[:, :n_ctx], cstate)
        return x, ctx


class SD3FinalLayer(nn.Module):
    def __init__(self, cfg: SD3Config):
        super().__init__()
        self.adaLN_modulation = Linear(cfg.hidden, 2 * cfg.hidden, compute_dtype=cfg.dtype)
        self.linear = Linear(cfg.hidden, cfg.patch * cfg.patch * cfg.in_channels,
                             compute_dtype=torch.float32)

    def forward(self, x, c):
        shift, scale = self.adaLN_modulation(F.silu(c))[:, None, :].chunk(2, dim=-1)
        return self.linear(_modulate(layernorm_centred(x), shift, scale).float())


class SD3MMDiT(nn.Module):
    """forward(x_nchw_latent, t, context, vec) -> velocity prediction."""

    def __init__(self, cfg: SD3Config):
        super().__init__()
        self.cfg = cfg
        h, dt = cfg.hidden, cfg.dtype
        n_dual = len(cfg.dual_attn_layers)
        if cfg.dual_attn_layers != tuple(range(n_dual)):
            raise ValueError("only a contiguous dual-attention prefix is supported (the "
                             "MMDiT-X layout)")
        self.x_embedder = Conv2d(cfg.in_channels, h, cfg.patch, stride=cfg.patch,
                                 compute_dtype=dt)
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.pos_embed_max ** 2, h))
        self.t_embedder = MLPEmbedder(256, h, dtype=dt)
        if cfg.vec_dim > 0:
            self.y_embedder = MLPEmbedder(cfg.vec_dim, h, dtype=dt)
        self.context_embedder = Linear(cfg.context_dim, h, compute_dtype=dt)
        self.joint_dual = nn.ModuleList(JointBlock(cfg, dual_attn=True) for _ in range(n_dual))
        self.joint = nn.ModuleList(JointBlock(cfg) for _ in range(cfg.depth - 1 - n_dual))
        self.joint_last = JointBlock(cfg, pre_only_ctx=True)
        self.final_layer = SD3FinalLayer(cfg)

    def cropped_pos_embed(self, gh: int, gw: int) -> torch.Tensor:
        """The (1, gh * gw, hidden) centre crop of the learned grid."""
        m, h = self.cfg.pos_embed_max, self.cfg.hidden
        top, left = (m - gh) // 2, (m - gw) // 2
        pos = self.pos_embed.reshape(1, m, m, h)[:, top:top + gh, left:left + gw]
        return pos.reshape(1, gh * gw, h)

    def forward(self, x, t, context, vec=None):
        cfg, dt = self.cfg, self.cfg.dtype
        p = cfg.patch
        b, _, hh, ww = x.shape
        gh, gw = hh // p, ww // p
        img = self.x_embedder(x).flatten(2).transpose(1, 2)
        img = img + self.cropped_pos_embed(gh, gw).to(dt)

        t = torch.as_tensor(t, device=x.device).float().reshape(-1)
        c = self.t_embedder(timestep_embedding(t * 1000.0, 256).to(dt))
        if cfg.vec_dim > 0 and vec is not None:
            c = c + self.y_embedder(vec.to(dt))
        ctx = self.context_embedder(context.to(dt))

        for block in (*self.joint_dual, *self.joint):
            img, ctx = block(img, ctx, c)
        img, _ = self.joint_last(img, ctx, c)

        out = self.final_layer(img, c)
        # unpatchify: (B, S, p*p*C) -> (B, C, H, W)
        out = out.reshape(b, gh, gw, p, p, cfg.in_channels).permute(0, 5, 1, 3, 2, 4)
        return out.reshape(b, cfg.in_channels, hh, ww)
