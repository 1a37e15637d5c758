"""Wan2.2 video DiT: 3D-patchified flow-matching transformer.

PyTorch counterpart of `lanpaint_tpu/models/wan.py` (the public Wan2.x
design): a (1, 2, 2) patchify of the temporal latent, self-attention with 3D
RoPE over (frame, y, x), cross-attention to T5 text features, AdaLN time
modulation with per-block learned offsets.  Tokens are (B, F*H*W, hidden);
compute in `cfg.dtype` (bf16 by default); the adaLN pre-norms return fp32
and the modulation runs in the dtype `residual_dtype` gives it (fp32 when
None) before the downcast; each block's output is cast back to the token
dtype, as the JAX module's scan carry is; the head projects in fp32.
Submodule names follow the flax module names, with the scanned blocks as
`blocks.<i>`, so models/bridge.py maps a flax tree onto the state_dict one
to one.

Kernels on CUDA: self-attention through `layers.attention_bshd` (at
TI2V-5B's S = 7,920, D = 128 the flash-attention kernel, the ragged tail
masked in the kernel); `norm1` / `norm2` / the head's `layernorm_na` and
`norm3`'s `LayerNormF32` through the row-norm kernel; and `_WanQKNorm`,
RMS over the full projection width before the head reshape, through the
same row-norm kernel in its RMS mode with a scale (`ops.norms.rmsnorm`, one
launch, counted in `rmsnorm.launches`).  Cross-attention over the 512 text
tokens (Sk != S) takes `attention_ref`, as the JAX package leaves it to XLA.

Not ported: sequence and tensor parallelism (`seq_axis`, `tp_axis`,
`tp_size`; ROADMAP A.19).  The config keeps the fields and the model raises
NotImplementedError when any is set.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norms import rmsnorm
from .layers import (
    LayerNormF32,
    Linear,
    MLPEmbedder,
    apply_rope,
    attention_bshd,
    layernorm_na,
    rope_freqs,
    timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class WanConfig:
    in_channels: int = 16
    out_channels: int = 16
    hidden: int = 5120
    num_heads: int = 40
    depth: int = 40
    ffn_dim: int = 13824
    context_dim: int = 4096      # umt5-xxl features
    patch: Tuple[int, int, int] = (1, 2, 2)
    axes_dim: Tuple[int, ...] = (44, 42, 42)  # (frame, y, x) RoPE split
    eps: float = 1e-6
    seq_axis: Optional[str] = None
    tp_axis: Optional[str] = None
    tp_size: int = 1
    dtype: torch.dtype = torch.bfloat16
    # dtype of the adaLN modulation inside each block; None = float32
    residual_dtype: Optional[torch.dtype] = None

    @property
    def head_dim(self) -> int:
        return self.hidden // self.num_heads


# The configurations of lanpaint_tpu/models/wan.py, which documents each
# one's source.
WAN22_T2V_14B_CONFIG = WanConfig(residual_dtype=torch.bfloat16)
WAN22_TI2V_5B_CONFIG = WanConfig(in_channels=48, out_channels=48, hidden=3072, num_heads=24,
                                 depth=30, ffn_dim=14336, axes_dim=(44, 42, 42),
                                 residual_dtype=torch.bfloat16)
TINY_WAN_CONFIG = WanConfig(in_channels=4, out_channels=4, hidden=64, num_heads=4, depth=2,
                            ffn_dim=128, context_dim=32, axes_dim=(8, 4, 4))


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # flax nn.gelu's default


class _WanQKNorm(nn.Module):
    """RMSNorm over the FULL projection width, before the head reshape
    (public Wan semantics; checkpoint weight shape (dim,)): fp32
    statistics, output in the input dtype, through the row-norm kernel on
    CUDA.  The flax leaf `scale` maps to `weight`."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return rmsnorm(x, self.weight, self.eps)


class WanSelfAttention(nn.Module):
    def __init__(self, cfg: WanConfig):
        super().__init__()
        self.cfg = cfg
        h, dt = cfg.hidden, cfg.dtype
        self.q, self.k, self.v, self.o = (Linear(h, h, compute_dtype=dt) for _ in range(4))
        self.norm_q = _WanQKNorm(h, cfg.eps)
        self.norm_k = _WanQKNorm(h, cfg.eps)

    def forward(self, x, pe):
        cfg = self.cfg
        heads = (cfg.num_heads, cfg.head_dim)
        q = apply_rope(self.norm_q(self.q(x)).unflatten(-1, heads), pe)
        k = apply_rope(self.norm_k(self.k(x)).unflatten(-1, heads), pe)
        v = self.v(x).unflatten(-1, heads)
        return self.o(attention_bshd(q, k, v).flatten(2))


class WanCrossAttention(nn.Module):
    def __init__(self, cfg: WanConfig):
        super().__init__()
        self.cfg = cfg
        h, dt = cfg.hidden, cfg.dtype
        self.q, self.k, self.v, self.o = (Linear(h, h, compute_dtype=dt) for _ in range(4))
        self.norm_q = _WanQKNorm(h, cfg.eps)
        self.norm_k = _WanQKNorm(h, cfg.eps)

    def kv(self, context):
        """(k, v), each (B, T_text, hidden): the context-only slice, which
        WanModel.precompute_kv hoists out of the sampling loops."""
        return self.norm_k(self.k(context)), self.v(context)

    def forward(self, x, context, kv_pre=None):
        """`kv_pre`: an optional precomputed (k, v) pair (WanModel.precompute_kv),
        bit-identical to computing it here from `context`."""
        cfg = self.cfg
        heads = (cfg.num_heads, cfg.head_dim)
        q = self.norm_q(self.q(x)).unflatten(-1, heads)
        k, v = self.kv(context) if kv_pre is None else kv_pre
        k, v = (t.to(cfg.dtype).unflatten(-1, heads) for t in (k, v))
        return self.o(attention_bshd(q, k, v).flatten(2))


class WanBlock(nn.Module):
    def __init__(self, cfg: WanConfig):
        super().__init__()
        self.cfg = cfg
        h, dt = cfg.hidden, cfg.dtype
        self.modulation = nn.Parameter(torch.zeros(1, 6, h))
        self.self_attn = WanSelfAttention(cfg)
        self.norm3 = LayerNormF32(h, cfg.eps)
        self.cross_attn = WanCrossAttention(cfg)
        self.ffn_0 = Linear(h, cfg.ffn_dim, compute_dtype=dt)
        self.ffn_2 = Linear(cfg.ffn_dim, h, compute_dtype=dt)

    def forward(self, x, e, context, pe, kv_pre=None):
        """e: (B, 6, hidden) time modulation; the block's learned offset is
        added in fp32, then cast to the modulation dtype."""
        cfg, dt = self.cfg, self.cfg.dtype
        rdt = torch.float32 if cfg.residual_dtype is None else cfg.residual_dtype
        e = (self.modulation.float() + e.float()).to(rdt)
        sh1, sc1, g1, sh2, sc2, g2 = (e[:, i][:, None] for i in range(6))
        xn = layernorm_na(x, cfg.eps) * (1 + sc1) + sh1
        x = x + g1 * self.self_attn(xn.to(dt), pe)
        x = x + self.cross_attn(self.norm3(x).to(dt), context, kv_pre=kv_pre)
        xn = layernorm_na(x, cfg.eps) * (1 + sc2) + sh2
        return x + g2 * self.ffn_2(_gelu(self.ffn_0(xn.to(dt))))


def video_ids(b: int, f: int, h: int, w: int, frame_offset: int = 0, device=None) -> torch.Tensor:
    """(B, F*H*W, 3) position ids over the (frame, y, x) token grid."""
    fs = (torch.arange(f, device=device) + frame_offset).repeat_interleave(h * w)
    ys = torch.arange(h, device=device).repeat_interleave(w).repeat(f)
    xs = torch.arange(w, device=device).repeat(f * h)
    return torch.stack([fs, ys, xs], dim=-1)[None].expand(b, -1, -1)


class WanModel(nn.Module):
    """forward(x_ncfhw, t, context, kv_cache=None) -> velocity (B, C, F, H, W)."""

    def __init__(self, cfg: WanConfig):
        super().__init__()
        if cfg.seq_axis is not None or cfg.tp_axis is not None or cfg.tp_size != 1:
            raise NotImplementedError("sequence and tensor parallelism (seq_axis, tp_axis, "
                                      "tp_size) are not ported (ROADMAP A.19)")
        self.cfg = cfg
        h, dt = cfg.hidden, cfg.dtype
        pf, ph, pw = cfg.patch
        self.patch_embedding = Linear(cfg.in_channels * pf * ph * pw, h, compute_dtype=dt)
        self.text_embedding_0 = Linear(cfg.context_dim, h, compute_dtype=dt)
        self.text_embedding_2 = Linear(h, h, compute_dtype=dt)
        self.time_embedding = MLPEmbedder(256, h, dtype=dt)
        self.time_projection = Linear(h, 6 * h, compute_dtype=dt)
        self.blocks = nn.ModuleList(WanBlock(cfg) for _ in range(cfg.depth))
        self.head_modulation = nn.Parameter(torch.zeros(1, 2, h))
        self.head = Linear(h, cfg.out_channels * pf * ph * pw, compute_dtype=torch.float32)

    def embed_text(self, context):
        dt = self.cfg.dtype
        return self.text_embedding_2(_gelu(self.text_embedding_0(context.to(dt))))

    def precompute_kv(self, context):
        """Run-constant cross-attention hoist: the text embedding and every
        block's cross-attention k (with norm_k) and v, computed once per
        sampler call with the same submodules as the forward (so the values
        are bit-identical to the in-forward path).  Returns {"k", "v"}, each
        (B, depth, T_text, hidden), batch-major so a batched-CFG cond concat
        composes."""
        ctx = self.embed_text(context)
        kvs = [block.cross_attn.kv(ctx) for block in self.blocks]
        return {"k": torch.stack([k for k, _ in kvs], dim=1),
                "v": torch.stack([v for _, v in kvs], dim=1)}

    def forward(self, x, t, context, kv_cache=None):
        cfg, dt = self.cfg, self.cfg.dtype
        b, c, f, hh, ww = x.shape
        pf, ph, pw = cfg.patch
        gf, gh, gw = f // pf, hh // ph, ww // pw
        xt = x.reshape(b, c, gf, pf, gh, ph, gw, pw).permute(0, 2, 4, 6, 1, 3, 5, 7)
        tokens = self.patch_embedding(xt.reshape(b, gf * gh * gw, c * pf * ph * pw).to(dt))

        t = torch.as_tensor(t, device=x.device).float().reshape(-1)
        te = self.time_embedding(timestep_embedding(t * 1000.0, 256).to(dt))
        e6 = self.time_projection(F.silu(te)).reshape(b, 6, cfg.hidden)
        pe = rope_freqs(video_ids(b, gf, gh, gw, device=x.device), cfg.axes_dim)

        ctx = None if kv_cache is not None else self.embed_text(context)
        for i, block in enumerate(self.blocks):
            kv_pre = None if kv_cache is None else (kv_cache["k"][:, i], kv_cache["v"][:, i])
            tokens = block(tokens, e6, ctx, pe, kv_pre=kv_pre).to(tokens.dtype)

        he = self.head_modulation.float() + te.float()[:, None]
        sh, sc = he[:, 0][:, None], he[:, 1][:, None]
        out = self.head((layernorm_na(tokens, cfg.eps) * (1 + sc) + sh).float())
        out = out.reshape(b, gf, gh, gw, cfg.out_channels, pf, ph, pw)
        return out.permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(b, cfg.out_channels, f, hh, ww)
