"""Neural building blocks of the SD UNet and the MMDiT, as torch `nn.Module`s.

PyTorch counterpart of the UNet and DiT subset of
`lanpaint_tpu/models/layers.py`.
Layout is NCHW for convolutions and (B, tokens, C) inside the spatial
transformers.  Parameters keep their stored dtype; every dense layer and
convolution casts inputs AND weights to the module's compute dtype first,
which is what flax `Dense(dtype=bf16)` does with fp32 parameters.
GroupNorm and the row norms compute their statistics in fp32.

Self-attention goes through `attention_bshd`, which takes the hand-written
attention kernels (ops/attention.py) where the JAX package takes its TPU
kernels, and every transformer LayerNorm and RMSNorm through the row-norm
kernel (ops/norms.py); the 77-token cross-attention, and self-attention
the JAX package leaves to XLA (S < 1024, or SD1.5's head dims), stay plain
PyTorch.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import WIDE_HEAD_DIMS, attention_ref, flash_attention, wide_attention
from ..ops.norms import layernorm, rmsnorm


def attention_bshd(q, k, v, scale: Optional[float] = None):
    """Multi-head attention on (B, S, H, D) tensors, routed by shape as the
    JAX package's `attention_bshd(impl="auto")` is: self-attention with
    S >= 1024 and D % 64 == 0 goes to a kernel on CUDA — `wide_attention`
    for D in WIDE_HEAD_DIMS (the VAEs' mid attention, D = 384, 512, 640), else
    `flash_attention` (which raises on a head dim it does not support) —
    anything else to `attention_ref`, where the JAX package leaves it to
    XLA."""
    s, d = q.shape[1], q.shape[3]
    if k.shape[1] == s and s >= 1024 and d % 64 == 0:
        kernel = wide_attention if d in WIDE_HEAD_DIMS else flash_attention
        return kernel(q, k, v, scale)
    return attention_ref(q, k, v, scale)


def layernorm_na(x, eps: float = 1e-6):
    """No-affine LayerNorm with fp32 statistics and an fp32 result: the
    adaLN pre-norm of every DiT block, whose modulation runs in fp32 before
    the downcast (through the row-norm kernel on CUDA)."""
    return layernorm(x, eps=eps, out_dtype=torch.float32)


def layernorm_centred(x, eps: float = 1e-6):
    """Affine-free LayerNorm in fp32 with the centred two-pass variance:
    the SD3 and HiDream blocks' norms, plain jnp in the JAX package (not
    its row-norm kernel, whose E[x^2] - E[x]^2 is another function), so
    plain torch here."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0,
                       time_factor: float = 1.0) -> torch.Tensor:
    """Sinusoidal timestep embedding, [cos | sin] halves (DDPM convention)."""
    t = torch.as_tensor(t).float() * time_factor
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class Linear(nn.Linear):
    """flax-style Dense: computes in `compute_dtype` (inputs and weights cast)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv2d(nn.Conv2d):
    """flax-style Conv: computes in `compute_dtype` (inputs and weights cast)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0,
                 compute_dtype: torch.dtype = torch.float32, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride, self.padding)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(32), eps 1e-5, computed in fp32 regardless of compute dtype."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-5):
        super().__init__(groups, channels, eps=eps)

    def forward(self, x):
        y = F.group_norm(x.float(), self.num_groups, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


class LayerNormF32(nn.Module):
    """LayerNorm with fp32 statistics, learned scale and bias, eps 1e-6,
    output in the input dtype — through the row-norm kernel on CUDA."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return layernorm(x, self.weight, self.bias, self.eps)


class RMSNorm(nn.Module):
    """RMSNorm over the last axis with a learned scale (`weight`), fp32
    statistics, output in the input dtype (through the row-norm kernel on
    CUDA)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return rmsnorm(x, self.weight, self.eps)


class QKNorm(nn.Module):
    """Per-head RMS normalization of q and k (Flux/SD3-style)."""

    def __init__(self, head_dim: int):
        super().__init__()
        self.query_norm = RMSNorm(head_dim)
        self.key_norm = RMSNorm(head_dim)

    def forward(self, q, k):
        return self.query_norm(q), self.key_norm(k)


class CrossAttention(nn.Module):
    """Self- or cross-attention of the UNet spatial transformer, fused layout.

    Self-attention (`context_dim is None`) projects q/k/v as ONE GEMM
    (`to_qkv`, split q|k|v) and runs `attention_bshd` on the strided split
    views (the flash-attention kernel where the JAX package takes its TPU
    kernel: S >= 1024 and D % 64 == 0).  Cross-attention takes `to_q` and a precomputed
    fused k|v tensor (`kv`, hoisted out of the depth loop by
    SpatialTransformer) and runs plain attention over the text tokens.
    """

    def __init__(self, query_dim: int, context_dim: Optional[int], num_heads: int,
                 head_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.is_self = context_dim is None
        inner = num_heads * head_dim
        if self.is_self:
            self.to_qkv = Linear(query_dim, inner * 3, bias=False, compute_dtype=dtype)
        else:
            self.to_q = Linear(query_dim, inner, bias=False, compute_dtype=dtype)
        self.to_out = Linear(inner, query_dim, compute_dtype=dtype)

    def forward(self, x, kv=None):
        b, s, _ = x.shape
        heads = (self.num_heads, self.head_dim)
        if self.is_self:
            q, k, v = (t.unflatten(-1, heads) for t in self.to_qkv(x).chunk(3, dim=-1))
            out = attention_bshd(q, k, v)
        else:
            q = self.to_q(x).unflatten(-1, heads)
            k, v = (t.unflatten(-1, heads) for t in kv.chunk(2, dim=-1))
            out = attention_ref(q, k, v)
        return self.to_out(out.reshape(b, s, -1))


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2, compute_dtype=dtype)

    def forward(self, x):
        a, g = self.proj(x).chunk(2, dim=-1)
        # flax nn.gelu defaults to the tanh approximation
        return a * F.gelu(g, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.net_0 = GEGLU(dim, dim * mult, dtype=dtype)
        self.net_2 = Linear(dim * mult, dim, compute_dtype=dtype)

    def forward(self, x):
        return self.net_2(self.net_0(x))


class BasicTransformerBlock(nn.Module):
    """LDM transformer block: self-attn -> cross-attn -> GEGLU FF."""

    def __init__(self, dim: int, context_dim: int, num_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNormF32(dim)
        self.attn1 = CrossAttention(dim, None, num_heads, head_dim, dtype=dtype)
        self.norm2 = LayerNormF32(dim)
        self.attn2 = CrossAttention(dim, context_dim, num_heads, head_dim, dtype=dtype)
        self.norm3 = LayerNormF32(dim)
        self.ff = FeedForward(dim, dtype=dtype)

    def forward(self, x, kv):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), kv=kv)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """GN -> linear proj -> depth x transformer block -> proj, residual.

    The cross-attention k/v projections of all blocks live in one stacked
    parameter `kv_cross` (depth, context_dim, 2*channels), contracted
    against the text context in one einsum — or taken precomputed
    (`kv_pre`, batch-major (B, depth, T, 2c)) from zoo.unet_precompute_kv,
    which the sampler runs once per call."""

    def __init__(self, channels: int, context_dim: int, num_heads: int, depth: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = GroupNorm32(channels)
        self.proj_in = Linear(channels, channels, compute_dtype=dtype)
        head_dim = channels // num_heads
        self.blocks = nn.ModuleList(
            BasicTransformerBlock(channels, context_dim, num_heads, head_dim, dtype=dtype)
            for _ in range(depth))
        self.kv_cross = nn.Parameter(torch.empty(depth, context_dim, 2 * channels))
        self.proj_out = Linear(channels, channels, compute_dtype=dtype)

    def cross_kv(self, context):
        """Batch-major cross-attention k|v of every block: (B, depth, T, 2c)."""
        return torch.einsum("btc,dcf->bdtf", context.to(self.dtype),
                            self.kv_cross.to(self.dtype))

    def forward(self, x, context, kv_pre=None):
        b, c, h, w = x.shape
        residual = x
        x = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        x = self.proj_in(x)
        kv_all = (self.cross_kv(context) if kv_pre is None else kv_pre).to(self.dtype)
        for i, block in enumerate(self.blocks):
            x = block(x, kv_all[:, i])
        x = self.proj_out(x)
        return x.reshape(b, h, w, c).permute(0, 3, 1, 2) + residual


class ResBlock(nn.Module):
    """UNet residual block with timestep-embedding injection."""

    def __init__(self, in_channels: int, out_channels: int, emb_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_norm = GroupNorm32(in_channels)
        self.in_conv = Conv2d(in_channels, out_channels, 3, padding=1, compute_dtype=dtype)
        self.emb_proj = Linear(emb_dim, out_channels, compute_dtype=dtype)
        self.out_norm = GroupNorm32(out_channels)
        self.out_conv = Conv2d(out_channels, out_channels, 3, padding=1, compute_dtype=dtype)
        self.skip_conv = (Conv2d(in_channels, out_channels, 1, compute_dtype=dtype)
                          if in_channels != out_channels else None)

    def forward(self, x, emb):
        h = self.in_conv(F.silu(self.in_norm(x)))
        h = h + self.emb_proj(F.silu(emb))[:, :, None, None]
        h = self.out_conv(F.silu(self.out_norm(h)))
        if self.skip_conv is not None:
            x = self.skip_conv(x)
        return x + h


class Downsample(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=1, compute_dtype=dtype)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1, compute_dtype=dtype)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class MLPEmbedder(nn.Module):
    """Two-layer SiLU MLP for time / vector embeddings."""

    def __init__(self, in_dim: int, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_layer = Linear(in_dim, hidden, compute_dtype=dtype)
        self.out_layer = Linear(hidden, hidden, compute_dtype=dtype)

    def forward(self, x):
        return self.out_layer(F.silu(self.in_layer(x)))


# --------------------------------------------------------------------------
# Rotary position embeddings (DiT family)


def rope_freqs(ids: torch.Tensor, axes_dim, theta: float = 10000.0) -> torch.Tensor:
    """Multi-axis RoPE rotation table.

    ids: (B, S, n_axes) integer position ids; axes_dim[i] dims go to axis i
    (they sum to the head dim).  Returns (B, S, head_dim // 2, 2, 2) fp32
    rotation matrices (Flux convention)."""
    parts = []
    for i, d in enumerate(axes_dim):
        scale = torch.arange(0, d, 2, dtype=torch.float32, device=ids.device) / d
        omega = 1.0 / (theta**scale)
        out = ids[..., i].float()[..., None] * omega  # (B, S, d // 2)
        cos, sin = torch.cos(out), torch.sin(out)
        parts.append(torch.stack([cos, -sin, sin, cos], dim=-1).reshape(*out.shape, 2, 2))
    return torch.cat(parts, dim=-3)


def apply_rope(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Rotate (B, S, H, D) q or k by the table, in fp32; returns x's dtype."""
    b, s, h, d = x.shape
    xf = x.float().reshape(b, s, h, d // 2, 1, 2)
    fr = freqs[:, :, None]  # (B, S, 1, D // 2, 2, 2)
    out = fr[..., 0] * xf[..., 0] + fr[..., 1] * xf[..., 1]
    return out.reshape(b, s, h, d).to(x.dtype)
