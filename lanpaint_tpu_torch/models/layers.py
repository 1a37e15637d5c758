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
kernels, and so does Wan's cross-attention to its text tokens (S >= 1024
queries, D = 128); every transformer LayerNorm and RMSNorm goes through the
row-norm kernel (ops/norms.py).  The UNet's 77-token cross-attention, and
self-attention the JAX package leaves to XLA (S < 1024, or SD1.5's head
dims), stay plain PyTorch.

Tensor and layer parallelism (Megatron style, over the process groups of a
`parallel.make_mesh` mesh, the weights cut by `parallel.shard_params_tp`):
`column_linear` / `ColumnLinear` (a rank's rows of a weight cut per fused
part), `row_linear` / `RowLinear` (a rank's input features, the partial
products all-reduced and the bias added once after), `ShardedRMSNorm`
(RMS over a full width split over the tensor axis, the sum of squares
all-reduced) and `LayerShards` (a block list depth-sharded over an axis,
each block's weights broadcast by their owner before it runs).  The UNet's
spatial transformer runs on a rank's heads where the axis divides their
count, else whole.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.attention import WIDE_HEAD_DIMS, attention_ref, flash_attention, wide_attention
from ..ops.norms import (VEC, apply_rope, layernorm, rmsnorm, rmsnorm_ref, rmsnorm_rope,
                         rmsnorm_rope_ref, rope_rows)
from ..parallel.mesh import NO_AXIS, Axis, all_gather


def attention_bshd(q, k, v, scale: Optional[float] = None):
    """Multi-head attention of q (B, S, H, D) over k, v (B, Sk, H, D),
    routed by shape as the JAX package's `attention_bshd(impl="auto")` is:
    S >= 1024 and D % 64 == 0 goes to a kernel on CUDA — `wide_attention`
    for self-attention with D in WIDE_HEAD_DIMS (the VAEs' mid attention,
    D = 384, 512, 640), else `flash_attention`, whatever Sk (Wan's
    cross-attention, which the JAX package leaves to XLA at the kernel's
    precision; it raises on a head dim it does not support) — anything else
    to `attention_ref`, where the JAX package leaves it to XLA."""
    s, d = q.shape[1], q.shape[3]
    if s >= 1024 and d % 64 == 0:
        if d not in WIDE_HEAD_DIMS:
            return flash_attention(q, k, v, scale)
        if k.shape[1] == s:
            return wide_attention(q, k, v, scale)
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


# --------------------------------------------------------------------------
# tensor and layer parallelism


def all_reduce(x, axis: Axis):
    """Sum `x` over the axis's group, in place.  Without a group (no mesh, a
    planned mesh, or Wan's tp_size without an axis, where the JAX package
    reduces nothing either) `x` is left as it is."""
    if axis.group is not None and axis.size > 1:
        dist.all_reduce(x, group=axis.group)
    return x


def head_rule(tp: Axis, num_heads: int) -> Axis:
    """The tensor axis a block of `num_heads` heads runs on: `tp` where its
    size divides the head count, else none (the block whole on every rank;
    `parallel.Cut.heads` makes the rules agree)."""
    return tp if num_heads % tp.size == 0 else NO_AXIS


def gather_features(x, axis: Axis):
    """The ranks' feature slices of `x` (last dim) concatenated in axis
    order."""
    if axis.group is None or axis.size == 1:
        return x
    return all_gather(x, axis.group, x.ndim - 1)


class ColumnLinear(Linear):
    """Column-parallel Linear: this rank's rows of a full (out, in) weight
    whose out dim is `parts` (a fused projection's parts, e.g. q | k | v),
    each part cut in `axis.size` blocks (`parallel.Cut`), so the output is
    the rank's block of every part, in order.  Its bias is the rank's cut,
    or with `whole_bias` the full bias (the rules keep it replicated, as the
    JAX package's do), of which the forward takes the rank's spans."""

    def __init__(self, in_features: int, parts: tuple, axis: Axis, bias: bool = True,
                 whole_bias: bool = False, compute_dtype: torch.dtype = torch.float32):
        n = axis.size
        super().__init__(in_features, sum(parts) // n, bias=bias and not whole_bias,
                         compute_dtype=compute_dtype)
        if bias and whole_bias:
            self.bias = nn.Parameter(torch.empty(sum(parts)))
        offsets = [sum(parts[:j]) for j in range(len(parts))]
        self.spans = [(o + axis.index * (p // n), p // n) for o, p in zip(offsets, parts)]

    def forward(self, x):
        dt = self.compute_dtype
        b = self.bias
        if b is not None and b.shape[0] != self.out_features:
            b = torch.cat([b.narrow(0, start, n) for start, n in self.spans])
        return F.linear(x.to(dt), self.weight.to(dt), None if b is None else b.to(dt))


def column_linear(in_features: int, parts: tuple, axis: Axis, *, bias: bool = True,
                  whole_bias: bool = False, dtype: torch.dtype = torch.float32) -> Linear:
    """A ColumnLinear over `axis`, or a Linear of the full width where the
    axis has one rank."""
    if axis.size == 1:
        return Linear(in_features, sum(parts), bias=bias, compute_dtype=dtype)
    return ColumnLinear(in_features, parts, axis, bias=bias, whole_bias=whole_bias,
                        compute_dtype=dtype)


class RowLinear(Linear):
    """Row-parallel Linear: the input features are split over the axis, the
    partial products are all-reduced over its group, and the bias is added
    once after the reduce.  The state dict is a Linear's."""

    def __init__(self, in_features: int, out_features: int, axis: Axis,
                 compute_dtype: torch.dtype, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias, compute_dtype=compute_dtype)
        self.axis = axis

    def forward(self, x):
        dt = self.compute_dtype
        y = all_reduce(F.linear(x.to(dt), self.weight.to(dt)), self.axis)
        return y if self.bias is None else y + self.bias.to(dt)


def row_linear(in_features: int, out_features: int, axis: Axis, *, bias: bool = True,
               dtype: torch.dtype = torch.float32) -> Linear:
    """A RowLinear where the axis has a process group (of any size: the
    bias then comes after the reduce), else a plain Linear."""
    if axis.group is None:
        return Linear(in_features, out_features, bias=bias, compute_dtype=dtype)
    return RowLinear(in_features, out_features, axis, dtype, bias=bias)


class LayerShards:
    """A block list depth-sharded over a layer axis
    (`parallel.layer_shard_rules`).  With n blocks and an axis of d ranks
    where d divides n, the rank at index r holds blocks [r n / d, (r + 1)
    n / d) and the others' parameters stay on the meta device; `run` runs
    block i: its owner broadcasts the block's weights (its tensor shard),
    one flat buffer, over the axis's group, and every other rank runs the
    block on the buffer and drops it.  Where d is 1 or does not divide n,
    every rank holds every block (JAX's `_divisible_spec`)."""

    def __init__(self, n: int, axis: Axis = NO_AXIS):
        self.axis = axis
        self.per = n // axis.size if axis.size > 1 and n % axis.size == 0 else None

    def holds(self, i: int) -> bool:
        return self.per is None or i // self.per == self.axis.index

    def run(self, block: nn.Module, i: int, *args, **kwargs):
        if self.per is None:
            return block(*args, **kwargs)
        params = list(block.named_parameters())
        dtypes = {p.dtype for _, p in params}
        if len(dtypes) != 1:
            raise ValueError(f"LayerShards: block {i} mixes parameter dtypes {dtypes}")
        if self.holds(i):
            flat = torch.cat([p.detach().reshape(-1) for _, p in params])
        else:
            flat = torch.empty(sum(p.numel() for _, p in params), dtype=dtypes.pop(),
                               device=args[0].device)
        owner = dist.get_global_rank(self.axis.group, i // self.per)
        dist.broadcast(flat, src=owner, group=self.axis.group)
        if self.holds(i):
            return block(*args, **kwargs)
        views, offset = {}, 0
        for name, p in params:
            views[name] = flat[offset:offset + p.numel()].view(p.shape)
            offset += p.numel()
        return torch.func.functional_call(block, views, args, kwargs)


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


def _rms(x, weight, eps, freqs=None):
    """RMSNorm of x's rows, then with `freqs` (a `rope_freqs` table) RoPE of
    each of their heads of the table's head dim: through the row-norm kernel
    (its RoPE epilogue with a table) where it takes the row width and head
    dim (multiples of `ops.norms.VEC`), the plain versions elsewhere, as the
    JAX package leaves the widths its kernel does not take to jnp (the tiny
    Z-Image's head dim 12)."""
    if freqs is None:
        return rmsnorm_ref(x, weight, eps) if x.shape[-1] % VEC else rmsnorm(x, weight, eps)
    head_dim = 2 * freqs.shape[-3]
    if x.shape[-1] % VEC or head_dim % VEC:
        return rmsnorm_rope_ref(x, weight, eps, freqs, head_dim)
    return rmsnorm_rope(x, weight, eps, freqs, head_dim)


class RMSNorm(nn.Module):
    """RMSNorm over the last axis with a learned scale (`weight`), fp32
    statistics, output in the input dtype; `forward(x, freqs)` rotates the
    normalised (B, S, ..., C) rows by a RoPE table after it, as
    `apply_rope` (`_rms`'s routing)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x, freqs=None):
        return _rms(x, self.weight, self.eps, freqs)


class ShardedRMSNorm(nn.Module):
    """RMSNorm over the full width `dim` before the head split (Wan's and
    HiDream's q / k norms), fp32 statistics, output in the input dtype.  On
    one rank of the axis: the row-norm kernel on CUDA (`RMSNorm`'s routing).
    Where the features are split over a tensor axis, a rank holds
    dim / size of them: the sum of squares is all-reduced over the axis and
    divided by the full `dim`, in plain PyTorch.  The scale is the rank's
    slice, or with `whole_weight` the full scale (replicated by the rules),
    of which the forward takes the rank's slice.  `forward(x, freqs)`
    rotates the normalised rows' heads by a RoPE table after it, as
    `apply_rope`: in the kernel's epilogue on one rank, after the plain
    norm on several."""

    def __init__(self, dim: int, eps: float = 1e-6, axis: Axis = NO_AXIS,
                 whole_weight: bool = False):
        super().__init__()
        self.eps = eps
        self.dim = dim
        self.axis = axis
        self.local = dim // axis.size
        self.weight = nn.Parameter(torch.ones(dim if whole_weight else self.local))

    def forward(self, x, freqs=None):
        w = self.weight
        if w.shape[0] != x.shape[-1]:
            w = w.narrow(0, self.axis.index * self.local, self.local)
        if self.axis.size == 1:
            return _rms(x, w, self.eps, freqs)
        xf = x.float()
        ss = all_reduce(torch.sum(xf * xf, dim=-1, keepdim=True), self.axis)
        y = (xf * torch.rsqrt(ss / self.dim + self.eps) * w.float()).to(x.dtype)
        return y if freqs is None else rope_rows(y, freqs, 2 * freqs.shape[-3])


class QKNorm(nn.Module):
    """Per-head RMS normalization of q and k (Flux/SD3-style); with a RoPE
    table `freqs`, q and k rotated by it after the norm (one launch each)."""

    def __init__(self, head_dim: int):
        super().__init__()
        self.query_norm = RMSNorm(head_dim)
        self.key_norm = RMSNorm(head_dim)

    def forward(self, q, k, freqs=None):
        return self.query_norm(q, freqs), self.key_norm(k, freqs)


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
                 head_dim: int, dtype: torch.dtype = torch.float32, tp: Axis = NO_AXIS):
        super().__init__()
        self.num_heads = num_heads // tp.size  # this rank's heads
        self.head_dim = head_dim
        self.is_self = context_dim is None
        inner = num_heads * head_dim
        if self.is_self:
            self.to_qkv = column_linear(query_dim, (inner,) * 3, tp, bias=False, dtype=dtype)
        else:
            self.to_q = column_linear(query_dim, (inner,), tp, bias=False, dtype=dtype)
        self.to_out = row_linear(inner // tp.size, query_dim, tp, dtype=dtype)

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
    def __init__(self, dim_in: int, dim_out: int, dtype: torch.dtype = torch.float32,
                 tp: Axis = NO_AXIS):
        super().__init__()
        self.proj = column_linear(dim_in, (dim_out, dim_out), tp, dtype=dtype)  # a | gate

    def forward(self, x):
        a, g = self.proj(x).chunk(2, dim=-1)
        # flax nn.gelu defaults to the tanh approximation
        return a * F.gelu(g, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4, dtype: torch.dtype = torch.float32,
                 tp: Axis = NO_AXIS):
        super().__init__()
        self.net_0 = GEGLU(dim, dim * mult, dtype=dtype, tp=tp)
        self.net_2 = row_linear(dim * mult // tp.size, dim, tp, dtype=dtype)

    def forward(self, x):
        return self.net_2(self.net_0(x))


class BasicTransformerBlock(nn.Module):
    """LDM transformer block: self-attn -> cross-attn -> GEGLU FF, on this
    rank's heads and GEGLU width under `tp` (x whole on every rank)."""

    def __init__(self, dim: int, context_dim: int, num_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.float32, tp: Axis = NO_AXIS):
        super().__init__()
        self.norm1 = LayerNormF32(dim)
        self.attn1 = CrossAttention(dim, None, num_heads, head_dim, dtype=dtype, tp=tp)
        self.norm2 = LayerNormF32(dim)
        self.attn2 = CrossAttention(dim, context_dim, num_heads, head_dim, dtype=dtype, tp=tp)
        self.norm3 = LayerNormF32(dim)
        self.ff = FeedForward(dim, dtype=dtype, tp=tp)

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
    which the sampler runs once per call.

    Under tensor parallelism (`tp`, where its size divides `num_heads`; a
    transformer it does not divide stays whole on every rank) the blocks
    run on this rank's heads: `proj_in` is column-parallel and its output
    is all-gathered over the axis before the blocks' LayerNorm, `kv_cross`
    holds the rank's k and v columns, and `proj_out` is row-parallel on the
    rank's channel slice (all-reduced, its bias added once).  `layers`
    depth-shards the blocks (`LayerShards`)."""

    def __init__(self, channels: int, context_dim: int, num_heads: int, depth: int = 1,
                 dtype: torch.dtype = torch.float32, tp: Axis = NO_AXIS,
                 layers: Axis = NO_AXIS):
        super().__init__()
        tp = self.tp = head_rule(tp, num_heads)
        self.dtype = dtype
        self.norm = GroupNorm32(channels)
        self.proj_in = column_linear(channels, (channels,), tp, dtype=dtype)
        head_dim = channels // num_heads
        self.blocks = nn.ModuleList(
            BasicTransformerBlock(channels, context_dim, num_heads, head_dim, dtype=dtype, tp=tp)
            for _ in range(depth))
        self.layers = LayerShards(depth, layers)
        self.kv_cross = nn.Parameter(torch.empty(depth, context_dim, 2 * channels // tp.size))
        self.proj_out = row_linear(channels // tp.size, channels, tp, dtype=dtype)

    def cross_kv(self, context):
        """Batch-major cross-attention k|v of every block: (B, depth, T, 2c)."""
        return torch.einsum("btc,dcf->bdtf", context.to(self.dtype),
                            self.kv_cross.to(self.dtype))

    def forward(self, x, context, kv_pre=None):
        b, c, h, w = x.shape
        residual = x
        x = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        x = gather_features(self.proj_in(x), self.tp)
        kv_all = (self.cross_kv(context) if kv_pre is None else kv_pre).to(self.dtype)
        for i, block in enumerate(self.blocks):
            x = self.layers.run(block, i, x, kv_all[:, i])
        if self.tp.size > 1:  # the rank's channels into the row-parallel proj_out
            x = x.narrow(-1, self.tp.index * (c // self.tp.size), c // self.tp.size)
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
    """Two-layer SiLU MLP for time / vector embeddings (FLUX.2's without
    biases)."""

    def __init__(self, in_dim: int, hidden: int, dtype: torch.dtype = torch.float32,
                 bias: bool = True):
        super().__init__()
        self.in_layer = Linear(in_dim, hidden, bias=bias, compute_dtype=dtype)
        self.out_layer = Linear(hidden, hidden, bias=bias, compute_dtype=dtype)

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
