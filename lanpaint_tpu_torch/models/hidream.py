"""HiDream-I1 MoE-MMDiT backbone (flow matching) as a torch module.

PyTorch counterpart of `lanpaint_tpu/models/hidream.py` (the public
HiDream-I1 transformer):

* double-stream blocks: separate image and text projections (`to_q` /
  `to_q_t`), joint attention over [txt; llama_i; img], one fused 12-chunk
  adaLN a block, an image-stream SwiGLU mixture of experts (a shared
  expert and the top 2 of 4 routed ones) and a plain SwiGLU on the text
  stream;
* single-stream blocks over the concatenated stream, 6-chunk adaLN, the
  MoE feed-forward;
* per-block text injection: block i's own caption projection maps one
  Llama hidden-state slice (layer i % L for double blocks, (16 + i) % L
  for single ones), appended to the stream for that block and stripped
  after it; the caption projections run outside the blocks as two stacked
  products (`cap_proj_double`, `cap_proj_single`), as in JAX;
* full-width (not per-head) RMS q / k norms.

The MoE keeps the JAX module's dense formulation: every token runs through
all routed experts as one stacked product, combined with the renormalized
top-2 softmax gate (zero for the others).  The router computes in fp32 and
breaks ties toward the lower expert index, as `jax.lax.top_k` does.

Compute in `cfg.dtype` (bf16 by default); the blocks' affine-free
LayerNorms are `layers.layernorm_centred`, the JAX module's `_ln` (plain
jnp there); the final projection runs in fp32.
Scanned blocks are `double.<i>` / `single.<i>` as the flax scans name
them; `nn.Module.double` (the float64 cast) shadows the attribute, so that
stack lives in `_modules` directly.

Kernels on CUDA: the joint attention through `layers.attention_bshd` (H =
20, D = 128), and the q / k RMS norms through the row-norm kernel at C =
2,560.

Expert, tensor and layer parallelism (`HiDreamModel(cfg, mesh, tp_axis=...,
expert_axis=..., layer_axis=...)`, the weights cut by
`parallel.hidream_ep_rules`): a rank holds E / expert of the routed experts
and inner / tensor of their SwiGLU width; the router stays whole, each rank
weights its experts' outputs by their columns of the gate, and the sum is
all-reduced over "expert" and then, with the shared expert's partial
product, over "tensor".  The shared expert and the text SwiGLU are column /
row parallel, to_q / to_k / to_v (and the _t ones) column, to_out (and
to_out_t) row; the full-width q / k RMS norms all-reduce their sum of
squares over the tensor axis (layers.ShardedRMSNorm; the row-norm kernel on
one rank).  A block whose head count the tensor axis does not divide keeps
its attention and feed-forward widths whole.  `layer_axis` depth-shards
`double` and `single` (layers.LayerShards).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import NO_AXIS, Axis, axis_of
from .dit import _modulate, image_ids, pack_latent, unpack_latent
from .layers import (LayerShards, Linear, MLPEmbedder, ShardedRMSNorm, all_reduce, apply_rope,
                     attention_bshd, column_linear, head_rule, layernorm_centred, rope_freqs,
                     row_linear, timestep_embedding)


@dataclasses.dataclass(frozen=True)
class HiDreamConfig:
    in_channels: int = 64          # packed 2x2 patches of the 16ch latent
    out_channels: int = 64
    hidden: int = 2560
    num_heads: int = 20
    depth_double: int = 16
    depth_single: int = 32
    ffn_dim: int = 6912            # SwiGLU inner width
    num_experts: int = 4
    num_activated: int = 2
    context_dim: int = 4096        # T5-XXL features
    llama_dim: int = 4096          # Llama-3.1 hidden states (per layer)
    vec_dim: int = 2048            # pooled CLIP
    axes_dim: Tuple[int, ...] = (16, 56, 56)
    theta: float = 10000.0
    patch: int = 2
    latent_channels: int = 16
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden // self.num_heads


HIDREAM_I1_CONFIG = HiDreamConfig()
TINY_HIDREAM_CONFIG = HiDreamConfig(
    in_channels=16, out_channels=16, hidden=64, num_heads=4, depth_double=2,
    depth_single=2, ffn_dim=96, context_dim=32, llama_dim=24, vec_dim=16,
    axes_dim=(4, 6, 6), latent_channels=4,
)


class SwiGLU(nn.Module):
    """w2(silu(w1 x) * w3 x): the shared expert and the text-stream FF;
    w1 / w3 column- and w2 row-parallel over `tp`."""

    def __init__(self, inner: int, hidden: int, dtype: torch.dtype = torch.float32,
                 tp: Axis = NO_AXIS):
        super().__init__()
        self.w1 = column_linear(hidden, (inner,), tp, bias=False, dtype=dtype)
        self.w3 = column_linear(hidden, (inner,), tp, bias=False, dtype=dtype)
        self.w2 = row_linear(inner // tp.size, hidden, tp, bias=False, dtype=dtype)

    def hidden_act(self, x):
        return F.silu(self.w1(x)) * self.w3(x)

    def forward(self, x):
        return self.w2(self.hidden_act(x))


def top_k_lower_first(probs: torch.Tensor, k: int) -> tuple:
    """(values, indices) of the k largest entries of the last axis, ties
    taken in index order (`jax.lax.top_k`'s order; `torch.topk` promises
    none for ties)."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def route(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Dense (..., E) routing weights from fp32 router logits: the softmax's
    top k renormalized to sum to one, zero for the other experts."""
    topv, topi = top_k_lower_first(torch.softmax(logits, dim=-1), k)
    topv = topv / torch.sum(topv, dim=-1, keepdim=True)
    return torch.zeros_like(logits).scatter_(-1, topi, topv)


class MoEFeedForward(nn.Module):
    """The shared expert plus the top-k of `num_experts` routed SwiGLU
    experts, the routed ones stacked (E, in, out) and run for every token
    as one batched product, then weighted by the dense gate.

    Under expert parallelism (`ep`, where its size divides E) a rank holds
    its E / size experts and weights their outputs by its columns of the
    gate; under tensor parallelism (`tp`) it holds inner / size of every
    expert's width and of the shared expert's.  The routed sum is
    all-reduced over "expert", then with the shared expert's partial
    product over "tensor"."""

    def __init__(self, cfg: HiDreamConfig, tp: Axis = NO_AXIS, ep: Axis = NO_AXIS):
        super().__init__()
        self.cfg = cfg
        e, inner, h = cfg.num_experts, cfg.ffn_dim, cfg.hidden
        self.tp = tp
        self.ep = ep if e % ep.size == 0 else NO_AXIS
        n_e, inner_r = e // self.ep.size, inner // tp.size  # this rank's
        self.shared = SwiGLU(inner, h, dtype=cfg.dtype, tp=tp)
        self.gate = Linear(h, e, bias=False, compute_dtype=torch.float32)
        self.experts_w1 = nn.Parameter(torch.empty(n_e, h, inner_r))
        self.experts_w3 = nn.Parameter(torch.empty(n_e, h, inner_r))
        self.experts_w2 = nn.Parameter(torch.empty(n_e, inner_r, h))

    def forward(self, x):
        cfg, dt = self.cfg, self.cfg.dtype
        weights = route(self.gate(x.float()), cfg.num_activated)  # (B, S, E)
        b, s, h = x.shape
        n_e = self.experts_w1.shape[0]
        weights = weights.narrow(-1, self.ep.index * n_e, n_e)  # this rank's experts
        xe = x.to(dt).reshape(1, b * s, h)
        a = torch.matmul(xe, self.experts_w1.to(dt))              # (E, BS, inner)
        g = torch.matmul(xe, self.experts_w3.to(dt))
        out = torch.matmul(F.silu(a) * g, self.experts_w2.to(dt))  # (E, BS, h)
        routed = torch.einsum("enh,ne->nh", out, weights.to(dt).reshape(b * s, -1))
        routed = all_reduce(routed, self.ep).reshape(b, s, h)
        # the shared expert's w2 product (a rank's partial sum under tensor
        # parallelism; its w2 has no bias) joins the routed sum's reduce
        shared = F.linear(self.shared.hidden_act(x), self.shared.w2.weight.to(dt))
        return all_reduce(shared + routed, self.tp)


class _Modulation(nn.Module):
    """SiLU -> one Linear giving n fused adaLN chunks (12 for a double
    block, 6 for a single one)."""

    def __init__(self, hidden: int, n: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n = n
        self.lin = Linear(hidden, n * hidden, compute_dtype=dtype)

    def forward(self, vec):
        return self.lin(F.silu(vec))[:, None, :].chunk(self.n, dim=-1)


def _add_attention(block: nn.Module, cfg: HiDreamConfig, suffix: str, tp: Axis) -> None:
    h, dt = cfg.hidden, cfg.dtype
    for name in ("to_q", "to_k", "to_v"):
        block.add_module(name + suffix, column_linear(h, (h,), tp, whole_bias=True, dtype=dt))
    block.add_module("to_out" + suffix, row_linear(h // tp.size, h, tp, dtype=dt))
    block.add_module("q_rms_norm" + suffix, ShardedRMSNorm(h, 1e-6, tp, whole_weight=True))
    block.add_module("k_rms_norm" + suffix, ShardedRMSNorm(h, 1e-6, tp, whole_weight=True))


def _qkv(block: nn.Module, cfg: HiDreamConfig, x, suffix: str):
    """(q, k, v) BSHD of one stream (the block's rank's heads), q and k
    RMS-normalized over the full width before the head split."""
    q = getattr(block, "q_rms_norm" + suffix)(getattr(block, "to_q" + suffix)(x))
    k = getattr(block, "k_rms_norm" + suffix)(getattr(block, "to_k" + suffix)(x))
    v = getattr(block, "to_v" + suffix)(x)
    return (t.unflatten(-1, (block.heads, cfg.head_dim)) for t in (q, k, v))


class HiDreamDoubleBlock(nn.Module):
    """img / txt dual-stream block with joint attention, the MoE FF on the
    image stream.  `llama` arrives projected to the hidden width; it joins
    the text stream for this block only."""

    def __init__(self, cfg: HiDreamConfig, tp: Axis = NO_AXIS, ep: Axis = NO_AXIS):
        super().__init__()
        self.cfg = cfg
        tp = head_rule(tp, cfg.num_heads)
        self.heads = cfg.num_heads // tp.size
        self.adaLN_modulation = _Modulation(cfg.hidden, 12, dtype=cfg.dtype)
        _add_attention(self, cfg, "", tp)
        _add_attention(self, cfg, "_t", tp)
        self.ff_i = MoEFeedForward(cfg, tp, ep)
        self.ff_t = SwiGLU(cfg.ffn_dim, cfg.hidden, dtype=cfg.dtype, tp=tp)

    def forward(self, img, txt, vec, pe, llama):
        cfg, dt = self.cfg, self.cfg.dtype
        mods = self.adaLN_modulation(vec)
        im, tm = mods[:6], mods[6:]
        txt_full = torch.cat([txt, llama.to(txt.dtype)], dim=1)

        img_n = _modulate(layernorm_centred(img), im[0], im[1]).to(dt)
        txt_n = _modulate(layernorm_centred(txt_full), tm[0], tm[1]).to(dt)
        iq, ik, iv = _qkv(self, cfg, img_n, "")
        tq, tk, tv = _qkv(self, cfg, txt_n, "_t")
        q = apply_rope(torch.cat([tq, iq], dim=1), pe)
        k = apply_rope(torch.cat([tk, ik], dim=1), pe)
        attn = attention_bshd(q, k, torch.cat([tv, iv], dim=1)).flatten(2)
        n_txt = txt_full.shape[1]
        txt_a, img_a = attn[:, :n_txt], attn[:, n_txt:]

        img = img + im[2] * self.to_out(img_a)
        img = img + im[5] * self.ff_i(_modulate(layernorm_centred(img), im[3], im[4]).to(dt))
        # the carried text stream keeps only its persistent (T5) tokens
        txt = txt + tm[2] * self.to_out_t(txt_a[:, :txt.shape[1]])
        txt = txt + tm[5] * self.ff_t(_modulate(layernorm_centred(txt), tm[3], tm[4]).to(dt))
        return img, txt


class HiDreamSingleBlock(nn.Module):
    """Single-stream block: the projected Llama tokens appended before the
    block and stripped after it, the MoE FF."""

    def __init__(self, cfg: HiDreamConfig, tp: Axis = NO_AXIS, ep: Axis = NO_AXIS):
        super().__init__()
        self.cfg = cfg
        tp = head_rule(tp, cfg.num_heads)
        self.heads = cfg.num_heads // tp.size
        self.adaLN_modulation = _Modulation(cfg.hidden, 6, dtype=cfg.dtype)
        _add_attention(self, cfg, "", tp)
        self.ff_i = MoEFeedForward(cfg, tp, ep)

    def forward(self, x, vec, pe, llama):
        cfg, dt = self.cfg, self.cfg.dtype
        n_keep = x.shape[1]
        x_full = torch.cat([x, llama.to(x.dtype)], dim=1)
        m = self.adaLN_modulation(vec)
        q, k, v = _qkv(self, cfg, _modulate(layernorm_centred(x_full), m[0], m[1]).to(dt), "")
        attn = attention_bshd(apply_rope(q, pe), apply_rope(k, pe), v).flatten(2)
        x_full = x_full + m[2] * self.to_out(attn)
        x_full = x_full + m[5] * self.ff_i(_modulate(layernorm_centred(x_full), m[3], m[4]).to(dt))
        return x_full[:, :n_keep]


class HiDreamModel(nn.Module):
    """forward(x_nchw, t, context, vec, llama) -> velocity prediction.

    `context`: (B, S_t5, context_dim), the carried T5 stream (projected by
               `txt_in`, the public last caption projection).
    `llama`:   (L, B, S_ll, llama_dim) per-layer Llama features; block i
               (double blocks first, then single ones) takes slice i % L
               through its own caption projection.

    `mesh` (a `parallel.make_mesh` DeviceMesh, or a `parallel.plan_mesh`)
    resolves `tp_axis`, `expert_axis` and `layer_axis` (`double` and
    `single` depth-sharded); without a mesh the model is whole."""

    def __init__(self, cfg: HiDreamConfig, mesh=None, tp_axis: Optional[str] = None,
                 expert_axis: Optional[str] = None, layer_axis: Optional[str] = None):
        super().__init__()
        self.cfg = cfg
        tp, ep = axis_of(mesh, tp_axis), axis_of(mesh, expert_axis)
        layers = axis_of(mesh, layer_axis)
        h, dt = cfg.hidden, cfg.dtype
        self.x_embedder = Linear(cfg.in_channels, h, compute_dtype=dt)
        self.txt_in = Linear(cfg.context_dim, h, bias=False, compute_dtype=dt)
        self.time_in = MLPEmbedder(256, h, dtype=dt)
        if cfg.vec_dim > 0:
            self.vector_in = MLPEmbedder(cfg.vec_dim, h, dtype=dt)
        self.cap_proj_double = nn.Parameter(torch.empty(cfg.depth_double, cfg.llama_dim, h))
        self.cap_proj_single = nn.Parameter(torch.empty(cfg.depth_single, cfg.llama_dim, h))
        self._modules["double"] = nn.ModuleList(
            HiDreamDoubleBlock(cfg, tp, ep) for _ in range(cfg.depth_double))
        self.single = nn.ModuleList(HiDreamSingleBlock(cfg, tp, ep)
                                    for _ in range(cfg.depth_single))
        self.layers = {"double": LayerShards(cfg.depth_double, layers),
                       "single": LayerShards(cfg.depth_single, layers)}
        self.final_mod = Linear(h, 2 * h, compute_dtype=dt)
        self.final_linear = Linear(h, cfg.out_channels, compute_dtype=torch.float32)

    def caption_projections(self, llama: torch.Tensor) -> tuple:
        """The per-block projected Llama slices: ((depth_double, B, S_ll, h),
        (depth_single, B, S_ll, h)), two stacked products."""
        cfg, dt = self.cfg, self.cfg.dtype
        n_layers = llama.shape[0]
        idx_d = torch.arange(cfg.depth_double, device=llama.device) % n_layers
        idx_s = (cfg.depth_double + torch.arange(cfg.depth_single, device=llama.device)) \
            % n_layers
        ll = llama.to(dt)
        lp_d = torch.einsum("dbsl,dlh->dbsh", ll[idx_d], self.cap_proj_double.to(dt))
        lp_s = torch.einsum("dbsl,dlh->dbsh", ll[idx_s], self.cap_proj_single.to(dt))
        return lp_d, lp_s

    def forward(self, x, t, context, vec=None, llama=None):
        cfg, dt = self.cfg, self.cfg.dtype
        b, _, hh, ww = x.shape
        img = self.x_embedder(pack_latent(x, cfg.patch).to(dt))
        txt = self.txt_in(context.to(dt))

        t = torch.as_tensor(t, device=x.device).float().reshape(-1)
        v = self.time_in(timestep_embedding(t * 1000.0, 256).to(dt))
        if cfg.vec_dim > 0 and vec is not None:
            v = v + self.vector_in(vec.to(dt))

        if llama is None:
            llama = torch.zeros((1, b, 1, cfg.llama_dim), device=x.device)
        n_ll = llama.shape[2]
        lp_d, lp_s = self.caption_projections(llama)

        # RoPE ids: [t5 + llama; img], the text tokens at position 0
        n_t5 = txt.shape[1]
        im_ids = image_ids(b, hh, ww, cfg.patch, device=x.device)
        zeros = lambda n: torch.zeros((b, n, 3), dtype=torch.long, device=x.device)  # noqa: E731
        pe = rope_freqs(torch.cat([zeros(n_t5 + n_ll), im_ids], dim=1), cfg.axes_dim, cfg.theta)
        for i, block in enumerate(self._modules["double"]):
            img, txt = self.layers["double"].run(block, i, img, txt, v, pe, lp_d[i])

        xcat = torch.cat([txt, img], dim=1)
        # single-stream pe: the carried txt, img, and the per-block llama
        # appended at the end inside the block
        pe_s = rope_freqs(torch.cat([zeros(n_t5), im_ids, zeros(n_ll)], dim=1), cfg.axes_dim,
                          cfg.theta)
        for i, block in enumerate(self.single):
            xcat = self.layers["single"].run(block, i, xcat, v, pe_s, lp_s[i])
        img = xcat[:, n_t5:]

        shift, scale = self.final_mod(F.silu(v))[:, None, :].chunk(2, dim=-1)
        out = self.final_linear(_modulate(layernorm_centred(img), shift, scale).float())
        return unpack_latent(out, hh, ww, cfg.patch)
