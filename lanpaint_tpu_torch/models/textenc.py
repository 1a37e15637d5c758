"""Text encoders: CLIP and T5 / UMT5, as torch `nn.Module`s.

PyTorch counterpart of the CLIP and T5 parts of
`lanpaint_tpu/models/textenc.py`: the encoders every prompt of the image
families and of Wan goes through (CLIP-L and CLIP-G for SD1.x and SDXL,
CLIP-L + T5-XXL for Flux and SD3, UMT5-XXL for Wan2.2).  The Llama / Qwen
stacks wait for the families that need them (ROADMAP A.14).

fp32 by default, as the JAX configs are.  A config's `dtype` is the compute
dtype of the dense layers, which cast inputs and weights to it (flax
`Dense(dtype=...)`); the embeddings are summed in fp32 before the cast,
the norms compute in fp32.  The JAX package runs no TPU kernel here
(`jax.nn.dot_product_attention` and flax's LayerNorm), so neither does
the port: attention is `F.scaled_dot_product_attention`, the norms
`F.layer_norm` and a plain RMS.  The per-layer weights are a ModuleList
(`layers.<i>` for CLIP, `blocks.<i>` for T5), so models/bridge.py maps the
JAX package's scanned trees onto them.  `zoo.build_clip` and
`zoo.build_t5` make one on the CUDA card unless `device` names another.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Linear

# --------------------------------------------------------------------------
# CLIP text model


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    width: int = 768
    layers: int = 12
    heads: int = 12
    max_len: int = 77
    intermediate: int = 3072
    act: str = "quick_gelu"      # CLIP-L; bigG uses "gelu"
    projection_dim: int = 0      # 0 = no text_projection head
    eos_token_id: int = 49407
    ln_eps: float = 1e-5         # HF CLIP layer_norm_eps
    dtype: torch.dtype = torch.float32


CLIP_L_CONFIG = CLIPTextConfig()
CLIP_G_CONFIG = CLIPTextConfig(width=1280, layers=32, heads=20, intermediate=5120, act="gelu",
                               projection_dim=1280)
# SD 2.x text encoder (OpenCLIP ViT-H text tower)
CLIP_H_CONFIG = CLIPTextConfig(width=1024, layers=24, heads=16, intermediate=4096, act="gelu",
                               projection_dim=1024)


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return lambda x: F.gelu(x)
    raise ValueError(name)


class LayerNorm(nn.Module):
    """flax LayerNorm(dtype=float32): fp32 statistics and an fp32 result,
    learned `weight` and `bias`."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(), self.bias.float(),
                            self.eps)


class _CLIPLayer(nn.Module):
    def __init__(self, c: CLIPTextConfig):
        super().__init__()
        self.heads = c.heads
        self.act = _act(c.act)
        self.ln1 = LayerNorm(c.width, c.ln_eps)
        self.q, self.k, self.v, self.out = (Linear(c.width, c.width, compute_dtype=c.dtype)
                                            for _ in range(4))
        self.ln2 = LayerNorm(c.width, c.ln_eps)
        self.fc1 = Linear(c.width, c.intermediate, compute_dtype=c.dtype)
        self.fc2 = Linear(c.intermediate, c.width, compute_dtype=c.dtype)

    def forward(self, x):
        h = self.ln1(x)
        b, s, w = h.shape
        q, k, v = (proj(h).view(b, s, self.heads, -1).transpose(1, 2)
                   for proj in (self.q, self.k, self.v))
        att = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        x = x + self.out(att.transpose(1, 2).reshape(b, s, w))
        h = self.fc1(self.ln2(x))
        return x + self.fc2(self.act(h))


class CLIPTextEncoder(nn.Module):
    """forward(ids) -> (hidden_states stacked (L+1, B, S, D), last_ln, pooled).

    hidden_states[i] is the output after i layers (index 0 = embeddings),
    matching HF `output_hidden_states` indexing, so the hosts' "clip skip 1"
    penultimate convention is `hidden_states[-2] = hs[layers - 1]`.
    last_ln is final_layer_norm(hs[-1]).  pooled is the EOT-token feature of
    last_ln (the first position of `eos_token_id`), through text_projection
    (`x @ proj`, fp32) when projection_dim > 0."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Parameter(torch.empty(cfg.vocab_size, cfg.width))
        self.position_embedding = nn.Parameter(torch.empty(cfg.max_len, cfg.width))
        self.layers = nn.ModuleList(_CLIPLayer(cfg) for _ in range(cfg.layers))
        self.final_ln = LayerNorm(cfg.width, cfg.ln_eps)
        if cfg.projection_dim:
            self.text_projection = nn.Parameter(torch.empty(cfg.width, cfg.projection_dim))

    def forward(self, ids: torch.Tensor):
        c = self.cfg
        b, s = ids.shape
        x = (self.token_embedding[ids].float()
             + self.position_embedding[None, :s].float()).to(c.dtype)
        hs = [x]
        for layer in self.layers:
            x = layer(x)
            hs.append(x)
        last_ln = self.final_ln(x)
        eot = torch.argmax((ids == c.eos_token_id).to(torch.int32), dim=-1)
        pooled = last_ln[torch.arange(b, device=ids.device), eot]
        if c.projection_dim:
            pooled = pooled.float() @ self.text_projection.float()
        return torch.stack(hs), last_ln, pooled


# --------------------------------------------------------------------------
# T5 / UMT5 encoder


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_ff: int = 10240
    layers: int = 24
    heads: int = 64
    head_dim: int = 64
    rel_buckets: int = 32
    rel_max_distance: int = 128
    per_layer_rel_bias: bool = False   # True = UMT5 (Wan2.2 umt5-xxl)
    act: str = "gelu"                  # gated act: gelu (v1.1/xxl) or relu
    dtype: torch.dtype = torch.float32


T5_XXL_CONFIG = T5Config()
UMT5_XXL_CONFIG = T5Config(vocab_size=256384, per_layer_rel_bias=True)


def t5_relative_buckets(qlen: int, klen: int, buckets: int, maxdist: int) -> np.ndarray:
    """Bidirectional T5 relative-position bucket table (static, host-side)."""
    ctx = np.arange(qlen)[:, None]
    mem = np.arange(klen)[None, :]
    rel = mem - ctx
    nb = buckets // 2
    out = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    is_small = rel < max_exact
    large = max_exact + (
        np.log(rel.clip(1) / max_exact) / np.log(maxdist / max_exact)
        * (nb - max_exact)).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return out + np.where(is_small, rel, large)


class RMSNorm(nn.Module):
    """T5 RMSNorm: fp32 statistics, learned `weight`, no bias, no mean
    subtraction, the result in the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        n = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + self.eps)
        return (n * self.weight.float()).to(x.dtype)


def _bias_from_table(table: torch.Tensor, buckets: torch.Tensor) -> torch.Tensor:
    """(buckets, heads) table at the (S, S) bucket ids -> (1, heads, S, S)."""
    return table[buckets].permute(2, 0, 1)[None]


class _T5Layer(nn.Module):
    def __init__(self, c: T5Config):
        super().__init__()
        self.heads = c.heads
        self.gelu = c.act == "gelu"
        inner = c.heads * c.head_dim
        dt = c.dtype
        self.ln1 = RMSNorm(c.d_model)
        self.q, self.k, self.v = (Linear(c.d_model, inner, bias=False, compute_dtype=dt)
                                  for _ in range(3))
        self.o = Linear(inner, c.d_model, bias=False, compute_dtype=dt)
        if c.per_layer_rel_bias:
            self.rel_bias = nn.Parameter(torch.empty(c.rel_buckets, c.heads))
        self.ln2 = RMSNorm(c.d_model)
        self.wi0 = Linear(c.d_model, c.d_ff, bias=False, compute_dtype=dt)
        self.wi1 = Linear(c.d_model, c.d_ff, bias=False, compute_dtype=dt)
        self.wo = Linear(c.d_ff, c.d_model, bias=False, compute_dtype=dt)

    def forward(self, x, pos_bias, buckets, mask):
        h = self.ln1(x)
        if hasattr(self, "rel_bias"):
            pos_bias = _bias_from_table(self.rel_bias, buckets)
        b, s, _ = h.shape
        q, k, v = (proj(h).view(b, s, self.heads, -1).transpose(1, 2)
                   for proj in (self.q, self.k, self.v))
        bias = pos_bias.to(q.dtype)
        if mask is not None:  # keys outside the mask: the dtype's lowest value
            bias = bias.masked_fill(~mask, torch.finfo(q.dtype).min)
        att = F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=1.0)
        x = x + self.o(att.transpose(1, 2).reshape(b, s, -1))
        h = self.ln2(x)
        g = self.wi0(h)
        act = F.gelu(g, approximate="tanh") if self.gelu else F.relu(g)
        return x + self.wo(act * self.wi1(h))


class T5Encoder(nn.Module):
    """forward(ids, attn_mask=None) -> last_hidden_state (B, S, d_model)
    after the final RMSNorm.  attn_mask: an optional (B, S) 1/0 key-validity
    mask (HF attention_mask)."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model))
        if not cfg.per_layer_rel_bias:
            self.rel_bias = nn.Parameter(torch.empty(cfg.rel_buckets, cfg.heads))
        self.blocks = nn.ModuleList(_T5Layer(cfg) for _ in range(cfg.layers))
        self.final_ln = RMSNorm(cfg.d_model)

    def forward(self, ids: torch.Tensor, attn_mask: Optional[torch.Tensor] = None):
        c = self.cfg
        s = ids.shape[1]
        x = self.shared[ids].float().to(c.dtype)
        buckets = torch.from_numpy(
            t5_relative_buckets(s, s, c.rel_buckets, c.rel_max_distance)).to(ids.device)
        pos_bias = None if c.per_layer_rel_bias else _bias_from_table(self.rel_bias, buckets)
        mask = None if attn_mask is None else attn_mask[:, None, None, :].bool()
        for block in self.blocks:
            x = block(x, pos_bias, buckets, mask)
        return self.final_ln(x)


# --------------------------------------------------------------------------
# convenience wrappers (the builders are zoo.build_clip and zoo.build_t5)


@torch.no_grad()
def clip_encode(model: CLIPTextEncoder, ids, clip_skip: int = 2
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hidden, pooled): hidden = hidden_states[-clip_skip] (the hosts'
    default clip_skip=2 == the penultimate layer, un-normed), pooled as HF."""
    hs, _last, pooled = model(ids)
    return hs[model.cfg.layers + 1 - clip_skip], pooled


@torch.no_grad()
def t5_encode(model: T5Encoder, ids, attn_mask=None) -> torch.Tensor:
    return model(ids, attn_mask)
