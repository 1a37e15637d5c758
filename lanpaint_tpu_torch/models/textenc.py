"""Text encoders: CLIP, T5 / UMT5 and the Llama / Qwen trunk, as torch
`nn.Module`s.

PyTorch counterpart of `lanpaint_tpu/models/textenc.py`: the encoders every
prompt goes through (CLIP-L and CLIP-G for SD1.x and SDXL, CLIP-L + T5-XXL
for Flux and SD3, UMT5-XXL for Wan2.2, the Qwen2.5-7B text stack for
Qwen-Image, Qwen3-4B for Z-Image and the Qwen3 stand-in families,
Llama-3.1-8B for HiDream).

fp32 by default, as the JAX configs are.  A config's `dtype` is the compute
dtype of the dense layers, which cast inputs and weights to it (flax
`Dense(dtype=...)`); the embeddings are summed in fp32 before the cast,
the norms compute in fp32.  The JAX package runs no TPU kernel here
(`jax.nn.dot_product_attention` and flax's LayerNorm), so neither does
the port: attention is `F.scaled_dot_product_attention`, the norms
`F.layer_norm` and a plain RMS.  The per-layer weights are a ModuleList
(`layers.<i>` for CLIP and Llama, `blocks.<i>` for T5), so models/bridge.py
maps the JAX package's scanned trees onto them.  `zoo.build_clip`,
`zoo.build_t5` and `zoo.build_llama` make one on the CUDA card unless
`device` names another.
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
# Llama / Qwen2 decoder used as a hidden-state encoder


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    layers: int = 32
    heads: int = 32
    kv_heads: int = 8
    intermediate: int = 14336
    rope_theta: float = 500000.0
    # llama3-style rope scaling (factor, low_freq_factor, high_freq_factor,
    # original_max_position_embeddings) or None
    rope_scaling: Optional[Tuple[float, float, float, int]] = None
    qkv_bias: bool = False            # True = Qwen2/Qwen2.5
    rms_eps: float = 1e-5
    # Qwen3 family: explicit head width (decoupled from dim//heads) and
    # per-head RMS q/k-norm before RoPE
    head_dim: Optional[int] = None
    qk_norm: bool = False
    # Qwen2.5-VL multimodal rope: channel sections of head_dim//2 assigned
    # to the (temporal, height, width) position streams, engaged when
    # pos_ids are passed; for pure text the three streams are equal, which
    # is standard RoPE
    mrope_section: Optional[Tuple[int, int, int]] = None
    dtype: torch.dtype = torch.float32

    @property
    def head_width(self) -> int:
        return self.head_dim if self.head_dim is not None else self.dim // self.heads


# The configurations of lanpaint_tpu/models/textenc.py, which documents each
# one's source: Llama-3.1-8B (HiDream), the Qwen2.5-(VL-)7B text stack
# (Qwen-Image), Qwen3 0.6B / 4B / 8B (Anima; Z-Image, Flux.2-Klein-4b,
# Krea2; Flux.2-Klein-9b, Ideogram4).
LLAMA31_8B_CONFIG = LlamaConfig(rope_scaling=(8.0, 1.0, 4.0, 8192))
QWEN25_7B_CONFIG = LlamaConfig(vocab_size=152064, dim=3584, layers=28, heads=28, kv_heads=4,
                               intermediate=18944, rope_theta=1000000.0, qkv_bias=True,
                               rms_eps=1e-6, mrope_section=(16, 24, 24))
QWEN3_06B_CONFIG = LlamaConfig(vocab_size=151936, dim=1024, layers=28, heads=16, kv_heads=8,
                               intermediate=3072, rope_theta=1000000.0, rms_eps=1e-6,
                               head_dim=128, qk_norm=True)
QWEN3_4B_CONFIG = LlamaConfig(vocab_size=151936, dim=2560, layers=36, heads=32, kv_heads=8,
                              intermediate=9728, rope_theta=1000000.0, rms_eps=1e-6,
                              head_dim=128, qk_norm=True)
QWEN3_8B_CONFIG = LlamaConfig(vocab_size=151936, dim=4096, layers=36, heads=32, kv_heads=8,
                              intermediate=12288, rope_theta=1000000.0, rms_eps=1e-6,
                              head_dim=128, qk_norm=True)


def _llama3_scale_inv_freq(inv: np.ndarray, factor: float, low: float,
                           high: float, orig: int) -> np.ndarray:
    """Llama-3.1 frequency rescaling (HF ROPE_INIT_FUNCTIONS['llama3'])."""
    low_wl = orig / low
    high_wl = orig / high
    wavelen = 2.0 * np.pi / inv
    smooth = (orig / wavelen - low) / (high - low)
    mid = (1.0 - smooth) * inv / factor + smooth * inv
    return np.where(wavelen > low_wl, inv / factor,
                    np.where(wavelen < high_wl, inv, mid)).astype(np.float32)


def _inv_freq(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, np.float32) / head_dim))


def _llama_rope(s: int, head_dim: int, theta: float,
                scaling: Optional[Tuple[float, float, float, int]] = None, device=None):
    """(cos, sin), each (S, head_dim) fp32: the rotation of position p on
    channel pair (c, c + head_dim/2)."""
    inv = _inv_freq(head_dim, theta)
    if scaling is not None:
        inv = _llama3_scale_inv_freq(inv, *scaling)
    t = np.arange(s, dtype=np.float32)[:, None] * inv[None]
    freqs = torch.from_numpy(np.concatenate([t, t], axis=-1)).to(device)
    return torch.cos(freqs), torch.sin(freqs)


def _rotate_half(x):
    a, b = x.chunk(2, dim=-1)
    return torch.cat([-b, a], dim=-1)


def _mrope_tables(pos_ids: torch.Tensor, head_dim: int, theta: float,
                  section: Tuple[int, int, int]):
    """Qwen2.5-VL multimodal rope tables from 3-stream position ids.

    pos_ids (3, S): temporal / height / width positions (text tokens carry
    the same value in all three).  Channel c of head_dim // 2 takes stream k
    where c falls in section k (HF apply_multimodal_rotary_pos_emb's i % 3
    chunk pattern, collapsed to one select because the tables are (freqs,
    freqs) duplicated)."""
    inv = torch.from_numpy(_inv_freq(head_dim, theta)).to(pos_ids.device)
    freqs = pos_ids[:, :, None].float() * inv[None, None]   # (3, S, hd/2)
    bounds = np.cumsum((0,) + tuple(section))
    sel = torch.cat([freqs[k, :, bounds[k]:bounds[k + 1]] for k in range(3)], dim=-1)
    emb = torch.cat([sel, sel], dim=-1)                     # (S, head_dim)
    return torch.cos(emb), torch.sin(emb)


def _large_negative(dtype: torch.dtype) -> float:
    """jax.nn.dot_product_attention's fill for masked logits."""
    return -0.7 * torch.finfo(dtype).max


def masked_attention(q, k, v, mask):
    """`jax.nn.dot_product_attention(q, k, v, mask=mask)` on (B, S, H, D)
    tensors through `F.scaled_dot_product_attention`: keys where the
    boolean `mask` (broadcast to (B, H, Sq, Sk)) is False take JAX's fill,
    -0.7 * the dtype's largest value, added to the logits (in fp32 the sum
    is the fill itself), so a query with no valid key averages every value
    uniformly, as JAX's does.  An empty sequence returns at once."""
    if q.shape[1] == 0:
        return q
    bias = torch.zeros(mask.shape, dtype=q.dtype, device=q.device).masked_fill(
        ~mask, _large_negative(q.dtype))
    out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                         v.transpose(1, 2), attn_mask=bias)
    return out.transpose(1, 2)


class _LlamaLayer(nn.Module):
    """Pre-norm decoder layer: RMS -> GQA attention (optional qkv bias,
    Qwen3's per-head q/k RMS before RoPE, RoPE in fp32, k/v repeated to the
    query heads) -> RMS -> SwiGLU."""

    def __init__(self, c: LlamaConfig):
        super().__init__()
        self.cfg = c
        dt, hd = c.dtype, c.head_width
        self.ln1 = RMSNorm(c.dim, c.rms_eps)
        self.q = Linear(c.dim, c.heads * hd, bias=c.qkv_bias, compute_dtype=dt)
        self.k = Linear(c.dim, c.kv_heads * hd, bias=c.qkv_bias, compute_dtype=dt)
        self.v = Linear(c.dim, c.kv_heads * hd, bias=c.qkv_bias, compute_dtype=dt)
        if c.qk_norm:
            self.q_norm = RMSNorm(hd, c.rms_eps)
            self.k_norm = RMSNorm(hd, c.rms_eps)
        self.o = Linear(c.heads * hd, c.dim, bias=False, compute_dtype=dt)
        self.ln2 = RMSNorm(c.dim, c.rms_eps)
        self.gate = Linear(c.dim, c.intermediate, bias=False, compute_dtype=dt)
        self.up = Linear(c.dim, c.intermediate, bias=False, compute_dtype=dt)
        self.down = Linear(c.intermediate, c.dim, bias=False, compute_dtype=dt)

    def forward(self, x, cos, sin, mask):
        c = self.cfg
        dt = c.dtype
        h = self.ln1(x)
        b, s, _ = h.shape
        hd = c.head_width
        q = self.q(h).view(b, s, c.heads, hd)
        k = self.k(h).view(b, s, c.kv_heads, hd)
        v = self.v(h).view(b, s, c.kv_heads, hd)
        if c.qk_norm:  # Qwen3: per-head RMS over head_dim, before RoPE
            q, k = self.q_norm(q), self.k_norm(k)
        cs, sn = cos[None, :, None], sin[None, :, None]
        q = (q.float() * cs + _rotate_half(q.float()) * sn).to(dt)
        k = (k.float() * cs + _rotate_half(k.float()) * sn).to(dt)
        rep = c.heads // c.kv_heads
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        att = masked_attention(q, k, v, mask)
        x = x + self.o(att.reshape(b, s, c.heads * hd))
        h = self.ln2(x)
        return x + self.down(F.silu(self.gate(h)) * self.up(h))


class LlamaEncoder(nn.Module):
    """Causal LM trunk used as an encoder.

    forward(ids, attn_mask=None, embeds=None, pos_ids=None) ->
    (hidden_states (L+1, B, S, D), HF-indexed, final_norm(last)).  HiDream
    consumes a selection of the per-layer states; Qwen-Image and the Qwen3
    families take the final-normed last state.  `attn_mask` (B, S) 1/0 marks
    the valid keys (with the causal mask); `embeds` (B, S, dim) overrides
    the token-embedding lookup (the Qwen2.5-VL vision tokens spliced in at
    the <|image_pad|> positions; `ids` still gives the shape); `pos_ids`
    (3, S) engages the multimodal rope (cfg.mrope_section)."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Parameter(torch.empty(cfg.vocab_size, cfg.dim))
        self.layers = nn.ModuleList(_LlamaLayer(cfg) for _ in range(cfg.layers))
        self.final_ln = RMSNorm(cfg.dim, cfg.rms_eps)

    def forward(self, ids: torch.Tensor, attn_mask: Optional[torch.Tensor] = None,
                embeds: Optional[torch.Tensor] = None, pos_ids: Optional[torch.Tensor] = None):
        c = self.cfg
        b, s = ids.shape
        x = (self.embed_tokens[ids] if embeds is None else embeds).to(c.dtype)
        if pos_ids is not None:
            cos, sin = _mrope_tables(torch.as_tensor(pos_ids, device=ids.device), c.head_width,
                                     c.rope_theta, c.mrope_section)
        else:
            cos, sin = _llama_rope(s, c.head_width, c.rope_theta, c.rope_scaling, ids.device)
        mask = torch.ones((s, s), dtype=torch.bool, device=ids.device).tril()[None, None]
        if attn_mask is not None:
            mask = mask & attn_mask[:, None, None, :].bool()
        hs = [x]
        for layer in self.layers:
            x = layer(x, cos, sin, mask)
            hs.append(x)
        return torch.stack(hs), self.final_ln(x)


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


@torch.no_grad()
def llama_encode(model: LlamaEncoder, ids, attn_mask=None):
    return model(ids, attn_mask)
