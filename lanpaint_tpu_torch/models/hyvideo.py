"""HunyuanVideo DiT, the backbone of the reference's "Hunyuan" family, as a
torch module.

PyTorch counterpart of `lanpaint_tpu/models/hyvideo.py` (tencent's
HunyuanVideo T2V, which the reference's Hunyuan workflow samples as a
single-frame T2I model):

* double-stream blocks: separate img / txt weights, fused qkv, per-head
  RMS q / k norms, joint attention over [img; txt] (image tokens first,
  unlike Flux), 6-way AdaLN;
* single-stream blocks: fused `linear1` / `linear2`, parallel attention
  and MLP;
* the token refiner `txt_in`: transformer blocks over the raw llava
  features (affine LayerNorms, plain self-attention, SiLU MLP), gated by
  AdaLN on the timestep embedding plus the projected mean of the context
  over every token, padding included;
* conditioning vector = time_in(t) + vector_in(CLIP-L pooled) +
  guidance_in(g * 1000), the distilled-CFG input (6.0 when none is given);
* 3D RoPE over (t, y, x), axes (16, 56, 56), theta 256, on the image
  tokens only.

Compute in `cfg.dtype` (bf16 by default); the adaLN pre-norms return fp32
and the modulation runs in fp32 before the downcast; the final projection
runs in fp32.  Scanned blocks are `double.<i>` / `single.<i>` and
`txt_in.refiner.<i>` as the flax scans name them; `nn.Module.double` (the
float64 cast) shadows the attribute, so that stack lives in `_modules`
directly.

Kernels on CUDA: the double and single blocks' joint attention through
`layers.attention_bshd` (H = 24, D = 128); the adaLN pre-norms
(`layernorm_na`, LN -> fp32), the refiner's affine `LayerNormF32` and the
per-head q / k RMS norms (strided column views of `*_attn_qkv` and of
`linear1`) through the row-norm kernel.  The refiner's attention over the
text tokens is plain (`attention_ref`), where the JAX package asks XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention_ref
from .dit import _gelu, _modulate
from .layers import (
    LayerNormF32,
    Linear,
    MLPEmbedder,
    RMSNorm,
    apply_rope,
    attention_bshd,
    layernorm_na,
    rope_freqs,
    timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class HYVideoConfig:
    in_channels: int = 16
    out_channels: int = 16
    hidden: int = 3072
    num_heads: int = 24
    mlp_ratio: float = 4.0
    depth_double: int = 20
    depth_single: int = 40
    refiner_depth: int = 2
    context_dim: int = 4096        # llava-llama3 token features
    vec_dim: int = 768             # CLIP-L pooled
    guidance_embed: bool = True    # t2v_720p is the distilled-CFG model
    patch: Tuple[int, int, int] = (1, 2, 2)
    axes_dim: Tuple[int, ...] = (16, 56, 56)
    theta: float = 256.0
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden // self.num_heads

    @property
    def mlp_hidden(self) -> int:
        return int(self.hidden * self.mlp_ratio)


HUNYUAN_VIDEO_720P_CONFIG = HYVideoConfig()
TINY_HYVIDEO_CONFIG = HYVideoConfig(
    in_channels=4, out_channels=4, hidden=64, num_heads=4,
    depth_double=2, depth_single=2, refiner_depth=2,
    context_dim=32, vec_dim=16, axes_dim=(4, 6, 6),
)


def _heads(x, cfg: HYVideoConfig):
    return x.unflatten(-1, (cfg.num_heads, cfg.head_dim))


class _RefinerBlock(nn.Module):
    """Token-refiner block: plain self-attention (no RoPE, no q/k norm), a
    SiLU MLP, a 2-gate AdaLN on the (t + pooled context) vector."""

    def __init__(self, cfg: HYVideoConfig):
        super().__init__()
        self.cfg = cfg
        h, dt = cfg.hidden, cfg.dtype
        self.adaLN_modulation = Linear(h, 2 * h, compute_dtype=dt)
        self.norm1 = LayerNormF32(h)
        self.self_attn_qkv = Linear(h, 3 * h, compute_dtype=dt)
        self.self_attn_proj = Linear(h, h, compute_dtype=dt)
        self.norm2 = LayerNormF32(h)
        self.mlp_fc1 = Linear(h, cfg.mlp_hidden, compute_dtype=dt)
        self.mlp_fc2 = Linear(cfg.mlp_hidden, h, compute_dtype=dt)

    def forward(self, x, c):
        cfg, dt = self.cfg, self.cfg.dtype
        gate_msa, gate_mlp = self.adaLN_modulation(F.silu(c))[:, None, :].chunk(2, dim=-1)
        q, k, v = (_heads(t, cfg)
                   for t in self.self_attn_qkv(self.norm1(x).to(dt)).chunk(3, dim=-1))
        x = x + gate_msa * self.self_attn_proj(attention_ref(q, k, v).flatten(2))
        hdn = F.silu(self.mlp_fc1(self.norm2(x).to(dt)))
        return x + gate_mlp * self.mlp_fc2(hdn)


class TokenRefiner(nn.Module):
    """`txt_in`: raw llava context -> hidden-width refined text tokens."""

    def __init__(self, cfg: HYVideoConfig):
        super().__init__()
        self.cfg = cfg
        h, dt = cfg.hidden, cfg.dtype
        self.t_embedder = MLPEmbedder(256, h, dtype=dt)
        self.c_embedder = MLPEmbedder(cfg.context_dim, h, dtype=dt)
        self.input_embedder = Linear(cfg.context_dim, h, compute_dtype=dt)
        self.refiner = nn.ModuleList(_RefinerBlock(cfg) for _ in range(cfg.refiner_depth))

    def forward(self, context, t):
        dt = self.cfg.dtype
        c = self.t_embedder(timestep_embedding(t * 1000.0, 256).to(dt))
        # the raw context's mean over every token, padding included
        c = c + self.c_embedder(torch.mean(context.float(), dim=1).to(dt))
        x = self.input_embedder(context.to(dt))
        for block in self.refiner:
            x = block(x, c)
        return x


class HYDoubleBlock(nn.Module):
    def __init__(self, cfg: HYVideoConfig):
        super().__init__()
        self.cfg = cfg
        h, dt = cfg.hidden, cfg.dtype
        for p in ("img", "txt"):
            self.add_module(f"{p}_mod", Linear(h, 6 * h, compute_dtype=dt))
            self.add_module(f"{p}_attn_qkv", Linear(h, 3 * h, compute_dtype=dt))
            self.add_module(f"{p}_q_norm", RMSNorm(cfg.head_dim))
            self.add_module(f"{p}_k_norm", RMSNorm(cfg.head_dim))
            self.add_module(f"{p}_attn_proj", Linear(h, h, compute_dtype=dt))
            self.add_module(f"{p}_mlp_fc1", Linear(h, cfg.mlp_hidden, compute_dtype=dt))
            self.add_module(f"{p}_mlp_fc2", Linear(cfg.mlp_hidden, h, compute_dtype=dt))

    def _qkv(self, x, prefix):
        """q, k, v column views of the fused projection, q and k normalized
        per head in place of the view."""
        q, k, v = (_heads(t, self.cfg)
                   for t in getattr(self, f"{prefix}_attn_qkv")(x).chunk(3, dim=-1))
        return getattr(self, f"{prefix}_q_norm")(q), getattr(self, f"{prefix}_k_norm")(k), v

    def forward(self, img, txt, vec, pe):
        dt = self.cfg.dtype
        im1_s, im1_c, im1_g, im2_s, im2_c, im2_g = \
            self.img_mod(F.silu(vec))[:, None, :].chunk(6, dim=-1)
        tx1_s, tx1_c, tx1_g, tx2_s, tx2_c, tx2_g = \
            self.txt_mod(F.silu(vec))[:, None, :].chunk(6, dim=-1)

        iq, ik, iv = self._qkv(_modulate(layernorm_na(img), im1_s, im1_c).to(dt), "img")
        tq, tk, tv = self._qkv(_modulate(layernorm_na(txt), tx1_s, tx1_c).to(dt), "txt")
        # RoPE on the image tokens only; joint attention over [img; txt]
        q = torch.cat([apply_rope(iq, pe), tq], dim=1)
        k = torch.cat([apply_rope(ik, pe), tk], dim=1)
        attn = attention_bshd(q, k, torch.cat([iv, tv], dim=1)).flatten(2)
        n_img = img.shape[1]
        img_a, txt_a = attn[:, :n_img], attn[:, n_img:]

        img = img + im1_g * self.img_attn_proj(img_a)
        txt = txt + tx1_g * self.txt_attn_proj(txt_a)

        img_n2 = _modulate(layernorm_na(img), im2_s, im2_c).to(dt)
        txt_n2 = _modulate(layernorm_na(txt), tx2_s, tx2_c).to(dt)
        img = img + im2_g * self.img_mlp_fc2(_gelu(self.img_mlp_fc1(img_n2)))
        txt = txt + tx2_g * self.txt_mlp_fc2(_gelu(self.txt_mlp_fc1(txt_n2)))
        return img, txt


class HYSingleBlock(nn.Module):
    """Fused single-stream block; q, k and v are views of one `linear1`
    output, RoPE on the leading `n_img` (image) tokens only."""

    def __init__(self, cfg: HYVideoConfig):
        super().__init__()
        self.cfg = cfg
        h, dt = cfg.hidden, cfg.dtype
        self.modulation = Linear(h, 3 * h, compute_dtype=dt)
        self.linear1 = Linear(h, 3 * h + cfg.mlp_hidden, compute_dtype=dt)
        self.linear2 = Linear(h + cfg.mlp_hidden, h, compute_dtype=dt)
        self.q_norm = RMSNorm(cfg.head_dim)
        self.k_norm = RMSNorm(cfg.head_dim)

    def forward(self, x, vec, pe, n_img):
        cfg = self.cfg
        shift, scale, gate = self.modulation(F.silu(vec))[:, None, :].chunk(3, dim=-1)
        fused = self.linear1(_modulate(layernorm_na(x), shift, scale).to(cfg.dtype))
        qkv, mlp = fused[..., :3 * cfg.hidden], fused[..., 3 * cfg.hidden:]
        q, k, v = (_heads(t, cfg) for t in qkv.chunk(3, dim=-1))
        q, k = self.q_norm(q), self.k_norm(k)
        q = torch.cat([apply_rope(q[:, :n_img], pe), q[:, n_img:]], dim=1)
        k = torch.cat([apply_rope(k[:, :n_img], pe), k[:, n_img:]], dim=1)
        attn = attention_bshd(q, k, v).flatten(2)
        return x + gate * self.linear2(torch.cat([attn, _gelu(mlp)], dim=-1))


class HYLastLayer(nn.Module):
    def __init__(self, cfg: HYVideoConfig):
        super().__init__()
        self.adaLN_modulation = Linear(cfg.hidden, 2 * cfg.hidden, compute_dtype=cfg.dtype)
        self.linear = Linear(cfg.hidden, cfg.out_channels * cfg.patch[0] * cfg.patch[1]
                             * cfg.patch[2], compute_dtype=torch.float32)

    def forward(self, x, vec):
        shift, scale = self.adaLN_modulation(F.silu(vec))[:, None, :].chunk(2, dim=-1)
        return self.linear(_modulate(layernorm_na(x), shift, scale).float())


def pack_video(x: torch.Tensor, patch) -> torch.Tensor:
    """(B, C, T, H, W) -> (B, T/pf * H/ph * W/pw, C*pf*ph*pw) tokens."""
    b, c, t, hh, ww = x.shape
    pf, ph, pw = patch
    x = x.reshape(b, c, t // pf, pf, hh // ph, ph, ww // pw, pw).permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b, (t // pf) * (hh // ph) * (ww // pw), c * pf * ph * pw)


def unpack_video(tokens: torch.Tensor, t: int, h: int, w: int, patch) -> torch.Tensor:
    """Inverse of pack_video."""
    pf, ph, pw = patch
    b, _, cp = tokens.shape
    c = cp // (pf * ph * pw)
    x = tokens.reshape(b, t // pf, h // ph, w // pw, c, pf, ph, pw).permute(0, 4, 1, 5, 2, 6, 3, 7)
    return x.reshape(b, c, t, h, w)


def video_ids(b: int, t: int, h: int, w: int, patch, device=None) -> torch.Tensor:
    """(B, S, 3) RoPE ids (frame, y, x) per token."""
    pf, ph, pw = patch
    grid = torch.meshgrid(*(torch.arange(n, device=device) for n in (t // pf, h // ph, w // pw)),
                          indexing="ij")
    ids = torch.stack(grid, dim=-1).reshape(-1, 3)
    return ids[None].expand(b, -1, -1)


class HYVideoDiT(nn.Module):
    """forward(x_bcthw, t, context, vec, guidance) -> velocity prediction.

    x: (B, C, T, H, W) video latent (T = 1 for the reference's T2I use).
    context: (B, L, 4096) llava-llama3 token features.
    vec: (B, 768) CLIP-L pooled.  guidance: (B,) distilled-CFG scale."""

    def __init__(self, cfg: HYVideoConfig):
        super().__init__()
        self.cfg = cfg
        h, dt = cfg.hidden, cfg.dtype
        pf, ph, pw = cfg.patch
        self.img_in = Linear(cfg.in_channels * pf * ph * pw, h, compute_dtype=dt)
        self.txt_in = TokenRefiner(cfg)
        self.time_in = MLPEmbedder(256, h, dtype=dt)
        if cfg.vec_dim > 0:
            self.vector_in = MLPEmbedder(cfg.vec_dim, h, dtype=dt)
        if cfg.guidance_embed:
            self.guidance_in = MLPEmbedder(256, h, dtype=dt)
        self._modules["double"] = nn.ModuleList(
            HYDoubleBlock(cfg) for _ in range(cfg.depth_double))
        self.single = nn.ModuleList(HYSingleBlock(cfg) for _ in range(cfg.depth_single))
        self.final_layer = HYLastLayer(cfg)

    def forward(self, x, t, context, vec=None, guidance=None):
        cfg, dt = self.cfg, self.cfg.dtype
        b, _, tt, hh, ww = x.shape
        img = self.img_in(pack_video(x, cfg.patch).to(dt))
        n_img = img.shape[1]
        t = torch.as_tensor(t, device=x.device).float().reshape(-1)
        txt = self.txt_in(context, t)

        v = self.time_in(timestep_embedding(t * 1000.0, 256).to(dt))
        if cfg.vec_dim > 0:
            if vec is None:
                raise ValueError("HunyuanVideo needs the CLIP-L pooled `vec`")
            v = v + self.vector_in(vec.to(dt))
        if cfg.guidance_embed:
            g = (torch.full((b,), 6.0, device=x.device) if guidance is None
                 else torch.as_tensor(guidance, device=x.device).float().reshape(-1))
            v = v + self.guidance_in(timestep_embedding(g * 1000.0, 256).to(dt))

        pe = rope_freqs(video_ids(b, tt, hh, ww, cfg.patch, device=x.device), cfg.axes_dim,
                        cfg.theta)
        for block in self._modules["double"]:
            img, txt = block(img, txt, v, pe)
        xcat = torch.cat([img, txt], dim=1)  # image tokens first
        for block in self.single:
            xcat = block(xcat, v, pe, n_img)
        out = self.final_layer(xcat[:, :n_img], v)
        return unpack_video(out, tt, hh, ww, cfg.patch)
