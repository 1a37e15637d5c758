"""Z-Image single-stream DiT (Tongyi S3-DiT, the Lumina2 / NextDiT graph) as
a torch module.

PyTorch counterpart of `lanpaint_tpu/models/zimage.py`, the model of the
reference's Z_image_Inpaint.json workflow (Qwen3-4B prompt states, the Flux
16-channel VAE, shift 3):

* `x_embedder`, a Linear on packed 2x2 patches; `cap_norm` + `cap_proj`
  (RMSNorm + Linear) on the Qwen3-4B hidden states;
* `context_refiner.<i>`, unmodulated blocks over the text tokens;
  `noise_refiner.<i>`, t-modulated blocks over the image tokens;
  `layers.<i>`, the main blocks over [txt; img];
* each block (`ZBlock`): fused GQA `attention.qkv` (no bias), per-head RMS
  q/k norm, RoPE, SwiGLU `feed_forward.w1/w2/w3`, sandwich RMSNorms
  (attention_norm1/2, ffn_norm1/2), tanh-gated scale-only adaLN;
* `norm_final` RMSNorm, then a parameter-free LayerNorm scaled by
  `final_adaLN_1` and `final_linear` in fp32.

The config's dims are the JAX package's, "recalled-unverified" in
docs/family_facts.md.  Compute in `cfg.dtype` (bf16 by default), RoPE and
the final LayerNorm in fp32.  Attention goes through
`layers.attention_bshd` (the D <= 128 kernel on CUDA for the main layers
at n_txt + 4,096 tokens and the noise refiner at 4,096; the context
refiner's few text tokens stay plain, where the JAX package leaves them to
XLA); GQA k/v heads are repeated before the call, as in JAX.  Every
RMSNorm goes through the row-norm kernel, the q/k norms on strided views of
the fused qkv; the final LayerNorm stays plain torch (jnp in JAX).
Submodules are named after the flax modules, so models/bridge.py maps the
three scanned stacks (`context_refiner/block`, `noise_refiner/block`,
`layers/block`) one to one.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .dit import image_ids, pack_latent, unpack_latent
from .layers import Linear, RMSNorm, apply_rope, attention_bshd, rope_freqs, timestep_embedding


@dataclasses.dataclass(frozen=True)
class ZImageConfig:
    in_channels: int = 16           # latent channels (Flux ae)
    out_channels: int = 16
    patch: int = 2
    hidden: int = 3840
    num_heads: int = 30
    num_kv_heads: int = 30          # GQA-capable fused qkv layout
    depth: int = 30                 # main layers
    refiner_depth: int = 2          # noise_refiner blocks
    context_refiner_depth: int = 2
    ffn_dim: int = 10240            # SwiGLU inner width
    cap_dim: int = 2560             # Qwen3-4B hidden states
    axes_dim: Tuple[int, ...] = (32, 48, 48)
    theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden // self.num_heads

    @property
    def t_dim(self) -> int:
        # NextDiT: TimestepEmbedder(min(dim, 1024))
        return min(self.hidden, 1024)

    @property
    def latent_channels(self) -> int:
        return self.in_channels


Z_IMAGE_S3_CONFIG = ZImageConfig()
TINY_ZIMAGE_CONFIG = ZImageConfig(
    in_channels=4, out_channels=4, hidden=48, num_heads=4, num_kv_heads=2,
    depth=2, refiner_depth=1, context_refiner_depth=1, ffn_dim=80,
    cap_dim=24, axes_dim=(4, 4, 4),
)


class ZAttention(nn.Module):
    """Fused-QKV grouped-query attention with per-head RMS q/k norm."""

    def __init__(self, cfg: ZImageConfig):
        super().__init__()
        self.cfg = cfg
        h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.qkv = Linear(cfg.hidden, (h + 2 * kvh) * d, bias=False, compute_dtype=cfg.dtype)
        self.q_norm = RMSNorm(d)
        self.k_norm = RMSNorm(d)
        self.out = Linear(h * d, cfg.hidden, bias=False, compute_dtype=cfg.dtype)

    def forward(self, x, pe):
        cfg = self.cfg
        h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        b, s, _ = x.shape
        qkv = self.qkv(x)
        # strided column views of the fused projection (the row norm reads
        # them in place)
        q = qkv[..., :h * d].unflatten(-1, (h, d))
        k = qkv[..., h * d:(h + kvh) * d].unflatten(-1, (kvh, d))
        v = qkv[..., (h + kvh) * d:].unflatten(-1, (kvh, d))
        q = apply_rope(self.q_norm(q), pe)
        k = apply_rope(self.k_norm(k), pe)
        if kvh != h:
            k = k.repeat_interleave(h // kvh, dim=2)
            v = v.repeat_interleave(h // kvh, dim=2)
        return self.out(attention_bshd(q, k, v).reshape(b, s, h * d))


class ZSwiGLU(nn.Module):
    def __init__(self, cfg: ZImageConfig):
        super().__init__()
        dt = cfg.dtype
        self.w1 = Linear(cfg.hidden, cfg.ffn_dim, bias=False, compute_dtype=dt)
        self.w3 = Linear(cfg.hidden, cfg.ffn_dim, bias=False, compute_dtype=dt)
        self.w2 = Linear(cfg.ffn_dim, cfg.hidden, bias=False, compute_dtype=dt)

    def forward(self, x):
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class ZBlock(nn.Module):
    """NextDiT JointTransformerBlock: sandwich RMSNorm, tanh-gated adaLN
    (scale and gate only, no shift) when `modulated`."""

    def __init__(self, cfg: ZImageConfig, modulated: bool = True):
        super().__init__()
        self.cfg = cfg
        self.modulated = modulated
        h = cfg.hidden
        if modulated:
            self.adaLN_modulation_1 = Linear(cfg.t_dim, 4 * h, compute_dtype=cfg.dtype)
        self.attention_norm1 = RMSNorm(h)
        self.attention = ZAttention(cfg)
        self.attention_norm2 = RMSNorm(h)
        self.ffn_norm1 = RMSNorm(h)
        self.feed_forward = ZSwiGLU(cfg)
        self.ffn_norm2 = RMSNorm(h)

    def forward(self, x, pe, t_emb=None):
        dt = self.cfg.dtype
        if self.modulated:
            mod = self.adaLN_modulation_1(F.silu(t_emb))[:, None, :]
            s_msa, g_msa, s_mlp, g_mlp = mod.chunk(4, dim=-1)
            g_msa, g_mlp = torch.tanh(g_msa), torch.tanh(g_mlp)
        else:
            s_msa = g_msa = s_mlp = g_mlp = None

        def scale(v, s):
            return v if s is None else v * (1.0 + s)

        def gate(v, g):
            return v if g is None else v * g

        h = self.attention(scale(self.attention_norm1(x), s_msa).to(dt), pe)
        x = x + gate(self.attention_norm2(h), g_msa)
        h = self.feed_forward(scale(self.ffn_norm1(x), s_mlp).to(dt))
        return x + gate(self.ffn_norm2(h), g_mlp)


class ZImageModel(nn.Module):
    """forward(x_nchw, t, context) -> velocity prediction.

    `context`: (B, S_txt, cap_dim) Qwen3-4B hidden states."""

    def __init__(self, cfg: ZImageConfig):
        super().__init__()
        self.cfg = cfg
        dt, h = cfg.dtype, cfg.hidden
        self.x_embedder = Linear(cfg.in_channels * cfg.patch ** 2, h, compute_dtype=dt)
        self.cap_norm = RMSNorm(cfg.cap_dim)
        self.cap_proj = Linear(cfg.cap_dim, h, compute_dtype=dt)
        self.t_mlp_0 = Linear(256, cfg.t_dim, compute_dtype=dt)
        self.t_mlp_2 = Linear(cfg.t_dim, cfg.t_dim, compute_dtype=dt)
        self.context_refiner = nn.ModuleList(
            ZBlock(cfg, modulated=False) for _ in range(cfg.context_refiner_depth))
        self.noise_refiner = nn.ModuleList(ZBlock(cfg) for _ in range(cfg.refiner_depth))
        self.layers = nn.ModuleList(ZBlock(cfg) for _ in range(cfg.depth))
        self.norm_final = RMSNorm(h)
        self.final_adaLN_1 = Linear(cfg.t_dim, h, compute_dtype=dt)
        self.final_linear = Linear(h, cfg.out_channels * cfg.patch ** 2,
                                   compute_dtype=torch.float32)

    def forward(self, x, t, context):
        cfg = self.cfg
        dt = cfg.dtype
        b, _, hh, ww = x.shape
        img = self.x_embedder(pack_latent(x, cfg.patch).to(dt))
        txt = self.cap_proj(self.cap_norm(context).to(dt))

        t = torch.as_tensor(t, device=x.device).float().reshape(-1)
        t_emb = self.t_mlp_0(timestep_embedding(t * 1000.0, 256).to(dt))
        t_emb = self.t_mlp_2(F.silu(t_emb))

        # position ids: text tokens advance on axis 0; image tokens sit at
        # axis 0 = n_txt with 2D spatial ids (NextDiT joint rope)
        n_txt = txt.shape[1]
        txt_ids = torch.zeros((b, n_txt, 3), dtype=torch.long, device=x.device)
        txt_ids[..., 0] = torch.arange(n_txt, device=x.device)
        im_ids = image_ids(b, hh, ww, cfg.patch, device=x.device).clone()
        im_ids[..., 0] += n_txt
        pe_txt = rope_freqs(txt_ids, cfg.axes_dim, cfg.theta)
        pe_img = rope_freqs(im_ids, cfg.axes_dim, cfg.theta)
        pe_all = torch.cat([pe_txt, pe_img], dim=1)

        for block in self.context_refiner:
            txt = block(txt, pe_txt)
        for block in self.noise_refiner:
            img = block(img, pe_img, t_emb)
        xcat = torch.cat([txt, img], dim=1)
        for block in self.layers:
            xcat = block(xcat, pe_all, t_emb)
        img = self.norm_final(xcat[:, n_txt:])

        scale = self.final_adaLN_1(F.silu(t_emb))[:, None, :]
        # FinalLayer: parameter-free LayerNorm (fp32), scale-only modulation
        imf = img.float()
        mu = torch.mean(imf, dim=-1, keepdim=True)
        var = torch.var(imf, dim=-1, keepdim=True, unbiased=False)
        normed = (imf - mu) * torch.rsqrt(var + 1e-6) * (1.0 + scale.float())
        return unpack_latent(self.final_linear(normed), hh, ww, cfg.patch)
