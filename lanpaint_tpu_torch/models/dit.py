"""Flow-matching MMDiT family (Flux and its relatives) as a torch module.

PyTorch counterpart of `lanpaint_tpu/models/dit.py`: double-stream blocks
(separate image and text weights, joint attention), single-stream blocks
(parallel attention and MLP), QK-RMSNorm, multi-axis RoPE and adaLN
modulation.  Tokens stay (B, S, hidden); compute in `cfg.dtype` (bf16 by
default); the adaLN pre-norm returns fp32 and the modulation runs in fp32
before the downcast; the residual streams stay in the compute dtype; the
final projection runs in fp32.  Submodule names follow the flax module
names, with the scanned blocks as `double.<i>` / `single.<i>`, so
models/bridge.py maps a flax parameter tree onto the state_dict one to one.

Joint self-attention goes through `layers.attention_bshd` (the
flash-attention kernel on CUDA at S >= 1024, D % 64 == 0), every
`layernorm_na` and `QKNorm` through the row-norm kernel.  The JAX config's
`attention_impl` knob is not carried over: the port routes by shape only.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (
    Linear,
    MLPEmbedder,
    QKNorm,
    RMSNorm,
    apply_rope,
    attention_bshd,
    layernorm_na,
    rope_freqs,
    timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    in_channels: int = 64          # packed 2x2 patches of the 16ch latent
    out_channels: int = 64
    hidden: int = 3072
    num_heads: int = 24
    mlp_ratio: float = 4.0
    depth_double: int = 19
    depth_single: int = 38
    context_dim: int = 4096        # T5 features
    vec_dim: int = 768             # pooled CLIP
    guidance_embed: bool = True    # Flux-dev guidance distillation input
    axes_dim: Tuple[int, ...] = (16, 56, 56)
    theta: float = 10000.0
    patch: int = 2                 # latent pixels per token side
    latent_channels: int = 16
    # RMS-normalize the raw context features before txt_in (Qwen-Image)
    txt_norm: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden // self.num_heads


# The configurations of lanpaint_tpu/models/dit.py, which documents each
# one's source (the stand-ins' topologies are not all public).
FLUX_DEV_CONFIG = DiTConfig()
FLUX_SCHNELL_CONFIG = DiTConfig(guidance_embed=False)
QWEN_IMAGE_CONFIG = DiTConfig(
    hidden=3072, num_heads=24, depth_double=60, depth_single=0,
    context_dim=3584, vec_dim=0, guidance_embed=False, txt_norm=True,
)
Z_IMAGE_CONFIG = DiTConfig(
    hidden=2304, num_heads=18, depth_double=6, depth_single=30,
    context_dim=2560, vec_dim=0, guidance_embed=False,
)
FLUX2_DEV_CONFIG = DiTConfig(
    hidden=5120, num_heads=40, depth_double=8, depth_single=38,
    context_dim=5120, vec_dim=0, guidance_embed=True,
)
FLUX2_KLEIN_CONFIG = DiTConfig(
    hidden=3584, num_heads=28, depth_double=8, depth_single=28,
    context_dim=4096, vec_dim=0, guidance_embed=False,
)
KREA2_CONFIG = DiTConfig(
    context_dim=2560, vec_dim=0, guidance_embed=False,
)
ANIMA_CONFIG = DiTConfig(
    hidden=2048, num_heads=16, depth_double=8, depth_single=24,
    context_dim=1024, vec_dim=0, guidance_embed=False,
)
IDEOGRAM4_CONFIG = DiTConfig(
    hidden=3072, num_heads=24, depth_double=8, depth_single=30,
    context_dim=4096, vec_dim=0, guidance_embed=False,
)
SD35_LARGE_CONFIG = DiTConfig(
    hidden=2432, num_heads=38, depth_double=38, depth_single=0,
    context_dim=4096, vec_dim=2048, guidance_embed=False,
    axes_dim=(16, 24, 24),
)
HIDREAM_CONFIG = DiTConfig(
    hidden=2560, num_heads=20, depth_double=16, depth_single=32,
    context_dim=4096, vec_dim=2048, guidance_embed=False,
)
TINY_DIT_CONFIG = DiTConfig(
    in_channels=16, out_channels=16, hidden=64, num_heads=4,
    depth_double=2, depth_single=2, context_dim=32, vec_dim=16,
    guidance_embed=False, axes_dim=(4, 6, 6), latent_channels=4,
)


class Modulation(nn.Module):
    """AdaLN modulation: vec -> n_sets x (shift, scale, gate), each (B, 1, hidden)."""

    def __init__(self, hidden: int, double: bool, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n = 6 if double else 3
        self.lin = Linear(hidden, self.n * hidden, compute_dtype=dtype)

    def forward(self, vec):
        return self.lin(F.silu(vec))[:, None, :].chunk(self.n, dim=-1)


def _modulate(x, shift, scale):
    return (1 + scale) * x + shift


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # flax nn.gelu's default


class DoubleStreamBlock(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        h, dt = cfg.hidden, cfg.dtype
        mlp_h = int(h * cfg.mlp_ratio)
        for p in ("img", "txt"):
            self.add_module(f"{p}_mod", Modulation(h, True, dtype=dt))
            self.add_module(f"{p}_attn_qkv", Linear(h, 3 * h, compute_dtype=dt))
            self.add_module(f"{p}_attn_qknorm", QKNorm(cfg.head_dim))
            self.add_module(f"{p}_attn_proj", Linear(h, h, compute_dtype=dt))
            self.add_module(f"{p}_mlp_0", Linear(h, mlp_h, compute_dtype=dt))
            self.add_module(f"{p}_mlp_2", Linear(mlp_h, h, compute_dtype=dt))

    def _qkv(self, x, prefix):
        heads = (self.cfg.num_heads, self.cfg.head_dim)
        q, k, v = (t.unflatten(-1, heads)
                   for t in getattr(self, f"{prefix}_attn_qkv")(x).chunk(3, dim=-1))
        q, k = getattr(self, f"{prefix}_attn_qknorm")(q, k)
        return q, k, v

    def forward(self, img, txt, vec, pe):
        dt = self.cfg.dtype
        im1_shift, im1_scale, im1_gate, im2_shift, im2_scale, im2_gate = self.img_mod(vec)
        tx1_shift, tx1_scale, tx1_gate, tx2_shift, tx2_scale, tx2_gate = self.txt_mod(vec)

        iq, ik, iv = self._qkv(_modulate(layernorm_na(img), im1_shift, im1_scale).to(dt), "img")
        tq, tk, tv = self._qkv(_modulate(layernorm_na(txt), tx1_shift, tx1_scale).to(dt), "txt")

        # joint attention over [txt; img] with RoPE
        q = apply_rope(torch.cat([tq, iq], dim=1), pe)
        k = apply_rope(torch.cat([tk, ik], dim=1), pe)
        v = torch.cat([tv, iv], dim=1)
        attn = attention_bshd(q, k, v).flatten(2)
        n_txt = txt.shape[1]
        txt_a, img_a = attn[:, :n_txt], attn[:, n_txt:]

        img = img + im1_gate * self.img_attn_proj(img_a)
        txt = txt + tx1_gate * self.txt_attn_proj(txt_a)

        img_n2 = _modulate(layernorm_na(img), im2_shift, im2_scale).to(dt)
        txt_n2 = _modulate(layernorm_na(txt), tx2_shift, tx2_scale).to(dt)
        img = img + im2_gate * self.img_mlp_2(_gelu(self.img_mlp_0(img_n2)))
        txt = txt + tx2_gate * self.txt_mlp_2(_gelu(self.txt_mlp_0(txt_n2)))
        return img, txt


class SingleStreamBlock(nn.Module):
    """Fused single-stream block: parallel attention + MLP, one residual.
    q, k and v are views of one `linear1` output (no split copy)."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        h, dt = cfg.hidden, cfg.dtype
        mlp_h = int(h * cfg.mlp_ratio)
        self.modulation = Modulation(h, False, dtype=dt)
        self.linear1 = Linear(h, 3 * h + mlp_h, compute_dtype=dt)
        self.qknorm = QKNorm(cfg.head_dim)
        self.linear2 = Linear(h + mlp_h, h, compute_dtype=dt)

    def forward(self, x, vec, pe):
        cfg = self.cfg
        shift, scale, gate = self.modulation(vec)
        fused = self.linear1(_modulate(layernorm_na(x), shift, scale).to(cfg.dtype))
        qkv, mlp = fused[..., :3 * cfg.hidden], fused[..., 3 * cfg.hidden:]
        q, k, v = (t.unflatten(-1, (cfg.num_heads, cfg.head_dim)) for t in qkv.chunk(3, dim=-1))
        q, k = self.qknorm(q, k)
        attn = attention_bshd(apply_rope(q, pe), apply_rope(k, pe), v).flatten(2)
        return x + gate * self.linear2(torch.cat([attn, _gelu(mlp)], dim=-1))


class LastLayer(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.adaLN_modulation = Linear(cfg.hidden, 2 * cfg.hidden, compute_dtype=cfg.dtype)
        self.linear = Linear(cfg.hidden, cfg.out_channels, compute_dtype=torch.float32)

    def forward(self, x, vec):
        shift, scale = self.adaLN_modulation(F.silu(vec))[:, None, :].chunk(2, dim=-1)
        return self.linear(_modulate(layernorm_na(x), shift, scale).float())


def pack_latent(x: torch.Tensor, patch: int = 2) -> torch.Tensor:
    """(B, C, H, W) latent -> (B, H/p * W/p, C*p*p) token sequence."""
    b, c, hh, ww = x.shape
    x = x.reshape(b, c, hh // patch, patch, ww // patch, patch).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, (hh // patch) * (ww // patch), c * patch * patch)


def unpack_latent(tokens: torch.Tensor, h: int, w: int, patch: int = 2) -> torch.Tensor:
    """Inverse of pack_latent."""
    b, s, cpp = tokens.shape
    c = cpp // (patch * patch)
    x = tokens.reshape(b, h // patch, w // patch, c, patch, patch).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, c, h, w)


def image_ids(b: int, h: int, w: int, patch: int = 2, device=None) -> torch.Tensor:
    """(B, S, 3) position ids: (0, y, x) per token (Flux convention)."""
    hh, ww = h // patch, w // patch
    ys = torch.arange(hh, device=device).repeat_interleave(ww)
    xs = torch.arange(ww, device=device).repeat(hh)
    ids = torch.stack([torch.zeros_like(ys), ys, xs], dim=-1)
    return ids[None].expand(b, -1, -1)


class MMDiT(nn.Module):
    """forward(x_nchw_latent, t, context, vec, guidance, extra_tokens) -> velocity."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        h, dt = cfg.hidden, cfg.dtype
        self.img_in = Linear(cfg.in_channels, h, compute_dtype=dt)
        if cfg.txt_norm:
            self.txt_norm = RMSNorm(cfg.context_dim)
        self.txt_in = Linear(cfg.context_dim, h, compute_dtype=dt)
        self.time_in = MLPEmbedder(256, h, dtype=dt)
        if cfg.guidance_embed:
            self.guidance_in = MLPEmbedder(256, h, dtype=dt)
        if cfg.vec_dim > 0:
            self.vector_in = MLPEmbedder(cfg.vec_dim, h, dtype=dt)
        # named as the flax scans; `nn.Module.double` (the float64 cast)
        # shadows the attribute, so both stacks live in and are read from
        # `_modules` directly
        self._modules["double"] = nn.ModuleList(
            DoubleStreamBlock(cfg) for _ in range(cfg.depth_double))
        self.single = nn.ModuleList(SingleStreamBlock(cfg) for _ in range(cfg.depth_single))
        self.final_layer = LastLayer(cfg)

    def forward(self, x, t, context, vec=None, guidance=None, extra_tokens=None):
        cfg, dt = self.cfg, self.cfg.dtype
        b, _, hh, ww = x.shape
        img = pack_latent(x, cfg.patch).to(dt)
        # Qwen-Edit-style reference tokens (packed-latent space) share img_in,
        # join the sequence, and are dropped before the output unpack.
        n_extra = 0 if extra_tokens is None else extra_tokens.shape[1]
        if n_extra:
            img = torch.cat([img, extra_tokens.to(dt)], dim=1)
        img = self.img_in(img)
        ctx = context.to(dt)
        if cfg.txt_norm:
            ctx = self.txt_norm(ctx)
        txt = self.txt_in(ctx)

        t = torch.as_tensor(t, device=x.device).float().reshape(-1)
        vec_emb = self.time_in(timestep_embedding(t * 1000.0, 256).to(dt))
        if cfg.guidance_embed:
            g = (torch.full((b,), 3.5, device=x.device) if guidance is None
                 else torch.as_tensor(guidance, device=x.device).float().reshape(-1))
            vec_emb = vec_emb + self.guidance_in(timestep_embedding(g * 1000.0, 256).to(dt))
        if cfg.vec_dim > 0:
            if vec is None:
                raise ValueError("this DiT config needs pooled conditioning `vec`")
            vec_emb = vec_emb + self.vector_in(vec.to(dt))

        txt_ids = torch.zeros((b, txt.shape[1], 3), dtype=torch.long, device=x.device)
        img_ids = image_ids(b, hh, ww, cfg.patch, device=x.device)
        if n_extra:
            # reference tokens live on a shifted first-axis RoPE plane
            reps = -(-n_extra // img_ids.shape[1])
            ref_ids = img_ids.repeat(1, reps, 1)[:, :n_extra].clone()
            ref_ids[..., 0] = 1
            img_ids = torch.cat([img_ids, ref_ids], dim=1)
        pe = rope_freqs(torch.cat([txt_ids, img_ids], dim=1), cfg.axes_dim, cfg.theta)

        for block in self._modules["double"]:
            img, txt = block(img, txt, vec_emb, pe)
        xcat = torch.cat([txt, img], dim=1)
        for block in self._modules["single"]:
            xcat = block(xcat, vec_emb, pe)
        img = xcat[:, txt.shape[1]:]
        if n_extra:
            img = img[:, :-n_extra]
        return unpack_latent(self.final_layer(img, vec_emb), hh, ww, cfg.patch)
