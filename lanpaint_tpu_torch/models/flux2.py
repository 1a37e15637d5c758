"""FLUX.2 [dev]'s transformer as a torch module, at its published
architecture.

Black Forest Labs' FLUX.2 (huggingface.co/black-forest-labs/FLUX.2-dev,
`transformer/config.json`: diffusers `Flux2Transformer2DModel`) keeps
Flux.1's double-stream and single-stream blocks, QK-RMSNorm, multi-axis
RoPE and adaLN, and changes four things, each here:

* shared modulation: three modulation linears on silu(vec) are computed
  once a forward (`double_stream_modulation_img` and `_txt`, 6 x hidden
  each; `single_stream_modulation`, 3 x hidden), and all the blocks read
  them; Flux.1 has one modulation a block;
* SwiGLU MLPs: silu(a) * b of a projection's halves [a | b]
  (`swiglu`): the double blocks' `mlp_0` maps hidden to 2 x mlp_hidden
  and `mlp_2` mlp_hidden back; the single block's `linear1` holds q, k, v
  and both halves (3 x hidden + 2 x mlp_hidden), `linear2` maps
  hidden + mlp_hidden back;
* no bias on any linear (the embedders' too);
* four-axis RoPE (t, h, w, l), 32 dims each at theta 2,000: an image token
  at (0, y, x, 0), a text token at (0, 0, 0, l), a reference-latent token
  at (`ref_time`, y, x, 0).  The time coordinate of the first reference
  image, 10, is the published sampling code's as recalled offline; the
  reference latent is taken to lie on the target's grid.

The final layer is Flux.1's (shift and scale from `adaLN_modulation`, a
no-affine LayerNorm, a projection to the packed latent), bias-free.  The
packed latent is the 32-channel VAE latent in 2 x 2 patches, 128 features
a token, packed as `dit.pack_latent` packs Flux.1's.

The arithmetic is `dit.py`'s: compute in `cfg.dtype` (bf16), the adaLN
pre-norm (`layernorm_na`) in fp32 and the modulation applied in fp32
before the downcast, the residual streams in the compute dtype, the final
projection in fp32; joint attention through `attention_bshd` (the
flash-attention kernel on the card), QKNorm with RoPE in the row norm's
epilogue (`ops.norms.rmsnorm_rope`).  Reference-latent tokens
(`extra_tokens`, the cond's `ref_tokens`) share `img_in`, join the image
stream after the target's tokens and are dropped before the final layer.

Spans (`telemetry`): `dit.double` and `dit.single` around the two stacks
of a forward (events; attrs `tokens`, the joint sequence, and
`ref_tokens`).  Counters: `SharedModulation.calls` (3 a forward) and
`swiglu.calls` (one a stream of a double block and one a single block:
2 x 8 + 48 = 64 a forward of FLUX.2 [dev]), in `telemetry.summary()`.

Submodule names follow `dit.MMDiT`'s (`double.<i>`, `single.<i>`,
`img_attn_qkv`, `qknorm`, ...); `models/load.py` maps the published
checkpoint's names onto them (`import_flux2`).  No tensor- or
layer-parallel build: `zoo.build_flux2` refuses a mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import telemetry
from .dit import _modulate, pack_latent, unpack_latent
from .layers import (Linear, MLPEmbedder, QKNorm, attention_bshd, layernorm_na, rope_freqs,
                     timestep_embedding)


@dataclasses.dataclass(frozen=True)
class Flux2Config:
    in_channels: int = 128         # packed 2x2 patches of the 32ch latent
    hidden: int = 6144             # num_attention_heads x attention_head_dim
    num_heads: int = 48
    mlp_ratio: float = 3.0
    depth_double: int = 8          # num_layers
    depth_single: int = 48         # num_single_layers
    context_dim: int = 15360       # joint_attention_dim: 3 Mistral-Small-3.1 layers
    axes_dim: Tuple[int, ...] = (32, 32, 32, 32)  # (t, h, w, l)
    theta: float = 2000.0
    time_channels: int = 256       # timestep_guidance_channels
    patch: int = 2
    latent_channels: int = 32
    ref_time: int = 10             # the first reference image's time coordinate
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden // self.num_heads

    @property
    def mlp_hidden(self) -> int:
        return int(self.hidden * self.mlp_ratio)


FLUX2_DEV_CONFIG = Flux2Config()
# the embedded guidance when a cond gives none: the Flux.2 workflow's FluxGuidance 4
GUIDANCE = 4.0
TINY_FLUX2_CONFIG = Flux2Config(hidden=128, num_heads=4, depth_double=2, depth_single=2,
                                context_dim=32, axes_dim=(8, 8, 8, 8))


def swiglu(x):
    """silu(a) * b of x's last-axis halves [a | b] (the published
    `SiLUActivation`); each call adds one to `swiglu.calls`."""
    swiglu.calls += 1
    a, b = x.chunk(2, dim=-1)
    return F.silu(a) * b


swiglu.calls = 0


class SharedModulation(nn.Module):
    """silu(vec) -> n x (B, 1, hidden) modulation vectors ((shift, scale,
    gate) per set), computed once a forward for every block that reads
    them; each call adds one to `SharedModulation.calls`."""

    calls = 0

    def __init__(self, hidden: int, n: int, dtype: torch.dtype):
        super().__init__()
        self.n = n
        self.lin = Linear(hidden, n * hidden, bias=False, compute_dtype=dtype)

    def forward(self, vec):
        SharedModulation.calls += 1
        return self.lin(F.silu(vec))[:, None, :].chunk(self.n, dim=-1)


class Flux2DoubleBlock(nn.Module):
    def __init__(self, cfg: Flux2Config):
        super().__init__()
        self.cfg = cfg
        h, mlp, dt = cfg.hidden, cfg.mlp_hidden, cfg.dtype
        for p in ("img", "txt"):
            self.add_module(f"{p}_attn_qkv", Linear(h, 3 * h, bias=False, compute_dtype=dt))
            self.add_module(f"{p}_attn_qknorm", QKNorm(cfg.head_dim))
            self.add_module(f"{p}_attn_proj", Linear(h, h, bias=False, compute_dtype=dt))
            self.add_module(f"{p}_mlp_0", Linear(h, 2 * mlp, bias=False, compute_dtype=dt))
            self.add_module(f"{p}_mlp_2", Linear(mlp, h, bias=False, compute_dtype=dt))

    def _qkv(self, x, prefix, pe):
        heads = (self.cfg.num_heads, self.cfg.head_dim)
        q, k, v = (t.unflatten(-1, heads)
                   for t in getattr(self, f"{prefix}_attn_qkv")(x).chunk(3, dim=-1))
        q, k = getattr(self, f"{prefix}_attn_qknorm")(q, k, pe)
        return q, k, v

    def _mlp(self, x, prefix, shift, scale):
        x = _modulate(layernorm_na(x), shift, scale).to(self.cfg.dtype)
        return getattr(self, f"{prefix}_mlp_2")(swiglu(getattr(self, f"{prefix}_mlp_0")(x)))

    def forward(self, img, txt, mod_img, mod_txt, pe):
        dt = self.cfg.dtype
        im1_shift, im1_scale, im1_gate, im2_shift, im2_scale, im2_gate = mod_img
        tx1_shift, tx1_scale, tx1_gate, tx2_shift, tx2_scale, tx2_gate = mod_txt
        n_txt = txt.shape[1]
        iq, ik, iv = self._qkv(_modulate(layernorm_na(img), im1_shift, im1_scale).to(dt), "img",
                               pe[:, n_txt:])
        tq, tk, tv = self._qkv(_modulate(layernorm_na(txt), tx1_shift, tx1_scale).to(dt), "txt",
                               pe[:, :n_txt])
        attn = attention_bshd(torch.cat([tq, iq], dim=1), torch.cat([tk, ik], dim=1),
                              torch.cat([tv, iv], dim=1)).flatten(2)
        img = img + im1_gate * self.img_attn_proj(attn[:, n_txt:])
        txt = txt + tx1_gate * self.txt_attn_proj(attn[:, :n_txt])
        img = img + im2_gate * self._mlp(img, "img", im2_shift, im2_scale)
        txt = txt + tx2_gate * self._mlp(txt, "txt", tx2_shift, tx2_scale)
        return img, txt


class Flux2SingleBlock(nn.Module):
    """Parallel attention and SwiGLU MLP on one `linear1` output: q, k and
    v are views of it (no split copy)."""

    def __init__(self, cfg: Flux2Config):
        super().__init__()
        self.cfg = cfg
        h, mlp, dt = cfg.hidden, cfg.mlp_hidden, cfg.dtype
        self.linear1 = Linear(h, 3 * h + 2 * mlp, bias=False, compute_dtype=dt)
        self.qknorm = QKNorm(cfg.head_dim)
        self.linear2 = Linear(h + mlp, h, bias=False, compute_dtype=dt)

    def forward(self, x, mod, pe):
        cfg = self.cfg
        shift, scale, gate = mod
        fused = self.linear1(_modulate(layernorm_na(x), shift, scale).to(cfg.dtype))
        qkv, mlp = fused[..., :3 * cfg.hidden], fused[..., 3 * cfg.hidden:]
        q, k, v = (t.unflatten(-1, (cfg.num_heads, cfg.head_dim)) for t in qkv.chunk(3, dim=-1))
        q, k = self.qknorm(q, k, pe)
        attn = attention_bshd(q, k, v).flatten(2)
        return x + gate * self.linear2(torch.cat([attn, swiglu(mlp)], dim=-1))


class Flux2LastLayer(nn.Module):
    def __init__(self, cfg: Flux2Config):
        super().__init__()
        self.adaLN_modulation = Linear(cfg.hidden, 2 * cfg.hidden, bias=False,
                                       compute_dtype=cfg.dtype)
        self.linear = Linear(cfg.hidden, cfg.in_channels, bias=False,
                             compute_dtype=torch.float32)

    def forward(self, x, vec):
        shift, scale = self.adaLN_modulation(F.silu(vec))[:, None, :].chunk(2, dim=-1)
        return self.linear(_modulate(layernorm_na(x), shift, scale).float())


def flux2_ids(b: int, h: int, w: int, n_txt: int, n_ref: int, cfg: Flux2Config,
              device=None) -> torch.Tensor:
    """(B, n_txt + S + n_ref, 4) RoPE positions (t, h, w, l) of the joint
    sequence [text; image; reference]: text (0, 0, 0, l), image (0, y, x,
    0), reference (cfg.ref_time, y, x, 0) over the image's grid, repeated
    where the reference holds more tokens than the image."""
    hh, ww = h // cfg.patch, w // cfg.patch
    ys = torch.arange(hh, device=device).repeat_interleave(ww)
    xs = torch.arange(ww, device=device).repeat(hh)
    zero = torch.zeros_like(ys)
    img = torch.stack([zero, ys, xs, zero], dim=-1)
    ls = torch.arange(n_txt, device=device)
    txt = torch.stack([torch.zeros_like(ls)] * 3 + [ls], dim=-1)
    parts = [txt, img]
    if n_ref:
        ref = img.repeat(-(-n_ref // img.shape[0]), 1)[:n_ref].clone()
        ref[:, 0] = cfg.ref_time
        parts.append(ref)
    return torch.cat(parts)[None].expand(b, -1, -1)


class Flux2(nn.Module):
    """forward(x_nchw_latent, t, context, vec=None, guidance=None,
    extra_tokens=None) -> flow velocity; `vec` is taken for `dit.MMDiT`'s
    signature and must be None (FLUX.2 has no pooled vector)."""

    def __init__(self, cfg: Flux2Config):
        super().__init__()
        self.cfg = cfg
        h, dt = cfg.hidden, cfg.dtype
        self.img_in = Linear(cfg.in_channels, h, bias=False, compute_dtype=dt)
        self.txt_in = Linear(cfg.context_dim, h, bias=False, compute_dtype=dt)
        self.time_in = MLPEmbedder(cfg.time_channels, h, dtype=dt, bias=False)
        self.guidance_in = MLPEmbedder(cfg.time_channels, h, dtype=dt, bias=False)
        self.double_stream_modulation_img = SharedModulation(h, 6, dt)
        self.double_stream_modulation_txt = SharedModulation(h, 6, dt)
        self.single_stream_modulation = SharedModulation(h, 3, dt)
        # `nn.Module.double` (the float64 cast) shadows the attribute, so
        # the stack lives in and is read from `_modules` directly (dit.MMDiT)
        self._modules["double"] = nn.ModuleList(
            Flux2DoubleBlock(cfg) for _ in range(cfg.depth_double))
        self.single = nn.ModuleList(Flux2SingleBlock(cfg) for _ in range(cfg.depth_single))
        self.final_layer = Flux2LastLayer(cfg)

    def forward(self, x, t, context, vec=None, guidance=None, extra_tokens=None):
        cfg, dt = self.cfg, self.cfg.dtype
        if vec is not None:
            raise ValueError("FLUX.2 takes no pooled vector `vec`")
        b, _, hh, ww = x.shape
        img = pack_latent(x, cfg.patch).to(dt)
        n_img = img.shape[1]
        n_ref = 0 if extra_tokens is None else extra_tokens.shape[1]
        if n_ref:
            img = torch.cat([img, extra_tokens.to(dt)], dim=1)
        img = self.img_in(img)
        txt = self.txt_in(context.to(dt))
        n_txt = txt.shape[1]

        t = torch.as_tensor(t, device=x.device).float().reshape(-1)
        g = (torch.full((b,), GUIDANCE, device=x.device) if guidance is None
             else torch.as_tensor(guidance, device=x.device).float().reshape(-1))
        vec = (self.time_in(timestep_embedding(t * 1000.0, cfg.time_channels).to(dt))
               + self.guidance_in(timestep_embedding(g * 1000.0, cfg.time_channels).to(dt)))
        mod_img = self.double_stream_modulation_img(vec)
        mod_txt = self.double_stream_modulation_txt(vec)
        mod_single = self.single_stream_modulation(vec)
        pe = rope_freqs(flux2_ids(b, hh, ww, n_txt, n_ref, cfg, device=x.device), cfg.axes_dim,
                        cfg.theta)

        seq = n_txt + n_img + n_ref
        with telemetry.span("dit.double", device=x.device, tokens=seq, ref_tokens=n_ref):
            for block in self._modules["double"]:
                img, txt = block(img, txt, mod_img, mod_txt, pe)
        xcat = torch.cat([txt, img], dim=1)
        with telemetry.span("dit.single", device=x.device, tokens=seq, ref_tokens=n_ref):
            for block in self.single:
                xcat = block(xcat, mod_single, pe)
        img = xcat[:, n_txt:n_txt + n_img]
        return unpack_latent(self.final_layer(img, vec), hh, ww, cfg.patch)
