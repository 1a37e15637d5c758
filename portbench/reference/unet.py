"""Plain float32 SD / SDXL UNet, as an eps-prediction denoiser.

A frozen copy of `lanpaint_tpu_torch/models/unet.py` and the UNet half of
its `models/layers.py` (fused-QKV layout, the same parameter names, so the
benchmark's weights load into both), with the flash-attention and row-norm
kernels replaced by plain attention and LayerNorm, and every operation in
float32.  `sizes` is the configuration file's dict (`configs/<name>.json`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import nn as rnn


class CrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int, self_attention: bool):
        super().__init__()
        self.heads = heads
        self.is_self = self_attention
        if self_attention:
            self.to_qkv = rnn.Linear(dim, 3 * dim, bias=False)
        else:
            self.to_q = rnn.Linear(dim, dim, bias=False)
        self.to_out = rnn.Linear(dim, dim)

    def forward(self, x, kv=None):
        b, s, c = x.shape
        split = (self.heads, c // self.heads)
        if self.is_self:
            q, k, v = (t.unflatten(-1, split) for t in self.to_qkv(x).chunk(3, dim=-1))
        else:
            q = self.to_q(x).unflatten(-1, split)
            k, v = (t.unflatten(-1, split) for t in kv.chunk(2, dim=-1))
        return self.to_out(rnn.attention(q, k, v).reshape(b, s, c))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = rnn.Linear(dim, 2 * inner)

    def forward(self, x):
        a, g = self.proj(x).chunk(2, dim=-1)
        return a * rnn.gelu(g)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net_0 = GEGLU(dim, 4 * dim)
        self.net_2 = rnn.Linear(4 * dim, dim)

    def forward(self, x):
        return self.net_2(self.net_0(x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm1 = rnn.LayerNorm(dim)
        self.attn1 = CrossAttention(dim, heads, True)
        self.norm2 = rnn.LayerNorm(dim)
        self.attn2 = CrossAttention(dim, heads, False)
        self.norm3 = rnn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, kv):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), kv=kv)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    def __init__(self, ch: int, context_dim: int, heads: int, depth: int):
        super().__init__()
        self.norm = rnn.GroupNorm32(ch)
        self.proj_in = rnn.Linear(ch, ch)
        self.blocks = nn.ModuleList(BasicTransformerBlock(ch, heads) for _ in range(depth))
        self.kv_cross = nn.Parameter(torch.empty(depth, context_dim, 2 * ch))
        self.proj_out = rnn.Linear(ch, ch)

    def cross_kv(self, context):
        """(B, depth, T, 2c): every block's cross-attention k | v."""
        return torch.einsum("btc,dcf->bdtf", rnn.operand(context), rnn.operand(self.kv_cross))

    def forward(self, x, context, kv=None):
        b, c, h, w = x.shape
        t = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c))
        kv = self.cross_kv(context) if kv is None else kv
        for i, block in enumerate(self.blocks):
            t = block(t, kv[:, i])
        return self.proj_out(t).reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class ResBlock(nn.Module):
    def __init__(self, n_in: int, n_out: int, emb_dim: int):
        super().__init__()
        self.in_norm = rnn.GroupNorm32(n_in)
        self.in_conv = rnn.Conv2d(n_in, n_out, 3, padding=1)
        self.emb_proj = rnn.Linear(emb_dim, n_out)
        self.out_norm = rnn.GroupNorm32(n_out)
        self.out_conv = rnn.Conv2d(n_out, n_out, 3, padding=1)
        self.skip_conv = rnn.Conv2d(n_in, n_out, 1) if n_in != n_out else None

    def forward(self, x, emb):
        h = self.in_conv(F.silu(self.in_norm(x)))
        h = h + self.emb_proj(F.silu(emb))[:, :, None, None]
        h = self.out_conv(F.silu(self.out_norm(h)))
        return (x if self.skip_conv is None else self.skip_conv(x)) + h


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = rnn.Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = rnn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def heads_of(sizes: dict, ch: int) -> int:
    return ch // sizes["head_dim"] if sizes["head_dim"] is not None else sizes["num_heads"]


class UNet(nn.Module):
    """forward(x, timesteps, context, y, kv) -> eps; `kv` maps a spatial
    transformer's name to its `cross_kv` (computed here when absent)."""

    def __init__(self, sizes: dict):
        super().__init__()
        self.sizes = s = sizes
        mc = s["model_channels"]
        emb_dim = 4 * mc
        self.time_embed = rnn.MLPEmbedder(mc, emb_dim)
        if s["adm_in_channels"] is not None:
            self.label_emb = rnn.MLPEmbedder(s["adm_in_channels"], emb_dim)
        self.input_conv = rnn.Conv2d(s["in_channels"], mc, 3, padding=1)

        def transformer(ch, depth):
            return SpatialTransformer(ch, s["context_dim"], heads_of(s, ch), depth)

        self.down_plan, skips, ch_in = [], [mc], mc
        for level, mult in enumerate(s["channel_mult"]):
            ch = mc * mult
            for i in range(s["num_res_blocks"]):
                self.add_module(f"down_{level}_{i}_res", ResBlock(ch_in, ch, emb_dim))
                attn = None
                if s["transformer_depth"][level] > 0:
                    attn = f"down_{level}_{i}_attn"
                    self.add_module(attn, transformer(ch, s["transformer_depth"][level]))
                self.down_plan.append((f"down_{level}_{i}_res", attn, None))
                ch_in = ch
                skips.append(ch)
            if level != len(s["channel_mult"]) - 1:
                self.add_module(f"down_{level}_ds", Downsample(ch))
                self.down_plan.append((None, None, f"down_{level}_ds"))
                skips.append(ch)
        ch = mc * s["channel_mult"][-1]
        self.mid_res1 = ResBlock(ch_in, ch, emb_dim)
        self.mid_attn = (transformer(ch, s["transformer_depth_middle"])
                         if s["transformer_depth_middle"] > 0 else None)
        self.mid_res2 = ResBlock(ch, ch, emb_dim)

        self.up_plan = []
        for level, mult in reversed(list(enumerate(s["channel_mult"]))):
            ch = mc * mult
            for i in range(s["num_res_blocks"] + 1):
                name = f"up_{level}_{i}_res"
                self.add_module(name, ResBlock(ch_in + skips.pop(), ch, emb_dim))
                attn = None
                if s["transformer_depth"][level] > 0:
                    attn = f"up_{level}_{i}_attn"
                    self.add_module(attn, transformer(ch, s["transformer_depth"][level]))
                self.up_plan.append((name, attn))
                ch_in = ch
            if level != 0:
                self.add_module(f"up_{level}_us", Upsample(ch))
                self.up_plan.append((None, f"up_{level}_us"))
        self.out_norm = rnn.GroupNorm32(mc)
        self.out_conv = rnn.Conv2d(mc, s["out_channels"], 3, padding=1)

    def transformers(self):
        return [(n, m) for n, m in self.named_children() if isinstance(m, SpatialTransformer)]

    def forward(self, x, timesteps, context, y=None, kv=None):
        kv = kv or {}
        emb = self.time_embed(rnn.timestep_embedding(timesteps, self.sizes["model_channels"]))
        if self.sizes["adm_in_channels"] is not None:
            emb = emb + self.label_emb(y)
        h = self.input_conv(x)
        skips = [h]
        for res, attn, ds in self.down_plan:
            if ds is not None:
                h = getattr(self, ds)(h)
            else:
                h = getattr(self, res)(h, emb)
                if attn is not None:
                    h = getattr(self, attn)(h, context, kv.get(attn))
            skips.append(h)
        h = self.mid_res1(h, emb)
        if self.mid_attn is not None:
            h = self.mid_attn(h, context, kv.get("mid_attn"))
        h = self.mid_res2(h, emb)
        for res, attn in self.up_plan:
            if res is None:
                h = getattr(self, attn)(h)
                continue
            h = getattr(self, res)(torch.cat([h, skips.pop()], dim=1), emb)
            if attn is not None:
                h = getattr(self, attn)(h, context, kv.get(attn))
        return self.out_conv(F.silu(self.out_norm(h)))


def eps_sigmas() -> np.ndarray:
    """The 1,000 VE sigmas of SD's scaled-linear beta schedule."""
    betas = np.linspace(0.00085**0.5, 0.012**0.5, 1000, dtype=np.float64) ** 2
    abar = np.cumprod(1.0 - betas)
    return np.sqrt((1.0 - abar) / abar)


class EpsDenoiser:
    """x0(x, sigma, cond) of the UNet: eps predicted from x / sqrt(1 + s^2)
    at the table's fractional timestep (log-sigma interpolation), x0 = x -
    s eps.  `cond` is {"context", "y"}; `prepare(cond)` adds every
    transformer's cross-attention k | v once per job."""

    kind = "eps"

    def __init__(self, unet: UNet):
        self.unet = unet
        self.table = eps_sigmas()

    def timestep(self, sigma: torch.Tensor) -> torch.Tensor:
        log_t = torch.log(torch.tensor(self.table, dtype=torch.float64, device=sigma.device))
        x = torch.log(torch.clamp_min(sigma.double(), 1e-10))
        i = torch.clamp(torch.searchsorted(log_t, x, right=True), 1, log_t.shape[0] - 1)
        w = (x - log_t[i - 1]) / (log_t[i] - log_t[i - 1])
        t = (i - 1).double() + w
        t = torch.where(x < log_t[0], 0.0, t)
        return torch.where(x > log_t[-1], float(log_t.shape[0] - 1), t).float()

    def prepare(self, cond: dict) -> dict:
        return dict(cond, kv={n: m.cross_kv(cond["context"]) for n, m in self.unet.transformers()})

    def __call__(self, x, sigma, cond):
        s = sigma.float().reshape(-1, 1, 1, 1)
        eps = self.unet(x / torch.sqrt(1.0 + s**2), self.timestep(sigma.float().reshape(-1)),
                        cond["context"], cond.get("y"), cond.get("kv"))
        return x - s * eps
