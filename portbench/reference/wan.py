"""Plain float32 Wan2.2 TI2V-5B DiT, as a flow-matching denoiser.

Written from the published description of the Wan2.x video DiT
(github.com/Wan-Video/Wan2.2, `wan/modules/model.py`, with the sizes of
`wan/configs/wan_ti2v_5B.py`): a (1, 2, 2) patch embedding of the latent
video; a text embedding (Linear, tanh GELU, Linear) of the UMT5-XXL
features; a sinusoidal time embedding (Linear, SiLU, Linear) projected to
six modulation vectors; blocks of

    x = x + g1 * self_attn(LN(x) * (1 + c1) + s1)      3D RoPE on q and k
    x = x + cross_attn(LN_affine(x), text)
    x = x + g2 * ffn(LN(x) * (1 + c2) + s2)            tanh GELU

each with its own learned offset added to the modulation, the q / k RMS
norms over the full width before the head split; and a head of its own
two-vector modulation.  Every operation in float32 (TF32 off while
`nn.precision` holds), attention computed over groups of heads so that the
probabilities of S = 7,920 tokens at batch 2 fit on one card.  `sizes` is
the configuration file's dict.

Departures from the published module, each so that one seeded draw of the
port's parameter names loads both:

* parameter names and layouts are the port's state dict's
  (`lanpaint_tpu_torch/models/wan.py`): `text_embedding_0` / `_2`,
  `time_embedding.in_layer` / `out_layer`, `time_projection`, `ffn_0` /
  `ffn_2`, `head_modulation`; the patch embedding as a Linear over the
  (c, pf, ph, pw) patch (the published Conv3d's weight, flattened);
* the head's output features are read in (c, pf, ph, pw) order, as the
  port's state dict holds them.  The published unpatchify reads
  (pf, ph, pw, c) (as recalled offline; the port's checkpoint import does
  not reorder the head);
* one time a sample (the text-to-video path): the published TI2V model
  may give each token its own time for image conditioning, which no job of
  this benchmark uses;
* the cross-attention k and v are computed in every forward (the port
  hoists them once a job), and no sequence is padded (`seq_lens` all
  full).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from . import nn as rnn

HEAD_GROUP = 8  # heads whose fp32 attention probabilities are held at once


def attention(q, k, v, group: int = HEAD_GROUP):
    """softmax(q k^T / sqrt(D)) v on (B, S, H, D), `group` heads at a time."""
    return torch.cat([rnn.attention(q[:, :, h:h + group], k[:, :, h:h + group],
                                    v[:, :, h:h + group])
                      for h in range(0, q.shape[2], group)], dim=2)


def rope_angles(grid, axes_dim, theta: float = 10000.0, device=None):
    """(F*H*W, D/2) complex rotations of the 3D RoPE: each axis its own
    frequencies 1 / theta^(2i / d) over its positions (published
    `rope_params`, float64)."""
    f, h, w = grid
    parts = []
    for n, d in zip(grid, axes_dim):
        freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=device) / d)
        parts.append(torch.outer(torch.arange(n, dtype=torch.float64, device=device), freqs))
    af, ah, aw = parts
    ang = torch.cat([af[:, None, None].expand(f, h, w, -1), ah[None, :, None].expand(f, h, w, -1),
                     aw[None, None, :].expand(f, h, w, -1)], dim=-1)
    return torch.polar(torch.ones_like(ang), ang).reshape(f * h * w, -1)


def apply_rope(x, rot):
    """Rotate the consecutive pairs of x (B, S, H, D) by `rot` (S, D/2)."""
    b, s, h, d = x.shape
    xc = torch.view_as_complex(x.double().reshape(b, s, h, d // 2, 2))
    return torch.view_as_real(xc * rot[None, :, None]).reshape(b, s, h, d).float()


class Attention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q, self.k, self.v, self.o = (rnn.Linear(hidden, hidden) for _ in range(4))
        self.norm_q = rnn.RMSNorm(hidden)
        self.norm_k = rnn.RMSNorm(hidden)

    def split(self, t):
        return t.unflatten(-1, (self.heads, -1))

    def self_attention(self, x, rot):
        q = apply_rope(self.split(self.norm_q(self.q(x))), rot)
        k = apply_rope(self.split(self.norm_k(self.k(x))), rot)
        return self.o(attention(q, k, self.split(self.v(x))).flatten(2))

    def cross_attention(self, x, text):
        q = self.split(self.norm_q(self.q(x)))
        k, v = self.split(self.norm_k(self.k(text))), self.split(self.v(text))
        return self.o(attention(q, k, v).flatten(2))


class Block(nn.Module):
    def __init__(self, s: dict):
        super().__init__()
        h = s["hidden"]
        self.modulation = nn.Parameter(torch.empty(1, 6, h))
        self.self_attn = Attention(h, s["num_heads"])
        self.norm3 = rnn.LayerNorm(h)
        self.cross_attn = Attention(h, s["num_heads"])
        self.ffn_0 = rnn.Linear(h, s["ffn_dim"])
        self.ffn_2 = rnn.Linear(s["ffn_dim"], h)

    def forward(self, x, e6, text, rot):
        sh1, sc1, g1, sh2, sc2, g2 = (self.modulation.float() + e6).unbind(1)
        y = self.self_attn.self_attention(rnn.layer_norm(x) * (1 + sc1[:, None])
                                          + sh1[:, None], rot)
        x = x + y * g1[:, None]
        x = x + self.cross_attn.cross_attention(self.norm3(x), text)
        y = self.ffn_2(rnn.gelu(self.ffn_0(rnn.layer_norm(x) * (1 + sc2[:, None])
                                           + sh2[:, None])))
        return x + y * g2[:, None]


class WanDiT(nn.Module):
    """velocity(x (B, C, F, H, W), t (B,) in [0, 1], context (B, T, 4096))."""

    def __init__(self, s: dict):
        super().__init__()
        self.s = s
        h = s["hidden"]
        pf, ph, pw = s["patch"]
        self.patch_embedding = rnn.Linear(s["in_channels"] * pf * ph * pw, h)
        self.text_embedding_0 = rnn.Linear(s["context_dim"], h)
        self.text_embedding_2 = rnn.Linear(h, h)
        self.time_embedding = rnn.MLPEmbedder(256, h)
        self.time_projection = rnn.Linear(h, 6 * h)
        self.blocks = nn.ModuleList(Block(s) for _ in range(s["depth"]))
        self.head_modulation = nn.Parameter(torch.empty(1, 2, h))
        self.head = rnn.Linear(h, s["out_channels"] * pf * ph * pw)

    def forward(self, x, t, context):
        s = self.s
        b, c, f, hh, ww = x.shape
        pf, ph, pw = s["patch"]
        grid = (f // pf, hh // ph, ww // pw)
        patches = x.float().reshape(b, c, grid[0], pf, grid[1], ph, grid[2], pw)
        patches = patches.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(b, math.prod(grid), -1)
        tokens = self.patch_embedding(patches)
        text = self.text_embedding_2(rnn.gelu(self.text_embedding_0(context)))
        te = self.time_embedding(rnn.timestep_embedding(t.float().reshape(-1) * 1000.0, 256))
        e6 = self.time_projection(F.silu(te)).reshape(b, 6, -1)
        rot = rope_angles(grid, s["axes_dim"], device=x.device)
        for block in self.blocks:
            tokens = block(tokens, e6, text, rot)
        sh, sc = (self.head_modulation.float() + te[:, None]).unbind(1)
        out = self.head(rnn.layer_norm(tokens) * (1 + sc[:, None]) + sh[:, None])
        out = out.reshape(b, *grid, s["out_channels"], pf, ph, pw)
        return out.permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(b, -1, f, hh, ww)


class FlowDenoiser:
    """x0(x, t, cond) of the Wan DiT: x0 = x - t v.  `cond` is {"context"}."""

    kind = "flow"

    def __init__(self, dit: WanDiT):
        self.dit = dit

    def prepare(self, cond: dict) -> dict:
        return cond

    def __call__(self, x, t, cond):
        vel = self.dit(x, t, cond["context"])
        return x.float() - t.float().reshape(-1, 1, 1, 1, 1) * vel
