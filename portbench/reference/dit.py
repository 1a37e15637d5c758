"""Plain float32 Flux-style MMDiT, as a flow-matching denoiser.

A frozen copy of `lanpaint_tpu_torch/models/dit.py` and the DiT half of
its `models/layers.py` (the same parameter names, `double.<i>` and
`single.<i>` blocks), with the flash-attention and row-norm kernels
replaced by plain attention, LayerNorm and RMSNorm, and every operation in
float32.  `sizes` is the configuration file's dict.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import nn as rnn


class Modulation(nn.Module):
    def __init__(self, hidden: int, n: int):
        super().__init__()
        self.n = n
        self.lin = rnn.Linear(hidden, n * hidden)

    def forward(self, vec):
        return self.lin(F.silu(vec))[:, None, :].chunk(self.n, dim=-1)


class QKNorm(nn.Module):
    def __init__(self, head_dim: int):
        super().__init__()
        self.query_norm = rnn.RMSNorm(head_dim)
        self.key_norm = rnn.RMSNorm(head_dim)

    def forward(self, q, k):
        return self.query_norm(q), self.key_norm(k)


def modulate(x, shift, scale):
    return (1 + scale) * x + shift


def rope_table(ids, axes_dim, theta):
    """(B, S, D/2, 2, 2) rotation matrices of the multi-axis RoPE."""
    parts = []
    for i, d in enumerate(axes_dim):
        omega = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=ids.device) / d)
        ang = ids[..., i].double()[..., None] * omega
        cos, sin = torch.cos(ang), torch.sin(ang)
        parts.append(torch.stack([cos, -sin, sin, cos], dim=-1).reshape(*ang.shape, 2, 2))
    return torch.cat(parts, dim=-3).float()


def rope(x, table):
    b, s, h, d = x.shape
    xf = x.float().reshape(b, s, h, d // 2, 1, 2)
    fr = table[:, :, None]
    return (fr[..., 0] * xf[..., 0] + fr[..., 1] * xf[..., 1]).reshape(b, s, h, d)


class DoubleStreamBlock(nn.Module):
    def __init__(self, s: dict):
        super().__init__()
        h, mlp = s["hidden"], int(s["hidden"] * s["mlp_ratio"])
        self.heads = s["num_heads"]
        for p in ("img", "txt"):
            self.add_module(f"{p}_mod", Modulation(h, 6))
            self.add_module(f"{p}_attn_qkv", rnn.Linear(h, 3 * h))
            self.add_module(f"{p}_attn_qknorm", QKNorm(h // s["num_heads"]))
            self.add_module(f"{p}_attn_proj", rnn.Linear(h, h))
            self.add_module(f"{p}_mlp_0", rnn.Linear(h, mlp))
            self.add_module(f"{p}_mlp_2", rnn.Linear(mlp, h))

    def _qkv(self, x, p):
        q, k, v = (t.unflatten(-1, (self.heads, -1))
                   for t in getattr(self, f"{p}_attn_qkv")(x).chunk(3, dim=-1))
        q, k = getattr(self, f"{p}_attn_qknorm")(q, k)
        return q, k, v

    def forward(self, img, txt, vec, pe):
        i1s, i1c, i1g, i2s, i2c, i2g = self.img_mod(vec)
        t1s, t1c, t1g, t2s, t2c, t2g = self.txt_mod(vec)
        iq, ik, iv = self._qkv(modulate(rnn.layer_norm(img), i1s, i1c), "img")
        tq, tk, tv = self._qkv(modulate(rnn.layer_norm(txt), t1s, t1c), "txt")
        q = rope(torch.cat([tq, iq], dim=1), pe)
        k = rope(torch.cat([tk, ik], dim=1), pe)
        attn = rnn.attention(q, k, torch.cat([tv, iv], dim=1)).flatten(2)
        n = txt.shape[1]
        img = img + i1g * self.img_attn_proj(attn[:, n:])
        txt = txt + t1g * self.txt_attn_proj(attn[:, :n])
        img = img + i2g * self.img_mlp_2(rnn.gelu(self.img_mlp_0(
            modulate(rnn.layer_norm(img), i2s, i2c))))
        txt = txt + t2g * self.txt_mlp_2(rnn.gelu(self.txt_mlp_0(
            modulate(rnn.layer_norm(txt), t2s, t2c))))
        return img, txt


class SingleStreamBlock(nn.Module):
    def __init__(self, s: dict):
        super().__init__()
        h, mlp = s["hidden"], int(s["hidden"] * s["mlp_ratio"])
        self.heads, self.hidden = s["num_heads"], h
        self.modulation = Modulation(h, 3)
        self.linear1 = rnn.Linear(h, 3 * h + mlp)
        self.qknorm = QKNorm(h // s["num_heads"])
        self.linear2 = rnn.Linear(h + mlp, h)

    def forward(self, x, vec, pe):
        shift, scale, gate = self.modulation(vec)
        fused = self.linear1(modulate(rnn.layer_norm(x), shift, scale))
        qkv, mlp = fused[..., :3 * self.hidden], fused[..., 3 * self.hidden:]
        q, k, v = (t.unflatten(-1, (self.heads, -1)) for t in qkv.chunk(3, dim=-1))
        q, k = self.qknorm(q, k)
        attn = rnn.attention(rope(q, pe), rope(k, pe), v).flatten(2)
        return x + gate * self.linear2(torch.cat([attn, rnn.gelu(mlp)], dim=-1))


class LastLayer(nn.Module):
    def __init__(self, s: dict):
        super().__init__()
        self.adaLN_modulation = rnn.Linear(s["hidden"], 2 * s["hidden"])
        self.linear = rnn.Linear(s["hidden"], s["out_channels"])

    def forward(self, x, vec):
        shift, scale = self.adaLN_modulation(F.silu(vec))[:, None, :].chunk(2, dim=-1)
        return self.linear(modulate(rnn.layer_norm(x), shift, scale))


def pack(x, p):
    b, c, hh, ww = x.shape
    x = x.reshape(b, c, hh // p, p, ww // p, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, (hh // p) * (ww // p), c * p * p)


def unpack(tokens, hh, ww, p):
    b, _, cpp = tokens.shape
    x = tokens.reshape(b, hh // p, ww // p, cpp // (p * p), p, p).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, cpp // (p * p), hh, ww)


class MMDiT(nn.Module):
    """forward(x, t, context, vec, guidance) -> flow velocity."""

    def __init__(self, sizes: dict):
        super().__init__()
        self.sizes = s = sizes
        h = s["hidden"]
        self.img_in = rnn.Linear(s["in_channels"], h)
        self.txt_in = rnn.Linear(s["context_dim"], h)
        self.time_in = rnn.MLPEmbedder(256, h)
        if s["guidance_embed"]:
            self.guidance_in = rnn.MLPEmbedder(256, h)
        if s["vec_dim"] > 0:
            self.vector_in = rnn.MLPEmbedder(s["vec_dim"], h)
        self._modules["double"] = nn.ModuleList(DoubleStreamBlock(s)
                                                for _ in range(s["depth_double"]))
        self.single = nn.ModuleList(SingleStreamBlock(s) for _ in range(s["depth_single"]))
        self.final_layer = LastLayer(s)

    def forward(self, x, t, context, vec=None, guidance=None):
        s, p = self.sizes, self.sizes["patch"]
        b, _, hh, ww = x.shape
        img = self.img_in(pack(x, p))
        txt = self.txt_in(context)
        t = torch.as_tensor(t, device=x.device).float().reshape(-1)
        v = self.time_in(rnn.timestep_embedding(t * 1000.0, 256))
        if s["guidance_embed"]:
            g = torch.as_tensor(guidance, device=x.device).float().reshape(-1)
            v = v + self.guidance_in(rnn.timestep_embedding(g * 1000.0, 256))
        if s["vec_dim"] > 0:
            v = v + self.vector_in(vec)
        ys = torch.arange(hh // p, device=x.device).repeat_interleave(ww // p)
        xs = torch.arange(ww // p, device=x.device).repeat(hh // p)
        img_ids = torch.stack([torch.zeros_like(ys), ys, xs], dim=-1)
        ids = torch.cat([torch.zeros((txt.shape[1], 3), dtype=torch.long, device=x.device),
                         img_ids])[None].expand(b, -1, -1)
        pe = rope_table(ids, s["axes_dim"], s["theta"])
        for block in self._modules["double"]:
            img, txt = block(img, txt, v, pe)
        xcat = torch.cat([txt, img], dim=1)
        for block in self.single:
            xcat = block(xcat, v, pe)
        return unpack(self.final_layer(xcat[:, txt.shape[1]:], v), hh, ww, p)


class FlowDenoiser:
    """x0(x, t, cond) of the MMDiT: x0 = x - t v.  `cond` is {"context",
    "vec", "guidance"}."""

    kind = "flow"

    def __init__(self, dit: MMDiT):
        self.dit = dit

    def prepare(self, cond: dict) -> dict:
        return cond

    def __call__(self, x, t, cond):
        vel = self.dit(x, t, cond["context"], cond.get("vec"), cond.get("guidance"))
        return x - t.float().reshape(-1, 1, 1, 1) * vel
