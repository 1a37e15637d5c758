"""Plain float32 FLUX.2 [dev] transformer, as a flow-matching denoiser.

Written from the published description of FLUX.2
(huggingface.co/black-forest-labs/FLUX.2-dev, `transformer/config.json`;
diffusers `Flux2Transformer2DModel` and Black Forest Labs' `flux2` model
code, as recalled offline):

    vec  = time_in(emb(1000 t)) + guidance_in(emb(1000 g))     bias-free MLPs
    mods = the three shared modulations of silu(vec): double img (6 h),
           double txt (6 h), single (3 h), computed once a forward
    double block, per stream s of (img, txt), joint attention over [txt; img]:
        x_s = x_s + g1 * proj_s(attn(RoPE(RMS(q)), RoPE(RMS(k)), v))
        x_s = x_s + g2 * mlp_2_s(silu(a) * b),  [a | b] = mlp_0_s(LN(x_s) (1 + c2) + s2)
    single block on [txt; img]:
        [q | k | v | a | b] = linear1(LN(x) (1 + c) + s)
        x = x + g * linear2([attn(RoPE(RMS(q)), RoPE(RMS(k)), v) | silu(a) * b])
    out  = linear(LN(img) (1 + scale) + shift),  (shift, scale) = adaLN_modulation(silu(vec))

with no bias on any linear, q / k RMS norms of a head's 128 dims, and
four-axis RoPE (t, h, w, l) of 32 dims each at theta 2,000 over the
positions text (0, 0, 0, l), image (0, y, x, 0) and reference-latent
tokens (10, y, x, 0), the reference tokens joining the image stream after
the target's and dropped before the final layer.  Every operation in
float32 (TF32 off while `nn.precision` holds), each weight widened at its
use from the dtype it is held in, attention computed over groups of
heads so that the probabilities of S = 8,624 tokens fit on one card beside
64.4 GB of bf16 weights.  `sizes` is the configuration file's dict.

Departures from the published module, each so that one seeded draw of the
port's parameter names loads both:

* parameter names are the port's state dict's
  (`lanpaint_tpu_torch/models/flux2.py`): `double.<i>` / `single.<i>`,
  `img_attn_qkv`, `img_attn_qknorm.query_norm.weight` (the published
  `img_attn.norm.query_norm.scale`), `img_mlp_0`, `qknorm`,
  `final_layer.adaLN_modulation` (the published `...adaLN_modulation.1`);
* the reference tokens' time coordinate, 10, and the key names are
  recalled, not read from a checkpoint;
* one time and one guidance a sample; the sampler's `Flux2Scheduler`
  resolution rule is the benchmark's traffic, not the model's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import nn as rnn
from .dit import modulate, pack, rope, rope_table, unpack

HEAD_GROUP = 4  # heads whose fp32 attention probabilities are held at once


def attention(q, k, v, group: int = HEAD_GROUP):
    """softmax(q k^T / sqrt(D)) v on (B, S, H, D), `group` heads at a time."""
    return torch.cat([rnn.attention(q[:, :, h:h + group], k[:, :, h:h + group],
                                    v[:, :, h:h + group])
                      for h in range(0, q.shape[2], group)], dim=2)


def swiglu(x):
    a, b = x.chunk(2, dim=-1)
    return F.silu(a) * b


class Embedder(nn.Module):
    """Linear, SiLU, Linear, without biases."""

    def __init__(self, n_in: int, hidden: int):
        super().__init__()
        self.in_layer = rnn.Linear(n_in, hidden, bias=False)
        self.out_layer = rnn.Linear(hidden, hidden, bias=False)

    def forward(self, x):
        return self.out_layer(F.silu(self.in_layer(x)))


class Modulation(nn.Module):
    def __init__(self, hidden: int, n: int):
        super().__init__()
        self.n = n
        self.lin = rnn.Linear(hidden, n * hidden, bias=False)

    def forward(self, vec):
        return self.lin(F.silu(vec))[:, None, :].chunk(self.n, dim=-1)


class QKNorm(nn.Module):
    def __init__(self, head_dim: int):
        super().__init__()
        self.query_norm = rnn.RMSNorm(head_dim)
        self.key_norm = rnn.RMSNorm(head_dim)

    def forward(self, q, k, pe):
        return rope(self.query_norm(q), pe), rope(self.key_norm(k), pe)


def _mlp_hidden(s):
    return int(s["hidden"] * s["mlp_ratio"])


class DoubleBlock(nn.Module):
    def __init__(self, s: dict):
        super().__init__()
        h, mlp = s["hidden"], _mlp_hidden(s)
        self.heads = s["num_heads"]
        for p in ("img", "txt"):
            self.add_module(f"{p}_attn_qkv", rnn.Linear(h, 3 * h, bias=False))
            self.add_module(f"{p}_attn_qknorm", QKNorm(h // self.heads))
            self.add_module(f"{p}_attn_proj", rnn.Linear(h, h, bias=False))
            self.add_module(f"{p}_mlp_0", rnn.Linear(h, 2 * mlp, bias=False))
            self.add_module(f"{p}_mlp_2", rnn.Linear(mlp, h, bias=False))

    def _qkv(self, x, p, pe):
        q, k, v = (t.unflatten(-1, (self.heads, -1))
                   for t in getattr(self, f"{p}_attn_qkv")(x).chunk(3, dim=-1))
        q, k = getattr(self, f"{p}_attn_qknorm")(q, k, pe)
        return q, k, v

    def _mlp(self, x, p, shift, scale):
        hidden = getattr(self, f"{p}_mlp_0")(modulate(rnn.layer_norm(x), shift, scale))
        return getattr(self, f"{p}_mlp_2")(swiglu(hidden))

    def forward(self, img, txt, mod_img, mod_txt, pe):
        i1s, i1c, i1g, i2s, i2c, i2g = mod_img
        t1s, t1c, t1g, t2s, t2c, t2g = mod_txt
        n = txt.shape[1]
        iq, ik, iv = self._qkv(modulate(rnn.layer_norm(img), i1s, i1c), "img", pe[:, n:])
        tq, tk, tv = self._qkv(modulate(rnn.layer_norm(txt), t1s, t1c), "txt", pe[:, :n])
        attn = attention(torch.cat([tq, iq], dim=1), torch.cat([tk, ik], dim=1),
                         torch.cat([tv, iv], dim=1)).flatten(2)
        img = img + i1g * self.img_attn_proj(attn[:, n:])
        txt = txt + t1g * self.txt_attn_proj(attn[:, :n])
        img = img + i2g * self._mlp(img, "img", i2s, i2c)
        txt = txt + t2g * self._mlp(txt, "txt", t2s, t2c)
        return img, txt


class SingleBlock(nn.Module):
    def __init__(self, s: dict):
        super().__init__()
        h, mlp = s["hidden"], _mlp_hidden(s)
        self.heads, self.hidden = s["num_heads"], h
        self.linear1 = rnn.Linear(h, 3 * h + 2 * mlp, bias=False)
        self.qknorm = QKNorm(h // self.heads)
        self.linear2 = rnn.Linear(h + mlp, h, bias=False)

    def forward(self, x, mod, pe):
        shift, scale, gate = mod
        fused = self.linear1(modulate(rnn.layer_norm(x), shift, scale))
        qkv, mlp = fused[..., :3 * self.hidden], fused[..., 3 * self.hidden:]
        q, k, v = (t.unflatten(-1, (self.heads, -1)) for t in qkv.chunk(3, dim=-1))
        q, k = self.qknorm(q, k, pe)
        return x + gate * self.linear2(torch.cat([attention(q, k, v).flatten(2), swiglu(mlp)],
                                                 dim=-1))


class LastLayer(nn.Module):
    def __init__(self, s: dict):
        super().__init__()
        self.adaLN_modulation = rnn.Linear(s["hidden"], 2 * s["hidden"], bias=False)
        self.linear = rnn.Linear(s["hidden"], s["in_channels"], bias=False)

    def forward(self, x, vec):
        shift, scale = self.adaLN_modulation(F.silu(vec))[:, None, :].chunk(2, dim=-1)
        return self.linear(modulate(rnn.layer_norm(x), shift, scale))


def positions(hh: int, ww: int, n_txt: int, n_ref: int, ref_time: int, device) -> torch.Tensor:
    """(n_txt + hh * ww + n_ref, 4) positions (t, h, w, l): text, image,
    then the reference tokens on the image's grid at time `ref_time`."""
    txt = [(0, 0, 0, i) for i in range(n_txt)]
    img = [(0, y, x, 0) for y in range(hh) for x in range(ww)]
    ref = [(ref_time, y, x, 0) for _, y, x, _ in (img * (n_ref // len(img) + 1))[:n_ref]]
    return torch.tensor(txt + img + ref, dtype=torch.long, device=device)


class Flux2(nn.Module):
    """forward(x, t, context, guidance, ref_tokens) -> flow velocity."""

    def __init__(self, sizes: dict):
        super().__init__()
        self.sizes = s = sizes
        h = s["hidden"]
        self.img_in = rnn.Linear(s["in_channels"], h, bias=False)
        self.txt_in = rnn.Linear(s["context_dim"], h, bias=False)
        self.time_in = Embedder(s["time_channels"], h)
        self.guidance_in = Embedder(s["time_channels"], h)
        self.double_stream_modulation_img = Modulation(h, 6)
        self.double_stream_modulation_txt = Modulation(h, 6)
        self.single_stream_modulation = Modulation(h, 3)
        self._modules["double"] = nn.ModuleList(DoubleBlock(s) for _ in range(s["depth_double"]))
        self.single = nn.ModuleList(SingleBlock(s) for _ in range(s["depth_single"]))
        self.final_layer = LastLayer(s)

    def forward(self, x, t, context, guidance, ref_tokens=None):
        s, p = self.sizes, self.sizes["patch"]
        b, _, hh, ww = x.shape
        img = pack(x, p)
        n_img, n_ref = img.shape[1], 0 if ref_tokens is None else ref_tokens.shape[1]
        if n_ref:
            img = torch.cat([img, ref_tokens.float()], dim=1)
        img = self.img_in(img)
        txt = self.txt_in(context)
        n_txt = txt.shape[1]
        t = torch.as_tensor(t, device=x.device).float().reshape(-1)
        g = torch.as_tensor(guidance, device=x.device).float().reshape(-1)
        c = s["time_channels"]
        vec = (self.time_in(rnn.timestep_embedding(t * 1000.0, c))
               + self.guidance_in(rnn.timestep_embedding(g * 1000.0, c)))
        mod_img = self.double_stream_modulation_img(vec)
        mod_txt = self.double_stream_modulation_txt(vec)
        mod_single = self.single_stream_modulation(vec)
        ids = positions(hh // p, ww // p, n_txt, n_ref, s["ref_time"], x.device)
        pe = rope_table(ids[None].expand(b, -1, -1), s["axes_dim"], s["theta"])
        for block in self._modules["double"]:
            img, txt = block(img, txt, mod_img, mod_txt, pe)
        xcat = torch.cat([txt, img], dim=1)
        for block in self.single:
            xcat = block(xcat, mod_single, pe)
        return unpack(self.final_layer(xcat[:, n_txt:n_txt + n_img], vec), hh, ww, p)


class FlowDenoiser:
    """x0(x, t, cond) of FLUX.2: x0 = x - t v.  `cond` is {"context",
    "guidance", "ref_tokens"}."""

    kind = "flow"

    def __init__(self, dit: Flux2):
        self.dit = dit

    def prepare(self, cond: dict) -> dict:
        return cond

    def __call__(self, x, t, cond):
        vel = self.dit(x, t, cond["context"], cond["guidance"], cond.get("ref_tokens"))
        return x - t.float().reshape(-1, 1, 1, 1) * vel
