"""Plain float32 Wan2.2 video VAE, encoding and decoding chunk by chunk of
frames as the published VAE does.

Written from the published Wan2.2 VAE (github.com/Wan-Video/Wan2.2,
`wan/modules/vae2_2.py`): a patch-2 pixel unshuffle, a causal 3D
convolutional encoder of RMS-normalized residual blocks with stride-2
spatial and causal stride-2 temporal down-sampling, a parameter-free
average shortcut around each stage (AvgDown3D), one single-head spatial
attention in the middle; the decoder mirrors it with nearest up-sampling,
a causal time convolution whose two channel groups become two frames, and
a channel-duplicating shortcut (DupUp3D).  As published, the encoder takes
the first frame alone and then chunks of as many frames as the temporal
stride (4), the decoder one latent frame at a time, and every causal time
convolution keeps a cache of its last inputs across chunks; a whole clip
is never held at full resolution.  Layout NCDHW, every operation in
float32 (TF32 off while `nn.precision` holds); under the control's
precision every convolution's operands are rounded to float8.

Departures from the published module:

* parameter names are the port's state dict's
  (`lanpaint_tpu_torch/models/video_vae.py`: `down_<i>_block_<j>`,
  `down_<i>_ds`, `mid_block_1`, `mid_attn`, `up_<i>_us`, `head_norm`,
  `head_conv`, `quant_conv`, `post_quant_conv`), so one seeded draw loads
  both, and the stage flags (`temporal_downsample`) are the
  configuration's;
* the first chunk's edge: the published VAE runs no time convolution on
  the first chunk (its first frame passes the temporal down- and
  up-samplers unchanged) and later chunks' caches start from that frame.
  Here every causal time convolution sees zero frames before the clip, the
  edge the port (and the JAX package it follows) gives, so that the
  reference checks the port's computation; which edge the released
  weights were trained with is open (docs/family_facts.md);
* no latent normalization: the configuration carries no per-channel
  mean and std, as the port's WAN22_VAE_CONFIG leaves them out.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from . import nn as rnn


class Conv(nn.Module):
    """A 3D convolution (O, I, kt, kh, kw) on NCDHW, no time padding; its
    operands rounded under the control."""

    def __init__(self, n_in: int, n_out: int, kernel, stride=(1, 1, 1), padding=(0, 0, 0)):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in, *kernel))
        self.bias = nn.Parameter(torch.empty(n_out))
        self.stride, self.padding = stride, padding

    def forward(self, x):
        return F.conv3d(rnn.operand(x), rnn.operand(self.weight), self.bias.float(),
                        self.stride, self.padding)


def stream(conv: Conv, x, cache: dict):
    """`conv` over time as one causal convolution over the whole clip
    (kt - 1 zero frames in front), fed chunk by chunk: the frames it has
    not yet consumed wait in `cache` for the next chunk."""
    kt, st = conv.weight.shape[2], conv.stride[0]
    buf = cache.get(conv)
    if buf is None:
        buf = x.new_zeros(x.shape[0], x.shape[1], kt - 1, *x.shape[3:])
    buf = torch.cat([buf, x], dim=2)
    n = (buf.shape[2] - kt) // st + 1 if buf.shape[2] >= kt else 0
    cache[conv] = buf[:, :, n * st:]
    if n == 0:
        return x.new_zeros(x.shape[0], conv.weight.shape[0], 0, *x.shape[3:])
    return conv(buf[:, :, :(n - 1) * st + kt])


class CausalConv(nn.Module):
    def __init__(self, n_in: int, n_out: int, k: int = 3):
        super().__init__()
        self.conv = Conv(n_in, n_out, (k, k, k), padding=(0, k // 2, k // 2))

    def forward(self, x, cache):
        return stream(self.conv, x, cache)


class RMSNorm(nn.Module):
    """Published `RMS_norm(dim, images=False)`: F.normalize over channels
    times sqrt(dim) times gamma."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        g = self.gamma.float().reshape(1, -1, 1, 1, 1)
        return F.normalize(x.float(), dim=1) * math.sqrt(x.shape[1]) * g


class ResBlock(nn.Module):
    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.norm1, self.conv1 = RMSNorm(n_in), CausalConv(n_in, n_out)
        self.norm2, self.conv2 = RMSNorm(n_out), CausalConv(n_out, n_out)
        self.shortcut = CausalConv(n_in, n_out, 1) if n_in != n_out else None

    def forward(self, x, cache):
        h = self.conv1(F.silu(self.norm1(x)), cache)
        h = self.conv2(F.silu(self.norm2(h)), cache)
        return (x if self.shortcut is None else self.shortcut(x, cache)) + h


class AttnBlock(nn.Module):
    """One head of D = C over each frame's pixels."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = RMSNorm(c)
        self.to_qkv = Conv(c, 3 * c, (1, 1, 1))
        self.proj = Conv(c, c, (1, 1, 1))

    def forward(self, x, cache=None):
        b, c, t, h, w = x.shape
        qkv = self.to_qkv(self.norm(x)).permute(0, 2, 3, 4, 1).reshape(b * t, h * w, 1, 3 * c)
        q, k, v = qkv.chunk(3, dim=-1)
        o = rnn.attention(q, k, v).reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)
        return x + self.proj(o)


class Spatial(nn.Module):
    """Per-frame resample: down, a (0, 1) bottom / right zero pad and a
    stride-2 3x3 convolution; up, nearest 2x and a same-padded one."""

    def __init__(self, n_in: int, n_out: int, down: bool):
        super().__init__()
        self.down = down
        self.conv = Conv(n_in, n_out, (1, 3, 3), stride=(1, 2, 2) if down else (1, 1, 1),
                         padding=(0, 0, 0) if down else (0, 1, 1))

    def forward(self, x):
        if self.down:
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return self.conv(x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4))


class Down(nn.Module):
    def __init__(self, c: int, temporal: bool):
        super().__init__()
        self.resample = Spatial(c, c, down=True)
        self.time_conv = Conv(c, c, (3, 1, 1), stride=(2, 1, 1)) if temporal else None

    def forward(self, x, cache):
        x = self.resample(x)
        return x if self.time_conv is None else stream(self.time_conv, x, cache)


class Up(nn.Module):
    def __init__(self, c: int, temporal: bool):
        super().__init__()
        self.c = c
        self.time_conv = Conv(c, 2 * c, (3, 1, 1)) if temporal else None
        self.resample = Spatial(c, c, down=False)

    def forward(self, x, cache):
        if self.time_conv is not None:
            first = self not in cache
            y = stream(self.time_conv, x, cache)
            b, _, t, h, w = y.shape
            # the two channel groups of each frame become two frames
            x = y.reshape(b, 2, self.c, t, h, w).permute(0, 2, 3, 1, 4, 5)
            x = x.reshape(b, self.c, 2 * t, h, w)
            if first:  # the whole clip's first interleaved frame is dropped
                cache[self] = True
                x = x[:, :, 1:]
        return self.resample(x)


def avg_down(x, n_out: int, ft: int, fs: int):
    """Published AvgDown3D on one chunk: front-pad its frames to a multiple
    of ft, fold (ft, fs, fs) blocks into the channels, group means."""
    x = F.pad(x, (0, 0, 0, 0, (ft - x.shape[2] % ft) % ft, 0))
    b, c, t, h, w = x.shape
    x = x.reshape(b, c, t // ft, ft, h // fs, fs, w // fs, fs).permute(0, 1, 3, 5, 7, 2, 4, 6)
    x = x.reshape(b, n_out, c * ft * fs * fs // n_out, t // ft, h // fs, w // fs)
    return x.mean(dim=2)


def dup_up(x, n_out: int, ft: int, fs: int, first: bool):
    """Published DupUp3D on one chunk: repeat the channels, unfold them to
    (ft, fs, fs) blocks, drop ft - 1 frames at the clip's start."""
    b, c, t, h, w = x.shape
    x = x.repeat_interleave(n_out * ft * fs * fs // c, dim=1)
    x = x.reshape(b, n_out, ft, fs, fs, t, h, w).permute(0, 1, 5, 2, 6, 3, 7, 4)
    x = x.reshape(b, n_out, t * ft, h * fs, w * fs)
    return x[:, :, ft - 1:] if first else x


def patchify(x, p: int):
    """(B, C, F, H, W) -> (B, C*p*p, F, H/p, W/p), channels (c, r, q): q the
    row sub-pixel, r the column one."""
    b, c, f, h, w = x.shape
    x = x.reshape(b, c, f, h // p, p, w // p, p).permute(0, 1, 6, 4, 2, 3, 5)
    return x.reshape(b, c * p * p, f, h // p, w // p)


def unpatchify(x, p: int):
    b, cpp, f, h, w = x.shape
    x = x.reshape(b, cpp // (p * p), p, p, f, h, w).permute(0, 1, 4, 5, 3, 6, 2)
    return x.reshape(b, cpp // (p * p), f, h * p, w * p)


class Encoder(nn.Module):
    def __init__(self, v: dict):
        super().__init__()
        self.v = v
        mult = v["dim_mult"]
        self.dims = dims = [v["dim"] * u for u in [1] + list(mult)]
        self.conv1 = CausalConv(3 * v["patch"] ** 2, dims[0])
        for i in range(len(mult)):
            c = dims[i]
            for j in range(v["num_res_blocks"]):
                self.add_module(f"down_{i}_block_{j}", ResBlock(c, dims[i + 1]))
                c = dims[i + 1]
            if i != len(mult) - 1:
                self.add_module(f"down_{i}_ds", Down(c, v["temporal_downsample"][i]))
        c = dims[-1]
        self.mid_block_1, self.mid_attn, self.mid_block_2 = ResBlock(c, c), AttnBlock(c), \
            ResBlock(c, c)
        self.head_norm = RMSNorm(c)
        self.head_conv = CausalConv(c, 2 * v["z_channels"])

    def forward(self, x, cache):
        v, dims, n = self.v, self.dims, len(self.v["dim_mult"])
        h = self.conv1(x, cache)
        for i in range(n):
            h_in = h
            for j in range(v["num_res_blocks"]):
                h = getattr(self, f"down_{i}_block_{j}")(h, cache)
            if i != n - 1:
                h = getattr(self, f"down_{i}_ds")(h, cache)
            if v["stage_shortcuts"]:
                down = i != n - 1
                ft = 2 if down and v["temporal_downsample"][i] else 1
                h = h + avg_down(h_in, dims[i + 1], ft, 2 if down else 1)
        h = self.mid_block_2(self.mid_attn(self.mid_block_1(h, cache)), cache)
        return self.head_conv(F.silu(self.head_norm(h)), cache)


class Decoder(nn.Module):
    def __init__(self, v: dict):
        super().__init__()
        self.v = v
        rev = list(reversed(v["dim_mult"]))
        self.dims = dims = [v["dim"] * u for u in [rev[0]] + rev]
        self.temporal_up = list(reversed(v["temporal_downsample"]))
        self.conv1 = CausalConv(v["z_channels"], dims[0])
        c = dims[0]
        self.mid_block_1, self.mid_attn, self.mid_block_2 = ResBlock(c, c), AttnBlock(c), \
            ResBlock(c, c)
        for i in range(len(rev)):
            for j in range(v["num_res_blocks"] + 1):
                self.add_module(f"up_{i}_block_{j}", ResBlock(c, dims[i + 1]))
                c = dims[i + 1]
            if i != len(rev) - 1:
                self.add_module(f"up_{i}_us", Up(c, self.temporal_up[i]))
        self.head_norm = RMSNorm(c)
        self.head_conv = CausalConv(c, 3 * v["patch"] ** 2)

    def forward(self, z, cache, first: bool):
        v, dims, n = self.v, self.dims, len(self.v["dim_mult"])
        h = self.conv1(z, cache)
        h = self.mid_block_2(self.mid_attn(self.mid_block_1(h, cache)), cache)
        for i in range(n):
            h_in = h
            for j in range(v["num_res_blocks"] + 1):
                h = getattr(self, f"up_{i}_block_{j}")(h, cache)
            if i != n - 1:
                h = getattr(self, f"up_{i}_us")(h, cache)
                if v["stage_shortcuts"]:
                    h = h + dup_up(h_in, dims[i + 1], 2 if self.temporal_up[i] else 1, 2, first)
        return self.head_conv(F.silu(self.head_norm(h)), cache)


class WanVAE(nn.Module):
    """encode(pixels (B, 3, 1 + s k, H, W) in [-1, 1]) -> the posterior mean
    (B, z, 1 + k, H/16, W/16); decode(latent) -> pixels; s the temporal
    stride.  `v` is the configuration file's "vae" dict."""

    def __init__(self, v: dict):
        super().__init__()
        self.v = v
        z = v["z_channels"]
        self.encoder = Encoder(v)
        self.quant_conv = CausalConv(2 * z, 2 * z, 1)
        self.post_quant_conv = CausalConv(z, z, 1)
        self.decoder = Decoder(v)

    def encode(self, video):
        v, cache = self.v, {}
        x = patchify(video.float(), v["patch"])
        s = 2 ** sum(bool(f) for f in v["temporal_downsample"])
        chunks = [x[:, :, :1]] + [x[:, :, i:i + s] for i in range(1, x.shape[2], s)]
        out = torch.cat([self.encoder(c, cache) for c in chunks], dim=2)
        return self.quant_conv(out, cache).chunk(2, dim=1)[0]

    def decode(self, latent):
        v, cache = self.v, {}
        z = self.post_quant_conv(latent.float(), cache)
        out = [unpatchify(self.decoder(z[:, :, i:i + 1], cache, i == 0), v["patch"])
               for i in range(z.shape[2])]
        return torch.cat(out, dim=2)
