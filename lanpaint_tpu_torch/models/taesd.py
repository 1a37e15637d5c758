"""TAESD decoder: a tiny autoencoder's decoder for fast latent previews.

PyTorch counterpart of `lanpaint_tpu/models/taesd.py`.  The reference's
per-step previews go through its host's TAESD decoding (reference
nodes.py:544, 613; every 2 steps, nodes.py:188-196).  This is the public
TAESD decoder graph (madebyollin/taesd): clamp -> conv -> 3 x (3 blocks +
nearest x2 + conv) -> block -> conv, ~1.2M parameters, cheap enough to run
at every preview step.  Pair it with `utils.make_preview_callback` and
`LanPaintSampler(callback=...)`.

Variants share the graph: taesd (SD1.x), taesdxl, taesd3/taef1 (16-channel
latents); pick `latent_channels` to match.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d


class _TBlock(nn.Module):
    """conv-relu-conv-relu-conv plus an identity skip, then ReLU."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_0, self.conv_2, self.conv_4 = (
            Conv2d(64, 64, 3, padding=1, compute_dtype=dtype) for _ in range(3))

    def forward(self, x):
        h = self.conv_4(F.relu(self.conv_2(F.relu(self.conv_0(x)))))
        return F.relu(h + x)


class TAESDDecoder(nn.Module):
    """(B, C_latent, h, w) scaled latent -> (B, 3, 8h, 8w) pixels in [0, 1]."""

    def __init__(self, latent_channels: int = 4, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv_in = Conv2d(latent_channels, 64, 3, padding=1, compute_dtype=dtype)
        for idx in range(10):
            self.add_module(f"block_{idx}", _TBlock(dtype))
        for stage in range(3):
            self.add_module(f"up_conv_{stage}", Conv2d(64, 64, 3, padding=1, compute_dtype=dtype,
                                                       bias=False))
        self.conv_out = Conv2d(64, 3, 3, padding=1)

    def forward(self, latent):
        x = torch.tanh(latent.to(self.dtype) / 3.0) * 3.0  # clamp
        x = F.relu(self.conv_in(x))
        for stage in range(3):
            for idx in range(3 * stage, 3 * stage + 3):
                x = getattr(self, f"block_{idx}")(x)
            x = getattr(self, f"up_conv_{stage}")(F.interpolate(x, scale_factor=2,
                                                                mode="nearest"))
        return self.conv_out(self.block_9(x).float())


def taesd_entries():
    """(public taesd_decoder.safetensors key, this module's name, kind) for
    every parameterized layer of the public sequential layout; kind "conv"
    has a weight and a bias, "conv_nb" a weight only."""
    e = [("decoder.1", "conv_in", "conv")]
    seq = 3
    idx = 0
    for stage in range(3):
        for _ in range(3):
            for ci in (0, 2, 4):
                e.append((f"decoder.{seq}.conv.{ci}", f"block_{idx}.conv_{ci}", "conv"))
            seq += 1
            idx += 1
        seq += 1  # the upsample (no parameters)
        e.append((f"decoder.{seq}", f"up_conv_{stage}", "conv_nb"))
        seq += 1
    for ci in (0, 2, 4):
        e.append((f"decoder.{seq}.conv.{ci}", f"block_{idx}.conv_{ci}", "conv"))
    seq += 1
    e.append((f"decoder.{seq}", "conv_out", "conv"))
    return e


def _suffixes(kind):
    return ("weight",) if kind == "conv_nb" else ("weight", "bias")


def import_taesd_decoder(state) -> dict:
    """A public TAESD decoder state dict (OIHW convolutions, as this module
    keeps them) -> `TAESDDecoder.state_dict()` keys, as tensors.  Files that
    store the decoder without the "decoder." prefix are accepted."""
    if not any(k.startswith("decoder.") for k in state):
        state = {f"decoder.{k}": v for k, v in state.items()}
    out = {}
    for ckpt, name, kind in taesd_entries():
        for suffix in _suffixes(kind):
            if f"{ckpt}.{suffix}" in state:
                out[f"{name}.{suffix}"] = torch.as_tensor(state[f"{ckpt}.{suffix}"])
    return out


def export_taesd_decoder(state_dict) -> dict:
    """`TAESDDecoder.state_dict()` -> the public layout's keys."""
    out = {}
    for ckpt, name, kind in taesd_entries():
        for suffix in _suffixes(kind):
            if f"{name}.{suffix}" in state_dict:
                out[f"{ckpt}.{suffix}"] = state_dict[f"{name}.{suffix}"]
    return out
