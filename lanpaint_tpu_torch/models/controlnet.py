"""ControlNet (LDM/SGM cldm family) for the SD UNet backbones.

PyTorch counterpart of `lanpaint_tpu/models/controlnet.py`: the UNet's
encoder half with a pixel-space hint encoder (`input_hint_block`, 8 convs
downsampling the control image to latent resolution) and a
zero-initialized 1x1 projection (`zero_conv_j`) after every skip position
plus `middle_block_out`.  The produced residual dict plugs into
`UNetModel.forward(..., control=...)` (documented at `UNetModel._forward`).

Submodule names follow the flax module names (`input_hint_block.conv_j`,
`zero_conv_j`, `middle_block_out`, and the UNet's `down_*`, `mid_*`), so
models/bridge.py carries a flax ControlNet tree onto this module's
state_dict one to one.  NCHW layout; the encoder reuses the UNet's blocks
(`unet.build_encoder`: self-attention through the hand-written kernels on
CUDA, as in the UNet).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d
from .unet import UNetConfig, build_encoder, embed

HINT_WIDTHS = ((16, 1), (16, 1), (32, 2), (32, 1), (96, 2), (96, 1), (256, 2))


class _HintBlock(nn.Module):
    """Pixel hint (B, 3, H*8, W*8) -> latent-res feature (model_channels)."""

    def __init__(self, model_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        widths = HINT_WIDTHS + ((model_channels, 1),)
        c_in = 3
        for j, (w, stride) in enumerate(widths):
            self.add_module(f"conv_{j}", Conv2d(c_in, w, 3, stride=stride, padding=1,
                                                compute_dtype=dtype))
            c_in = w
        self.n = len(widths)

    def forward(self, hint):
        h = hint.to(self.dtype)
        for j in range(self.n):
            h = getattr(self, f"conv_{j}")(h)
            if j < self.n - 1:
                h = F.silu(h)
        return h


class ControlNet(nn.Module):
    """forward(x_nchw, hint_nchw_pixels, timesteps, context, y) ->
    {"output": [residual per skip position], "middle": residual}."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        self.down_plan, skip_chs = build_encoder(self, cfg)
        self.input_hint_block = _HintBlock(cfg.model_channels, dtype=cfg.dtype)
        for j, c in enumerate(skip_chs):  # a zero conv after every skip position
            self.add_module(f"zero_conv_{j}", Conv2d(c, c, 1, compute_dtype=cfg.dtype))
        self.n_zero = len(skip_chs)
        ch = cfg.model_channels * cfg.channel_mult[-1]
        self.middle_block_out = Conv2d(ch, ch, 1, compute_dtype=cfg.dtype)

    def zero_convs(self):
        """The zero-initialized projections: every `zero_conv_j` and
        `middle_block_out`."""
        return [getattr(self, f"zero_conv_{j}") for j in range(self.n_zero)] + \
            [self.middle_block_out]

    def forward(self, x, hint, timesteps, context, y=None):
        cfg = self.cfg
        x = x.to(cfg.dtype)
        context = context.to(cfg.dtype)
        emb = embed(self, timesteps, y)

        h = self.input_conv(x) + self.input_hint_block(hint)
        outs = [self.zero_conv_0(h)]
        for res, attn, ds in self.down_plan:
            if ds is not None:
                h = getattr(self, ds)(h)
            else:
                h = getattr(self, res)(h, emb)
                if attn is not None:
                    h = getattr(self, attn)(h, context)
            outs.append(getattr(self, f"zero_conv_{len(outs)}")(h))

        h = self.mid_res1(h, emb)
        if self.mid_attn is not None:
            h = self.mid_attn(h, context)
        h = self.mid_res2(h, emb)
        # encoder-order residuals are consumed at the matching skips in the
        # UNet's up path: the "output" slot (see UNetModel.forward)
        return {"output": outs, "middle": self.middle_block_out(h)}


def scale_control(control: dict, strength: float) -> dict:
    """Scale a control dict (the node-graph "strength" knob)."""
    out = {}
    for k, v in control.items():
        if isinstance(v, list):
            out[k] = [None if c is None else c * strength for c in v]
        else:
            out[k] = None if v is None else v * strength
    return out
