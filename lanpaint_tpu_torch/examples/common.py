"""Shared helpers of the example scripts.

PyTorch counterpart of `examples/common.py`.  Each example mirrors one of
the reference's example workflows (reference example_workflows/*.json):
the same model family, the same LanPaint hyperparameters as the workflow's
widget values.  Without a checkpoint path an example runs in --smoke mode:
random weights at a small latent, so the whole path runs end to end on any
machine with the card (or with `--device cpu`).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..utils import resolve_device


def example_argparser(name: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=name)
    p.add_argument("--checkpoint", default=None,
                   help="safetensors checkpoint; omit for --smoke random init")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--think-steps", type=int, default=5)
    p.add_argument("--smoke", action="store_true",
                   help="tiny latent + random weights (no checkpoint needed)")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card; \"cpu\" to ask "
                        "for the CPU)")
    return p


def example_device(args) -> torch.device:
    """The device of `--device`: the CUDA card unless another is named
    (without a card and without `--device`, this raises)."""
    return resolve_device(args.device)


def center_square_mask(h: int, w: int, frac: float = 0.5) -> torch.Tensor:
    """Pixel mask repainting a centered square (1 = repaint)."""
    m = np.zeros((h, w), np.float32)
    dh, dw = int(h * frac / 2), int(w * frac / 2)
    m[h // 2 - dh: h // 2 + dh, w // 2 - dw: w // 2 + dw] = 1.0
    return torch.from_numpy(m)


def outpaint_mask(h: int, w: int, border_frac: float = 0.25) -> torch.Tensor:
    """Pixel mask repainting an outer border (outpainting, reference
    Qwen_Image_Outpainting workflow)."""
    m = np.ones((h, w), np.float32)
    bh, bw = int(h * border_frac), int(w * border_frac)
    m[bh: h - bh, bw: w - bw] = 0.0
    return torch.from_numpy(m)


def report(name: str, out, original=None, mask=None, lpips_params=None) -> None:
    """Print the output's stats; with `original` and `mask` also the
    masked-region quality metrics (`quality.quality_report`), and the
    masked LPIPS given `lpips_params` or, for 3-channel images, when
    LANPAINT_LPIPS_VGG names VGG16 weights (LANPAINT_LPIPS_LIN the trained
    linear heads)."""
    o = torch.as_tensor(out).detach().float().cpu().numpy()
    line = (f"{name}: output {o.shape}, finite={np.isfinite(o).all()}, "
            f"mean={o.mean():.4f}, std={o.std():.4f}")
    if original is not None and mask is not None:
        from ..quality import load_lpips_params, quality_report

        out_t = torch.as_tensor(out).float()
        vgg = os.environ.get("LANPAINT_LPIPS_VGG")
        if lpips_params is None and vgg and o.shape[1] == 3:
            lpips_params = load_lpips_params(vgg, os.environ.get("LANPAINT_LPIPS_LIN"),
                                             device=out_t.device)
        q = quality_report(torch.as_tensor(original, device=out_t.device).float(), out_t,
                           torch.as_tensor(mask, device=out_t.device), lpips_params=lpips_params)
        line += " | " + ", ".join(f"{k}={v:.4f}" for k, v in q.items())
    print(line)
