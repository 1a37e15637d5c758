"""Masked-region quality metrics: PSNR, SSIM, LPIPS.

PyTorch counterpart of `lanpaint_tpu/quality.py`.  The quality north star
(BASELINE.json) is masked-region LPIPS; the reference benches quality
externally (LanPaintBench, reference README.md:22) and ships no metric
code.

Conventions: images are (B, C, H, W) float in [-1, 1] (the VAE decode
range); masks are (H, W) or broadcastable, 1 = inpainted region.
Mask-weighted sums keep every metric free of boolean indexing.

LPIPS follows Zhang et al. 2018 (arXiv 1801.03924): VGG16 features at
relu1_2/relu2_2/relu3_3/relu4_3/relu5_3, unit-normalized over channels,
squared difference, a learned non-negative per-channel weight per stage,
spatial mean, summed over stages.  `LPIPS` holds the weights as a module;
`load_lpips_params` reads the torchvision VGG16 and the official LPIPS
calibration `.pth` files, `init_lpips_params` draws the same structure at
random for tests.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .utils import resolve_device

# LPIPS input scaling (Zhang et al.'s implementation): images in [-1, 1]
# are shifted and scaled per channel before VGG.
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)

# VGG16 feature config: conv channel widths, "M" = 2x2 max pool.  LPIPS
# taps the activation after the ReLU before each pool (and the last).
_VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512)
_TAP_AFTER_CONV = (1, 3, 6, 9, 12)   # conv indices of relu1_2..relu5_3
_STAGE_CHANNELS = (64, 128, 256, 512, 512)
# torchvision's Sequential indices of the 13 convolutions in vgg16.features
_TORCHVISION_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def _prep_mask(mask, shape, device):
    """Broadcast a pixel mask to (B, 1, H, W) float32."""
    m = torch.as_tensor(mask, dtype=torch.float32, device=device)
    while m.ndim < 4:
        m = m[None]
    return torch.broadcast_to(m[:, :1], (shape[0], 1, shape[2], shape[3]))


def masked_mse(a, b, mask=None):
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    se = (a - b) ** 2
    if mask is None:
        return torch.mean(se)
    m = _prep_mask(mask, a.shape, a.device)
    return torch.sum(se * m) / torch.clamp_min(torch.sum(m) * a.shape[1], 1e-8)


def masked_psnr(a, b, mask=None, data_range: float = 2.0):
    """PSNR over the masked region (dB); data_range 2 for [-1, 1] images."""
    mse = masked_mse(a, b, mask)
    return 10.0 * torch.log10(data_range**2 / torch.clamp_min(mse, 1e-12))


def _gaussian_window(size: int = 11, sigma: float = 1.5, device=None):
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x**2) / (2 * sigma**2))
    g = g / torch.sum(g)
    return torch.outer(g, g)


def _depthwise_filter(img, window):
    """(B, C, H, W) x (k, k) -> per-channel 'valid' convolution."""
    c = img.shape[1]
    w = window[None, None].expand(c, 1, *window.shape)
    return F.conv2d(img, w, groups=c), window.shape[0]


def masked_ssim(a, b, mask=None, data_range: float = 2.0, window_size: int = 11,
                sigma: float = 1.5):
    """SSIM (Wang et al. 2004) with a Gaussian window, averaged over the
    masked region (the mask centre-cropped to the valid-convolution grid)."""
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    win = _gaussian_window(window_size, sigma, device=a.device)
    mu_a, k = _depthwise_filter(a, win)
    mu_b, _ = _depthwise_filter(b, win)
    saa, _ = _depthwise_filter(a * a, win)
    sbb, _ = _depthwise_filter(b * b, win)
    sab, _ = _depthwise_filter(a * b, win)
    va = saa - mu_a**2
    vb = sbb - mu_b**2
    cab = sab - mu_a * mu_b
    ssim_map = ((2 * mu_a * mu_b + c1) * (2 * cab + c2)) / (
        (mu_a**2 + mu_b**2 + c1) * (va + vb + c2))
    if mask is None:
        return torch.mean(ssim_map)
    m = _prep_mask(mask, a.shape, a.device)
    off = (k - 1) // 2
    m = m[:, :, off:off + ssim_map.shape[2], off:off + ssim_map.shape[3]]
    return torch.sum(ssim_map * m) / torch.clamp_min(torch.sum(m) * ssim_map.shape[1], 1e-8)


# ---------------------------------------------------------------------------
# LPIPS


class LPIPS(nn.Module):
    """The LPIPS VGG16 feature stack (`vgg.conv{i}`, OIHW) and its per-stage
    channel weights (`lin.lin{i}`)."""

    def __init__(self):
        super().__init__()
        convs, cin = {}, 3
        for item in _VGG16_CFG:
            if item != "M":
                convs[f"conv{len(convs)}"] = nn.Conv2d(cin, item, 3, padding=1)
                cin = item
        self.vgg = nn.ModuleDict(convs)
        self.lin = nn.ParameterDict({f"lin{i}": nn.Parameter(torch.full((ch,), 1.0 / ch))
                                     for i, ch in enumerate(_STAGE_CHANNELS)})

    def features(self, x) -> list:
        """The 5 LPIPS tap activations (post-ReLU) of x in VGG input space."""
        taps, conv_i = [], 0
        for item in _VGG16_CFG:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = F.relu(self.vgg[f"conv{conv_i}"](x))
            if conv_i in _TAP_AFTER_CONV:
                taps.append(x)
            conv_i += 1
        return taps


def _unit_normalize(f, eps=1e-10):
    return f / (torch.sqrt(torch.sum(f**2, dim=1, keepdim=True)) + eps)


def _on_device(x, device):
    """`x` as fp32 on `device`, the LPIPS weights' device.  A tensor on
    another device raises: it is not moved, so the network never runs
    anywhere but where its weights were built."""
    if isinstance(x, torch.Tensor) and x.device != device:
        raise ValueError(f"LPIPS weights are on {device} but an image is on {x.device}: "
                         "build or load them with device= the images' device")
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def lpips_maps(params: LPIPS, a, b) -> Sequence[torch.Tensor]:
    """Per-stage (B, 1, H_s, W_s) LPIPS distance maps for images in [-1, 1],
    on the LPIPS weights' device (a tensor on another device raises)."""
    device = next(params.parameters()).device
    shift = torch.tensor(_LPIPS_SHIFT, device=device)[None, :, None, None]
    scale = torch.tensor(_LPIPS_SCALE, device=device)[None, :, None, None]
    xa = (_on_device(a, device) - shift) / scale
    xb = (_on_device(b, device) - shift) / scale
    maps = []
    for i, (u, v) in enumerate(zip(params.features(xa), params.features(xb))):
        d = (_unit_normalize(u) - _unit_normalize(v)) ** 2
        w = F.relu(params.lin[f"lin{i}"])  # non-negative calibration
        maps.append(torch.sum(d * w[None, :, None, None], dim=1, keepdim=True))
    return maps


def _linear_resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) weights of `jax.image.resize(..., "linear")` along one
    axis: a triangle kernel, widened by the scale when downsampling
    (antialiasing), each column normalized."""
    inv_scale = n_in / n_out
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None])
    w = torch.clamp_min(1.0 - x / max(inv_scale, 1.0), 0.0)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def lpips(params: LPIPS, a, b, mask=None):
    """LPIPS distance per image; with `mask`, each stage's map is averaged
    over the mask resized (linear, antialiased) to that stage's grid:
    masked-region LPIPS, the BASELINE.json north-star metric."""
    maps = lpips_maps(params, a, b)
    total = 0.0
    for d in maps:
        if mask is None:
            total = total + torch.mean(d, dim=(1, 2, 3))
            continue
        m = _prep_mask(mask, (d.shape[0], 1) + tuple(torch.as_tensor(a).shape[2:]), d.device)
        wh = _linear_resize_weights(m.shape[2], d.shape[2], d.device)
        ww = _linear_resize_weights(m.shape[3], d.shape[3], d.device)
        m = torch.einsum("bchw,hy,wx->bcyx", m, wh, ww)
        total = total + (torch.sum(d * m, dim=(1, 2, 3))
                         / torch.clamp_min(torch.sum(m, dim=(1, 2, 3)), 1e-8))
    return total


@torch.no_grad()
def init_lpips_params(generator: Optional[torch.Generator] = None, device=None) -> LPIPS:
    """The LPIPS structure with random weights (offline tests; a real
    evaluation needs `load_lpips_params`): kernels N(0, 1) * 2/sqrt(9 C_in),
    biases zero, stage weights uniform in [0, 2/C).  On the CUDA card
    unless `device` names another (`utils.resolve_device`); `generator`
    must live on that device."""
    mod = LPIPS().to(resolve_device(device))
    for conv in mod.vgg.values():
        cin = conv.in_channels
        conv.weight.normal_(0.0, 1.0, generator=generator).mul_(2.0 / np.sqrt(9 * cin))
        conv.bias.zero_()
    for i, ch in enumerate(_STAGE_CHANNELS):
        mod.lin[f"lin{i}"].uniform_(0.0, 2.0 / ch, generator=generator)
    return mod.eval().requires_grad_(False)


def load_lpips_params(vgg_pth: str, lpips_pth: Optional[str] = None, device=None) -> LPIPS:
    """LPIPS weights from torch checkpoints, on the CUDA card unless
    `device` names another (`utils.resolve_device`).

    `vgg_pth`: the torchvision VGG16 state dict (vgg16-397923af.pth), keys
    `features.{idx}.weight/bias` with idx the Sequential position.
    `lpips_pth`: the official LPIPS v0.1 VGG calibration (`vgg.pth`), keys
    `lin{i}.model.1.weight` of shape (1, C, 1, 1).  Without it the stage
    weights are uniform 1/C (an uncalibrated perceptual distance)."""
    device = resolve_device(device)
    sd = torch.load(vgg_pth, map_location="cpu", weights_only=True)
    state = {}
    for i, idx in enumerate(_TORCHVISION_CONV_IDX):
        state[f"vgg.conv{i}.weight"] = sd[f"features.{idx}.weight"]
        state[f"vgg.conv{i}.bias"] = sd[f"features.{idx}.bias"]
    ld = (torch.load(lpips_pth, map_location="cpu", weights_only=True)
          if lpips_pth is not None else None)
    for i, ch in enumerate(_STAGE_CHANNELS):
        state[f"lin.lin{i}"] = (ld[f"lin{i}.model.1.weight"].reshape(ch) if ld is not None
                                else torch.full((ch,), 1.0 / ch))
    mod = LPIPS()
    mod.load_state_dict(state)
    return mod.to(device).eval().requires_grad_(False)


def quality_report(original, inpainted, mask, lpips_params: Optional[LPIPS] = None) -> dict:
    """Masked-region quality summary of an inpainting result:
    {"masked_psnr", "masked_ssim"}, plus "masked_lpips" given LPIPS
    weights.  `original`/`inpainted` are (B, 3, H, W) in [-1, 1]."""
    out = {"masked_psnr": float(masked_psnr(original, inpainted, mask)),
           "masked_ssim": float(masked_ssim(original, inpainted, mask))}
    if lpips_params is not None:
        out["masked_lpips"] = float(torch.mean(lpips(lpips_params, original, inpainted, mask)))
    return out
