"""Mask pipeline: pixel mask -> latent-grid mask.

PyTorch counterpart of `lanpaint_tpu/masks.py` (reference
src/LanPaint/nodes.py:20-84 `reshape_mask`/`prepare_mask`), with torch's
`nearest-exact` interpolation written as an index gather (half-pixel
centres) so latent masks binarize identically on every device.
"""

from __future__ import annotations

import torch


def _nearest_exact_indices(out_size: int, in_size: int, device) -> torch.Tensor:
    """torch 'nearest-exact' source index: floor((i + 0.5) * in/out)."""
    i = torch.arange(out_size, dtype=torch.float32, device=device)
    src = torch.floor((i + 0.5) * (in_size / out_size)).to(torch.int64)
    return torch.clamp(src, 0, in_size - 1)


def resize_nearest_exact(x: torch.Tensor, size) -> torch.Tensor:
    """Resize the trailing len(size) spatial dims with nearest-exact."""
    nsp = len(size)
    for axis_off, target in enumerate(size):
        axis = x.ndim - nsp + axis_off
        idx = _nearest_exact_indices(target, x.shape[axis], x.device)
        x = torch.index_select(x, axis, idx)
    return x


def repeat_to_batch_size(x: torch.Tensor, batch: int) -> torch.Tensor:
    """Tile / trim the leading dim to `batch` (comfy.utils.repeat_to_batch_size)."""
    if x.shape[0] == batch:
        return x
    if x.shape[0] > batch:
        return x[:batch]
    reps = -(-batch // x.shape[0])
    return x.repeat((reps,) + (1,) * (x.ndim - 1))[:batch]


def reshape_mask(input_mask, output_shape, video: bool = False) -> torch.Tensor:
    """Normalize a 2D (H, W), 3D (B, H, W) or 4D (B, C, H, W) mask (4D/5D
    for video) to the latent grid `output_shape`, (B, C, H, W) or
    (B, C, F, H, W): nearest-exact resize, then channel and batch repeat."""
    m = torch.as_tensor(input_mask)
    if m.ndim == 2:
        m = m[None, None]
    elif m.ndim == 3:
        m = m[:, None]

    if len(output_shape) == 5:
        if video:
            if m.ndim == 4:
                # (F, C, H, W) frame stack -> (1, C, F, H, W)
                m = m.permute(1, 0, 2, 3)[None]
            m = resize_nearest_exact(m, tuple(output_shape[2:]))
        else:
            if m.ndim == 4:
                m = m[:, :, None]  # (B, C, 1, H, W)
            m = resize_nearest_exact(m, tuple(output_shape[2:]))
        if m.shape[1] < output_shape[1]:
            m = m.repeat(1, output_shape[1], 1, 1, 1)[:, : output_shape[1]]
    else:
        m = resize_nearest_exact(m, tuple(output_shape[2:]))
        if m.shape[1] < output_shape[1]:
            m = m.repeat((1, output_shape[1]) + (1,) * (m.ndim - 2))[:, : output_shape[1]]
    return repeat_to_batch_size(m, output_shape[0])


def prepare_mask(noise_mask, shape, video: bool = False) -> torch.Tensor:
    return reshape_mask(noise_mask, shape, video).to(torch.float32)
