"""Mask pipeline: pixel mask -> latent-grid mask, and pixel-space blending.

PyTorch counterpart of `lanpaint_tpu/masks.py` (reference
src/LanPaint/nodes.py:20-84 `reshape_mask`/`prepare_mask` and
nodes.py:416-477 `MaskBlend`), with torch's `nearest-exact` interpolation
written as an index gather (half-pixel centres) so latent masks binarize
identically on every device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


def gaussian_kernel(kernel_size: int, device=None) -> torch.Tensor:
    """2D Gaussian kernel, sigma = (k-1)/4, normalized (nodes.py:463-477);
    sigma is floored at 1e-6, so k = 1 gives the identity (the reference
    divides by zero there)."""
    sigma = max((kernel_size - 1) / 4.0, 1e-6)
    coords = torch.arange(kernel_size, dtype=torch.float32, device=device) - kernel_size // 2
    xg, yg = torch.meshgrid(coords, coords, indexing="ij")
    k = torch.exp(-(xg**2 + yg**2) / (2 * sigma**2))
    return k / torch.sum(k)


def _max_pool2d(x: torch.Tensor, k: int) -> torch.Tensor:
    """Same-size, stride-1 max pool of (B, H, W) with padding k//2 (mask
    dilation)."""
    return F.max_pool2d(x[:, None], k, stride=1, padding=k // 2)[:, 0]


def mask_blend(image1: torch.Tensor, image2: torch.Tensor, mask: torch.Tensor,
               blend_overlap: int = 1) -> torch.Tensor:
    """Pixel-space post blend: dilate the mask, Gaussian-feather it, lerp.

    `image1`/`image2` are (B, H, W, C) images (before / after inpaint);
    `mask` is (B, H, W), 1 = repainted.  Mirrors MaskBlend.blend_images
    (nodes.py:436-461).  Where the feathered mask is 0 the result is
    `image1` exactly."""
    if image1.shape[1] != image2.shape[1] or image1.shape[2] != image2.shape[2]:
        raise ValueError(
            "Image size mismatch: both images must share dimensions (and be "
            f"multiples of 8 for VAE decode); got {tuple(image1.shape)} vs "
            f"{tuple(image2.shape)}")
    m = _max_pool2d(mask.float(), blend_overlap)
    k = gaussian_kernel(blend_overlap, device=m.device)[None, None]  # OIHW
    # Not cuDNN: its FFT or Winograd algorithms may leave tiny non-zero
    # values where the feathered mask must be exactly 0 (the pixels beyond
    # the blend then equal image1 exactly); PyTorch's own convolution sums
    # exact zero products there.
    with torch.backends.cudnn.flags(enabled=False):
        m = F.conv2d(m[:, None], k, padding=blend_overlap // 2)[:, 0]
    m = m[..., None]
    return image1 * (1.0 - m) + image2 * m


def checkerboard_noise_mask(shape, scale: int = 2) -> torch.Tensor:
    """Upscale helper: every `scale`-th pixel known (reference
    LanPaint_UpSale_LatentNoiseMask, nodes.py:270-289; the reference keeps
    the node disabled, this keeps it for component parity).  (B, 1, H, W)."""
    b, _, h, w = shape
    m = torch.ones((b, 1, h, w), dtype=torch.float32)
    m[:, :, ::scale, ::scale] = 0.0
    return m
