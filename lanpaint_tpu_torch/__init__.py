"""lanpaint_tpu_torch: LanPaint inpainting in PyTorch for NVIDIA Hopper.

The PyTorch / CUDA port of `lanpaint_tpu`, module for module.  Plain tensor
code is PyTorch; the TPU package's Pallas kernels are hand-written Hopper
kernels (ops/attention.py with csrc/attention.cu and
csrc/wide_attention.cu, ops/norms.py and ops/fused.py in Triton), built at
first use.  Builders and entry points run on the CUDA card unless the caller
names another device.
"""

from .api import (
    LanPaintSampler,
    inpaint_image,
    inpaint_video,
    ksampler,
    ksampler_advanced,
    outpaint_image,
    sample_custom,
    sample_custom_advanced,
)
from .config import LanPaintConfig, ModelKind
from .masks import mask_blend
from .models.base import Denoiser

__all__ = ["Denoiser", "LanPaintConfig", "LanPaintSampler", "ModelKind", "inpaint_image",
           "inpaint_video", "ksampler", "ksampler_advanced", "mask_blend", "outpaint_image",
           "sample_custom", "sample_custom_advanced"]
