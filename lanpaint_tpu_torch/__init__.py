"""lanpaint_tpu_torch: LanPaint inpainting in PyTorch for NVIDIA Hopper.

The PyTorch / CUDA port of `lanpaint_tpu`, module for module.  Plain tensor
code is PyTorch; the TPU package's Pallas kernels are hand-written Hopper
kernels (ops/attention.py with csrc/attention.cu and
csrc/wide_attention.cu, ops/norms.py with csrc/row_norm.cu, ops/fused.py with
csrc/fused.cu), built at first use.  `LanPaintPipeline` takes a single-file
checkpoint and a prompt to an inpainted image (models/load.py, native/,
tokenizers.py, models/textenc.py, models/vision.py, text.py), or separate
component files (`from_components`: Flux, Z-Image, Qwen-Image and its edit
path).  The `build_*` functions and
the entry points run on the CUDA card unless the caller names another
device.
"""

from .api import (
    LanPaintSampler,
    edit_image,
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
from .pipeline import LanPaintPipeline
from .text import encode_prompt

__all__ = ["Denoiser", "LanPaintConfig", "LanPaintPipeline", "LanPaintSampler", "ModelKind",
           "edit_image", "encode_prompt", "inpaint_image", "inpaint_video", "ksampler",
           "ksampler_advanced", "mask_blend", "outpaint_image", "sample_custom",
           "sample_custom_advanced"]
