"""lanpaint_tpu_torch: LanPaint inpainting in PyTorch for NVIDIA Hopper.

The PyTorch / CUDA port of `lanpaint_tpu`, module for module.  Plain tensor
code is PyTorch; the TPU package's Pallas kernels on the main path are
hand-written Hopper kernels (ops/attention.py with csrc/attention.cu,
ops/norms.py in Triton), built at first use.
"""

from .api import LanPaintSampler, ksampler
from .config import LanPaintConfig, ModelKind
from .models.base import Denoiser

__all__ = ["Denoiser", "LanPaintConfig", "LanPaintSampler", "ModelKind", "ksampler"]
