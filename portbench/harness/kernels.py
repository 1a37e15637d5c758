"""Device kernels by class, from their names: the port's own kernels, then
the libraries'.  A library's attention (flash or memory-efficient SDPA)
counts as attention too, so the class holds the same work whatever
implements it.  First match wins."""

from __future__ import annotations

CLASSES = (
    ("attention", ("flash_fwd", "wide_fwd", "fmha", "flash_attn", "flash::", "attention",
                   "sdpa", "mem_eff")),
    ("row_norm", ("row_norm",)),
    ("fused_think", ("fused_think",)),
    ("conv", ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd", "nhwc", "nchw")),
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "sm90_", "sm80_", "cublas")),
    ("group_norm", ("group_norm", "groupnorm", "welford")),
    ("softmax", ("softmax",)),
    ("reduce", ("reduce",)),
    ("copy", ("copy", "cat", "index", "gather", "scatter", "fill", "memcpy", "memset")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "pointwise")),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    return next((c for c, keys in CLASSES if any(k in low for k in keys)), "other")
