"""Row normalization (LayerNorm / RMSNorm) over the last axis: a Triton
kernel for Hopper and its plain PyTorch versions.

Replaces the Pallas TPU kernel `_norm_kernel` / `_pallas_norm` of
`lanpaint_tpu/ops/norms.py` (reached through `fused_layernorm` /
`fused_rmsnorm`).  Same numerical contract: fp32 statistics, the one-pass
E[x^2] - E[x]^2 variance of flax's nn.LayerNorm, rsqrt(var + eps), optional
affine, output in the input dtype unless `out_dtype` is given.

What bounds it on this card: bytes.  A row is read once and written once
(4 bytes per bf16 element moved for ~8 flops), far below the H100's
flop/byte ridge.  The design therefore does the least memory traffic: one
program per row loads the whole row (C <= 8192 values, padded to a power
of two) into registers, reduces sum and sum of squares with `tl.sum`, and
stores the normalized row — one read and one write, no fp32 intermediate
in device memory.  Triton serves as well as CUDA here: there is no matrix
work for wgmma and no tile reuse for TMA to add.  On an NVIDIA H100 80GB
HBM3 at 700 W a call takes 3-5 us on the device (1.75-2.14 TB/s at the
SDXL rows (1024, 1280) and (4096, 640)); on the main path its cost is the
host's ~55 us to launch it.

Triton is imported, and the kernel compiled, inside the launching function,
so this module imports where triton is absent.  Triton's compile cache goes
to `lanpaint_tpu_torch/_build/triton/` (ignored by git) unless
TRITON_CACHE_DIR is set.
"""

import os
from pathlib import Path

import torch

MAX_FEATURES = 8192

# bound to `triton.language` when the kernel is first built (the kernel body
# below resolves `tl` as a module global)
tl = None
_KERNEL = None


def layernorm_ref(x, gamma=None, beta=None, eps: float = 1e-5, out_dtype=None):
    """fp32-statistics LayerNorm over the last axis (any device)."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    # same statistics formula as flax nn.LayerNorm (E[x^2] - E[x]^2)
    var = torch.mean(xf * xf, dim=-1, keepdim=True) - mu * mu
    y = (xf - mu) * torch.rsqrt(var + eps)
    if gamma is not None:
        y = y * gamma.float()
    if beta is not None:
        y = y + beta.float()
    return y.to(x.dtype if out_dtype is None else out_dtype)


def rmsnorm_ref(x, gamma=None, eps: float = 1e-6):
    """fp32-statistics RMSNorm over the last axis (any device)."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    if gamma is not None:
        y = y * gamma.float()
    return y.to(x.dtype)


def _row_norm_kernel():
    global tl, _KERNEL
    if _KERNEL is None:
        os.environ.setdefault("TRITON_CACHE_DIR",
                              str(Path(__file__).resolve().parent.parent / "_build" / "triton"))
        import triton
        import triton.language

        tl = triton.language

        @triton.jit
        def row_norm(x_ptr, g_ptr, b_ptr, o_ptr, n_cols, x_row_stride, o_row_stride, eps,
                     RMS: tl.constexpr, HAS_GAMMA: tl.constexpr, HAS_BETA: tl.constexpr,
                     BLOCK: tl.constexpr):
            row = tl.program_id(0).to(tl.int64)
            cols = tl.arange(0, BLOCK)
            m = cols < n_cols
            x = tl.load(x_ptr + row * x_row_stride + cols, mask=m, other=0.0).to(tl.float32)
            mean_sq = tl.sum(x * x, axis=0) / n_cols
            if RMS:
                y = x * tl.rsqrt(mean_sq + eps)
            else:
                mu = tl.sum(x, axis=0) / n_cols
                y = (x - mu) * tl.rsqrt(mean_sq - mu * mu + eps)
            if HAS_GAMMA:
                y = y * tl.load(g_ptr + cols, mask=m, other=0.0).to(tl.float32)
            if HAS_BETA:
                y = y + tl.load(b_ptr + cols, mask=m, other=0.0).to(tl.float32)
            tl.store(o_ptr + row * o_row_stride + cols, y.to(o_ptr.dtype.element_ty), mask=m)

        _KERNEL = row_norm
    return _KERNEL


def _launch(x, gamma, beta, eps, rms, out_dtype):
    c = x.shape[-1]
    if c > MAX_FEATURES:
        raise ValueError(f"row norm kernel: {c} features exceed {MAX_FEATURES}")
    for name, p in (("gamma", gamma), ("beta", beta)):
        if p is not None and (p.device != x.device or p.shape != (c,)):
            raise ValueError(f"row norm kernel: {name} must be ({c},) on {x.device}")
    x2 = x.reshape(-1, c)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    out = torch.empty(x2.shape, dtype=x.dtype if out_dtype is None else out_dtype,
                      device=x.device)
    block = 1 << max(c - 1, 1).bit_length()
    kernel = _row_norm_kernel()
    kernel[(x2.shape[0],)](
        x2, x2 if gamma is None else gamma, x2 if beta is None else beta, out,
        c, x2.stride(0), out.stride(0), float(eps),
        RMS=rms, HAS_GAMMA=gamma is not None, HAS_BETA=beta is not None,
        BLOCK=block, num_warps=min(max(block // 256, 1), 8))
    return out.reshape(x.shape)


def layernorm(x, gamma=None, beta=None, eps: float = 1e-5, out_dtype=None):
    """LayerNorm over the last axis.  A CPU tensor takes `layernorm_ref`; a
    CUDA tensor launches the Triton kernel or raises.  Each launch adds one
    to `layernorm.launches`."""
    if x.device.type == "cpu":
        return layernorm_ref(x, gamma, beta, eps, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"layernorm: unsupported device {x.device}")
    out = _launch(x, gamma, beta, eps, rms=False, out_dtype=out_dtype)
    layernorm.launches += 1
    return out


def rmsnorm(x, gamma=None, eps: float = 1e-6):
    """RMSNorm over the last axis; CPU -> `rmsnorm_ref`, CUDA -> the Triton
    kernel (or raise).  Each launch adds one to `rmsnorm.launches`."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, gamma, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    out = _launch(x, gamma, None, eps, rms=True, out_dtype=None)
    rmsnorm.launches += 1
    return out


layernorm.launches = 0
rmsnorm.launches = 0
