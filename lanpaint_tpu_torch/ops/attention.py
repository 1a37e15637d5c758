"""Non-causal self-attention on (B, S, H, D) tensors: a hand-written Hopper
flash-attention forward and its plain PyTorch version.

Replaces the two Pallas TPU kernels of `lanpaint_tpu/models/layers.py`:
`attention_bshd`'s flash branch (`flash_attention`, layers.py:213-242) and
`_splash_attention`/`_splash_kernel` (layers.py:103-173).  Both compute
softmax(Q K^T * scale) V with fp32 accumulation; they differ only in tiling.

The kernel (`csrc/attention.cu`, CUDA C++ for sm_90a) is bound by
compute on this card: at S=4096, H=10, D=64 a call does 43 GFLOP on 21 MB
of q/k/v/out, ~2,000 flops per byte against the H100's ~295 flop/byte
ridge.  Its design: one block of 4 warps per (batch, head, 64-query tile); each
warp keeps its 16 query rows in `mma.sync` bf16 fragments and streams
64-key tiles of K and V^T through shared memory, with fp32 online softmax
and accumulation in registers, so the S x S score matrix never reaches
device memory.  It reads q/k/v through their strides (the fused-QKV split
hands it strided views: no transpose, no copy) and masks the ragged
sequence tail itself, which replaces the TPU path's segment-id padding.
This first design loads each K/V tile synchronously, with no copy/compute
overlap, and reaches ~9% of the bf16 tensor-core peak (464 us a call at
S=4096, H=10 on an NVIDIA H100 80GB HBM3 at 700 W); TMA, wgmma and a
pipelined K/V ring are the levers left.

Head dims above 128 take `wide_attention` (`csrc/wide_attention.cu`):
the VAEs' mid attention, one head of D = 512 in the image VAE
(`lanpaint_tpu/models/vae.py:81`) and of D = 384 / 640 in the Wan2.1 /
Wan2.2 video VAEs (`lanpaint_tpu/models/video_vae.py:159`), where the TPU
path reaches the splash kernel.  The D <= 128 design keeps a warp's whole
output row block in registers, 256 of them a thread at D = 512, so that
kernel splits the output's D across warps in slices of 128 columns instead
and sums the warps' partial scores in shared memory (its source says how).

Each source is built with nvcc into its own library at first use, into
`lanpaint_tpu_torch/_build/` (ignored by git), keyed by a hash of the
source, and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

_PKG_DIR = Path(__file__).resolve().parent.parent
# library name -> (CUDA source, its C entry point)
SOURCES = {"attention": (_PKG_DIR / "csrc" / "attention.cu", "lp_flash_attention_fwd"),
           "wide_attention": (_PKG_DIR / "csrc" / "wide_attention.cu", "lp_wide_attention_fwd")}
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SUPPORTED_HEAD_DIMS = (64, 128)
WIDE_HEAD_DIMS = (384, 512, 640)

_LIBS: dict = {}


def attention_ref(q, k, v, scale: Optional[float] = None):
    """Plain multi-head attention on (B, S, H, D) / (B, Sk, H, D) tensors.

    fp32 logits, softmax and product; returns q's dtype.  Serves as the
    kernel's reference and as the cross-attention path (Sk != S)."""
    scale = (1.0 / math.sqrt(q.shape[-1])) if scale is None else scale
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    probs = torch.softmax((qf @ kf.transpose(-1, -2)) * scale, dim=-1)
    return (probs @ vf).transpose(1, 2).to(q.dtype)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def build_library(name: str = "attention") -> Path:
    """Compile one CUDA source of SOURCES into a shared library unless a
    build for the same source bytes and flags exists; returns its path.
    The compiler's output (ptxas register and spill counts) is kept beside
    it as `<name>.log`."""
    source = SOURCES[name][0]
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    lib_path.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed building {source.name}:\n{log}")
    os.replace(tmp, lib_path)
    return lib_path


def _library(name: str = "attention"):
    """The loaded library `name`, built first if need be; its one entry
    point takes (q, k, v, out, B, S, H, D, 12 strides, scale, stream)."""
    if name not in _LIBS:
        lib = ctypes.CDLL(str(build_library(name)))
        fn = getattr(lib, SOURCES[name][1])
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return _LIBS[name]


def _check_cuda_inputs(op: str, q, k, v, head_dims):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.bfloat16 or t.ndim != 4:
            raise ValueError(
                f"{op}: {name} must be a 4D bfloat16 tensor on {q.device}; "
                f"got {tuple(t.shape)} {t.dtype} on {t.device}")
        if t.shape != q.shape:
            raise ValueError(f"{op} is self-attention only: q, k, v need "
                             f"one shape; got {tuple(q.shape)}, {tuple(t.shape)}")
        if (t.stride(-1) != 1 or t.data_ptr() % 16
                or any(s % 8 for s in t.stride()[:3])):
            raise ValueError(
                f"{op}: {name} needs a unit-stride head dim, 16-byte "
                f"alignment and strides divisible by 8; got strides {t.stride()}")
    if q.shape[-1] not in head_dims:
        raise ValueError(f"{op}: head dim {q.shape[-1]} not in {head_dims}")


def _launch(op, lib_name, head_dims, q, k, v, scale):
    """Check the inputs, allocate the output and launch `lib_name`'s kernel
    on the current stream; raises on a refused launch."""
    _check_cuda_inputs(op, q, k, v, head_dims)
    b, s, h, d = q.shape
    scale = (1.0 / math.sqrt(d)) if scale is None else float(scale)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]]
    err = getattr(_library(lib_name), SOURCES[lib_name][1])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, d,
        *strides, scale, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{op} kernel launch failed: CUDA error {err}")
    return out


def flash_attention(q, k, v, scale: Optional[float] = None):
    """Non-causal self-attention on (B, S, H, D) tensors -> (B, S, H, D).

    A CPU tensor takes `attention_ref`.  A CUDA tensor launches the Hopper
    kernel (bf16, D in SUPPORTED_HEAD_DIMS) or raises.  Each launch adds one
    to `flash_attention.launches`."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    out = _launch("flash_attention", "attention", SUPPORTED_HEAD_DIMS, q, k, v, scale)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def wide_attention(q, k, v, scale: Optional[float] = None):
    """Non-causal self-attention on (B, S, H, D) tensors with a wide head
    (D in WIDE_HEAD_DIMS) -> (B, S, H, D).

    A CPU tensor takes `attention_ref`.  A CUDA tensor launches the
    wide-head Hopper kernel (bf16) or raises.  Each launch adds one to
    `wide_attention.launches`."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"wide_attention: unsupported device {q.device}")
    out = _launch("wide_attention", "wide_attention", WIDE_HEAD_DIMS, q, k, v, scale)
    wide_attention.launches += 1
    return out


wide_attention.launches = 0
