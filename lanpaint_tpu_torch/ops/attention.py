"""Non-causal self-attention on (B, S, H, D) tensors: hand-written Hopper
flash-attention forwards and their plain PyTorch version.

Replaces the two Pallas TPU kernels of `lanpaint_tpu/models/layers.py`:
`attention_bshd`'s flash branch (`flash_attention`, layers.py:213-242) and
`_splash_attention`/`_splash_kernel` (layers.py:103-173).  Both compute
softmax(Q K^T * scale) V with fp32 accumulation; they differ only in tiling.

The D <= 128 kernel (`csrc/attention.cu`, CUDA C++ for sm_90a) is bound by
the tensor cores: a call does ~S flops per byte of q/k/v/out (43 GFLOP on
21 MB at S=4096, H=10, D=64) against the H100's ~295 flop/byte ridge.  Its
first design fed `mma.sync` from 32-bit shared-memory loads and staged K/V
through registers with no copy/compute overlap, and stayed at 8-9% of the
bf16 peak.  The kernel now does what Hopper needs for its rate: TMA copies
Q once and K/V tiles of 128 keys into a ring of shared-memory stages (one
producer warpgroup, mbarriers), and two consumer warpgroups of 64 queries
run both products as `wgmma` (S = Q K^T from shared memory, O += P V with P
in registers and V read as it lies), with the online softmax in registers.
On an NVIDIA H100 80GB HBM3 at 700 W it reaches 56-59% of the bf16 peak at
D = 128 and 19-34% at D = 64 (`chip_smoke.py` phase 3; `PERF.md` section
6 has the times beside PyTorch's flash SDPA).  The tensor maps' geometry
is computed here (`tma_geometry`): dims (D, H, S, B), the operands' own
byte strides (the fused-QKV split views and Flux's column slice of
`linear1` need no copy) and the boxes; a layout TMA cannot take is refused
before the launch.  Ragged S needs no padding: TMA fills rows past S with
zeros and the kernel masks keys past S, which replaces the TPU path's
segment-id padding.

Head dims above 128 take `wide_attention` (`csrc/wide_attention.cu`):
the VAEs' mid attention, one head of D = 512 in the image VAE
(`lanpaint_tpu/models/vae.py:81`) and of D = 384 / 640 in the Wan2.1 /
Wan2.2 video VAEs (`lanpaint_tpu/models/video_vae.py:159`), where the TPU
path reaches the splash kernel.  A D <= 128 consumer keeps its whole
output row block in registers, 256 of them a thread at D = 512, so that
kernel splits the output's D across warps in slices of 128 columns instead
and sums the warps' partial scores in shared memory (its source says how).

Each source is built with nvcc into its own library at first use, into
`lanpaint_tpu_torch/_build/` (ignored by git), keyed by a hash of the
source, and loaded with ctypes.  The D <= 128 library reaches the driver's
`cuTensorMapEncodeTiled` through `cudaGetDriverEntryPoint` at run time and
links no libcuda.
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
_PTR = ctypes.c_void_p
_I64 = ctypes.c_longlong
# (q, k, v, out, B, S, H, D) + the layout arguments + (scale, stream)
_HEAD = [_PTR] * 4 + [ctypes.c_int] * 4
_TAIL = [ctypes.c_float, _PTR]
# library name -> (CUDA source, its C entry point, the entry point's argtypes):
# the D <= 128 kernel takes the tensor maps' geometry and out's strides,
# the wide-head kernel the element strides of q, k, v and out
SOURCES = {
    "attention": (_PKG_DIR / "csrc" / "attention.cu", "lp_flash_attention_fwd",
                  _HEAD + [ctypes.POINTER(_I64)] + [_I64] * 3 + _TAIL),
    "wide_attention": (_PKG_DIR / "csrc" / "wide_attention.cu", "lp_wide_attention_fwd",
                       _HEAD + [_I64] * 12 + _TAIL),
}
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SUPPORTED_HEAD_DIMS = (64, 128)
WIDE_HEAD_DIMS = (384, 512, 640)
# The D <= 128 kernel's tiles (csrc/attention.cu checks that the geometry
# it is given has them): queries a block, keys a K/V tile, and the bf16
# columns of one TMA box row (128 bytes, the 128-byte swizzle's row).
BLOCK_M = 128
BLOCK_N = 128
BOX_COLS = 64

_LIBS: dict = {}


def tma_geometry(shape, strides, data_ptr: int, rows: int) -> tuple:
    """The 4D TMA tensor map of one (B, S, H, D) bf16 operand of the D <= 128
    kernel, from its shape, element strides and data pointer alone:
    (dims, byte strides, box), with dims (D, H, S, B) innermost first, the
    byte strides of H, S and B, and a box of (BOX_COLS, 1, rows, 1)
    elements (a D = 128 row is two boxes).  A dim of extent 1 is never
    stepped, so its stride is taken as packed.

    Raises ValueError for a layout TMA cannot take: a head dim outside
    SUPPORTED_HEAD_DIMS or not of unit stride, a base address that is not
    16-byte aligned, or a stride that is not a positive multiple of 16 bytes
    (8 bf16 elements) below 2^40."""
    b, s, h, d = shape
    if d not in SUPPORTED_HEAD_DIMS or strides[3] != 1:
        raise ValueError(f"TMA layout: head dim {d} with stride {strides[3]}; the kernel takes "
                         f"{SUPPORTED_HEAD_DIMS} with unit stride")
    if data_ptr % 16:
        raise ValueError(f"TMA layout: base address {data_ptr:#x} is not 16-byte aligned")
    byte_strides = []
    inner = 2 * d  # bytes spanned by the next-inner dim
    for extent, stride in ((h, strides[2]), (s, strides[1]), (b, strides[0])):
        step = 2 * stride if extent > 1 else inner
        if step <= 0 or step % 16 or step >= 2**40:
            raise ValueError(f"TMA layout: strides {tuple(strides)} (elements) need multiples "
                             "of 8 elements below 2^39")
        byte_strides.append(step)
        inner = step * extent
    return (d, h, s, b), tuple(byte_strides), (BOX_COLS, 1, rows, 1)


def _tma_geometries(q, k, v):
    """q's, k's and v's geometry as the kernel's int64 array (3 x 11)."""
    vals = [x for t, rows in ((q, BLOCK_M), (k, BLOCK_N), (v, BLOCK_N))
            for part in tma_geometry(t.shape, t.stride(), t.data_ptr(), rows) for x in part]
    return (_I64 * len(vals))(*vals)


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


def build_library(name: str = "attention", defines: tuple = ()) -> Path:
    """Compile one CUDA source of SOURCES into a shared library unless a
    build for the same source bytes and flags exists; returns its path.
    `defines` ("NAME=VALUE") are passed as -D flags (a measurement's
    variant of a kernel).  The compiler's output (ptxas register and spill
    counts) is kept beside it as `<name>.log`."""
    source = SOURCES[name][0]
    flags = NVCC_FLAGS + [f"-D{d}" for d in defines]
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode())
    lib_path = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *flags, "-o", tmp, str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    lib_path.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed building {source.name}:\n{log}")
    os.replace(tmp, lib_path)
    return lib_path


def _library(name: str = "attention"):
    """The loaded library `name`, built first if need be, with its one entry
    point's argtypes set (SOURCES)."""
    if name not in _LIBS:
        lib = ctypes.CDLL(str(build_library(name)))
        fn = getattr(lib, SOURCES[name][1])
        fn.argtypes = SOURCES[name][2]
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


def _entry(name: str):
    """The C entry point of library `name`."""
    return getattr(_library(name), SOURCES[name][1])


def _launch(op, entry, q, k, v, scale, layout_args):
    """Allocate the output and launch a kernel through its C `entry` point
    on the current stream; `layout_args(out)` gives the entry point's
    arguments that describe the operands' layout.  Raises on a refused
    launch."""
    b, s, h, d = q.shape
    scale = (1.0 / math.sqrt(d)) if scale is None else float(scale)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    err = entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, d,
        *layout_args(out), scale, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{op} kernel launch failed: CUDA error {err}")
    return out


def _flash_launch(entry, q, k, v, scale):
    """Check q/k/v, compute their tensor maps' geometry and launch the
    D <= 128 kernel through `entry` (a build of csrc/attention.cu)."""
    _check_cuda_inputs("flash_attention", q, k, v, SUPPORTED_HEAD_DIMS)
    geom = _tma_geometries(q, k, v)
    return _launch("flash_attention", entry, q, k, v, scale,
                   lambda out: (geom, *out.stride()[:3]))


def flash_attention(q, k, v, scale: Optional[float] = None):
    """Non-causal self-attention on (B, S, H, D) tensors -> (B, S, H, D).

    A CPU tensor takes `attention_ref`.  A CUDA tensor launches the Hopper
    kernel (bf16, D in SUPPORTED_HEAD_DIMS, a layout `tma_geometry` takes)
    or raises.  Each launch adds one to `flash_attention.launches`."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    out = _flash_launch(_entry("attention"), q, k, v, scale)
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
    _check_cuda_inputs("wide_attention", q, k, v, WIDE_HEAD_DIMS)
    out = _launch("wide_attention", _entry("wide_attention"), q, k, v, scale,
                  lambda out: [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                               *out.stride()[:3]])
    wide_attention.launches += 1
    return out


wide_attention.launches = 0
