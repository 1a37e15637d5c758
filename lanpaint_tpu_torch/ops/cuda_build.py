"""Build and load the port's CUDA C++ kernels.

Each source of `SOURCES` (`lanpaint_tpu_torch/csrc/*.cu`) is compiled with
nvcc for sm_90a into its own shared library with a plain C interface, at
first use, into `lanpaint_tpu_torch/_build/` (ignored by git), keyed by a
hash of the source, the headers beside it (`csrc/*.cuh`) and the flags, and
loaded with ctypes.  No library includes PyTorch's headers, so a build takes
seconds.  Nothing here runs at import, so the modules import where there
is no nvcc; a build happens where a kernel is first launched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_PTR = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int
# both attention kernels: (q, k, v, out, B, Sq, Sk, H, D, the tensor maps'
# geometry, out's strides (batch, seq, head), scale, stream)
_ATTENTION_ARGS = ([_PTR] * 4 + [_INT] * 5 + [ctypes.POINTER(_I64)] + [_I64] * 3
                   + [ctypes.c_float, _PTR])
# library name -> (CUDA source, its C entry point, the entry point's argtypes)
SOURCES = {
    "attention": (CSRC / "attention.cu", "lp_flash_attention_fwd", _ATTENTION_ARGS),
    "wide_attention": (CSRC / "wide_attention.cu", "lp_wide_attention_fwd", _ATTENTION_ARGS),
    # (x, gamma, beta, out, rows, inner rows, outer and inner row strides, C,
    #  x / params / out bf16 flags, rms, eps, threads a block, threads a row,
    #  RoPE table or null, its rows a token, tokens a batch, batch and token
    #  strides, head dim, stream)
    "row_norm": (CSRC / "row_norm.cu", "lp_row_norm",
                 [_PTR] * 4 + [_I64] * 4 + [_INT] * 5 + [ctypes.c_float, _INT, _INT, _PTR]
                 + [_I64] * 4 + [_INT, _PTR]),
    # (phase, seed, launch, element offset, coef_x, coef_y, x, v, x_od, c_old, c_new,
    #  mask, out_x, out_v, out_x_od, rows, cols, noise_mult, threads, quads a thread, stream)
    "fused": (CSRC / "fused.cu", "lp_fused_think",
              [_INT, _PTR, _I64, _I64] + [_PTR] * 11 + [_I64] * 2
              + [ctypes.c_float, _INT, _INT, _PTR]),
}

_ENTRIES: dict = {}
_ENTRIES_LOCK = threading.Lock()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def build_library(name: str, defines: tuple = ()) -> Path:
    """Compile one source of SOURCES into a shared library unless a build
    for the same source, headers and flags exists; returns its path.
    `defines` ("NAME=VALUE") are passed as -D flags (a measurement's
    variant of a kernel).  The compiler's output (ptxas register and spill
    counts) is kept beside it as `<name>.log`."""
    source = SOURCES[name][0]
    flags = NVCC_FLAGS + [f"-D{d}" for d in defines]
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    lib_path = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *flags, "-o", tmp, str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    lib_path.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed building {source.name}:\n{log}")
    os.replace(tmp, lib_path)
    return lib_path


def load_entry(name: str, defines: tuple = ()):
    """The C entry point of a build of `name`, built first if need be, with
    its argtypes set (SOURCES)."""
    fn = getattr(ctypes.CDLL(str(build_library(name, defines))), SOURCES[name][1])
    fn.argtypes = SOURCES[name][2]
    fn.restype = ctypes.c_int
    return fn


def entry(name: str):
    """The C entry point of library `name` (the default build, loaded once,
    also when threads first launch a kernel together: a serving worker's
    first batch builds under a lock)."""
    fn = _ENTRIES.get(name)
    if fn is None:
        with _ENTRIES_LOCK:
            fn = _ENTRIES.get(name)
            if fn is None:
                fn = _ENTRIES[name] = load_entry(name)
    return fn


def stream_handle(device) -> int:
    """The raw handle of PyTorch's current stream on CUDA `device`, the
    kernels' launch stream (a cheaper call than
    `torch.cuda.current_stream(device).cuda_stream`, which builds a Stream
    object: the wrappers pay it on every launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)
