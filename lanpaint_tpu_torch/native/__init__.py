"""Native host code of the checkpoint reader (C++, bound with ctypes).

PyTorch counterpart of `lanpaint_tpu/native/__init__.py`.  `convert.cpp`
(a byte-for-byte copy of the JAX package's) widens bf16 / fp16 / fp8
tensors to fp32 across threads, with an fp8 `scale_weight` folded in.  It
is built with g++ at first use into `lanpaint_tpu_torch/_build/` (ignored
by git), under a file name keyed by a hash of the source, the flags and the
host CPU's model and feature flags (the build is `-march=native`), so an
edited source, or a build directory copied to another machine, never loads
a stale or foreign build, and the package's directory holds no build
output.  Nothing here runs at import.  `get_lib()` returns
None where the library cannot be built; `models/load.load_safetensors`
then converts with torch's own dtypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "convert.cpp"
BUILD_DIR = SOURCE.parent.parent / "_build"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-pthread"]

_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _cpu_identity() -> bytes:
    """The host CPU's model name and feature flags (empty where the system
    does not list them)."""
    found = {}
    try:
        with open("/proc/cpuinfo", encoding="utf-8", errors="replace") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags") and key not in found:
                    found[key] = line
    except OSError:
        pass
    return "".join(found.values()).encode()


def library_path() -> Path:
    """Where the build of the current source and flags for this CPU lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()
                            + _cpu_identity())
    return BUILD_DIR / f"lpnative-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile convert.cpp unless a build of the same source and flags
    exists; returns the library's path.  The compiler writes a temporary
    file that is renamed into place, so concurrent processes never load a
    half-written library.  Raises when g++ fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed building {SOURCE.name}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def get_lib():
    """Load (building if need be) the native library, or None where it
    cannot be built or loaded."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.TimeoutExpired):
            return None
        lib.lp_convert_f32.restype = ctypes.c_int
        lib.lp_convert_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_float, ctypes.c_int]
        lib.lp_copy.restype = None
        lib.lp_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
        _LIB = lib
        return _LIB


DTYPE_CODES = {"F16": 0, "BF16": 1, "F8_E4M3": 2, "F8_E5M2": 3}
