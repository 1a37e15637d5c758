"""Fast safetensors reader: one streaming read + native dtype conversion.

PyTorch counterpart of `lanpaint_tpu/native/loader.py`, with the same
contract as `lanpaint_tpu.models.load.load_safetensors`: fp8_scaled tensors
are dequantized (weight = fp8.astype(f32) * scale_weight, the scale keys
consumed), bf16 and fp8 widen to fp32, fp32 and fp16 (and the integer
types) pass through as views of the read buffer.  Python owns the header,
the tensor table and the scale pairing; convert.cpp (`native.get_lib`)
widens.  Where it cannot be built, or with `native=False`, torch's own
dtypes widen instead (`torch.bfloat16`, `torch.float8_e4m3fn`,
`torch.float8_e5m2`), the JAX package's `ml_dtypes` fallback in torch.
`CONVERSIONS` counts the tensors each route widened.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from . import DTYPE_CODES, get_lib

_NP_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}
_WIDEN = ("BF16", "F8_E4M3", "F8_E5M2")
_ITEMSIZE = {"BF16": 2, "F8_E4M3": 1, "F8_E5M2": 1}
_TORCH_DTYPES = {"BF16": torch.bfloat16, "F8_E4M3": torch.float8_e4m3fn,
                 "F8_E5M2": torch.float8_e5m2}

# tensors widened by each route since the count was last reset
CONVERSIONS = {"native": 0, "torch": 0}


def _torch_convert(raw: np.ndarray, st_dtype: str) -> np.ndarray:
    return torch.from_numpy(raw).view(_TORCH_DTYPES[st_dtype]).float().numpy()


def _convert(raw: np.ndarray, st_dtype: str, scale: float, nthreads: int,
             native: bool) -> np.ndarray:
    """raw: a uint8 buffer -> a flat fp32 array."""
    lib = get_lib() if native else None
    if lib is None:
        CONVERSIONS["torch"] += 1
        out = _torch_convert(raw, st_dtype)
        return out * np.float32(scale) if scale != 1.0 else out
    n = raw.nbytes // _ITEMSIZE[st_dtype]
    dst = np.empty(n, np.float32)
    rc = lib.lp_convert_f32(raw.ctypes.data, dst.ctypes.data, n, DTYPE_CODES[st_dtype],
                            float(scale), nthreads)
    if rc != 0:  # pragma: no cover
        raise ValueError(f"native convert failed for {st_dtype}")
    CONVERSIONS["native"] += 1
    return dst


def load_safetensors_fast(path: str, nthreads: int = 0,
                          native: bool = True) -> Dict[str, np.ndarray]:
    """Read a safetensors file into numpy arrays (the contract above).
    `native=False` widens with torch's dtypes even where the native
    library builds."""
    if nthreads <= 0:
        nthreads = min(os.cpu_count() or 1, 16)
    # one sequential readinto: on overlay or network filesystems, cold mmap
    # page faults are far slower than a streaming read
    size = os.path.getsize(path)
    buf = np.empty(size, np.uint8)
    with open(path, "rb") as f:
        f.readinto(memoryview(buf))
    hlen = int.from_bytes(buf[:8].tobytes(), "little")
    header = json.loads(buf[8:8 + hlen].tobytes().decode("utf-8"))
    header.pop("__metadata__", None)
    base = 8 + hlen

    # pass 1: the fp32 scales of fp8_scaled checkpoints
    scales: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name.endswith(".scale_weight"):
            o0, o1 = info["data_offsets"]
            arr = buf[base + o0: base + o1].view(_NP_DTYPES[info["dtype"]]).reshape(info["shape"])
            scales[name[: -len(".scale_weight")] + ".weight"] = arr

    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name.endswith(".scale_weight"):
            continue
        dt, shape = info["dtype"], info["shape"]
        o0, o1 = info["data_offsets"]
        raw = buf[base + o0: base + o1]
        scale = scales.get(name)
        if dt in _WIDEN:
            s, elementwise = 1.0, None
            if scale is not None:
                if scale.size == 1:
                    s = float(scale.reshape(-1)[0])
                else:
                    elementwise = scale
            arr = _convert(raw, dt, s, nthreads, native).reshape(shape)
            if elementwise is not None:
                arr = arr * elementwise.astype(np.float32)
        else:
            arr = raw.view(_NP_DTYPES[dt]).reshape(shape)
            if scale is not None:
                arr = arr.astype(np.float32) * scale.astype(np.float32)
        out[name] = arr
    return out
