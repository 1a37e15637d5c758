"""Non-causal attention on (B, S, H, D) tensors: hand-written Hopper
flash-attention forwards and their plain PyTorch version.

Replaces the two Pallas TPU kernels of `lanpaint_tpu/models/layers.py`:
`attention_bshd`'s flash branch (`flash_attention`, layers.py:213-242) and
`_splash_attention`/`_splash_kernel` (layers.py:103-173).  Both compute
softmax(Q K^T * scale) V with fp32 accumulation; they differ only in tiling.
The D <= 128 kernel also takes cross-attention (k and v of Sk rows other
than q's Sq): Wan's attention to its text tokens, which the JAX package
leaves to XLA (`attention_bshd(impl="auto")`, layers.py:176) with bf16
operands, fp32 logits and softmax and the probabilities cast to bf16 for
the product with V, as the kernel computes.

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
segment-id padding.  A cross launch also adds one to
`flash_attention.cross_launches`.

Head dims above 128 take `wide_attention` (`csrc/wide_attention.cu`):
the VAEs' mid attention, one head of D = 512 in the image VAE
(`lanpaint_tpu/models/vae.py:81`) and of D = 384 / 640 in the Wan2.1 /
Wan2.2 video VAEs (`lanpaint_tpu/models/video_vae.py:159`), where the TPU
path reaches the splash kernel.  A consumer warpgroup of the D <= 128
kernel keeps its whole output row block in registers, D / 2 of them a
thread, so the wide kernel's two consumers share one 64-query tile and
split the output's D in halves, and add their partial scores in shared
memory (its source says how).  It takes self-attention only.  It is built
from the same parts (TMA, `wgmma`, mbarriers) and reads the same tensor
maps, with 64-row Q boxes and 32-row K/V boxes (`WIDE_BLOCK_M`,
`WIDE_BLOCK_N`).

Each source is built with nvcc into its own library at first use
(`ops/cuda_build.py`); the libraries reach the driver's
`cuTensorMapEncodeTiled` through `cudaGetDriverEntryPoint` at run time and
link no libcuda.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import cuda_build

_I64 = ctypes.c_longlong
SUPPORTED_HEAD_DIMS = (64, 128)
WIDE_HEAD_DIMS = (384, 512, 640)
# The D <= 128 kernel's tiles (csrc/attention.cu checks that the geometry
# it is given has them): queries a block, keys a K/V tile, and the bf16
# columns of one TMA box row (128 bytes, the 128-byte swizzle's row).
BLOCK_M = 128
BLOCK_N = 128
BOX_COLS = 64
# the wide-head kernel's (csrc/wide_attention.cu): 64 queries, 32-key tiles
WIDE_BLOCK_M = 64
WIDE_BLOCK_N = 32
# each kernel's head dims, (q, k/v) box rows and whether it takes k and v
# of another length than q (cross-attention), by wrapper name
KERNELS = {"flash_attention": (SUPPORTED_HEAD_DIMS, BLOCK_M, BLOCK_N, True),
           "wide_attention": (WIDE_HEAD_DIMS, WIDE_BLOCK_M, WIDE_BLOCK_N, False)}


def tma_geometry(shape, strides, data_ptr: int, rows: int,
                 head_dims: tuple = SUPPORTED_HEAD_DIMS) -> tuple:
    """The 4D TMA tensor map of one (B, S, H, D) bf16 operand of an
    attention kernel, from its shape, element strides and data pointer
    alone: (dims, byte strides, box), with dims (D, H, S, B) innermost
    first, the byte strides of H, S and B, and a box of (BOX_COLS, 1, rows,
    1) elements (a D = 128 row is two boxes, a D = 640 row ten).  A dim of
    extent 1 is never stepped, so its stride is taken as packed.

    Raises ValueError for a layout TMA cannot take: a head dim outside
    `head_dims` (the D <= 128 kernel's by default) or not of unit stride, a
    base address that is not 16-byte aligned, or a stride that is not a
    positive multiple of 16 bytes (8 bf16 elements) below 2^40."""
    b, s, h, d = shape
    if d not in head_dims or strides[3] != 1:
        raise ValueError(f"TMA layout: head dim {d} with stride {strides[3]}; the kernel takes "
                         f"{head_dims} with unit stride")
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


def _tma_geometries(q, k, v, head_dims=SUPPORTED_HEAD_DIMS, block_m=BLOCK_M, block_n=BLOCK_N):
    """q's, k's and v's geometry as the kernel's int64 array (3 x 11): boxes
    of `block_m` rows for q and `block_n` for k and v."""
    vals = [x for t, rows in ((q, block_m), (k, block_n), (v, block_n))
            for part in tma_geometry(t.shape, t.stride(), t.data_ptr(), rows, head_dims)
            for x in part]
    return (_I64 * len(vals))(*vals)


def attention_ref(q, k, v, scale: Optional[float] = None):
    """Plain multi-head attention on (B, S, H, D) / (B, Sk, H, D) tensors.

    fp32 logits, softmax and product; returns q's dtype.  The kernels'
    reference, and the path of attention no kernel takes."""
    scale = (1.0 / math.sqrt(q.shape[-1])) if scale is None else scale
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    probs = torch.softmax((qf @ kf.transpose(-1, -2)) * scale, dim=-1)
    return (probs @ vf).transpose(1, 2).to(q.dtype)


def _check_cuda_inputs(op: str, q, k, v, head_dims, cross: bool = True):
    """Refuse what kernel `op` cannot take: q (B, Sq, H, D) and k, v (B, Sk,
    H, D) with Sk >= 1, and Sk = Sq unless `cross`, as 4D bfloat16 tensors
    on one device in a layout TMA reads."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.bfloat16 or t.ndim != 4:
            raise ValueError(
                f"{op}: {name} must be a 4D bfloat16 tensor on {q.device}; "
                f"got {tuple(t.shape)} {t.dtype} on {t.device}")
        if (t.stride(-1) != 1 or t.data_ptr() % 16
                or any(s % 8 for s in t.stride()[:3])):
            raise ValueError(
                f"{op}: {name} needs a unit-stride head dim, 16-byte "
                f"alignment and strides divisible by 8; got strides {t.stride()}")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"{op}: q, k, v need one batch, head count and head dim, and k and v "
                         f"one shape; got q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if k.shape[1] < 1 or (not cross and k.shape[1] != q.shape[1]):
        raise ValueError(f"{op} takes {'Sk >= 1' if cross else 'self-attention only (Sk = S)'}; "
                         f"got S {q.shape[1]}, Sk {k.shape[1]}")
    if q.shape[-1] not in head_dims:
        raise ValueError(f"{op}: head dim {q.shape[-1]} not in {head_dims}")


def _tma_launch(op, entry, q, k, v, scale):
    """Check q/k/v, compute their tensor maps' geometry for kernel `op`
    (KERNELS), allocate the output and launch through the C `entry` point
    (a build of the kernel's source) on the current stream.  Raises on a
    refused launch."""
    head_dims, block_m, block_n, cross = KERNELS[op]
    _check_cuda_inputs(op, q, k, v, head_dims, cross)
    geom = _tma_geometries(q, k, v, head_dims, block_m, block_n)
    b, s, h, d = q.shape
    scale = (1.0 / math.sqrt(d)) if scale is None else float(scale)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, k.shape[1], h,
                d, geom, *out.stride()[:3], scale, cuda_build.stream_handle(q.device))
    if err != 0:
        raise RuntimeError(f"{op} kernel launch failed: CUDA error {err}")
    return out


def flash_attention(q, k, v, scale: Optional[float] = None):
    """Non-causal attention of q (B, S, H, D) over k, v (B, Sk, H, D) ->
    (B, S, H, D); Sk = S is self-attention.

    A CPU tensor takes `attention_ref`.  A CUDA tensor launches the Hopper
    kernel (bf16, D in SUPPORTED_HEAD_DIMS, a layout `tma_geometry` takes)
    or raises.  Each launch adds one to `flash_attention.launches`, and a
    cross launch (Sk != S) one to `flash_attention.cross_launches` too."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    out = _tma_launch("flash_attention", cuda_build.entry("attention"), q, k, v, scale)
    flash_attention.launches += 1
    flash_attention.cross_launches += int(k.shape[1] != q.shape[1])
    return out


flash_attention.launches = 0
flash_attention.cross_launches = 0


def wide_attention(q, k, v, scale: Optional[float] = None):
    """Non-causal self-attention on (B, S, H, D) tensors with a wide head
    (D in WIDE_HEAD_DIMS) -> (B, S, H, D).

    A CPU tensor takes `attention_ref`.  A CUDA tensor launches the
    wide-head Hopper kernel (bf16, a layout `tma_geometry` takes) or
    raises.  Each launch adds one to `wide_attention.launches`."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"wide_attention: unsupported device {q.device}")
    out = _tma_launch("wide_attention", cuda_build.entry("wide_attention"), q, k, v, scale)
    wide_attention.launches += 1
    return out


wide_attention.launches = 0
