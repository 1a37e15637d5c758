"""Row normalization (LayerNorm / RMSNorm) over the last axis: a CUDA C++
kernel for Hopper and its plain PyTorch versions.

Replaces the Pallas TPU kernel `_norm_kernel` / `_pallas_norm` of
`lanpaint_tpu/ops/norms.py` (reached through `fused_layernorm` /
`fused_rmsnorm`).  Same numerical contract: fp32 statistics, the one-pass
E[x^2] - E[x]^2 variance of flax's nn.LayerNorm, rsqrt(var + eps), optional
affine, output in the input dtype unless `out_dtype` is given.

What bounds it on this card: bytes.  A row is read once and written once
(4 bytes per bf16 element moved for ~8 flops), far below the H100's
flop/byte ridge.  The kernel (`csrc/row_norm.cu`) therefore moves only
those bytes, and keeps enough of them in flight:

* strided rows without a copy.  `row_geometry` collapses the input's
  leading dims into at most two row dims with their strides; the kernel
  reads through them and writes a contiguous output.  QKNorm's q and k, the
  (B, S, H, D) column slices of a fused projection (`models/dit.py`), are
  rows (B*S, H) with strides (3*H*D or `linear1`'s width, D).  The Triton
  kernel this replaces took `reshape(-1, C)` of that view, a full copy,
  before reading it again.  A layout that does not collapse raises;
* 16-byte loads, and many rows a block for narrow rows (at C = 128, 8
  threads a row and 16 rows a block), whole warps a row for wide ones;
  `launch_config` gives the shape a block has at each C;
* a cheap launch: one ctypes call of a plain C function, where Triton's
  Python launcher cost ~30-45 us a call above `F.layer_norm`'s on the
  host (`PERF.md`).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises (a dtype other than fp32 / bf16, C > MAX_FEATURES or C % 8, a row
or parameter that is not 16-byte aligned).
"""

import torch

from . import cuda_build

MAX_FEATURES = 8192
VEC = 8  # elements a kernel thread loads at once (16 bytes of bf16)
# kernel dtype flags: 1 for bf16, 0 for fp32
_BF16 = {torch.bfloat16: 1, torch.float32: 0}
# C -> (threads a block, threads a row): the main paths' widths, each the
# block shape of least launch-weighted device time in the sweep on the card
# (scripts/measure_torch_row_norm.py; NVIDIA H100 80GB HBM3, 700 W); other
# widths follow `launch_config`'s rule
CONFIG = {64: (128, 8), 128: (128, 8), 640: (256, 32), 1280: (192, 96), 2560: (96, 96),
          3072: (128, 128), 3584: (128, 128), 3840: (128, 128)}


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


def row_geometry(shape, strides) -> tuple:
    """The rows of a tensor of `shape` and element `strides`, normalised
    over its last dim, as the kernel reads them: (n_outer, n_inner,
    s_outer, s_inner), row (o, i) at element offset o * s_outer + i *
    s_inner, o < n_outer and i < n_inner, in the order of the tensor's own
    rows.  Leading dims collapse where one steps exactly over the next
    (extent-1 dims are dropped); one left gives n_outer = 1, s_outer = 0.

    Raises ValueError if the last dim is not of unit stride or the leading
    dims do not collapse into two."""
    if shape[-1] > 1 and strides[-1] != 1:
        raise ValueError(f"row norm: the last dim needs unit stride; got strides {tuple(strides)}")
    groups = []  # [extent, stride], innermost first
    for n, st in zip(reversed(shape[:-1]), reversed(strides[:-1])):
        if n == 1:
            continue
        if groups and st == groups[-1][0] * groups[-1][1]:
            groups[-1][0] *= n
        else:
            groups.append([n, st])
    if len(groups) > 2:
        raise ValueError(f"row norm: shape {tuple(shape)} with strides {tuple(strides)} does not "
                         "collapse into two row dims")
    (n_in, s_in), (n_out, s_out) = (groups or [[1, shape[-1]]]) + [[1, 0]] * (len(groups) < 2)
    return n_out, n_in, s_out, s_in


def max_threads(nv: int) -> int:
    """The kernel's limit on threads a block where a thread holds `nv`
    16-byte vectors (csrc/row_norm.cu `max_threads`): its registers must
    hold 8 * nv values within 65,536 / threads."""
    return 1024 if nv <= 2 else 2048 // nv


def launch_config(c: int) -> tuple:
    """(threads a block, threads a row) of the kernel at row width `c`: the
    sweep's choice where it measured one (CONFIG), else 16-byte vectors
    spread over threads -- up to 32 threads a row, many rows a block, for
    narrow rows; a block a row, two vectors a thread, for wide ones."""
    if c in CONFIG:
        return CONFIG[c]
    nvec = -(-c // VEC)
    if nvec <= 32:
        return 256, 1 << max(nvec - 1, 0).bit_length()
    if nvec <= 256:
        return 256, 32
    return min(-(-nvec // 64) * 32, 1024), min(-(-nvec // 64) * 32, 1024)


def _launch(wrapper, x, gamma, beta, eps, rms, out_dtype, config=None):
    """Check the operands and launch the kernel, adding one to
    `wrapper.launches`; `config` overrides `launch_config` (a sweep)."""
    c = x.shape[-1]
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if (x.dtype not in _BF16 or out_dtype not in _BF16 or c > MAX_FEATURES or c % VEC
            or x.data_ptr() % 16):
        raise ValueError(f"row norm kernel: takes fp32 / bf16 rows of C % {VEC} == 0, C <= "
                         f"{MAX_FEATURES}, 16-byte aligned; got {x.dtype} -> {out_dtype}, C = {c}")
    n_outer, n_inner, s_outer, s_inner = row_geometry(x.shape, x.stride())
    if s_outer % VEC or s_inner % VEC:
        raise ValueError(f"row norm kernel: row strides {s_outer}, {s_inner} are not multiples "
                         f"of {VEC} elements")
    params = [p for p in (gamma, beta) if p is not None]
    for p in params:
        if (p.device != x.device or p.shape != (c,) or p.dtype != params[0].dtype
                or p.dtype not in _BF16 or p.stride(0) != 1 or p.data_ptr() % 16):
            raise ValueError(f"row norm kernel: gamma and beta must be contiguous ({c},) fp32 "
                             f"or bf16 tensors of one dtype on {x.device}")
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    threads, tpr = config or launch_config(c)
    err = cuda_build.entry("row_norm")(
        x.data_ptr(), None if gamma is None else gamma.data_ptr(),
        None if beta is None else beta.data_ptr(), out.data_ptr(), n_outer * n_inner, n_inner,
        s_outer, s_inner, c, _BF16[x.dtype], bool(params) and _BF16[params[0].dtype],
        _BF16[out_dtype], rms, eps, threads, tpr, cuda_build.stream_handle(x.device))
    if err != 0:
        raise RuntimeError(f"row norm kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
    return out


def layernorm(x, gamma=None, beta=None, eps: float = 1e-5, out_dtype=None):
    """LayerNorm over the last axis.  A CPU tensor takes `layernorm_ref`; a
    CUDA tensor launches the kernel or raises.  Each launch adds one to
    `layernorm.launches`."""
    if x.device.type == "cpu":
        return layernorm_ref(x, gamma, beta, eps, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"layernorm: unsupported device {x.device}")
    return _launch(layernorm, x, gamma, beta, eps, rms=False, out_dtype=out_dtype)


def rmsnorm(x, gamma=None, eps: float = 1e-6):
    """RMSNorm over the last axis; CPU -> `rmsnorm_ref`, CUDA -> the kernel
    (or raise).  Each launch adds one to `rmsnorm.launches`."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, gamma, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    return _launch(rmsnorm, x, gamma, None, eps, rms=True, out_dtype=None)


layernorm.launches = 0
rmsnorm.launches = 0
