"""The think step's two pointwise phases as a CUDA C++ kernel for Hopper,
with their plain PyTorch versions and the plain twin of the kernel's draw.

Replaces the Pallas TPU kernels of `lanpaint_tpu/ops/fused.py`:
`fused_half_step` (`_half_kernel`, the pre-model phase: mask-mixed damped
SHO half step and overdamped OU half step, non-finite -> OU select) and
`fused_finish` (`_finish_kernel`, the post-model phase: velocity kick and
second half step when warm, one full step with the fresh drift C when
cold, with the same selects).  Same numerical contract as the JAX kernels
and as the engine's jnp-style path (`engine.lanpaint_update` with the flag
off), up to the random stream.

What bounds them on this card: bytes, and at latent sizes the launch.
Each element reads per-batch scalars, does ~60 flops and draws up to 3
normals; the half step moves 28 B an element (4 fp32 reads, 3 writes), the
warm finish 32 B (6 reads, 2 writes), the cold finish 20 B (3 reads, 2
writes): 7.3, 8.4 and 5.2 MB at Flux's 262,144 latent elements, 1.6-2.5 us
at 3.35 TB/s.  The kernel (`csrc/fused.cu`, one library, one C entry
point taking the phase) works on a flat contiguous (B, M) view cut into
quads of four consecutive flat indices: a thread takes `quads` of them,
16-byte loads and stores where a quad lies in one batch row and every
pointer is 16-byte aligned, element by element otherwise; the block reads
its row's two (B, 24) table rows once; the normals are drawn in registers,
so no latent-sized noise tensor reaches device memory; and a launch is one
ctypes call.  Its block shape is `BLOCK_SHAPE`, from
`scripts/measure_torch_fused.py`.

The draw.  Stream j of element e (flat index in (B, M)) is lane g % 4 of
Philox4x32-10 with counter (g >> 2, launch, j, 0) and key (seed_lo,
seed_hi), where g = offset + e is the element's index in the whole batch
(the wrapper's `offset`: a data-parallel rank's rows.start * M, 0 in one
process, so the ranks together draw the one-process stream), the key the
64 bits of a one-element int64 tensor on the card (drawn from the run's
generator, so the loop needs no host sync); launch is the wrapper's
`launch` argument.  Streams 0, 1, 2 are (ey, ev, vs) in the half
step and (ey2, ev2, vs) in the finish.  A call's four words give two
Box-Muller pairs: u1 = (w >> 8) * 2^-24 + 2^-25, u2 = (w' >> 8) * 2^-24,
normals (r cos 2 pi u2, r sin 2 pi u2) with r = sqrt(-2 ln u1), as the TPU
kernel maps its bits; all-zero bits give (sqrt(-2 ln 2^-25), 0).
`philox_normals` draws the same numbers on the CPU (for tests and
`chip_smoke.py`; the engine never calls it).

Coefficient tables: one (B, 2 * N_COEF) fp32 table per region branch (x =
unknown, y = known), the half-step row then the full-step row, each
`[wy_cy, wy_v, wv_cy, wv_v, l_yy, l_vy, l_vv, ou_decay, ou_k, ou_ns, a,
slot11]` with slot 11 = sqrt(Gamma) * dt in the half row (the velocity
kick) and dt in the full row (the overdamped position kick), as the JAX
package packs them.  They are built from `engine._branch_scalars`, the
port's one parameterization.

The kernel is built (`ops/cuda_build.py`) where it is first launched, so
this module imports where there is no nvcc.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_build
from .sho import OUCoeffs, SHOCoeffs, ou_apply, sho_apply

N_COEF = 12
# Indices into engine._branch_scalars's field list [a, dt, sqrt_gamma_dt,
# *sho_half(7), *sho_full(7), *ou_half(3), *ou_full(3)] giving a table row.
HALF_FIELDS = (3, 4, 5, 6, 7, 8, 9, 17, 18, 19, 0, 2)
FULL_FIELDS = (10, 11, 12, 13, 14, 15, 16, 20, 21, 22, 0, 1)
TABLE_FIELDS = HALF_FIELDS + FULL_FIELDS
# the kernel's phase argument
HALF, WARM, COLD = 0, 1, 2
# (threads a block, quads a thread): the block shape of least launch-weighted
# device time at both main-path latent sizes (SDXL 4 x 128 x 128, Flux 16 x
# 128 x 128) in the sweep on the card (scripts/measure_torch_fused.py;
# NVIDIA H100 80GB HBM3, 700 W)
BLOCK_SHAPE = (128, 1)
MAX_ROWS = 65535  # the grid's second dimension
# Philox4x32-10's round multipliers and key increments (Random123)
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def pack_branch_coeffs(config, times):
    """(coef_x, coef_y) tables for the unknown and known branches."""
    from ..engine import _branch_scalars  # the engine imports this module

    fx, fy, _, _ = _branch_scalars(config, times.abt)
    return tuple(torch.stack([f[j] for j in TABLE_FIELDS], dim=-1).float() for f in (fx, fy))


# ---------------------------------------------------------------- plain versions


def _mix_col(coef_x, coef_y, j, mask):
    """Table column j mixed per element by the region mask."""
    cx, cy = coef_x[:, j:j + 1], coef_y[:, j:j + 1]
    return cx + (cy - cx) * mask


def _mixed_row(coef_x, coef_y, row, mask, noise_mult):
    """Slots 0-10 of one table row, mixed: (SHO coeffs, OU coeffs, a), the
    noise coefficients scaled by noise_mult."""
    w = [_mix_col(coef_x, coef_y, row + j, mask) for j in range(N_COEF - 1)]
    sho = SHOCoeffs(*w[:4], *(t * noise_mult for t in w[4:7]))
    return sho, OUCoeffs(w[7], w[8], w[9] * noise_mult), w[10]


def _finite(y, v):
    return torch.isfinite(y) & torch.isfinite(v)


def fused_half_step_ref(coef_x, coef_y, noise_mult, x, v, c, mask, ey, ev, vs):
    """Pre-model phase on (B, M) fp32 tensors with explicit normals
    (ey, ev) for the damped step (ey also drives the OU step) and vs for
    the stationary velocity.  Returns (x_half, v_half, x_half_overdamped)."""
    sho, ou, a = _mixed_row(coef_x, coef_y, 0, mask, noise_mult)
    xh_d, vh_d = sho_apply(sho, x, v, a, c, ey, ev)
    xh_o = ou_apply(ou, x, c, ey)
    ok = _finite(xh_d, vh_d)
    return torch.where(ok, xh_d, xh_o), torch.where(ok, vh_d, vs * noise_mult), xh_o


def fused_finish_ref(coef_x, coef_y, noise_mult, warm: bool, x_in, x_half, v_half,
                     x_half_od, c_old, c_new, mask, ey2, ev2, vs):
    """Post-model phase.  Warm: velocity kick, then the second half step
    with the old C from the half point (x_half, v_half, x_half_od).  Cold:
    one full step from x_in with the fresh C and the stationary velocity
    (the half-step arguments and c_old are not read).  The non-finite
    select looks at this phase's damped result only, as the TPU kernel
    does.  Returns (x, v)."""
    v_stat = vs * noise_mult
    if warm:
        sho, ou, a = _mixed_row(coef_x, coef_y, 0, mask, noise_mult)
        dc = c_new - c_old
        v_kick = v_half + _mix_col(coef_x, coef_y, 11, mask) * dc  # sqrt(Gamma) dt
        x_kick = x_half_od + _mix_col(coef_x, coef_y, N_COEF + 11, mask) * dc  # dt
        x_d, v_d = sho_apply(sho, x_half, v_kick, a, c_old, ey2, ev2)
        x_o = ou_apply(ou, x_kick, c_old, ey2)
    else:
        sho, ou, a = _mixed_row(coef_x, coef_y, N_COEF, mask, noise_mult)
        x_d, v_d = sho_apply(sho, x_in, v_stat, a, c_new, ey2, ev2)
        x_o = ou_apply(ou, x_in, c_new, ey2)
    ok = _finite(x_d, v_d)
    return torch.where(ok, x_d, x_o), torch.where(ok, v_d, v_stat)


# ---------------------------------------------------------------- the draw


def philox4x32_10(counter, key):
    """Philox4x32-10 of `counter` (four uint32 words, each an int or an
    array, broadcast together) under `key` (two uint32 ints): the four
    output words as uint32 arrays.  Each 32 x 32-bit product is taken in
    uint64, where it is exact."""
    c0, c1, c2, c3 = (a.astype(np.uint64) for a in np.broadcast_arrays(
        *(np.asarray(w, dtype=np.uint64) for w in counter)))
    low = np.uint64(0xFFFFFFFF)
    k0, k1 = int(key[0]), int(key[1])
    for r in range(10):
        if r:
            k0, k1 = (k0 + PHILOX_W[0]) & 0xFFFFFFFF, (k1 + PHILOX_W[1]) & 0xFFFFFFFF
        p0, p1 = np.uint64(PHILOX_M[0]) * c0, np.uint64(PHILOX_M[1]) * c2
        c0, c1, c2, c3 = ((p1 >> np.uint64(32)) ^ c1 ^ np.uint64(k0), p1 & low,
                          (p0 >> np.uint64(32)) ^ c3 ^ np.uint64(k1), p0 & low)
    return tuple(w.astype(np.uint32) for w in (c0, c1, c2, c3))


def box_muller(w0, w1):
    """Two fp32 standard normals from two uint32 words, as the kernel maps
    them: u1 = (w0 >> 8) * 2^-24 + 2^-25 (never 0) and u2 = (w1 >> 8) *
    2^-24 in fp32, then (r cos 2 pi u2, r sin 2 pi u2), r = sqrt(-2 ln u1),
    each factor rounded to fp32 from float64."""
    u1 = (w0 >> 8).astype(np.float32) * np.float32(2.0**-24) + np.float32(2.0**-25)
    u2 = (w1 >> 8).astype(np.float32) * np.float32(2.0**-24)
    r = np.sqrt(-2.0 * np.log(u1.astype(np.float64))).astype(np.float32)
    turn = np.pi * (2.0 * u2.astype(np.float64))
    return r * np.cos(turn).astype(np.float32), r * np.sin(turn).astype(np.float32)


def philox_normals(seed, launch: int, b: int, m: int, offset: int = 0) -> torch.Tensor:
    """The three (b, m) fp32 normals streams the kernel draws on a (b, m)
    view with `seed` (an int, or a one-element int64 tensor: its 64 bits
    are the key) at `launch` and element `offset` (the view's first
    element's index in the whole batch), on the CPU: (3, b, m), streams 0,
    1, 2."""
    bits = int(seed) & 0xFFFFFFFFFFFFFFFF
    key = (bits & 0xFFFFFFFF, bits >> 32)
    n = b * m
    first, lane = divmod(offset, 4)
    quads = np.arange(first, (offset + n + 3) // 4, dtype=np.uint64)
    out = np.empty((3, quads.size, 4), np.float32)
    for j in range(3):
        w = philox4x32_10((quads, launch, j, 0), key)
        out[j, :, 0], out[j, :, 1] = box_muller(w[0], w[1])
        out[j, :, 2], out[j, :, 3] = box_muller(w[2], w[3])
    return torch.from_numpy(out.reshape(3, -1)[:, lane:lane + n].reshape(3, b, m).copy())


# ---------------------------------------------------------------- the kernel


def _check_cuda(name, seed, coef_x, coef_y, arrays, offset=0):
    if any(t is None for t in arrays):
        raise ValueError(f"{name}: a latent array is missing")
    if arrays[0].dim() != 2:
        raise ValueError(f"{name}: latent arrays must be (B, M); got {tuple(arrays[0].shape)}")
    b, m = arrays[0].shape
    for t in arrays:
        if (t.device != arrays[0].device or t.dtype != torch.float32 or t.shape != (b, m)
                or not t.is_contiguous()):
            raise ValueError(f"{name}: latent arrays must be contiguous ({b}, {m}) float32 on "
                             f"{arrays[0].device}; got {tuple(t.shape)} {t.dtype} on {t.device}")
    for t in (coef_x, coef_y):
        if (t.device != arrays[0].device or t.dtype != torch.float32
                or t.shape != (b, 2 * N_COEF) or not t.is_contiguous()):
            raise ValueError(f"{name}: coefficient tables must be contiguous "
                             f"({b}, {2 * N_COEF}) float32 on {arrays[0].device}")
    if (not isinstance(seed, torch.Tensor) or seed.device != arrays[0].device
            or seed.dtype != torch.int64 or seed.numel() != 1):
        raise ValueError(f"{name}: seed must be a one-element int64 tensor on {arrays[0].device}")
    if offset < 0 or offset + b * m >= 2**31 or b > MAX_ROWS:
        raise ValueError(f"{name}: {b} x {m} elements at offset {offset} exceed the kernel's "
                         f"int32 indexing or its {MAX_ROWS} rows")


def _route(name, x, normals):
    """'cpu' (plain version, explicit normals) or 'cuda' (kernel, in-kernel
    normals); anything else raises."""
    if x.device.type == "cpu":
        if normals is None:
            raise ValueError(f"{name}: on the CPU the plain version needs its normals")
        return "cpu"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if normals is not None:
        raise ValueError(f"{name}: the kernel draws its own normals; got explicit ones")
    return "cuda"


def _launch(wrapper, phase, seed, launch, offset, coef_x, coef_y, noise_mult, x, v=None,
            x_od=None, c_old=None, c_new=None, mask=None, n_out=2, config=None):
    """Launch one phase and add one to `wrapper.launches`; `config`
    overrides `BLOCK_SHAPE` (a sweep).  Returns the n_out outputs."""
    b, m = x.shape
    if not 0 <= launch < 2**32:
        raise ValueError(f"{wrapper.__name__}: launch {launch} is not a uint32")
    outs = [torch.empty_like(x) for _ in range(n_out)]
    threads, quads = config or BLOCK_SHAPE
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = cuda_build.entry("fused")(
        phase, seed.data_ptr(), launch, offset, coef_x.data_ptr(), coef_y.data_ptr(), x.data_ptr(),
        ptr(v), ptr(x_od), ptr(c_old), ptr(c_new), mask.data_ptr(), outs[0].data_ptr(),
        outs[1].data_ptr(), ptr(outs[2] if n_out == 3 else None), b, m, noise_mult, threads,
        quads, cuda_build.stream_handle(x.device))
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
    return tuple(outs)


def fused_half_step(coef_x, coef_y, noise_mult, x, v, c, mask, *, seed=None, launch: int = 0,
                    offset: int = 0, normals=None):
    """Pre-model phase of a think step on (B, M) fp32 tensors.

    A CPU tensor takes `fused_half_step_ref` with `normals` = (ey, ev, vs).
    A CUDA tensor launches the kernel, which draws its normals with Philox
    (counter ((offset + e) >> 2, `launch`, stream, 0), lane (offset + e) %
    4, key `seed`, a one-element int64 tensor on the card;
    `philox_normals` is its CPU twin), or raises.  `offset`: the view's
    first element's index in the whole batch (a data-parallel rank's
    rows.start * M).  Each launch adds one to `fused_half_step.launches`.
    Returns (x_half, v_half, x_half_overdamped)."""
    if _route("fused_half_step", x, normals) == "cpu":
        return fused_half_step_ref(coef_x, coef_y, noise_mult, x, v, c, mask, *normals)
    _check_cuda("fused_half_step", seed, coef_x, coef_y, (x, v, c, mask), int(offset))
    return _launch(fused_half_step, HALF, seed, int(launch), int(offset), coef_x, coef_y,
                   float(noise_mult), x, v=v, c_old=c, mask=mask, n_out=3)


def fused_finish(coef_x, coef_y, noise_mult, warm: bool, x_in, x_half, v_half, x_half_od,
                 c_old, c_new, mask, *, seed=None, launch: int = 0, offset: int = 0,
                 normals=None):
    """Post-model phase of a think step on (B, M) fp32 tensors; `warm` is
    a host bool (a compile-time flag of the kernel).  When cold, x_half,
    v_half, x_half_od and c_old are not read and may be None; when warm,
    x_in is not read.

    A CPU tensor takes `fused_finish_ref` with `normals` = (ey2, ev2, vs);
    a CUDA tensor launches the kernel (normals from Philox at `offset`, as
    in `fused_half_step`) or raises.  Each launch adds one to
    `fused_finish.launches`.  Returns (x, v)."""
    if _route("fused_finish", x_in, normals) == "cpu":
        return fused_finish_ref(coef_x, coef_y, noise_mult, warm, x_in, x_half, v_half,
                                x_half_od, c_old, c_new, mask, *normals)
    if warm:
        _check_cuda("fused_finish", seed, coef_x, coef_y,
                    (x_half, v_half, x_half_od, c_old, c_new, mask), int(offset))
        return _launch(fused_finish, WARM, seed, int(launch), int(offset), coef_x, coef_y,
                       float(noise_mult), x_half, v=v_half, x_od=x_half_od, c_old=c_old,
                       c_new=c_new, mask=mask)
    _check_cuda("fused_finish", seed, coef_x, coef_y, (x_in, c_new, mask), int(offset))
    return _launch(fused_finish, COLD, seed, int(launch), int(offset), coef_x, coef_y,
                   float(noise_mult), x_in, c_new=c_new, mask=mask)


fused_half_step.launches = 0
fused_finish.launches = 0
