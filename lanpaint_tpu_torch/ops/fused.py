"""The think step's two pointwise phases as fused Triton kernels for Hopper,
with their plain PyTorch versions.

Replaces the Pallas TPU kernels of `lanpaint_tpu/ops/fused.py`:
`fused_half_step` (`_half_kernel`, the pre-model phase: mask-mixed damped
SHO half step and overdamped OU half step, non-finite -> OU select) and
`fused_finish` (`_finish_kernel`, the post-model phase: velocity kick and
second half step when warm, one full step with the fresh drift C when
cold, with the same selects).  Same numerical contract as the JAX kernels
and as the engine's jnp-style path (`engine.lanpaint_update` with the flag
off), up to the random stream.

What bounds them on this card: bytes, and at latent sizes the launch.
Each element reads per-batch scalars, does ~60 flops and draws 3 normals;
the half step moves 28 B an element (4 fp32 reads, 3 writes), the finish
36 B (7 reads, 2 writes) — 7.3 and 9.4 MB at Flux's 262,144 latent
elements, ~3 us at 3.35 TB/s.  The design: a flat contiguous (B, M) view
of the latent (no TPU-style (rows, 128) tiling or padding: each program
masks its own tail), one program per 1,024 elements of one batch row, the
row's two (B, 24) coefficient tables loaded as scalars and mixed per
element by the region mask, and the normals drawn in registers with
Philox (`tl.randn4x`), so no latent-sized noise tensor reaches device
memory.  The Philox seed is a one-element int64 tensor on the card (drawn
from the run's generator, so the loop needs no host sync) plus a launch
index; the counter is the element's flat index.

Coefficient tables: one (B, 2 * N_COEF) fp32 table per region branch (x =
unknown, y = known), the half-step row then the full-step row, each
`[wy_cy, wy_v, wv_cy, wv_v, l_yy, l_vy, l_vv, ou_decay, ou_k, ou_ns, a,
slot11]` with slot 11 = sqrt(Gamma) * dt in the half row (the velocity
kick) and dt in the full row (the overdamped position kick), as the JAX
package packs them.  They are built from `engine._branch_scalars`, the
port's one parameterization.

Triton is imported, and the kernels compiled, inside the launching
functions, so this module imports where triton is absent.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from .sho import OUCoeffs, SHOCoeffs, ou_apply, sho_apply

N_COEF = 12
# Indices into engine._branch_scalars's field list [a, dt, sqrt_gamma_dt,
# *sho_half(7), *sho_full(7), *ou_half(3), *ou_full(3)] giving a table row.
HALF_FIELDS = (3, 4, 5, 6, 7, 8, 9, 17, 18, 19, 0, 2)
FULL_FIELDS = (10, 11, 12, 13, 14, 15, 16, 20, 21, 22, 0, 1)
TABLE_FIELDS = HALF_FIELDS + FULL_FIELDS
BLOCK = 1024  # elements per program

# bound to `triton.language` and the jitted helpers when the kernels are
# first built (the kernel bodies resolve them as module globals)
tl = None
_coef = _sho = _ou = _finite_k = None
_KERNELS = None


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


# ---------------------------------------------------------------- the kernels


def _build():
    global tl, _coef, _sho, _ou, _finite_k, _KERNELS
    if _KERNELS is None:
        os.environ.setdefault("TRITON_CACHE_DIR",
                              str(Path(__file__).resolve().parent.parent / "_build" / "triton"))
        import triton
        import triton.language

        tl = triton.language

        @triton.jit
        def coef(cx_ptr, cy_ptr, row, j: tl.constexpr, mask):
            cx = tl.load(cx_ptr + row + j)
            cy = tl.load(cy_ptr + row + j)
            return cx + (cy - cx) * mask

        @triton.jit
        def sho(cx_ptr, cy_ptr, row, R: tl.constexpr, mask, y0, v0, c, ey, ev, nm):
            wy_cy = _coef(cx_ptr, cy_ptr, row, R + 0, mask)
            wy_v = _coef(cx_ptr, cy_ptr, row, R + 1, mask)
            wv_cy = _coef(cx_ptr, cy_ptr, row, R + 2, mask)
            wv_v = _coef(cx_ptr, cy_ptr, row, R + 3, mask)
            l_yy = _coef(cx_ptr, cy_ptr, row, R + 4, mask) * nm
            l_vy = _coef(cx_ptr, cy_ptr, row, R + 5, mask) * nm
            l_vv = _coef(cx_ptr, cy_ptr, row, R + 6, mask) * nm
            a = _coef(cx_ptr, cy_ptr, row, R + 10, mask)
            drive = c - a * y0
            y = y0 + wy_cy * drive + wy_v * v0 + l_yy * ey
            v = wv_cy * drive + wv_v * v0 + l_vy * ey + l_vv * ev
            return y, v

        @triton.jit
        def ou(cx_ptr, cy_ptr, row, R: tl.constexpr, mask, x0, c, eps, nm):
            decay = _coef(cx_ptr, cy_ptr, row, R + 7, mask)
            k = _coef(cx_ptr, cy_ptr, row, R + 8, mask)
            ns = _coef(cx_ptr, cy_ptr, row, R + 9, mask) * nm
            return decay * x0 + k * c + ns * eps

        @triton.jit
        def finite(y, v):
            # NaN fails both comparisons, +-inf the bound
            return (tl.abs(y) <= 3.4028234663852886e38) & (tl.abs(v) <= 3.4028234663852886e38)

        @triton.jit
        def half_kernel(seed_ptr, seed_off, cx_ptr, cy_ptr, x_ptr, v_ptr, c_ptr, m_ptr,
                        xh_ptr, vh_ptr, xho_ptr, n_cols, nm, BLOCK: tl.constexpr):
            b = tl.program_id(1)
            cols = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
            inb = cols < n_cols
            idx = b * n_cols + cols
            row = b * 24
            x = tl.load(x_ptr + idx, mask=inb, other=0.0)
            v = tl.load(v_ptr + idx, mask=inb, other=0.0)
            c = tl.load(c_ptr + idx, mask=inb, other=0.0)
            mask = tl.load(m_ptr + idx, mask=inb, other=0.0)
            ey, ev, vs, _ = tl.randn4x(tl.load(seed_ptr) + seed_off, idx)
            xh_d, vh_d = _sho(cx_ptr, cy_ptr, row, 0, mask, x, v, c, ey, ev, nm)
            xh_o = _ou(cx_ptr, cy_ptr, row, 0, mask, x, c, ey, nm)
            ok = _finite_k(xh_d, vh_d)
            tl.store(xh_ptr + idx, tl.where(ok, xh_d, xh_o), mask=inb)
            tl.store(vh_ptr + idx, tl.where(ok, vh_d, vs * nm), mask=inb)
            tl.store(xho_ptr + idx, xh_o, mask=inb)

        @triton.jit
        def finish_kernel(seed_ptr, seed_off, cx_ptr, cy_ptr, xin_ptr, xh_ptr, vh_ptr, xho_ptr,
                          co_ptr, cn_ptr, m_ptr, xo_ptr, vo_ptr, n_cols, nm,
                          WARM: tl.constexpr, BLOCK: tl.constexpr):
            b = tl.program_id(1)
            cols = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
            inb = cols < n_cols
            idx = b * n_cols + cols
            row = b * 24
            mask = tl.load(m_ptr + idx, mask=inb, other=0.0)
            c_new = tl.load(cn_ptr + idx, mask=inb, other=0.0)
            ey2, ev2, vs, _ = tl.randn4x(tl.load(seed_ptr) + seed_off, idx)
            v_stat = vs * nm
            if WARM:
                xh = tl.load(xh_ptr + idx, mask=inb, other=0.0)
                vh = tl.load(vh_ptr + idx, mask=inb, other=0.0)
                xh_o = tl.load(xho_ptr + idx, mask=inb, other=0.0)
                c_old = tl.load(co_ptr + idx, mask=inb, other=0.0)
                dc = c_new - c_old
                v_kick = vh + _coef(cx_ptr, cy_ptr, row, 11, mask) * dc
                x_d, v_d = _sho(cx_ptr, cy_ptr, row, 0, mask, xh, v_kick, c_old, ey2, ev2, nm)
                x_kick = xh_o + _coef(cx_ptr, cy_ptr, row, 23, mask) * dc
                x_o = _ou(cx_ptr, cy_ptr, row, 0, mask, x_kick, c_old, ey2, nm)
            else:
                x_in = tl.load(xin_ptr + idx, mask=inb, other=0.0)
                x_d, v_d = _sho(cx_ptr, cy_ptr, row, 12, mask, x_in, v_stat, c_new, ey2, ev2, nm)
                x_o = _ou(cx_ptr, cy_ptr, row, 12, mask, x_in, c_new, ey2, nm)
            ok = _finite_k(x_d, v_d)
            tl.store(xo_ptr + idx, tl.where(ok, x_d, x_o), mask=inb)
            tl.store(vo_ptr + idx, tl.where(ok, v_d, v_stat), mask=inb)

        _coef, _sho, _ou, _finite_k = coef, sho, ou, finite
        _KERNELS = (half_kernel, finish_kernel)
    return _KERNELS


def _check_cuda(name, seed, coef_x, coef_y, arrays):
    b, m = arrays[0].shape
    for t in arrays:
        if t is None:
            raise ValueError(f"{name}: a latent array is missing")
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
    if b * m >= 2**31:
        raise ValueError(f"{name}: {b} x {m} elements exceed the kernel's int32 indexing")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


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


def fused_half_step(coef_x, coef_y, noise_mult, x, v, c, mask, *, seed=None, launch: int = 0,
                    normals=None):
    """Pre-model phase of a think step on (B, M) fp32 tensors.

    A CPU tensor takes `fused_half_step_ref` with `normals` = (ey, ev, vs).
    A CUDA tensor launches the Triton kernel, which draws its normals from
    Philox keyed by `seed` (one-element int64 tensor on the card) plus
    `launch`, or raises.  Each launch adds one to `fused_half_step.launches`.
    Returns (x_half, v_half, x_half_overdamped)."""
    if _route("fused_half_step", x, normals) == "cpu":
        return fused_half_step_ref(coef_x, coef_y, noise_mult, x, v, c, mask, *normals)
    _check_cuda("fused_half_step", seed, coef_x, coef_y, (x, v, c, mask))
    b, m = x.shape
    xh, vh, xh_o = (torch.empty_like(x) for _ in range(3))
    half, _ = _build()
    half[(_cdiv(m, BLOCK), b)](
        seed, int(launch), coef_x, coef_y, x, v, c, mask, xh, vh, xh_o, m, float(noise_mult),
        BLOCK=BLOCK, num_warps=4)
    fused_half_step.launches += 1
    return xh, vh, xh_o


def fused_finish(coef_x, coef_y, noise_mult, warm: bool, x_in, x_half, v_half, x_half_od,
                 c_old, c_new, mask, *, seed=None, launch: int = 0, normals=None):
    """Post-model phase of a think step on (B, M) fp32 tensors; `warm` is
    a host bool (a compile-time flag of the kernel).  When cold, x_half,
    v_half, x_half_od and c_old are not read and may be None.

    A CPU tensor takes `fused_finish_ref` with `normals` = (ey2, ev2, vs);
    a CUDA tensor launches the Triton kernel (normals from Philox, as in
    `fused_half_step`) or raises.  Each launch adds one to
    `fused_finish.launches`.  Returns (x, v)."""
    if _route("fused_finish", x_in, normals) == "cpu":
        return fused_finish_ref(coef_x, coef_y, noise_mult, warm, x_in, x_half, v_half,
                                x_half_od, c_old, c_new, mask, *normals)
    arrays = (x_in, x_half, v_half, x_half_od, c_old, c_new, mask) if warm \
        else (x_in, c_new, mask)
    _check_cuda("fused_finish", seed, coef_x, coef_y, arrays)
    if not warm:  # the cold variant reads none of these
        x_half = v_half = x_half_od = c_old = x_in
    b, m = x_in.shape
    x_out, v_out = torch.empty_like(x_in), torch.empty_like(x_in)
    _, finish = _build()
    finish[(_cdiv(m, BLOCK), b)](
        seed, int(launch), coef_x, coef_y, x_in, x_half, v_half, x_half_od, c_old, c_new, mask,
        x_out, v_out, m, float(noise_mult), WARM=bool(warm), BLOCK=BLOCK, num_warps=4)
    fused_finish.launches += 1
    return x_out, v_out


fused_half_step.launches = 0
fused_finish.launches = 0
