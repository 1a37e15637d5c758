#!/usr/bin/env python3
"""Drive lanpaint_tpu_torch's main paths once on one CUDA card, and check them.

    python3 chip_smoke.py          # from the root of the repository

Two main paths, each with random bf16 weights made on the card from a seed,
the euler solver, 20 steps, 5 think steps, outer early stop 1 and a
centre-square mask:

* SDXL-1024: karras, CFG 5 as two sequential passes, the unfused think
  step: (20 - 1) * 6 + 1 = 115 CFG pairs, 230 UNet forwards;
* Flux-dev-1024 (the reference's Flux_Inpaint workflow): "simple", cfg 1
  (cfg_big forced to 1), `use_fused_kernels=True`: 115 MMDiT forwards, 76
  fused half-step and 95 fused finish launches.

Phases, one line of output each or more (any failure raises and the script
exits non-zero without printing a result):

1. device: nvidia-smi's name and power limit, torch and CUDA versions, the
   TF32 flags in force;
2. build: nvcc builds the attention library from csrc/ while Triton
   compiles the row norm and the fused think-step kernels; seconds for each;
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   card at the main paths' shapes (plus ragged shapes), with each kernel's
   time and the plain version's: per launch including the host's launch
   work (CUDA events, median of 20) and on the device (`device_us`);
   for the fused kernels also a non-finite coefficient case, the noise
   statistics at noise_mult=1, and the non-model time of a think step,
   fused against plain, at the SDXL and Flux latent sizes;
4. small UNet reference and 5. small DiT reference: a small model whose
   attention and norms go through the kernels, on the card in bf16 against
   the same weights in fp32 on the CPU, beside the CPU's own bf16 plain
   path: one forward, and a 4-step LanPaint run with a shared think-noise
   feed;
6. SDXL main path and 7. Flux main path: build, then LanPaintSampler twice
   (for Flux the first run is a 2-step warm-up); the second run is timed
   and its kernel launches counted: the output is finite, the known region
   equals the latent, the repainted region moved, and every kernel ran
   exactly its expected number of times.

Then, on lines of their own: the nvidia-smi line, one JSON line with the
per-kernel numbers, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
In the kernels line, `launches` is the two timed runs' count, and `ms` /
`plain_ms` are the kernel's / plain version's per-launch times at each
main-path shape times that shape's launches in the two timed runs, summed
(each shape alone in `per_shape`, with its device time in us).

It needs one CUDA card, the CUDA toolkit (nvcc) and triton; no network.
"""

import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from lanpaint_tpu_torch import LanPaintConfig, LanPaintSampler, ModelKind
from lanpaint_tpu_torch.engine import lanpaint_update
from lanpaint_tpu_torch.models import dit, unet, zoo
from lanpaint_tpu_torch.ops import attention, fused, norms
from lanpaint_tpu_torch.schedule import unify_times
from lanpaint_tpu_torch.sigmas import calculate_sigmas

STEPS, THINK, EARLY_STOP = 20, 5, 1
PAIRS = (STEPS - EARLY_STOP) * (THINK + 1) + EARLY_STOP     # 115
FORWARDS = {"sdxl": 2 * PAIRS, "flux": PAIRS}               # CFG 5 sequential / cfg 1
PER_FORWARD = {  # kernel launches per model forward
    "sdxl": {"flash_attention": 70, "layernorm": 210, "rmsnorm": 0},
    # 19 double + 38 single blocks; adaLN norms 4 + 1 per block + 1 final;
    # QKNorm 4 per double block, 2 per single block
    "flux": {"flash_attention": 57, "layernorm": 115, "rmsnorm": 152},
}
PER_RUN = {  # fused launches per run: half on warm iterations, finish on every one
    "sdxl": {"fused_half_step": 0, "fused_finish": 0},
    "flux": {"fused_half_step": (STEPS - EARLY_STOP) * (THINK - 1),
             "fused_finish": (STEPS - EARLY_STOP) * THINK},
}
SPLASH = "lanpaint_tpu/models/layers.py:131 (_splash_kernel)"
# (shape, calls per forward by path, TPU kernel it replaces)
ATTN_SHAPES = [
    ((1, 4096, 10, 64), {"sdxl": 10}, SPLASH),
    ((1, 1024, 20, 64), {"sdxl": 60}, "lanpaint_tpu/models/layers.py:238 (flash_attention)"),
    ((1, 4608, 24, 128), {"flux": 57}, SPLASH),
    ((2, 1000, 4, 64), {}, None),
]
# (shape, mode, calls per forward by path); rmsnorm inputs are the strided
# q/k views of a fused projection, as the DiT hands them over
NORM_SHAPES = [
    ((1, 4096, 640), "layernorm", {"sdxl": 30}),
    ((1, 1024, 1280), "layernorm", {"sdxl": 180}),
    ((1, 4096, 3072), "layernorm_na", {"flux": 39}),
    ((1, 512, 3072), "layernorm_na", {"flux": 38}),
    ((1, 4608, 3072), "layernorm_na", {"flux": 38}),
    ((1, 4096, 24, 128), "rmsnorm", {"flux": 38}),
    ((1, 512, 24, 128), "rmsnorm", {"flux": 38}),
    ((1, 4608, 24, 128), "rmsnorm", {"flux": 76}),
]
FUSED_SHAPES = [(1, 4 * 128 * 128), (1, 16 * 128 * 128), (2, 1000)]  # SDXL, Flux, ragged
ATTN_TOL = dict(max_abs=2e-2, rel_l2=1e-2)
NORM_TOL = dict(atol=2e-2, rtol=1e-2)
FUSED_TOL = dict(rtol=1e-5, atol=1e-6)  # tests/test_fused.py's


def say(line: str) -> None:
    print(line, flush=True)


def median_ms(fn, n: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_us(fn, n: int = 10) -> float:
    """Device time per call, in us: CUDA events around n back-to-back calls
    that the host queues while the card runs a ~55 ms sleep kernel, so the
    host's launch work overlaps the sleep and not the timed calls (kernel
    time plus the gaps between the call's kernels).  If the host could not
    queue them all within the sleep (the launch queue holds ~1,000
    kernels, and a plain version launches ~50-100 a call), n is halved."""
    fn()
    torch.cuda.synchronize()
    while True:
        before, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        before.record()
        torch.cuda._sleep(100_000_000)
        start.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        end.record()
        host_ms = 1e3 * (time.perf_counter() - t0)
        end.synchronize()
        if host_ms < 0.8 * before.elapsed_time(start):  # queued within the sleep
            return 1e3 * start.elapsed_time(end) / n
        if n == 1:
            raise AssertionError("the host could not queue one call within the sleep")
        n //= 2


def rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


def timed_row(kernel, plain, err, calls, **extra):
    return dict(err=err, calls=calls, ms=median_ms(kernel), plain_ms=median_ms(plain),
                us=device_us(kernel), plain_us=device_us(plain), **extra)


def row_text(r) -> str:
    return (f"kernel {r['ms']:.4f} ms ({r['us']:.1f} us device) plain {r['plain_ms']:.4f} ms "
            f"({r['plain_us']:.1f} us device)")


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    say(f"phase 1 device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | tf32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn {torch.backends.cudnn.allow_tf32}")
    return smi


def _compile_triton():
    """One launch of each Triton program the main paths use (each row width
    and mode of the row norm, each fused kernel variant)."""
    t0 = time.perf_counter()
    for shape, mode, _ in NORM_SHAPES:
        x = torch.randn(shape, device="cuda", dtype=torch.bfloat16)
        g = torch.ones(shape[-1], device="cuda")
        if mode == "rmsnorm":
            norms.rmsnorm(x, g)
        else:
            norms.layernorm(x, None if mode == "layernorm_na" else g,
                            None if mode == "layernorm_na" else g, eps=1e-6,
                            out_dtype=torch.float32 if mode == "layernorm_na" else None)
    z = torch.zeros((1, 1024), device="cuda")
    tab = torch.zeros((1, 2 * fused.N_COEF), device="cuda")
    seed = torch.zeros((1,), dtype=torch.int64, device="cuda")
    fused.fused_half_step(tab, tab, 1.0, z, z, z, z, seed=seed)
    for warm in (True, False):
        fused.fused_finish(tab, tab, 1.0, warm, z, z, z, z, z, z, z, seed=seed)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_build() -> None:
    """nvcc (a subprocess) and Triton's compiles run side by side."""
    def nvcc():
        t0 = time.perf_counter()
        lib = attention.build_library()
        return lib, time.perf_counter() - t0

    with ThreadPoolExecutor(1) as pool:
        nvcc_job = pool.submit(nvcc)
        t_triton = _compile_triton()
        lib, t_nvcc = nvcc_job.result()
    attention._library()
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    say(f"phase 2 build: nvcc {t_nvcc:.1f} s ({lib.name}); triton {t_triton:.1f} s "
        f"(row norm x{len(NORM_SHAPES)} shapes, fused half + finish warm/cold), in parallel; "
        f"ptxas: {' / '.join(ptxas)}")


def _qkv_views(b, s, h, d, gen):
    """q, k, v as the main paths hand them over: strided views of one fused
    projection (B, S, 3 * H * D)."""
    qkv = torch.randn((b, s, 3 * h * d), device="cuda", generator=gen).to(torch.bfloat16)
    return [t.unflatten(-1, (h, d)) for t in qkv.chunk(3, dim=-1)]


def _kernel_attention(gen) -> list:
    rows = []
    for shape, calls, replaces in ATTN_SHAPES:
        b, s, h, d = shape
        q, k, v = _qkv_views(b, s, h, d, gen)
        if s == 1000:
            q, k, v = (t.contiguous() for t in (q, k, v))
        out = attention.flash_attention(q, k, v)
        torch.cuda.synchronize()
        want = attention.attention_ref(q.float(), k.float(), v.float())
        err = float((out.float() - want).abs().max())
        rel = rel_l2(out.float(), want)
        ok = err <= ATTN_TOL["max_abs"] and rel <= ATTN_TOL["rel_l2"]
        if not ok:
            raise AssertionError(f"attention {shape} disagrees with attention_ref: "
                                 f"max abs {err}, rel L2 {rel}, limits {ATTN_TOL}")
        r = timed_row(lambda: attention.flash_attention(q, k, v),
                      lambda: attention.attention_ref(q, k, v), err, calls, shape=shape,
                      replaces=replaces)
        say(f"phase 3 kernels: attention {shape} max_abs_err {err:.3g} rel_l2 {rel:.3g} "
            f"{row_text(r)} ok")
        rows.append(r)
    return rows


def _kernel_norms(gen) -> list:
    rows = []
    for shape, mode, calls in NORM_SHAPES:
        c = shape[-1]
        if mode == "rmsnorm":  # a strided q view, as QKNorm gets it
            x = _qkv_views(*shape, gen)[0]
            g = (1.0 + 0.1 * torch.randn(c, device="cuda", generator=gen)).to(torch.bfloat16)
            kernel, plain = (lambda: norms.rmsnorm(x, g)), (lambda: norms.rmsnorm_ref(x, g))
        else:
            x = (torch.randn(shape, device="cuda", generator=gen) * 2.0 + 0.5).to(torch.bfloat16)
            g = beta = None
            out_dtype = torch.float32
            if mode == "layernorm":
                g = 1.0 + 0.1 * torch.randn(c, device="cuda", generator=gen)
                beta = 0.1 * torch.randn(c, device="cuda", generator=gen)
                out_dtype = None
            kw = dict(eps=1e-6, out_dtype=out_dtype)
            kernel = lambda: norms.layernorm(x, g, beta, **kw)  # noqa: E731
            plain = lambda: norms.layernorm_ref(x, g, beta, **kw)  # noqa: E731
        out = kernel()
        torch.cuda.synchronize()
        want = plain()
        err = float((out.float() - want.float()).abs().max())
        ok = out.dtype == want.dtype and torch.allclose(out.float(), want.float(), **NORM_TOL)
        if not ok:
            raise AssertionError(f"{mode} {shape} disagrees with its plain version: {err}")
        r = timed_row(kernel, plain, err, calls, shape=shape, mode=mode)
        say(f"phase 3 kernels: {mode} {shape} {out.dtype} max_abs_err {err:.3g} {row_text(r)} ok")
        rows.append(r)
    return rows


def _fused_case(b, m, gen, sigma=0.6):
    tx, ty = (t.cuda() for t in fused.pack_branch_coeffs(
        LanPaintConfig(), unify_times(torch.full((b,), sigma), ModelKind.FLOW)))
    rnd = lambda scale=1.0: torch.randn((b, m), device="cuda", generator=gen) * scale  # noqa: E731
    x, v, c, c_new = rnd(), rnd(0.1), rnd(), rnd()
    mask = (torch.rand((b, m), device="cuda", generator=gen) > 0.5).float()
    return tx, ty, x, v, c, c_new, mask


def _fused_phases(tx, ty, nm, x, v, c, c_new, mask, seed):
    """(name, kernel outputs, plain outputs) of the three launches; the
    finishes take the kernel half step's outputs on both sides."""
    zeros = (torch.zeros_like(x),) * 3
    half = fused.fused_half_step(tx, ty, nm, x, v, c, mask, seed=seed, launch=0)
    half_ref = fused.fused_half_step_ref(tx, ty, nm, x, v, c, mask, *zeros)
    out = [("half", half, half_ref)]
    for warm in (True, False):
        got = fused.fused_finish(tx, ty, nm, warm, x, *half, c, c_new, mask, seed=seed, launch=1)
        want = fused.fused_finish_ref(tx, ty, nm, warm, x, *half, c, c_new, mask, *zeros)
        out.append(("warm finish" if warm else "cold finish", got, want))
    torch.cuda.synchronize()
    return out


def _kernel_fused(gen) -> tuple:
    seed = torch.randint(0, 2**31 - 1, (1,), generator=gen, device="cuda")
    half_rows, finish_rows = [], []
    # (a) noise_mult = 0 against the plain versions, with times
    for b, m in FUSED_SHAPES:
        tx, ty, x, v, c, c_new, mask = _fused_case(b, m, gen)
        errs = {}
        for name, got, want in _fused_phases(tx, ty, 0.0, x, v, c, c_new, mask, seed):
            errs[name] = err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            if not all(torch.allclose(g, w, **FUSED_TOL) for g, w in zip(got, want)):
                raise AssertionError(f"fused {name} ({b}, {m}) disagrees with its plain "
                                     f"version: max abs {err}, limits {FUSED_TOL}")
            say(f"phase 3 kernels: fused {name} ({b}, {m}) noise_mult 0 max_abs_err {err:.3g} ok")
        if b != 1:
            continue
        # times: each plain version draws its three normals as the kernel does
        normals = lambda: torch.randn((3, b, m), device="cuda").unbind(0)  # noqa: E731
        xh, vh, xho = fused.fused_half_step(tx, ty, 1.0, x, v, c, mask, seed=seed)
        cases = [  # (name, rows, kernel, plain, its noise_mult=0 error above)
            ("fused_half_step", half_rows,
             lambda: fused.fused_half_step(tx, ty, 1.0, x, v, c, mask, seed=seed),
             lambda: fused.fused_half_step_ref(tx, ty, 1.0, x, v, c, mask, *normals()),
             errs["half"]),
            ("fused_finish warm", finish_rows,
             lambda: fused.fused_finish(tx, ty, 1.0, True, x, xh, vh, xho, c, c_new, mask,
                                        seed=seed),
             lambda: fused.fused_finish_ref(tx, ty, 1.0, True, x, xh, vh, xho, c, c_new, mask,
                                            *normals()),
             errs["warm finish"]),
            ("fused_finish cold", finish_rows,
             lambda: fused.fused_finish(tx, ty, 1.0, False, x, None, None, None, None, c_new,
                                        mask, seed=seed),
             lambda: fused.fused_finish_ref(tx, ty, 1.0, False, x, None, None, None, None,
                                            c_new, mask, *normals()),
             errs["cold finish"]),
        ]
        # this shape's launches in a timed run: only the Flux path fuses, with
        # one cold finish per think loop and the rest warm
        path = "flux" if m == 16 * 128 * 128 else "sdxl"
        loops = STEPS - EARLY_STOP if path == "flux" else 0
        per_run = {"fused_half_step": loops * (THINK - 1),
                   "fused_finish warm": loops * (THINK - 1), "fused_finish cold": loops}
        for name, rows, kernel, plain, err in cases:
            r = timed_row(kernel, plain, err, {path: per_run[name]}, shape=(b, m), mode=name)
            say(f"phase 3 kernels: {name} ({b}, {m}) {row_text(r)} (plain draws its normals)")
            rows.append(r)

    # (b) a non-finite damped coefficient: the kernels select the OU branch
    tx, ty, x, v, c, c_new, mask = _fused_case(2, 1000, gen)
    tx[:, 0] = tx[:, fused.N_COEF] = math.inf
    for name, got, want in _fused_phases(tx, ty, 0.0, x, v, c, c_new, mask, seed):
        ok = all(torch.isfinite(g).all() and torch.allclose(g, w, **FUSED_TOL)
                 for g, w in zip(got, want))
        if name == "half":
            ok = ok and torch.equal(want[0], want[2])  # x_half is the overdamped step
        if not ok:
            raise AssertionError(f"fused {name}: the non-finite select disagrees")
    say("phase 3 kernels: fused half / warm / cold finish with a non-finite damped "
        "coefficient select the overdamped step like the plain versions ok")

    # (c) noise statistics at noise_mult = 1 from a zero state (x branch)
    b, m = 2, 1 << 19
    tx, ty, *_ = _fused_case(b, 8, gen, sigma=0.5)
    z = torch.zeros((b, m), device="cuda")
    xh, vh, _ = fused.fused_half_step(tx, ty, 1.0, z, z, z, z, seed=seed, launch=0)
    xf, _ = fused.fused_finish(tx, ty, 1.0, True, z, z, z, z, z, z, z, seed=seed, launch=1)
    l_yy, l_vy, l_vv = (float(tx[0, j]) for j in (4, 5, 6))
    n = b * m
    sd_v = math.hypot(l_vy, l_vv)

    def corr(p, q):
        return float(torch.corrcoef(torch.stack([p.flatten(), q.flatten()]))[0, 1])

    stats = dict(mean_x=float(xh.mean()), std_x=float(xh.std()), std_v=float(vh.std()),
                 corr_xv=corr(xh, vh), corr_launches=corr(xh, xf), corr_rows=corr(xh[0], xh[1]))
    ok = (abs(stats["mean_x"]) <= 4 * l_yy / math.sqrt(n)
          and abs(stats["std_x"] / l_yy - 1) <= 0.02 and abs(stats["std_v"] / sd_v - 1) <= 0.02
          and abs(stats["corr_xv"] - l_vy / sd_v) <= 0.01
          and abs(stats["corr_launches"]) < 0.01 and abs(stats["corr_rows"]) < 0.01)
    say(f"phase 3 kernels: fused noise statistics over {n} elements: "
        + " ".join(f"{k} {v:.5g}" for k, v in stats.items())
        + f" | want std_x {l_yy:.5g} std_v {sd_v:.5g} corr_xv {l_vy / sd_v:.5g} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the fused kernels' noise statistics are off")

    # the non-model time of a think step, fused against plain
    for shape, kind in (((1, 4, 128, 128), ModelKind.EPS), ((1, 16, 128, 128), ModelKind.FLOW)):
        lat = torch.randn(shape, device="cuda", generator=gen)
        mask4 = torch.zeros(shape, device="cuda")
        mask4[..., :, :64] = 1.0
        x0 = torch.randn(shape, device="cuda", generator=gen)
        times = unify_times(torch.tensor([0.6 if kind is ModelKind.FLOW else 2.0]), kind)
        ms = {}
        for label in ("plain", "fused", "fused", "plain"):
            cfg = LanPaintConfig(n_steps=THINK, use_fused_kernels=label == "fused")
            g = torch.Generator(device="cuda").manual_seed(1)
            run = lambda: lanpaint_update(  # noqa: E731
                lambda xm, t: (x0, x0), lat, latent_image=lat, noise=lat, latent_mask=mask4,
                times=times, n_steps=THINK, config=cfg, kind=kind, generator=g)
            ms.setdefault(label, []).append(median_ms(run, n=10, warmup=2) / THINK)
        say(f"phase 3 kernels: think-step non-model time per iteration at {shape} "
            f"(a constant denoiser, {THINK} think steps, in turns plain/fused/fused/plain): "
            f"plain {' '.join(f'{t:.4f}' for t in ms['plain'])} ms, fused "
            f"{' '.join(f'{t:.4f}' for t in ms['fused'])} ms")
    return half_rows, finish_rows


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    attn_rows = _kernel_attention(gen)
    norm_rows = _kernel_norms(gen)
    half_rows, finish_rows = _kernel_fused(gen)
    return {"flash_attention": attn_rows, "row_norm": norm_rows,
            "fused_half_step": half_rows, "fused_finish": finish_rows}


def _three_ways(build, cfg, seed):
    """One set of weights: (fp32 on the CPU, bf16 on the CPU, bf16 on the card)."""
    ref_den, ref_mod = build(dataclasses.replace(cfg, dtype=torch.float32), seed=seed,
                             name="small")
    state = ref_mod.state_dict()
    plain = build(cfg, state, name="small")
    card = build(cfg, state, device="cuda", name="small")
    return [(ref_den, ref_mod, "cpu"), (*plain, "cpu"), (*card, "cuda")]


def _small_reference(label, models, forward, sampler_kw, latent_shape, cond, sigmas):
    """The card's relative L2 error against the fp32 CPU reference must be
    no more than twice the plain bf16 path's, plus 1e-3, for one forward
    and for a 4-step LanPaint run with a shared think-noise feed."""
    before = {k: f.launches for k, f in (("attention", attention.flash_attention),
                                         ("layernorm", norms.layernorm),
                                         ("rmsnorm", norms.rmsnorm))}
    with torch.no_grad():
        fwd = [forward(mod, dev).cpu() for _, mod, dev in models]
    ran = {k: f.launches - before[k] for k, f in (("attention", attention.flash_attention),
                                                  ("layernorm", norms.layernorm),
                                                  ("rmsnorm", norms.rmsnorm))}
    gen = torch.Generator().manual_seed(5)
    latent = torch.randn(latent_shape, generator=gen)
    noise = torch.randn(latent_shape, generator=gen)
    px = latent_shape[-1] * 8
    mask = torch.zeros((px, px))
    mask[px // 4:3 * px // 4, px // 4:3 * px // 4] = 1.0
    feed = torch.randn((len(sigmas) - 1, 2, 5) + tuple(latent_shape), generator=gen)
    q = latent_shape[-1] // 4
    runs = []
    for den, _, dev in models:
        sam = LanPaintSampler(den, config=LanPaintConfig(n_steps=2), **sampler_kw)
        on_dev = [None if c is None else {k: v.to(dev) for k, v in c.items()} for c in cond]
        samples, _ = sam(latent=latent.to(dev), sigmas=sigmas, cond=on_dev[0],
                         uncond=on_dev[1], mask=mask.to(dev), noise=noise.to(dev),
                         noise_feed=feed.to(dev))
        runs.append(samples.cpu()[..., q:3 * q, q:3 * q])  # the repainted square
    (fwd_plain, fwd_card), (run_plain, run_card) = (
        [rel_l2(out, outs[0]) for out in outs[1:]] for outs in (fwd, runs))
    ok = (fwd_card <= 2 * fwd_plain + 1e-3 and run_card <= 2 * run_plain + 1e-3
          and bool(torch.isfinite(runs[2]).all()))
    say(f"{label}: rel_l2 against fp32 on the CPU (limit 2x the plain bf16 path's + 1e-3): "
        f"forward card {fwd_card:.3g} plain {fwd_plain:.3g}; 4-step LanPaint run card "
        f"{run_card:.3g} plain {run_plain:.3g}; card-forward launches {ran} "
        f"{'ok' if ok else 'FAIL'}")
    return ok, ran


SMALL_UNET = unet.UNetConfig(model_channels=64, channel_mult=(1, 2), num_res_blocks=1,
                             transformer_depth=(1, 1), transformer_depth_middle=1,
                             context_dim=64, head_dim=64)
SMALL_DIT = dataclasses.replace(dit.FLUX_DEV_CONFIG, hidden=256, num_heads=2, depth_double=2,
                                depth_single=2, context_dim=64, vec_dim=32)


def phase_small_unet() -> None:
    """bf16 rounding alone puts the plain path ~2e-2 from the reference
    (the CPU tests measure the same on the tiny UNet), and CFG 5 amplifies
    it in the run, so the limit follows the plain path."""
    models = _three_ways(zoo.build_unet, SMALL_UNET, seed=3)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((1, 4, 32, 32), generator=gen)
    t = torch.tensor([420.0])
    ctx = torch.randn((1, 12, 64), generator=gen)
    cond = ({"context": torch.randn((1, 12, 64), generator=gen)},
            {"context": torch.randn((1, 12, 64), generator=gen)})
    ok, ran = _small_reference(
        "phase 4 small UNet reference", models,
        lambda mod, dev: mod(x.to(dev), t.to(dev), ctx.to(dev)),
        dict(cfg=5.0, sequential_cfg=True), (1, 4, 32, 32), cond,
        calculate_sigmas(models[0][0].sigma_table, "karras", 4))
    if not (ok and ran["attention"] and ran["layernorm"]):
        raise AssertionError("the small UNet on the card is less accurate than the plain path "
                             "or did not go through the kernels")


def phase_small_dit() -> None:
    """A small MMDiT at head dim 128 (hidden 256, 2 heads, 2 + 2 blocks) on
    a 64x64 latent: 1,024 image and 16 text tokens, so its joint attention
    takes the kernel; cfg 1 as the Flux path."""
    models = _three_ways(zoo.build_dit, SMALL_DIT, seed=3)
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((1, 16, 64, 64), generator=gen)
    t = torch.tensor([0.7])
    cond = {"context": torch.randn((1, 16, 64), generator=gen),
            "vec": torch.randn((1, 32), generator=gen), "guidance": torch.tensor([3.5])}
    ok, ran = _small_reference(
        "phase 5 small DiT reference", models,
        lambda mod, dev: mod(x.to(dev), t.to(dev), cond["context"].to(dev),
                             cond["vec"].to(dev), cond["guidance"].to(dev)),
        dict(cfg=1.0), (1, 16, 64, 64), (cond, None),
        calculate_sigmas(models[0][0].sigma_table, "simple", 4))
    if not (ok and ran["attention"] and ran["layernorm"] and ran["rmsnorm"]):
        raise AssertionError("the small DiT on the card is less accurate than the plain path "
                             "or did not go through the kernels")


COUNTERS = {"flash_attention": attention.flash_attention, "layernorm": norms.layernorm,
            "rmsnorm": norms.rmsnorm, "fused_half_step": fused.fused_half_step,
            "fused_finish": fused.fused_finish}


def _main_path(label, path, smi, den, module, t_init, run, warmup, latent) -> dict:
    n_params = sum(p.numel() for p in module.parameters())
    t0 = time.perf_counter()
    warmup()
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0

    for f in COUNTERS.values():
        f.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    samples, den_hist = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in COUNTERS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    side = latent.shape[-1]
    known = torch.ones((side, side), dtype=torch.bool, device="cuda")
    known[side // 4:3 * side // 4, side // 4:3 * side // 4] = False
    finite = bool(torch.isfinite(samples).all()) and bool(torch.isfinite(den_hist).all())
    known_err = float((samples - latent)[..., known].abs().max())
    moved = float((samples - latent)[..., ~known].abs().mean())
    fwd = FORWARDS[path]
    want = {**{k: n * fwd for k, n in PER_FORWARD[path].items()}, **PER_RUN[path]}
    ok = (finite and samples.shape == latent.shape and known_err <= 1e-3 and moved > 1e-2
          and launches == want)
    say(f"{label}: {n_params / 1e9:.3f} B params bf16 (init {t_init:.1f} s), {fwd} forwards | "
        f"first run {t_first:.2f} s, timed run {wall:.3f} s = {1e3 * wall / fwd:.2f} ms per "
        f"forward, peak {peak_gb:.1f} GB on {smi} | finite {finite} known-region max err "
        f"{known_err:.3g} repainted mean change {moved:.3g} | launches {launches} "
        f"(want {want}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} check failed")
    return launches


def _mask_1024():
    mask = torch.zeros((1024, 1024), device="cuda")
    mask[256:768, 256:768] = 1.0
    return mask


def phase_sdxl(smi: str) -> dict:
    t0 = time.perf_counter()
    den, module = zoo.build_sdxl(device="cuda", param_dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(0)
    latent = torch.randn((1, 4, 128, 128), device="cuda", generator=gen)
    cond, uncond = ({"context": torch.randn((1, 77, 2048), device="cuda", generator=gen),
                     "y": torch.randn((1, 2816), device="cuda", generator=gen)} for _ in range(2))
    sigmas = calculate_sigmas(den.sigma_table, "karras", STEPS)
    sam = LanPaintSampler(den, config=LanPaintConfig(n_steps=THINK, outer_early_stop=EARLY_STOP),
                          sampler_name="euler", cfg=5.0, sequential_cfg=True)
    run = lambda: sam(latent=latent, sigmas=sigmas, cond=cond, uncond=uncond,  # noqa: E731
                      mask=_mask_1024(), seed=0)
    return _main_path(f"phase 6 SDXL main path: euler karras {STEPS} x think {THINK}, cfg 5 "
                      "sequential", "sdxl", smi, den, module, t_init, run, run, latent)


def phase_flux(smi: str) -> dict:
    t0 = time.perf_counter()
    den, module = zoo.build_flux_dev(device="cuda", param_dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(0)
    latent = torch.randn((1, 16, 128, 128), device="cuda", generator=gen)
    cond = {"context": torch.randn((1, 512, 4096), device="cuda", generator=gen),
            "vec": torch.randn((1, 768), device="cuda", generator=gen),
            "guidance": torch.tensor([3.5], device="cuda")}
    sam = LanPaintSampler(den, config=LanPaintConfig(n_steps=THINK, outer_early_stop=EARLY_STOP,
                                                     use_fused_kernels=True),
                          sampler_name="euler", cfg=1.0)
    if sam.cfg_big != 1.0:
        raise AssertionError("Flux must force cfg_big to 1")

    def run(steps=STEPS):
        return sam(latent=latent, sigmas=calculate_sigmas(den.sigma_table, "simple", steps),
                   cond=cond, mask=_mask_1024(), seed=0)

    return _main_path(f"phase 7 Flux main path: euler simple {STEPS} x think {THINK}, cfg 1, "
                      "fused think step (warm-up: 2 steps)", "flux", smi, den, module, t_init,
                      run, lambda: run(2), latent)


def kernels_line(rows: dict, launches: dict) -> list:
    """One entry per kernel: launches in the timed main-path runs, and the
    per-launch times at each main-path shape weighted by those runs'
    launches at that shape."""
    meta = {
        "flash_attention": ("cuda", "lanpaint_tpu_torch/csrc/attention.cu",
                            "lanpaint_tpu/models/layers.py:238; lanpaint_tpu/models/layers.py:131",
                            ("flash_attention",)),
        "row_norm": ("triton", "lanpaint_tpu_torch/ops/norms.py",
                     "lanpaint_tpu/ops/norms.py:93", ("layernorm", "rmsnorm")),
        "fused_half_step": ("triton", "lanpaint_tpu_torch/ops/fused.py",
                            "lanpaint_tpu/ops/fused.py:239", ("fused_half_step",)),
        "fused_finish": ("triton", "lanpaint_tpu_torch/ops/fused.py",
                         "lanpaint_tpu/ops/fused.py:259", ("fused_finish",)),
    }

    def run_launches(r):  # this shape's launches in the two timed runs
        per_fwd = r["calls"]
        if r.get("mode", "").startswith("fused"):
            return sum(per_fwd.values())
        return sum(n * FORWARDS[p] for p, n in per_fwd.items())

    out = []
    for name, (route, source, replaces, counters) in meta.items():
        rs = rows[name]
        out.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": sum(launches[p][c] for p in launches for c in counters),
            "launches_by_path": {p: sum(launches[p][c] for c in counters) for p in launches},
            "max_abs_err": max(r["err"] for r in rs),
            "ms": sum(r["ms"] * run_launches(r) for r in rs),
            "plain_ms": sum(r["plain_ms"] * run_launches(r) for r in rs),
            "per_shape": [{"shape": list(r["shape"]), "mode": r.get("mode"),
                           "launches_per_forward_or_run": r["calls"], "ms": r["ms"],
                           "plain_ms": r["plain_ms"], "device_us": r["us"],
                           "plain_device_us": r["plain_us"], "max_abs_err": r["err"]}
                          for r in rs],
        })
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    smi = phase_device()
    phase_build()
    rows = phase_kernels()
    phase_small_unet()
    phase_small_dit()
    launches = {"sdxl": phase_sdxl(smi)}
    gc.collect()
    torch.cuda.empty_cache()  # SDXL's weights go before Flux's 23.8 GB arrive
    launches["flux"] = phase_flux(smi)
    print(smi)
    print(json.dumps({"kernels": kernels_line(rows, launches)}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
