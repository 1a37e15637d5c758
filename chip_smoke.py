#!/usr/bin/env python3
"""Drive lanpaint_tpu_torch's main path once on one CUDA card, and check it.

    python3 chip_smoke.py          # from the root of the repository

The main path is SDXL-1024 LanPaint inpainting: random bf16 weights made on
the card from a seed, karras 20 steps, the euler solver, CFG 5 as two
sequential passes, 5 think steps, outer early stop 1, a centre-square
mask: (20 - 1) * 6 + 1 = 115 CFG pairs, 230 UNet forwards.

Phases, one line of output each (any failure raises and the script exits
non-zero without printing a result):

1. device: nvidia-smi's name and power limit, torch and CUDA versions, the
   TF32 flags in force;
2. build: nvcc builds the attention library from csrc/, Triton compiles the
   row-norm kernel at the main path's widths; seconds for each;
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   card at the main path's shapes (plus a ragged S and D=128 for
   attention, RMSNorm and fp32-out for the row norm), with each kernel's
   time and the plain version's (CUDA events, median of 20 launches);
4. small reference: a small UNet whose attention and norms go through the
   kernels, on the card in bf16 against the same weights in fp32 on the CPU,
   beside the CPU's own bf16 plain path: one forward, and a 4-step LanPaint
   run with a shared think-noise feed;
5. main path: build_sdxl, then LanPaintSampler twice; the second run is
   timed and its kernel launches counted: the output is finite, the known
   region equals the latent, the repainted region moved, and the
   attention and row-norm kernels ran exactly 70 and 210 times per forward.

Then, on lines of their own: the nvidia-smi line, one JSON line with the
per-kernel numbers, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
In the kernels line, `launches` is the timed run's count, and `ms` /
`plain_ms` are the kernel's / plain version's per-launch times at each
main-path shape times that shape's calls per SDXL forward, summed (each
shape alone in `per_shape`).  Per-launch times include the host's launch
work, as the eager main path pays it.

It needs one CUDA card, the CUDA toolkit (nvcc) and triton; no network.
"""

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import torch

from lanpaint_tpu_torch import LanPaintConfig, LanPaintSampler, ModelKind
from lanpaint_tpu_torch.engine import lanpaint_update
from lanpaint_tpu_torch.models import unet, zoo
from lanpaint_tpu_torch.ops import attention, norms
from lanpaint_tpu_torch.schedule import unify_times
from lanpaint_tpu_torch.sigmas import calculate_sigmas

STEPS, THINK, EARLY_STOP = 20, 5, 1
FORWARDS = 2 * ((STEPS - EARLY_STOP) * (THINK + 1) + EARLY_STOP)  # 230
SDXL_ATTN_PER_FWD = 70      # 10 at S=4096 H=10 + 60 at S=1024 H=20, D=64
SDXL_NORM_PER_FWD = 210     # three LayerNorms in each of the 70 blocks
# (shape, calls per SDXL forward, TPU kernel it replaces)
ATTN_SHAPES = [
    ((1, 4096, 10, 64), 10, "lanpaint_tpu/models/layers.py:131 (_splash_kernel)"),
    ((1, 1024, 20, 64), 60, "lanpaint_tpu/models/layers.py:238 (flash_attention)"),
    ((2, 1000, 4, 64), 0, None),
    ((1, 5400, 24, 128), 0, None),
]
NORM_SHAPES = [((1, 4096, 640), 30), ((1, 1024, 1280), 180)]
ATTN_TOL = dict(max_abs=2e-2, rel_l2=1e-2)
NORM_TOL = dict(atol=2e-2, rtol=1e-2)


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


def rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    say(f"phase 1 device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | tf32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn {torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = attention.build_library()
    attention._library()
    t_nvcc = time.perf_counter() - t0
    # Triton compiles one program per row width of the main path
    t0 = time.perf_counter()
    for shape, _ in NORM_SHAPES:
        x = torch.randn(shape, device="cuda", dtype=torch.bfloat16)
        norms.layernorm(x, torch.ones(shape[-1], device="cuda"),
                        torch.zeros(shape[-1], device="cuda"), eps=1e-6)
    torch.cuda.synchronize()
    t_triton = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    say(f"phase 2 build: nvcc {t_nvcc:.1f} s ({lib.name}); triton {t_triton:.1f} s; "
        f"ptxas: {' / '.join(ptxas)}")


def _qkv_views(b, s, h, d, gen):
    """q, k, v as the main path hands them over: strided views of one fused
    projection (B, S, 3 * H * D)."""
    qkv = torch.randn((b, s, 3 * h * d), device="cuda", generator=gen).to(torch.bfloat16)
    return [t.unflatten(-1, (h, d)) for t in qkv.chunk(3, dim=-1)]


def phase_kernels() -> tuple:
    gen = torch.Generator(device="cuda").manual_seed(0)
    attn_rows = []
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
        ms = median_ms(lambda: attention.flash_attention(q, k, v))
        plain_ms = median_ms(lambda: attention.attention_ref(q, k, v))
        ok = err <= ATTN_TOL["max_abs"] and rel <= ATTN_TOL["rel_l2"]
        say(f"phase 3 kernels: attention {shape} max_abs_err {err:.3g} rel_l2 {rel:.3g} "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"attention {shape} disagrees with attention_ref: "
                                 f"max abs {err}, rel L2 {rel}, limits {ATTN_TOL}")
        attn_rows.append(dict(shape=shape, calls=calls, replaces=replaces, err=err,
                              ms=ms, plain_ms=plain_ms))

    norm_rows = []
    for shape, calls in NORM_SHAPES:
        c = shape[-1]
        x = (torch.randn(shape, device="cuda", generator=gen) * 2.0 + 0.5).to(torch.bfloat16)
        g = 1.0 + 0.1 * torch.randn(c, device="cuda", generator=gen)
        beta = 0.1 * torch.randn(c, device="cuda", generator=gen)
        out = norms.layernorm(x, g, beta, eps=1e-6)
        torch.cuda.synchronize()
        want = norms.layernorm_ref(x, g, beta, eps=1e-6)
        err = float((out.float() - want.float()).abs().max())
        ok = out.dtype == torch.bfloat16 and torch.allclose(out.float(), want.float(),
                                                            **NORM_TOL)
        ms = median_ms(lambda: norms.layernorm(x, g, beta, eps=1e-6))
        plain_ms = median_ms(lambda: norms.layernorm_ref(x, g, beta, eps=1e-6))
        say(f"phase 3 kernels: layernorm {shape} bf16 affine eps 1e-6 max_abs_err {err:.3g} "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"layernorm {shape} disagrees with layernorm_ref: {err}")
        norm_rows.append(dict(shape=shape, calls=calls, err=err, ms=ms, plain_ms=plain_ms))

    # the other modes of the same kernel body
    x = torch.randn((1024, 1280), device="cuda", generator=gen).to(torch.bfloat16)
    g = 1.0 + 0.1 * torch.randn(1280, device="cuda", generator=gen)
    for label, got, want in (
            ("rmsnorm affine", norms.rmsnorm(x, g), norms.rmsnorm_ref(x, g)),
            ("layernorm fp32-out", norms.layernorm(x, eps=1e-6, out_dtype=torch.float32),
             norms.layernorm_ref(x, eps=1e-6, out_dtype=torch.float32))):
        err = float((got.float() - want.float()).abs().max())
        ok = got.dtype == want.dtype and torch.allclose(got.float(), want.float(), **NORM_TOL)
        say(f"phase 3 kernels: {label} (1024, 1280) max_abs_err {err:.3g} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label} disagrees with its plain version: {err}")

    # the fused think-step kernels are not ported: the flag must refuse a
    # CUDA latent rather than quietly take the plain path
    z = torch.zeros((1, 4, 8, 8), device="cuda")
    try:
        lanpaint_update(lambda xm, t: (xm, xm), z, latent_image=z, noise=z, latent_mask=z,
                        times=unify_times(torch.tensor([1.0]), ModelKind.EPS), n_steps=1,
                        config=LanPaintConfig(n_steps=1, use_fused_kernels=True),
                        kind=ModelKind.EPS)
    except NotImplementedError:
        say("phase 3 kernels: use_fused_kernels=True on CUDA raises NotImplementedError ok")
    else:
        raise AssertionError("use_fused_kernels=True ran on CUDA without its kernels")
    return attn_rows, norm_rows


SMALL_CONFIG = unet.UNetConfig(model_channels=64, channel_mult=(1, 2), num_res_blocks=1,
                               transformer_depth=(1, 1), transformer_depth_middle=1,
                               context_dim=64, head_dim=64)


def phase_small_reference() -> None:
    """One small UNet, one set of weights, three ways: fp32 on the CPU (the
    reference), bf16 on the CPU (the plain path), bf16 on the card (the
    kernels).  The card's relative L2 error against the reference must be
    no more than twice the plain bf16 path's own error, plus 1e-3, for one
    forward and for a 4-step LanPaint run.  bf16 rounding alone puts the
    plain path ~2e-2 from the reference (the CPU tests measure the same on
    the tiny UNet), and CFG 5 amplifies it in the run, so the limit follows
    the plain path rather than a fixed number."""
    fp32 = dataclasses.replace(SMALL_CONFIG, dtype=torch.float32)
    ref_den, ref_mod = zoo.build_unet(fp32, seed=3, name="small")
    state = ref_mod.state_dict()
    plain_den, plain_mod = zoo.build_unet(SMALL_CONFIG, state, name="small")
    card_den, card_mod = zoo.build_unet(SMALL_CONFIG, state, device="cuda", name="small")
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((1, 4, 32, 32), generator=gen)
    t = torch.tensor([420.0])
    ctx = torch.randn((1, 12, 64), generator=gen)
    attn0, norm0 = attention.flash_attention.launches, norms.layernorm.launches
    with torch.no_grad():
        fwd = [mod(x.to(dev), t.to(dev), ctx.to(dev)).cpu()
               for mod, dev in ((ref_mod, "cpu"), (plain_mod, "cpu"), (card_mod, "cuda"))]
    if not (attention.flash_attention.launches > attn0 and norms.layernorm.launches > norm0):
        raise AssertionError("the small UNet on the card did not go through the kernels")

    latent = torch.randn((1, 4, 32, 32), generator=gen)
    noise = torch.randn((1, 4, 32, 32), generator=gen)
    mask = torch.zeros((256, 256))
    mask[64:192, 64:192] = 1.0
    cond = {"context": torch.randn((1, 12, 64), generator=gen)}
    uncond = {"context": torch.randn((1, 12, 64), generator=gen)}
    sigmas = calculate_sigmas(ref_den.sigma_table, "karras", 4)
    feed = torch.randn((4, 2, 5, 1, 4, 32, 32), generator=gen)
    runs = []
    for den, dev in ((ref_den, "cpu"), (plain_den, "cpu"), (card_den, "cuda")):
        sam = LanPaintSampler(den, config=LanPaintConfig(n_steps=2), cfg=5.0,
                              sequential_cfg=True)
        to = lambda tree: {k: v.to(dev) for k, v in tree.items()}  # noqa: E731
        samples, _ = sam(latent=latent.to(dev), sigmas=sigmas, cond=to(cond),
                         uncond=to(uncond), mask=mask.to(dev), noise=noise.to(dev),
                         noise_feed=feed.to(dev))
        runs.append(samples.cpu()[..., 8:24, 8:24])  # the repainted square
    (fwd_plain, fwd_card), (run_plain, run_card) = (
        [rel_l2(out, outs[0]) for out in outs[1:]] for outs in (fwd, runs))
    ok = (fwd_card <= 2 * fwd_plain + 1e-3 and run_card <= 2 * run_plain + 1e-3
          and bool(torch.isfinite(runs[2]).all()))
    say(f"phase 4 small reference: rel_l2 against fp32 on the CPU (limit 2x the plain bf16 "
        f"path's + 1e-3): forward card {fwd_card:.3g} plain {fwd_plain:.3g}; 4-step LanPaint "
        f"run card {run_card:.3g} plain {run_plain:.3g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the small UNet on the card is less accurate than the plain path")


def phase_main_path(smi: str) -> dict:
    t0 = time.perf_counter()
    den, module = zoo.build_sdxl(device="cuda", param_dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in module.parameters())

    gen = torch.Generator(device="cuda").manual_seed(0)
    latent = torch.randn((1, 4, 128, 128), device="cuda", generator=gen)
    mask = torch.zeros((1024, 1024), device="cuda")
    mask[256:768, 256:768] = 1.0
    cond = {"context": torch.randn((1, 77, 2048), device="cuda", generator=gen),
            "y": torch.randn((1, 2816), device="cuda", generator=gen)}
    uncond = {"context": torch.randn((1, 77, 2048), device="cuda", generator=gen),
              "y": torch.randn((1, 2816), device="cuda", generator=gen)}
    sigmas = calculate_sigmas(den.sigma_table, "karras", STEPS)
    sam = LanPaintSampler(den, config=LanPaintConfig(n_steps=THINK, outer_early_stop=EARLY_STOP),
                          sampler_name="euler", cfg=5.0, sequential_cfg=True)

    def run():
        return sam(latent=latent, sigmas=sigmas, cond=cond, uncond=uncond, mask=mask, seed=0)

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0

    attention.flash_attention.launches = 0
    norms.layernorm.launches = 0
    norms.rmsnorm.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    samples, den_hist = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": attention.flash_attention.launches,
                "layernorm": norms.layernorm.launches, "rmsnorm": norms.rmsnorm.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    known = torch.ones((128, 128), dtype=torch.bool, device="cuda")
    known[32:96, 32:96] = False
    finite = bool(torch.isfinite(samples).all()) and bool(torch.isfinite(den_hist).all())
    known_err = float((samples - latent)[..., known].abs().max())
    moved = float((samples - latent)[..., ~known].abs().mean())
    want = {"flash_attention": SDXL_ATTN_PER_FWD * FORWARDS,
            "layernorm": SDXL_NORM_PER_FWD * FORWARDS, "rmsnorm": 0}
    ok = (finite and tuple(samples.shape) == (1, 4, 128, 128) and known_err <= 1e-3
          and moved > 1e-2 and launches == want)
    say(f"phase 5 main path: SDXL {n_params / 1e9:.3f} B params bf16 (init {t_init:.1f} s), "
        f"euler karras {STEPS} x think {THINK}, cfg 5 sequential, {FORWARDS} forwards | "
        f"first run {t_first:.2f} s, timed run {wall:.3f} s = {1e3 * wall / FORWARDS:.2f} ms "
        f"per forward, peak {peak_gb:.1f} GB on {smi} | finite {finite} known-region max err "
        f"{known_err:.3g} repainted mean change {moved:.3g} | launches {launches} "
        f"(want {want}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("main path check failed")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    smi = phase_device()
    phase_build()
    attn_rows, norm_rows = phase_kernels()
    phase_small_reference()
    launches = phase_main_path(smi)

    def entry(name, route, source, replaces, rows, count):
        per_fwd = [r for r in rows if r["calls"]]
        return {
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[count],
            "max_abs_err": max(r["err"] for r in rows),
            # kernel time per SDXL forward: each shape timed alone, times its calls
            "ms": sum(r["ms"] * r["calls"] for r in per_fwd),
            "plain_ms": sum(r["plain_ms"] * r["calls"] for r in per_fwd),
            "per_shape": [{"shape": list(r["shape"]), "calls_per_forward": r["calls"],
                           "ms": r["ms"], "plain_ms": r["plain_ms"], "max_abs_err": r["err"]}
                          for r in rows],
        }

    kernels = [
        entry("flash_attention", "cuda", "lanpaint_tpu_torch/csrc/attention.cu",
              "lanpaint_tpu/models/layers.py:238; lanpaint_tpu/models/layers.py:131",
              attn_rows, "flash_attention"),
        entry("row_norm", "triton", "lanpaint_tpu_torch/ops/norms.py",
              "lanpaint_tpu/ops/norms.py:93", norm_rows, "layernorm"),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
