#!/usr/bin/env python3
"""Drive lanpaint_tpu_torch's main paths once on one CUDA card, and check them.

    python3 chip_smoke.py          # from the root of the repository

Four main paths, each with random bf16 weights made on the card from a
seed, the euler solver, 20 steps, outer early stop 1 and a centre mask; 5
think steps but for the video path's 2:

* SDXL-1024: karras, CFG 5 as two sequential passes, the unfused think
  step: (20 - 1) * 6 + 1 = 115 CFG pairs, 230 UNet forwards;
* pixel-space SDXL-1024 (the reference's SDXL_Inpaint workflow through
  `api.inpaint_image`): the SDXL VAE encodes a random 1024^2 image, the
  SDXL path above repaints the latent, the VAE decodes it and MaskBlend
  (overlap 9) feathers it into the image: two wide-head attention launches
  (the VAE's mid attention, D = 512, S = 16,384) besides the SDXL path's;
* Flux-dev-1024 (the reference's Flux_Inpaint workflow): "simple", cfg 1
  (cfg_big forced to 1), `use_fused_kernels=True`: 115 MMDiT forwards, 76
  fused half-step and 95 fused finish launches;
* Wan2.2 TI2V-5B video (the reference's video workflows through
  `api.inpaint_video` with its defaults): "simple", 2 think steps, CFG 5 as
  two sequential passes, on a random (1, 3, 33, 704, 1280) video (TI2V-5B's
  published 704x1280 with 33 of its 121 frames) and the Wan2.2 VAE: a
  (1, 48, 9, 44, 80) latent, S = 7,920 tokens, (20 - 1) * 3 + 1 = 58 CFG
  pairs, 116 DiT forwards, and two wide-head attention launches (the VAE's
  mid attention, D = 640, over 9 frames of 3,520 tokens).

Phases, one line of output each or more (any failure raises and the script
exits non-zero without printing a result):

1. device: nvidia-smi's name and power limit, torch and CUDA versions, the
   TF32 flags in force;
2. build: one nvcc per CUDA source in csrc/ (the D <= 128 and the
   wide-head attention libraries) while Triton compiles the row norm and
   the fused think-step kernels; seconds for each, and ptxas's register
   and spill counts for each kernel instantiation (no wide-head
   instantiation, D = 384, 512 or 640, may spill);
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   card at the main paths' shapes (plus ragged shapes), with each kernel's
   time, the plain version's and, where one PyTorch call computes the same
   function (scaled_dot_product_attention, F.layer_norm, F.rms_norm), that
   call's, timed as a yardstick only: per launch including the host's
   launch work (CUDA events, median of 20) and on the device (`device_us`);
   beside them each call's bound, the larger of its bytes over 3.35 TB/s
   and its operations over the peak of their type (989 TFLOP/s bf16 on
   the tensor cores, 67 TFLOP/s fp32 elsewhere);
   for the fused kernels also a non-finite coefficient case, the noise
   statistics at noise_mult=1, and the non-model time of a think step,
   fused against plain, at the SDXL and Flux latent sizes;
4. small UNet reference and 5. small DiT reference: a small model whose
   attention and norms go through the kernels, on the card in bf16 against
   the same weights in fp32 on the CPU, beside the CPU's own bf16 plain
   path: one forward, and a 4-step LanPaint run with a shared think-noise
   feed;
6. SDXL main path and 8. Flux main path: build, then LanPaintSampler twice
   (for Flux the first run is a 2-step warm-up); the second run is timed
   and its kernel launches counted: the output is finite, the known region
   equals the latent, the repainted region moved, and every kernel ran
   exactly its expected number of times;
7. pixel path (phase 6's UNet, the SDXL VAE): the VAE's encode and decode
   timed alone, then one `api.inpaint_image` run, timed and counted: the
   output is finite and (1, 3, 1024, 1024), every pixel farther than the
   blend overlap from the mask equals the input bit for bit, the repainted
   region moved, and every kernel ran exactly its expected number of times
   (the wide-head attention twice);
9. Flux VAE: one encode-decode round trip of FLUX_VAE_CONFIG (16 latent
   channels, no quant convs) at 1024^2 through the wide-head kernel;
10. video path (Wan2.2 TI2V-5B and the Wan2.2 VAE): the VAE's encode and
   decode timed alone, one DiT forward under torch.profiler (kernel time
   against wall clock: the card's idle share), a 2-step warm-up call of
   `api.inpaint_video`, then one timed and counted call with its defaults:
   the output is finite and of the input's shape, every pixel of every
   frame farther than the blend overlap from the mask equals the input bit
   for bit, the repainted region moved, and every kernel ran exactly its
   expected number of times (the wide-head attention twice);
11. Wan2.1 VAE: one encode-decode round trip of WAN21_VAE_CONFIG at 480x832
   x 33 frames, whose mid attention runs the wide-head kernel at D = 384.

Then, on lines of their own: the nvidia-smi line, one JSON line with the
per-kernel numbers, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
In the kernels line, `launches` is the four timed runs' count, and `ms` /
`plain_ms` / `library_ms` / `bound_ms` are the kernel's / plain version's /
PyTorch call's per-launch times and the bound at each main-path shape times
that shape's launches in the four timed runs, summed (`library_ms` null
where a launched shape has no such call; each shape alone in `per_shape`,
with its device times in us).

To run some phases alone: python3 -c "import chip_smoke as c; smi =
c.phase_device(); c.phase_build(); c.phase_pixel(smi)".

It needs one CUDA card, the CUDA toolkit (nvcc) and triton; no network.
"""

import dataclasses
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from lanpaint_tpu_torch import (LanPaintConfig, LanPaintSampler, ModelKind, api, inpaint_image,
                                inpaint_video)
from lanpaint_tpu_torch.engine import lanpaint_update
from lanpaint_tpu_torch.models import dit, unet, vae, video_vae, wan, zoo
from lanpaint_tpu_torch.ops import attention, fused, norms
from lanpaint_tpu_torch.schedule import unify_times
from lanpaint_tpu_torch.sigmas import calculate_sigmas

STEPS, THINK, EARLY_STOP = 20, 5, 1
PAIRS = (STEPS - EARLY_STOP) * (THINK + 1) + EARLY_STOP     # 115
# the video path: inpaint_video's defaults (20 steps, 2 think steps)
VIDEO_THINK = 2
VIDEO_PAIRS = (STEPS - EARLY_STOP) * (VIDEO_THINK + 1) + EARLY_STOP  # 58
VIDEO_SHAPE = (1, 3, 33, 704, 1280)  # TI2V-5B's 704x1280, 33 of its 121 frames
WAN21_SHAPE = (1, 3, 33, 480, 832)   # the 14B pair's 480p with the Wan2.1 VAE
FORWARDS = {"sdxl": 2 * PAIRS, "pixel": 2 * PAIRS, "flux": PAIRS,  # CFG 5 seq. / cfg 1
            "video": 2 * VIDEO_PAIRS}                              # CFG 5 sequential
PER_FORWARD = {  # kernel launches per model forward
    "sdxl": {"flash_attention": 70, "layernorm": 210, "rmsnorm": 0},
    # 19 double + 38 single blocks; adaLN norms 4 + 1 per block + 1 final;
    # QKNorm 4 per double block, 2 per single block
    "flux": {"flash_attention": 57, "layernorm": 115, "rmsnorm": 152},
    # 30 blocks: self-attention; norm1, norm2, norm3 + the head's norm;
    # self q, self k and cross q RMS norms
    "video": {"flash_attention": 30, "layernorm": 91, "rmsnorm": 90},
}
PER_FORWARD["pixel"] = PER_FORWARD["sdxl"]
PER_RUN = {  # per run: fused half on warm iterations, finish on every one; the
    # VAE's mid attention once in the encode and once in the decode; the
    # Wan cross norm_k of 30 blocks in each of the two conds' precompute
    "sdxl": {"fused_half_step": 0, "fused_finish": 0, "wide_attention": 0},
    "pixel": {"fused_half_step": 0, "fused_finish": 0, "wide_attention": 2},
    "flux": {"fused_half_step": (STEPS - EARLY_STOP) * (THINK - 1),
             "fused_finish": (STEPS - EARLY_STOP) * THINK, "wide_attention": 0},
    "video": {"fused_half_step": 0, "fused_finish": 0, "wide_attention": 2, "rmsnorm": 60},
}
BLEND = 9  # MaskBlend overlap of the pixel and video paths
SPLASH = "lanpaint_tpu/models/layers.py:131 (_splash_kernel)"
# (shape, calls per forward by path, TPU kernel it replaces)
ATTN_SHAPES = [
    ((1, 4096, 10, 64), {"sdxl": 10, "pixel": 10}, SPLASH),
    ((1, 1024, 20, 64), {"sdxl": 60, "pixel": 60},
     "lanpaint_tpu/models/layers.py:238 (flash_attention)"),
    ((1, 4608, 24, 128), {"flux": 57}, SPLASH),
    ((1, 7920, 24, 128), {"video": 30}, SPLASH),  # TI2V-5B at 704x1280 x 33 frames
    ((2, 1000, 4, 64), {}, None),
]
# the VAEs' mid attention (one head of 512, 640 or 384): (shape, calls per
# run by path, TPU call site)
SPLASH_VAE = SPLASH + " via lanpaint_tpu/models/vae.py:81"
SPLASH_VIDEO = SPLASH + " via lanpaint_tpu/models/video_vae.py:159"
WIDE_SHAPES = [
    ((1, 16384, 1, 512), {"pixel": 2}, SPLASH_VAE),  # 1024^2: encode and decode
    ((1, 4096, 1, 512), {}, SPLASH_VAE),             # 512^2
    ((1, 4000, 1, 512), {}, SPLASH_VAE),             # a ragged S
    ((9, 3520, 1, 640), {"video": 2}, SPLASH_VIDEO),  # Wan2.2 VAE, 704x1280 x 33 frames
    ((9, 6240, 1, 384), {}, SPLASH_VIDEO),           # Wan2.1 VAE, 480x832 x 33 frames
    ((2, 1100, 1, 640), {}, SPLASH_VIDEO),           # a ragged S
    ((2, 1100, 1, 384), {}, SPLASH_VIDEO),
]
# (shape, mode, calls per forward by path[, calls per run by path]); a 4D
# rmsnorm input is the strided q/k view of a fused projection, as the DiT
# hands it over, a 3D one a dense projection's output (Wan's full-width norm)
NORM_SHAPES = [
    ((1, 4096, 640), "layernorm", {"sdxl": 30, "pixel": 30}),
    ((1, 1024, 1280), "layernorm", {"sdxl": 180, "pixel": 180}),
    ((1, 4096, 3072), "layernorm_na", {"flux": 39}),
    ((1, 512, 3072), "layernorm_na", {"flux": 38}),
    ((1, 4608, 3072), "layernorm_na", {"flux": 38}),
    ((1, 4096, 24, 128), "rmsnorm", {"flux": 38}),
    ((1, 512, 24, 128), "rmsnorm", {"flux": 38}),
    ((1, 4608, 24, 128), "rmsnorm", {"flux": 76}),
    ((1, 7920, 3072), "layernorm_na", {"video": 61}),
    ((1, 7920, 3072), "layernorm", {"video": 30}),
    ((1, 7920, 3072), "rmsnorm", {"video": 90}),
    ((1, 512, 3072), "rmsnorm", {}, {"video": 60}),
]
FUSED_SHAPES = [(1, 4 * 128 * 128), (1, 16 * 128 * 128), (2, 1000)]  # SDXL, Flux, ragged
ATTN_TOL = dict(max_abs=2e-2, rel_l2=1e-2)
NORM_TOL = dict(atol=2e-2, rtol=1e-2)
FUSED_TOL = dict(rtol=1e-5, atol=1e-6)  # tests/test_fused.py's
# One H100 SXM's published peaks (NVIDIA's data sheet, dense, at 700 W): the
# bound of a call is the larger of its bytes over PEAK_BYTES and its
# operations over the peak of their type.
PEAK_BF16 = 989e12    # tensor-core FLOP/s, bf16
PEAK_FP32 = 67e12     # FLOP/s outside the tensor cores, fp32
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
# fp32 operations per element, counted from each kernel's body: the row
# norm's LayerNorm (x^2, two sums, centre, scale, affine) and RMS mode; the
# fused think-step kernels' SHO/OU mix and Box-Muller draws (ops/fused.py)
NORM_OPS = {"layernorm": 8, "layernorm_na": 6, "rmsnorm": 5}
FUSED_OPS = 60
# bytes per element the fused kernels must move: half step 4 fp32 reads and
# 3 writes, warm finish 7 reads and 2 writes, cold finish 3 reads and 2 writes
FUSED_BYTES = {"fused_half_step": 28, "fused_finish warm": 36, "fused_finish cold": 20}


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


def bound(n_bytes: float, ops: float, peak: float) -> dict:
    """The least time the card could take for a call: the larger of its
    bytes over the memory rate and its operations over `peak`."""
    t_bytes, t_ops = 1e3 * n_bytes / PEAK_BYTES, 1e3 * ops / peak
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def timed_row(kernel, plain, err, calls, *, bounds, library=None, library_name=None,
              run_calls=None, **extra):
    """Times of the kernel, its plain version and (where one PyTorch call
    computes the same function) that call: per launch including the host's
    work (ms) and on the device (us).  `calls`: launches per forward by path;
    `run_calls`: launches per run by path."""
    r = dict(err=err, calls=calls, run_calls=run_calls or {}, ms=median_ms(kernel),
             plain_ms=median_ms(plain), us=device_us(kernel), plain_us=device_us(plain),
             library=library_name, library_ms=None, library_us=None, **bounds, **extra)
    if library is not None:
        r.update(library_ms=median_ms(library), library_us=device_us(library))
    return r


def row_text(r) -> str:
    lib = ("" if r["library_ms"] is None else
           f" library {r['library_ms']:.4f} ms ({r['library_us']:.1f} us device, "
           f"{r['library']})")
    return (f"kernel {r['ms']:.4f} ms ({r['us']:.1f} us device) plain {r['plain_ms']:.4f} ms "
            f"({r['plain_us']:.1f} us device){lib} bound {1e3 * r['bound_ms']:.1f} us "
            f"({r['bound_by']})")


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
    for shape, mode, *_ in NORM_SHAPES:
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
    """One nvcc (a subprocess) per CUDA source and Triton's compiles run side
    by side.  The wide-head kernel must not spill (its ptxas log is read)."""
    def nvcc(name):
        t0 = time.perf_counter()
        lib = attention.build_library(name)
        return lib, time.perf_counter() - t0

    with ThreadPoolExecutor(len(attention.SOURCES)) as pool:
        jobs = {name: pool.submit(nvcc, name) for name in attention.SOURCES}
        t_triton = _compile_triton()
        built = {name: job.result() for name, job in jobs.items()}
    for name, (lib, t_nvcc) in built.items():
        attention._library(name)
        kernels = ptxas_counts(lib.with_suffix(".log").read_text())
        say(f"phase 2 build: nvcc {t_nvcc:.1f} s ({lib.name}); ptxas: "
            + " / ".join(f"{k}: {v}" for k, v in kernels.items()))
        if name == "wide_attention" and (
                len(kernels) != len(attention.WIDE_HEAD_DIMS) or any(
                    "0 bytes spill stores" not in v or "0 bytes spill loads" not in v
                    for v in kernels.values())):
            raise AssertionError("a wide-head attention instantiation spills registers")
    say(f"phase 2 build: triton {t_triton:.1f} s (row norm x{len(NORM_SHAPES)} shapes, fused "
        "half + finish warm/cold), in parallel with nvcc")


def ptxas_counts(log: str) -> dict:
    """ptxas -v's registers and spills per kernel instantiation, named by
    its template arguments (D, or D x row groups)."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            args = re.findall(r"Li(\d+)E", ln.split("'")[1])
            name = "D=" + "x".join(args) if args else ln.split("'")[1]
            out[name] = ""
        elif name and ("spill" in ln or "registers" in ln):
            part = ln.split(":", 1)[-1].strip() if "registers" in ln else ln.strip()
            out[name] = (out[name] + ", " + part).strip(", ")
    return out


def _qkv_views(b, s, h, d, gen):
    """q, k, v as the main paths hand them over: strided views of one fused
    projection (B, S, 3 * H * D)."""
    qkv = torch.randn((b, s, 3 * h * d), device="cuda", generator=gen).to(torch.bfloat16)
    return [t.unflatten(-1, (h, d)) for t in qkv.chunk(3, dim=-1)]


def _kernel_attention(gen, kernel=attention.flash_attention, shapes=ATTN_SHAPES,
                      per_run=False) -> list:
    """Each shape through `kernel` against `attention_ref` in fp32, then
    timed against `attention_ref` on the same bf16 inputs."""
    rows = []
    for shape, calls, *replaces in shapes:
        b, s, h, d = shape
        q, k, v = _qkv_views(b, s, h, d, gen)
        if s % 8:  # a ragged S: contiguous inputs
            q, k, v = (t.contiguous() for t in (q, k, v))
        out = kernel(q, k, v)
        torch.cuda.synchronize()
        want = attention.attention_ref(q.float(), k.float(), v.float())
        err = float((out.float() - want).abs().max())
        rel = rel_l2(out.float(), want)
        del want
        ok = err <= ATTN_TOL["max_abs"] and rel <= ATTN_TOL["rel_l2"]
        if not ok:
            raise AssertionError(f"{kernel.__name__} {shape} disagrees with attention_ref: "
                                 f"max abs {err}, rel L2 {rel}, limits {ATTN_TOL}")
        backends = _sdpa_backends(q, k, v)
        r = timed_row(lambda: kernel(q, k, v), lambda: attention.attention_ref(q, k, v), err,
                      {} if per_run else calls, run_calls=calls if per_run else None,
                      bounds=bound(4 * b * s * h * d * 2, 4 * b * h * s * s * d, PEAK_BF16),
                      library=lambda: _sdpa(q, k, v),
                      library_name="scaled_dot_product_attention, backends that take it: "
                                   + ("/".join(backends) or "math only"),
                      shape=shape, replaces=replaces[0] if replaces else None)
        say(f"phase 3 kernels: {kernel.__name__} {shape} max_abs_err {err:.3g} rel_l2 "
            f"{rel:.3g} {row_text(r)} ok")
        rows.append(r)
    return rows


def _sdpa(q, k, v):
    """The PyTorch call computing the same attention (yardstick only)."""
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2)).transpose(1, 2)


def _sdpa_backends(q, k, v) -> list:
    """The fused SDPA backends that accept this call (flash stops at D =
    256); with none, PyTorch's default call takes its math path."""
    ok = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION):
        try:
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore")  # each refusal warns why
                _sdpa(q, k, v)
            ok.append(backend.name.lower())
        except RuntimeError:
            pass
    torch.cuda.synchronize()
    return ok


def _kernel_norms(gen) -> list:
    rows = []
    for shape, mode, calls, *run_calls in NORM_SHAPES:
        c = shape[-1]
        library = None
        if mode == "rmsnorm":  # 4D: a strided q view, as QKNorm gets it
            x = (_qkv_views(*shape, gen)[0] if len(shape) == 4 else
                 torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16))
            g = (1.0 + 0.1 * torch.randn(c, device="cuda", generator=gen)).to(torch.bfloat16)
            kernel, plain = (lambda: norms.rmsnorm(x, g)), (lambda: norms.rmsnorm_ref(x, g))
            library = lambda: F.rms_norm(x, (c,), g, eps=1e-6)  # noqa: E731
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
            if mode == "layernorm":  # F.layer_norm takes the weights in x's dtype
                gb, bb = g.to(x.dtype), beta.to(x.dtype)
                library = lambda: F.layer_norm(x, (c,), gb, bb, eps=1e-6)  # noqa: E731
        out = kernel()
        torch.cuda.synchronize()
        want = plain()
        err = float((out.float() - want.float()).abs().max())
        ok = out.dtype == want.dtype and torch.allclose(out.float(), want.float(), **NORM_TOL)
        if not ok:
            raise AssertionError(f"{mode} {shape} disagrees with its plain version: {err}")
        params = [p for p in (g, beta) if p is not None] if mode != "rmsnorm" else [g]
        n_bytes = sum(t.numel() * t.element_size() for t in (x, out, *params))
        r = timed_row(kernel, plain, err, calls, run_calls=run_calls[0] if run_calls else None,
                      bounds=bound(n_bytes, NORM_OPS[mode] * x.numel(), PEAK_FP32),
                      library=library,
                      library_name={"layernorm": "F.layer_norm", "rmsnorm": "F.rms_norm"}.get(mode),
                      shape=shape, mode=mode)
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
            r = timed_row(kernel, plain, err, {}, run_calls={path: per_run[name]},
                          bounds=bound(FUSED_BYTES[name] * b * m, FUSED_OPS * b * m, PEAK_FP32),
                          shape=(b, m), mode=name)
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
    wide_rows = _kernel_attention(gen, attention.wide_attention, WIDE_SHAPES, per_run=True)
    norm_rows = _kernel_norms(gen)
    half_rows, finish_rows = _kernel_fused(gen)
    return {"flash_attention": attn_rows, "wide_attention": wide_rows, "row_norm": norm_rows,
            "fused_half_step": half_rows, "fused_finish": finish_rows}


def _three_ways(build, cfg, seed):
    """One set of weights: (fp32 on the CPU, bf16 on the CPU, bf16 on the card)."""
    ref_den, ref_mod = build(dataclasses.replace(cfg, dtype=torch.float32), seed=seed,
                             name="small", device="cpu")
    state = ref_mod.state_dict()
    plain = build(cfg, state, name="small", device="cpu")
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


COUNTERS = {"flash_attention": attention.flash_attention,
            "wide_attention": attention.wide_attention, "layernorm": norms.layernorm,
            "rmsnorm": norms.rmsnorm, "fused_half_step": fused.fused_half_step,
            "fused_finish": fused.fused_finish}


def _zero_counters() -> None:
    for f in COUNTERS.values():
        f.launches = 0


def _want(path: str) -> dict:
    """Every counter's expected launches in one timed run of `path`."""
    want = {k: n * FORWARDS[path] for k, n in PER_FORWARD[path].items()}
    for k, n in PER_RUN[path].items():
        want[k] = want.get(k, 0) + n
    return want


def _main_path(label, path, smi, den, module, t_init, run, warmup, latent) -> dict:
    n_params = sum(p.numel() for p in module.parameters())
    t0 = time.perf_counter()
    warmup()
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0

    _zero_counters()
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
    want = _want(path)
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


def _centre_mask(hh, ww):
    """1 over the centre half of each side, 0 elsewhere."""
    mask = torch.zeros((hh, ww), device="cuda")
    mask[hh // 4:3 * hh // 4, ww // 4:3 * ww // 4] = 1.0
    return mask


def _build_sdxl():
    t0 = time.perf_counter()
    den, module = zoo.build_sdxl(device="cuda", param_dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    return den, module, time.perf_counter() - t0


def _sdxl_conds(gen):
    return tuple({"context": torch.randn((1, 77, 2048), device="cuda", generator=gen),
                  "y": torch.randn((1, 2816), device="cuda", generator=gen)} for _ in range(2))


def phase_sdxl(smi: str) -> tuple:
    """Returns (launches, the SDXL Denoiser) so the pixel phase reuses it."""
    den, module, t_init = _build_sdxl()
    gen = torch.Generator(device="cuda").manual_seed(0)
    latent = torch.randn((1, 4, 128, 128), device="cuda", generator=gen)
    cond, uncond = _sdxl_conds(gen)
    sigmas = calculate_sigmas(den.sigma_table, "karras", STEPS)
    sam = LanPaintSampler(den, config=LanPaintConfig(n_steps=THINK, outer_early_stop=EARLY_STOP),
                          sampler_name="euler", cfg=5.0, sequential_cfg=True)
    run = lambda: sam(latent=latent, sigmas=sigmas, cond=cond, uncond=uncond,  # noqa: E731
                      mask=_centre_mask(1024, 1024), seed=0)
    return _main_path(f"phase 6 SDXL main path: euler karras {STEPS} x think {THINK}, cfg 5 "
                      "sequential", "sdxl", smi, den, module, t_init, run, run, latent), den


def _vae_times(model, image) -> tuple:
    """(encode ms, decode ms, the latent): median of 3 calls after one warm-up."""
    with torch.no_grad():
        latent = model.encode(image)
        enc = median_ms(lambda: model.encode(image), n=3, warmup=1)
        dec = median_ms(lambda: model.decode(latent), n=3, warmup=1)
    return enc, dec, latent


def _pixel_workflow(entry, den, model, source, path, **kw) -> tuple:
    """One timed and counted call of a pixel workflow (`inpaint_image` or
    `inpaint_video`, which takes `source` as its image or video) with a 2D
    centre mask and MaskBlend overlap BLEND.  Checks that the output is
    finite and of the source's shape, that every pixel (of every frame)
    farther than the blend from the mask equals the source bit for bit, that
    the repainted region moved, and that every kernel ran exactly as `path`
    expects.  Returns (ok, launches, the result's text)."""
    hh, ww = source.shape[-2:]
    mask = _centre_mask(hh, ww)
    source_kw = {"image" if entry is inpaint_image else "video": source}
    _zero_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = entry(den, model, mask=mask, blend_overlap=BLEND, **source_kw, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in COUNTERS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    far = torch.ones((hh, ww), dtype=torch.bool, device="cuda")
    far[hh // 4 - BLEND:3 * hh // 4 + BLEND, ww // 4 - BLEND:3 * ww // 4 + BLEND] = False
    finite = bool(torch.isfinite(out).all())
    kept = torch.equal(out[..., far], source[..., far])
    moved = float((out - source)[..., mask > 0].abs().mean())
    want = _want(path)
    ok = (finite and out.shape == source.shape and kept and moved > 1e-2
          and launches == want)
    fwd = FORWARDS[path]
    text = (f"{fwd} forwards, timed run {wall:.3f} s = {1e3 * wall / fwd:.2f} ms per forward, "
            f"peak {peak_gb:.1f} GB | finite {finite} shape {tuple(out.shape)} beyond-blend "
            f"pixels bit-equal {kept} repainted mean change {moved:.3g} | launches {launches} "
            f"(want {want}) {'ok' if ok else 'FAIL'}")
    return ok, launches, text


def phase_pixel(smi: str, den=None) -> dict:
    """Pixel-space inpainting at 1024^2: `api.inpaint_image` with the SDXL
    UNet (phase 6's, or a new one) and the SDXL VAE, random bf16 weights."""
    if den is None:
        den, _, _ = _build_sdxl()
    t0 = time.perf_counter()
    model = zoo.build_vae(vae.SDXL_VAE_CONFIG, device="cuda", param_dtype=torch.bfloat16, seed=1)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(2)
    image = torch.rand((1, 3, 1024, 1024), device="cuda", generator=gen) * 2.0 - 1.0
    cond, uncond = _sdxl_conds(gen)
    enc_ms, dec_ms, latent = _vae_times(model, image)
    if latent.shape != (1, 4, 128, 128) or not bool(torch.isfinite(latent).all()):
        raise AssertionError(f"SDXL VAE encode gave {tuple(latent.shape)}, finite "
                             f"{bool(torch.isfinite(latent).all())}")
    ok, launches, text = _pixel_workflow(
        inpaint_image, den, model, image, "pixel", positive=cond, negative=uncond, seed=0,
        steps=STEPS, cfg=5.0, scheduler="karras", num_steps=THINK, sequential_cfg=True)
    say(f"phase 7 pixel path: inpaint_image, SDXL VAE ({n_params / 1e6:.1f} M params bf16, "
        f"init {t_init:.1f} s) + SDXL euler karras {STEPS} x think {THINK}, cfg 5 sequential, "
        f"blend {BLEND} | VAE encode {enc_ms:.2f} ms decode {dec_ms:.2f} ms (1024^2, median of "
        f"3) | {text} on {smi}")
    if not ok:
        raise AssertionError("phase 7 pixel path check failed")
    return launches


def _vae_round_trip(label, model, shape, latent_shape, seed, smi, extra_ok=True) -> None:
    """One encode-decode round trip of `model` on a random `shape` input in
    [-1, 1], each half timed alone: the latent of `latent_shape`, the output
    of `shape`, both finite, and the wide-head attention launched twice
    (the mid attention of the encoder and of the decoder)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(shape, device="cuda", generator=gen) * 2.0 - 1.0
    enc_ms, dec_ms, _ = _vae_times(model, x)
    _zero_counters()
    with torch.no_grad():
        latent = model.encode(x)
        out = model.decode(latent)
    torch.cuda.synchronize()
    wide = attention.wide_attention.launches
    ok = (tuple(latent.shape) == latent_shape and tuple(out.shape) == shape
          and bool(torch.isfinite(latent).all()) and bool(torch.isfinite(out).all())
          and wide == 2 and extra_ok)
    say(f"{label}: encode {enc_ms:.2f} ms -> {tuple(latent.shape)}, decode {dec_ms:.2f} ms -> "
        f"{tuple(out.shape)} (median of 3) on {smi} | finite | wide-head attention launches "
        f"{wide} (want 2) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} round trip failed")


def phase_flux_vae(smi: str) -> None:
    """One encode-decode round trip of the Flux VAE (no quant convs) at 1024^2."""
    model = zoo.build_vae(vae.FLUX_VAE_CONFIG, device="cuda", param_dtype=torch.bfloat16, seed=4)
    _vae_round_trip("phase 9 Flux VAE", model, (1, 3, 1024, 1024), (1, 16, 128, 128), 3, smi,
                    extra_ok=model.encoder.quant_conv is None)


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
                   cond=cond, mask=_centre_mask(1024, 1024), seed=0)

    return _main_path(f"phase 8 Flux main path: euler simple {STEPS} x think {THINK}, cfg 1, "
                      "fused think step (warm-up: 2 steps)", "flux", smi, den, module, t_init,
                      run, lambda: run(2), latent)


def _self_device_us(event) -> float:
    return getattr(event, "self_device_time_total", None) or getattr(event, "self_cuda_time_total", 0)


def profile_forward(fn) -> dict:
    """One call of `fn` (after one unprofiled call) under torch.profiler:
    its wall clock to a synchronize, the CUDA kernels' summed self time in
    the same window, the card's idle share between them, the kernel count,
    and the largest kernels by device time."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    cuda = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(_self_device_us(e) for e in cuda) / 1e3
    top = sorted(cuda, key=_self_device_us, reverse=True)[:6]
    return dict(wall_ms=wall_ms, device_ms=device_ms, idle=1.0 - device_ms / wall_ms,
                kernels=sum(e.count for e in cuda),
                top=[(e.key[:48], round(_self_device_us(e) / 1e3, 3), e.count) for e in top])


def phase_video(smi: str) -> dict:
    """Wan2.2 TI2V-5B video inpainting at 704x1280 x 33 frames:
    `api.inpaint_video` with its defaults (euler "simple", 20 steps x 2
    think, CFG 5, here as two sequential passes, blend 9) on the TI2V-5B
    DiT and the Wan2.2 VAE, random bf16 weights, a random video and a 2D
    centre mask; a 2-step warm-up call, then one timed and counted call."""
    t0 = time.perf_counter()
    den, module = zoo.build_wan(wan.WAN22_TI2V_5B_CONFIG, device="cuda",
                                param_dtype=torch.bfloat16, seed=0, name="wan22-ti2v-5b")
    model = zoo.build_wan_vae(video_vae.WAN22_VAE_CONFIG, device="cuda",
                              param_dtype=torch.bfloat16, seed=1)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_dit = sum(p.numel() for p in module.parameters())
    n_vae = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(5)
    video = torch.rand(VIDEO_SHAPE, device="cuda", generator=gen) * 2.0 - 1.0
    cond, uncond = ({"context": torch.randn((1, 512, 4096), device="cuda", generator=gen)}
                    for _ in range(2))
    enc_ms, dec_ms, latent = _vae_times(model, video)
    if tuple(latent.shape) != (1, 48, 9, 44, 80) or not bool(torch.isfinite(latent).all()):
        raise AssertionError(f"Wan2.2 VAE encode gave {tuple(latent.shape)}, finite "
                             f"{bool(torch.isfinite(latent).all())}")
    pre = den.precompute(cond)
    t_mid = torch.tensor([0.7], device="cuda")
    prof = profile_forward(lambda: den.apply(latent, t_mid, pre))
    del pre

    kw = dict(positive=cond, negative=uncond, seed=0, sequential_cfg=True)
    t0 = time.perf_counter()
    inpaint_video(den, model, video=video, mask=_centre_mask(*VIDEO_SHAPE[-2:]), steps=2,
                  blend_overlap=BLEND, **kw)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    ok, launches, text = _pixel_workflow(inpaint_video, den, model, video, "video", **kw)
    say(f"phase 10 video path: inpaint_video, Wan2.2 TI2V-5B ({n_dit / 1e9:.3f} B params bf16) + "
        f"Wan2.2 VAE ({n_vae / 1e6:.1f} M), init {t_init:.1f} s | {VIDEO_SHAPE} -> latent "
        f"{tuple(latent.shape)}, S = 7920 | VAE encode {enc_ms:.2f} ms decode {dec_ms:.2f} ms "
        f"(median of 3) | one forward at t = 0.7 under torch.profiler: wall "
        f"{prof['wall_ms']:.2f} ms, kernels {prof['device_ms']:.2f} ms in {prof['kernels']}, "
        f"idle {100 * prof['idle']:.1f}%, top {prof['top']} | euler simple {STEPS} x think "
        f"{VIDEO_THINK}, cfg 5 sequential, blend {BLEND}, first run (2 steps) {t_first:.2f} s, "
        f"{text} on {smi}")
    if not ok:
        raise AssertionError("phase 10 video path check failed")
    return launches


def phase_wan21_vae(smi: str) -> None:
    """One encode-decode round trip of the Wan2.1 VAE at 480x832 x 33
    frames: its mid attention runs the wide-head kernel at D = 384."""
    model = zoo.build_wan_vae(video_vae.WAN21_VAE_CONFIG, device="cuda",
                              param_dtype=torch.bfloat16, seed=6)
    _vae_round_trip("phase 11 Wan2.1 VAE (mid attention at D = 384)", model, WAN21_SHAPE,
                    (1, 16, 9, 60, 104), 7, smi)


def kernels_line(rows: dict, launches: dict) -> list:
    """One entry per kernel: launches in the timed main-path runs, and the
    per-launch times, bounds and library-call times at each main-path shape
    weighted by those runs' launches at that shape (`library_ms` null where
    a launched shape has no one PyTorch call computing the same function)."""
    meta = {
        "flash_attention": ("cuda", "lanpaint_tpu_torch/csrc/attention.cu",
                            "lanpaint_tpu/models/layers.py:238; lanpaint_tpu/models/layers.py:131",
                            ("flash_attention",)),
        "wide_attention": ("cuda", "lanpaint_tpu_torch/csrc/wide_attention.cu",
                           "lanpaint_tpu/models/layers.py:131 (_splash_kernel) via "
                           "lanpaint_tpu/models/vae.py:81 and lanpaint_tpu/models/video_vae.py:159",
                           ("wide_attention",)),
        "row_norm": ("triton", "lanpaint_tpu_torch/ops/norms.py",
                     "lanpaint_tpu/ops/norms.py:93", ("layernorm", "rmsnorm")),
        "fused_half_step": ("triton", "lanpaint_tpu_torch/ops/fused.py",
                            "lanpaint_tpu/ops/fused.py:239", ("fused_half_step",)),
        "fused_finish": ("triton", "lanpaint_tpu_torch/ops/fused.py",
                         "lanpaint_tpu/ops/fused.py:259", ("fused_finish",)),
    }

    def run_launches(r):  # this shape's launches in the timed runs
        return (sum(n * FORWARDS[p] for p, n in r["calls"].items())
                + sum(r["run_calls"].values()))

    out = []
    for name, (route, source, replaces, counters) in meta.items():
        weighted = [(r, run_launches(r)) for r in rows[name]]
        used = [(r, n) for r, n in weighted if n]
        by_ops = sum(r["bound_ms"] * n for r, n in used if r["bound_by"] == "operations")
        total_bound = sum(r["bound_ms"] * n for r, n in used)
        out.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": sum(launches[p][c] for p in launches for c in counters),
            "launches_by_path": {p: sum(launches[p][c] for c in counters) for p in launches},
            "max_abs_err": max(r["err"] for r, _ in weighted),
            "ms": sum(r["ms"] * n for r, n in used),
            "plain_ms": sum(r["plain_ms"] * n for r, n in used),
            "bound_ms": total_bound,
            "bound_by": "operations" if by_ops >= total_bound / 2 else "bytes",
            "library_ms": (sum(r["library_ms"] * n for r, n in used)
                           if all(r["library_ms"] is not None for r, _ in used) else None),
            "per_shape": [{"shape": list(r["shape"]), "mode": r.get("mode"),
                           "launches_per_forward": r["calls"], "launches_per_run": r["run_calls"],
                           "ms": r["ms"], "plain_ms": r["plain_ms"], "device_us": r["us"],
                           "plain_device_us": r["plain_us"], "bound_us": 1e3 * r["bound_ms"],
                           "bound_by": r["bound_by"], "library": r["library"],
                           "library_ms": r["library_ms"], "library_device_us": r["library_us"],
                           "max_abs_err": r["err"]}
                          for r, _ in weighted],
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
    launches = {}
    launches["sdxl"], den = phase_sdxl(smi)
    launches["pixel"] = phase_pixel(smi, den)
    del den
    api._SAMPLER_CACHE.clear()  # ksampler's sampler cache holds the SDXL model
    gc.collect()
    torch.cuda.empty_cache()  # SDXL's weights go before Flux's 23.8 GB arrive
    launches["flux"] = phase_flux(smi)
    gc.collect()
    torch.cuda.empty_cache()
    phase_flux_vae(smi)
    launches["video"] = phase_video(smi)
    api._SAMPLER_CACHE.clear()  # ksampler's sampler cache holds the Wan model
    gc.collect()
    torch.cuda.empty_cache()
    phase_wan21_vae(smi)
    print(smi)
    print(json.dumps({"kernels": kernels_line(rows, launches)}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
