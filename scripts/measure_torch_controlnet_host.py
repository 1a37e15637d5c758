#!/usr/bin/env python3
"""Where the host time of an SDXL-1024 forward with a ControlNet goes, on
one CUDA card.

    python3 scripts/measure_torch_controlnet_host.py [--forwards 20] [--rounds 2]

chip_smoke.py's phase 6 SDXL UNet (random bf16 weights from seed 0) and
phase 20's pair over its state (`zoo.build_controlled_unet`, a ControlNet of
seed 1 with its zero convs drawn), a seeded (1, 3, 1024, 1024) hint, phase
6's random conds.  In each round, in this order: `--forwards` forwards back
to back of the pair with the hint (strength 1), of the same pair without it
(the plain UNet), and of phase 6's UNet Denoiser, each with Python's garbage
collector on and then off: wall ms a forward to a synchronize, and the CUDA
kernels a forward (one forward under torch.profiler, the first round only).
After the rounds, phase 20's sampler run (euler karras 20 x 5 think, CFG 5
sequential, 230 forwards) at strength 1 with the collector on, then off,
and phase 6's run on the plain UNet: seconds and ms a forward.  One JSON
line each, after the card's nvidia-smi name and power limit.
"""

import argparse
import gc
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from lanpaint_tpu_torch import LanPaintConfig, LanPaintSampler  # noqa: E402
from lanpaint_tpu_torch.models import unet, zoo  # noqa: E402
from lanpaint_tpu_torch.sigmas import calculate_sigmas  # noqa: E402


def _wall_ms(fn, n: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def _gc(enabled: bool) -> None:
    if enabled:
        gc.enable()
    else:
        gc.collect()
        gc.disable()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--forwards", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("measure_torch_controlnet_host: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    c.phase_build()
    den, module = zoo.build_unet(unet.SDXL_CONFIG, device="cuda", param_dtype=torch.bfloat16,
                                 seed=0)
    cden, (_, cn) = zoo.build_controlled_unet(unet.SDXL_CONFIG, module.state_dict(),
                                              device="cuda", param_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        for conv in cn.zero_convs():
            conv.weight.normal_(0.0, 0.02, generator=gen)
    gen = torch.Generator(device="cuda").manual_seed(0)
    latent = torch.randn((1, 4, 128, 128), device="cuda", generator=gen)
    hint = torch.rand((1, 3, 1024, 1024), device="cuda", generator=gen) * 2.0 - 1.0
    cond, uncond = c._hinted_conds(gen, hint)
    bare = {k: v for k, v in cond.items() if k != "hint"}
    sigma = torch.tensor([3.0], device="cuda")
    cases = {"controlled": lambda: cden.apply(latent, sigma, cond),
             "pair without hint": lambda: cden.apply(latent, sigma, bare),
             "phase 6 UNet": lambda: den.apply(latent, sigma, bare)}
    with torch.no_grad():
        for fn in cases.values():
            fn()
        kernels = {name: c.profile_forward(fn)["kernels"] for name, fn in cases.items()}
        for rnd in range(args.rounds):
            for name, fn in cases.items():
                for enabled in (True, False):
                    _gc(enabled)
                    ms = _wall_ms(fn, args.forwards)
                    gc.enable()
                    print(json.dumps({"round": rnd, "forward": name, "gc": enabled,
                                      "ms_a_forward": round(ms, 3),
                                      "kernels_a_forward": kernels[name],
                                      "us_a_kernel": round(1e3 * ms / kernels[name], 2)}),
                          flush=True)

    sigmas = calculate_sigmas(cden.sigma_table, "karras", c.STEPS)
    config = LanPaintConfig(n_steps=c.THINK, outer_early_stop=c.EARLY_STOP)
    mask = c._centre_mask(1024, 1024)
    runs = (("controlled", cden, cond, uncond, True), ("controlled", cden, cond, uncond, False),
            ("phase 6 UNet", den, bare, {k: v for k, v in uncond.items() if k != "hint"}, True))
    for name, model, pos, neg, enabled in runs:
        sam = LanPaintSampler(model, config=config, sampler_name="euler", cfg=5.0,
                              sequential_cfg=True)
        _gc(enabled)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = sam(latent=latent, sigmas=sigmas, cond=pos, uncond=neg, mask=mask, seed=0)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        gc.enable()
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name}: non-finite sample")
        print(json.dumps({"run": name, "gc": enabled, "s": round(s, 3),
                          "ms_a_forward": round(1e3 * s / (2 * c.PAIRS), 2)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
