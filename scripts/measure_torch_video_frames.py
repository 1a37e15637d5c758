#!/usr/bin/env python3
"""Device memory and time of the port's video inpainting by frame count, on
one CUDA card.

    python3 scripts/measure_torch_video_frames.py [--frames 33 49 65 ...]

`lanpaint_tpu_torch.api.inpaint_video` with Wan2.2 TI2V-5B and the Wan2.2
VAE at TI2V-5B's published 704x1280, random bf16 weights made on the card
from a seed, a random video and a 2D centre mask, with inpaint_video's
defaults but for the steps: 2 euler steps ("simple", 2 think steps, CFG 5 as
two sequential passes, blend 9), that is 4 CFG pairs, 8 DiT forwards.  For
each frame count, ascending (each 4k + 1): the peak of
`torch.cuda.max_memory_allocated` over one call (the weights included), the
call's wall time, and after it one DiT forward, one VAE encode and one VAE
decode, each timed alone (a stage that runs out of device memory is named).
It stops at the first frame count whose inpaint_video call runs out of
device memory.  One JSON line per frame count, after the card's nvidia-smi
name and power limit.
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

from lanpaint_tpu_torch import inpaint_video  # noqa: E402
from lanpaint_tpu_torch.models import video_vae, wan, zoo  # noqa: E402

HEIGHT, WIDTH = 704, 1280


def _wall_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def measure(den, model, frames: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(frames)
    video = torch.rand((1, 3, frames, HEIGHT, WIDTH), device="cuda", generator=gen) * 2.0 - 1.0
    cond, uncond = ({"context": torch.randn((1, 512, 4096), device="cuda", generator=gen)}
                    for _ in range(2))
    mask = torch.zeros((HEIGHT, WIDTH), device="cuda")
    mask[HEIGHT // 4:3 * HEIGHT // 4, WIDTH // 4:3 * WIDTH // 4] = 1.0
    row = {"frames": frames}
    stage = "inpaint_video"
    try:
        torch.cuda.reset_peak_memory_stats()
        out, row["call_s"] = _wall_s(lambda: inpaint_video(
            den, model, video=video, mask=mask, positive=cond, negative=uncond, seed=0,
            steps=2, sequential_cfg=True))
        row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        row["finite"] = bool(torch.isfinite(out).all())
        del out
        gc.collect()
        torch.cuda.empty_cache()
        with torch.no_grad():
            stage = "encode"
            latent, row["encode_s"] = _wall_s(lambda: model.encode(video))
            row["latent"] = list(latent.shape)
            row["tokens"] = latent.shape[2] * (latent.shape[3] // 2) * (latent.shape[4] // 2)
            stage = "forward"
            pre = den.precompute(cond)
            t_mid = torch.tensor([0.7], device="cuda")
            _, row["forward_s"] = _wall_s(lambda: den.apply(latent, t_mid, pre))
            del pre
            stage = "decode"
            _, row["decode_s"] = _wall_s(lambda: model.decode(latent))
    except torch.cuda.OutOfMemoryError:
        row["out_of_memory_in"] = stage
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, nargs="+", default=[33, 49, 65, 81, 89, 97, 105, 113, 121])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("measure_torch_video_frames: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    den, _ = zoo.build_wan(wan.WAN22_TI2V_5B_CONFIG, device="cuda", param_dtype=torch.bfloat16,
                           seed=0, name="wan22-ti2v-5b")
    model = zoo.build_wan_vae(video_vae.WAN22_VAE_CONFIG, device="cuda",
                              param_dtype=torch.bfloat16, seed=1)
    print(json.dumps({"weights_gb": torch.cuda.memory_allocated() / 1e9,
                      "card_gb": torch.cuda.get_device_properties(0).total_memory / 1e9}),
          flush=True)
    measure(den, model, 5)  # warm-up: kernel builds, cuDNN and cuBLAS plans
    for frames in sorted(args.frames):
        gc.collect()
        torch.cuda.empty_cache()
        row = measure(den, model, frames)
        print(json.dumps(row), flush=True)
        if row.get("out_of_memory_in") == "inpaint_video":
            break
    return 0


if __name__ == "__main__":
    sys.exit(main())
