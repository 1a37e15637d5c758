#!/usr/bin/env python3
"""Device time of the port's D <= 128 attention kernel by the depth of its
K/V ring, on one CUDA card.

    python3 scripts/measure_torch_attention_stages.py [--d64 2 3 4 6] [--d128 2 3]

Builds `lanpaint_tpu_torch/csrc/attention.cu` once per stage count
(-DLP_ATTN_STAGES_D64 / -DLP_ATTN_STAGES_D128; one nvcc each, side by side)
and runs every build at the main paths' shapes (SDXL S = 4,096 and 1,024 at
D = 64, Flux S = 4,608 and Wan S = 7,920 at D = 128) and a ragged B = 2,
S = 1,000 shape per head dim, on the strided q/k/v views of one fused
projection as the models hand them over.  Each build is first held to
`attention_ref` in fp32 (max abs error), then timed on the device: CUDA
events around 20 back-to-back calls that the host queues behind a sleep
kernel, so host work does not count.  The builds run in turns, in order
and then in reverse, and both times are printed.  One JSON line per shape
and stage count, after the card's nvidia-smi name and power limit.
"""

import argparse
import json
import math
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from lanpaint_tpu_torch.ops import attention, cuda_build  # noqa: E402

SHAPES = {64: [(1, 4096, 10, 64), (1, 1024, 20, 64), (2, 1000, 4, 64)],
          128: [(1, 4608, 24, 128), (1, 7920, 24, 128), (2, 1000, 4, 128)]}


def device_us(fn, n: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms: the host queues the n calls meanwhile
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return 1e3 * start.elapsed_time(end) / n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d64", type=int, nargs="+", default=[2, 3, 4, 6])
    ap.add_argument("--d128", type=int, nargs="+", default=[2, 3])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("measure_torch_attention_stages: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    variants = [(64, n) for n in args.d64] + [(128, n) for n in args.d128]
    defines = {v: (f"LP_ATTN_STAGES_D{v[0]}={v[1]}",) for v in variants}
    with ThreadPoolExecutor(len(variants)) as pool:  # one nvcc each, side by side
        list(pool.map(lambda v: cuda_build.build_library("attention", defines[v]), variants))
    fns = {v: cuda_build.load_entry("attention", defines[v]) for v in variants}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for d, shapes in SHAPES.items():
        stages = [n for dd, n in variants if dd == d]
        for b, s, h, _ in shapes:
            qkv = torch.randn((b, s, 3 * h * d), device="cuda", generator=gen).to(torch.bfloat16)
            q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.chunk(3, dim=-1))
            want = attention.attention_ref(q.float(), k.float(), v.float())
            runs = {n: (lambda fn=fns[(d, n)]: attention._tma_launch("flash_attention", fn, q,
                                                                     k, v, None))
                    for n in stages}
            err = {n: float((runs[n]().float() - want).abs().max()) for n in stages}
            del want
            times = {n: [] for n in stages}
            for n in stages + stages[::-1]:
                times[n].append(device_us(runs[n]))
            flops = 4 * b * h * s * s * d
            for n in stages:
                print(json.dumps({"shape": [b, s, h, d], "stages": n, "max_abs_err": err[n],
                                  "device_us": times[n],
                                  "tflops": flops / min(times[n]) / 1e6,
                                  "bound_us": 1e6 * flops / 989e12}), flush=True)
            if any(not math.isfinite(e) or e > 2e-2 for e in err.values()):
                print(f"a build disagrees with attention_ref at {(b, s, h, d)}: {err}",
                      file=sys.stderr)
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
