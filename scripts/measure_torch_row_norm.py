#!/usr/bin/env python3
"""Device time of the port's row-norm kernel by the shape of its blocks, on
one CUDA card.

    python3 scripts/measure_torch_row_norm.py [--widths 64,2560,3584,3840]

For each row-norm shape of the main paths (`chip_smoke.NORM_SHAPES`, with
the shapes whose text lengths come from the synthetic tokenizers: the SDXL
LayerNorms, the DiTs' fp32-out adaLN norms, QKNorm's strided views of a
fused projection, the full-width q / k norms of Wan and HiDream, Z-Image's
and Qwen-Image's RMS norms, the DiTs' and Wan's q / k norms with RoPE in
the epilogue; `--widths` keeps the rows of those widths
only), runs `csrc/row_norm.cu` under
each candidate block shape, (threads a block, threads a row): up to 32
threads a row with many rows a block, or any whole number of warps a row
with 1, 2 or 4 rows a block, with 1 to 8 16-byte vectors a thread.  Each candidate is
first held to the plain version (`chip_smoke.NORM_TOL`), then timed on the
device
(`chip_smoke.device_us`: CUDA events around back-to-back calls that the
host queues behind a sleep kernel), in turns, in order and then in
reverse.  One JSON line per shape and candidate, after the card's
nvidia-smi name and power limit; then one line per row width with the
candidate of least device time summed over that width's shapes, each
weighted by its launches in the main-path runs (`ops/norms.CONFIG` takes
those), beside the weighted time of the block shape the kernel took for
that width when the script ran (`norms.launch_config`).
"""

import argparse
import json
import math
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from lanpaint_tpu_torch.ops import norms  # noqa: E402


def candidates(c: int) -> list:
    """(threads a block, threads a row) worth timing at row width `c`."""
    nvec = c // norms.VEC
    out = []
    for tpr in (4, 8, 16, 32):  # a row shared by the lanes of part of a warp
        nv = 1 << (math.ceil(nvec / tpr) - 1).bit_length()
        if tpr <= nvec and nv <= 8:
            out += [(t, tpr) for t in (128, 256, 512) if t <= norms.max_threads(nv)]
    for tpr in range(64, math.ceil(nvec / 32) * 32 + 1, 32):  # whole warps a row
        nv = 1 << (math.ceil(nvec / tpr) - 1).bit_length()
        if nv <= 8:  # 1, 2 or 4 rows a block
            out += [(t, tpr) for t in (tpr, 2 * tpr, 4 * tpr) if t <= norms.max_threads(nv)]
    return out


def case(shape, mode, gen):
    """(kernel(config), plain()) on inputs as chip_smoke phase 3 makes them."""
    c = shape[-1]
    if mode == "rmsnorm_rope":  # RoPE in the epilogue, the table as the models slice it
        x, freqs = chip_smoke.rope_case(shape, gen)
        g = (1.0 + 0.1 * torch.randn(c, device="cuda", generator=gen)).to(torch.bfloat16)
        return (lambda cfg: norms._launch(norms.rmsnorm_rope, x, g, None, 1e-6, True, None, cfg,
                                          rope=(freqs, 128)),
                lambda: norms.rmsnorm_rope_ref(x, g, 1e-6, freqs, 128))
    if mode.startswith("rmsnorm"):
        x = (chip_smoke._qkv_views(*shape, gen)[0] if len(shape) == 4 else
             torch.randn(shape, device="cuda", generator=gen))
        x = x if mode == "rmsnorm_fp32" else x.to(torch.bfloat16)
        g = (1.0 + 0.1 * torch.randn(c, device="cuda", generator=gen)).to(torch.bfloat16)
        return (lambda cfg: norms._launch(norms.rmsnorm, x, g, None, 1e-6, True, None, cfg),
                lambda: norms.rmsnorm_ref(x, g))
    x = (torch.randn(shape, device="cuda", generator=gen) * 2.0 + 0.5).to(torch.bfloat16)
    g = beta = None
    out_dtype = torch.float32
    if mode == "layernorm":
        g = 1.0 + 0.1 * torch.randn(c, device="cuda", generator=gen)
        beta = 0.1 * torch.randn(c, device="cuda", generator=gen)
        out_dtype = None
    return (lambda cfg: norms._launch(norms.layernorm, x, g, beta, 1e-6, False, out_dtype, cfg),
            lambda: norms.layernorm_ref(x, g, beta, eps=1e-6, out_dtype=out_dtype))


def add_path_shapes() -> None:
    """chip_smoke's rows whose text lengths come from its synthetic
    tokenizers (Z-Image, Qwen-Image-Edit, SD3.5, HiDream, HunyuanVideo)."""
    chip_smoke.add_new_path_shapes(*chip_smoke.text_lengths(chip_smoke.synthetic_qwen_tokenizer()))
    chip_smoke.add_a14_shapes(
        *chip_smoke.a14_text_lengths(chip_smoke.synthetic_llama_tokenizer()))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--widths", default="",
                        help="comma-separated row widths to sweep (default: every width)")
    widths = {int(c) for c in parser.parse_args().widths.split(",") if c}
    if not torch.cuda.is_available():
        print("measure_torch_row_norm: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    add_path_shapes()
    gen = torch.Generator(device="cuda").manual_seed(0)
    totals = {}  # C -> {config: launch-weighted device us}
    for shape, mode, calls, *run_calls in chip_smoke.NORM_SHAPES:
        c = shape[-1]
        if widths and c not in widths:
            continue
        launches = (sum(n * chip_smoke.FORWARDS[p] for p, n in calls.items())
                    + sum((run_calls[0] if run_calls else {}).values()))
        kernel, plain = case(shape, mode, gen)
        want = plain().float()
        configs = candidates(c)
        for cfg in configs:
            got = kernel(cfg).float()
            err = float((got - want).abs().max())
            if not torch.allclose(got, want, **chip_smoke.NORM_TOL):
                print(f"{mode} {shape} config {cfg} disagrees with its plain version: {err}",
                      file=sys.stderr)
                return 1
        times = {cfg: [] for cfg in configs}
        for cfg in configs + configs[::-1]:
            times[cfg].append(chip_smoke.device_us(lambda: kernel(cfg)))
        for cfg in configs:
            us = sum(times[cfg]) / 2
            totals.setdefault(c, {}).setdefault(cfg, 0.0)
            totals[c][cfg] += us * max(launches, 1)
            print(json.dumps({"shape": list(shape), "mode": mode, "threads": cfg[0],
                              "threads_per_row": cfg[1], "device_us": times[cfg],
                              "launches_per_runs": launches}), flush=True)
    for c, by_cfg in totals.items():
        best, current = min(by_cfg, key=by_cfg.get), norms.launch_config(c)
        print(json.dumps({"C": c, "best": list(best), "best_us": by_cfg[best],
                          "current": list(current), "current_us": by_cfg.get(current),
                          "weighted_us": {f"{t}x{r}": v for (t, r), v in by_cfg.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
