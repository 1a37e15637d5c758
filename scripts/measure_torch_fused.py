#!/usr/bin/env python3
"""Device time of the port's fused think-step kernel by the shape of its
blocks, on one CUDA card.

    python3 scripts/measure_torch_fused.py

For each main-path latent size of `chip_smoke.FUSED_SHAPES` (SDXL's (1,
65,536) and Flux's (1, 262,144)) and each phase (half step, warm finish,
cold finish), runs `csrc/fused.cu` under each candidate block shape,
(threads a block, quads a thread) of 128 or 256 threads and 1 or 2 quads
(4 or 8 elements: a quad is one Philox call's four normals, so a thread
of fewer elements would evaluate each call more than once).  Each
candidate is first held to the plain version fed the kernel's draw
(`fused.philox_normals`, `chip_smoke.FUSED_NOISE_TOL`) at noise_mult 1,
then timed on the device (`chip_smoke.device_us`: CUDA events around
back-to-back calls that the host queues behind a sleep kernel), in turns,
in order and then in reverse.  One JSON line per size, phase and
candidate, after the card's nvidia-smi name and power limit; then one line
per size with the candidate of least device time summed over the three
phases, each weighted by its launches in a Flux run (76 half, 76 warm, 19
cold; 1 each where no main path launches that size).  `ops/fused.BLOCK_SHAPE`
is the best of both.  Before them, the device time of a one-element fill: the
card's floor for one launch of any kernel, timed the same way.
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from lanpaint_tpu_torch.ops import fused  # noqa: E402

CANDIDATES = [(128, 1), (128, 2), (256, 1), (256, 2)]


def cases(b, m, gen, seed) -> dict:
    """phase -> (kernel(config), plain()) on inputs as chip_smoke phase 3
    makes them; the finishes start from the kernel's half step."""
    tx, ty, x, v, c, c_new, mask = chip_smoke._fused_case(b, m, gen)
    d0, d1 = (fused.philox_normals(seed, launch, b, m).cuda() for launch in (0, 1))
    xh, vh, xho = fused.fused_half_step(tx, ty, 1.0, x, v, c, mask, seed=seed, launch=0)
    launch = fused._launch
    return {
        "half": (lambda cfg: launch(fused.fused_half_step, fused.HALF, seed, 0, 0, tx, ty, 1.0, x,
                                    v=v, c_old=c, mask=mask, n_out=3, config=cfg),
                 lambda: fused.fused_half_step_ref(tx, ty, 1.0, x, v, c, mask, *d0)),
        "warm": (lambda cfg: launch(fused.fused_finish, fused.WARM, seed, 1, 0, tx, ty, 1.0, xh,
                                    v=vh, x_od=xho, c_old=c, c_new=c_new, mask=mask, config=cfg),
                 lambda: fused.fused_finish_ref(tx, ty, 1.0, True, x, xh, vh, xho, c, c_new,
                                                mask, *d1)),
        "cold": (lambda cfg: launch(fused.fused_finish, fused.COLD, seed, 1, 0, tx, ty, 1.0, x,
                                    c_new=c_new, mask=mask, config=cfg),
                 lambda: fused.fused_finish_ref(tx, ty, 1.0, False, x, None, None, None, None,
                                                c_new, mask, *d1)),
    }


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    if not torch.cuda.is_available():
        print("measure_torch_fused: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    # the card's floor for one launch of any kernel: a one-element fill
    one = torch.zeros(1, device="cuda")
    print(json.dumps({"launch_floor_us": chip_smoke.device_us(lambda: one.fill_(1.0))}),
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    seed = torch.randint(0, 2**31 - 1, (1,), generator=gen, device="cuda")
    loops = chip_smoke.STEPS - chip_smoke.EARLY_STOP
    flux_runs = {"half": loops * (chip_smoke.THINK - 1), "warm": loops * (chip_smoke.THINK - 1),
                 "cold": loops}
    for b, m in chip_smoke.FUSED_SHAPES:
        if b != 1:  # the main paths' sizes only
            continue
        flux = m == 16 * 128 * 128
        totals = dict.fromkeys(CANDIDATES, 0.0)
        for phase, (kernel, plain) in cases(b, m, gen, seed).items():
            want = plain()
            for cfg in CANDIDATES:
                got = kernel(cfg)
                err = max(float((g - w).abs().max()) for g, w in zip(got, want))
                if not all(torch.allclose(g, w, **chip_smoke.FUSED_NOISE_TOL)
                           for g, w in zip(got, want)):
                    print(f"{phase} ({b}, {m}) config {cfg} disagrees with its plain version: "
                          f"{err}", file=sys.stderr)
                    return 1
            times = {cfg: [] for cfg in CANDIDATES}
            for cfg in CANDIDATES + CANDIDATES[::-1]:
                times[cfg].append(chip_smoke.device_us(lambda: kernel(cfg)))
            launches = flux_runs[phase] if flux else 0
            for cfg in CANDIDATES:
                totals[cfg] += sum(times[cfg]) / 2 * max(launches, 1)
                print(json.dumps({"shape": [b, m], "phase": phase, "threads": cfg[0],
                                  "quads": cfg[1], "device_us": times[cfg],
                                  "launches_per_run": launches}), flush=True)
        best = min(totals, key=totals.get)
        print(json.dumps({"M": m, "best": list(best),
                          "weighted_us": {f"{t}x{q}": v for (t, q), v in totals.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
