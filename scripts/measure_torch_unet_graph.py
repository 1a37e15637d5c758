#!/usr/bin/env python3
"""The SDXL-1024 UNet forward eager and replayed as a CUDA graph
(`models/graphs.py`), on one CUDA card.

    python3 scripts/measure_torch_unet_graph.py [--forwards 20] [--jobs 2]

The UNet at SDXL's widths and depth (random bf16 weights from seed 0,
`zoo.build_unet`), batch 2 (CFG batched), a 128^2 latent, N(0, 1) context
(2, 77, 2048) and y (2, 2816), the cross-attention k/v hoisted as the
sampler does.  Prints, one JSON line each, after the card's nvidia-smi name
and power limit:

* `forward`: for the eager forward (`UNetModel._forward`) and the replay,
  ms a forward from the host's clock to a synchronize over `--forwards`
  back to back, the host's ms to issue them (the loop before the
  synchronize), the card's ms a forward between CUDA events, the port's
  kernels a forward in the card's trace of one more such loop
  (`telemetry.card_kernels`); the capture's seconds, whether the replay's
  output equals the eager one bit for bit (and the largest difference),
  the peak memory with and without the graph, and the host's ms for one
  replay issued from an idle queue;
* `jobs`: `--jobs` rounds of one `api.ksampler` job graphed and one eager,
  in turn (euler karras 20 x 5 think, CFG 5 batched: the benchmark's
  `sdxl-1024.single` traffic, 115 forwards a job): seconds a job, the
  graph counters and the wrappers' launches (what the host issued) each
  job added, and the host ms of its `model.forward` spans (p10 / p50 /
  p90, and the median by the forward's place in its step).  The eager
  jobs run with the module's forward set to `UNetModel._forward`, the
  function that the graph captures.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from lanpaint_tpu_torch import api, telemetry  # noqa: E402
from lanpaint_tpu_torch.models import unet, zoo  # noqa: E402


def _delta(before: dict, after: dict) -> dict:
    return {k: n - before[k] for k, n in after.items() if n != before[k]}


def _graphs() -> dict:
    return telemetry.summary()["graphs"]


def _time(fn, n: int) -> dict:
    """ms a call: to a synchronize, to issue, between CUDA events; and the
    port's kernels a call in the card's trace of `n` more calls."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    with telemetry.card_kernels() as kernels:
        for _ in range(n):
            fn()
    return {"wall_ms": 1e3 * (t2 - t0) / n, "issue_ms": 1e3 * (t1 - t0) / n,
            "device_ms": start.elapsed_time(end) / n,
            "kernels": {k: v / n for k, v in kernels.items() if v}}


def _pct(values, q):
    values = sorted(values)
    return values[min(len(values) - 1, int(round(q / 100 * (len(values) - 1))))]


def _by_place(job) -> dict:
    """Median host ms of the `model.forward` spans by their place among a
    step's forwards (0 = the step's first)."""
    spans, places, count = job["spans"], {}, {}
    for sp in spans:
        if sp["name"] != "model.forward":
            continue
        j = sp["parent"]
        while spans[j]["name"] != "sampler.step":
            j = spans[j]["parent"]
        place = count.get(j, 0)
        count[j] = place + 1
        places.setdefault(place, []).append(sp["host_ms"])
    return {p: _pct(v, 50) for p, v in sorted(places.items())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--forwards", type=int, default=20)
    ap.add_argument("--jobs", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("measure_torch_unet_graph: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    c.phase_build()
    den, module = zoo.build_unet(unet.SDXL_CONFIG, device="cuda", param_dtype=torch.bfloat16,
                                 seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((2, 4, 128, 128), device="cuda", generator=gen)
    t = torch.full((2,), 500.0, device="cuda")
    ctx = torch.randn((2, 77, 2048), device="cuda", generator=gen)
    y = torch.randn((2, 2816), device="cuda", generator=gen)
    out = {}
    with torch.no_grad():
        kv = zoo.unet_precompute_kv(module, {"context": ctx})["kv_cache"]
        eager = lambda: module._forward(x, t, ctx, y, kv_cache=kv)  # noqa: E731
        graphed = lambda: module(x, t, ctx, y, kv_cache=kv)  # noqa: E731
        want = eager()
        out["eager"] = _time(eager, args.forwards)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eager()
        torch.cuda.synchronize()
        peak_eager = torch.cuda.max_memory_allocated()
        graphed()  # the signature's first call: eager
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = graphed()  # warm-up and capture, then a replay
        torch.cuda.synchronize()
        out["capture_s"] = time.perf_counter() - t0
        out["replay"] = _time(graphed, args.forwards)
        again = graphed()
        torch.cuda.synchronize()
        out["peak_bytes"] = {"eager": peak_eager, "graphed": torch.cuda.max_memory_allocated()}
        out["bit_equal"] = bool(torch.equal(got, want) and torch.equal(again, want))
        out["max_abs_diff"] = float((again - want).abs().max())
        issue = []
        for _ in range(10):  # from an idle queue: the host's own cost of a replay
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graphed()
            issue.append(1e3 * (time.perf_counter() - t0))
        out["idle_issue_ms"] = sorted(issue)[len(issue) // 2]
        out["graphs"] = _graphs()
    print(json.dumps({"forward": out}), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(2)
    latent = torch.randn((1, 4, 128, 128), device="cuda", generator=gen)
    mask = torch.zeros((1024, 1024), device="cuda")
    mask[256:768, 320:832] = 1.0
    pos = {"context": torch.randn((1, 77, 2048), device="cuda", generator=gen),
           "y": torch.randn((1, 2816), device="cuda", generator=gen)}
    neg = {k: torch.randn(v.shape, device="cuda", generator=gen) for k, v in pos.items()}

    def job(seed):
        api.ksampler(den, seed=seed, steps=20, cfg=5.0, sampler_name="euler",
                     scheduler="karras", positive=pos, negative=neg, latent=latent, mask=mask,
                     num_steps=5)

    job(0)  # warm-up
    rounds = []
    for r in range(args.jobs):
        for mode in ("graphed", "eager"):
            if mode == "eager":
                module.forward = module._forward
            torch.cuda.synchronize()
            g0, l0 = _graphs(), telemetry.launches()
            t0 = time.perf_counter()
            job(r + 1)
            torch.cuda.synchronize()
            job_s = time.perf_counter() - t0
            if mode == "eager":
                del module.forward
            record = telemetry.jobs(last=1)[0]
            host = [sp["host_ms"] for sp in record["spans"] if sp["name"] == "model.forward"]
            rounds.append({"round": r, "mode": mode, "job_s": job_s,
                           "graphs": _delta(g0, _graphs()),
                           "launches": _delta(l0, telemetry.launches()),
                           "forward_host_ms": {"p10": _pct(host, 10), "p50": _pct(host, 50),
                                               "p90": _pct(host, 90)},
                           "forward_host_ms_by_place": _by_place(record)})
    print(json.dumps({"jobs": rounds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
