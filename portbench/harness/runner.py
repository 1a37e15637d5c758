"""One run of one cell: set-up, the measured window, the metrics, the
comparison, and the result line.

The cell's traffic file names its entry, `entries/<entry>.py`, which
holds `setup(ctx)` (set-up; it sets `ctx.module`, the backbone the traced
spans hook), `run_window(ctx, seconds, sync)` and `check(ctx)`.  The entry
owns the window and the way it offers load (`harness/window.py`): it
returns the requests attempted and failed, the window's seconds and each
request's latency, which the metric readers get.  With `trace` the
backbone's forwards are spanned by CUDA events and one slice of the window
runs under the profiler; the metrics are then the cell's per-layer ones,
else its end-to-end ones.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from . import files
from .trace import ForwardSpans


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, t0: float,
             device="cuda", bench: dict = None, sizes: dict = None,
             traffic: dict = None) -> dict:
    """Run cell `name` once; returns the result line's dict (and, under
    `_check`, the comparison's details and the latencies).  `sizes` /
    `traffic` override the cell's files (the CPU tests' tiny runs)."""
    bench = files.benchmark() if bench is None else bench
    cell = files.cell(name, bench)
    traffic = files.traffic(name) if traffic is None else traffic
    config = files.config_module(cell["config"])
    ctx = SimpleNamespace(seed=int(seed), device=device, config=config, traffic=traffic,
                          sizes=files.config_sizes(cell["config"]) if sizes is None else sizes)
    entry = files.entry_module(traffic["entry"])
    entry.setup(ctx)
    _sync(device)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0

    spans = None
    if trace:
        first, count = traffic["profile_forwards"]
        spans = ForwardSpans(ctx.module, first, count)
        spans.armed = on_card
    win = entry.run_window(ctx, seconds, lambda: _sync(device))
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    run = SimpleNamespace(window_s=win.window_s, setup_s=setup_s,
                          jobs=win.attempted - win.failed, latencies=win.latencies,
                          sizes=ctx.sizes, config=config, traffic=traffic,
                          forward_ms=[], batches=[], profile=None)
    if spans is not None:
        spans.armed = False
        if on_card:
            run.forward_ms, run.batches = spans.forward_ms(), spans.batches
        spans.close()
        run.profile = spans.profile
        run.window_s -= spans.paused_s
    e2e, per_layer = files.metrics_of(name, bench)
    metrics = {}
    for m in (per_layer if trace else e2e):
        value = files.metric_module(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    check = entry.check(ctx)
    limits = traffic["limits"]
    checks = {k: {"value": float(check["numbers"][k]), "limit": float(limits[k])}
              for k in limits}
    correct = win.failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(memory_peak)}
    out = {"correct": bool(correct), "attempted": win.attempted, "failed": win.failed,
           "metrics": metrics, "device": dev}
    if trace and run.profile is not None:
        dev["busy_s"] = run.profile["busy_s"]
        dev["window_s"] = run.profile["slice_s"]
        out["breakdown"] = {"device_ops": run.profile["device_ops"],
                            "idle_gaps": run.profile["idle_gaps"]}
    out["checks"] = checks
    out["_check"] = dict(check, latencies=win.latencies)
    return out
