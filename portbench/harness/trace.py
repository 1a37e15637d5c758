"""What a traced run records, from the benchmark's own files: device-time
spans of every backbone forward (CUDA events in forward hooks, no sync),
and one steady slice of the window under `torch.profiler`, reduced once
the window has closed to busy seconds, device seconds by kernel class, the
longest operations and the longest idle gaps by the host operation that
ended them.  Starting and stopping the profiler pauses the host with the
card drained; those pauses (`paused_s`) are the instrumentation's cost
and are taken out of the traced window."""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time

import torch

from .kernels import kernel_class


class ForwardSpans:
    """Hooks on the backbone module: a CUDA event pair around every
    forward, its batch, and a profiled slice from forward `first` to
    forward `first + count` (the slice holds `count` whole forwards and
    the work between them).  `armed` turns the recording on."""

    def __init__(self, module: torch.nn.Module, first: int, count: int):
        self.events, self.batches = [], []
        self.first, self.count = first, count
        self.armed = False
        self.profile = None
        self.paused_s = 0.0
        self._prof = None
        self._slice = None
        self._handles = [module.register_forward_pre_hook(self._pre),
                         module.register_forward_hook(self._post)]

    def _pre(self, module, args):
        if not self.armed:
            return
        n = len(self.events)
        if n == self.first:
            self._start_profile()
        elif n == self.first + self.count and self._prof is not None:
            self._stop_profile()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        self.events.append([start, None])
        self.batches.append(int(args[0].shape[0]))

    def _post(self, module, args, out):
        if self.armed and self.events and self.events[-1][1] is None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.events[-1][1] = end

    def _start_profile(self):
        torch.cuda.synchronize()
        t = time.perf_counter()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        self.paused_s += self._t0 - t

    def _stop_profile(self):
        torch.cuda.synchronize()
        t = time.perf_counter()
        self._prof.stop()
        self._slice = (self._prof, t - self._t0)
        self._prof = None
        self.paused_s += time.perf_counter() - t

    def close(self):
        """Remove the hooks and reduce the slice's trace (None if the
        window ended inside the slice)."""
        if self._prof is not None:
            self._prof.stop()
            self._prof = None
        for h in self._handles:
            h.remove()
        if self._slice is not None:
            self.profile = reduce_profile(*self._slice, self.count)
            self._slice = None

    def forward_ms(self) -> list:
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events if e is not None]


def union_s(intervals) -> float:
    """Seconds covered by (start_us, end_us) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e6


def reduce_profile(prof, slice_s: float, forwards: int) -> dict:
    """The slice's kernels from the profiler's trace: busy seconds (their
    union), device seconds by class, the ten longest kernel classes and the
    ten largest sums of idle gaps by the host operation running at the
    launch that ended each gap."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    kernels = [e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"]
    cpu_ops = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"),
                     key=lambda e: e["ts"])
    launches = {e["args"].get("correlation"): e for e in events
                if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "args" in e}
    by_class = {}
    for k in kernels:
        c = kernel_class(k.get("name", ""))
        by_class[c] = by_class.get(c, 0.0) + k["dur"] / 1e6
    spans = sorted((k["ts"], k["ts"] + k["dur"], k) for k in kernels)
    gaps = {}
    starts = [e["ts"] for e in cpu_ops]
    end = None
    for s, e, k in spans:
        if end is not None and s > end:
            label = _host_label(launches.get(k.get("args", {}).get("correlation")), cpu_ops, starts)
            gaps[label] = gaps.get(label, 0.0) + (s - end) / 1e6
        end = e if end is None else max(end, e)
    return {"slice_s": slice_s, "forwards": forwards,
            "busy_s": union_s((s, e) for s, e, _ in spans),
            "by_class": by_class, "kernels": len(kernels),
            "device_ops": sorted(([c, v] for c, v in by_class.items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": sorted(([c, v] for c, v in gaps.items()), key=lambda x: -x[1])[:10]}


def _host_label(launch, cpu_ops, starts) -> str:
    """The innermost host operation around a kernel's launch."""
    if launch is None:
        return "unknown"
    t = launch["ts"]
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 50, -1), -1):
        if cpu_ops[j]["ts"] + cpu_ops[j]["dur"] >= t:
            return cpu_ops[j]["name"]
    return "outside any aten op: " + launch.get("name", "launch")
