"""Spans of the sampling path, on the host's clock and on the card's.

`span(name, device=None, **attrs)` times a block:

* host nanoseconds at entry and exit (`time.perf_counter_ns`);
* with `device` (the device the block's work runs on) a CUDA device, a
  pair of CUDA events on that device's current stream, from a pool that
  evicted jobs refill (once `KEEP` jobs are kept, none is created).
  Nothing synchronises and nothing is copied between host and device;
* while `torch.profiler` runs, `torch.profiler.record_function(name)`
  around the block, so the span shows in the profiler's trace as a
  `user_annotation` around the work it launched, on the kernels' clock.
  With the profiler off the span does not call it (it costs ~10 us a
  call even then).

Spans nest.  A job root (`JOB_ROOTS`: `pipeline.video` or `sampler.job`)
opened outside any other span starts a job record, which collects every
span opened inside it on the same thread: name, parent, host start and
end, the event pair and the attrs.  A `sampler.job` inside a
`pipeline.video` joins that record as a child.  Spans opened outside a job
are not recorded.  The recorder keeps the last `KEEP` jobs; an evicted
job's events go back to the pool.

The port's spans:

| span | placed in | events | attrs |
| --- | --- | --- | --- |
| `pipeline.video` | `api.inpaint_video`, whole body | yes | frames, height, width, tokens |
| `vae.encode` | `api.inpaint_video`, the VAE encode | yes | |
| `vae.decode` | `api.inpaint_video`, the VAE decode | yes | |
| `video.blend` | `api.inpaint_video`, the per-frame MaskBlend | yes | |
| `sampler.job` | `api.LanPaintSampler.__call__` | yes | sampler, steps, batch |
| `sampler.step` | the solver's model function (`api`): one a model-function call | no | step |
| `engine.think_iter` | each Langevin iteration of `engine.lanpaint_update` | yes | i |
| `model.forward` | each backbone call in `guidance.make_cfg_double_denoiser` | yes | batch |
| `dit.double` | FLUX.2's forward (`models/flux2.py`), its double-stream blocks | yes | tokens, ref_tokens |
| `dit.single` | FLUX.2's forward, its single-stream blocks | yes | tokens, ref_tokens |

`model.forward` holds the Denoiser's apply whole: the backbone and the
model's own input scaling and output conversion.

`jobs(last=n)` resolves the kept records (host and device ms a span; the
caller synchronises first, and an unfinished event pair gives None).
`summary()` gives, per span name, the count and the p50 / p90 of host and
device ms over the kept jobs, beside the kernel wrappers' launch counters,
the cross-attention launches of the flash-attention kernel among them
(`cross_launches`), the row norm's launches with RoPE in their epilogue
(`rope_launches`, `norms.rmsnorm_rope`), FLUX.2's shared-modulation
computations (`modulation_calls`, `flux2.SharedModulation.calls`: 3 a
forward) and SwiGLU calls (`swiglu_calls`, `flux2.swiglu.calls`: 64 a
FLUX.2 [dev] forward) and the UNet's CUDA-graph counters (`models/graphs.py`:
captures, replays and forwards run eagerly; replays over replays plus eager
is the hit rate).
The wrappers count the launches the host issues; `card_kernels()` counts
the port's kernels that the card runs in a block, from its trace, a
graph's replays among them.
`enable(flag)` switches recording for the process.  It is on by default:
a span costs ~3 us of host time, ~20-45 us with its event pair, a few
ms a job of hundreds of forwards, and a recorder that must be switched
on is off where it would be read.  `reset()` forgets the kept jobs.
"""

from __future__ import annotations

import collections
import contextlib
import re
import threading
import time

import numpy as np
import torch

KEEP = 64  # jobs kept
JOB_ROOTS = ("pipeline.video", "sampler.job")  # spans that start a job record


class _Entry:
    __slots__ = ("name", "parent", "t0", "t1", "index", "events", "attrs")


class Recorder:
    """The process's span store: the open job of each thread, the last
    `KEEP` finished jobs and the free CUDA events of each device."""

    def __init__(self):
        self.enabled = True
        self._jobs = collections.deque()
        self._pool = {}  # device index -> free timing events
        self._lock = threading.Lock()
        self._local = threading.local()
        self.graphs = {"captures": 0, "replays": 0, "eager": 0}  # models/graphs.py

    def _events(self, index: int) -> list:
        with self._lock:
            free = self._pool.setdefault(index, [])
            if len(free) >= 2:
                return [free.pop(), free.pop()]
        return [torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)]

    def _finish(self, job: list) -> None:
        with self._lock:
            self._jobs.append(job)
            while len(self._jobs) > KEEP:
                self._release(self._jobs.popleft())

    def _release(self, job: list) -> None:
        for e in job:
            if e.events is not None:
                self._pool.setdefault(e.index, []).extend(e.events)

    def reset(self) -> None:
        with self._lock:
            while self._jobs:
                self._release(self._jobs.popleft())

    def jobs(self, last: int = None) -> list:
        """The kept jobs, oldest first (the last `last` of them), each
        {"host_ms", "device_ms", "attrs", "spans"}: `spans` in the order
        opened, the job's own first, each {"name", "parent" (an index into
        `spans`, None for the job), "start_ms" (host, from the job's
        start), "host_ms", "device_ms" (None without events or before the
        card has passed them), "attrs"}."""
        with self._lock:  # an evicted job's events may be recorded again
            kept = list(self._jobs)
            if last is not None:
                kept = kept[max(0, len(kept) - last):] if last > 0 else []
            return [_resolve(job) for job in kept]

    def summary(self) -> dict:
        """Per span name over the kept jobs: count, and p50 / p90 of host
        ms and of device ms (None where no span has both events done),
        with the kernel wrappers' `.launches`, the flash-attention
        launches among them that were cross-attention
        (`flash_attention.cross_launches`, a key of its own so that
        `families` does not count them twice), the row norm's RoPE
        launches (`rmsnorm_rope.launches`, also in `launches`), FLUX.2's
        shared modulations and SwiGLU calls and the CUDA-graph counters
        (`count_graphs`) beside them."""
        from .models import flux2
        from .ops import attention, norms

        kept = self.jobs()
        times = {}
        for job in kept:
            for s in job["spans"]:
                host, dev = times.setdefault(s["name"], ([], []))
                host.append(s["host_ms"])
                if s["device_ms"] is not None:
                    dev.append(s["device_ms"])

        def pct(values):
            return ({"p50": float(np.percentile(values, 50)),
                     "p90": float(np.percentile(values, 90))} if values else None)

        return {"jobs": len(kept),
                "spans": {name: {"count": len(host), "host_ms": pct(host), "device_ms": pct(dev)}
                          for name, (host, dev) in times.items()},
                "launches": launches(),
                "cross_launches": attention.flash_attention.cross_launches,
                "rope_launches": norms.rmsnorm_rope.launches,
                "modulation_calls": flux2.SharedModulation.calls,
                "swiglu_calls": flux2.swiglu.calls,
                "graphs": dict(self.graphs)}


def _resolve(job: list) -> dict:
    t_job = job[0].t0
    spans = []
    for e in job:
        dev = None
        if e.events is not None and e.events[0].query() and e.events[1].query():
            dev = e.events[0].elapsed_time(e.events[1])
        spans.append({"name": e.name, "parent": e.parent, "start_ms": (e.t0 - t_job) / 1e6,
                      "host_ms": (e.t1 - e.t0) / 1e6, "device_ms": dev, "attrs": e.attrs})
    root = spans[0]
    return {"host_ms": root["host_ms"], "device_ms": root["device_ms"], "attrs": root["attrs"],
            "spans": spans}


def _cuda_index(device):
    """The CUDA device index `device` names, or None."""
    if device is None or device.type != "cuda":
        return None
    return torch.cuda.current_device() if device.index is None else device.index


class _Span:
    __slots__ = ("_rec", "_name", "_device", "_attrs", "_entry", "_stream", "_annotation")

    def __init__(self, rec: Recorder, name: str, device, attrs: dict):
        self._rec, self._name, self._device, self._attrs = rec, name, device, attrs
        self._entry = self._annotation = None

    @property
    def attrs(self) -> dict:
        """The span's attrs, which the block may add to before it ends."""
        return self._attrs

    def __enter__(self):
        rec = self._rec
        if not rec.enabled:
            return self
        if torch.autograd.profiler._is_profiler_enabled:
            self._annotation = torch.profiler.record_function(self._name)
            self._annotation.__enter__()
        local = rec._local
        job = getattr(local, "job", None)
        if job is None:
            if self._name not in JOB_ROOTS:
                return self
            job = local.job = []
            local.stack = []
        e = self._entry = _Entry()
        e.name, e.attrs, e.events = self._name, self._attrs, None
        e.parent = local.stack[-1] if local.stack else None
        local.stack.append(len(job))
        job.append(e)
        index = _cuda_index(self._device)
        e.t0 = time.perf_counter_ns()
        if index is not None:
            self._stream = torch.cuda.current_stream(index)
            e.index, e.events = index, rec._events(index)
            e.events[0].record(self._stream)
        return self

    def __exit__(self, *exc):
        e = self._entry
        if e is not None:
            if e.events is not None:
                e.events[1].record(self._stream)
            e.t1 = time.perf_counter_ns()
            local = self._rec._local
            local.stack.pop()
            if not local.stack:
                job, local.job = local.job, None
                self._rec._finish(job)
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        return False


RECORDER = Recorder()


def span(name: str, device: torch.device = None, **attrs) -> _Span:
    """A context manager timing its block as span `name` (module docstring);
    CUDA events are recorded where `device` is a CUDA device."""
    return _Span(RECORDER, name, device, attrs)


def enable(flag: bool = True) -> None:
    """Switch recording on or off for the process (on by default)."""
    RECORDER.enabled = bool(flag)


def reset() -> None:
    """Forget the kept jobs (their events go back to the pool)."""
    RECORDER.reset()


def jobs(last: int = None) -> list:
    """The kept job records (`Recorder.jobs`)."""
    return RECORDER.jobs(last)


def summary() -> dict:
    """The operator's view of the kept jobs (`Recorder.summary`)."""
    return RECORDER.summary()


def launches() -> dict:
    """The seven kernel wrappers' launch counters, as they stand: the
    launches the host issued through them, a graph's capture among them
    and its replays not (`card_kernels` counts what the card ran)."""
    from .ops import attention, fused, norms

    return {f.__name__: f.launches for f in (
        attention.flash_attention, attention.wide_attention, norms.layernorm, norms.rmsnorm,
        norms.rmsnorm_rope, fused.fused_half_step, fused.fused_finish)}


def count_graphs(name: str) -> None:
    """Count a graph captured ("captures"), or a forward replayed
    ("replays") or run eagerly ("eager"), by `models/graphs.Graphs`."""
    with RECORDER._lock:
        RECORDER.graphs[name] += 1


# The port's hand-written kernels (`csrc/*.cu`) by their symbol in a device
# trace, and the family each is counted in: the row norm's modes (with
# RoPE or without) are one kernel, and the fused think step's template
# phase tells its half step (kHalf = 0) from its finishes (kWarm = 1,
# kCold = 2).  The trace
# names them `void (anonymous namespace)::row_norm_kernel<...>(...)`; the
# lookbehinds keep out PyTorch's own `pytorch_flash::flash_fwd_kernel`.
_KERNEL = re.compile(r"(?<!\w)(?<!pytorch_flash::)"
                     r"(flash_fwd_kernel|wide_fwd_kernel|row_norm_kernel|fused_think_kernel)<(\d*)")
FAMILIES = ("flash_attention", "wide_attention", "row_norm", "fused_half_step", "fused_finish")


def kernel_family(name: str):
    """The family (`FAMILIES`) of the kernel named `name` (demangled) in a
    device trace, or None where it is none of the port's."""
    m = _KERNEL.search(name)
    if m is None:
        return None
    kind, phase = m.groups()
    if kind == "fused_think_kernel":
        return "fused_half_step" if phase == "0" else "fused_finish"
    return {"flash_fwd_kernel": "flash_attention", "wide_fwd_kernel": "wide_attention",
            "row_norm_kernel": "row_norm"}[kind]


def families(counts: dict) -> dict:
    """Launch counts by wrapper name (`launches()`) or by family, by family
    as `card_kernels` counts them."""
    out = {f: counts.get(f, 0) for f in FAMILIES}
    out["row_norm"] += sum(counts.get(k, 0) for k in ("layernorm", "rmsnorm", "rmsnorm_rope"))
    return out


@contextlib.contextmanager
def card_kernels():
    """Count the port's hand-written kernels that the card runs inside the
    block, from a CUPTI trace of its device activity (`torch.profiler`): a
    CUDA graph's replays among them, which pass no wrapper.  Yields
    {family: 0} over `FAMILIES`, filled in when the block ends, after a
    synchronize."""
    counts = dict.fromkeys(FAMILIES, 0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        yield counts
        torch.cuda.synchronize()
    for event in prof.profiler.kineto_results.events():
        if event.device_type() == torch.autograd.DeviceType.CUDA:
            family = kernel_family(event.name())
            if family is not None:
                counts[family] += 1
