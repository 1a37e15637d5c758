"""Observability and persistence utilities.

PyTorch counterpart of `lanpaint_tpu/utils.py`: profiling (`torch.profiler`
in place of `jax.profiler`), weight persistence (a state dict with
`torch.save` / `torch.load` in place of orbax; the content is the same
parameters), and the preview-callback throttle (the reference's TAESD
preview callback, nodes.py:188-196; pair with `models.taesd.TAESDDecoder`
and `LanPaintSampler(callback=...)`).  `resolve_device` is the device rule
of every builder: the CUDA card unless the caller names another.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or the CUDA card when it is None.  Without a card a build
    that names no device raises: it does not carry on on the CPU (the CPU
    tests pass device="cpu")."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port builds on the card unless the caller "
                           "asks for another device (pass device=\"cpu\" for the CPU)")
    return torch.device("cuda")


@contextlib.contextmanager
def profile_trace(log_dir: str = "lanpaint_trace"):
    """Profile everything inside the block with `torch.profiler` (CPU, and
    CUDA when a card is present) and write a Chrome trace to
    `<log_dir>/trace.json` on exit.  Yields the profiler, whose
    `key_averages()` gives the per-op table:

        with profile_trace("trace") as prof:
            sampler(latent=..., sigmas=..., cond=...)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def save_params(path: str, params) -> None:
    """Save a module's parameters (or a state dict) with `torch.save`."""
    state = params.state_dict() if isinstance(params, torch.nn.Module) else params
    torch.save(state, os.path.abspath(path))


def load_params(path: str, like=None):
    """Load a state dict saved by `save_params`, on the CPU.  With `like` a
    module, load it into the module (strictly) and return the module."""
    state = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    if isinstance(like, torch.nn.Module):
        like.load_state_dict(state)
        return like
    return state


def make_preview_callback(fn: Callable[[int, torch.Tensor], None], every: int = 2) -> Callable:
    """Throttle a preview callback to every `every`-th outer step
    (reference nodes.py:192 shows previews every 2nd step): the result is a
    sampler `callback(i, denoised, x)` that calls `fn(i, denoised)`."""

    def cb(i, denoised, x):
        if int(i) % every == 0:
            fn(int(i), denoised)

    return cb
