"""The program's own spans (`lanpaint_tpu_torch.telemetry`) of the window's
jobs, for the readers of span metrics.  A program without the recorder
gives none, and its readers read nothing."""

from __future__ import annotations

import torch


def window_jobs(run) -> list:
    """The job records of the window: the last `run.jobs` the recorder kept
    (the warm-up job ran before the window, and the comparison runs after
    the readers); [] where the program has no recorder."""
    try:
        from lanpaint_tpu_torch import telemetry
    except ImportError:
        return []
    if not run.jobs:
        return []
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return telemetry.jobs(last=run.jobs)
