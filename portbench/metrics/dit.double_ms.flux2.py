"""dit.double_ms.flux2: the device time of FLUX.2's double-stream blocks a
forward, in ms: over the window's jobs, the median device ms of the
program's `dit.double` spans (one a forward, `models/flux2.py`).  A
program that opens no such span gives nothing."""

import statistics

from portbench.harness.spans import window_jobs


def median_ms(run, name: str):
    """The median device ms of the window's spans called `name`, or None."""
    ms = [s["device_ms"] for job in window_jobs(run) for s in job["spans"]
          if s["name"] == name and s["device_ms"] is not None]
    return statistics.median(ms) if ms else None


def read(run):
    return median_ms(run, "dit.double")
