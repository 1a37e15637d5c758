"""model.issue_ms: the host's time to issue one backbone call, in ms: the
median host time, entry to return, of the program's `model.forward` spans
in the window's jobs.  Where the host sets the pace it is the launch path's
pace; where the card does, it lies between the host's own launch work and
the forward's device time, and nearing `model.forward_ms` it says the cell
has turned host-bound."""

import statistics

from portbench.harness.spans import window_jobs


def read(run):
    values = [s["host_ms"] for job in window_jobs(run) for s in job["spans"]
              if s["name"] == "model.forward"]
    return statistics.median(values) if values else None
