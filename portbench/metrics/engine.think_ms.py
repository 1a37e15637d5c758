"""engine.think_ms: what one Langevin iteration adds to the device's
timeline beyond the backbone, in ms: over the window's jobs, the median
across the program's `engine.think_iter` spans of the span's device time
less that of the `model.forward` spans inside it (the half step, CFG's
concat / split / combine, the score, the finish step and casts)."""

import statistics

from portbench.harness.spans import window_jobs


def _think_iter(spans: list, i: int):
    """The index of the think iteration that span i is inside, or None."""
    i = spans[i]["parent"]
    while i is not None and spans[i]["name"] != "engine.think_iter":
        i = spans[i]["parent"]
    return i


def read(run):
    values = []
    for job in window_jobs(run):
        spans = job["spans"]
        inner = {}  # think_iter index -> device ms of its forwards (None: unresolved)
        for i, s in enumerate(spans):
            if s["name"] == "model.forward":
                k = _think_iter(spans, i)
                if k is not None:
                    prev = inner.get(k, 0.0)
                    inner[k] = (None if prev is None or s["device_ms"] is None
                                else prev + s["device_ms"])
        for i, s in enumerate(spans):
            if (s["name"] == "engine.think_iter" and s["device_ms"] is not None
                    and inner.get(i, 0.0) is not None):
                values.append(s["device_ms"] - inner.get(i, 0.0))
    return statistics.median(values) if values else None
