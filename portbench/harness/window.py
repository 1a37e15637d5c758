"""The measured window's ways of offering load, for entries to share.

An entry owns its window: `run_window(ctx, seconds, sync)` offers the
cell's load and returns a `Window`.  The window opens when the first
request is sent and closes when the last request sent before `seconds`
had passed has finished.  Every request sent counts in `attempted`; one
that raised or came back wrong in `failed`.  `latencies` holds each
request's seconds from its sending to its answer, in the order sent."""

from __future__ import annotations

import sys
import time
import traceback
from dataclasses import dataclass, field


@dataclass
class Window:
    attempted: int = 0
    failed: int = 0
    window_s: float = 0.0
    latencies: list = field(default_factory=list)


def closed_loop(run_one, seconds: float, sync) -> Window:
    """One client in a closed loop: request i is sent once request i - 1
    has been answered.  `run_one(i)` returns True if its answer is right;
    `sync()` waits for the device."""
    w = Window()
    start = time.perf_counter()
    while w.attempted == 0 or time.perf_counter() - start < seconds:
        t = time.perf_counter()
        try:
            ok = run_one(w.attempted)
        except Exception:  # a request that raises fails alone
            traceback.print_exc(file=sys.stderr)
            ok = False
        sync()
        w.latencies.append(time.perf_counter() - t)
        w.attempted += 1
        w.failed += not ok
    w.window_s = time.perf_counter() - start
    return w
