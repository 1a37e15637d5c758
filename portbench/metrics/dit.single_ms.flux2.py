"""dit.single_ms.flux2: the device time of FLUX.2's single-stream blocks a
forward, in ms: over the window's jobs, the median device ms of the
program's `dit.single` spans (one a forward, `models/flux2.py`).  A
program that opens no such span gives nothing."""

from portbench.harness.files import metric_module


def read(run):
    return metric_module("dit.double_ms.flux2").median_ms(run, "dit.single")
