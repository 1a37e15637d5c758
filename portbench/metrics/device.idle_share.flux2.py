"""device.idle_share.flux2: `device.idle_share` in the FLUX.2 cell, over a
slice of FLUX.2 forwards."""

from portbench.harness.files import metric_module

read = metric_module("device.idle_share").read
