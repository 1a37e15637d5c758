"""model.mfu.flux2: `model.mfu` in the FLUX.2 cell, over the FLUX.2
configuration's analytic work a forward (`flops`)."""

from portbench.harness.files import metric_module

read = metric_module("model.mfu").read
