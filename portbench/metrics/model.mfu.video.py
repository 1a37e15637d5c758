"""model.mfu.video: `model.mfu` in the video cell, over the Wan
configuration's analytic work a DiT forward (`flops`)."""

from portbench.harness.files import metric_module

read = metric_module("model.mfu").read
