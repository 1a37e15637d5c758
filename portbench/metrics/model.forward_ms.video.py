"""model.forward_ms.video: `model.forward_ms` in the video cell: a batch-2
Wan DiT forward's device time."""

from portbench.harness.files import metric_module

read = metric_module("model.forward_ms").read
