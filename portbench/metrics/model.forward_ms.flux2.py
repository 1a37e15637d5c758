"""model.forward_ms.flux2: `model.forward_ms` in the FLUX.2 cell: a batch-1
FLUX.2 [dev] forward's device time at S = 8,624."""

from portbench.harness.files import metric_module

read = metric_module("model.forward_ms").read
