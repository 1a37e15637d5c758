"""model.issue_ms.flux2: `model.issue_ms` in the FLUX.2 cell: the host's ms to issue a backbone call
at S = 8,624."""

from portbench.harness.files import metric_module

read = metric_module("model.issue_ms").read
