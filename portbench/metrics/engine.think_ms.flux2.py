"""engine.think_ms.flux2: `engine.think_ms` in the FLUX.2 cell: the think loop's device ms an iteration beyond the backbone
at S = 8,624."""

from portbench.harness.files import metric_module

read = metric_module("engine.think_ms").read
