"""engine.think_ms.host: `engine.think_ms` in a cell that reports
`job_s.host`, which it moves there."""

from portbench.harness.files import metric_module

read = metric_module("engine.think_ms").read
