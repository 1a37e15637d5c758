"""model.mfu.host: `model.mfu` in a cell that reports
`job_s.host`, which it moves there."""

from portbench.harness.files import metric_module

read = metric_module("model.mfu").read
