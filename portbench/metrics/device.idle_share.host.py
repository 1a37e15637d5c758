"""device.idle_share.host: `device.idle_share` in a cell that reports
`job_s.host`, which it moves there."""

from portbench.harness.files import metric_module

read = metric_module("device.idle_share").read
