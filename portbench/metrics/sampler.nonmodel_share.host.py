"""sampler.nonmodel_share.host: `sampler.nonmodel_share` in a cell that reports
`job_s.host`, which it moves there."""

from portbench.harness.files import metric_module

read = metric_module("sampler.nonmodel_share").read
