"""kernels.attention_roofline.host: `kernels.attention_roofline` in a cell that reports
`job_s.host`, which it moves there."""

from portbench.harness.files import metric_module

read = metric_module("kernels.attention_roofline").read
