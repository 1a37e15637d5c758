"""kernels.attention_roofline.video: `kernels.attention_roofline` in the
video cell, over the Wan configuration's self-attention calls
(`attention_calls`)."""

from portbench.harness.files import metric_module

read = metric_module("kernels.attention_roofline").read
