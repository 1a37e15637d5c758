"""kernels.attention_roofline.flux2: `kernels.attention_roofline` in the
FLUX.2 cell, over the FLUX.2 configuration's joint self-attention calls
(`attention_calls`: 56 a forward at S = 8,624, 48 heads of D = 128)."""

from portbench.harness.files import metric_module

read = metric_module("kernels.attention_roofline").read
