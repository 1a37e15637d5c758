"""sampler.nonmodel_share.flux2: `sampler.nonmodel_share` in the FLUX.2 cell: the share of the window outside the backbone's forwards
at S = 8,624."""

from portbench.harness.files import metric_module

read = metric_module("sampler.nonmodel_share").read
