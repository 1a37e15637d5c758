"""device.idle_share.video: `device.idle_share` in the video cell, over a
slice of Wan DiT forwards."""

from portbench.harness.files import metric_module

read = metric_module("device.idle_share").read
