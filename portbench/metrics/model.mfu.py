"""model.mfu: the configuration's analytic FLOPs of every forward of the
window, at its batch, over the window's seconds, as a share of one H100's
bf16 peak, in percent."""

from portbench.harness.peaks import PEAK_BF16


def read(run):
    if not run.batches:
        return None
    flops = sum(run.config.flops(run.sizes, b) for b in run.batches)
    return 100.0 * flops / run.window_s / PEAK_BF16
