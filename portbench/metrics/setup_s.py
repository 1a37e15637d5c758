"""setup_s: process start to the window's start (host clock): imports,
the card, the kernels' builds or loads, the weights, the warm-up job."""


def read(run):
    return run.setup_s
