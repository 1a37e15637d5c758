"""sampler.nonmodel_share: the share of the window outside the backbone's
forward spans (the think loop's arithmetic, CFG, the euler step, the
known-region blend, and the host's waits), in percent."""


def read(run):
    if not run.forward_ms:
        return None
    return 100.0 * (1.0 - sum(run.forward_ms) / 1e3 / run.window_s)
