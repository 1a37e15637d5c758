"""model.forward_ms: the mean device time of a backbone forward in the
window, from the CUDA events of the forward hooks."""


def read(run):
    return sum(run.forward_ms) / len(run.forward_ms) if run.forward_ms else None
