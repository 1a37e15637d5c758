"""device.idle_share: the share of the profiled slice of the window in
which no kernel ran on the card, in percent."""


def read(run):
    prof = run.profile
    if prof is None or prof["slice_s"] <= 0 or not prof["kernels"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["slice_s"])
