"""job_s: the window's seconds over the jobs it completed (host clock)."""


def read(run):
    return run.window_s / run.jobs if run.jobs else None
