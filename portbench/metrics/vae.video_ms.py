"""vae.video_ms: the video VAE's device time a job, in ms: over the
window's jobs, the median of a job's `vae.encode` plus `vae.decode` device
ms, from the program's spans (`api.inpaint_video`).  A program whose video
pipeline opens no such spans gives nothing."""

import statistics

from portbench.harness.spans import window_jobs


def read(run):
    values = []
    for job in window_jobs(run):
        ms = [s["device_ms"] for s in job["spans"] if s["name"] in ("vae.encode", "vae.decode")]
        if len(ms) == 2 and None not in ms:
            values.append(sum(ms))
    return statistics.median(values) if values else None
