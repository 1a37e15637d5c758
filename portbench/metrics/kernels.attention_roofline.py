"""kernels.attention_roofline: the least time of the configuration's
self-attention calls in the profiled forwards (each operand read once, the
output written once, against 989 TFLOP/s bf16 and 3.35 TB/s) over the
profiler's device time of the attention class there, in percent."""

from portbench.harness.peaks import attention_bound_s


def read(run):
    prof = run.profile
    if prof is None or not prof["by_class"].get("attention") or not run.batches:
        return None
    b = run.batches[0]
    calls = [c[:5] + (c[5] * prof["forwards"],) for c in run.config.attention_calls(run.sizes, b)]
    return 100.0 * attention_bound_s(calls) / prof["by_class"]["attention"]
