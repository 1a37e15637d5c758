"""Each metric reader on synthetic runs, and the trace reduction on a
synthetic profiler trace."""

import json
from types import SimpleNamespace

import pytest

from portbench.harness import files, kernels, peaks, trace
from portbench.tests import tiny


def _run(**kw):
    base = dict(window_s=10.0, setup_s=20.0, jobs=4, forward_ms=[], batches=[], profile=None,
                sizes=tiny.SIZES["flux-dev-1024"], config=files.config_module("flux-dev-1024"))
    base.update(kw)
    return SimpleNamespace(**base)


def read(name, run):
    return files.metric_module(name).read(run)


def test_end_to_end():
    assert read("job_s", _run()) == 2.5
    assert read("job_s", _run(jobs=0)) is None
    assert read("setup_s", _run()) == 20.0


def test_spans():
    run = _run(forward_ms=[100.0, 300.0], batches=[1, 1], window_s=0.5)
    assert read("model.forward_ms", run) == 200.0
    assert read("sampler.nonmodel_share", run) == pytest.approx(20.0)
    flops = 2 * run.config.flops(run.sizes, 1)
    assert read("model.mfu", run) == pytest.approx(100 * flops / 0.5 / peaks.PEAK_BF16)
    empty = _run()
    assert all(read(n, empty) is None
               for n in ("model.forward_ms", "sampler.nonmodel_share", "model.mfu"))


def test_profile_readers():
    prof = {"slice_s": 2.0, "busy_s": 1.5, "forwards": 3, "kernels": 10,
            "by_class": {"attention": 0.01, "gemm": 1.0}}
    run = _run(profile=prof, batches=[1, 1, 1])
    assert read("device.idle_share", run) == pytest.approx(25.0)
    calls = run.config.attention_calls(run.sizes, 1)
    want = 100 * peaks.attention_bound_s([c[:5] + (3 * c[5],) for c in calls]) / 0.01
    assert read("kernels.attention_roofline", run) == pytest.approx(want)
    # a reader that finds nothing returns nothing, never 0
    no_attention = dict(prof, by_class={"gemm": 1.0})
    assert read("kernels.attention_roofline", _run(profile=no_attention, batches=[1])) is None
    assert read("device.idle_share", _run(profile=dict(prof, kernels=0))) is None
    assert read("device.idle_share", _run()) is None


def test_union():
    assert trace.union_s([(0, 10), (5, 15), (20, 30)]) == pytest.approx(25e-6)
    assert trace.union_s([(0, 10), (2, 3)]) == pytest.approx(10e-6)
    assert trace.union_s([]) == 0.0


def test_kernel_classes():
    assert kernels.kernel_class("void flash_fwd_kernel<64>(CUtensorMap)") == "attention"
    assert kernels.kernel_class("pytorch_flash::flash_fwd_kernel") == "attention"
    assert kernels.kernel_class("fmha_cutlassF_bf16_aligned_64x128") == "attention"
    assert kernels.kernel_class("void row_norm_kernel<bf16>") == "row_norm"
    assert kernels.kernel_class("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNT") == "gemm"
    assert kernels.kernel_class("sm90_xmma_fprop_implicit_gemm_bf16") == "conv"
    assert kernels.kernel_class("at::native::vectorized_elementwise_kernel<4>") == "elementwise"
    assert kernels.kernel_class("something_else") == "other"


class _Prof:
    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def test_reduce_profile():
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 50},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10, "dur": 5,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "nvjet_gemm", "ts": 20, "dur": 100,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 150, "dur": 30},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 160, "dur": 5,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "vectorized_elementwise_kernel", "ts": 170,
         "dur": 10, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "ts": 300, "dur": 5,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "flash_fwd_kernel", "ts": 400, "dur": 40,
         "args": {"correlation": 3}},
    ]
    p = trace.reduce_profile(_Prof(ev), 0.001, 2)
    assert p["busy_s"] == pytest.approx(150e-6)
    assert p["by_class"] == pytest.approx({"gemm": 100e-6, "elementwise": 10e-6,
                                           "attention": 40e-6})
    assert p["kernels"] == 3 and p["forwards"] == 2 and p["slice_s"] == 0.001
    assert p["device_ops"][0] == ["gemm", pytest.approx(100e-6)]
    gaps = dict(p["idle_gaps"])
    assert gaps["aten::add"] == pytest.approx(50e-6)
    assert gaps["outside any aten op: cuLaunchKernel"] == pytest.approx(220e-6)


def test_closed_loop_counts_each_request():
    from portbench.harness import window

    w = window.closed_loop(lambda i: True, 0.0, lambda: None)
    assert (w.attempted, w.failed, len(w.latencies)) == (1, 0, 1)

    def raises(i):
        raise RuntimeError("planted")

    w = window.closed_loop(raises, 0.0, lambda: None)
    assert (w.attempted, w.failed) == (1, 1)
    w = window.closed_loop(lambda i: i % 2 == 0, 0.05, lambda: None)
    assert w.attempted == len(w.latencies) > 1 and w.failed == w.attempted // 2
    assert w.window_s >= 0.05


def test_runner_hands_the_entry_window_to_the_readers(monkeypatch):
    """An entry of its own way of offering load (several clients, open
    arrivals) needs no edit of the runner: it returns its window, and the
    readers get its latencies."""
    from portbench.harness import runner, window

    seen = {}

    def read_latencies(run):
        seen["latencies"] = list(run.latencies)
        return run.window_s / run.jobs

    entry = SimpleNamespace(
        setup=lambda ctx: setattr(ctx, "module", None),
        run_window=lambda ctx, s, sync: window.Window(attempted=4, failed=0, window_s=8.0,
                                                      latencies=[1.0, 2.0, 3.0, 4.0]),
        check=lambda ctx: {"numbers": {"step_err": 0.0}})
    bench = {"workloads": [{"name": "x.y", "config": "flux-dev-1024", "traffic": "y",
                            "chips": 1}],
             "end_to_end": [{"name": "job_s", "unit": "s/job"}], "per_layer": []}
    monkeypatch.setattr(files, "entry_module", lambda name: entry)
    monkeypatch.setattr(files, "metric_module",
                        lambda name: SimpleNamespace(read=read_latencies))
    out = runner.run_cell("x.y", 1, 0.0, False, t0=0.0, device="cpu", bench=bench,
                          sizes={}, traffic={"entry": "any", "limits": {"step_err": 0.1}})
    assert out["correct"] and out["attempted"] == 4
    assert out["metrics"]["job_s"]["value"] == 2.0
    assert seen["latencies"] == [1.0, 2.0, 3.0, 4.0]
