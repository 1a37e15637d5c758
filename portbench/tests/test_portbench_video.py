"""The video cell (`wan22-ti2v-5b.video`): a traced run at tiny sizes on
the CPU, the five new readers on synthetic runs and on a program without
the video spans, a traced run on the card that every new reader reads,
and the reference's independence of JAX and the port."""

import math
import re
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from portbench.harness import files, peaks, runner

CELL = "wan22-ti2v-5b.video"
READERS = ("vae.video_ms", "model.mfu.video", "kernels.attention_roofline.video",
           "model.forward_ms.video", "device.idle_share.video")
VAE = {"dim": 8, "z_channels": 4, "dim_mult": [1, 2, 2], "num_res_blocks": 1,
       "temporal_downsample": [True, False], "patch": 2, "stage_shortcuts": True}
TINY = {"name": "wan22-ti2v-5b", "family": "wan", "in_channels": 4, "out_channels": 4,
        "hidden": 64, "num_heads": 4, "depth": 2, "ffn_dim": 128, "context_dim": 32,
        "patch": [1, 2, 2], "axes_dim": [8, 4, 4], "eps": 1e-6, "shift": 5.0,
        "dtype": "bfloat16", "num_frames": 5, "height": 64, "width": 64, "context_tokens": 8,
        "vae": VAE, "latent_shape": [4, 3, 8, 8]}
# S = 3 x 16 x 24 = 1,152 tokens of D = 64: the card's flash-attention kernel
SMALL = dict(TINY, hidden=128, num_heads=2, ffn_dim=256, context_dim=64, axes_dim=[24, 20, 20],
             height=256, width=384, context_tokens=16, latent_shape=[4, 3, 32, 48])


def _traffic():
    return dict(files.traffic(CELL), steps=4, think=2, warmup_steps=2, profile_forwards=[2, 3])


def _run(sizes, device, trace=True):
    return runner.run_cell(CELL, 2**31 + 77, 0.0, trace, t0=time.perf_counter(),
                           device=device, sizes=sizes, traffic=_traffic())


def test_traced_tiny_run_is_correct_and_reads_no_device_metric_on_the_cpu():
    out = _run(TINY, "cpu")
    assert out["correct"], out["checks"]
    assert sorted(out["checks"]) == ["blend_err", "decode_err", "encode_err", "known_err",
                                     "step_err"]
    assert out["checks"]["known_err"]["value"] == out["checks"]["blend_err"]["value"] == 0.0
    assert not set(READERS) & set(out["metrics"])


def _span(name, parent, device_ms):
    return {"name": name, "parent": parent, "start_ms": 0.0, "host_ms": 1.0,
            "device_ms": device_ms, "attrs": {}}


def _video_record(encode_ms, decode_ms):
    spans = [_span("pipeline.video", None, 1e4), _span("vae.encode", 0, encode_ms),
             _span("sampler.job", 0, 9e3), _span("model.forward", 2, 500.0),
             _span("vae.decode", 0, decode_ms), _span("video.blend", 0, 2.0)]
    return {"host_ms": 1e4, "device_ms": 1e4, "attrs": {}, "spans": spans}


def _read(name, run):
    return files.metric_module(name).read(run)


def test_vae_video_ms_reads_the_window_jobs(monkeypatch):
    from lanpaint_tpu_torch import telemetry

    jobs = [_video_record(100.0, 900.0), _video_record(300.0, 900.0),
            _video_record(200.0, 1000.0), _video_record(None, 1000.0)]
    monkeypatch.setattr(telemetry, "jobs", lambda last=None: jobs[len(jobs) - last:])
    # the warm-up's 1,000 ms left out; a job whose encode did not resolve too
    assert _read("vae.video_ms", SimpleNamespace(jobs=3)) == 1200.0
    assert _read("vae.video_ms", SimpleNamespace(jobs=1)) is None
    # a program whose video path opens no VAE spans (its sampler's record only)
    image = {"host_ms": 1.0, "device_ms": 1.0, "attrs": {},
             "spans": [_span("sampler.job", None, 1.0)]}
    monkeypatch.setattr(telemetry, "jobs", lambda last=None: [image] * last)
    assert _read("vae.video_ms", SimpleNamespace(jobs=2)) is None


def test_vae_video_ms_without_the_recorder(monkeypatch):
    monkeypatch.setitem(sys.modules, "lanpaint_tpu_torch.telemetry", None)
    import lanpaint_tpu_torch

    monkeypatch.delattr(lanpaint_tpu_torch, "telemetry", raising=False)
    assert _read("vae.video_ms", SimpleNamespace(jobs=3)) is None


def test_re_exports_read_the_wan_configuration():
    config = files.config_module("wan22-ti2v-5b")
    sizes = files.config_sizes("wan22-ti2v-5b")
    prof = {"slice_s": 6.0, "busy_s": 5.88, "forwards": 12, "kernels": 10,
            "by_class": {"attention": 1.0, "gemm": 4.0}}
    run = SimpleNamespace(window_s=30.0, jobs=1, forward_ms=[510.0] * 58, batches=[2] * 58,
                          profile=prof, sizes=sizes, config=config)
    mfu = 100 * 58 * config.flops(sizes, 2) / 30.0 / peaks.PEAK_BF16
    assert _read("model.mfu.video", run) == pytest.approx(mfu)
    assert 30 < mfu < 40  # a 30-s job of 58 forwards of ~187 TFLOP
    bound = peaks.attention_bound_s([(2, 24, 7920, 7920, 128, 30 * 12)])
    assert _read("kernels.attention_roofline.video", run) == pytest.approx(100 * bound)
    assert _read("model.forward_ms.video", run) == 510.0
    assert _read("device.idle_share.video", run) == pytest.approx(2.0)


def test_references_import_no_jax_nor_the_port():
    """In a fresh interpreter, the video reference, the cell's comparison,
    entry and configuration load none of JAX, the JAX package or the
    port; the two reference files name neither."""
    code = ("import sys; sys.path.insert(0, %r);"
            "import portbench.reference.wan, portbench.reference.wan_vae,"
            " portbench.reference.video, portbench.harness.video;"
            "from portbench.harness import files, nojax;"
            "files.entry_module('inpaint_video'); files.config_module('wan22-ti2v-5b');"
            "print(nojax.loaded(), sorted(n for n in sys.modules"
            " if n.split('.')[0] == 'lanpaint_tpu_torch'))") % str(files.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] []"
    imports = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|lanpaint_tpu)", re.M)
    for name in ("wan.py", "wan_vae.py", "video.py"):
        assert not imports.search((files.BENCH / "reference" / name).read_text()), name


@pytest.mark.card
def test_on_the_card_every_new_reader_reads_a_traced_run():
    """At small sizes on the card (S = 1,152, the flash-attention kernel):
    the run is correct and each of the five new metrics is a finite
    number, the shares under 100%."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = _run(SMALL, "cuda")
    assert out["correct"], out["checks"]
    values = {k: out["metrics"].get(k, {}).get("value") for k in READERS}
    assert all(v is not None and math.isfinite(v) for v in values.values()), values
    assert values["model.mfu.video"] < 100 and values["kernels.attention_roofline.video"] < 100
