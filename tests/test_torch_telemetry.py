"""The port's span recorder (`lanpaint_tpu_torch.telemetry`): the spans a
sampling job opens, their nesting, the switch, the kept-job limit, the
profiler annotations, and (on a CUDA card) that recording adds no host
sync.  The card test runs there without this directory's conftest (which
imports JAX): `python -m pytest tests/test_torch_telemetry.py --noconftest
-c portbench/tests/pytest.ini --rootdir . -p no:cacheprovider`."""

import json
import os
import warnings

import numpy as np
import pytest
import torch

from lanpaint_tpu_torch import api, telemetry
from lanpaint_tpu_torch.config import LanPaintConfig, ModelKind
from lanpaint_tpu_torch.models.base import Denoiser
from lanpaint_tpu_torch.sigmas import EpsSigmaTable
from lanpaint_tpu_torch.utils import profile_trace

NAMES = ("sampler.job", "sampler.step", "engine.think_iter", "model.forward")


@pytest.fixture(autouse=True)
def _fresh():
    telemetry.reset()
    telemetry.enable(True)
    yield
    telemetry.reset()
    telemetry.enable(True)


def _toy():
    return Denoiser(apply=lambda x, t, cond: torch.tanh(x) * cond["c"].reshape(-1, 1, 1, 1),
                    kind=ModelKind.EPS, sigma_table=EpsSigmaTable())


def _job(model=None, device="cpu", steps=3, think=2, **kw):
    """A tiny ksampler job: euler karras, CFG 2 (batched unless
    `sequential_cfg`), early stop 1, a square mask."""
    mask = torch.zeros((8, 8), device=device)
    mask[2:6, 2:6] = 1.0
    latent = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 4, 8, 8)).astype(
        np.float32)).to(device)
    return api.ksampler(model or _toy(), seed=4, steps=steps, cfg=2.0, sampler_name="euler",
                        positive={"c": torch.ones(1, device=device)},
                        negative={"c": torch.full((1,), 0.5, device=device)},
                        latent=latent, mask=mask, num_steps=think, **kw)


def _names(job):
    return [s["name"] for s in job["spans"]]


@pytest.mark.parametrize("sequential,forwards", [(False, 7), (True, 14)],
                         ids=["batched", "sequential"])
def test_a_job_opens_its_spans_nested(sequential, forwards):
    """euler 3 steps, think 2, early stop 1: 2 + 2 + 0 think iterations and
    one final denoise a step, so 2·2 + 3 CFG evaluations, each one forward
    batched or two sequential."""
    _job(sequential_cfg=sequential)
    (job,) = telemetry.jobs()
    names = _names(job)
    assert [names.count(n) for n in NAMES] == [1, 3, 4, forwards]
    spans = job["spans"]
    assert spans[0]["name"] == "sampler.job" and spans[0]["parent"] is None
    assert job["attrs"] == {"sampler": "euler", "steps": 3, "batch": 1}

    def ancestors(i):
        while spans[i]["parent"] is not None:
            i = spans[i]["parent"]
            yield spans[i]["name"]

    fwd = [i for i, n in enumerate(names) if n == "model.forward"]
    assert all("sampler.step" in ancestors(i) for i in fwd)
    in_think = [i for i in fwd if "engine.think_iter" in ancestors(i)]
    assert len(in_think) == 4 * (2 if sequential else 1)
    assert [spans[i]["parent"] for i, n in enumerate(names) if n == "sampler.step"] == [0] * 3
    assert [spans[i]["attrs"]["step"] for i, n in enumerate(names) if n == "sampler.step"] == \
        [0, 1, 2]
    assert [spans[i]["attrs"]["i"] for i, n in enumerate(names) if n == "engine.think_iter"] == \
        [0, 1, 0, 1]
    assert {spans[i]["attrs"]["batch"] for i in fwd} == {1 if sequential else 2}
    for s in spans:  # host times only on the CPU; a child starts inside its parent
        assert s["host_ms"] >= 0 and s["device_ms"] is None
        if s["parent"] is not None:
            p = spans[s["parent"]]
            assert p["start_ms"] <= s["start_ms"]
            assert s["start_ms"] + s["host_ms"] <= p["start_ms"] + p["host_ms"] + 1e-6


def _video_job(steps=3):
    """A tiny `inpaint_video` job: the tiny Wan DiT and Wan2.2 VAE, random
    weights, a (1, 3, 5, 32, 32) clip, a square mask on every frame."""
    from lanpaint_tpu_torch.models import video_vae, zoo

    den, _ = zoo.build_tiny_wan(device="cpu", seed=1)
    vae = zoo.build_wan_vae(video_vae.TINY_WAN22_VAE_CONFIG, device="cpu", seed=2)
    clip = torch.from_numpy(np.random.default_rng(4).uniform(
        -1, 1, (1, 3, 5, 32, 32)).astype(np.float32))
    mask = torch.zeros((32, 32))
    mask[8:24, 8:24] = 1.0
    ctx = {"context": torch.ones((1, 6, 32))}
    return api.inpaint_video(den, vae, video=clip, mask=mask, positive=ctx,
                             negative={"context": torch.zeros((1, 6, 32))}, seed=3,
                             steps=steps, num_steps=2, blend_overlap=5)


VIDEO = ("pipeline.video", "vae.encode", "sampler.job", "vae.decode", "video.blend")


def test_a_video_job_is_one_record_nested_as_placed():
    """`pipeline.video` starts the record; the VAE's encode, the sampler's
    own job, the decode and the blend are its children in that order, and
    the sampler's spans sit inside `sampler.job` as in an image job."""
    _video_job()
    (job,) = telemetry.jobs()
    spans = job["spans"]
    names = _names(job)
    assert names[0] == "pipeline.video" and spans[0]["parent"] is None
    assert job["attrs"] == {"frames": 5, "height": 32, "width": 32, "tokens": 3 * 2 * 2}
    top = [s["name"] for s in spans if s["parent"] == 0]
    assert top == list(VIDEO[1:])
    assert [names.count(n) for n in VIDEO] == [1] * 5
    sjob = names.index("sampler.job")
    assert spans[sjob]["attrs"] == {"sampler": "euler", "steps": 3, "batch": 1}
    inner = names[sjob + 1:names.index("vae.decode")]
    assert [inner.count(n) for n in NAMES[1:]] == [3, 4, 7]
    assert all(spans[i]["parent"] == sjob for i, n in enumerate(names) if n == "sampler.step")


def test_a_ksampler_job_alone_is_recorded_as_before():
    """Outside a video pipeline `sampler.job` is the record's root and the
    record holds the sampler's four span names only."""
    _job()
    (job,) = telemetry.jobs()
    assert job["spans"][0]["name"] == "sampler.job" and job["spans"][0]["parent"] is None
    assert set(_names(job)) == set(NAMES)
    assert job["attrs"] == {"sampler": "euler", "steps": 3, "batch": 1}


def test_spans_outside_either_root_are_not_recorded():
    for name in ("vae.encode", "vae.decode", "video.blend", "sampler.step", "model.forward"):
        with telemetry.span(name):
            with telemetry.span("engine.think_iter", i=0):
                pass
    assert telemetry.jobs() == []
    with telemetry.span("pipeline.video", frames=1):
        with telemetry.span("sampler.job"):
            pass
    (job,) = telemetry.jobs()
    assert _names(job) == ["pipeline.video", "sampler.job"]


def test_the_mask_less_path_spans_steps_and_forwards():
    latent = torch.ones((1, 4, 8, 8))
    sam = api.LanPaintSampler(_toy(), config=LanPaintConfig(n_steps=2), cfg=2.0)
    sam(latent=latent, sigmas=[14.6, 5.0, 1.0, 0.0], cond={"c": torch.ones(1)},
        uncond={"c": torch.zeros(1)})
    (job,) = telemetry.jobs()
    assert [_names(job).count(n) for n in NAMES] == [1, 3, 0, 3]


def test_off_records_nothing_and_changes_no_sample():
    on = _job()
    telemetry.reset()
    telemetry.enable(False)
    off = _job()
    assert torch.equal(on, off)
    assert telemetry.jobs() == []
    telemetry.enable(True)
    assert torch.equal(_job(), on) and len(telemetry.jobs()) == 1


def test_keeps_the_last_64_jobs():
    for k in range(100):
        with telemetry.span("sampler.job", k=k):
            with telemetry.span("sampler.step", step=0):
                pass
    kept = telemetry.jobs()
    assert len(kept) == telemetry.KEEP == 64
    assert [j["attrs"]["k"] for j in kept] == list(range(36, 100))
    assert [j["attrs"]["k"] for j in telemetry.jobs(last=3)] == [97, 98, 99]
    assert len(telemetry.jobs(last=100)) == 64
    assert telemetry.jobs(last=0) == []
    # spans outside a job are not recorded
    with telemetry.span("model.forward"):
        pass
    assert len(telemetry.jobs()) == 64


def test_no_record_function_while_the_profiler_is_off(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        calls.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _job()
    assert calls == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _job()
    assert sorted(set(calls)) == sorted(NAMES)
    assert calls.count("model.forward") == 7


def test_profile_trace_holds_the_spans_around_their_ops(tmp_path):
    with profile_trace(str(tmp_path)):
        _job()
    with open(os.path.join(tmp_path, "trace.json")) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    notes = {n: [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") == "user_annotation" and e["name"] == n] for n in NAMES}
    assert [len(notes[n]) for n in NAMES] == [1, 3, 4, 7]

    def inside(t, spans):
        return any(s <= t[0] and t[1] <= e for s, e in spans)

    # the toy model's tanh runs in the forwards, each forward in a step, and
    # the think loop's four iterations each hold one forward
    tanh = [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "cpu_op" and e["name"] == "aten::tanh"]
    assert len(tanh) == 7 and all(inside(t, notes["model.forward"]) for t in tanh)
    assert all(inside(f, notes["sampler.step"]) for f in notes["model.forward"])
    assert sum(inside(f, notes["engine.think_iter"]) for f in notes["model.forward"]) == 4
    ops = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") == "cpu_op"]
    assert sum(inside(o, notes["engine.think_iter"]) for o in ops) > 4 * 10
    assert all(inside(s, notes["sampler.job"]) for s in notes["sampler.step"])


def test_summary_names_the_four_spans_and_the_launch_counters():
    _job()
    _job()
    s = telemetry.summary()
    assert s["jobs"] == 2
    assert sorted(s["spans"]) == sorted(NAMES)
    assert s["spans"]["model.forward"]["count"] == 14
    host = s["spans"]["engine.think_iter"]["host_ms"]
    assert 0 <= host["p50"] <= host["p90"]
    assert s["spans"]["model.forward"]["device_ms"] is None  # no card
    assert sorted(s["launches"]) == sorted([
        "flash_attention", "wide_attention", "layernorm", "rmsnorm", "rmsnorm_rope",
        "fused_half_step", "fused_finish"])
    assert s["rope_launches"] == s["launches"]["rmsnorm_rope"]


def test_flux2_forwards_open_their_block_spans_inside_the_forward():
    """A FLUX.2 forward inside a job opens `dit.double` and then
    `dit.single` inside its `model.forward`, each with the joint sequence's
    tokens and the reference tokens among them as attrs; `summary()` counts
    the spans beside the shared-modulation and SwiGLU counters."""
    from lanpaint_tpu_torch.models import flux2, zoo

    den, _ = zoo.build_flux2(flux2.TINY_FLUX2_CONFIG, device="cpu")
    gen = torch.Generator().manual_seed(6)
    cond = {"context": torch.randn((1, 3, 32), generator=gen),
            "ref_tokens": torch.randn((1, 16, 128), generator=gen)}
    mask = torch.zeros((64, 64))
    mask[16:48, 16:48] = 1.0
    api.ksampler(den, seed=1, steps=2, cfg=1.0, sampler_name="euler", scheduler="simple",
                 positive=cond, negative=None, latent=torch.randn((1, 32, 8, 8), generator=gen),
                 mask=mask, num_steps=1)
    (job,) = telemetry.jobs()
    spans = job["spans"]
    forwards = [i for i, s in enumerate(spans) if s["name"] == "model.forward"]
    blocks = [(i, s) for i, s in enumerate(spans) if s["name"] in ("dit.double", "dit.single")]
    assert len(forwards) == 3 and len(blocks) == 2 * len(forwards)
    for (i, double), (j, single) in zip(blocks[::2], blocks[1::2]):
        assert (double["name"], single["name"]) == ("dit.double", "dit.single")
        assert double["parent"] == single["parent"] and double["parent"] in forwards
        assert double["attrs"] == single["attrs"] == {"tokens": 3 + 16 + 16, "ref_tokens": 16}
    s = telemetry.summary()
    assert s["spans"]["dit.double"]["count"] == s["spans"]["dit.single"]["count"] == 3
    assert s["modulation_calls"] >= 9 and s["swiglu_calls"] >= 3 * 6


def test_custom_distance_trace_rows_keep_their_step_and_threshold():
    """The trace's step column and the custom distance's threshold are made
    on the latent's device without a host copy; their values stay i + 1 and
    the float32 threshold."""
    model = _toy()
    config = LanPaintConfig(n_steps=3, inner_threshold=0.3, record_trace=True,
                            distance_fn=lambda prev, cur, ctx: torch.mean(torch.abs(cur - prev)))
    sam = api.LanPaintSampler(model, config=config, cfg=2.0, return_aux=True)
    mask = torch.zeros((8, 8))
    mask[2:6, 2:6] = 1.0
    _, _, aux = sam(latent=torch.ones((1, 4, 8, 8)), sigmas=[14.6, 5.0, 1.0, 0.0],
                    cond={"c": torch.ones(1)}, uncond={"c": torch.zeros(1)}, mask=mask, seed=1)
    for done, rows in zip(aux.steps_done.tolist(), aux.trace):
        assert torch.equal(rows[:done, 0], torch.arange(1, done + 1, dtype=torch.float32))
        assert torch.equal(rows[:done, 5], torch.full((done,), 0.3, dtype=torch.float32))


@pytest.mark.card
def test_on_the_card_the_recorder_adds_no_host_sync():
    """A tiny job on the card under sync-debug "warn": the recorder on and
    off give the same count of synchronising operations, every event pair
    resolves to a positive time, and the trace rows add no sync a think
    iteration (8 against 4 iterations: the same difference as without)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    model = _toy()

    def syncs(**kw):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                _job(model, device="cuda", **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return sum("synchroniz" in str(w.message) for w in seen)

    syncs()  # warm-up: first-use work off the count
    telemetry.reset()
    on = syncs()
    telemetry.enable(False)
    off = syncs()
    telemetry.enable(True)
    assert on == off
    torch.cuda.synchronize()
    (job,) = telemetry.jobs()
    timed = [s for s in job["spans"] if s["name"] != "sampler.step"]
    assert len(timed) == 1 + 4 + 7
    assert all(s["device_ms"] is not None and s["device_ms"] > 0 for s in timed)
    traced = {think: syncs(think=think, trace={}) for think in (2, 4)}
    plain = {think: syncs(think=think) for think in (2, 4)}
    assert traced[4] - traced[2] == plain[4] - plain[2]
