"""The port's serving layer (lanpaint_tpu_torch.serve): dynamic
micro-batching, variant grouping, the HTTP front end and `pipeline_runner`.

Each scenario of tests/test_serve.py runs here against the port's module:
a fake runner stands in for the sampler (the batching and queueing layer
is model-agnostic), and the `pipeline_runner` scenarios patch the port's
`api.inpaint_image` with a fake of its signature (`model, vae`, torch
tensors in).  Beyond them: the runner hands `inpaint_image` what JAX's
runner hands it on the same requests; on a tiny single-file pipeline of
the port it is bit-equal to `inpaint_image` called directly with the same
stacked inputs and per-lane noise; it runs with grad disabled in the
server's worker thread; and the web UI's sampler and scheduler lists are
the port's registries.
"""

import dataclasses
import http.client
import json
import re
import threading
import time

import numpy as np
import pytest
import torch

import lanpaint_tpu_torch.api as api_mod
import lanpaint_tpu_torch.serve as serve_mod
from lanpaint_tpu_torch.serve import (InpaintServer, Request, Variant, _decode_array,
                                      _encode_array, make_http_server)


def make_echo_runner(log, delay=0.0):
    def run(batch):
        if delay:
            time.sleep(delay)
        log.append([r.prompt for r in batch])
        return [f"out:{r.prompt}" for r in batch]

    return run


def _serve(srv, **kw):
    """An HTTP front end on an ephemeral port, serving in a thread."""
    httpd = make_http_server(srv, port=0, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, httpd.server_address[1]


def test_batching_coalesces_same_variant():
    log = []
    srv = InpaintServer(make_echo_runner(log, delay=0.01), batch_size=4, max_delay_s=0.2)
    futs = [srv.submit(Request(prompt=f"p{i}")) for i in range(4)]
    assert [f.result(5) for f in futs] == [f"out:p{i}" for i in range(4)]
    srv.close()
    assert any(len(b) == 4 for b in log)  # all four arrived within the window
    assert srv.stats.snapshot()["requests"] == 4


def test_variant_isolation():
    log = []
    srv = InpaintServer(make_echo_runner(log), batch_size=4, max_delay_s=0.1)
    va, vb = Variant(steps=20), Variant(steps=30)
    futs = [srv.submit(Request(prompt=f"a{i}", variant=va)) for i in range(2)]
    futs += [srv.submit(Request(prompt=f"b{i}", variant=vb)) for i in range(2)]
    assert sorted(f.result(5) for f in futs) == ["out:a0", "out:a1", "out:b0", "out:b1"]
    srv.close()
    for b in log:  # no batch mixes variants
        assert len({p[0] for p in b}) == 1


def test_runner_error_fails_lanes_and_keeps_serving():
    calls = {"n": 0}

    def run(batch):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("boom")
        return ["ok"] * len(batch)

    srv = InpaintServer(run, batch_size=2, max_delay_s=0.05)
    bad = srv.submit(Request(prompt="x"))
    with pytest.raises(RuntimeError, match="boom"):
        bad.result(5)
    assert srv.submit(Request(prompt="y")).result(5) == "ok"
    srv.close()
    assert srv.stats.snapshot()["errors"] == 1


def test_stats_latency_percentiles():
    srv = InpaintServer(make_echo_runner([]), batch_size=1, max_delay_s=0.01)
    for i in range(5):
        srv.submit(Request(prompt=str(i))).result(5)
    snap = srv.stats.snapshot()
    srv.close()
    assert snap["batches"] == 5
    assert snap["latency_p50_s"] is not None
    assert snap["latency_p99_s"] >= snap["latency_p50_s"]


def test_http_roundtrip():
    srv = InpaintServer(lambda batch: [np.asarray(r.image, np.float32) * 2.0 for r in batch],
                        batch_size=2, max_delay_s=0.01)
    httpd, port = _serve(srv)
    try:
        img = np.arange(12, dtype=np.float32).reshape(3, 2, 2)
        payload = {"prompt": "hi", "image": _encode_array(img),
                   "mask": _encode_array(np.ones((2, 2), np.float32)), "variant": {"steps": 4}}
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("POST", "/inpaint", json.dumps(payload), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        np.testing.assert_array_equal(_decode_array(json.loads(resp.read())["image"]), img * 2.0)
        conn.request("GET", "/healthz")
        assert json.loads(conn.getresponse().read())["ok"] is True
        conn.request("GET", "/stats")
        assert json.loads(conn.getresponse().read())["requests"] == 1
    finally:
        httpd.shutdown()
        srv.close()


def test_http_unknown_variant_field_is_refused_and_serving_goes_on():
    """A variant naming a field `Variant` lacks (the JAX package's
    `chunk_steps`) gets the handler's error reply; the next request is
    served."""
    srv = InpaintServer(lambda batch: [np.asarray(r.image, np.float32) for r in batch],
                        batch_size=1, max_delay_s=0.01)
    httpd, port = _serve(srv)
    try:
        img = np.zeros((3, 2, 2), np.float32)
        payload = {"image": _encode_array(img), "mask": _encode_array(np.ones((2, 2), np.float32))}
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        for variant, status in (({"steps": 4, "chunk_steps": 3}, 500), ({"steps": 4}, 200)):
            conn.request("POST", "/inpaint", json.dumps(dict(payload, variant=variant)),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = json.loads(resp.read())
            assert resp.status == status, body
        assert "chunk_steps" not in body and "image" in body
    finally:
        httpd.shutdown()
        srv.close()


def test_http_hwc_layout_mirrored():
    """An HWC (browser-canvas) request gets an HWC response; the runner
    still sees the canonical CHW layout through _as_chw."""
    srv = InpaintServer(lambda batch: [serve_mod._as_chw(np.asarray(r.image, np.float32)) * 2.0
                                       for r in batch], batch_size=1, max_delay_s=0.01)
    httpd, port = _serve(srv)
    try:
        img_hwc = np.arange(24, dtype=np.float32).reshape(4, 2, 3)
        payload = {"image": _encode_array(img_hwc),
                   "mask": _encode_array(np.ones((4, 2), np.float32)), "variant": {"steps": 2}}
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("POST", "/inpaint", json.dumps(payload), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        out = _decode_array(json.loads(resp.read())["image"])
        assert out.shape == (4, 2, 3)
        np.testing.assert_array_equal(out, img_hwc * 2.0)
    finally:
        httpd.shutdown()
        srv.close()


def test_validator_accepts_hwc():
    v = Variant(height=8, width=6)
    serve_mod.pipeline_validator(batch_size=1)(
        Request(image=np.zeros((8, 6, 3), np.float32), mask=np.zeros((8, 6), np.float32),
                variant=v))
    bad = Request(image=np.zeros((6, 8, 3), np.float32), mask=np.zeros((8, 6), np.float32),
                  variant=v)
    with pytest.raises(ValueError):
        serve_mod.pipeline_validator(batch_size=1)(bad)


def test_web_ui_served_at_root():
    srv = InpaintServer(lambda batch: [r.image for r in batch], batch_size=1, max_delay_s=0.01)
    httpd, port = _serve(srv)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("GET", "/")
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Content-Type").startswith("text/html")
        html = resp.read().decode()
        for f in dataclasses.fields(Variant):
            assert f'id="{f.name}"' in html, f.name
        assert "/inpaint" in html and "/stats" in html and "data_b64" in html
    finally:
        httpd.shutdown()
        srv.close()


def test_web_ui_lists_the_ports_samplers_and_schedulers():
    """The page's sampler list is the port's SAMPLER_NAMES less the _gpu
    aliases, in order, and its scheduler list the port's schedulers."""
    from lanpaint_tpu_torch import webui
    from lanpaint_tpu_torch.samplers import SAMPLER_NAMES
    from lanpaint_tpu_torch.sigmas import SCHEDULERS

    assert list(webui.SAMPLERS) == [s for s in SAMPLER_NAMES if not s.endswith("_gpu")]
    assert sorted(webui.SCHEDULERS) == sorted(SCHEDULERS)
    for s in webui.SAMPLERS + webui.SCHEDULERS:
        assert f'value="{s}"' in webui.INDEX_HTML


def test_web_ui_payload_names_only_variant_fields():
    """The page's request names every `Variant` field and no other, so the
    server takes each form it sends."""
    from lanpaint_tpu_torch import webui

    block = re.search(r"variant: \{(.*?)\}", webui.INDEX_HTML, re.S).group(1)
    assert set(re.findall(r"(\w+):", block)) == {f.name for f in dataclasses.fields(Variant)}


class FakePipe:
    """What pipeline_runner reads of a pipeline: model, vae (its device),
    encode."""

    def __init__(self, ctx_shape=(1, 3, 4), by_length=True):
        self.model = type("M", (), {"latent_channels": 4})()
        self.vae = torch.nn.Linear(1, 1)
        self.ctx_shape, self.by_length = ctx_shape, by_length

    def encode(self, prompt):
        fill = float(len(prompt)) if self.by_length else 0.0
        return {"context": np.full(self.ctx_shape, fill, np.float32)}


@pytest.fixture
def fake_inpaint(monkeypatch):
    """Patch the port's api.inpaint_image; yields the dict its calls fill."""
    seen = {}

    def install(fn):
        def fake(model, vae, *, image, mask, positive, negative, **kw):
            seen.update(image=image, mask=mask, positive=positive, negative=negative, **kw)
            return fn(image=image, positive=positive, **kw)

        monkeypatch.setattr(api_mod, "inpaint_image", fake)
        return seen

    return install


def test_pipeline_runner_stacks_and_pads(fake_inpaint):
    """Per-lane prompts stacked into batched conds, lane-0 padding sliced off."""
    seen = fake_inpaint(lambda image, positive, **kw:
                        image * 0 + positive["context"][:, 0, 0][:, None, None, None])
    run = serve_mod.pipeline_runner(FakePipe(), batch_size=4)
    outs = run([Request(prompt="ab", image=np.zeros((3, 2, 2), np.float32),
                        mask=np.ones((2, 2), np.float32)),
                Request(prompt="abcd", image=np.ones((3, 2, 2), np.float32),
                        mask=np.ones((2, 2), np.float32))])
    assert len(outs) == 2
    assert tuple(seen["image"].shape) == (4, 3, 2, 2)
    assert tuple(seen["positive"]["context"].shape) == (4, 3, 4)
    assert seen["positive"]["context"][0, 0, 0] == 2.0
    assert seen["positive"]["context"][1, 0, 0] == 4.0
    np.testing.assert_array_equal(outs[0], np.full((3, 2, 2), 2.0))
    np.testing.assert_array_equal(outs[1], np.full((3, 2, 2), 4.0))


def _lane_encode(prompt):
    """Prompt encodings that tell every prompt apart, as numpy (the JAX
    pipeline's host conds)."""
    codes = np.array([ord(c) for c in prompt] or [0], np.float32)
    ctx = np.arange(12, dtype=np.float32).reshape(1, 3, 4) + codes.sum() + 0.5 * len(prompt)
    return {"context": ctx, "y": np.full((1, 5), codes.mean(), np.float32)}


def test_pipeline_runner_matches_the_jax_runner(monkeypatch):
    """Both packages' pipeline_runner on one padded batch, each package's
    `api.inpaint_image` replaced by a recorder: the same stacked images
    (one request in HWC), masks, prompt encodings (lane 0 repeated as
    padding), batch seed, variant fields and sliced outputs; the JAX
    package's variant also has `chunk_steps`, which it passes on and the
    port has not.  Only the per-lane noise's values differ (JAX keys against
    torch.Generator)."""
    import lanpaint_tpu.api as japi
    import lanpaint_tpu.serve as jserve

    seen = {}

    def recorder(name):
        def fake(*args, image, mask, positive, negative, **kw):
            seen[name] = dict(args=args, image=image, mask=mask, positive=positive,
                              negative=negative, **kw)
            ctx = positive["context"]
            return image * 0 + ctx[:, 0, 0][:, None, None, None] - negative["y"][:, :1, None, None]

        return fake

    monkeypatch.setattr(japi, "inpaint_image", recorder("jax"))
    monkeypatch.setattr(api_mod, "inpaint_image", recorder("torch"))

    class JaxPipe:
        model, vae_module, vae_params = type("M", (), {"latent_channels": 4})(), "V", "P"
        encode = staticmethod(_lane_encode)

    class PortPipe(FakePipe):
        encode = staticmethod(_lane_encode)

    rng = np.random.default_rng(3)
    v = Variant(height=16, width=24, steps=7, num_steps=2, sampler_name="dpmpp_2m",
                scheduler="simple", cfg=3.5, sequential_cfg=True)
    jv = jserve.Variant(**dataclasses.asdict(v), chunk_steps=3)
    images = [rng.uniform(-1, 1, (3, 16, 24)).astype(np.float32),
              rng.uniform(-1, 1, (16, 24, 3)).astype(np.float32),
              rng.uniform(-1, 1, (3, 16, 24)).astype(np.float32)]
    reqs = [Request(prompt=p, negative_prompt=n, image=im,
                    mask=(rng.uniform(size=(16, 24)) > 0.5).astype(np.float32), seed=seed,
                    variant=v)
            for p, n, im, seed in zip(("a cat", "the dog", "x"), ("", "blurry", "low"), images,
                                      (11, 12, 13))]
    jreqs = [jserve.Request(prompt=r.prompt, negative_prompt=r.negative_prompt, image=r.image,
                            mask=r.mask, seed=r.seed, variant=jv) for r in reqs]
    outs = {"jax": jserve.pipeline_runner(JaxPipe(), batch_size=4)(jreqs),
            "torch": serve_mod.pipeline_runner(PortPipe(), batch_size=4)(reqs)}
    want, got = seen["jax"], seen["torch"]
    assert want["args"] == (JaxPipe.model, "V", "P")
    assert len(got["args"]) == 2 and isinstance(got["args"][1], torch.nn.Module)
    for key in ("image", "mask"):
        assert tuple(got[key].shape) == (4,) + tuple(np.shape(want[key]))[1:]
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    np.testing.assert_array_equal(got["image"][3].numpy(), images[0])  # padding: lane 0
    for side in ("positive", "negative"):
        assert sorted(got[side]) == sorted(want[side]) == ["context", "y"]
        for k in want[side]:
            assert tuple(got[side][k].shape) == np.shape(want[side][k])
            np.testing.assert_array_equal(got[side][k].numpy(), np.asarray(want[side][k]))
    for key in ("seed", "steps", "cfg", "sampler_name", "scheduler", "num_steps",
                "sequential_cfg", "callback"):
        assert got[key] == want[key], key
    assert got["seed"] == 11 and got["callback"] is None and want["chunk_steps"] == 3
    # no trace without progress, in both
    assert sorted(got) == sorted(set(want) - {"chunk_steps"})
    assert tuple(got["noise"].shape) == np.shape(want["noise"]) == (4, 4, 2, 3)
    assert torch.equal(got["noise"][3], got["noise"][0])
    assert len(outs["jax"]) == len(outs["torch"]) == 3
    for a, b in zip(outs["jax"], outs["torch"]):
        np.testing.assert_array_equal(b, np.asarray(a))


def test_validator_rejects_only_bad_request():
    srv = InpaintServer(lambda b: ["ok"] * len(b), batch_size=2, max_delay_s=0.05,
                        validator=serve_mod.pipeline_validator())
    v = Variant(height=16, width=16)
    good = Request(image=np.zeros((3, 16, 16), np.float32), mask=np.zeros((16, 16), np.float32),
                   variant=v)
    bad = Request(image=np.zeros((3, 8, 8), np.float32), mask=np.zeros((16, 16), np.float32),
                  variant=v)
    fb, fg = srv.submit(bad), srv.submit(good)
    with pytest.raises(ValueError, match="image shape"):
        fb.result(5)
    assert fg.result(5) == "ok"
    srv.close()


def test_close_fails_queued_futures():
    gate = threading.Event()

    def slow_runner(batch):
        gate.wait(10)
        return ["done"] * len(batch)

    srv = InpaintServer(slow_runner, batch_size=1, max_delay_s=0.01)
    first = srv.submit(Request(prompt="a"))
    time.sleep(0.1)
    queued = srv.submit(Request(prompt="b"))
    gate.set()
    srv.close(timeout=5)
    assert first.result(5) == "done"  # work accepted before close() completes
    assert queued.result(5) == "done"
    late = srv.submit(Request(prompt="c"))  # after close: fails at once
    with pytest.raises(RuntimeError, match="closed"):
        late.result(5)


def test_pipeline_runner_per_lane_seeds(fake_inpaint):
    """Distinct request seeds give distinct per-lane initial noise, each
    lane's a torch.Generator draw from its own seed."""
    seen = fake_inpaint(lambda image, **kw: image)
    run = serve_mod.pipeline_runner(FakePipe((1, 2, 3), by_length=False), batch_size=2)
    v = Variant(height=16, width=16)
    run([Request(prompt="a", seed=seed, variant=v, image=np.zeros((3, 16, 16), np.float32),
                 mask=np.ones((16, 16), np.float32)) for seed in (1, 2)])
    noise = seen["noise"]
    assert tuple(noise.shape) == (2, 4, 2, 2)
    assert not torch.allclose(noise[0], noise[1])
    assert torch.equal(noise[1], torch.randn((4, 2, 2), generator=torch.Generator().manual_seed(2)))


def test_pipeline_runner_progress_and_preview(fake_inpaint):
    """Requests carrying a request_id get per-step progress and latent
    previews on the ProgressBoard (from bf16 tensors, as on the card);
    lanes without an id stay silent."""
    def fake(image, callback=None, trace=None, **kw):
        assert callback is not None and trace is not None
        trace["steps_done"] = np.asarray([5, 5, 0])
        lat = torch.arange(image.shape[0] * 16, dtype=torch.float32).reshape(
            image.shape[0], 4, 2, 2).to(torch.bfloat16)
        for i in range(3):
            callback(i, lat, lat)
        return image

    fake_inpaint(fake)
    board = serve_mod.ProgressBoard()
    run = serve_mod.pipeline_runner(FakePipe((1, 2, 2), by_length=False), batch_size=2,
                                    progress=board)
    v = Variant(height=16, width=16, steps=3)
    run([Request(prompt="a", image=np.zeros((3, 16, 16), np.float32),
                 mask=np.ones((16, 16), np.float32), variant=v, extras={"request_id": "r1"}),
         Request(prompt="b", image=np.zeros((3, 16, 16), np.float32),
                 mask=np.ones((16, 16), np.float32), variant=v)])
    e = board.get("r1")
    assert e is not None and e["done"]
    assert e["step"] == 3 and e["total"] == 3
    assert e["preview"] is not None and e["preview"]["shape"] == [2, 2, 3]
    assert e["think_steps_done"] == [5, 5, 0] and e["think_steps_total"] == 10
    assert board.get("") is None


def test_http_progress_endpoint():
    board = serve_mod.ProgressBoard()
    done = threading.Event()

    def run(batch):
        for r in batch:
            if r.extras.get("request_id"):
                board.update(r.extras["request_id"], step=1, total=2)
        done.wait(5)
        return [np.zeros((3, 2, 2), np.float32) for _ in batch]

    srv = InpaintServer(run, batch_size=1, max_delay_s=0.01)
    httpd, port = _serve(srv, progress=board)
    try:
        payload = {"image": _encode_array(np.zeros((3, 2, 2), np.float32)),
                   "mask": _encode_array(np.ones((2, 2), np.float32)),
                   "variant": {"steps": 2}, "request_id": "xyz"}
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("POST", "/inpaint", json.dumps(payload), {"Content-Type": "application/json"})
        for _ in range(100):  # poll while the request is blocked in the runner
            c2 = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
            c2.request("GET", "/progress?id=xyz")
            r2 = c2.getresponse()
            if r2.status == 200:
                prog = json.loads(r2.read())
                break
            r2.read()
            time.sleep(0.05)
        else:
            raise AssertionError("progress never appeared")
        assert prog["step"] == 1 and prog["total"] == 2
        done.set()
        assert conn.getresponse().status == 200
        c3 = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        c3.request("GET", "/progress?id=nope")
        assert c3.getresponse().status == 404
    finally:
        done.set()
        httpd.shutdown()
        srv.close()


def test_runner_disables_grad_in_the_worker_thread(fake_inpaint):
    """Grad mode is thread-local: the runner turns it off itself, in the
    server's worker thread, whatever the submitting thread's mode."""
    modes = []
    fake_inpaint(lambda image, **kw: modes.append(
        (torch.is_grad_enabled(), threading.current_thread().name)) or image)
    srv = InpaintServer(serve_mod.pipeline_runner(FakePipe(), batch_size=1), batch_size=1,
                        max_delay_s=0.01)
    assert torch.is_grad_enabled()
    out = srv.submit(Request(prompt="x", image=np.zeros((3, 8, 8), np.float32),
                             mask=np.ones((8, 8), np.float32),
                             variant=Variant(height=8, width=8))).result(10)
    srv.close()
    assert out.shape == (3, 8, 8)
    assert modes == [(False, "lanpaint-serve-worker")]


# --------------------------------------------------------------------------
# a tiny single-file pipeline of the port (no JAX), shared with test_torch_cli


def tiny_port_pipeline(tmp_path, size=32):
    """An SD1.x-shaped single-file pipeline of tiny port modules (random
    weights from seeds, fp32; the VAE of stride 8, as the runner's latent
    grid assumes), read through `from_single_file` on the CPU."""
    from lanpaint_tpu_torch.models import load as TL
    from lanpaint_tpu_torch.models import textenc as tte
    from lanpaint_tpu_torch.models import unet as tunet
    from lanpaint_tpu_torch.models import vae as tvae
    from lanpaint_tpu_torch.models import zoo as tzoo
    from lanpaint_tpu_torch.pipeline import LanPaintPipeline
    from test_torch_text import _clip_files

    vp, mp, _ = _clip_files(tmp_path)
    ucfg = tunet.UNetConfig(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                            transformer_depth=(1, 1), transformer_depth_middle=1,
                            context_dim=8, head_dim=None, num_heads=2, dtype=torch.float32)
    vcfg = tvae.VAEConfig(ch=32, ch_mult=(1, 1, 1, 1), num_res_blocks=1, dtype=torch.float32)
    ccfg = tte.CLIPTextConfig(vocab_size=49408, width=8, layers=2, heads=2, intermediate=16,
                              projection_dim=0, eos_token_id=49407)
    _, unet = tzoo.build_unet(ucfg, device="cpu", seed=1)
    vae = tzoo.build_vae(vcfg, device="cpu", seed=2)
    clip = tzoo.build_clip(ccfg, device="cpu", seed=3)
    state = {}
    state.update(TL.export_unet(unet.state_dict(), ucfg))
    state.update({"first_stage_model." + k: v
                  for k, v in TL.export_vae(vae.state_dict(), vcfg).items()})
    state.update({"cond_stage_model.transformer." + k: v
                  for k, v in TL.export_clip(clip.state_dict(), ccfg).items()})
    return LanPaintPipeline.from_single_file(
        "<in-memory>", state=state, vocab=vp, merges=mp, unet_config=ucfg, vae_config=vcfg,
        clip_l_config=ccfg, height=size, width=size, device="cpu")


def test_pipeline_runner_equals_inpaint_image_on_a_tiny_pipeline(tmp_path):
    """The runner on a real (tiny) pipeline, one request padded to a batch
    of 2: bit-equal to `inpaint_image` called with the stacked inputs, the
    stacked prompt encodings and each lane's seeded noise."""
    pipe = tiny_port_pipeline(tmp_path)
    rng = np.random.default_rng(0)
    image = rng.uniform(-1, 1, (3, 32, 32)).astype(np.float32)
    mask = np.zeros((32, 32), np.float32)
    mask[12:20, 12:20] = 1.0  # farther than the default blend (9) from rows 0-2
    v = Variant(height=32, width=32, steps=3, num_steps=1)
    req = Request(prompt="the cat", negative_prompt="", image=image, mask=mask, seed=5, variant=v)
    (out,) = serve_mod.pipeline_runner(pipe, batch_size=2)([req])

    lanes = torch.from_numpy(np.stack([image, image]))
    noise = torch.stack([torch.randn((4, 4, 4), generator=torch.Generator().manual_seed(5))] * 2)
    with torch.no_grad():
        want = api_mod.inpaint_image(
            pipe.model, pipe.vae, image=lanes, mask=torch.from_numpy(np.stack([mask, mask])),
            positive={k: torch.cat([t, t]) for k, t in pipe.encode("the cat").items()},
            negative={k: torch.cat([t, t]) for k, t in pipe.encode("").items()}, seed=5,
            steps=3, cfg=v.cfg, sampler_name="euler", scheduler="karras", num_steps=1,
            sequential_cfg=False, noise=noise)
    assert out.dtype == np.float32 and out.shape == (3, 32, 32)
    np.testing.assert_array_equal(out, want[0].numpy())
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out[:, :3], image[:, :3])  # beyond the blend: the source
    assert np.abs(out - image)[:, 12:20, 12:20].mean() > 1e-2
