"""Production serving front end: dynamic micro-batching + HTTP JSON API.

PyTorch counterpart of `lanpaint_tpu/serve.py`.  The reference is an
interactive single-user plugin (one ComfyUI graph execution per request);
this module is the framework's serving story (docs/serving.md): a request
queue feeding a fixed-batch sampler on one CUDA card.

Design:

- Fixed batches.  The eager PyTorch sampler has no compiled programs to
  reuse, but the contract stays the JAX package's: requests carry a
  *variant key* (latent shape, steps, sampler, think steps, ...); the
  batcher only coalesces requests of the same variant and pads partial
  batches to the server's batch size (padded lanes reuse lane 0's inputs
  and are sliced off the result), so every launch of a variant runs at one
  set of kernel shapes and one memory footprint.
- A single worker thread owns the card: it is the only thread that
  launches work on it (the HTTP handler threads decode and validate on the
  host), so batches run back to back without contention for the stream.
  Grad mode is thread-local in PyTorch: the runner disables it itself.
- Dynamic batching window: the worker takes the oldest request, then waits
  up to `max_delay_s` for same-variant requests before launching, trading
  a bounded latency add for up-to-`batch_size`x throughput.

The runner is any callable `runner(requests: list[Request]) -> list[out]`;
`pipeline_runner` adapts a `LanPaintPipeline`.  Serving tests drive a fake
runner (tests/test_torch_serve.py): the batching/queueing layer is
model-agnostic by construction.
"""

from __future__ import annotations

import base64
import json
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


@dataclass(frozen=True)
class Variant:
    """Static-shape key: requests coalesce only within one variant."""

    height: int = 1024
    width: int = 1024
    steps: int = 20
    num_steps: int = 5          # think steps
    sampler_name: str = "euler"
    scheduler: str = "karras"
    cfg: float = 5.0
    # Sequential cond/uncond passes — faster at 1024px+ and halves peak
    # activation memory (docs/serving.md "Video-scale CFG").
    sequential_cfg: bool = False


@dataclass
class Request:
    prompt: str = ""
    negative_prompt: str = ""
    image: Any = None           # (H, W, 3) float array, pixel space
    mask: Any = None            # (H, W) float array, 1 = repaint
    seed: int = 0
    variant: Variant = field(default_factory=Variant)
    extras: Dict[str, Any] = field(default_factory=dict)
    _future: Optional[Future] = None
    _t_submit: float = 0.0


class Stats:
    """Lock-protected serving counters + latency reservoir."""

    def __init__(self, keep: int = 512):
        self._lock = threading.Lock()
        self._lat: List[float] = []
        self._keep = keep
        self.requests = 0
        self.batches = 0
        self.padded_lanes = 0
        self.errors = 0

    def record(self, n_reqs: int, n_pad: int, latencies: List[float]):
        with self._lock:
            self.requests += n_reqs
            self.batches += 1
            self.padded_lanes += n_pad
            self._lat.extend(latencies)
            if len(self._lat) > self._keep:
                self._lat = self._lat[-self._keep:]

    def record_error(self, n: int = 1):
        with self._lock:
            self.errors += n

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            lat = sorted(self._lat)
            pct = (lambda p: lat[min(len(lat) - 1, int(p * len(lat)))]
                   if lat else None)
            return {
                "requests": self.requests,
                "batches": self.batches,
                "padded_lanes": self.padded_lanes,
                "errors": self.errors,
                "latency_p50_s": pct(0.50),
                "latency_p90_s": pct(0.90),
                "latency_p99_s": pct(0.99),
            }


class ProgressBoard:
    """Per-request progress + latest preview, for polling while a request
    is in flight (the reference host's latent_preview role: TAESD/latent
    previews pushed to the UI during sampling).  Thread-safe; bounded."""

    def __init__(self, keep: int = 256):
        self._lock = threading.Lock()
        self._keep = keep
        self._d: Dict[str, Dict[str, Any]] = {}

    def update(self, rid: str, **fields):
        with self._lock:
            entry = self._d.setdefault(rid, {"step": 0, "total": 0,
                                             "done": False, "preview": None})
            entry.update(fields)
            while len(self._d) > self._keep:
                self._d.pop(next(iter(self._d)))

    def get(self, rid: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            e = self._d.get(rid)
            return dict(e) if e is not None else None


def latent_preview_rgb(denoised) -> "Any":
    """Model-agnostic latent -> uint8 RGB preview: up to 3 latent channels,
    per-image normalized.  (The reference's latent2rgb fallback role —
    exact colors need per-model factors; this stays model-agnostic.)"""
    import numpy as np

    if hasattr(denoised, "detach"):  # a torch tensor, possibly bf16 on the card
        denoised = denoised.detach().float().cpu().numpy()
    d = np.asarray(denoised, np.float32)
    if d.ndim == 5:
        d = d[:, :, 0]                      # video: first frame
    rgb = d[:, :3] if d.shape[1] >= 3 else np.repeat(d[:, :1], 3, axis=1)
    lo = rgb.min(axis=(1, 2, 3), keepdims=True)
    hi = rgb.max(axis=(1, 2, 3), keepdims=True)
    rgb = (rgb - lo) / np.maximum(hi - lo, 1e-8)
    return (rgb.transpose(0, 2, 3, 1) * 255).astype(np.uint8)  # (B, h, w, 3)


class InpaintServer:
    """Dynamic micro-batching executor over a single-owner device thread."""

    def __init__(self, runner: Callable[[List[Request]], List[Any]], *,
                 batch_size: int = 4, max_delay_s: float = 0.05,
                 max_queue: int = 256,
                 validator: Optional[Callable[[Request], None]] = None):
        # validator(req) raises to reject a request at submit time — BEFORE
        # it can join a batch.  Shape mismatches must fail the one bad
        # request, not every co-batched lane (see pipeline_validator).
        self.runner = runner
        self.batch_size = batch_size
        self.max_delay_s = max_delay_s
        self.validator = validator
        self.stats = Stats()
        self._q: "queue.Queue[Optional[Request]]" = queue.Queue(max_queue)
        self._pending: List[Request] = []  # same-variant carryover
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="lanpaint-serve-worker")
        self._worker.start()

    # ------------------------------------------------------------- client
    def submit(self, req: Request) -> Future:
        fut: Future = Future()
        req._future = fut
        req._t_submit = time.monotonic()
        if self._stop.is_set():
            fut.set_exception(RuntimeError("server is closed"))
            return fut
        if self.validator is not None:
            try:
                self.validator(req)
            except Exception as e:  # noqa: BLE001 — reject just this request
                fut.set_exception(e)
                self.stats.record_error()
                return fut
        self._q.put(req)
        return fut

    def close(self, timeout: float = 600.0):
        """Stop the worker (waits for the in-flight batch — sampler batches
        run minutes on video variants, so the default timeout is generous)
        and fail any still-queued futures instead of abandoning them."""
        self._stop.set()
        self._q.put(None)
        self._worker.join(timeout)
        leftovers = list(self._pending)
        self._pending.clear()
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                break
            if r is not None:
                leftovers.append(r)
        for r in leftovers:
            if r._future is not None and not r._future.done():
                r._future.set_exception(RuntimeError("server closed"))

    # ------------------------------------------------------------- worker
    def _take_batch(self) -> List[Request]:
        """Oldest request + up-to-batch_size same-variant peers within the
        batching window.  Different-variant arrivals are carried over."""
        batch: List[Request] = []
        if self._pending:
            batch.append(self._pending.pop(0))
        else:
            first = self._q.get()
            if first is None:
                return []
            batch.append(first)
        deadline = time.monotonic() + self.max_delay_s
        variant = batch[0].variant
        while len(batch) < self.batch_size:
            # same-variant carryover first
            took = False
            for i, r in enumerate(self._pending):
                if r.variant == variant:
                    batch.append(self._pending.pop(i))
                    took = True
                    break
            if took:
                continue
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                r = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if r is None:
                self._stop.set()
                break
            if r.variant == variant:
                batch.append(r)
            else:
                self._pending.append(r)
        return batch

    def _loop(self):
        while not self._stop.is_set() or self._pending or not self._q.empty():
            try:
                batch = self._take_batch()
            except Exception:
                continue
            if not batch:
                continue
            try:
                outs = self.runner(batch)
                if len(outs) != len(batch):
                    raise RuntimeError(
                        f"runner returned {len(outs)} outputs for "
                        f"{len(batch)} requests")
                done = time.monotonic()
                lats = [done - r._t_submit for r in batch]
                n_pad = max(0, self.batch_size - len(batch))
                self.stats.record(len(batch), n_pad, lats)
                for r, o in zip(batch, outs):
                    r._future.set_result(o)
            except Exception as e:  # noqa: BLE001 — fail the lanes, keep serving
                self.stats.record_error(len(batch))
                for r in batch:
                    if not r._future.done():
                        r._future.set_exception(e)


# ---------------------------------------------------------------- runners
def _as_chw(img):
    """Accept (3, H, W) or (H, W, 3) pixel images; return (3, H, W).

    The JSON API's canonical layout is channels-first, but browser canvases
    (webui.py) and most image libraries hand out HWC — normalize here so
    one wire format serves both.  3x3x3 ambiguity resolves to CHW (the
    documented contract)."""
    if img.ndim == 3 and img.shape[-1] == 3 and img.shape[0] != 3:
        return img.transpose(2, 0, 1)
    return img


def pipeline_validator(batch_size: int = 4):
    """Submit-time request validation for pipeline_runner: shape mismatches
    must fail the ONE offending request, never its co-batched lanes."""
    import numpy as np

    def validate(req: Request):
        v = req.variant
        img = _as_chw(np.asarray(req.image))
        if img.shape != (3, v.height, v.width):
            raise ValueError(
                f"image shape {img.shape} does not match variant "
                f"(3, {v.height}, {v.width})")
        m = np.asarray(req.mask)
        if m.shape != (v.height, v.width):
            raise ValueError(
                f"mask shape {m.shape} does not match variant "
                f"({v.height}, {v.width})")

    return validate


def pipeline_runner(pipeline, *, batch_size: int = 4,
                    progress: Optional[ProgressBoard] = None,
                    previewer: Optional[Callable] = None,
                    preview_every: int = 2):
    """Adapt a LanPaintPipeline to the server's list-of-requests contract.

    With `progress`, requests that carry extras["request_id"] get per-step
    progress (and every `preview_every` steps a preview image from
    `previewer(denoised_latents) -> (B, h, w, 3) uint8`, default
    latent_preview_rgb) published to the board: pollable over HTTP at
    GET /progress?id=... while the request runs.  The preview costs a host
    sync per outer step, so the callback is only passed when some lane
    asked for progress.

    Per-lane prompts are encoded once each (padding lanes REUSE lane 0's
    conditioning: no duplicate encoder work) and stacked along the batch
    axis with torch.cat; per-lane masks ride the (B, H, W) mask path;
    per-lane seeds feed per-lane initial noise, each lane's drawn on the
    CPU from a torch.Generator seeded with its request's seed (the think
    loop's and the ancestral/SDE solvers' noise come from the batch's
    generator, seeded with lane 0's seed, so those lanes also depend on the
    co-batch composition).  Partial batches are padded by repeating lane 0
    and the padding sliced off the result.  `batch_size` MUST equal the
    server's: checked.  image: (3, H, W) in [-1, 1] per request; mask:
    (H, W), 1 = repaint.  Inputs go to the device of the pipeline's VAE;
    outputs come back as float32 numpy arrays.
    """
    import numpy as np
    import torch

    def _stack_conds(conds: List[Any]):
        if isinstance(conds[0], dict):
            if any(c.keys() != conds[0].keys() for c in conds):
                raise ValueError("the lanes' conds have different keys")
            return {k: _stack_conds([c[k] for c in conds]) for k in conds[0]}
        return torch.cat([torch.as_tensor(c) for c in conds], dim=0)

    def run(batch: List[Request]) -> List[Any]:
        # grad mode is thread-local: the worker thread sets its own
        with torch.no_grad():
            return _run(batch)

    def _run(batch: List[Request]) -> List[Any]:
        v = batch[0].variant
        n = len(batch)
        if n > batch_size:
            raise RuntimeError(
                f"runner compiled for batch_size={batch_size} got {n} "
                "requests — pass the same batch_size to InpaintServer and "
                "pipeline_runner")
        pad = batch_size - n
        lanes = batch + [batch[0]] * pad
        device = next(pipeline.vae.parameters()).device
        images = torch.from_numpy(np.stack([_as_chw(np.asarray(r.image, np.float32))
                                            for r in lanes])).to(device)
        masks = torch.from_numpy(np.stack([np.asarray(r.mask, np.float32)
                                           for r in lanes])).to(device)
        pos = [pipeline.encode(r.prompt) for r in batch]
        neg = [pipeline.encode(r.negative_prompt) for r in batch]
        positive = _stack_conds(pos + [pos[0]] * pad)
        negative = _stack_conds(neg + [neg[0]] * pad)
        # per-lane seeded initial noise at the latent grid (VAE stride 8)
        lat_hw = (getattr(pipeline.model, "latent_channels", 4),
                  v.height // 8, v.width // 8)
        noise = torch.stack([
            torch.randn(lat_hw, generator=torch.Generator().manual_seed(r.seed))
            for r in lanes]).to(device)
        from .api import inpaint_image

        callback = None
        rids = [r.extras.get("request_id") for r in batch]
        if progress is not None and any(rids):
            prev = previewer or latent_preview_rgb
            for rid in rids:
                if rid:
                    progress.update(rid, step=0, total=v.steps, done=False)

            def callback(i, den, x):
                imgs = (prev(den) if (i % max(1, preview_every)) == 0
                        else None)
                for lane, rid in enumerate(rids):
                    if not rid:
                        continue
                    fields: Dict[str, Any] = {"step": int(i) + 1,
                                              "total": v.steps}
                    if imgs is not None:
                        fields["preview"] = _encode_array(imgs[lane])
                    progress.update(rid, **fields)

        # think-loop accounting (the ksampler trace hook): published per
        # request so a client can see the Langevin iterations actually
        # spent per outer step, the serving face of the reference's
        # lanpaint_semantic_trace (earlystop.py:315-334)
        tr: Dict[str, Any] = {} if progress is not None and any(rids) else None
        try:
            outs = inpaint_image(
                pipeline.model, pipeline.vae,
                image=images, mask=masks, positive=positive,
                negative=negative, seed=batch[0].seed, steps=v.steps,
                cfg=v.cfg, sampler_name=v.sampler_name,
                scheduler=v.scheduler, num_steps=v.num_steps,
                sequential_cfg=v.sequential_cfg,
                noise=noise, callback=callback,
                **({"trace": tr} if tr is not None else {}))
        finally:
            if progress is not None:
                think = None
                if tr and tr.get("steps_done") is not None:
                    sd = np.asarray(tr["steps_done"])
                    think = {"think_steps_done": [int(s) for s in sd],
                             "think_steps_total": int(sd.sum())}
                for rid in rids:
                    if rid:
                        progress.update(rid, done=True, **(think or {}))
        outs = torch.as_tensor(outs).float().cpu().numpy()
        return [outs[i] for i in range(n)]

    return run


# ---------------------------------------------------------------- HTTP API
def _encode_array(a) -> Dict[str, Any]:
    import numpy as np

    a = np.asarray(a)
    return {"shape": list(a.shape), "dtype": str(a.dtype),
            "data_b64": base64.b64encode(a.tobytes()).decode()}


def _decode_array(d):
    import numpy as np

    raw = base64.b64decode(d["data_b64"])
    return np.frombuffer(raw, dtype=d["dtype"]).reshape(d["shape"]).copy()


def make_http_server(server: InpaintServer, host: str = "127.0.0.1",
                     port: int = 8776, request_timeout_s: float = 600.0,
                     progress: Optional[ProgressBoard] = None):
    """HTTP front end (stdlib-only).  Endpoints:

    GET  /         browser front end (webui.INDEX_HTML: mask painting +
                   every Variant field as a form control)
    POST /inpaint  {"prompt": ..., "image": {shape,dtype,data_b64},
                    "mask": {...}, "seed": int, "variant": {...},
                    "request_id": str (optional — enables /progress)}
                   -> {"image": {shape,dtype,data_b64}}
    GET  /healthz  -> {"ok": true}
    GET  /stats    -> serving counters + latency percentiles
    GET  /progress?id=RID  -> {"step", "total", "done", "preview"} while a
                   request with that request_id runs (needs a `progress`
                   board shared with pipeline_runner)

    Returns an http.server.ThreadingHTTPServer; call .serve_forever() (or
    run it in a thread) and .shutdown() to stop.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, obj: Dict[str, Any]):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True})
            elif self.path == "/stats":
                self._json(200, server.stats.snapshot())
            elif self.path.startswith("/progress"):
                from urllib.parse import parse_qs, urlparse

                rid = parse_qs(urlparse(self.path).query).get("id", [""])[0]
                entry = progress.get(rid) if (progress and rid) else None
                if entry is None:
                    self._json(404, {"error": "unknown request id"})
                else:
                    self._json(200, entry)
            elif self.path in ("/", "/index.html"):
                from . import webui

                body = webui.INDEX_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/inpaint":
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(n))
                req = Request(
                    prompt=payload.get("prompt", ""),
                    negative_prompt=payload.get("negative_prompt", ""),
                    image=_decode_array(payload["image"]),
                    mask=_decode_array(payload["mask"]),
                    seed=int(payload.get("seed", 0)),
                    variant=Variant(**payload.get("variant", {})),
                )
                if payload.get("request_id"):
                    req.extras["request_id"] = str(payload["request_id"])
                out = server.submit(req).result(timeout=request_timeout_s)
                import numpy as np

                out = np.asarray(out)
                img_in = np.asarray(req.image)
                # reply in the caller's layout: HWC request -> HWC response
                if (img_in.ndim == 3 and img_in.shape[-1] == 3
                        and img_in.shape[0] != 3 and out.ndim == 3
                        and out.shape[0] == 3):
                    out = out.transpose(1, 2, 0)
                self._json(200, {"image": _encode_array(out)})
            except Exception as e:  # noqa: BLE001 — surface as 500
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)
