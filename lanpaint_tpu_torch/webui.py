"""Browser front end for the serving API (the framework's L5 layer).

The reference ships a web extension (reference web/lanpaint_info.js) that
decorates its four ComfyUI nodes inside ComfyUI's canvas UI; a standalone
framework has no host canvas, so its web layer is a self-contained
single-page app served by `serve.make_http_server` at `GET /`:

- load an image, paint the repaint mask with a brush (the MaskEditor role
  ComfyUI provides the reference for free),
- set the LanPaint sampler parameters (the node-widget role) — every
  `serve.Variant` field is a form control,
- POST /inpaint with the same base64 float32 tensor envelope the JSON API
  uses (the page is also living documentation of the wire format), and
- watch /stats live (batching counters + latency percentiles).

Zero build step, zero dependencies: one HTML string, stdlib http.server.
Keeping it a Python string (not package data) keeps wheel-building and
`pip install -e` trivially correct.
"""

from __future__ import annotations

SAMPLERS = (
    "euler", "euler_ancestral", "heun", "heunpp2", "dpm_2",
    "dpm_2_ancestral", "ddpm", "dpmpp_2m", "dpmpp_2m_sde", "dpmpp_3m_sde",
    "dpmpp_sde", "res_multistep", "res_multistep_ancestral", "seeds_2",
    "seeds_3", "er_sde", "gradient_estimation", "deis", "dpm_fast",
)
SCHEDULERS = (
    "karras", "exponential", "normal", "sgm_uniform", "simple",
    "ddim_uniform", "beta", "linear_quadratic", "kl_optimal",
)

_OPTIONS_SAMPLER = "".join(
    f'<option value="{s}"{" selected" if s == "euler" else ""}>{s}</option>'
    for s in SAMPLERS)
_OPTIONS_SCHEDULER = "".join(
    f'<option value="{s}"{" selected" if s == "karras" else ""}>{s}</option>'
    for s in SCHEDULERS)


INDEX_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>LanPaint TPU</title>
<style>
  :root { color-scheme: dark; }
  body { font: 14px/1.4 system-ui, sans-serif; margin: 0; background: #111;
         color: #ddd; display: flex; flex-wrap: wrap; gap: 16px;
         padding: 16px; }
  h1 { font-size: 18px; margin: 0 0 8px; }
  .panel { background: #1a1a1f; border: 1px solid #2a2a33;
           border-radius: 8px; padding: 12px; }
  #stage { position: relative; }
  #stage canvas { position: absolute; left: 0; top: 0; border-radius: 4px; }
  #stage canvas#maskc { opacity: 0.55; cursor: crosshair; }
  label { display: block; margin: 6px 0 2px; color: #9a9aa5; }
  input, select, textarea, button { width: 100%; box-sizing: border-box;
    background: #0e0e12; color: #ddd; border: 1px solid #33333d;
    border-radius: 4px; padding: 5px 7px; }
  textarea { resize: vertical; min-height: 44px; }
  button { cursor: pointer; background: #243049; }
  button:hover { background: #2e3d5e; }
  .row { display: flex; gap: 8px; } .row > div { flex: 1; }
  #status { margin-top: 8px; min-height: 18px; color: #8fc98f; }
  #status.err { color: #d98080; }
  #stats { font-family: ui-monospace, monospace; font-size: 12px;
           white-space: pre; color: #8888a0; }
  .tools { display: flex; gap: 8px; margin-top: 8px; align-items: center; }
  .tools > * { width: auto; }
</style>
</head>
<body>
<div class="panel" style="flex: 0 0 auto">
  <h1>LanPaint TPU &mdash; inpaint</h1>
  <div id="stage" style="width:512px;height:512px">
    <canvas id="imgc" width="512" height="512"></canvas>
    <canvas id="maskc" width="512" height="512"></canvas>
  </div>
  <div class="tools">
    <input type="file" id="file" accept="image/*">
    <label style="margin:0">brush</label>
    <input type="range" id="brush" min="4" max="128" value="32"
           style="width:100px">
    <button id="erase" style="width:auto">erase: off</button>
    <button id="clear" style="width:auto">clear mask</button>
  </div>
  <div id="status">load an image, paint the region to repaint</div>
  <h1 style="margin-top:12px">result</h1>
  <canvas id="outc" width="512" height="512"
          style="border-radius:4px;background:#000"></canvas>
</div>
<div class="panel" style="flex: 1 1 300px; max-width: 420px">
  <label for="prompt">prompt</label>
  <textarea id="prompt"></textarea>
  <label for="negative_prompt">negative prompt</label>
  <textarea id="negative_prompt"></textarea>
  <div class="row">
    <div><label for="height">height</label>
      <input id="height" type="number" value="512" step="64"></div>
    <div><label for="width">width</label>
      <input id="width" type="number" value="512" step="64"></div>
    <div><label for="seed">seed</label>
      <input id="seed" type="number" value="0"></div>
  </div>
  <div class="row">
    <div><label for="steps">steps</label>
      <input id="steps" type="number" value="20"></div>
    <div><label for="num_steps">think steps</label>
      <input id="num_steps" type="number" value="5"></div>
    <div><label for="cfg">cfg</label>
      <input id="cfg" type="number" value="5.0" step="0.5"></div>
  </div>
  <div class="row">
    <div><label for="sampler_name">sampler</label>
      <select id="sampler_name">__SAMPLERS__</select></div>
    <div><label for="scheduler">scheduler</label>
      <select id="scheduler">__SCHEDULERS__</select></div>
  </div>
  <div class="row">
    <div><label for="sequential_cfg">sequential cfg</label>
      <select id="sequential_cfg">
        <option value="false" selected>off</option>
        <option value="true">on</option>
      </select></div>
  </div>
  <button id="go" style="margin-top:12px">inpaint</button>
  <h1 style="margin-top:16px">serving stats</h1>
  <div id="stats">&mdash;</div>
</div>
<script>
"use strict";
const $ = id => document.getElementById(id);
const imgc = $("imgc"), maskc = $("maskc"), outc = $("outc");
const ictx = imgc.getContext("2d"), mctx = maskc.getContext("2d");
let haveImage = false, painting = false, erasing = false;

function setSize(w, h) {
  for (const c of [imgc, maskc, outc]) { c.width = w; c.height = h; }
  $("stage").style.width = w + "px";
  $("stage").style.height = h + "px";
}

$("file").addEventListener("change", ev => {
  const f = ev.target.files[0];
  if (!f) return;
  const img = new Image();
  img.onload = () => {
    const w = +$("width").value, h = +$("height").value;
    setSize(w, h);
    ictx.drawImage(img, 0, 0, w, h);
    haveImage = true;
    status("image loaded \\u2014 paint the mask");
  };
  img.src = URL.createObjectURL(f);
});

function paint(ev) {
  const r = maskc.getBoundingClientRect();
  const x = ev.clientX - r.left, y = ev.clientY - r.top;
  mctx.globalCompositeOperation = erasing ? "destination-out" : "source-over";
  mctx.fillStyle = "#e33";
  mctx.beginPath();
  mctx.arc(x, y, +$("brush").value / 2, 0, 2 * Math.PI);
  mctx.fill();
}
maskc.addEventListener("mousedown", ev => { painting = true; paint(ev); });
maskc.addEventListener("mousemove", ev => { if (painting) paint(ev); });
window.addEventListener("mouseup", () => { painting = false; });
$("clear").onclick = () => mctx.clearRect(0, 0, maskc.width, maskc.height);
$("erase").onclick = () => {
  erasing = !erasing;
  $("erase").textContent = "erase: " + (erasing ? "on" : "off");
};

function status(msg, err) {
  $("status").textContent = msg;
  $("status").className = err ? "err" : "";
}

// -- float32 tensor <-> base64 (the /inpaint wire format) --------------------
function b64encode(f32) {
  const u8 = new Uint8Array(f32.buffer);
  let s = "";
  for (let i = 0; i < u8.length; i += 0x8000)
    s += String.fromCharCode.apply(null, u8.subarray(i, i + 0x8000));
  return btoa(s);
}
function b64decode(s) {
  const bin = atob(s), u8 = new Uint8Array(bin.length);
  for (let i = 0; i < bin.length; i++) u8[i] = bin.charCodeAt(i);
  return new Float32Array(u8.buffer);
}

function grabTensors() {
  const w = imgc.width, h = imgc.height;
  const px = ictx.getImageData(0, 0, w, h).data;
  const mk = mctx.getImageData(0, 0, w, h).data;
  const img = new Float32Array(h * w * 3), mask = new Float32Array(h * w);
  for (let i = 0; i < h * w; i++) {
    img[3 * i]     = px[4 * i]     / 127.5 - 1;
    img[3 * i + 1] = px[4 * i + 1] / 127.5 - 1;
    img[3 * i + 2] = px[4 * i + 2] / 127.5 - 1;
    mask[i] = mk[4 * i + 3] > 0 ? 1 : 0;
  }
  return {
    image: { shape: [h, w, 3], dtype: "float32", data_b64: b64encode(img) },
    mask:  { shape: [h, w],    dtype: "float32", data_b64: b64encode(mask) },
  };
}

function showResult(t) {
  const [h, w] = t.shape;
  const f32 = b64decode(t.data_b64);
  outc.width = w; outc.height = h;
  const od = outc.getContext("2d").createImageData(w, h);
  for (let i = 0; i < h * w; i++) {
    for (let c = 0; c < 3; c++) {
      const v = Math.max(-1, Math.min(1, f32[3 * i + c]));
      od.data[4 * i + c] = Math.round((v + 1) * 127.5);
    }
    od.data[4 * i + 3] = 255;
  }
  outc.getContext("2d").putImageData(od, 0, 0);
}

$("go").onclick = async () => {
  if (!haveImage) { status("load an image first", true); return; }
  const payload = {
    prompt: $("prompt").value,
    negative_prompt: $("negative_prompt").value,
    seed: +$("seed").value,
    variant: {
      height: imgc.height, width: imgc.width,
      steps: +$("steps").value, num_steps: +$("num_steps").value,
      sampler_name: $("sampler_name").value,
      scheduler: $("scheduler").value, cfg: +$("cfg").value,
      sequential_cfg: $("sequential_cfg").value === "true",
    },
    ...grabTensors(),
  };
  const rid = "web-" + Math.random().toString(36).slice(2);
  payload.request_id = rid;
  status("sampling\\u2026");
  $("go").disabled = true;
  const poll = setInterval(async () => {
    try {
      const r = await fetch("/progress?id=" + rid);
      if (!r.ok) return;
      const p = await r.json();
      if (p.total) status("sampling\\u2026 step " + p.step + "/" + p.total);
      if (p.preview) showPreview(p.preview);
    } catch (e) { /* server busy; keep last */ }
  }, 1500);
  try {
    const rsp = await fetch("/inpaint", {
      method: "POST", body: JSON.stringify(payload),
      headers: { "Content-Type": "application/json" },
    });
    const out = await rsp.json();
    if (!rsp.ok) throw new Error(out.error || rsp.statusText);
    showResult(out.image);
    status("done");
  } catch (e) {
    status(String(e), true);
  } finally {
    clearInterval(poll);
    $("go").disabled = false;
  }
};

// low-res latent preview (uint8 HWC) upscaled onto the output canvas
function showPreview(t) {
  const [h, w, c] = t.shape;
  const raw = Uint8Array.from(atob(t.data_b64), ch => ch.charCodeAt(0));
  const tmp = document.createElement("canvas");
  tmp.width = w; tmp.height = h;
  const im = tmp.getContext("2d").createImageData(w, h);
  for (let i = 0; i < h * w; i++) {
    im.data[4 * i] = raw[c * i];
    im.data[4 * i + 1] = raw[c * i + 1];
    im.data[4 * i + 2] = raw[c * i + 2];
    im.data[4 * i + 3] = 255;
  }
  tmp.getContext("2d").putImageData(im, 0, 0);
  const ctx = $("outc").getContext("2d");
  ctx.imageSmoothingEnabled = true;
  ctx.drawImage(tmp, 0, 0, $("outc").width, $("outc").height);
}

async function pollStats() {
  try {
    const s = await (await fetch("/stats")).json();
    $("stats").textContent = JSON.stringify(s, null, 1)
      .replace(/[{}",]/g, "").trim();
  } catch (e) { /* server restarting; keep last */ }
  setTimeout(pollStats, 2000);
}
pollStats();
</script>
</body>
</html>
"""

INDEX_HTML = (INDEX_HTML
              .replace("__SAMPLERS__", _OPTIONS_SAMPLER)
              .replace("__SCHEDULERS__", _OPTIONS_SCHEDULER))
