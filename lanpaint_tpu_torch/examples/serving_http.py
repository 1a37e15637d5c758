"""Production serving: micro-batched inpaint server with the HTTP JSON API.

Stands up `lanpaint_tpu_torch.serve.InpaintServer` (docs/serving.md) over a
sampler runner and serves POST /inpaint.  With --checkpoint it builds the
full single-file SDXL pipeline; in --smoke mode a tiny random-init UNet
takes the same path so the whole request->batch->sample->response loop is
exercised anywhere.  The reference has no serving story (interactive
ComfyUI graphs only) — this is the framework's deployment surface.

Try it (smoke):
    python -m lanpaint_tpu_torch.examples.serving_http --smoke --port 8776 &
    python - <<'PY'
    import json, http.client, numpy as np
    from lanpaint_tpu_torch.serve import _encode_array, _decode_array
    img = np.zeros((3, 128, 128), np.float32)
    mask = np.zeros((128, 128), np.float32); mask[32:96, 32:96] = 1.0
    conn = http.client.HTTPConnection("127.0.0.1", 8776, timeout=600)
    conn.request("POST", "/inpaint", json.dumps({
        "prompt": "a red fox", "image": _encode_array(img),
        "mask": _encode_array(mask), "variant": {"steps": 8, "num_steps": 2}}),
        {"Content-Type": "application/json"})
    out = _decode_array(json.loads(conn.getresponse().read())["image"])
    print(out.shape)
    PY

Or open http://127.0.0.1:8776/ in a browser: the built-in web UI
(lanpaint_tpu_torch/webui.py) paints masks on a canvas and drives the same API.
"""

import numpy as np
import torch

from lanpaint_tpu_torch.examples.common import example_argparser, example_device, report
from lanpaint_tpu_torch.serve import (
    InpaintServer, Request, Variant, make_http_server, pipeline_runner, pipeline_validator,
)


def smoke_runner(batch_size: int, device):
    """Tiny UNet + ksampler runner: the same contract as pipeline_runner
    but latent-space only (images are downscaled to the latent grid)."""
    from lanpaint_tpu_torch import ksampler
    from lanpaint_tpu_torch.models.unet import TINY_UNET_CONFIG
    from lanpaint_tpu_torch.models.zoo import build_tiny_unet

    model, _ = build_tiny_unet(device=device)
    hw = 16

    def run(batch):
        v = batch[0].variant
        n = len(batch)
        lanes = batch + [batch[0]] * (batch_size - n)
        latent = torch.zeros((batch_size, 4, hw, hw), device=device)
        masks = np.stack([
            np.asarray(r.mask, np.float32)[:: max(1, r.mask.shape[0] // hw),
                                           :: max(1, r.mask.shape[1] // hw)][:hw, :hw]
            for r in lanes])
        cond = {"context": torch.from_numpy(np.stack([
            np.full((8, TINY_UNET_CONFIG.context_dim), float(len(r.prompt)) * 0.01, np.float32)
            for r in lanes])).to(device)}
        out = ksampler(model, seed=batch[0].seed, steps=v.steps, cfg=v.cfg,
                       sampler_name=v.sampler_name, scheduler=v.scheduler,
                       positive=cond, latent=latent, mask=torch.from_numpy(masks),
                       num_steps=v.num_steps)
        out = out.float().cpu().numpy()
        return [out[i] for i in range(n)]

    return run


def main():
    p = example_argparser("LanPaint HTTP serving")
    p.add_argument("--port", type=int, default=8776)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--vocab", default=None)
    p.add_argument("--merges", default=None)
    p.add_argument("--selftest", action="store_true",
                   help="submit two in-process requests and exit")
    args = p.parse_args()
    device = example_device(args)

    validator = None
    if args.checkpoint:
        from lanpaint_tpu_torch.pipeline import LanPaintPipeline

        pipe = LanPaintPipeline.from_single_file(
            args.checkpoint, vocab=args.vocab, merges=args.merges, device=device)
        runner = pipeline_runner(pipe, batch_size=args.batch_size)
        # reject shape-mismatched requests at submit time so one bad
        # payload can't fail its co-batched lanes
        validator = pipeline_validator(args.batch_size)
    else:
        runner = smoke_runner(args.batch_size, device)

    server = InpaintServer(runner, batch_size=args.batch_size,
                           max_delay_s=0.05, validator=validator)

    if args.selftest:
        mask = np.zeros((128, 128), np.float32)
        mask[32:96, 32:96] = 1.0
        futs = [server.submit(Request(
            prompt=p_, image=np.zeros((3, 128, 128), np.float32), mask=mask,
            variant=Variant(steps=6, num_steps=2, cfg=1.0)))
            for p_ in ("a red fox", "a blue bird")]
        outs = [f.result(timeout=600) for f in futs]
        server.close()
        report("serving_selftest", np.stack(outs))
        print("stats:", server.stats.snapshot())
        return

    httpd = make_http_server(server, port=args.port)
    print(f"serving on http://127.0.0.1:{args.port}  "
          f"(POST /inpaint, GET /healthz, GET /stats)")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        httpd.shutdown()
        server.close()


if __name__ == "__main__":
    main()
