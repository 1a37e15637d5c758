"""Command-line interface: `python -m lanpaint_tpu_torch <command>`.

PyTorch counterpart of `lanpaint_tpu/__main__.py`, with the same commands
and flags:

  inpaint   single-file checkpoint + image + mask -> inpainted image
            (the LanPaint_KSampler node's parameter surface as flags)
  serve     stand up the micro-batching HTTP server + web UI on a
            checkpoint (lanpaint_tpu_torch/serve.py, webui.py)
  info      print the CUDA devices and the default config, or with
            --census a checkpoint's key census

The pipelines build on the CUDA card.  Image I/O is PIL, imported only
inside the image helpers (inpaint needs it; serve and info do not); arrays
move in pixel space [-1, 1] exactly as `LanPaintPipeline` expects.
"""

from __future__ import annotations

import argparse
import sys


def _load_image(path: str, size=None):
    import numpy as np
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if size is not None:
        img = img.resize(size, Image.LANCZOS)
    arr = np.asarray(img, np.float32) / 127.5 - 1.0      # (H, W, 3)
    return arr.transpose(2, 0, 1)[None]                  # (1, 3, H, W)


def _load_mask(path: str, size=None):
    import numpy as np
    from PIL import Image

    m = Image.open(path).convert("L")
    if size is not None:
        m = m.resize(size, Image.NEAREST)
    return (np.asarray(m, np.float32) > 127.0).astype(np.float32)


def _save_image(path: str, arr):
    import numpy as np
    from PIL import Image

    if hasattr(arr, "detach"):                            # a torch tensor
        arr = arr.detach().float().cpu().numpy()
    a = np.asarray(arr)[0].transpose(1, 2, 0)            # (H, W, 3)
    a = np.clip(np.rint((a + 1.0) * 127.5), 0, 255).astype(np.uint8)
    Image.fromarray(a).save(path)


def _add_sampler_flags(p: argparse.ArgumentParser):
    """The LanPaint_KSampler node surface (reference nodes.py:298-349)."""
    p.add_argument("--prompt", default="")
    p.add_argument("--negative-prompt", default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--cfg", type=float, default=5.0)
    p.add_argument("--sampler", default="euler")
    p.add_argument("--scheduler", default="karras")
    p.add_argument("--think-steps", type=int, default=5,
                   help="LanPaint NumSteps (inner Langevin iterations)")
    p.add_argument("--prompt-mode", default="Image First",
                   choices=["Image First", "Prompt First"])
    p.add_argument("--blend-overlap", type=int, default=9,
                   help="MaskBlend dilate+feather width (0 = off)")
    p.add_argument("--sequential-cfg", action="store_true",
                   help="run cond/uncond as separate forwards "
                        "(faster + half the memory at video/1024px scale)")


def _build_pipeline(args):
    from .pipeline import LanPaintPipeline

    family = getattr(args, "family", "auto")
    if family in ("auto", "sd15", "sdxl"):
        return LanPaintPipeline.from_single_file(
            args.checkpoint, vocab=args.vocab, merges=args.merges,
            family=None if family == "auto" else family,
            height=args.height, width=args.width)
    return LanPaintPipeline.from_components(
        family=family, model=args.checkpoint, vae=args.vae,
        clip_l=args.clip_l, clip_g=args.clip_g, t5=args.t5,
        llama=args.llama, clip_vocab=args.vocab, clip_merges=args.merges,
        t5_tokenizer=args.t5_tokenizer, llama_tokenizer=args.llama_tokenizer,
        with_vision=args.with_vision, height=args.height, width=args.width)


def _add_component_flags(p):
    p.add_argument("--family", default="auto",
                   choices=["auto", "sd15", "sdxl", "flux", "sd35", "qwen", "z-image"],
                   help="auto/sd15/sdxl load --checkpoint as one file; "
                        "flux/sd35/qwen use the multi-file component flags")
    p.add_argument("--vae", default=None, help="VAE safetensors (DiT families)")
    p.add_argument("--clip-l", default=None)
    p.add_argument("--clip-g", default=None)
    p.add_argument("--t5", default=None, help="T5-XXL safetensors")
    p.add_argument("--llama", default=None,
                   help="Qwen2.5-VL safetensors (qwen family)")
    p.add_argument("--t5-tokenizer", default=None,
                   help="spiece.model or tokenizer.json")
    p.add_argument("--llama-tokenizer", default=None, help="tokenizer.json")
    p.add_argument("--with-vision", action="store_true",
                   help="load the Qwen2.5-VL vision tower (enables --edit)")


def cmd_inpaint(args) -> int:
    pipe = _build_pipeline(args)
    image = _load_image(args.image, (args.width, args.height))
    mask = _load_mask(args.mask, (args.width, args.height))
    common = dict(
        negative_prompt=args.negative_prompt, seed=args.seed,
        steps=args.steps, cfg=args.cfg, num_steps=args.think_steps,
        sampler_name=args.sampler, scheduler=args.scheduler,
        blend_overlap=args.blend_overlap, prompt_mode=args.prompt_mode,
        sequential_cfg=args.sequential_cfg)
    if args.edit:
        # Qwen-Image-Edit: the source image conditions the model both as
        # Qwen2.5-VL vision tokens and as reference latents
        import torch

        from .api import edit_image

        hwc = image[0].transpose(1, 2, 0) * 0.5 + 0.5
        positive = pipe.encode(args.prompt, image=hwc)
        negative = pipe.encode(common.pop("negative_prompt"))
        device = next(pipe.vae.parameters()).device
        out = edit_image(pipe.model, pipe.vae,
                         image=torch.as_tensor(image, device=device),
                         mask=torch.as_tensor(mask, device=device), positive=positive,
                         negative=negative, **common)
    else:
        out = pipe(args.prompt, image=image, mask=mask, **common)
    _save_image(args.output, out)
    print(args.output)
    return 0


def cmd_serve(args) -> int:
    from .serve import (
        InpaintServer, ProgressBoard, make_http_server, pipeline_runner,
        pipeline_validator,
    )

    pipe = _build_pipeline(args)
    board = ProgressBoard()
    srv = InpaintServer(
        pipeline_runner(pipe, batch_size=args.batch_size, progress=board),
        batch_size=args.batch_size, max_delay_s=args.max_delay_s,
        validator=pipeline_validator(args.batch_size))
    httpd = make_http_server(srv, host=args.host, port=args.port,
                             progress=board)
    print(f"serving on http://{args.host}:{httpd.server_address[1]}/ "
          f"(web UI at /, JSON API at /inpaint)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        srv.close()
    return 0


def cmd_info(args) -> int:
    if getattr(args, "census", None):
        # header-only checkpoint key census vs a family's import table:
        # the actionable report the first real flux2/krea2/anima checkpoint
        # needs (their vendored topologies are structural stand-ins —
        # import_dit_guarded raises; this prints the same diff without
        # loading a single tensor)
        from .models.zoo import family_census

        if not args.family:
            print("info --census requires --family", file=sys.stderr)
            return 2
        rep = family_census(args.census, args.family)
        print(f"family:   {rep['family']}")
        print(f"expected: {rep['expected']} keys; in file: {rep['in_file']}; "
              f"matched: {rep['matched']}")
        for label in ("missing", "leftover"):
            ks = rep[label]
            print(f"{label}: {len(ks)}")
            for k in ks[:20]:
                print(f"  {k}")
            if len(ks) > 20:
                print(f"  ... and {len(ks) - 20} more")
        print("census: OK — importer covers this file exactly" if rep["ok"]
              else "census: MISMATCH — update the family config / entry "
                   "table (see docs/family_facts.md)")
        return 0 if rep["ok"] else 1

    import torch

    from .config import LanPaintConfig

    print(f"torch: {torch.__version__} (CUDA {torch.version.cuda})")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(f"cuda available: {torch.cuda.is_available()}")
    devices = []
    for i in range(count):
        p = torch.cuda.get_device_properties(i)
        devices.append(f"cuda:{i} {p.name} ({p.total_memory / 2**30:.1f} GiB, "
                       f"sm_{p.major}{p.minor}, {p.multi_processor_count} SMs)")
    print(f"devices: {devices}")
    print(f"device_count: {count}")
    print(f"default config: {LanPaintConfig()}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lanpaint_tpu_torch",
        description="LanPaint: training-free inpainting on a CUDA card")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("inpaint", help="inpaint one image")
    p.add_argument("--checkpoint", required=True,
                   help="single-file SD1.x/SDXL safetensors, or the "
                        "diffusion-model file with --family flux/sd35/qwen")
    p.add_argument("--vocab", default=None, help="CLIP vocab.json")
    p.add_argument("--merges", default=None, help="CLIP merges.txt")
    p.add_argument("--image", required=True)
    p.add_argument("--mask", required=True,
                   help="grayscale mask image; >50%% = repaint")
    p.add_argument("--output", default="inpainted.png")
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--edit", action="store_true",
                   help="Qwen-Image-Edit mode: condition on the input image "
                        "(needs --family qwen --with-vision)")
    _add_component_flags(p)
    _add_sampler_flags(p)
    p.set_defaults(fn=cmd_inpaint)

    p = sub.add_parser("serve", help="HTTP server + web UI on a checkpoint")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--vocab", default=None)
    p.add_argument("--merges", default=None)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--width", type=int, default=1024)
    _add_component_flags(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8776)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--max-delay-s", type=float, default=0.25)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("info", help="device / config diagnostics + "
                                    "checkpoint key census")
    p.add_argument("--census", default=None, metavar="CKPT",
                   help="safetensors checkpoint: print the key diff vs the "
                        "--family import table (header-only, no tensor "
                        "loads); exit 0 iff the importer covers it exactly")
    p.add_argument("--family", default=None,
                   help="model family for --census (sdxl, flux2-dev, "
                        "krea2, anima, qwen, wan-14b, ...)")
    p.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
