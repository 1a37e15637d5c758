"""SDXL inpainting (reference example_workflows/SDXL_Inpaint.json:
5 think-steps, euler/karras, cfg 5).

With --checkpoint this runs the real prompt path end to end: the single
safetensors file is split into UNet + CLIP-L + CLIP-G + VAE, the prompt is
tokenized and encoded by the port's text towers, and the pixel-space
pipeline runs VAE encode -> LanPaint -> VAE decode -> MaskBlend (the graph
the reference wires as CheckpointLoaderSimple -> CLIPTextEncode ->
LanPaint_KSampler, SDXL_Inpaint.json):

    python -m lanpaint_tpu_torch.examples.sdxl_inpaint \
        --checkpoint sd_xl_base_1.0.safetensors \
        --vocab vocab.json --merges merges.txt --prompt "a corgi"

The quality line prints masked PSNR/SSIM against the source image (and
LPIPS when LANPAINT_LPIPS_VGG points at VGG16 weights, see common.report).
Without --checkpoint: tiny random-init smoke mode, the same code path
minus the text encoders.
"""

import numpy as np
import torch

from lanpaint_tpu_torch import ksampler
from lanpaint_tpu_torch.examples.common import (center_square_mask, example_argparser,
                                                example_device, report)


def synthetic_image(h: int, w: int) -> torch.Tensor:
    """Deterministic smooth test image in [-1, 1] (B, 3, H, W)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([
        np.sin(xx / w * 6.28) * np.cos(yy / h * 3.14),
        np.cos(xx / w * 3.14) * np.sin(yy / h * 6.28),
        np.sin((xx + yy) / (h + w) * 6.28),
    ])
    return torch.from_numpy(img[None])


def main():
    p = example_argparser("SDXL LanPaint inpainting")
    p.add_argument("--vocab", default=None, help="CLIP vocab.json")
    p.add_argument("--merges", default=None, help="CLIP merges.txt")
    p.add_argument("--prompt", default="a photo of a corgi")
    p.add_argument("--negative", default="")
    args = p.parse_args()
    device = example_device(args)

    if args.checkpoint:
        from lanpaint_tpu_torch.pipeline import LanPaintPipeline

        pipe = LanPaintPipeline.from_single_file(
            args.checkpoint, vocab=args.vocab, merges=args.merges, device=device)
        h = w = 1024
        image = synthetic_image(h, w).to(device)
        mask = center_square_mask(h, w)
        out = pipe(args.prompt, image=image, mask=mask,
                   negative_prompt=args.negative, seed=args.seed,
                   steps=args.steps, cfg=5.0, num_steps=args.think_steps)
        report("sdxl_inpaint", out, original=image, mask=mask)
        return

    # smoke mode: tiny random-init UNet, latent-space ksampler
    from lanpaint_tpu_torch.models.unet import TINY_UNET_CONFIG
    from lanpaint_tpu_torch.models.zoo import build_tiny_unet

    model, _ = build_tiny_unet(device=device)
    b, hw = 1, 16
    cond = {"context": torch.zeros((b, 8, TINY_UNET_CONFIG.context_dim), device=device)}
    latent = torch.zeros((b, 4, hw, hw), device=device)
    mask = center_square_mask(hw, hw)
    out = ksampler(
        model, seed=args.seed, steps=args.steps, cfg=5.0,
        sampler_name="euler", scheduler="karras", positive=cond,
        latent=latent, mask=mask, num_steps=args.think_steps,
    )
    # quality line vs the (zero) source latent: masked metrics exercise the
    # same reporting path the checkpoint mode uses
    report("sdxl_inpaint", out, original=latent, mask=mask)


if __name__ == "__main__":
    main()
