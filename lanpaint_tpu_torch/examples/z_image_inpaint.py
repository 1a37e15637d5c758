"""Z-Image inpainting (reference example_workflows/Z_image_Inpaint.json:
9 steps, cfg 1, euler/simple, 5 think-steps; --base switches to the
Z_image_base_Inpaint.json advanced variant: 20 steps, cfg 4, 3 think-steps,
lambda 8, step-size 0.05, friction 25).

The backbone is the real Z-Image S3-DiT graph (models/zimage.py — the
Lumina2/NextDiT layout the workflow's UNETLoader consumes; manifest-tested
key layout, load.import_zimage)."""

import torch

from lanpaint_tpu_torch import ksampler, ksampler_advanced
from lanpaint_tpu_torch.examples.common import (center_square_mask, example_argparser,
                                                example_device, report)
from lanpaint_tpu_torch.models.load import import_zimage, load_safetensors
from lanpaint_tpu_torch.models.zimage import TINY_ZIMAGE_CONFIG, Z_IMAGE_S3_CONFIG
from lanpaint_tpu_torch.models.zoo import build_tiny_zimage, build_zimage


def main():
    p = example_argparser("Z-Image LanPaint inpainting")
    p.add_argument("--base", action="store_true",
                   help="Z-image-base advanced-knob variant")
    args = p.parse_args()
    device = example_device(args)
    if args.checkpoint:
        cfg = Z_IMAGE_S3_CONFIG
        state = import_zimage(load_safetensors(args.checkpoint), cfg)
        model, _ = build_zimage(cfg, state, device=device)
        b, hw = 1, 128
        cond = {"context": torch.zeros((b, 77, cfg.cap_dim), device=device)}
    else:
        model, _ = build_tiny_zimage(device=device)
        cfg = TINY_ZIMAGE_CONFIG
        b, hw = 1, 16
        cond = {"context": torch.zeros((b, 8, cfg.cap_dim), device=device)}

    latent = torch.zeros((b, cfg.latent_channels, hw, hw), device=device)
    mask = center_square_mask(hw * 8, hw * 8)

    if args.base:
        out = ksampler_advanced(
            model, noise_seed=args.seed, steps=20, cfg=4.0,
            sampler_name="euler", scheduler="simple", positive=cond,
            latent=latent, mask=mask, num_steps=3, lamb=8.0, step_size=0.05,
            friction=25.0)
    else:
        out = ksampler(
            model, seed=args.seed, steps=9, cfg=1.0, sampler_name="euler",
            scheduler="simple", positive=cond, latent=latent, mask=mask,
            num_steps=5)
    report("z_image_inpaint", out, original=latent, mask=center_square_mask(hw, hw))


if __name__ == "__main__":
    main()
