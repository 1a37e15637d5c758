"""Qwen-Image outpainting (reference example_workflows/
Qwen_Image_Outpaint.json: 20 steps, cfg 4, euler/simple, 5 think-steps;
border mask = outpaint)."""

import torch

from lanpaint_tpu_torch import ksampler
from lanpaint_tpu_torch.examples.common import (outpaint_mask, example_argparser, example_device,
                                                report)
from lanpaint_tpu_torch.models.dit import QWEN_IMAGE_CONFIG, TINY_DIT_CONFIG
from lanpaint_tpu_torch.models.load import import_mmdit_auto, load_safetensors
from lanpaint_tpu_torch.models.zoo import build_dit, build_tiny_dit


def main():
    args = example_argparser("Qwen-Image LanPaint outpainting").parse_args()
    device = example_device(args)
    if args.checkpoint:
        cfg = QWEN_IMAGE_CONFIG
        state = import_mmdit_auto(load_safetensors(args.checkpoint), cfg)
        model, _ = build_dit(cfg, state, shift=2.2, is_flux=False, name="qwen-image",
                             device=device)
        b, hw = 1, 128
        cond = {"context": torch.zeros((b, 256, cfg.context_dim), device=device)}
    else:
        model, _ = build_tiny_dit(device=device)
        cfg = TINY_DIT_CONFIG
        b, hw = 1, 16
        cond = {"context": torch.zeros((b, 8, cfg.context_dim), device=device),
                "vec": torch.zeros((b, cfg.vec_dim), device=device)}

    latent = torch.zeros((b, cfg.latent_channels, hw, hw), device=device)
    mask = outpaint_mask(hw * 8, hw * 8)

    out = ksampler(
        model, seed=args.seed, steps=20, cfg=4.0, sampler_name="euler",
        scheduler="simple", positive=cond, latent=latent, mask=mask,
        num_steps=5,
    )
    report("qwen_image_outpaint", out)


if __name__ == "__main__":
    main()
