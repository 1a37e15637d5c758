"""Flux-dev inpainting (reference example_workflows/Flux_Inpaint.json:
5 think-steps; FLUX rule forces cfg_big = 1.0)."""

import torch

from lanpaint_tpu_torch import ksampler
from lanpaint_tpu_torch.examples.common import (center_square_mask, example_argparser,
                                                example_device, report)
from lanpaint_tpu_torch.models.dit import FLUX_DEV_CONFIG, TINY_DIT_CONFIG
from lanpaint_tpu_torch.models.load import import_dit, load_safetensors
from lanpaint_tpu_torch.models.zoo import build_dit, build_tiny_dit


def main():
    args = example_argparser("Flux LanPaint inpainting").parse_args()
    device = example_device(args)
    if args.checkpoint:
        state = import_dit(load_safetensors(args.checkpoint), FLUX_DEV_CONFIG)
        model, _ = build_dit(FLUX_DEV_CONFIG, state, shift=1.15, is_flux=True,
                             name="flux-dev", device=device)
        b, c, hw = 1, 16, 128
        cond = {
            "context": torch.zeros((b, 512, 4096), device=device),  # T5
            "vec": torch.zeros((b, 768), device=device),            # pooled CLIP
            "guidance": torch.full((b,), 3.5, device=device),
        }
    else:
        model, _ = build_tiny_dit(device=device)
        b, c, hw = 1, TINY_DIT_CONFIG.latent_channels, 16
        cond = {"context": torch.zeros((b, 8, TINY_DIT_CONFIG.context_dim), device=device),
                "vec": torch.zeros((b, TINY_DIT_CONFIG.vec_dim), device=device)}

    latent = torch.zeros((b, c, hw, hw), device=device)
    mask = center_square_mask(hw * 8, hw * 8)

    out = ksampler(
        model, seed=args.seed, steps=args.steps, cfg=1.0,
        sampler_name="euler", scheduler="simple", positive=cond,
        latent=latent, mask=mask, num_steps=args.think_steps,
    )
    report("flux_inpaint", out)


if __name__ == "__main__":
    main()
