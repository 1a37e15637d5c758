"""SD3.5-Large inpainting (reference supported-model matrix README.md:131-139;
standard LanPaint KSampler defaults: 5 think-steps, euler/simple)."""

import torch

from lanpaint_tpu_torch import ksampler
from lanpaint_tpu_torch.examples.common import (center_square_mask, example_argparser, example_device,
                                                report)
from lanpaint_tpu_torch.models.load import import_sd3, load_safetensors
from lanpaint_tpu_torch.models.sd3 import SD35_LARGE_CONFIG, TINY_SD3_CONFIG
from lanpaint_tpu_torch.models.zoo import build_sd3, build_tiny_sd3


def main():
    args = example_argparser("SD3.5 LanPaint inpainting").parse_args()
    device = example_device(args)
    if args.checkpoint:
        cfg = SD35_LARGE_CONFIG
        state = import_sd3(load_safetensors(args.checkpoint), cfg)
        model, _ = build_sd3(cfg, state, name="sd3.5-large", device=device)
        b, hw = 1, 128  # 1024x1024 pixels
        cond = {
            # plug in real T5+CLIP sequence features / pooled CLIP here
            "context": torch.zeros((b, 154, cfg.context_dim), device=device),
            "vec": torch.zeros((b, cfg.vec_dim), device=device),
        }
    else:
        model, _ = build_tiny_sd3(device=device)
        cfg = TINY_SD3_CONFIG
        b, hw = 1, 16
        cond = {"context": torch.zeros((b, 8, cfg.context_dim), device=device),
                "vec": torch.zeros((b, cfg.vec_dim), device=device)}

    latent = torch.zeros((b, cfg.in_channels, hw, hw), device=device)
    mask = center_square_mask(hw * 8, hw * 8)

    out = ksampler(
        model, seed=args.seed, steps=args.steps, cfg=4.5, sampler_name="euler",
        scheduler="simple", positive=cond, latent=latent, mask=mask,
        num_steps=args.think_steps,
    )
    report("sd35_inpaint", out)


if __name__ == "__main__":
    main()
