"""HiDream-I1 inpainting (reference supported-model matrix README.md:131-139;
MoE-MMDiT with per-block Llama text injection; standard LanPaint defaults)."""

import torch

from lanpaint_tpu_torch import ksampler
from lanpaint_tpu_torch.examples.common import (center_square_mask, example_argparser, example_device,
                                                report)
from lanpaint_tpu_torch.models.hidream import HIDREAM_I1_CONFIG, TINY_HIDREAM_CONFIG
from lanpaint_tpu_torch.models.load import import_hidream, load_safetensors
from lanpaint_tpu_torch.models.zoo import build_hidream, build_tiny_hidream


def main():
    args = example_argparser("HiDream LanPaint inpainting").parse_args()
    device = example_device(args)
    if args.checkpoint:
        cfg = HIDREAM_I1_CONFIG
        state = import_hidream(load_safetensors(args.checkpoint), cfg)
        model, _ = build_hidream(cfg, state, name="hidream", device=device)
        b, hw = 1, 128
        cond = {
            "context": torch.zeros((b, 128, cfg.context_dim), device=device),
            "vec": torch.zeros((b, cfg.vec_dim), device=device),
            # per-layer Llama-3.1 hidden states: (L, B, S, llama_dim)
            "llama": torch.zeros((32, b, 128, cfg.llama_dim), device=device),
        }
    else:
        model, _ = build_tiny_hidream(device=device)
        cfg = TINY_HIDREAM_CONFIG
        b, hw = 1, 16
        cond = {"context": torch.zeros((b, 8, cfg.context_dim), device=device),
                "vec": torch.zeros((b, cfg.vec_dim), device=device),
                "llama": torch.zeros((2, b, 4, cfg.llama_dim), device=device)}

    latent = torch.zeros((b, cfg.latent_channels, hw, hw), device=device)
    mask = center_square_mask(hw * 8, hw * 8)

    out = ksampler(
        model, seed=args.seed, steps=args.steps, cfg=1.0, sampler_name="euler",
        scheduler="simple", positive=cond, latent=latent, mask=mask,
        num_steps=args.think_steps,
    )
    report("hidream_inpaint", out)


if __name__ == "__main__":
    main()
