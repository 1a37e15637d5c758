"""Krea 2 inpainting (reference example_workflows/Krea2_LanPaint_Inpaint.json:
krea2_turbo checkpoint, Qwen3-VL-4B text features, Qwen-Image VAE; 8 steps,
cfg 1, euler/simple, 5 think-steps).

KREA2_CONFIG is a structural stand-in on the generic MMDiT — the encoder
width (2560) and VAE pairing are workflow-pinned facts, the DiT topology is
not retrievable offline (docs/family_facts.md)."""

import torch

from lanpaint_tpu_torch import ksampler
from lanpaint_tpu_torch.examples.common import (center_square_mask, example_argparser, example_device,
                                                report)
from lanpaint_tpu_torch.models.dit import KREA2_CONFIG, TINY_DIT_CONFIG
from lanpaint_tpu_torch.models.load import import_dit_guarded, load_safetensors
from lanpaint_tpu_torch.models.zoo import build_krea2, build_tiny_dit


def main():
    args = example_argparser("Krea2 LanPaint inpainting").parse_args()
    device = example_device(args)
    if args.checkpoint:
        cfg = KREA2_CONFIG
        state = import_dit_guarded(load_safetensors(args.checkpoint), cfg, family="krea2")
        model, _ = build_krea2(state, device=device)
        b, hw = 1, 128
        cond = {"context": torch.zeros((b, 512, cfg.context_dim), device=device)}
    else:
        model, _ = build_tiny_dit(device=device)
        cfg = TINY_DIT_CONFIG
        b, hw = 1, 16
        cond = {"context": torch.zeros((b, 8, cfg.context_dim), device=device),
                "vec": torch.zeros((b, cfg.vec_dim), device=device)}

    latent = torch.zeros((b, cfg.latent_channels, hw, hw), device=device)
    mask = center_square_mask(hw * 8, hw * 8)

    out = ksampler(
        model, seed=args.seed, steps=8, cfg=1.0, sampler_name="euler",
        scheduler="simple", positive=cond, latent=latent, mask=mask,
        num_steps=5,
    )
    report("krea2_inpaint", out)


if __name__ == "__main__":
    main()
