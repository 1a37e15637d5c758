"""Anima inpainting (reference README.md:272-286, workflow embedded in
examples/Example_26/InPainted_Drag_Me_to_ComfyUI.png: anima-preview3-base,
Qwen3-0.6B text features, Qwen-Image VAE; er_sde/simple, 30 steps, cfg 5,
5 think-steps).

ANIMA_CONFIG is a structural stand-in on the generic MMDiT — the encoder
width (1024) and VAE pairing are workflow-pinned facts, the DiT topology is
not retrievable offline (docs/family_facts.md)."""

import torch

from lanpaint_tpu_torch import ksampler
from lanpaint_tpu_torch.examples.common import (center_square_mask, example_argparser, example_device,
                                                report)
from lanpaint_tpu_torch.models.dit import ANIMA_CONFIG, TINY_DIT_CONFIG
from lanpaint_tpu_torch.models.load import import_dit_guarded, load_safetensors
from lanpaint_tpu_torch.models.zoo import build_anima, build_tiny_dit


def main():
    args = example_argparser("Anima LanPaint inpainting").parse_args()
    device = example_device(args)
    if args.checkpoint:
        cfg = ANIMA_CONFIG
        state = import_dit_guarded(load_safetensors(args.checkpoint), cfg, family="anima")
        model, _ = build_anima(state, device=device)
        b, hw = 1, 128
        cond = {"context": torch.zeros((b, 256, cfg.context_dim), device=device)}
    else:
        model, _ = build_tiny_dit(device=device)
        cfg = TINY_DIT_CONFIG
        b, hw = 1, 16
        cond = {"context": torch.zeros((b, 8, cfg.context_dim), device=device),
                "vec": torch.zeros((b, cfg.vec_dim), device=device)}

    latent = torch.zeros((b, cfg.latent_channels, hw, hw), device=device)
    mask = center_square_mask(hw * 8, hw * 8)

    out = ksampler(
        model, seed=args.seed, steps=30, cfg=5.0, sampler_name="er_sde",
        scheduler="simple", positive=cond, latent=latent, mask=mask,
        num_steps=5,
    )
    report("anima_inpaint", out)


if __name__ == "__main__":
    main()
