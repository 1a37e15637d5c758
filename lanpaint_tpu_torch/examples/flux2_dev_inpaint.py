"""Flux.2-dev inpainting (reference example_workflows/Flux.2.Dev_Inpaint.json:
LanPaint_SamplerCustomAdvanced with 5 think-steps, lambda 16, step-size 0.15,
FluxGuidance 4 (embedded), euler, Flux2Scheduler 20 steps; flux2_dev +
Mistral-Small-3.1 text features + flux2-vae).

The workflow also routes the source image's VAE latent through a
ReferenceLatent node into the positive conditioning — Flux.2 attends to
packed reference-latent tokens appended to the stream (the same mechanism
as Qwen-Image-Edit); mirrored here via cond["ref_tokens"].

FLUX2_DEV_CONFIG is a structural stand-in on the generic MMDiT — the
encoder width (5120), guidance embedding and reference-latent conditioning
are workflow-pinned facts, the DiT topology is not retrievable offline
(docs/family_facts.md)."""

import torch

from lanpaint_tpu_torch import sample_custom_advanced
from lanpaint_tpu_torch.examples.common import (center_square_mask, example_argparser,
                                                example_device, report)
from lanpaint_tpu_torch.models.dit import FLUX2_DEV_CONFIG, TINY_DIT_CONFIG, pack_latent
from lanpaint_tpu_torch.models.load import import_dit_guarded, load_safetensors
from lanpaint_tpu_torch.models.zoo import build_flux2_dev, build_tiny_dit
from lanpaint_tpu_torch.sigmas import resolution_shift_sigmas


def main():
    args = example_argparser("Flux.2-dev LanPaint inpainting").parse_args()
    device = example_device(args)
    if args.checkpoint:
        cfg = FLUX2_DEV_CONFIG
        state = import_dit_guarded(load_safetensors(args.checkpoint), cfg,
                                   family="flux2-dev")
        model, _ = build_flux2_dev(state, device=device)
        b, hw = 1, 128
        cond = {"context": torch.zeros((b, 512, cfg.context_dim), device=device),
                "guidance": torch.full((b,), 4.0, device=device)}
    else:
        model, _ = build_tiny_dit(device=device)
        cfg = TINY_DIT_CONFIG
        b, hw = 1, 16
        cond = {"context": torch.zeros((b, 8, cfg.context_dim), device=device),
                "vec": torch.zeros((b, cfg.vec_dim), device=device)}

    latent = torch.zeros((b, cfg.latent_channels, hw, hw), device=device)
    # ReferenceLatent conditioning (workflow-pinned): the source latent
    # rides the token stream as packed reference tokens
    cond["ref_tokens"] = pack_latent(latent, cfg.patch)
    mask = center_square_mask(hw * 8, hw * 8)
    # Flux2Scheduler [steps, W, H] (workflow-pinned): resolution-shifted
    # flow schedule (the public Flux dynamic-shift rule, sigmas.py)
    sigmas = resolution_shift_sigmas(args.steps, hw * 8, hw * 8)

    out, denoised = sample_custom_advanced(
        model, noise_seed=args.seed, cfg=1.0, positive=cond,
        sampler_name="euler", sigmas=sigmas, latent=latent, mask=mask,
        num_steps=5, lamb=16.0, step_size=0.15,
    )
    report("flux2_dev_inpaint", out)


if __name__ == "__main__":
    main()
