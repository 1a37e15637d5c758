"""Flux2-Klein inpainting (reference example_workflows/
Flux2_Klein_inpainting.json: LanPaint_SamplerCustomAdvanced with 2
think-steps, lambda 8, step-size 0.2, CFGGuider cfg 5, euler, 20 steps;
flux-2-klein-base-9b + Qwen3-8B text features + flux2-vae).

The workflow routes the source image's VAE latent through ReferenceLatent
nodes into BOTH the positive and negative conditioning (real CFG at 5) —
mirrored here via cond["ref_tokens"] on both conds.

FLUX2_KLEIN_CONFIG is a structural stand-in on the generic MMDiT — the
encoder width (4096) and reference-latent conditioning are workflow-pinned
facts, the DiT topology is not retrievable offline (docs/family_facts.md)."""

import torch

from lanpaint_tpu_torch import sample_custom_advanced
from lanpaint_tpu_torch.examples.common import (center_square_mask, example_argparser,
                                                example_device, report)
from lanpaint_tpu_torch.models.dit import FLUX2_KLEIN_CONFIG, TINY_DIT_CONFIG, pack_latent
from lanpaint_tpu_torch.models.load import import_dit_guarded, load_safetensors
from lanpaint_tpu_torch.models.zoo import build_flux2_klein, build_tiny_dit
from lanpaint_tpu_torch.sigmas import resolution_shift_sigmas


def main():
    args = example_argparser("Flux2-Klein LanPaint inpainting").parse_args()
    device = example_device(args)
    if args.checkpoint:
        cfg = FLUX2_KLEIN_CONFIG
        state = import_dit_guarded(load_safetensors(args.checkpoint), cfg,
                                   family="flux2-klein")
        model, _ = build_flux2_klein(state, device=device)
        b, hw = 1, 128
        cond = {"context": torch.zeros((b, 512, cfg.context_dim), device=device)}
        uncond = {"context": torch.zeros((b, 512, cfg.context_dim), device=device)}
    else:
        model, _ = build_tiny_dit(device=device)
        cfg = TINY_DIT_CONFIG
        b, hw = 1, 16
        cond = {"context": torch.zeros((b, 8, cfg.context_dim), device=device),
                "vec": torch.zeros((b, cfg.vec_dim), device=device)}
        uncond = {"context": torch.ones((b, 8, cfg.context_dim), device=device) * 0.1,
                  "vec": torch.zeros((b, cfg.vec_dim), device=device)}

    latent = torch.zeros((b, cfg.latent_channels, hw, hw), device=device)
    # ReferenceLatent on BOTH conds (workflow-pinned: two ReferenceLatent
    # nodes feed positive and negative under CFGGuider 5)
    ref = pack_latent(latent, cfg.patch)
    cond["ref_tokens"] = ref
    uncond["ref_tokens"] = ref
    mask = center_square_mask(hw * 8, hw * 8)
    # Flux2Scheduler [steps, W, H] (workflow-pinned): resolution-shifted
    # flow schedule (the public Flux dynamic-shift rule, sigmas.py)
    sigmas = resolution_shift_sigmas(args.steps, hw * 8, hw * 8)

    out, denoised = sample_custom_advanced(
        model, noise_seed=args.seed, cfg=5.0, positive=cond,
        negative=uncond,
        sampler_name="euler", sigmas=sigmas, latent=latent, mask=mask,
        num_steps=2, lamb=8.0, step_size=0.2,
    )
    report("flux2_klein_inpaint", out)


if __name__ == "__main__":
    main()
