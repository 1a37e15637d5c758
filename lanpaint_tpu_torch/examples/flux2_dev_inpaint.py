"""Flux.2-dev inpainting (reference example_workflows/Flux.2.Dev_Inpaint.json:
LanPaint_SamplerCustomAdvanced with 5 think-steps, lambda 16, step-size 0.15,
FluxGuidance 4 (embedded), euler, Flux2Scheduler 20 steps at 1248x832;
flux2_dev + Mistral-Small-3.1 text features + flux2-vae).

The workflow also routes the source image's VAE latent through a
ReferenceLatent node into the positive conditioning: FLUX.2 attends to its
packed tokens, appended to the image stream on a RoPE time coordinate of
their own; mirrored here via cond["ref_tokens"].

The model is FLUX.2 [dev] at its published architecture
(`models/flux2.py`, FLUX2_DEV_CONFIG: 32.22 B parameters, bf16 on the card,
a 32-channel latent in 2x2 patches); its checkpoint's key names are
recalled offline, and `load.import_flux2` checks a file against them.  The
smoke run builds the same model at TINY_FLUX2_CONFIG."""

import torch

from lanpaint_tpu_torch import sample_custom_advanced
from lanpaint_tpu_torch.examples.common import (center_square_mask, example_argparser,
                                                example_device, report)
from lanpaint_tpu_torch.models.dit import pack_latent
from lanpaint_tpu_torch.models.flux2 import FLUX2_DEV_CONFIG, TINY_FLUX2_CONFIG
from lanpaint_tpu_torch.models.load import import_flux2, load_safetensors
from lanpaint_tpu_torch.models.zoo import build_flux2, build_flux2_dev
from lanpaint_tpu_torch.sigmas import resolution_shift_sigmas


def main():
    args = example_argparser("Flux.2-dev LanPaint inpainting").parse_args()
    device = example_device(args)
    if args.checkpoint:
        cfg = FLUX2_DEV_CONFIG
        state = import_flux2(load_safetensors(args.checkpoint), cfg)
        model, _ = build_flux2_dev(state, device=device, param_dtype=torch.bfloat16)
        b, hh, ww, n_txt = 1, 104, 156, 512  # 1248x832 pixels
    else:
        cfg = TINY_FLUX2_CONFIG
        model, _ = build_flux2(cfg, device=device, name="tiny-flux2")
        b, hh, ww, n_txt = 1, 16, 16, 8
    cond = {"context": torch.zeros((b, n_txt, cfg.context_dim), device=device),
            "guidance": torch.full((b,), 4.0, device=device)}

    latent = torch.zeros((b, cfg.latent_channels, hh, ww), device=device)
    # ReferenceLatent conditioning (workflow-pinned): the source latent
    # rides the token stream as packed reference tokens
    cond["ref_tokens"] = pack_latent(latent, cfg.patch)
    mask = center_square_mask(hh * 8, ww * 8)
    # Flux2Scheduler [steps, W, H] (workflow-pinned): resolution-shifted
    # flow schedule (the public Flux dynamic-shift rule, sigmas.py)
    sigmas = resolution_shift_sigmas(args.steps, ww * 8, hh * 8)

    out, denoised = sample_custom_advanced(
        model, noise_seed=args.seed, cfg=1.0, positive=cond,
        sampler_name="euler", sigmas=sigmas, latent=latent, mask=mask,
        num_steps=5, lamb=16.0, step_size=0.15,
    )
    report("flux2_dev_inpaint", out)


if __name__ == "__main__":
    main()
