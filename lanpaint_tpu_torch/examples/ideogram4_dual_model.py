"""Ideogram4 dual-model inpainting (reference example_workflows/
Ideogram4_LanPaint_Inpaint.json: `DualModelGuider [4]` pairing
ideogram4_fp8_scaled (positive) with ideogram4_unconditional_fp8_scaled
(negative), Qwen3-VL-8B text features, flux2-vae, Ideogram4Scheduler
20 steps, euler, LanPaint_SamplerCustomAdvanced with 5 think-steps /
lambda 16 / step 0.2).

`zoo.dual_model_denoiser` reproduces the DualModelGuider semantics: the
CFG positive branch runs the conditional model, the negative branch runs
the separate unconditional model (`model_select` flag in the negative
cond), one model per CFG pass with `sequential_cfg=True`.
The Ideogram4 topology itself is offline-unknown (docs/family_facts.md) —
tiny stand-in models demonstrate the graph; the workflow's CFGOverride
late-schedule tweak is a host-side scheduler detail, not LanPaint surface.
"""

import torch

from lanpaint_tpu_torch import sample_custom_advanced
from lanpaint_tpu_torch.examples.common import (center_square_mask, example_argparser,
                                                example_device, report)
from lanpaint_tpu_torch.models.zoo import build_tiny_dit, dual_model_denoiser
from lanpaint_tpu_torch.sigmas import resolution_shift_sigmas


def main():
    p = example_argparser("Ideogram4 dual-model LanPaint inpainting")
    p.add_argument("--checkpoint-uncond", default=None,
                   help="the paired unconditional-model safetensors")
    args = p.parse_args()
    device = example_device(args)

    if args.checkpoint:
        # the census guard fails loudly when the stand-in topology does not
        # describe the real release (docs/family_facts.md)
        from lanpaint_tpu_torch.models.dit import IDEOGRAM4_CONFIG
        from lanpaint_tpu_torch.models.load import import_dit_guarded, load_safetensors
        from lanpaint_tpu_torch.models.zoo import build_dit

        cfg = IDEOGRAM4_CONFIG
        positive_model, _ = build_dit(
            cfg, import_dit_guarded(load_safetensors(args.checkpoint), cfg,
                                    family="ideogram4"),
            shift=1.0, is_flux=False, name="ideogram4", device=device)
        negative_model, _ = build_dit(
            cfg, import_dit_guarded(load_safetensors(args.checkpoint_uncond), cfg,
                                    family="ideogram4-uncond"),
            shift=1.0, is_flux=False, name="ideogram4-uncond", device=device)
        model = dual_model_denoiser(positive_model, negative_model, name="ideogram4-dual")
        b, hw = 1, 128
        cond = {"context": torch.zeros((b, 77, cfg.context_dim), device=device)}
        neg = dict(cond, model_select=torch.ones((), device=device))
    else:  # smoke mode: tiny conditional + unconditional experts
        positive_model, _ = build_tiny_dit(seed=0, device=device)
        negative_model, _ = build_tiny_dit(seed=1, device=device)
        model = dual_model_denoiser(positive_model, negative_model, name="ideogram4-dual")
        b, hw = 1, 16
        cond = {"context": torch.zeros((b, 8, 32), device=device),
                "vec": torch.zeros((b, 16), device=device)}
        neg = {"context": torch.zeros((b, 8, 32), device=device),
               "vec": torch.zeros((b, 16), device=device),
               "model_select": torch.ones((), device=device)}

    latent = torch.zeros((b, model.latent_channels, hw, hw), device=device)
    mask = center_square_mask(hw * 8, hw * 8)
    # Ideogram4Scheduler [20, 1024, 1024, 0.5, 1.75] (workflow-pinned):
    # resolution-shifted flow schedule, widgets = (base, max) shift
    sigmas = resolution_shift_sigmas(20, 1024, 1024, base_shift=0.5, max_shift=1.75)

    out, denoised = sample_custom_advanced(
        model, noise_seed=args.seed, cfg=4.0, positive=cond, negative=neg,
        sampler_name="euler", sigmas=sigmas, latent=latent, mask=mask,
        num_steps=5, lamb=16.0, step_size=0.2, sequential_cfg=True,
    )
    report("ideogram4_dual_model", out)


if __name__ == "__main__":
    main()
