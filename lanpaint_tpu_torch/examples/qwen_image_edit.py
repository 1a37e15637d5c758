"""Qwen-Image-Edit masked edit with reference-latent conditioning
(reference example_workflows/Qwen_Image_Edit_2509.json: custom-sampler path,
reference latents appended as extra image tokens).

With real weights, the text conditioning comes from the full Qwen2.5-VL
multimodal path (the reference's TextEncodeQwenImageEdit node):

    from lanpaint_tpu_torch.text import NativeEncoder, VisionEncoder, encode_prompt
    from lanpaint_tpu_torch.models.load import (import_llama, import_qwen_vl_vision,
                                                load_safetensors)
    from lanpaint_tpu_torch.models.textenc import QWEN25_7B_CONFIG
    sd = load_safetensors("qwen_2.5_vl_7b.safetensors")
    llama = NativeEncoder("llama", import_llama(sd, QWEN25_7B_CONFIG),
                          QWEN25_7B_CONFIG, tokenizer)
    vision = VisionEncoder(import_qwen_vl_vision(sd, QWEN25_VL_VISION_CONFIG))
    cond = encode_prompt(prompt, family="qwen_edit", llama=llama,
                         vision=vision, image=source_pixels_hwc)

(vision tokens spliced at <|image_pad|>, multimodal rope; held to the JAX
package's tower in tests/test_torch_vision.py)."""

import torch

from lanpaint_tpu_torch import sample_custom_advanced
from lanpaint_tpu_torch.examples.common import (example_argparser, example_device,
                                                outpaint_mask, report)
from lanpaint_tpu_torch.models.dit import QWEN_IMAGE_CONFIG, TINY_DIT_CONFIG, pack_latent
from lanpaint_tpu_torch.models.load import import_mmdit_auto, load_safetensors
from lanpaint_tpu_torch.models.zoo import build_dit, build_tiny_dit
from lanpaint_tpu_torch.sigmas import calculate_sigmas


def main():
    args = example_argparser("Qwen-Image-Edit LanPaint").parse_args()
    device = example_device(args)
    if args.checkpoint:
        state = import_mmdit_auto(load_safetensors(args.checkpoint), QWEN_IMAGE_CONFIG)
        model, _ = build_dit(QWEN_IMAGE_CONFIG, state, shift=2.2, is_flux=False,
                             name="qwen-image", device=device)
        b, c, hw, ctx_d = 1, 16, 128, 3584
    else:
        model, _ = build_tiny_dit(device=device)
        b, c, hw, ctx_d = 1, TINY_DIT_CONFIG.latent_channels, 16, TINY_DIT_CONFIG.context_dim

    latent = torch.zeros((b, c, hw, hw), device=device)
    # the edit source image enters as reference tokens (packed latent space)
    ref_latent = torch.ones((b, c, hw, hw), device=device) * 0.1
    cond = {
        "context": torch.zeros((b, 8, ctx_d), device=device),
        "ref_tokens": pack_latent(ref_latent, 2),
    }
    if model.name == "tiny-dit":
        cond["vec"] = torch.zeros((b, TINY_DIT_CONFIG.vec_dim), device=device)

    sigmas = calculate_sigmas(model.sigma_table, "simple", args.steps)
    out, denoised = sample_custom_advanced(
        model, noise_seed=args.seed, cfg=1.0, positive=cond,
        sampler_name="euler", sigmas=sigmas, latent=latent,
        mask=outpaint_mask(hw * 8, hw * 8), num_steps=args.think_steps,
    )
    report("qwen_image_edit", out)


if __name__ == "__main__":
    main()
