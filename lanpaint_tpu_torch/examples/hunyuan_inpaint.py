"""Hunyuan inpainting (reference example_workflows/Hunyuan_Inpaint.json:
20 steps, cfg 1, euler/simple, 5 think-steps).

The reference's "Hunyuan" family loads hunyuan_video_t2v_720p (the
HunyuanVideo T2V DiT, CFG-distilled) and samples it as a single-frame T2I
model — models/hyvideo.py is that architecture.  cfg=1.0 with the embedded
`guidance` scale mirrors the distilled model's workflow defaults.
"""

import torch

from lanpaint_tpu_torch import ksampler
from lanpaint_tpu_torch.examples.common import (center_square_mask, example_argparser, example_device,
                                                report)
from lanpaint_tpu_torch.models.hyvideo import HUNYUAN_VIDEO_720P_CONFIG, TINY_HYVIDEO_CONFIG
from lanpaint_tpu_torch.models.load import import_hyvideo, load_safetensors
from lanpaint_tpu_torch.models.zoo import build_hyvideo, build_tiny_hyvideo


def main():
    args = example_argparser("Hunyuan (HunyuanVideo T2I) LanPaint inpainting").parse_args()
    device = example_device(args)
    if args.checkpoint:
        cfg = HUNYUAN_VIDEO_720P_CONFIG
        state = import_hyvideo(load_safetensors(args.checkpoint), cfg)
        model, _ = build_hyvideo(cfg, state, device=device)
        b, hw, ctx_len = 1, 128, 256
    else:
        cfg = TINY_HYVIDEO_CONFIG
        model, _ = build_tiny_hyvideo(device=device)
        b, hw, ctx_len = 1, 16, 8

    cond = {"context": torch.zeros((b, ctx_len, cfg.context_dim), device=device),
            "vec": torch.zeros((b, cfg.vec_dim), device=device),
            "guidance": torch.full((b,), 6.0, device=device)}
    latent = torch.zeros((b, cfg.in_channels, hw, hw), device=device)
    mask = center_square_mask(hw * 8, hw * 8)

    out = ksampler(
        model, seed=args.seed, steps=20, cfg=1.0, sampler_name="euler",
        scheduler="simple", positive=cond, latent=latent, mask=mask,
        num_steps=5,
    )
    report("hunyuan_inpaint", out)


if __name__ == "__main__":
    main()
