"""Wan2.2 video inpainting with the high/low-noise expert pair
(reference example_workflows/video_Inpaint.json and README.md:205-268:
t2v 14B fp8_scaled, 2 think-steps, partial-frame masks).

--pixel runs the full pixel-level path instead (Wan2.2 48-ch VAE encode ->
LanPaint -> decode -> per-frame MaskBlend), the TI2V-5B-style deployment;
pass --vae wan2.2_vae.safetensors with a real checkpoint."""

import dataclasses

import numpy as np
import torch

from lanpaint_tpu_torch import inpaint_video, ksampler
from lanpaint_tpu_torch.examples.common import example_argparser, example_device, report
from lanpaint_tpu_torch.models.load import import_wan, load_safetensors
from lanpaint_tpu_torch.models.wan import TINY_WAN_CONFIG, WAN22_T2V_14B_CONFIG
from lanpaint_tpu_torch.models.zoo import build_tiny_wan, build_wan, switching_denoiser


def run_pixel(args, device):
    """Pixel video -> Wan2.2 VAE latents -> LanPaint -> pixels."""
    from lanpaint_tpu_torch.models.load import import_wan_vae
    from lanpaint_tpu_torch.models.video_vae import TINY_WAN22_VAE_CONFIG, WAN22_VAE_CONFIG
    from lanpaint_tpu_torch.models.zoo import build_wan_vae

    if args.vae:
        vae = build_wan_vae(WAN22_VAE_CONFIG,
                            import_wan_vae(load_safetensors(args.vae), WAN22_VAE_CONFIG),
                            device=device)
        den, _ = build_wan(WAN22_T2V_14B_CONFIG,
                           import_wan(load_safetensors(args.checkpoint), WAN22_T2V_14B_CONFIG),
                           shift=5.0, name="wan22-pixel", device=device)
        t, hw = 1 + 4 * ((args.frames - 1) // 4), 256
    else:
        vae_cfg = TINY_WAN22_VAE_CONFIG
        vae = build_wan_vae(vae_cfg, device=device)
        wan_cfg = dataclasses.replace(TINY_WAN_CONFIG, in_channels=vae_cfg.z_channels,
                                      out_channels=vae_cfg.z_channels)
        den, _ = build_wan(wan_cfg, name="wan22-pixel-tiny", device=device)
        t, hw = 5, 32
    gen = torch.Generator(device=device).manual_seed(1)
    video = torch.tanh(torch.randn((1, 3, t, hw, hw), generator=gen, device=device))
    mask = np.zeros((hw, hw), np.float32)
    mask[hw // 4: 3 * hw // 4, hw // 4: 3 * hw // 4] = 1.0
    ctx_d = 4096 if args.vae else TINY_WAN_CONFIG.context_dim
    cond = {"context": torch.zeros((1, 8, ctx_d), device=device)}
    out = inpaint_video(
        den, vae, video=video, mask=torch.from_numpy(mask), positive=cond, seed=args.seed,
        steps=args.steps, cfg=1.0, num_steps=2, blend_overlap=5)
    report("wan22_video_inpaint_pixel", out)


def main():
    p = example_argparser("Wan2.2 video LanPaint inpainting")
    p.add_argument("--checkpoint-low", default=None,
                   help="low-noise expert (fp8_scaled safetensors)")
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--pixel", action="store_true",
                   help="pixel-level path through the Wan2.2 VAE")
    p.add_argument("--vae", default=None,
                   help="wan2.2_vae.safetensors (with --pixel + --checkpoint)")
    args = p.parse_args()
    device = example_device(args)

    if args.pixel:
        run_pixel(args, device)
        return

    if args.checkpoint:
        cfgm = WAN22_T2V_14B_CONFIG
        high, _ = build_wan(cfgm, import_wan(load_safetensors(args.checkpoint), cfgm),
                            shift=5.0, name="wan22-high", device=device)
        low, _ = build_wan(cfgm, import_wan(load_safetensors(args.checkpoint_low), cfgm),
                           shift=5.0, name="wan22-low", device=device)
        model = switching_denoiser(high, low, boundary=0.875)
        b, c, f, hw, ctx_d = 1, 16, args.frames, 60, 4096
    else:
        high, _ = build_tiny_wan(seed=0, device=device)
        low, _ = build_tiny_wan(seed=1, device=device)
        model = switching_denoiser(high, low, boundary=0.875)
        b, c, f, hw, ctx_d = (1, TINY_WAN_CONFIG.in_channels, args.frames, 16,
                              TINY_WAN_CONFIG.context_dim)

    latent = torch.zeros((b, c, f, hw, hw), device=device)
    # frame-stack mask: repaint the second half of the frames
    mask = np.zeros((f, 1, hw * 8, hw * 8), np.float32)
    mask[f // 2:] = 1.0
    cond = {"context": torch.zeros((b, 8, ctx_d), device=device)}

    out = ksampler(
        model, seed=args.seed, steps=args.steps, cfg=1.0,
        sampler_name="euler", scheduler="simple", positive=cond,
        latent=latent, mask=torch.from_numpy(mask), num_steps=2, video=True,
    )
    report("wan22_video_inpaint", out)


if __name__ == "__main__":
    main()
