"""Complete SDXL pipeline from ONE single-file checkpoint: text -> image.

The reference's SDXL workflow loads everything through its host's
CheckpointLoaderSimple node (reference example_workflows/SDXL_Inpaint.json);
here one safetensors file is split into UNet + CLIP-L + CLIP-G + VAE
(load.split_checkpoint), both text encoders run on the device
(models/textenc.py), the prompt is tokenized by the standalone CLIP BPE
(tokenizers.py, vocab files next to the checkpoint), and the pixel-level
inpaint runs VAE encode -> LanPaint -> VAE decode -> MaskBlend.

Usage:
    python -m lanpaint_tpu_torch.examples.sdxl_single_file.py         --checkpoint sd_xl_base_1.0.safetensors         --vocab vocab.json --merges merges.txt         --prompt "a corgi wearing sunglasses"

Without --checkpoint, runs the same pipeline end to end at tiny scale with
random weights and a byte-alphabet tokenizer (smoke mode).
"""

import numpy as np
import torch

from lanpaint_tpu_torch import tokenizers as tk
from lanpaint_tpu_torch.api import inpaint_image
from lanpaint_tpu_torch.examples.common import (center_square_mask, example_argparser,
                                                example_device, report)
from lanpaint_tpu_torch.models import textenc as TE
from lanpaint_tpu_torch.text import NativeEncoder, encode_prompt


def byte_clip_tokenizer():
    byte_enc = tk.bytes_to_unicode()
    vocab = {ch: i for i, ch in enumerate(sorted(byte_enc.values()))}
    for ch in sorted(byte_enc.values()):
        vocab[ch + "</w>"] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return tk.ClipBpeTokenizer(
        vocab, [], bos_token_id=vocab["<|startoftext|>"],
        eos_token_id=vocab["<|endoftext|>"]), vocab


def main():
    p = example_argparser("SDXL single-file text-to-inpaint")
    p.add_argument("--vocab", default=None, help="CLIP vocab.json")
    p.add_argument("--merges", default=None, help="CLIP merges.txt")
    p.add_argument("--prompt", default="a photo of a corgi")
    args = p.parse_args()
    device = example_device(args)

    if args.checkpoint:
        from lanpaint_tpu_torch.models.load import (
            import_clip, import_clip_openclip, import_unet, import_vae,
            load_safetensors, split_checkpoint,
        )
        from lanpaint_tpu_torch.models.unet import SDXL_CONFIG
        from lanpaint_tpu_torch.models.vae import SD_VAE_CONFIG
        from lanpaint_tpu_torch.models.zoo import build_unet, build_vae

        comps = split_checkpoint(load_safetensors(args.checkpoint))
        model, _ = build_unet(SDXL_CONFIG, import_unet(comps["unet"], SDXL_CONFIG, prefix=""),
                              name="sdxl", device=device)
        vae = build_vae(SD_VAE_CONFIG, import_vae(comps["vae"], SD_VAE_CONFIG, prefix=""),
                        device=device)
        tok = tk.ClipBpeTokenizer.from_files(args.vocab, args.merges)
        clip_l = NativeEncoder("clip", import_clip(comps["clip_l"], TE.CLIP_L_CONFIG),
                               TE.CLIP_L_CONFIG, tok, device=device)
        clip_g = NativeEncoder("clip", import_clip_openclip(comps["clip_g"], TE.CLIP_G_CONFIG),
                               TE.CLIP_G_CONFIG, tok, device=device)
        h = w = 1024
        image = torch.zeros((1, 3, h, w), device=device)
    else:  # smoke mode: tiny everything, random weights
        from lanpaint_tpu_torch.models.unet import TINY_UNET_CONFIG
        from lanpaint_tpu_torch.models.vae import TINY_VAE_CONFIG
        from lanpaint_tpu_torch.models.zoo import build_clip, build_tiny_unet, build_vae

        model, _ = build_tiny_unet(device=device)
        vae = build_vae(TINY_VAE_CONFIG, device=device)
        h = w = 64
        image = torch.from_numpy(np.random.default_rng(0).uniform(
            -1, 1, (1, 3, h, w)).astype(np.float32)).to(device)
        tok, vocab = byte_clip_tokenizer()
        ctx_d = TINY_UNET_CONFIG.context_dim
        cl_cfg = TE.CLIPTextConfig(
            vocab_size=len(vocab), width=ctx_d // 2, layers=2, heads=2,
            intermediate=32, projection_dim=0, eos_token_id=tok.eos_token_id)
        cg_cfg = TE.CLIPTextConfig(
            vocab_size=len(vocab), width=ctx_d - ctx_d // 2, layers=2,
            heads=2, intermediate=32, projection_dim=ctx_d - ctx_d // 2,
            eos_token_id=tok.eos_token_id)
        clip_l = NativeEncoder("clip", build_clip(cl_cfg, device=device, seed=1), cl_cfg, tok)
        clip_g = NativeEncoder("clip", build_clip(cg_cfg, device=device, seed=1), cg_cfg, tok)

    cond = encode_prompt(args.prompt, family="sdxl", clip_l=clip_l, clip_g=clip_g,
                         height=h, width=w)
    uncond = encode_prompt("", family="sdxl", clip_l=clip_l, clip_g=clip_g, height=h, width=w)
    if not args.checkpoint:  # the tiny UNet has no pooled-y head
        cond.pop("y", None)
        uncond.pop("y", None)

    out = inpaint_image(
        model, vae, image=image, mask=center_square_mask(h, w),
        positive=cond, negative=uncond, seed=args.seed, steps=args.steps,
        cfg=5.0, num_steps=args.think_steps,
    )
    report("sdxl_single_file", out)


if __name__ == "__main__":
    main()
