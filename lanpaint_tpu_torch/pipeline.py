"""One-object pipeline: checkpoint file -> prompt -> inpainted image.

PyTorch counterpart of `lanpaint_tpu/pipeline.py`.  The reference's user
assembles a node graph (CheckpointLoaderSimple -> CLIPTextEncode ->
VAEEncode -> LanPaint_KSampler -> VAEDecode -> LanPaint_MaskBlend, e.g.
reference example_workflows/SDXL_Inpaint.json); `LanPaintPipeline` is that
graph as one object:

    pipe = LanPaintPipeline.from_single_file(
        "sd_xl_base_1.0.safetensors", vocab="vocab.json", merges="merges.txt",
        param_dtype=torch.bfloat16)
    out = pipe("a corgi", image=img, mask=mask, steps=30, num_steps=5)

Every stage stays overridable: pass your own Denoiser / encoders / VAE to
the constructor, or call `.encode()` / `.sample()` directly.  The
constructors build on the CUDA card unless `device` names another, with
`param_dtype` parameters (fp32 by default).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from .api import inpaint_image, ksampler
from .text import NativeEncoder, encode_prompt

def _import_clip_auto(sub: Dict[str, Any], cfg):
    """Import a CLIP text tower from either layout found in checkpoints."""
    from .models.load import import_clip, import_clip_openclip

    if any(k.startswith("ln_final.") for k in sub):
        return import_clip_openclip(sub, cfg)
    return import_clip(sub, cfg)


class _SingleFrameVAE(nn.Module):
    """A 3D (video) VAE used as a 2D image VAE (T = 1 frame).

    Qwen-Image pairs the Wan2.1-graph causal video VAE with a 2D image DiT
    (the reference workflow's qwen_image_vae); the 1+4k frame law maps one
    pixel frame to one latent frame, so squeezing the frame axis is exact."""

    def __init__(self, module):
        super().__init__()
        self.module = module

    def encode(self, x, generator=None):
        return self.module.encode(x[:, :, None], generator)[:, :, 0]

    def decode(self, latent):
        return self.module.decode(latent[:, :, None])[:, :, 0]


class LanPaintPipeline:
    def __init__(self, model, *, vae=None, encoders: Optional[Dict[str, NativeEncoder]] = None,
                 family: str = "sdxl", height: int = 1024, width: int = 1024):
        self.model = model
        self.vae = vae
        self.encoders = encoders or {}
        self.family = family
        self.height = height
        self.width = width

    # ------------------------------------------------------------------
    @classmethod
    def from_single_file(cls, path: str, *, vocab: str, merges: str,
                         family: Optional[str] = None,
                         unet_config=None, clip_l_config=None,
                         clip_g_config=None, vae_config=None,
                         height: int = 1024, width: int = 1024,
                         clip_pad_token_id: Optional[int] = None,
                         state: Optional[Dict[str, Any]] = None,
                         device=None, param_dtype: torch.dtype = torch.float32
                         ) -> "LanPaintPipeline":
        """Build the whole pipeline from one SD1.x/SDXL safetensors file.

        `vocab`/`merges` are the CLIP tokenizer files (shipped with every
        SD release).  Configs default by detected family: clip_g present
        in the file => SDXL, else SD1.x; the VAE defaults to SD_VAE_CONFIG
        for both, as in the JAX package.  Pass `state` to skip file I/O
        (pre-loaded state dicts)."""
        from .models import textenc as TE
        from .models.load import import_unet, import_vae, load_safetensors, split_checkpoint
        from .models.unet import SD15_CONFIG, SDXL_CONFIG
        from .models.vae import SD_VAE_CONFIG
        from .models.zoo import build_unet, build_vae
        from .tokenizers import ClipBpeTokenizer

        comps = split_checkpoint(state if state is not None else load_safetensors(path))
        if family is None:
            family = "sdxl" if "clip_g" in comps else "sd15"
        unet_config = unet_config or (SDXL_CONFIG if family == "sdxl" else SD15_CONFIG)
        vae_config = vae_config or SD_VAE_CONFIG
        built = dict(device=device, param_dtype=param_dtype)
        model, _ = build_unet(unet_config, import_unet(comps["unet"], unet_config, prefix=""),
                              name=family, **built)
        vae = build_vae(vae_config, import_vae(comps["vae"], vae_config, prefix=""), **built)

        tok = ClipBpeTokenizer.from_files(vocab, merges, pad_token_id=clip_pad_token_id)
        encoders: Dict[str, NativeEncoder] = {}
        if "clip_l" in comps:
            cfg_l = clip_l_config or TE.CLIP_L_CONFIG
            encoders["clip_l"] = NativeEncoder(
                "clip", _import_clip_auto(comps["clip_l"], cfg_l), cfg_l, tok, **built)
        if "clip_g" in comps:
            cfg_g = clip_g_config or TE.CLIP_G_CONFIG
            encoders["clip_g"] = NativeEncoder(
                "clip", _import_clip_auto(comps["clip_g"], cfg_g), cfg_g, tok, **built)
        return cls(model, vae=vae, encoders=encoders, family=family, height=height, width=width)

    # ------------------------------------------------------------------
    @classmethod
    def from_components(cls, *, family: str, model, vae,
                        clip_l=None, clip_g=None, t5=None, llama=None,
                        clip_vocab: Optional[str] = None,
                        clip_merges: Optional[str] = None,
                        t5_tokenizer=None, llama_tokenizer=None,
                        with_vision: bool = False,
                        model_config=None, vae_config=None,
                        clip_l_config=None, clip_g_config=None,
                        t5_config=None, llama_config=None,
                        vision_config=None, shift: Optional[float] = None,
                        height: int = 1024, width: int = 1024,
                        device=None, param_dtype: torch.dtype = torch.float32,
                        encoder_dtype: Optional[torch.dtype] = None
                        ) -> "LanPaintPipeline":
        """Build a pipeline from the multi-file layout modern releases ship
        (separate diffusion model / text encoder(s) / VAE safetensors — the
        reference's UNETLoader + DualCLIPLoader + VAELoader node trio).

        Families: "flux" (clip_l + t5 + the 16-channel VAE), "sd35" (clip_l
        + clip_g + t5 + the SD3 VAE; the model's `model.diffusion_model.`
        prefix detected), "qwen" (the Qwen2.5-VL llama stack + the
        Wan2.1-graph VAE at one frame; with_vision=True also loads the
        vision tower, from the same llama state, for Qwen-Image-Edit's image
        conditioning) and "z-image" (the Qwen3-4B stack + the 16-channel
        VAE).  Component
        args accept file paths or pre-loaded state dicts; tokenizer args
        accept paths (tokenizer.json / spiece.model / vocab+merges) or
        constructed tokenizer objects.  *_config args override the
        full-size defaults (used by the tiny-model tests).  The text
        encoders (and the vision tower) take `encoder_dtype` parameters,
        `param_dtype` when it is None: a bf16 diffusion model beside fp32
        encoders, say."""
        from .models import textenc as TE
        from .models import zoo
        from .models.load import (import_clip, import_dit, import_llama, import_t5, import_vae,
                                  load_safetensors)

        if family not in ("flux", "sd35", "qwen", "z-image"):
            raise ValueError(f"from_components: unknown family {family!r} "
                             "(flux, sd35, qwen, z-image)")

        def _state(x):
            return load_safetensors(x) if isinstance(x, str) else x

        def _vae_import(x, vae_cfg):
            st = _state(x)
            pre = ("first_stage_model."
                   if any(k.startswith("first_stage_model.") for k in st)
                   else "")  # combined checkpoints embed the VAE prefixed
            return import_vae(st, vae_cfg, prefix=pre)

        def _clip_tok():
            from .tokenizers import ClipBpeTokenizer

            if not isinstance(clip_vocab, str):
                return clip_vocab  # constructed tokenizer object
            return ClipBpeTokenizer.from_files(clip_vocab, clip_merges)

        def _t5_tok():
            from .tokenizers import from_tokenizer_json, unigram_from_sentencepiece

            if not isinstance(t5_tokenizer, str):
                return t5_tokenizer
            if t5_tokenizer.endswith(".json"):
                return from_tokenizer_json(t5_tokenizer)
            return unigram_from_sentencepiece(t5_tokenizer)

        def _llama_tok():
            from .tokenizers import from_tokenizer_json

            if not isinstance(llama_tokenizer, str):
                return llama_tokenizer
            return from_tokenizer_json(llama_tokenizer)

        from .models.vae import FLUX_VAE_CONFIG

        built = dict(device=device, param_dtype=param_dtype)
        enc_built = dict(device=device, param_dtype=encoder_dtype or param_dtype)
        encoders: Dict[str, Any] = {}
        if family == "flux":
            from .models.dit import FLUX_DEV_CONFIG

            cfg = model_config or FLUX_DEV_CONFIG
            den, _ = zoo.build_dit(cfg, import_dit(_state(model), cfg),
                                   shift=1.15 if shift is None else shift, is_flux=True,
                                   name="flux", **built)
            vae_cfg = vae_config or FLUX_VAE_CONFIG
            vae_module = zoo.build_vae(vae_cfg, _vae_import(vae, vae_cfg), **built)
            cl = clip_l_config or TE.CLIP_L_CONFIG
            tc = t5_config or TE.T5_XXL_CONFIG
            encoders["clip_l"] = NativeEncoder("clip", import_clip(_state(clip_l), cl), cl,
                                               _clip_tok(), **enc_built)
            encoders["t5"] = NativeEncoder("t5", import_t5(_state(t5), tc), tc, _t5_tok(),
                                           **enc_built)
        elif family == "sd35":
            from .models.load import import_sd3
            from .models.sd3 import SD35_LARGE_CONFIG
            from .models.vae import SD3_VAE_CONFIG

            cfg = model_config or SD35_LARGE_CONFIG
            st = _state(model)
            prefix = ("model.diffusion_model."
                      if any(k.startswith("model.diffusion_model.") for k in st) else "")
            den, _ = zoo.build_sd3(cfg, import_sd3(st, cfg, prefix=prefix),
                                   shift=3.0 if shift is None else shift, name="sd35", **built)
            vae_cfg = vae_config or SD3_VAE_CONFIG
            vae_module = zoo.build_vae(vae_cfg, _vae_import(vae, vae_cfg), **built)
            tok = _clip_tok()
            cl = clip_l_config or TE.CLIP_L_CONFIG
            cg = clip_g_config or TE.CLIP_G_CONFIG
            encoders["clip_l"] = NativeEncoder("clip", _import_clip_auto(_state(clip_l), cl), cl,
                                               tok, **enc_built)
            encoders["clip_g"] = NativeEncoder("clip", _import_clip_auto(_state(clip_g), cg), cg,
                                               tok, **enc_built)
            tc = t5_config or TE.T5_XXL_CONFIG
            encoders["t5"] = NativeEncoder("t5", import_t5(_state(t5), tc), tc, _t5_tok(),
                                           **enc_built)
            family = "sd3"
        elif family == "z-image":
            from .models.load import import_zimage
            from .models.zimage import Z_IMAGE_S3_CONFIG

            cfg = model_config or Z_IMAGE_S3_CONFIG
            den, _ = zoo.build_zimage(cfg, import_zimage(_state(model), cfg),
                                      shift=3.0 if shift is None else shift, name="z-image",
                                      **built)
            vae_cfg = vae_config or FLUX_VAE_CONFIG
            vae_module = zoo.build_vae(vae_cfg, _vae_import(vae, vae_cfg), **built)
            lc = llama_config or TE.QWEN3_4B_CONFIG
            encoders["llama"] = NativeEncoder("llama", import_llama(_state(llama), lc), lc,
                                              _llama_tok(), **enc_built)
            family = "qwen3"
        else:  # qwen
            from .models.dit import QWEN_IMAGE_CONFIG
            from .models.load import import_mmdit_auto, import_qwen_vl_vision, import_wan_vae
            from .models.video_vae import QWEN_IMAGE_VAE_CONFIG
            from .text import VisionEncoder

            cfg = model_config or QWEN_IMAGE_CONFIG
            den, _ = zoo.build_dit(cfg, import_mmdit_auto(_state(model), cfg),
                                   shift=2.2 if shift is None else shift, is_flux=False,
                                   name="qwen-image", **built)
            vae_cfg = vae_config or QWEN_IMAGE_VAE_CONFIG
            vae_module = _SingleFrameVAE(
                zoo.build_wan_vae(vae_cfg, import_wan_vae(_state(vae), vae_cfg), **built))
            lst = _state(llama)
            lc = llama_config or TE.QWEN25_7B_CONFIG
            encoders["llama"] = NativeEncoder("llama", import_llama(lst, lc), lc, _llama_tok(),
                                              **enc_built)
            if with_vision:
                from .models.vision import QWEN25_VL_VISION_CONFIG

                vc = vision_config or QWEN25_VL_VISION_CONFIG
                encoders["vision"] = VisionEncoder(import_qwen_vl_vision(lst, vc), vc,
                                                   **enc_built)
        return cls(den, vae=vae_module, encoders=encoders, family=family, height=height,
                   width=width)

    # ------------------------------------------------------------------
    def encode(self, prompt: str, **kw) -> Dict[str, Any]:
        """The prompt's cond dict; for family "qwen", an `image` keyword
        switches to the edit conditioning ("qwen_edit", which needs the
        vision tower: from_components(with_vision=True)), and without one
        the vision tower is left out."""
        if self.family in ("sdxl",):
            kw.setdefault("height", self.height)
            kw.setdefault("width", self.width)
        family = self.family
        encoders = self.encoders
        if family == "qwen" and kw.get("image") is not None:
            if "vision" not in encoders:
                raise ValueError("image conditioning needs from_components(with_vision=True)")
            family = "qwen_edit"
        elif "vision" in encoders:
            encoders = {k: v for k, v in encoders.items() if k != "vision"}
        return encode_prompt(prompt, family=family, **encoders, **kw)

    def sample(self, *, positive, negative=None, latent, mask, **kw):
        """Latent-space LanPaint sampling (node-equivalent ksampler)."""
        return ksampler(self.model, positive=positive, negative=negative, latent=latent,
                        mask=mask, **kw)

    def __call__(self, prompt: str, *, image, mask,
                 negative_prompt: str = "", seed: int = 0, steps: int = 30,
                 cfg: float = 5.0, num_steps: int = 5,
                 sampler_name: str = "euler", scheduler: str = "karras",
                 blend_overlap: int = 9,
                 encode_kw: Optional[Dict[str, Any]] = None, **kw):
        """Pixel-level inpaint: encode prompt(s) + VAE encode -> LanPaint ->
        VAE decode -> MaskBlend.  image: (B, 3, H, W) in [-1, 1]; mask:
        (H, W), 1 = repaint.  `encode_kw` goes to encode_prompt (e.g.
        t5_length); other kwargs go to the sampler."""
        ek = dict(encode_kw or {})
        device = next(self.vae.parameters()).device
        image = torch.as_tensor(image, dtype=torch.float32, device=device)
        mask = torch.as_tensor(mask, dtype=torch.float32, device=device)
        positive = self.encode(prompt, **ek)
        negative = self.encode(negative_prompt, **ek)
        return inpaint_image(
            self.model, self.vae, image=image, mask=mask, positive=positive,
            negative=negative, seed=seed, steps=steps, cfg=cfg, num_steps=num_steps,
            sampler_name=sampler_name, scheduler=scheduler, blend_overlap=blend_overlap, **kw)
