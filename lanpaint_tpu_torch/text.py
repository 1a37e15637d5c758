"""Text-conditioning assembly for every backbone family.

PyTorch counterpart of `lanpaint_tpu/text.py`.  The `*_cond` functions
take raw encoder outputs (torch tensors, or arrays: from HF transformers,
from `NativeEncoder`, or any other source) and produce the cond dict each
zoo denoiser expects, as fp32 tensors on the outputs' device.
`encode_prompt_hf` runs HuggingFace text encoders the caller built and
passes in (the package imports no `transformers`).  `NativeEncoder`,
`VisionEncoder` and `encode_prompt` run the standalone tokenizers
(tokenizers.py), the port's own encoders (models/textenc.py) and the
Qwen2.5-VL vision tower (models/vision.py) on the card.

Conventions (public model cards / reference hosts):
- SD1.x/2.x: single CLIP hidden-state sequence.
- SDXL: CLIP-L ⊕ CLIP-G hidden states on the channel axis (2048) + pooled
  CLIP-G with size micro-conditioning (`sdxl_pooled_y`).
- SD3/3.5: (CLIP-L ⊕ CLIP-G) zero-padded from 2048 to the T5 width (4096)
  and concatenated with T5-XXL along the sequence; vec = pooled-L ⊕ pooled-G.
- Flux family: T5-XXL sequence + pooled CLIP-L vec (+ guidance scalar).
- Qwen-Image / Wan2.2: the LLM/umt5 hidden-state sequence directly.
- Qwen-Image-Edit: the source image as Qwen2.5-VL vision tokens spliced
  into the prompt sequence, with the 3-stream multimodal rope.
- HiDream: T5 sequence + pooled vec + per-layer Llama hidden states.
- HunyuanVideo: llava-llama3 hidden states behind a chat template, its
  system prefix cropped, + pooled CLIP-L.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

def _a(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().float()
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


def sd15_cond(clip_hidden) -> Dict[str, Any]:
    return {"context": _a(clip_hidden)}


def sdxl_cond(clip_l_hidden, clip_g_hidden, clip_g_pooled,
              height: int = 1024, width: int = 1024, **size_kw) -> Dict[str, Any]:
    from .models.unet import sdxl_pooled_y

    context = torch.cat([_a(clip_l_hidden), _a(clip_g_hidden)], dim=-1)
    y = sdxl_pooled_y(_a(clip_g_pooled), height, width, **size_kw)
    return {"context": context, "y": y}


def sd3_cond(t5_hidden, clip_l_hidden, clip_g_hidden,
             clip_l_pooled, clip_g_pooled) -> Dict[str, Any]:
    clip = torch.cat([_a(clip_l_hidden), _a(clip_g_hidden)], dim=-1)
    t5 = _a(t5_hidden)
    clip = torch.nn.functional.pad(clip, (0, t5.shape[-1] - clip.shape[-1]))
    context = torch.cat([clip, t5], dim=1)
    vec = torch.cat([_a(clip_l_pooled), _a(clip_g_pooled)], dim=-1)
    return {"context": context, "vec": vec}


def flux_cond(t5_hidden, clip_pooled, guidance: Optional[float] = None) -> Dict[str, Any]:
    cond = {"context": _a(t5_hidden), "vec": _a(clip_pooled)}
    if guidance is not None:
        ctx = cond["context"]
        cond["guidance"] = torch.full((ctx.shape[0],), float(guidance), dtype=torch.float32,
                                      device=ctx.device)
    return cond


def qwen_cond(llm_hidden) -> Dict[str, Any]:
    return {"context": _a(llm_hidden)}


def wan_cond(umt5_hidden) -> Dict[str, Any]:
    return {"context": _a(umt5_hidden)}


def hidream_cond(t5_hidden, pooled, llama_hidden_stack) -> Dict[str, Any]:
    """llama_hidden_stack: (L, B, S, D) per-layer Llama hidden states."""
    return {"context": _a(t5_hidden), "vec": _a(pooled), "llama": _a(llama_hidden_stack)}


def hyvideo_cond(llama_hidden, clip_l_pooled) -> Dict[str, Any]:
    """HunyuanVideo dual encoder: llava-llama3 token features (context,
    refined on-model by the token refiner) + CLIP-L pooled (vec)."""
    return {"context": _a(llama_hidden), "vec": _a(clip_l_pooled)}


def encode_prompt_hf(prompt: str, *, clip_l=None, clip_g=None, t5=None,
                     tokenizer_l=None, tokenizer_g=None, tokenizer_t5=None,
                     family: str = "sdxl", max_length: int = 77,
                     **assemble_kw) -> Dict[str, Any]:
    """Run HuggingFace text encoders (the torch models and tokenizers the
    caller built) and assemble cond.

    Pass the already-constructed HF models/tokenizers for the family:
    sd15 (clip_l), sdxl (clip_l + clip_g), sd3 (clip_l + clip_g + t5),
    flux (clip_l + t5).  CLIP hidden states are taken from the penultimate
    layer (the hosts' "clip skip 1" default for SDXL-class models).
    """

    def run_clip(tok, model, length):
        ids = tok([prompt], padding="max_length", max_length=length,
                  truncation=True, return_tensors="pt")
        with torch.no_grad():
            out = model(**ids, output_hidden_states=True)
        hidden = out.hidden_states[-2]
        pooled = getattr(out, "text_embeds", None)
        if pooled is None:
            pooled = out.pooler_output if hasattr(out, "pooler_output") else None
        return hidden, pooled

    def run_t5(tok, model, length):
        ids = tok([prompt], padding="max_length", max_length=length,
                  truncation=True, return_tensors="pt")
        with torch.no_grad():
            return model(**ids).last_hidden_state

    if family == "sd15":
        ids = tokenizer_l([prompt], padding="max_length", max_length=max_length,
                          truncation=True, return_tensors="pt")
        with torch.no_grad():
            hidden = clip_l(**ids).last_hidden_state
        return sd15_cond(hidden)
    if family == "sdxl":
        h_l, _ = run_clip(tokenizer_l, clip_l, max_length)
        h_g, p_g = run_clip(tokenizer_g, clip_g, max_length)
        return sdxl_cond(h_l, h_g, p_g, **assemble_kw)
    if family == "sd3":
        h_l, p_l = run_clip(tokenizer_l, clip_l, max_length)
        h_g, p_g = run_clip(tokenizer_g, clip_g, max_length)
        h_t5 = run_t5(tokenizer_t5, t5, assemble_kw.pop("t5_length", 154))
        return sd3_cond(h_t5, h_l, h_g, p_l, p_g)
    if family == "flux":
        _, p_l = run_clip(tokenizer_l, clip_l, max_length)
        h_t5 = run_t5(tokenizer_t5, t5, assemble_kw.pop("t5_length", 512))
        return flux_cond(h_t5, p_l, **assemble_kw)
    raise ValueError(f"unknown family {family!r}")


# --------------------------------------------------------------------------
# the native path: standalone tokenizers (tokenizers.py) + the port's
# encoders (models/textenc.py, models/vision.py) on the card -> cond dict


QWEN_IMAGE_TEMPLATE = (
    "<|im_start|>system\nDescribe the image by detailing the color, shape, "
    "size, texture, quantity, text, spatial relationships of the objects "
    "and background:<|im_end|>\n<|im_start|>user\n{}<|im_end|>\n"
    "<|im_start|>assistant\n")

# Qwen-Image-Edit convention (public diffusers QwenImageEditPipeline): the
# source image rides the prompt as Qwen2.5-VL vision tokens between
# <|vision_start|>/<|vision_end|>; the first 64 hidden states (system
# prefix) are dropped before conditioning.
QWEN_IMAGE_EDIT_TEMPLATE = (
    "<|im_start|>system\nDescribe the key features of the input image "
    "(color, shape, size, texture, objects, background), then explain how "
    "the user's text instruction should alter or modify the image. Generate "
    "a new image that meets the user's requirements while maintaining "
    "consistency with the original input where appropriate.<|im_end|>\n"
    "<|im_start|>user\n<|vision_start|><|image_pad|><|vision_end|>{}"
    "<|im_end|>\n<|im_start|>assistant\n")
QWEN_EDIT_DROP_PREFIX = 64

# Qwen2.5-VL special token ids (HF tokenizer.json added_tokens)
QWEN_VL_IMAGE_PAD_ID = 151655

# HunyuanVideo llava-llama3 chat templates (official hyvideo
# constants.PROMPT_TEMPLATE): the system prefix is cropped from the hidden
# states before conditioning (crop_start 36 image / 95 video).
HYVIDEO_IMAGE_TEMPLATE = (
    "<|start_header_id|>system<|end_header_id|>\n\nDescribe the image by "
    "detailing the color, shape, size, texture, quantity, text, spatial "
    "relationships of the objects and background:<|eot_id|>"
    "<|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>")
HYVIDEO_IMAGE_CROP = 36
HYVIDEO_VIDEO_TEMPLATE = (
    "<|start_header_id|>system<|end_header_id|>\n\nDescribe the video by "
    "detailing the following aspects: 1. The main content and theme of the "
    "video.2. The color, shape, size, texture, quantity, text, and spatial "
    "relationships of the objects.3. Actions, events, behaviors temporal "
    "relationships, physical movement changes of the objects.4. background "
    "environment, light, style and atmosphere.5. camera angles, movements, "
    "and transitions used in the video:<|eot_id|>"
    "<|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>")
HYVIDEO_VIDEO_CROP = 95


def qwen_vl_pos_ids(n_before: int, grid, n_after: int, merge: int = 2) -> np.ndarray:
    """Qwen2.5-VL multimodal rope position ids (3, S) for one image span.

    Mirrors HF Qwen2_5_VLModel.get_rope_index for [text; image; text]:
    text before gets sequential ids 0..n_before-1 in all three streams;
    the vision span gets (t, row, col) grid ids offset by n_before; text
    after resumes at n_before + max(t, lh, lw)."""
    t, h, w = grid
    lh, lw = h // merge, w // merge
    pre = np.broadcast_to(np.arange(n_before), (3, n_before))
    tt = np.repeat(np.arange(t), lh * lw)
    hh = np.tile(np.repeat(np.arange(lh), lw), t)
    ww = np.tile(np.arange(lw), t * lh)
    vis = np.stack([tt, hh, ww]) + n_before
    start = n_before + max(t, lh, lw)
    post = np.broadcast_to(np.arange(n_after), (3, n_after)) + start
    return np.concatenate([pre, vis, post], axis=1).astype(np.int32)


class VisionEncoder:
    """The Qwen2.5-VL vision tower: __call__((H, W, 3) pixels in [0, 1]) ->
    (tokens (N, out_hidden), grid).

    `params` is the tower's state_dict (`models/load.import_qwen_vl_vision`),
    built on `device` (the CUDA card when None) with `param_dtype`
    parameters, or a tower already built (`zoo.build_vision`), used where it
    lies.  The image is preprocessed on the host (`vision.preprocess_image`);
    the window plan of each image grid is made on the device once and
    cached, so reuse one encoder across calls."""

    def __init__(self, params, cfg=None, *, device=None,
                 param_dtype: torch.dtype = torch.float32):
        from .models import zoo
        from .models.vision import QWEN25_VL_VISION_CONFIG

        self.cfg = QWEN25_VL_VISION_CONFIG if cfg is None else cfg
        if isinstance(params, nn.Module):
            self.module = params
        else:
            self.module = zoo.build_vision(self.cfg, params, device=device,
                                           param_dtype=param_dtype)
        self._plans: Dict[tuple, dict] = {}

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    @torch.no_grad()
    def __call__(self, image):
        from .models.vision import preprocess_image

        if isinstance(image, torch.Tensor):
            image = image.detach().float().cpu().numpy()
        patches, grid = preprocess_image(np.asarray(image), self.cfg)
        if grid not in self._plans:
            self._plans[grid] = self.module.device_plan(grid, self.device)
        tokens = self.module(torch.from_numpy(patches).to(self.device), grid, self._plans[grid])
        return tokens, grid


class NativeEncoder:
    """One text encoder = (module, config, tokenizer).

    kind: "clip" (CLIPTextConfig), "t5" (T5Config) or "llama"
    (LlamaConfig).  `params` is the encoder's state_dict (from
    `models/load.import_clip`, `import_clip_openclip`, `import_t5` or
    `import_llama`), built into a module on `device` (the CUDA card when
    None) with `param_dtype` parameters, or an encoder module already built
    (`zoo.build_clip` / `build_t5` / `build_llama`), used where it lies.
    Prompts tokenize on the host; the ids go to the module's device."""

    def __init__(self, kind: str, params, cfg, tokenizer, clip_skip: int = 2, *,
                 device=None, param_dtype: torch.dtype = torch.float32):
        from .models import zoo

        builders = {"clip": zoo.build_clip, "t5": zoo.build_t5, "llama": zoo.build_llama}
        if kind not in builders:
            raise ValueError(kind)
        if isinstance(params, nn.Module):
            self.module = params
        else:
            self.module = builders[kind](cfg, params, device=device, param_dtype=param_dtype)
        self.kind = kind
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.clip_skip = clip_skip

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    def ids(self, prompt: str, length: Optional[int] = None) -> torch.Tensor:
        tok = self.tokenizer
        if self.kind == "clip":
            out = tok.encode(prompt)
        else:
            out = tok.encode(prompt, pad_to=length) if length else tok.encode(prompt)
        return torch.tensor([out], dtype=torch.long, device=self.device)

    @torch.no_grad()
    def __call__(self, prompt: str, length: Optional[int] = None):
        return self.module(self.ids(prompt, length))

    @torch.no_grad()
    def with_vision(self, ids: torch.Tensor, vision_tokens: torch.Tensor, pos: int, grid):
        """Run the (llama-kind) stack with `vision_tokens` spliced into the
        embedding sequence at position `pos` and the multimodal rope
        position ids of the image `grid`: the Qwen2.5-VL path."""
        if self.kind != "llama":
            raise ValueError("with_vision requires a llama-kind encoder")
        ids = torch.as_tensor(ids, device=self.device)
        n = vision_tokens.shape[0]
        x = self.module.embed_tokens[ids]
        x[:, pos:pos + n] = vision_tokens.to(x.dtype)
        pos_ids = torch.from_numpy(qwen_vl_pos_ids(pos, grid, ids.shape[1] - pos - n))
        return self.module(ids, embeds=x, pos_ids=pos_ids.to(self.device))


def encode_prompt(prompt: str, *, family: str,
                  clip_l: Optional[NativeEncoder] = None,
                  clip_g: Optional[NativeEncoder] = None,
                  t5: Optional[NativeEncoder] = None,
                  llama: Optional[NativeEncoder] = None,
                  vision: Optional[VisionEncoder] = None,
                  image=None,
                  t5_length: int = 512, **assemble_kw) -> Dict[str, Any]:
    """Prompt string -> cond dict, on the encoders' device.

    Families: sd15 (clip_l), sdxl (clip_l+clip_g), sd3 (clip_l+clip_g+t5),
    flux (clip_l+t5), wan (t5), qwen (llama: the Qwen-Image template, its
    34 prefix states dropped), qwen_edit (llama + vision + image: the
    source image as Qwen2.5-VL vision tokens in the prompt sequence),
    qwen3 (bare Qwen3 final states: Z-Image, Anima, Klein, Krea2), hidream
    (llama + clip_l + t5: the Llama trunk's per-layer states after the
    embedding, CLIP-L pooled, T5; with clip_g, the pooled vec is CLIP-L's
    followed by CLIP-G's, the full-size model's 2,048) and hyvideo (llama + clip_l: the
    HunyuanVideo image template, or the video one with video=True, its
    system prefix cropped).  CLIP hidden states use each encoder's
    clip_skip (default 2 = penultimate, the hosts' convention)."""

    def clip_out(enc):
        hs, _last, pooled = enc(prompt)
        return hs[enc.cfg.layers + 1 - enc.clip_skip], pooled

    if family == "sd15":
        h, _ = clip_out(clip_l)
        return sd15_cond(h)
    if family == "sdxl":
        h_l, _ = clip_out(clip_l)
        h_g, p_g = clip_out(clip_g)
        return sdxl_cond(h_l, h_g, p_g, **assemble_kw)
    if family == "sd3":
        h_l, p_l = clip_out(clip_l)
        h_g, p_g = clip_out(clip_g)
        h_t5 = t5(prompt, assemble_kw.pop("sd3_t5_length", 154))
        return sd3_cond(h_t5, h_l, h_g, p_l, p_g)
    if family == "flux":
        _, p_l = clip_out(clip_l)
        return flux_cond(t5(prompt, t5_length), p_l, **assemble_kw)
    if family == "wan":
        return wan_cond(t5(prompt, t5_length))
    if family == "qwen":
        # Qwen-Image convention (public diffusers QwenImagePipeline): the
        # prompt is wrapped in a vision-describe chat template and the
        # template-prefix hidden states are dropped before conditioning.
        tpl = assemble_kw.pop("template", QWEN_IMAGE_TEMPLATE)
        drop = assemble_kw.pop("drop_prefix_tokens", 34 if tpl is QWEN_IMAGE_TEMPLATE else 0)
        _hs, final = llama(tpl.format(prompt) if tpl else prompt)
        return qwen_cond(final[:, drop:])
    if family == "qwen_edit":
        # Qwen-Image-Edit: vision tokens spliced at the <|image_pad|> slot,
        # the system-prefix hidden states dropped (diffusers QwenImageEdit
        # convention); the rest, the vision span included, is the context.
        tpl = assemble_kw.pop("template", QWEN_IMAGE_EDIT_TEMPLATE)
        drop = assemble_kw.pop("drop_prefix_tokens", QWEN_EDIT_DROP_PREFIX)
        pad_id = assemble_kw.pop("image_pad_id", QWEN_VL_IMAGE_PAD_ID)
        vision_tokens, grid = vision(image)
        n = int(vision_tokens.shape[0])
        ids = list(llama.tokenizer.encode(tpl.format(prompt)))
        pos = ids.index(pad_id)
        ids = ids[:pos] + [pad_id] * n + ids[pos + 1:]
        ids_t = torch.tensor([ids], dtype=torch.long, device=llama.device)
        _hs, final = llama.with_vision(ids_t, vision_tokens, pos, grid)
        return qwen_cond(final[:, drop:])
    if family == "qwen3":
        # plain Qwen3 final hidden states as context: the prompt stack of
        # Z-Image and the Anima / Flux.2-Klein / Krea2 families
        # (docs/family_facts.md); pass template= to wrap the prompt
        tpl = assemble_kw.pop("template", None)
        _hs, final = llama(tpl.format(prompt) if tpl else prompt)
        return qwen_cond(final)
    if family == "hidream":
        hs, _final = llama(prompt)
        pooled = clip_out(clip_l)[1]
        if clip_g is not None:
            # HiDream-I1's pooled input is CLIP-L's 768 + CLIP-G's 1280
            # (HIDREAM_I1_CONFIG.vec_dim 2048); the JAX family takes CLIP-L's
            # alone, which that model's vector_in refuses
            pooled = torch.cat([pooled, clip_out(clip_g)[1]], dim=-1)
        return hidream_cond(t5(prompt, t5_length), pooled, hs[1:])
    if family == "hyvideo":
        # HunyuanVideo dual encoder: llava-llama3 hidden states behind the
        # official chat template with its system prefix cropped, + CLIP-L
        # pooled; video=True selects the video template (crop 95, not 36)
        video = assemble_kw.pop("video", False)
        tpl = assemble_kw.pop("template",
                              HYVIDEO_VIDEO_TEMPLATE if video else HYVIDEO_IMAGE_TEMPLATE)
        crop = assemble_kw.pop("crop_start", HYVIDEO_VIDEO_CROP if video else HYVIDEO_IMAGE_CROP)
        _hs, final = llama(tpl.format(prompt))
        pooled = clip_out(clip_l)[1]
        return hyvideo_cond(final[:, crop:], pooled)
    raise ValueError(f"unknown family {family!r}")
