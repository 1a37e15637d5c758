"""Text-conditioning assembly for every backbone family.

PyTorch counterpart of `lanpaint_tpu/text.py`.  The `*_cond` functions
take raw encoder outputs (torch tensors, or arrays: from HF transformers,
from `NativeEncoder`, or any other source) and produce the cond dict each
zoo denoiser expects, as fp32 tensors on the outputs' device.
`encode_prompt_hf` runs HuggingFace text encoders the caller built and
passes in (the package imports no `transformers`).  `NativeEncoder` and
`encode_prompt` run the standalone tokenizers (tokenizers.py) and the
port's own encoders (models/textenc.py) on the card.

Conventions (public model cards / reference hosts):
- SD1.x/2.x: single CLIP hidden-state sequence.
- SDXL: CLIP-L ⊕ CLIP-G hidden states on the channel axis (2048) + pooled
  CLIP-G with size micro-conditioning (`sdxl_pooled_y`).
- SD3/3.5: (CLIP-L ⊕ CLIP-G) zero-padded from 2048 to the T5 width (4096)
  and concatenated with T5-XXL along the sequence; vec = pooled-L ⊕ pooled-G.
- Flux family: T5-XXL sequence + pooled CLIP-L vec (+ guidance scalar).
- Qwen-Image / Wan2.2: the LLM/umt5 hidden-state sequence directly.
- HiDream: T5 sequence + pooled vec + per-layer Llama hidden states.

The Llama-stack families (qwen, qwen_edit, qwen3, hidream, hyvideo) and
the Qwen2.5-VL vision tower wait for their models (ROADMAP A.14): their
encoders raise NotImplementedError.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

_WAITS = ("the Llama / Qwen text stacks and the Qwen2.5-VL vision tower are not ported yet "
          "(ROADMAP A.16 / A.14)")
_LLAMA_FAMILIES = ("qwen", "qwen_edit", "qwen3", "hidream", "hyvideo")


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
# encoders (models/textenc.py) on the card -> cond dict


class NativeEncoder:
    """One text encoder = (module, config, tokenizer).

    kind: "clip" (CLIPTextConfig) or "t5" (T5Config); "llama" waits for
    ROADMAP A.16 / A.14.  `params` is the encoder's state_dict (from
    `models/load.import_clip`, `import_clip_openclip` or `import_t5`),
    built into a module on `device` (the CUDA card when None) with
    `param_dtype` parameters, or an encoder module already built
    (`zoo.build_clip` / `build_t5`), used where it lies.  Prompts
    tokenize on the host; the ids go to the module's device."""

    def __init__(self, kind: str, params, cfg, tokenizer, clip_skip: int = 2, *,
                 device=None, param_dtype: torch.dtype = torch.float32):
        from .models import zoo

        if kind == "llama":
            raise NotImplementedError(f"NativeEncoder('llama'): {_WAITS}")
        if kind not in ("clip", "t5"):
            raise ValueError(kind)
        if isinstance(params, nn.Module):
            self.module = params
        else:
            build = zoo.build_clip if kind == "clip" else zoo.build_t5
            self.module = build(cfg, params, device=device, param_dtype=param_dtype)
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


def encode_prompt(prompt: str, *, family: str,
                  clip_l: Optional[NativeEncoder] = None,
                  clip_g: Optional[NativeEncoder] = None,
                  t5: Optional[NativeEncoder] = None,
                  t5_length: int = 512, **assemble_kw) -> Dict[str, Any]:
    """Prompt string -> cond dict, on the encoders' device.

    Families: sd15 (clip_l), sdxl (clip_l+clip_g), sd3 (clip_l+clip_g+t5),
    flux (clip_l+t5), wan (t5).  CLIP hidden states use each encoder's
    clip_skip (default 2 = penultimate, the hosts' convention).  The
    Llama-stack families (qwen, qwen_edit, qwen3, hidream, hyvideo) raise
    NotImplementedError (ROADMAP A.16 / A.14), and the JAX signature's
    llama, vision and image arguments wait with them."""

    waiting = sorted({"llama", "vision", "image"} & assemble_kw.keys())
    if waiting:
        raise NotImplementedError(f"encode_prompt({', '.join(waiting)}=...): {_WAITS}")

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
    if family in _LLAMA_FAMILIES:
        raise NotImplementedError(f"encode_prompt(family={family!r}): {_WAITS}")
    raise ValueError(f"unknown family {family!r}")
