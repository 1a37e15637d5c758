"""LoRA merging into checkpoint-layout state dicts.

The reference's "works with custom LoRAs" capability (reference
README.md:133) is host-provided there (ComfyUI ModelPatcher weight
patching); here LoRAs merge into the torch-layout state dict *before*
`import_unet`/`import_dit`/... so the bijective key mappers stay the single
source of truth:

    state = load_safetensors(ckpt)
    state = apply_lora(state, load_safetensors(lora), strength=0.8)
    params = import_unet(state, cfg)

Supported LoRA layouts:
- kohya / ComfyUI: ``lora_unet_<key with _>.lora_down.weight`` /
  ``.lora_up.weight`` / ``.alpha`` (underscored key names are resolved by
  building the forward map from the state dict's own keys — no guessing).
- diffusers / PEFT: ``<key>.lora_A.weight`` / ``<key>.lora_B.weight``.

Merge math: ``W += strength * (alpha / rank) * up @ down`` (conv kernels
flattened to 2-D for the product and reshaped back).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _merge_pair(w: np.ndarray, down: np.ndarray, up: np.ndarray,
                alpha: float, strength: float) -> np.ndarray:
    rank = down.shape[0]
    scale = strength * (alpha / rank)
    if w.ndim == 2:
        delta = up.reshape(up.shape[0], -1) @ down.reshape(rank, -1)
    else:  # conv (O, I, kh, kw); up (O, r, 1, 1), down (r, I, kh, kw)
        delta = (up.reshape(up.shape[0], rank)
                 @ down.reshape(rank, -1)).reshape(w.shape)
    return (w.astype(np.float32) + scale * delta.astype(np.float32)).astype(w.dtype)


def _kohya_name(state_key: str) -> str:
    """state-dict key -> kohya LoRA base name."""
    k = state_key
    for prefix, tag in (("model.diffusion_model.", "lora_unet_"),
                        ("diffusion_model.", "lora_unet_"),
                        ("", "lora_unet_")):
        if k.startswith(prefix):
            body = k[len(prefix):]
            if body.endswith(".weight"):
                body = body[: -len(".weight")]
            return tag + body.replace(".", "_")
    raise AssertionError


def apply_lora(state: Dict[str, np.ndarray], lora: Dict[str, np.ndarray],
               strength: float = 1.0) -> Dict[str, np.ndarray]:
    """Return a copy of `state` with `lora` merged at `strength`.

    Unmatched LoRA pairs raise KeyError listing the leftovers, so silent
    partial application cannot happen.
    """
    out = dict(state)
    # forward map: every mergeable state key under both naming schemes
    by_kohya = {}
    by_plain = {}
    for k in state:
        if not k.endswith(".weight"):
            continue
        by_kohya[_kohya_name(k)] = k
        by_plain[k[: -len(".weight")]] = k

    down_suffixes = (".lora_down.weight", ".lora_A.weight")
    up_for = {".lora_down.weight": ".lora_up.weight",
              ".lora_A.weight": ".lora_B.weight"}
    unmatched = []
    for lk in sorted(lora):
        for ds in down_suffixes:
            if not lk.endswith(ds):
                continue
            base = lk[: -len(ds)]
            target = by_kohya.get(base) or by_plain.get(base)
            if target is None:
                unmatched.append(base)
                break
            down = np.asarray(lora[lk])
            up = np.asarray(lora[base + up_for[ds]])
            a = lora.get(base + ".alpha")
            alpha = float(np.asarray(a).item()) if a is not None \
                else float(down.shape[0])
            out[target] = _merge_pair(np.asarray(out[target]), down, up,
                                      alpha, strength)
            break
    if unmatched:
        raise KeyError(f"LoRA keys with no matching model weight: "
                       f"{unmatched[:5]}{'...' if len(unmatched) > 5 else ''}")
    return out
