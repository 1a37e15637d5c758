"""Classifier-free-guidance double pass.

PyTorch counterpart of `lanpaint_tpu/guidance.py` (reference
src/LanPaint/nodes.py:85-132): a cond/uncond forward per model call, then two
CFG mixes — the normal `cfg` and the `cfg_big` used by the bidirectional
score on the known region — returning `(x0, x0_big)`.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch

# A "model x0 function": (x, t, cond) -> x0 prediction; cond is a tensor or
# a (nested) dict / list / tuple of tensors batched along axis 0.
ModelX0Fn = Callable[[torch.Tensor, torch.Tensor, Any], torch.Tensor]
# A "double denoiser": (x, t) -> (x0, x0_big); what the engine consumes.
DoubleDenoiser = Callable[[torch.Tensor, torch.Tensor], tuple]


def resolve_cfg_big(prompt_mode: str, cfg: float, is_flux: bool = False) -> float:
    """cfg_big policy (reference nodes.py:217-220, 337-340).

    "Image First" -> cfg_big = cfg; "Prompt First" -> cfg_big = -0.5;
    FLUX(-family guidance-distilled) backbones force cfg_big = 1.0.
    """
    if is_flux:
        return 1.0
    if prompt_mode == "Image First":
        return float(cfg)
    if prompt_mode == "Prompt First":
        return -0.5
    raise ValueError(f"unknown prompt_mode: {prompt_mode!r}")


def _concat_tree(a, b):
    """Concatenate two conditioning trees of the same structure on axis 0;
    ValueError for dicts of different keys, as `jax.tree.map` raises (a
    dual_model_denoiser's negative cond holds a `model_select` the positive
    lacks, so its batched CFG fails here as in the JAX package)."""
    if isinstance(a, dict):
        if set(a) != set(b):
            raise ValueError(f"cond and uncond differ in their keys: {sorted(a)} against "
                             f"{sorted(b)}")
        return {k: _concat_tree(a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_concat_tree(x, y) for x, y in zip(a, b))
    return torch.cat([a, b], dim=0)


def make_cfg_double_denoiser(
    model_x0: ModelX0Fn,
    cond: Any,
    uncond: Optional[Any],
    cfg: float,
    cfg_big: float,
    disable_cfg1_optimization: bool = False,
    pre_cfg_fns: Optional[list] = None,
    sequential: bool = False,
) -> DoubleDenoiser:
    """Build the (x0, x0_big) double denoiser from a raw model-x0 function.

    With cfg == 1 (and the optimization not disabled) the uncond pass is
    skipped and BOTH outputs equal the cond prediction (nodes.py:86-89).
    `sequential` runs two B-sized passes instead of one 2B-sized pass (same
    math, half the peak activation memory).  `pre_cfg_fns` see
    {"conds_out": [cond_pred, uncond_pred], "cond_scale", "input", "sigma"}
    and return the new conds_out list (nodes.py:94-97).
    """
    skip_uncond = uncond is None or (
        math.isclose(float(cfg), 1.0) and not disable_cfg1_optimization
    )

    if skip_uncond:

        def denoise_single(x, t):
            x0_c = model_x0(x, t, cond)
            return x0_c, x0_c

        return denoise_single

    def denoise_double(x, t):
        b = x.shape[0]
        tb = torch.broadcast_to(torch.as_tensor(t, device=x.device), (b,))
        if sequential:
            x0_c = model_x0(x, tb, cond)
            x0_u = model_x0(x, tb, uncond)
        else:
            out = model_x0(torch.cat([x, x], dim=0), torch.cat([tb, tb], dim=0),
                           _concat_tree(cond, uncond))
            x0_c, x0_u = out[:b], out[b:]
        for fn in (pre_cfg_fns or []):
            x0_c, x0_u = fn({"conds_out": [x0_c, x0_u], "cond_scale": cfg,
                             "input": x, "sigma": t})
        delta = x0_c - x0_u
        return x0_u + delta * cfg, x0_u + delta * cfg_big

    return denoise_double
