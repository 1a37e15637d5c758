"""Qwen2.5-VL vision tower: the image half of Qwen-Image-Edit conditioning.

PyTorch counterpart of `lanpaint_tpu/models/vision.py`.  The reference's
Qwen edit workflows (example_workflows/Qwen_Image_Edit_2509.json) encode the
source image through Qwen2.5-VL: ViT patches -> 32 blocks of windowed
attention (full attention every 8th block) -> 2x2 patch merger, and the
merged vision tokens are spliced into the prompt sequence of the Qwen2.5
text stack (models/textenc.py QWEN25_7B_CONFIG).

As in the JAX module, the window partition is static for an image grid and
computed on the host in numpy (`vision_plan`, a copy of the JAX package's):
partial edge windows are padded to full windows and masked, so window
attention is one batched attention over (n_windows, window_len) and the
full-attention blocks one pass over the padded sequence.  The Conv3d patch
embed (kernel == stride) is one matmul over patches flattened by
`preprocess_image` in the HF processor's order.

The JAX module runs no TPU kernel here (`jax.nn.dot_product_attention` with
a key mask and a jnp RMS), so neither does the port: attention is
`textenc.masked_attention` (SDPA with JAX's masked fill), the RMS plain
torch in fp32.  The RMS scales are raw parameters (`blocks.<i>.norm1`,
`norm2`, `ln_q`), as the flax module's `self.param`s, so models/bridge.py
maps the scanned tree one to one.  `zoo.build_vision` makes one on the CUDA
card unless `device` names another.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Linear
from .textenc import _rotate_half, masked_attention

# HF processor constants (transformers image_utils OPENAI_CLIP_MEAN/STD)
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class QwenVLVisionConfig:
    depth: int = 32
    hidden: int = 1280
    num_heads: int = 16
    intermediate: int = 3420
    in_channels: int = 3
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    window_size: int = 112              # pixels per attention window side
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    out_hidden: int = 3584              # text-stack width (QWEN25_7B dim)
    rms_eps: float = 1e-6
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden // self.num_heads

    @property
    def merge_unit(self) -> int:
        return self.spatial_merge_size ** 2

    @property
    def window_units(self) -> int:
        """Merged-token units per window side (HF vit_merger_window_size)."""
        return self.window_size // self.spatial_merge_size // self.patch_size


# Qwen2.5-VL-7B-Instruct's vision_config (the qwen_2.5_vl_7b.safetensors the
# reference's Qwen workflows load) and the JAX package's tiny test config
QWEN25_VL_VISION_CONFIG = QwenVLVisionConfig()
TINY_VL_VISION_CONFIG = QwenVLVisionConfig(
    depth=4, hidden=32, num_heads=4, intermediate=48, patch_size=2,
    window_size=8, fullatt_block_indexes=(1, 3), out_hidden=24,
)


@functools.lru_cache(maxsize=32)
def vision_plan(cfg: QwenVLVisionConfig, grid: Tuple[int, int, int]):
    """Static window / RoPE plan for one image grid (t, h, w in raw patches).

    Mirrors HF get_window_index / rot_pos_emb (modeling_qwen2_5_vl.py) but
    keeps the padded window slots instead of filtering them.  Returns numpy
    arrays:

    gather   (Sp_units,)  source merged-unit index per padded slot (0 for pad)
    valid    (Sp_units,)  bool, slot holds a real unit
    inv      (S_units,)   padded slot holding original unit i
    cos/sin  (Sp, head_dim) rotary tables in padded window order
    n_win    number of windows; win_len = raw tokens per window
    """
    t, h, w = grid
    m = cfg.spatial_merge_size
    if h % m or w % m:
        raise ValueError(f"grid {grid} not divisible by merge size {m}")
    lh, lw = h // m, w // m
    vw = cfg.window_units
    pad_h, pad_w = (-lh) % vw, (-lw) % vw
    nwh, nww = (lh + pad_h) // vw, (lw + pad_w) // vw

    idx = np.arange(t * lh * lw).reshape(t, lh, lw)
    idxp = np.full((t, lh + pad_h, lw + pad_w), -1, np.int64)
    idxp[:, :lh, :lw] = idx
    idxp = (idxp.reshape(t, nwh, vw, nww, vw)
                .transpose(0, 1, 3, 2, 4).reshape(-1))
    valid = idxp >= 0
    gather = np.where(valid, idxp, 0)
    inv = np.zeros(t * lh * lw, np.int64)
    inv[idxp[valid]] = np.nonzero(valid)[0]

    # rotary tables: (h, w) position per raw token in merged-group order
    hpos = np.broadcast_to(np.arange(h)[:, None], (h, w))
    wpos = np.broadcast_to(np.arange(w)[None, :], (h, w))

    def group(p):
        return p.reshape(lh, m, lw, m).transpose(0, 2, 1, 3).reshape(-1)

    pos = np.stack([group(hpos), group(wpos)], axis=-1)      # (h*w, 2)
    pos = np.tile(pos, (t, 1))                                # (S_raw, 2)
    half = cfg.head_dim // 2
    inv_freq = 1.0 / (cfg.rope_theta
                      ** (np.arange(0, half, 2, np.float32) / half))
    freqs = pos[:, :, None] * inv_freq[None, None, :]         # (S, 2, half/2)
    rpe = freqs.reshape(pos.shape[0], -1)                     # (S, half)
    # permute raw tokens into padded window order (unit = m*m raw tokens)
    unit = cfg.merge_unit
    rpe = rpe.reshape(-1, unit, rpe.shape[-1])[gather].reshape(-1, half)
    emb = np.concatenate([rpe, rpe], axis=-1)                 # (Sp, head_dim)
    return dict(
        gather=gather, valid=valid, inv=inv,
        cos=np.cos(emb).astype(np.float32),
        sin=np.sin(emb).astype(np.float32),
        n_win=t * nwh * nww, win_len=vw * vw * unit,
    )


def _rms(x, scale, eps):
    xf = x.float()
    return xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps) * scale.float()


class _VisionBlock(nn.Module):
    """RMS -> fused-qkv attention (RoPE in fp32; windowed, or full over the
    padded sequence) -> RMS -> biased SwiGLU."""

    _NORM_PARAMS = ("norm1", "norm2")  # RMS scales: ones at random init

    def __init__(self, c: QwenVLVisionConfig):
        super().__init__()
        self.cfg = c
        dt = c.dtype
        self.norm1 = nn.Parameter(torch.ones(c.hidden))
        self.qkv = Linear(c.hidden, 3 * c.hidden, compute_dtype=dt)
        self.proj = Linear(c.hidden, c.hidden, compute_dtype=dt)
        self.norm2 = nn.Parameter(torch.ones(c.hidden))
        self.gate = Linear(c.hidden, c.intermediate, compute_dtype=dt)
        self.up = Linear(c.hidden, c.intermediate, compute_dtype=dt)
        self.down = Linear(c.intermediate, c.hidden, compute_dtype=dt)

    def forward(self, x, plan, is_full: bool):
        c = self.cfg
        dt = c.dtype
        s = x.shape[0]
        nh, hd = c.num_heads, c.head_dim
        h = _rms(x, self.norm1, c.rms_eps).to(dt)
        q, k, v = self.qkv(h).view(s, 3 * nh, hd).chunk(3, dim=1)
        cs, sn = plan["cos"][:, None, :], plan["sin"][:, None, :]
        q = (q.float() * cs + _rotate_half(q.float()) * sn).to(dt)
        k = (k.float() * cs + _rotate_half(k.float()) * sn).to(dt)
        key_ok = plan["key_ok"]
        if is_full:
            att = masked_attention(q[None], k[None], v[None], key_ok[None, None, None, :])[0]
        else:
            n_win, win_len = plan["n_win"], plan["win_len"]
            shape = (n_win, win_len, nh, hd)
            mask = key_ok.reshape(n_win, win_len)[:, None, None, :]
            att = masked_attention(q.reshape(shape), k.reshape(shape), v.reshape(shape),
                                   mask).reshape(s, nh, hd)
        x = x + self.proj(att.reshape(s, c.hidden))
        h = _rms(x, self.norm2, c.rms_eps).to(dt)
        return x + self.down(F.silu(self.gate(h)) * self.up(h))


class QwenVLVision(nn.Module):
    """forward(patches (S, C*tps*ps*ps), grid) -> (S / merge_unit, out_hidden).

    `grid` (t, h, w in raw patches) is the image's: the parameters do not
    depend on it, and `device_plan(grid, device)` (the tensors of
    `vision_plan` on the device) may be made once and passed in."""

    _NORM_PARAMS = ("ln_q",)

    def __init__(self, cfg: QwenVLVisionConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
        patch_in = c.in_channels * c.temporal_patch_size * c.patch_size ** 2
        self.patch_embed = Linear(patch_in, c.hidden, bias=False, compute_dtype=c.dtype)
        self.blocks = nn.ModuleList(_VisionBlock(c) for _ in range(c.depth))
        self.ln_q = nn.Parameter(torch.ones(c.hidden))
        unit = c.merge_unit
        self.merger_0 = Linear(unit * c.hidden, unit * c.hidden, compute_dtype=c.dtype)
        self.merger_2 = Linear(unit * c.hidden, c.out_hidden, compute_dtype=c.dtype)

    def device_plan(self, grid, device) -> dict:
        plan = vision_plan(self.cfg, tuple(grid))
        out = {k: torch.from_numpy(plan[k]).to(device)
               for k in ("gather", "valid", "inv", "cos", "sin")}
        out["key_ok"] = out["valid"].repeat_interleave(self.cfg.merge_unit)
        out.update(n_win=plan["n_win"], win_len=plan["win_len"])
        return out

    def forward(self, patches, grid, plan=None):
        c = self.cfg
        if plan is None:
            plan = self.device_plan(grid, patches.device)
        unit = c.merge_unit
        s_raw = patches.shape[0]
        x = self.patch_embed(patches.to(c.dtype))
        # merged units into padded window order; pad slots are zero
        x = x.reshape(s_raw // unit, unit, c.hidden)
        x = torch.where(plan["valid"][:, None, None], x[plan["gather"]],
                        torch.zeros((), dtype=x.dtype, device=x.device))
        sp = x.shape[0] * unit
        x = x.reshape(sp, c.hidden)
        full = set(c.fullatt_block_indexes)
        for i, block in enumerate(self.blocks):
            x = block(x, plan, i in full)
        # patch merger: RMS -> concat the 2x2 unit -> MLP (exact GELU)
        x = _rms(x, self.ln_q, c.rms_eps).to(c.dtype)
        x = x.reshape(sp // unit, unit * c.hidden)
        x = self.merger_2(F.gelu(self.merger_0(x)))
        # the original merged-token order, pad slots dropped
        return x[plan["inv"]]


def smart_resize(height: int, width: int, factor: int = 28,
                 min_pixels: int = 56 * 56,
                 max_pixels: int = 14 * 14 * 4 * 1280) -> Tuple[int, int]:
    """HF qwen2_vl smart_resize: round to multiples of `factor` inside the
    pixel budget, preserving aspect ratio."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("aspect ratio must be < 200")
    h = round(height / factor) * factor
    w = round(width / factor) * factor
    if h * w > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h = max(factor, math.floor(height / beta / factor) * factor)
        w = max(factor, math.floor(width / beta / factor) * factor)
    elif h * w < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h = math.ceil(height * beta / factor) * factor
        w = math.ceil(width * beta / factor) * factor
    return h, w


def _keys_cubic(x):
    """Keys' cubic convolution kernel, a = -0.5."""
    x = np.abs(x)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def _cubic_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of `jax.image.resize(..., "bicubic")` along one
    axis: Keys' kernel, widened by the scale when downsampling
    (antialiasing), each column normalized, in fp32."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = _keys_cubic(x)
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(np.float32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resize_bicubic(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """(H, W, C) fp32 -> (height, width, C): `jax.image.resize(img, (height,
    width, C), "bicubic")` (antialiased), as two fp32 matrix products (one
    along each resized axis)."""
    h, w, c = img.shape
    out = img.astype(np.float32)
    if height != h:
        out = (_cubic_resize_weights(h, height).T @ out.reshape(h, w * c)).reshape(height, w, c)
    if width != w:
        rows = out.shape[0]
        out = out.transpose(0, 2, 1).reshape(rows * c, w) @ _cubic_resize_weights(w, width)
        out = out.reshape(rows, c, width).transpose(0, 2, 1)
    return np.ascontiguousarray(out, dtype=np.float32)


def preprocess_image(img: np.ndarray, cfg: QwenVLVisionConfig, resize: bool = True):
    """(H, W, 3) float [0, 1] pixels -> (patches (S, C*tps*ps*ps), grid).

    The HF Qwen2VLImageProcessor patch pipeline, as the JAX package runs it:
    smart_resize to multiples of patch*merge (bicubic, `resize_bicubic`),
    CLIP mean/std normalize, the frame duplicated temporal_patch_size
    times, flattened in the processor's (gh, gw, mh, mw, C, tps, ph, pw)
    order.  Host numpy."""
    img = np.asarray(img, np.float32)
    hh, ww = img.shape[:2]
    factor = cfg.patch_size * cfg.spatial_merge_size
    if resize and (hh % factor or ww % factor):
        th, tw = smart_resize(hh, ww, factor)
        img = resize_bicubic(img, th, tw)
        hh, ww = th, tw
    img = (img - np.asarray(CLIP_IMAGE_MEAN)) / np.asarray(CLIP_IMAGE_STD)
    chw = img.transpose(2, 0, 1)                               # (C, H, W)
    frames = np.broadcast_to(chw, (cfg.temporal_patch_size,) + chw.shape)
    ps, m = cfg.patch_size, cfg.spatial_merge_size
    gh, gw = hh // ps, ww // ps
    p = frames.reshape(1, cfg.temporal_patch_size, cfg.in_channels,
                       gh // m, m, ps, gw // m, m, ps)
    p = p.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    patches = p.reshape(gh * gw, cfg.in_channels
                        * cfg.temporal_patch_size * ps * ps)
    return patches.astype(np.float32), (1, gh, gw)
