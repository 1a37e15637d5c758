"""Plain operations of the reference, in float32 or, for the control, with
the operands of every product rounded to float8 e4m3 (per-tensor scale)."""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

_MODE = {"precision": "fp32"}
FP8_MAX = 448.0  # the largest finite float8 e4m3 value


@contextlib.contextmanager
def precision(mode: str):
    """Compute the products inside in `mode`: "fp32" (the reference) or
    "fp8" (the control).  TF32 is off either way."""
    if mode not in ("fp32", "fp8"):
        raise ValueError(f"unknown precision {mode!r}")
    saved = (_MODE["precision"], torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    _MODE["precision"] = mode
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (_MODE["precision"], torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def operand(t: torch.Tensor) -> torch.Tensor:
    """A product's operand in float32, rounded through float8 e4m3 under the
    control."""
    t = t.float()
    if _MODE["precision"] == "fp32":
        return t
    scale = torch.clamp_min(t.abs().amax(), 1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x, weight, bias=None):
    y = F.linear(operand(x), operand(weight))
    return y if bias is None else y + bias.float()


def conv2d(x, weight, bias=None, stride=1, padding=0):
    return F.conv2d(operand(x), operand(weight), None if bias is None else bias.float(),
                    stride, padding)


def attention(q, k, v):
    """softmax(q k^T / sqrt(D)) v on (B, S, H, D) / (B, Sk, H, D), float32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf = (operand(t).transpose(1, 2) for t in (q, k, v))
    probs = torch.softmax((qf @ kf.transpose(-1, -2)) * scale, dim=-1)
    return (operand(probs) @ vf).transpose(1, 2)


def layer_norm(x, weight=None, bias=None, eps: float = 1e-6):
    """LayerNorm over the last axis, centred two-pass variance."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt((xf - mu).square().mean(-1, keepdim=True) + eps)
    if weight is not None:
        y = y * weight.float()
    return y if bias is None else y + bias.float()


def rms_norm(x, weight, eps: float = 1e-6):
    xf = x.float()
    return xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps) * weight.float()


def group_norm(x, groups, weight, bias, eps: float = 1e-5):
    return F.group_norm(x.float(), groups, weight.float(), bias.float(), eps)


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """Sinusoidal embedding, [cos | sin] halves."""
    t = torch.as_tensor(t).float()
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class Linear(torch.nn.Module):
    def __init__(self, n_in: int, n_out: int, bias: bool = True):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.empty(n_out, n_in))
        self.bias = torch.nn.Parameter(torch.empty(n_out)) if bias else None

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class Conv2d(torch.nn.Module):
    def __init__(self, n_in: int, n_out: int, k: int, stride: int = 1, padding: int = 0):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.empty(n_out, n_in, k, k))
        self.bias = torch.nn.Parameter(torch.empty(n_out))
        self.stride, self.padding = stride, padding

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self.stride, self.padding)


class GroupNorm32(torch.nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.empty(channels))
        self.bias = torch.nn.Parameter(torch.empty(channels))

    def forward(self, x):
        return group_norm(x, 32, self.weight, self.bias)


class LayerNorm(torch.nn.Module):
    """Affine LayerNorm, eps 1e-6 (the spatial transformer's)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.empty(channels))
        self.bias = torch.nn.Parameter(torch.empty(channels))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias)


class RMSNorm(torch.nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.empty(dim))

    def forward(self, x):
        return rms_norm(x, self.weight)


class MLPEmbedder(torch.nn.Module):
    def __init__(self, n_in: int, hidden: int):
        super().__init__()
        self.in_layer = Linear(n_in, hidden)
        self.out_layer = Linear(hidden, hidden)

    def forward(self, x):
        return self.out_layer(F.silu(self.in_layer(x)))


def gelu(x):
    return F.gelu(x, approximate="tanh")
