"""Random weights drawn on the device from the seed, in one large call.

Every matrix or convolution kernel and every bias is N(0, 0.02^2) and
every norm scale (a one-dimensional `weight`) 1 + N(0, 0.02^2), in the
dtype the program serves in.  The draw is one `torch.randn` over the
concatenation of all leaves, norm scales first, then a scale and one
shift of the norm scales' prefix; the leaves are views of it.  The same
seed and table give the same bits on the same device."""

from __future__ import annotations

import math

import torch

from .seeds import derive

STD = 0.02


def is_norm_scale(name: str, shape) -> bool:
    return len(shape) == 1 and name.endswith("weight")


def draw(shapes: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """{name: tensor} for every (name, shape) of `shapes`."""
    names = sorted(shapes, key=lambda n: not is_norm_scale(n, shapes[n]))
    sizes = [math.prod(shapes[n]) for n in names]
    n_norm = sum(s for n, s in zip(names, sizes) if is_norm_scale(n, shapes[n]))
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    flat.mul_(STD)
    flat[:n_norm].add_(1.0)
    return {n: part.view(shapes[n]) for n, part in zip(names, flat.split(sizes))}
