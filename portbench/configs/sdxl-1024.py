"""SDXL-base's UNet at 1024x1024: the program's builder, the plain
reference's, the conditioning a job draws, and the analytic work of one
forward.  The sizes are `sdxl-1024.json` beside this file; every function
takes them, so a test can pass a tiny set."""

from __future__ import annotations

import torch

from portbench.harness import files

KIND = "eps"


def build_program(sizes: dict, state: dict, device):
    """The port's Denoiser and module, through `zoo.build_unet` with the
    benchmark's weights, bfloat16."""
    from lanpaint_tpu_torch.models import unet, zoo

    cfg = files.config_of(unet.UNetConfig, sizes, dtype=torch.bfloat16)
    return zoo.build_unet(cfg, state, device=device, param_dtype=torch.bfloat16, name="sdxl")


def build_reference(sizes: dict):
    """The plain float32 UNet denoiser, its parameters on the meta device."""
    from portbench.reference.unet import EpsDenoiser, UNet

    with torch.device("meta"):
        module = UNet(sizes)
    return EpsDenoiser(module), module


def sigma_table(sizes: dict):
    from portbench.reference.unet import eps_sigmas

    return eps_sigmas()


def cfg_big(cfg: float) -> float:
    """The bidirectional score's guidance on the known region: "Image
    First", the ksampler default, takes cfg itself."""
    return cfg


def conditioning(sizes: dict, gen: torch.Generator, device) -> dict:
    """One prompt's conditioning at the encoders' output shapes, N(0, 1)."""
    ctx = torch.randn((1, sizes["context_tokens"], sizes["context_dim"]), generator=gen,
                      device=device)
    y = torch.randn((1, sizes["adm_in_channels"]), generator=gen, device=device)
    return {"context": ctx, "y": y}


def _levels(s):
    """(resolution divisor, channels, transformer depth) of every block the
    forward runs, in order: ("res", div, c_in, c_out), ("attn", div, c,
    depth), ("down", div, c), ("up", div, c)."""
    mc, ops, skips, ch_in = s["model_channels"], [], [s["model_channels"]], s["model_channels"]
    div = 1
    for level, mult in enumerate(s["channel_mult"]):
        ch = mc * mult
        for _ in range(s["num_res_blocks"]):
            ops.append(("res", div, ch_in, ch))
            if s["transformer_depth"][level]:
                ops.append(("attn", div, ch, s["transformer_depth"][level]))
            ch_in = ch
            skips.append(ch)
        if level != len(s["channel_mult"]) - 1:
            ops.append(("down", div, ch))
            div *= 2
            skips.append(ch)
    ops.append(("res", div, ch_in, ch_in))
    if s["transformer_depth_middle"]:
        ops.append(("attn", div, ch_in, s["transformer_depth_middle"]))
    ops.append(("res", div, ch_in, ch_in))
    for level, mult in reversed(list(enumerate(s["channel_mult"]))):
        ch = mc * mult
        for _ in range(s["num_res_blocks"] + 1):
            ops.append(("res", div, ch_in + skips.pop(), ch))
            if s["transformer_depth"][level]:
                ops.append(("attn", div, ch, s["transformer_depth"][level]))
            ch_in = ch
        if level != 0:
            div //= 2
            ops.append(("up", div, ch))
    return ops


def _heads(s, ch):
    return ch // s["head_dim"] if s["head_dim"] is not None else s["num_heads"]


def flops(sizes: dict, batch: int) -> float:
    """Floating-point operations of one forward at `batch`: 2 M N K a
    matrix product, 2 per multiply-add of a convolution's outputs, 4 B H Sq
    Sk D an attention; the cross-attention k | v, computed once a job, and
    elementwise work not counted."""
    s, b = sizes, batch
    _, h, w = s["latent_shape"]
    mc, emb, t = s["model_channels"], 4 * s["model_channels"], s["context_tokens"]
    total = 2 * b * (mc * emb + emb * emb)
    if s["adm_in_channels"] is not None:
        total += 2 * b * (s["adm_in_channels"] * emb + emb * emb)
    total += 2 * b * h * w * 9 * (s["in_channels"] * mc + mc * s["out_channels"])
    for op in _levels(s):
        kind, div = op[0], op[1]
        px = (h // div) * (w // div)
        if kind == "res":
            c_in, c = op[2], op[3]
            total += 2 * b * px * 9 * (c_in * c + c * c) + 2 * b * emb * c
            total += 2 * b * px * c_in * c if c_in != c else 0
        elif kind == "down":
            total += 2 * b * (px // 4) * 9 * op[2] ** 2
        elif kind == "up":
            total += 2 * b * px * 9 * op[2] ** 2
        else:
            c, depth = op[2], op[3]
            total += 2 * 2 * b * px * c * c  # proj_in, proj_out
            per_block = (2 * b * px * c * (3 * c + c + c + c + 8 * c + 4 * c)
                         + 4 * b * px * px * c + 4 * b * px * t * c)
            total += depth * per_block
    return float(total)


def attention_calls(sizes: dict, batch: int) -> list:
    """The self-attention calls of one forward that the attention kernels
    serve, as (B, H, Sq, Sk, D, calls); the 77-token cross-attention is not
    among them."""
    s = sizes
    _, h, w = s["latent_shape"]
    calls = {}
    for op in _levels(s):
        if op[0] == "attn":
            px, c = (h // op[1]) * (w // op[1]), op[2]
            key = (batch, _heads(s, c), px, px, c // _heads(s, c))
            calls[key] = calls.get(key, 0) + op[3]
    return [k + (n,) for k, n in calls.items()]
