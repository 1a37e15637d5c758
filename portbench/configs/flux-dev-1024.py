"""FLUX.1-dev's transformer at 1024x1024: the program's builder, the plain
reference's, the conditioning a job draws, and the analytic work of one
forward.  The sizes are `flux-dev-1024.json` beside this file; every
function takes them, so a test can pass a tiny set."""

from __future__ import annotations

import torch

from portbench.harness import files

KIND = "flow"


def build_program(sizes: dict, state: dict, device):
    """The port's Denoiser and module, through `zoo.build_dit` with the
    benchmark's weights, bfloat16, Flux's shift and cfg_big rule."""
    from lanpaint_tpu_torch.models import dit, zoo

    cfg = files.config_of(dit.DiTConfig, sizes, dtype=torch.bfloat16)
    return zoo.build_dit(cfg, state, shift=sizes["shift"], is_flux=True, device=device,
                         param_dtype=torch.bfloat16, name="flux-dev")


def build_reference(sizes: dict):
    """The plain float32 MMDiT denoiser, its parameters on the meta device."""
    from portbench.reference.dit import FlowDenoiser, MMDiT

    with torch.device("meta"):
        module = MMDiT(sizes)
    return FlowDenoiser(module), module


def sigma_table(sizes: dict):
    from portbench.reference.lanpaint import flow_table

    return flow_table(sizes["shift"])


def cfg_big(cfg: float) -> float:
    """Flux's guidance-distilled backbones take 1 on the known region
    (reference nodes.py:217-218)."""
    return 1.0


def conditioning(sizes: dict, gen: torch.Generator, device) -> dict:
    """One prompt's conditioning at the encoders' output shapes, N(0, 1),
    and the distilled guidance."""
    ctx = torch.randn((1, sizes["context_tokens"], sizes["context_dim"]), generator=gen,
                      device=device)
    vec = torch.randn((1, sizes["vec_dim"]), generator=gen, device=device)
    return {"context": ctx, "vec": vec,
            "guidance": torch.full((1,), float(sizes["guidance"]), device=device)}


def _tokens(s):
    _, h, w = s["latent_shape"]
    return (h // s["patch"]) * (w // s["patch"]), s["context_tokens"]


def flops(sizes: dict, batch: int) -> float:
    """Floating-point operations of one forward at `batch`: 2 M N K a
    matrix product, 4 B H S S D an attention over the joint sequence;
    elementwise work (norms, RoPE, modulation's mix) not counted."""
    s, b = sizes, batch
    hid, mlp = s["hidden"], int(s["hidden"] * s["mlp_ratio"])
    n_img, n_txt = _tokens(s)
    seq = n_img + n_txt
    total = 2 * b * (n_img * s["in_channels"] * hid + n_txt * s["context_dim"] * hid)
    embedders = 1 + int(s["guidance_embed"])
    total += embedders * 2 * b * (256 * hid + hid * hid)
    if s["vec_dim"] > 0:
        total += 2 * b * (s["vec_dim"] * hid + hid * hid)
    attention = 4 * b * seq * seq * hid
    double = (2 * 2 * b * 6 * hid * hid                      # img / txt modulation
              + 2 * b * seq * hid * (3 * hid + hid + 2 * mlp) + attention)
    single = (2 * b * 3 * hid * hid + 2 * b * seq * (hid * (3 * hid + mlp) + (hid + mlp) * hid)
              + attention)
    total += s["depth_double"] * double + s["depth_single"] * single
    total += 2 * b * 2 * hid * hid + 2 * b * n_img * hid * s["out_channels"]
    return float(total)


def attention_calls(sizes: dict, batch: int) -> list:
    """The joint self-attention of every block, (B, H, S, S, D, calls)."""
    s = sizes
    seq = sum(_tokens(s))
    d = s["hidden"] // s["num_heads"]
    return [(batch, s["num_heads"], seq, seq, d, s["depth_double"] + s["depth_single"])]
