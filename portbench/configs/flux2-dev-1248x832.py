"""FLUX.2 [dev]'s transformer at 1248x832 with one reference latent: the
program's builder, the plain reference's, the conditioning a job draws,
and the analytic work of one forward.  The sizes are
`flux2-dev-1248x832.json` beside this file; every function takes them, so a
test can pass a tiny set."""

from __future__ import annotations

import torch

from portbench.harness import files

KIND = "flow"


def build_program(sizes: dict, state: dict, device):
    """The port's Denoiser and module, through `zoo.build_flux2` with the
    benchmark's weights held in place, bfloat16, shift 1.15 and Flux's
    cfg_big rule."""
    from lanpaint_tpu_torch.models import flux2, zoo

    cfg = files.config_of(flux2.Flux2Config, sizes, dtype=torch.bfloat16)
    return zoo.build_flux2(cfg, state, shift=sizes["shift"], device=device,
                           param_dtype=torch.bfloat16, name="flux2-dev")


def build_reference(sizes: dict):
    """The plain float32 FLUX.2 denoiser, its parameters on the meta device."""
    from portbench.reference.flux2 import FlowDenoiser, Flux2

    with torch.device("meta"):
        module = Flux2(sizes)
    return FlowDenoiser(module), module


def sigma_table(sizes: dict):
    from portbench.reference.lanpaint import flow_table

    return flow_table(sizes["shift"])


def cfg_big(cfg: float) -> float:
    """Flux's guidance-distilled backbones take 1 on the known region
    (reference nodes.py:217-218)."""
    return 1.0


def conditioning(sizes: dict, gen: torch.Generator, device) -> dict:
    """One prompt's conditioning at the encoder's output shape, N(0, 1),
    the embedded guidance, and the reference latent's packed tokens,
    N(0, 1)."""
    ctx = torch.randn((1, sizes["context_tokens"], sizes["context_dim"]), generator=gen,
                      device=device)
    ref = torch.randn((1, sizes["ref_tokens"], sizes["in_channels"]), generator=gen,
                      device=device)
    return {"context": ctx, "guidance": torch.full((1,), float(sizes["guidance"]), device=device),
            "ref_tokens": ref}


def _tokens(s):
    """(target image tokens, reference tokens, text tokens)."""
    _, h, w = s["latent_shape"]
    return (h // s["patch"]) * (w // s["patch"]), s["ref_tokens"], s["context_tokens"]


def flops(sizes: dict, batch: int) -> float:
    """Floating-point operations of one forward at `batch`: 2 M N K a
    matrix product (no biases; SwiGLU's first projection twice the MLP
    width), 4 B H S S D an attention over the joint sequence; the reference
    tokens ride the image stream, the final layer sees the target's tokens
    alone; elementwise work (norms, RoPE, modulation's mix, SwiGLU's
    product) not counted."""
    s, b = sizes, batch
    hid, mlp = s["hidden"], int(s["hidden"] * s["mlp_ratio"])
    n_img, n_ref, n_txt = _tokens(s)
    seq = n_img + n_ref + n_txt
    total = 2 * b * ((n_img + n_ref) * s["in_channels"] * hid + n_txt * s["context_dim"] * hid)
    total += 2 * 2 * b * (s["time_channels"] * hid + hid * hid)     # time and guidance
    total += 2 * b * (6 + 6 + 3) * hid * hid                        # the shared modulations
    attention = 4 * b * seq * seq * hid
    double = 2 * b * seq * hid * (3 * hid + hid + 2 * mlp + mlp) + attention
    single = 2 * b * seq * (hid * (3 * hid + 2 * mlp) + (hid + mlp) * hid) + attention
    total += s["depth_double"] * double + s["depth_single"] * single
    total += 2 * b * 2 * hid * hid + 2 * b * n_img * hid * s["in_channels"]
    return float(total)


def attention_calls(sizes: dict, batch: int) -> list:
    """The joint self-attention of every block, (B, H, S, S, D, calls)."""
    s = sizes
    seq = sum(_tokens(s))
    d = s["hidden"] // s["num_heads"]
    return [(batch, s["num_heads"], seq, seq, d, s["depth_double"] + s["depth_single"])]
