"""Wan2.2-TI2V-5B at 704x1280 x 33 frames: the program's DiT and VAE as
`zoo` makes them, the plain reference's, the conditioning a job draws, and the
analytic work of one DiT forward.  The sizes are `wan22-ti2v-5b.json`
beside this file (the VAE's under "vae"); every function takes them, so a
test can pass a tiny set."""

from __future__ import annotations

import math

import torch

from portbench.harness import files, weights
from portbench.harness.seeds import derive

KIND = "flow"


def program_configs(sizes: dict):
    """The port's (WanConfig, WanVAEConfig) of the sizes: the DiT computes
    in bfloat16 with its adaLN modulation in bfloat16, the VAE in its
    default dtype, no latent normalization."""
    from lanpaint_tpu_torch.models import video_vae, wan

    dit = files.config_of(wan.WanConfig, sizes, dtype=torch.bfloat16,
                          residual_dtype=torch.bfloat16)
    vae = files.config_of(video_vae.WanVAEConfig, sizes["vae"], latents_mean=None,
                          latents_std=None)
    return dit, vae


def build_program(sizes: dict, state: dict, device):
    """The port's Denoiser and DiT module, through `zoo.build_wan` with the
    benchmark's weights in bfloat16 and the configuration's shift."""
    from lanpaint_tpu_torch.models import zoo

    cfg, _ = program_configs(sizes)
    return zoo.build_wan(cfg, state, shift=sizes["shift"], device=device,
                         param_dtype=torch.bfloat16, name="wan22-ti2v-5b")


def build_vae(sizes: dict, state: dict, device):
    """The port's Wan2.2 VAE through `zoo.build_wan_vae`, its parameters in
    float32, that function's default."""
    from lanpaint_tpu_torch.models import zoo

    _, cfg = program_configs(sizes)
    return zoo.build_wan_vae(cfg, state, device=device)


def build_reference(sizes: dict):
    """The plain float32 Wan DiT denoiser, its parameters on the meta
    device."""
    from portbench.reference.wan import FlowDenoiser, WanDiT

    with torch.device("meta"):
        module = WanDiT(sizes)
    return FlowDenoiser(module), module


def build_reference_vae(sizes: dict):
    """The plain float32 chunked Wan2.2 VAE, on the meta device."""
    from portbench.reference.wan_vae import WanVAE

    with torch.device("meta"):
        return WanVAE(sizes["vae"])


def draw_vae(shapes: dict, seed: int, device) -> dict:
    """The VAE's weights from the seed (`weights.draw` under a seed of its
    own), its RMS gammas made norm scales, 1 + N(0, 0.02^2)."""
    state = weights.draw(shapes, derive(seed, "vae"), device)
    for name, t in state.items():
        if name.endswith(".gamma"):
            t.add_(1.0)
    return state


def sigma_table(sizes: dict):
    from portbench.reference.lanpaint import flow_table

    return flow_table(sizes["shift"])


def cfg_big(cfg: float) -> float:
    """"Image First", the default: cfg itself on the known region."""
    return cfg


def conditioning(sizes: dict, gen: torch.Generator, device) -> dict:
    """One prompt's conditioning at the UMT5-XXL encoder's output shape,
    N(0, 1)."""
    return {"context": torch.randn((1, sizes["context_tokens"], sizes["context_dim"]),
                                   generator=gen, device=device)}


def _tokens(s):
    _, f, h, w = s["latent_shape"]
    return math.prod((f // s["patch"][0], h // s["patch"][1], w // s["patch"][2]))


def flops(sizes: dict, batch: int) -> float:
    """Floating-point operations of one DiT forward at `batch`, as the
    program runs it: 2 M N K a matrix product, 4 B H Sq Sk D an attention;
    elementwise work (norms, RoPE, modulation) not counted, nor the text
    embedding and the cross-attention k and v, which the program computes
    once a job (`WanModel.precompute_kv`)."""
    s, b = sizes, batch
    hid, ffn = s["hidden"], s["ffn_dim"]
    seq, txt = _tokens(s), s["context_tokens"]
    patch = s["in_channels"] * math.prod(s["patch"])
    total = 2 * b * seq * patch * hid                                 # patch embedding
    total += 2 * b * (256 * hid + hid * hid + hid * 6 * hid)          # time embedding
    block = (2 * b * seq * hid * 4 * hid                              # self q, k, v, o
             + 4 * b * seq * seq * hid                                # self-attention
             + 2 * b * seq * hid * 2 * hid                            # cross q, o
             + 4 * b * seq * txt * hid                                # cross-attention
             + 2 * b * seq * hid * 2 * ffn)                           # the FFN
    total += s["depth"] * block
    total += 2 * b * seq * hid * s["out_channels"] * math.prod(s["patch"])  # the head
    return float(total)


def attention_calls(sizes: dict, batch: int) -> list:
    """The self-attention of every block, (B, H, S, S, D, calls): the calls
    that run in the attention class.  The cross-attention over the text
    (Sk = 512) runs as float32 products and a softmax
    (`ops.attention.attention_ref`), which the profiler counts as gemm and
    softmax, so its work is not set against the attention class's time."""
    s = sizes
    seq = _tokens(s)
    return [(batch, s["num_heads"], seq, seq, s["hidden"] // s["num_heads"], s["depth"])]
