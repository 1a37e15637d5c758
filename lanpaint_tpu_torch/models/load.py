"""Checkpoint loading: torch / safetensors state dicts -> this package's
module state_dicts, and back.

PyTorch counterpart of the parts of `lanpaint_tpu/models/load.py` whose
models the port runs: the reader (`load_safetensors`,
`safetensors_header_keys`), the entry-table machinery (`expected_keys`,
`manifest_coverage`, `key_census`, `split_checkpoint`), and the importers
and exporters of the SD UNets (with `fuse_unet_qkv` / `unfuse_unet_qkv`)
and their ControlNets,
the AutoencoderKL VAE, CLIP (HF and OpenCLIP layouts), T5 / UMT5, the
Llama / Qwen text trunk, the Qwen2.5-VL vision tower, the MMDiT (Flux
layout, Qwen-Image's diffusers layout, the stand-ins' census guard), FLUX.2
(a table of its own, checkpoint key to state_dict key), SD3 / SD3.5,
HiDream-I1, HunyuanVideo, Z-Image, the Wan DiT and the Wan VAE.

The entry tables are the JAX package's, row for row: (checkpoint key, flax
path, kind, stack), stack None for a plain tensor or (index, depth) for one
depth of a scanned stack.  An importer maps each checkpoint tensor through
the table's layout rule (`_t_in`, checkpoint -> flax) and then through
`bridge`'s rule (flax -> module), leaf by leaf, so that its result equals
`bridge.params_from_flax` of the JAX importer's tree bit for bit without
building the tree (the two transposes cancel: most results are views of
the checkpoint's own arrays).  An exporter runs the same rules backwards.
Importers return torch tensors ready for the builders' `state_dict=`;
exporters take a module's `state_dict()` and return the checkpoint's
tensors, on the state's device.
"""

from __future__ import annotations

import json
import re
import struct
from typing import Dict

import numpy as np
import torch

from . import bridge


def _tensor(value) -> torch.Tensor:
    """A checkpoint value as a torch tensor (numpy arrays are shared)."""
    if isinstance(value, torch.Tensor):
        return value
    arr = np.ascontiguousarray(value)
    if not arr.flags.writeable:  # torch may not share a read-only buffer
        arr = arr.copy()
    return torch.from_numpy(arr)


def t_linear(w):
    return w.permute(1, 0)


def t_conv2d(w):
    return w.permute(2, 3, 1, 0)  # OIHW -> HWIO


def load_safetensors(path: str, native: bool = True) -> Dict[str, np.ndarray]:
    """Read a safetensors file into numpy arrays, dequantizing fp8_scaled
    tensors.

    fp8_scaled layout: `<name>.weight` stored as float8_e4m3fn with a
    matching `<name>.scale_weight` fp32 scalar or tensor; the weight is
    fp8.astype(f32) * scale.  bf16 and fp8 widen to fp32; fp32 and fp16 pass
    through.  The reader is `native/loader.py`: its C++ conversion, or with
    `native=False` torch's dtypes.  A file it cannot read raises (the JAX
    package falls back to the `safetensors` package, which the port does not
    use)."""
    from ..native.loader import load_safetensors_fast

    return load_safetensors_fast(path, native=native)


def _t_in(kind, w):
    """checkpoint tensor -> flax leaf layout."""
    if kind in ("linear", "linear_nb", "raw_linear"):
        return t_linear(w)
    if kind == "conv":
        return t_conv2d(w)
    if kind == "linear_or_conv1x1":
        return t_linear(w[:, :, 0, 0] if w.ndim == 4 else w)
    if kind == "conv3d":
        # (O, I, kt, kh, kw) -> NDHWC kernel (kt, kh, kw, I, O)
        return w.permute(2, 3, 4, 1, 0)
    if kind == "conv2d3d":
        # torch Conv2d inside a 3D graph -> the (1, kh, kw, I, O) kernel
        return w[:, :, None].permute(2, 3, 4, 1, 0)
    if kind in ("gamma4", "gamma3"):
        return w.reshape(-1)  # Wan RMS_norm gamma (C,1,1,1)/(C,1,1) -> (C,)
    if isinstance(kind, tuple) and kind[0] == "conv3d_as_linear":
        # (O, I, pf, ph, pw) Conv3D kernel -> the patchify Dense (I*p, O)
        return w.reshape(w.shape[0], -1).T if w.ndim == 5 else w
    return w  # norms, raw


def _t_out(kind, w):
    """flax leaf -> checkpoint tensor layout."""
    if kind in ("linear", "linear_nb", "linear_or_conv1x1", "raw_linear"):
        return w.permute(1, 0)
    if kind == "conv":
        return w.permute(3, 2, 0, 1)
    if kind == "conv3d":
        return w.permute(4, 3, 0, 1, 2)
    if kind == "conv2d3d":
        return w.permute(4, 3, 0, 1, 2)[:, :, 0]
    if kind == "gamma4":
        return w.reshape(-1, 1, 1, 1)
    if kind == "gamma3":
        return w.reshape(-1, 1, 1)
    if isinstance(kind, tuple) and kind[0] == "conv3d_as_linear":
        if w.ndim == 2:  # kernel (I*pf*ph*pw, O) -> (O, I, pf, ph, pw)
            return w.permute(1, 0).reshape(w.shape[1], *kind[1])
        return w
    return w


def _leaves(kind):
    """(ckpt_suffix, flax_leaf) pairs a kind contributes."""
    if isinstance(kind, tuple):
        kind = kind[0]
    if kind in ("norm", "ln"):
        return [("weight", "scale"), ("bias", "bias")]
    if kind == "rms":
        return [("scale", "scale")]
    if kind in ("gamma4", "gamma3"):
        return [("gamma", "gamma")]
    if kind == "linear_nb":
        return [("weight", "kernel")]
    if kind == "raw":
        return [("", "")]
    if kind == "raw_linear":
        return [("weight", "")]
    if kind == "rms_weight":
        return [("weight", "")]  # HF RMSNorm: 1-D `.weight`, a raw leaf param
    if kind == "rms_w":
        return [("weight", "scale")]  # torch RMSNorm `.weight` -> flax scale
    return [("weight", "kernel"), ("bias", "bias")]


class _StateBuilder:
    """The port's `_TreeBuilder`: accumulates plain and depth-stacked leaves
    by flax path, then emits the module's state_dict (each stacked leaf
    unstacked into its depths' keys, each value in the module's layout)."""

    def __init__(self):
        self.plain = {}
        self.stacks = {}

    def set(self, path, value):
        self.plain[tuple(path)] = value

    def set_stacked(self, path, idx, depth, value):
        slot = self.stacks.setdefault((tuple(path), depth), [None] * depth)
        slot[idx] = value

    def build(self) -> dict:
        out = {}

        def put(path, v):
            out[bridge.state_key(path)] = bridge.module_layout(path, v).contiguous()

        for path, v in self.plain.items():
            put(path, v)
        for (path, depth), vs in self.stacks.items():
            missing = [i for i, v in enumerate(vs) if v is None]
            if missing:
                raise KeyError(f"missing stacked entries {missing} for {path}")
            for i, v in enumerate(vs):
                put(bridge.unstack(path, i), v)
        return out


# --------------------------------------------------------------------------
# mapping tables.  Entry: (ckpt_key, flax_path, kind, stack)
# stack = None for plain tensors, (idx, depth) for per-depth stacked leaves.


def _unet_entries(cfg, encoder_only: bool = False):
    e = []
    e += [(f"time_embed.{i}", ("time_embed", n), "linear", None)
          for i, n in [(0, "in_layer"), (2, "out_layer")]]
    if cfg.adm_in_channels is not None:
        e += [(f"label_emb.0.{i}", ("label_emb", n), "linear", None)
              for i, n in [(0, "in_layer"), (2, "out_layer")]]
    e.append(("input_blocks.0.0", ("input_conv",), "conv", None))
    if not encoder_only:
        e.append(("out.0", ("out_norm", "GroupNorm_0"), "norm", None))
        e.append(("out.2", ("out_conv",), "conv", None))

    def res(ckpt, flax, skip):
        # skip_connection exists in real checkpoints ONLY when the block
        # changes channel count (ldm ResBlock 1x1 conv)
        out = [
            (f"{ckpt}.in_layers.0", flax + ("in_norm", "GroupNorm_0"), "norm", None),
            (f"{ckpt}.in_layers.2", flax + ("in_conv",), "conv", None),
            (f"{ckpt}.emb_layers.1", flax + ("emb_proj",), "linear", None),
            (f"{ckpt}.out_layers.0", flax + ("out_norm", "GroupNorm_0"), "norm", None),
            (f"{ckpt}.out_layers.3", flax + ("out_conv",), "conv", None),
        ]
        if skip:
            out.append((f"{ckpt}.skip_connection", flax + ("skip_conv",), "conv", None))
        return out

    def attn(ckpt, flax, depth):
        out = [
            (f"{ckpt}.norm", flax + ("norm", "GroupNorm_0"), "norm", None),
            (f"{ckpt}.proj_in", flax + ("proj_in",), "linear_or_conv1x1", None),
            (f"{ckpt}.proj_out", flax + ("proj_out",), "linear_or_conv1x1", None),
        ]
        base = flax + ("blocks", "block")
        for j in range(depth):
            b = f"{ckpt}.transformer_blocks.{j}"
            st = (j, depth)
            out += [
                (f"{b}.norm1", base + ("norm1",), "ln", st),
                (f"{b}.norm2", base + ("norm2",), "ln", st),
                (f"{b}.norm3", base + ("norm3",), "ln", st),
                (f"{b}.ff.net.0.proj", base + ("ff", "net_0", "proj"), "linear", st),
                (f"{b}.ff.net.2", base + ("ff", "net_2"), "linear", st),
            ]
            for a in ("attn1", "attn2"):
                out += [
                    (f"{b}.{a}.to_q", base + (a, "to_q"), "linear_nb", st),
                    (f"{b}.{a}.to_k", base + (a, "to_k"), "linear_nb", st),
                    (f"{b}.{a}.to_v", base + (a, "to_v"), "linear_nb", st),
                    (f"{b}.{a}.to_out.0", base + (a, "to_out"), "linear", st),
                ]
        return out

    idx = 1
    ch = cfg.model_channels
    for level in range(len(cfg.channel_mult)):
        oc = cfg.model_channels * cfg.channel_mult[level]
        for i in range(cfg.num_res_blocks):
            e += res(f"input_blocks.{idx}.0", (f"down_{level}_{i}_res",), skip=(ch != oc))
            ch = oc
            if cfg.transformer_depth[level] > 0:
                e += attn(f"input_blocks.{idx}.1", (f"down_{level}_{i}_attn",),
                          cfg.transformer_depth[level])
            idx += 1
        if level != len(cfg.channel_mult) - 1:
            e.append((f"input_blocks.{idx}.0.op", (f"down_{level}_ds", "conv"), "conv", None))
            idx += 1

    e += res("middle_block.0", ("mid_res1",), skip=False)
    if cfg.transformer_depth_middle > 0:
        e += attn("middle_block.1", ("mid_attn",), cfg.transformer_depth_middle)
        e += res("middle_block.2", ("mid_res2",), skip=False)
    else:
        e += res("middle_block.1", ("mid_res2",), skip=False)
    if encoder_only:
        return e

    idx = 0
    for level in reversed(range(len(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            # up-path blocks concatenate the skip activation: in != out always
            e += res(f"output_blocks.{idx}.0", (f"up_{level}_{i}_res",), skip=True)
            k = 1
            if cfg.transformer_depth[level] > 0:
                e += attn(f"output_blocks.{idx}.{k}", (f"up_{level}_{i}_attn",),
                          cfg.transformer_depth[level])
                k += 1
            if level != 0 and i == cfg.num_res_blocks:
                e.append((f"output_blocks.{idx}.{k}.conv", (f"up_{level}_us", "conv"),
                          "conv", None))
            idx += 1
    return e


def _vae_entries(cfg):
    """AutoencoderKL public layout: encoder.down.{i}.block.{j} /
    decoder.up.{i}.block.{j} ResNets, mid block_1/attn_1/block_2, and the
    SD-family quant convs (absent for the SD3/Flux 16ch VAEs)."""
    def res(ckpt, flax):
        return [
            (f"{ckpt}.norm1", flax + ("norm1", "GroupNorm_0"), "norm", None),
            (f"{ckpt}.conv1", flax + ("conv1",), "conv", None),
            (f"{ckpt}.norm2", flax + ("norm2", "GroupNorm_0"), "norm", None),
            (f"{ckpt}.conv2", flax + ("conv2",), "conv", None),
            (f"{ckpt}.nin_shortcut", flax + ("nin_shortcut",), "conv", None),
        ]

    def attn(ckpt, flax):
        out = [(f"{ckpt}.norm", flax + ("norm", "GroupNorm_0"), "norm", None)]
        out += [(f"{ckpt}.{w}", flax + (w,), "conv", None) for w in ("q", "k", "v", "proj_out")]
        return out

    e = []
    enc = ("encoder",)
    e.append(("encoder.conv_in", enc + ("conv_in",), "conv", None))
    for i in range(len(cfg.ch_mult)):
        for j in range(cfg.num_res_blocks):
            e += res(f"encoder.down.{i}.block.{j}", enc + (f"down_{i}_block_{j}",))
        if i != len(cfg.ch_mult) - 1:
            e.append((f"encoder.down.{i}.downsample.conv", enc + (f"down_{i}_ds",), "conv", None))
    e += res("encoder.mid.block_1", enc + ("mid_block_1",))
    e += attn("encoder.mid.attn_1", enc + ("mid_attn_1",))
    e += res("encoder.mid.block_2", enc + ("mid_block_2",))
    e.append(("encoder.norm_out", enc + ("norm_out", "GroupNorm_0"), "norm", None))
    e.append(("encoder.conv_out", enc + ("conv_out",), "conv", None))
    if cfg.quant_conv:
        e.append(("quant_conv", enc + ("quant_conv",), "conv", None))

    dec = ("decoder",)
    if cfg.quant_conv:
        e.append(("post_quant_conv", dec + ("post_quant_conv",), "conv", None))
    e.append(("decoder.conv_in", dec + ("conv_in",), "conv", None))
    e += res("decoder.mid.block_1", dec + ("mid_block_1",))
    e += attn("decoder.mid.attn_1", dec + ("mid_attn_1",))
    e += res("decoder.mid.block_2", dec + ("mid_block_2",))
    for i in range(len(cfg.ch_mult)):
        for j in range(cfg.num_res_blocks + 1):
            e += res(f"decoder.up.{i}.block.{j}", dec + (f"up_{i}_block_{j}",))
        if i != 0:
            e.append((f"decoder.up.{i}.upsample.conv", dec + (f"up_{i}_us",), "conv", None))
    e.append(("decoder.norm_out", dec + ("norm_out", "GroupNorm_0"), "norm", None))
    e.append(("decoder.conv_out", dec + ("conv_out",), "conv", None))
    return e


def import_vae(state, cfg, prefix: str = None) -> dict:
    """Import a VAE from a standalone file (bare keys) or a full checkpoint
    (`first_stage_model.` prefix, auto-detected when prefix is None)."""
    if prefix is None:
        prefix = ("first_stage_model."
                  if any(k.startswith("first_stage_model.") for k in state) else "")
    return _import(state, _vae_entries(cfg), prefix)


def export_vae(state_dict, cfg, prefix: str = "") -> dict:
    return _export(state_dict, _vae_entries(cfg), prefix)


def _dit_entries(cfg):
    e = [
        ("img_in", ("img_in",), "linear", None),
        ("txt_in", ("txt_in",), "linear", None),
        ("time_in.in_layer", ("time_in", "in_layer"), "linear", None),
        ("time_in.out_layer", ("time_in", "out_layer"), "linear", None),
        ("final_layer.adaLN_modulation.1", ("final_layer", "adaLN_modulation"), "linear", None),
        ("final_layer.linear", ("final_layer", "linear"), "linear", None),
    ]
    if cfg.vec_dim > 0:
        e += [("vector_in.in_layer", ("vector_in", "in_layer"), "linear", None),
              ("vector_in.out_layer", ("vector_in", "out_layer"), "linear", None)]
    if cfg.guidance_embed:
        e += [("guidance_in.in_layer", ("guidance_in", "in_layer"), "linear", None),
              ("guidance_in.out_layer", ("guidance_in", "out_layer"), "linear", None)]
    for i in range(cfg.depth_double):
        b = f"double_blocks.{i}"
        p = ("double", "block")
        st = (i, cfg.depth_double)
        for s in ("img", "txt"):
            e += [
                (f"{b}.{s}_mod.lin", p + (f"{s}_mod", "lin"), "linear", st),
                (f"{b}.{s}_attn.qkv", p + (f"{s}_attn_qkv",), "linear", st),
                (f"{b}.{s}_attn.norm.query_norm", p + (f"{s}_attn_qknorm", "query_norm"),
                 "rms", st),
                (f"{b}.{s}_attn.norm.key_norm", p + (f"{s}_attn_qknorm", "key_norm"), "rms", st),
                (f"{b}.{s}_attn.proj", p + (f"{s}_attn_proj",), "linear", st),
                (f"{b}.{s}_mlp.0", p + (f"{s}_mlp_0",), "linear", st),
                (f"{b}.{s}_mlp.2", p + (f"{s}_mlp_2",), "linear", st),
            ]
    for i in range(cfg.depth_single):
        b = f"single_blocks.{i}"
        p = ("single", "block")
        st = (i, cfg.depth_single)
        e += [
            (f"{b}.modulation.lin", p + ("modulation", "lin"), "linear", st),
            (f"{b}.linear1", p + ("linear1",), "linear", st),
            (f"{b}.linear2", p + ("linear2",), "linear", st),
            (f"{b}.norm.query_norm", p + ("qknorm", "query_norm"), "rms", st),
            (f"{b}.norm.key_norm", p + ("qknorm", "key_norm"), "rms", st),
        ]
    return e


def _wan_entries(cfg):
    e = [
        ("patch_embedding", ("patch_embedding",),
         ("conv3d_as_linear", (cfg.in_channels,) + tuple(cfg.patch)), None),
        ("text_embedding.0", ("text_embedding_0",), "linear", None),
        ("text_embedding.2", ("text_embedding_2",), "linear", None),
        ("time_embedding.0", ("time_embedding", "in_layer"), "linear", None),
        ("time_embedding.2", ("time_embedding", "out_layer"), "linear", None),
        ("time_projection.1", ("time_projection",), "linear", None),
        ("head.head", ("head",), "linear", None),
        ("head.modulation", ("head_modulation",), "raw", None),
    ]
    for i in range(cfg.depth):
        b = f"blocks.{i}"
        p = ("blocks", "block")
        st = (i, cfg.depth)
        e.append((f"{b}.modulation", p + ("modulation",), "raw", st))
        for attn in ("self_attn", "cross_attn"):
            for w in ("q", "k", "v", "o"):
                e.append((f"{b}.{attn}.{w}", p + (attn, w), "linear", st))
            for nw in ("norm_q", "norm_k"):
                e.append((f"{b}.{attn}.{nw}", p + (attn, nw), "rms", st))
        e += [
            (f"{b}.norm3", p + ("norm3",), "ln", st),
            (f"{b}.ffn.0", p + ("ffn_0",), "linear", st),
            (f"{b}.ffn.2", p + ("ffn_2",), "linear", st),
        ]
    return e


def _sd3_entries(cfg):
    """SD3 / SD3.5 MMDiT public checkpoint layout (`model.diffusion_model.`):
    x_embedder / pos_embed / t_embedder / y_embedder / context_embedder and
    joint_blocks.{i}.{context_block,x_block}.*, the last context_block
    pre-only, and (MMDiT-X) attn2 on the dual-attention prefix."""
    e = [
        ("x_embedder.proj", ("x_embedder",), "conv", None),
        ("pos_embed", ("pos_embed",), "raw", None),
        ("t_embedder.mlp.0", ("t_embedder", "in_layer"), "linear", None),
        ("t_embedder.mlp.2", ("t_embedder", "out_layer"), "linear", None),
        ("context_embedder", ("context_embedder",), "linear", None),
        ("final_layer.adaLN_modulation.1", ("final_layer", "adaLN_modulation"), "linear", None),
        ("final_layer.linear", ("final_layer", "linear"), "linear", None),
    ]
    if cfg.vec_dim > 0:
        e += [("y_embedder.mlp.0", ("y_embedder", "in_layer"), "linear", None),
              ("y_embedder.mlp.2", ("y_embedder", "out_layer"), "linear", None)]

    def attn(ckpt, flax, proj_name, st, with_proj=True):
        out = [(f"{ckpt}.qkv", flax + ("qkv",), "linear", st)]
        if cfg.qk_norm:
            out += [(f"{ckpt}.ln_q", flax + ("ln_q",), "rms", st),
                    (f"{ckpt}.ln_k", flax + ("ln_k",), "rms", st)]
        if with_proj:
            out.append((f"{ckpt}.proj", flax[:-1] + (proj_name,), "linear", st))
        return out

    def block(i, base, st, dual):
        b = f"joint_blocks.{i}"
        out = []
        for stream in ("context_block", "x_block"):
            s = base + (stream,)
            pre_only = st is None and stream == "context_block"
            out.append((f"{b}.{stream}.adaLN_modulation.1", s + ("adaLN_modulation",), "linear",
                        st))
            out += attn(f"{b}.{stream}.attn", s + ("attn",), "attn_proj", st,
                        with_proj=not pre_only)
            if not pre_only:
                out += [(f"{b}.{stream}.mlp.fc1", s + ("mlp_fc1",), "linear", st),
                        (f"{b}.{stream}.mlp.fc2", s + ("mlp_fc2",), "linear", st)]
            if dual and stream == "x_block":
                out += attn(f"{b}.{stream}.attn2", s + ("attn2",), "attn2_proj", st)
        return out

    n_dual = len(cfg.dual_attn_layers)
    n_plain = cfg.depth - 1 - n_dual
    for i in range(n_dual):
        e += block(i, ("joint_dual", "block"), (i, n_dual), dual=True)
    for i in range(n_plain):
        e += block(n_dual + i, ("joint", "block"), (i, n_plain), dual=False)
    e += block(cfg.depth - 1, ("joint_last",), None, dual=False)
    return e


def _hidream_lin_keys(cfg, prefix: str = ""):
    """(key, has_bias) pairs of the public HiDream-I1 state-dict layout
    (x_embedder / t_embedder / p_embedder, the per-block caption_projection
    list, `.block.`-wrapped double / single streams with attn1.to_q[_t] and
    full-width q_rms_norm[_t], the ff_i MoE (shared_experts, experts.{j},
    gate), the ff_t SwiGLU): `hidream_expected_keys`' Linears."""
    p = prefix
    keys = [
        (p + "x_embedder.proj", True),
        (p + "t_embedder.timestep_embedder.linear_1", True),
        (p + "t_embedder.timestep_embedder.linear_2", True),
        (p + "final_layer.adaLN_modulation.1", True),
        (p + "final_layer.linear", True),
    ]
    if cfg.vec_dim > 0:
        keys += [(p + "p_embedder.pooled_embedder.linear_1", True),
                 (p + "p_embedder.pooled_embedder.linear_2", True)]
    n_cap = cfg.depth_double + cfg.depth_single + 1
    keys += [(f"{p}caption_projection.{i}.linear", False) for i in range(n_cap)]

    def attn(b, with_t):
        out = []
        for s in ("", "_t") if with_t else ("",):
            out += [(f"{b}.attn1.to_q{s}", True), (f"{b}.attn1.to_k{s}", True),
                    (f"{b}.attn1.to_v{s}", True), (f"{b}.attn1.to_out{s}", True)]
        return out

    def swiglu(b):
        return [(f"{b}.w1", False), (f"{b}.w2", False), (f"{b}.w3", False)]

    for i in range(cfg.depth_double):
        b = f"{p}double_stream_blocks.{i}.block"
        keys.append((f"{b}.adaLN_modulation.1", True))
        keys += attn(b, with_t=True)
        keys += swiglu(f"{b}.ff_i.shared_experts")
        for j in range(cfg.num_experts):
            keys += swiglu(f"{b}.ff_i.experts.{j}")
        keys += swiglu(f"{b}.ff_t")
    for i in range(cfg.depth_single):
        b = f"{p}single_stream_blocks.{i}.block"
        keys.append((f"{b}.adaLN_modulation.1", True))
        keys += attn(b, with_t=False)
        keys += swiglu(f"{b}.ff_i.shared_experts")
        for j in range(cfg.num_experts):
            keys += swiglu(f"{b}.ff_i.experts.{j}")
    return keys


def hidream_expected_keys(cfg, prefix: str = ""):
    """The checkpoint keys import_hidream consumes (manifest-coverage hook)."""
    keys = set()
    for k, bias in _hidream_lin_keys(cfg, prefix):
        keys.add(k + ".weight")
        if bias:
            keys.add(k + ".bias")
    for i in range(cfg.depth_double):
        b = f"{prefix}double_stream_blocks.{i}.block"
        for s in ("", "_t"):
            keys.add(f"{b}.attn1.q_rms_norm{s}.weight")
            keys.add(f"{b}.attn1.k_rms_norm{s}.weight")
        keys.add(f"{b}.ff_i.gate.weight")
    for i in range(cfg.depth_single):
        b = f"{prefix}single_stream_blocks.{i}.block"
        keys.add(f"{b}.attn1.q_rms_norm.weight")
        keys.add(f"{b}.attn1.k_rms_norm.weight")
        keys.add(f"{b}.ff_i.gate.weight")
    return keys


# HiDream's checkpoint Linears by flax path: (checkpoint key, flax path)
_HIDREAM_TOP = (("x_embedder.proj", ("x_embedder",)),
                ("t_embedder.timestep_embedder.linear_1", ("time_in", "in_layer")),
                ("t_embedder.timestep_embedder.linear_2", ("time_in", "out_layer")),
                ("final_layer.adaLN_modulation.1", ("final_mod",)),
                ("final_layer.linear", ("final_linear",)))
_HIDREAM_VEC = (("p_embedder.pooled_embedder.linear_1", ("vector_in", "in_layer")),
                ("p_embedder.pooled_embedder.linear_2", ("vector_in", "out_layer")))


def _hidream_blocks(cfg):
    """(checkpoint block, flax path, depth index, depth, double) of every
    HiDream block."""
    d, s = cfg.depth_double, cfg.depth_single
    return ([(f"double_stream_blocks.{i}.block", ("double", "block"), i, d, True)
             for i in range(d)]
            + [(f"single_stream_blocks.{i}.block", ("single", "block"), i, s, False)
               for i in range(s)])


def import_hidream(state, cfg, prefix: str = "") -> dict:
    """Public HiDream-I1 layout -> the HiDreamModel state_dict.

    Beyond the Linear transposes: the per-block caption_projection Linears
    stack into `cap_proj_double` / `cap_proj_single` (the last projection
    is the T5 `txt_in`), and the per-expert ff_i.experts.{j}.w{1,2,3} stack
    into the (E, in, out) MoE weights, as the JAX importer stacks them."""
    sb = _StateBuilder()
    g = lambda k: _tensor(state[prefix + k])  # noqa: E731

    def lin(ckpt, path, st=None, bias=True):
        leaves = [("kernel", t_linear(g(ckpt + ".weight")))]
        if bias:
            leaves.append(("bias", g(ckpt + ".bias")))
        for leaf, val in leaves:
            if st is None:
                sb.set(path + (leaf,), val)
            else:
                sb.set_stacked(path + (leaf,), st[0], st[1], val)

    for ckpt, path in _HIDREAM_TOP + (_HIDREAM_VEC if cfg.vec_dim > 0 else ()):
        lin(ckpt, path)
    d, s_ = cfg.depth_double, cfg.depth_single
    cap = [t_linear(g(f"caption_projection.{i}.linear.weight")) for i in range(d + s_ + 1)]
    sb.set(("cap_proj_double",), torch.stack(cap[:d]))
    sb.set(("cap_proj_single",), torch.stack(cap[d:d + s_]))
    sb.set(("txt_in", "kernel"), cap[d + s_])

    for ckpt, p, i, depth, double in _hidream_blocks(cfg):
        st = (i, depth)
        lin(f"{ckpt}.adaLN_modulation.1", p + ("adaLN_modulation", "lin"), st)
        for suf in ("", "_t") if double else ("",):
            for w in ("to_q", "to_k", "to_v", "to_out"):
                lin(f"{ckpt}.attn1.{w}{suf}", p + (f"{w}{suf}",), st)
            for nw in ("q_rms_norm", "k_rms_norm"):
                sb.set_stacked(p + (f"{nw}{suf}", "scale"), i, depth,
                               g(f"{ckpt}.attn1.{nw}{suf}.weight"))
        moe = p + ("ff_i",)
        for j in (1, 2, 3):
            lin(f"{ckpt}.ff_i.shared_experts.w{j}", moe + ("shared", f"w{j}"), st, bias=False)
            sb.set_stacked(moe + (f"experts_w{j}",), i, depth, torch.stack(
                [t_linear(g(f"{ckpt}.ff_i.experts.{e}.w{j}.weight"))
                 for e in range(cfg.num_experts)]))
            if double:
                lin(f"{ckpt}.ff_t.w{j}", p + ("ff_t", f"w{j}"), st, bias=False)
        lin(f"{ckpt}.ff_i.gate", moe + ("gate",), st, bias=False)
    return sb.build()


def export_hidream(state_dict, cfg, prefix: str = "") -> dict:
    """Inverse of import_hidream: a HiDreamModel state_dict in the public
    layout."""
    out = {}

    def flat(path, i=None):
        p = path if i is None else bridge.unstack(path, i)
        return bridge.flax_layout(p, state_dict[bridge.state_key(p)])

    def lin(ckpt, path, i=None, bias=True):
        out[prefix + ckpt + ".weight"] = flat(path + ("kernel",), i).permute(1, 0)
        if bias:
            out[prefix + ckpt + ".bias"] = flat(path + ("bias",), i)

    for ckpt, path in _HIDREAM_TOP + (_HIDREAM_VEC if cfg.vec_dim > 0 else ()):
        lin(ckpt, path)
    d, s_ = cfg.depth_double, cfg.depth_single
    for j, w in enumerate([*flat(("cap_proj_double",)), *flat(("cap_proj_single",)),
                           flat(("txt_in", "kernel"))]):
        out[f"{prefix}caption_projection.{j}.linear.weight"] = w.permute(1, 0)

    for ckpt, p, i, _depth, double in _hidream_blocks(cfg):
        lin(f"{ckpt}.adaLN_modulation.1", p + ("adaLN_modulation", "lin"), i)
        for suf in ("", "_t") if double else ("",):
            for w in ("to_q", "to_k", "to_v", "to_out"):
                lin(f"{ckpt}.attn1.{w}{suf}", p + (f"{w}{suf}",), i)
            for nw in ("q_rms_norm", "k_rms_norm"):
                out[f"{prefix}{ckpt}.attn1.{nw}{suf}.weight"] = flat(p + (f"{nw}{suf}", "scale"),
                                                                    i)
        moe = p + ("ff_i",)
        for j in (1, 2, 3):
            lin(f"{ckpt}.ff_i.shared_experts.w{j}", moe + ("shared", f"w{j}"), i, bias=False)
            for e, w in enumerate(flat(moe + (f"experts_w{j}",), i)):
                out[f"{prefix}{ckpt}.ff_i.experts.{e}.w{j}.weight"] = w.permute(1, 0)
            if double:
                lin(f"{ckpt}.ff_t.w{j}", p + ("ff_t", f"w{j}"), i, bias=False)
        lin(f"{ckpt}.ff_i.gate", moe + ("gate",), i, bias=False)
    return out


# --------------------------------------------------------------------------
# generic import / export over an entry table


def safetensors_header_keys(path: str):
    """Read ONLY a safetensors file's JSON header: {key: (dtype, shape)}.

    No tensor data is touched (the header is the first `u64-length` bytes),
    so this works instantly on multi-GB checkpoints.  Mirrors
    load_safetensors' fp8_scaled handling: `<name>.scale_weight` companions
    are dropped (the loader folds them into `<name>.weight`)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        hdr = json.loads(f.read(n))
    hdr.pop("__metadata__", None)
    return {k: (v.get("dtype"), tuple(v.get("shape", ())))
            for k, v in hdr.items() if not k.endswith(".scale_weight")}


def key_census(have_keys, want_keys, family: str) -> dict:
    """Diff a checkpoint's key set against an importer's expected set:
    `missing` = keys the import table expects but the file lacks,
    `leftover` = file keys the table would silently drop."""
    have = set(have_keys)
    want = set(want_keys)
    return {
        "family": family,
        "expected": len(want),
        "in_file": len(have),
        "matched": len(want & have),
        "missing": sorted(want - have),
        "leftover": sorted(have - want),
        "ok": want == have,
    }


def expected_keys(entries, prefix: str = ""):
    """The full set of checkpoint keys an entry table consumes."""
    keys = set()
    for ckpt, _path, kind, _stack in entries:
        for suffix, _leaf in _leaves(kind):
            keys.add(prefix + ckpt + ("." + suffix if suffix else ""))
    return keys


def manifest_coverage(state_keys, entries, prefix: str = ""):
    """(consumed, leftover, missing) of an importer vs a key manifest:
    `leftover` the manifest keys the importer would silently drop,
    `missing` the keys the table expects but the manifest lacks."""
    want = expected_keys(entries, prefix)
    have = set(state_keys)
    return want & have, have - want, want - have


def _import(state, entries, prefix):
    sb = _StateBuilder()
    for ckpt, path, kind, stack in entries:
        for suffix, leaf in _leaves(kind):
            key = prefix + ckpt + ("." + suffix if suffix else "")
            if key not in state:
                continue
            # layout transforms apply to weight/gamma tensors, never biases
            val = _tensor(state[key])
            if suffix in ("weight", "gamma"):
                val = _t_in(kind, val)
            p = tuple(path) + ((leaf,) if leaf else ())
            if stack is None:
                sb.set(p, val)
            else:
                sb.set_stacked(p, stack[0], stack[1], val)
    return sb.build()


def _export(state_dict, entries, prefix):
    out = {}
    for ckpt, path, kind, stack in entries:
        for suffix, leaf in _leaves(kind):
            p = tuple(path) + ((leaf,) if leaf else ())
            if stack is not None:
                p = bridge.unstack(p, stack[0])
            key = bridge.state_key(p)
            if key not in state_dict:
                continue
            w = bridge.flax_layout(p, state_dict[key])
            if suffix in ("weight", "gamma"):
                w = _t_out(kind, w)
            out[prefix + ckpt + ("." + suffix if suffix else "")] = w
    return out


_ATTN1_Q = re.compile(r"^(.*)\.blocks\.(\d+)\.attn1\.to_q\.weight$")


def fuse_unet_qkv(state: dict) -> dict:
    """Import-time QKV fusion of a UNet state_dict in split layout (the
    checkpoint's, as `_import` maps it) into the port UNet's fused one, as
    `lanpaint_tpu.models.load.fuse_unet_qkv` fuses the flax tree: in every
    SpatialTransformer

    * attn1 to_q / to_k / to_v (c, c) -> to_qkv (3c, c), q|k|v in order;
    * attn2 to_k / to_v (c, ctx) of every depth -> the stacked `kv_cross`
      (depth, ctx, 2c) = k^T|v^T per depth.

    Returns a new dict; the checkpoint's keys stay split."""
    out = dict(state)
    depths: Dict[str, int] = {}
    for key in state:
        m = _ATTN1_Q.match(key)
        if m:
            depths[m.group(1)] = max(depths.get(m.group(1), 0), int(m.group(2)) + 1)
    for st, depth in depths.items():
        kv = []
        for j in range(depth):
            a1, a2 = f"{st}.blocks.{j}.attn1.", f"{st}.blocks.{j}.attn2."
            out[a1 + "to_qkv.weight"] = torch.cat(
                [out.pop(f"{a1}to_{n}.weight") for n in "qkv"], dim=0)
            kv.append(torch.cat([out.pop(f"{a2}to_{n}.weight").T for n in "kv"], dim=-1))
        out[f"{st}.kv_cross"] = torch.stack(kv)
    return out


def unfuse_unet_qkv(state: dict) -> dict:
    """Inverse of `fuse_unet_qkv` (views of the fused tensors)."""
    out = dict(state)
    for key in [k for k in state if k.endswith(".kv_cross")]:
        st = key[: -len(".kv_cross")]
        kc, vc = out.pop(key).chunk(2, dim=-1)
        for j in range(kc.shape[0]):
            a1, a2 = f"{st}.blocks.{j}.attn1.", f"{st}.blocks.{j}.attn2."
            for n, w in zip("qkv", out.pop(a1 + "to_qkv.weight").chunk(3, dim=0)):
                out[f"{a1}to_{n}.weight"] = w
            out[a2 + "to_k.weight"], out[a2 + "to_v.weight"] = kc[j].T, vc[j].T
    return out


def import_unet(state, cfg, prefix: str = "model.diffusion_model.") -> dict:
    """An ldm/sgm UNet checkpoint -> the port UNet's (fused) state_dict."""
    return fuse_unet_qkv(_import(state, _unet_entries(cfg), prefix))


def export_unet(state_dict, cfg, prefix: str = "model.diffusion_model.") -> dict:
    return _export(unfuse_unet_qkv(state_dict), _unet_entries(cfg), prefix)


def _controlnet_entries(cfg):
    """cldm ControlNet layout: the UNet encoder entries + hint encoder +
    zero convs (public keys input_hint_block.{0,2,..,14}, zero_convs.{j}.0,
    middle_block_out.0; prefix `control_model.`)."""
    e = _unet_entries(cfg, encoder_only=True)
    for j in range(8):
        e.append((f"input_hint_block.{2 * j}", ("input_hint_block", f"conv_{j}"), "conv", None))
    n_zero = 1 + len(cfg.channel_mult) * cfg.num_res_blocks + (len(cfg.channel_mult) - 1)
    for j in range(n_zero):
        e.append((f"zero_convs.{j}.0", (f"zero_conv_{j}",), "conv", None))
    e.append(("middle_block_out.0", ("middle_block_out",), "conv", None))
    return e


def import_controlnet(state, cfg, prefix: str = "control_model.") -> dict:
    """A cldm ControlNet checkpoint -> the port ControlNet's (fused) state_dict."""
    return fuse_unet_qkv(_import(state, _controlnet_entries(cfg), prefix))


def export_controlnet(state_dict, cfg, prefix: str = "control_model.") -> dict:
    return _export(unfuse_unet_qkv(state_dict), _controlnet_entries(cfg), prefix)


def import_dit(state, cfg, prefix: str = "") -> dict:
    return _import(state, _dit_entries(cfg), prefix)


def import_dit_guarded(state, cfg, family: str, prefix: str = "") -> dict:
    """import_dit with a key-census guard for the structural stand-in
    families (Flux.2-Klein, Krea2, Anima, Ideogram4 —
    docs/family_facts.md): their DiTConfig dims are vendored best-effort, so
    a checkpoint whose keys differ from the table fails with the census
    diff (the JAX package's message) instead of a deep shape error."""
    want = expected_keys(_dit_entries(cfg), prefix)
    have = {k for k in state if k.startswith(prefix)}
    if want != have:
        missing = sorted(want - have)
        leftover = sorted(have - want)
        raise ValueError(
            f"{family}: checkpoint key census does not match the vendored "
            f"structural stand-in config ({len(want)} expected keys, "
            f"{len(have)} in file): {len(missing)} expected keys absent "
            f"(first: {missing[:4]}), {len(leftover)} checkpoint keys the "
            f"stand-in would drop (first: {leftover[:4]}).  The stand-in "
            "topology (depths/width/key naming) does not describe this "
            "release — update the family's DiTConfig dims and/or the "
            "load.py entry table to the real layout, then re-run.  The "
            "workflow-pinned facts (encoder widths, VAE pairing, sampler "
            "settings) are collected in docs/family_facts.md.")
    return _import(state, _dit_entries(cfg), prefix)


def export_dit(state_dict, cfg, prefix: str = "") -> dict:
    return _export(state_dict, _dit_entries(cfg), prefix)


def _flux2_entries(cfg):
    """(checkpoint key, state_dict key) pairs of FLUX.2's transformer
    (`models/flux2.py`): Black Forest Labs' checkpoint layout as recalled
    offline (Flux.1's `double_blocks` / `single_blocks` names without
    biases or per-block modulation, the three shared modulations at the top
    level); no checkpoint was at hand to check it against."""
    e = [(f"{k}.weight", f"{k}.weight") for k in (
        "img_in", "txt_in", "time_in.in_layer", "time_in.out_layer", "guidance_in.in_layer",
        "guidance_in.out_layer", "double_stream_modulation_img.lin",
        "double_stream_modulation_txt.lin", "single_stream_modulation.lin",
        "final_layer.linear")]
    e.append(("final_layer.adaLN_modulation.1.weight", "final_layer.adaLN_modulation.weight"))
    for i in range(cfg.depth_double):
        b, m = f"double_blocks.{i}", f"double.{i}"
        for s in ("img", "txt"):
            e += [(f"{b}.{s}_attn.qkv.weight", f"{m}.{s}_attn_qkv.weight"),
                  (f"{b}.{s}_attn.norm.query_norm.scale", f"{m}.{s}_attn_qknorm.query_norm.weight"),
                  (f"{b}.{s}_attn.norm.key_norm.scale", f"{m}.{s}_attn_qknorm.key_norm.weight"),
                  (f"{b}.{s}_attn.proj.weight", f"{m}.{s}_attn_proj.weight"),
                  (f"{b}.{s}_mlp.0.weight", f"{m}.{s}_mlp_0.weight"),
                  (f"{b}.{s}_mlp.2.weight", f"{m}.{s}_mlp_2.weight")]
    for i in range(cfg.depth_single):
        b, m = f"single_blocks.{i}", f"single.{i}"
        e += [(f"{b}.linear1.weight", f"{m}.linear1.weight"),
              (f"{b}.linear2.weight", f"{m}.linear2.weight"),
              (f"{b}.norm.query_norm.scale", f"{m}.qknorm.query_norm.weight"),
              (f"{b}.norm.key_norm.scale", f"{m}.qknorm.key_norm.weight")]
    return e


def flux2_expected_keys(cfg, prefix: str = ""):
    """The checkpoint keys FLUX.2's importer consumes."""
    return {prefix + k for k, _ in _flux2_entries(cfg)}


def import_flux2(state, cfg, prefix: str = "") -> dict:
    """A FLUX.2 checkpoint's tensors as `models/flux2.Flux2`'s state_dict
    (views of them: the layouts agree).  The key layout is recalled, so a
    checkpoint whose keys differ from the table raises with the census
    diff before any tensor is taken."""
    have = {k for k in state if k.startswith(prefix)}
    census = key_census(have, flux2_expected_keys(cfg, prefix), "flux2")
    if not census["ok"]:
        raise ValueError(
            f"flux2: the checkpoint's keys do not match the recalled FLUX.2 layout "
            f"({census['expected']} expected, {census['in_file']} in file): "
            f"{len(census['missing'])} absent (first: {census['missing'][:4]}), "
            f"{len(census['leftover'])} left over (first: {census['leftover'][:4]}); "
            "update `load._flux2_entries` to the file's names")
    return {m: _tensor(state[prefix + k]) for k, m in _flux2_entries(cfg)}


# Qwen-Image's diffusers layout (QwenImageTransformer2DModel): per-stream
# split projections, (scale, shift)-ordered final AdaLN
_QWEN_STREAMS = (
    ("img", ("to_q", "to_k", "to_v"), ("norm_q", "norm_k"), "to_out.0"),
    ("txt", ("add_q_proj", "add_k_proj", "add_v_proj"), ("norm_added_q", "norm_added_k"),
     "to_add_out"),
)
_QWEN_TOP = (("time_text_embed.timestep_embedder.linear_1", ("time_in", "in_layer")),
             ("time_text_embed.timestep_embedder.linear_2", ("time_in", "out_layer")),
             ("img_in", ("img_in",)), ("txt_in", ("txt_in",)),
             ("proj_out", ("final_layer", "linear")))


def import_qwen(state, cfg, prefix: str = "") -> dict:
    """Qwen-Image diffusers layout -> the MMDiT state_dict.

    The public checkpoint stores per-stream split projections
    (`attn.to_q/to_k/to_v` for the image stream, `attn.add_{q,k,v}_proj`
    for the text stream), fused here into the qkv weights;
    `attn.norm_q/...` are the head-dim RMS qk-norms; `norm_out.linear` is
    diffusers' AdaLayerNormContinuous, whose output halves are ordered
    (scale, shift), swapped into the flux convention (shift, scale)."""
    sb = _StateBuilder()
    g = lambda k: _tensor(state[prefix + k])  # noqa: E731
    h = cfg.hidden
    depth = cfg.depth_double

    def lin(ckpt, path, i=None):
        for leaf, val in (("kernel", t_linear(g(ckpt + ".weight"))), ("bias", g(ckpt + ".bias"))):
            if i is None:
                sb.set(path + (leaf,), val)
            else:
                sb.set_stacked(path + (leaf,), i, depth, val)

    for ckpt, path in _QWEN_TOP:
        lin(ckpt, path)
    sb.set(("txt_norm", "scale"), g("txt_norm.weight"))
    w, b = g("norm_out.linear.weight"), g("norm_out.linear.bias")
    sb.set(("final_layer", "adaLN_modulation", "kernel"), t_linear(torch.cat([w[h:], w[:h]])))
    sb.set(("final_layer", "adaLN_modulation", "bias"), torch.cat([b[h:], b[:h]]))

    p = ("double", "block")
    for i in range(depth):
        blk = f"transformer_blocks.{i}"
        lin(f"{blk}.img_mod.1", p + ("img_mod", "lin"), i)
        lin(f"{blk}.txt_mod.1", p + ("txt_mod", "lin"), i)
        for stream, src_q, src_norm, src_out in _QWEN_STREAMS:
            kw = torch.cat([t_linear(g(f"{blk}.attn.{s}.weight")) for s in src_q], dim=1)
            kb = torch.cat([g(f"{blk}.attn.{s}.bias") for s in src_q])
            sb.set_stacked(p + (f"{stream}_attn_qkv", "kernel"), i, depth, kw)
            sb.set_stacked(p + (f"{stream}_attn_qkv", "bias"), i, depth, kb)
            for nm, src in zip(("query_norm", "key_norm"), src_norm):
                sb.set_stacked(p + (f"{stream}_attn_qknorm", nm, "scale"), i, depth,
                               g(f"{blk}.attn.{src}.weight"))
            lin(f"{blk}.attn.{src_out}", p + (f"{stream}_attn_proj",), i)
            lin(f"{blk}.{stream}_mlp.net.0.proj", p + (f"{stream}_mlp_0",), i)
            lin(f"{blk}.{stream}_mlp.net.2", p + (f"{stream}_mlp_2",), i)
    return sb.build()


def import_mmdit_auto(state, cfg, prefix: str = "") -> dict:
    """MMDiT importer with layout auto-detection: public Qwen-Image
    checkpoints ship the diffusers layout (transformer_blocks.*), Flux-style
    files and this package's exports the double_blocks / single_blocks
    layout."""
    if any(k.startswith(prefix + "transformer_blocks.") for k in state):
        return import_qwen(state, cfg, prefix)
    return import_dit(state, cfg, prefix)


def qwen_expected_keys(cfg, prefix: str = ""):
    """The checkpoint keys import_qwen consumes (manifest-coverage hook)."""
    keys = set()
    for k in ("time_text_embed.timestep_embedder.linear_1",
              "time_text_embed.timestep_embedder.linear_2",
              "img_in", "txt_in", "norm_out.linear", "proj_out"):
        keys.add(prefix + k + ".weight")
        keys.add(prefix + k + ".bias")
    keys.add(prefix + "txt_norm.weight")
    for i in range(cfg.depth_double):
        blk = f"transformer_blocks.{i}"
        for k in ("img_mod.1", "txt_mod.1", "attn.to_q", "attn.to_k",
                  "attn.to_v", "attn.add_q_proj", "attn.add_k_proj",
                  "attn.add_v_proj", "attn.to_out.0", "attn.to_add_out",
                  "img_mlp.net.0.proj", "img_mlp.net.2",
                  "txt_mlp.net.0.proj", "txt_mlp.net.2"):
            keys.add(f"{prefix}{blk}.{k}.weight")
            keys.add(f"{prefix}{blk}.{k}.bias")
        for k in ("attn.norm_q", "attn.norm_k", "attn.norm_added_q",
                  "attn.norm_added_k"):
            keys.add(f"{prefix}{blk}.{k}.weight")
    return keys


def export_qwen(state_dict, cfg, prefix: str = "") -> dict:
    """Inverse of import_qwen: an MMDiT state_dict in the diffusers layout."""
    out = {}
    h = cfg.hidden

    def flat(path, i=None):
        p = path if i is None else bridge.unstack(path, i)
        return bridge.flax_layout(p, state_dict[bridge.state_key(p)])

    def lin(ckpt, path, i=None):
        out[prefix + ckpt + ".weight"] = flat(path + ("kernel",), i).permute(1, 0)
        out[prefix + ckpt + ".bias"] = flat(path + ("bias",), i)

    for ckpt, path in _QWEN_TOP:
        lin(ckpt, path)
    out[prefix + "txt_norm.weight"] = flat(("txt_norm", "scale"))
    w = flat(("final_layer", "adaLN_modulation", "kernel")).permute(1, 0)
    b = flat(("final_layer", "adaLN_modulation", "bias"))
    out[prefix + "norm_out.linear.weight"] = torch.cat([w[h:], w[:h]])
    out[prefix + "norm_out.linear.bias"] = torch.cat([b[h:], b[:h]])

    p = ("double", "block")
    for i in range(cfg.depth_double):
        blk = f"transformer_blocks.{i}"
        lin(f"{blk}.img_mod.1", p + ("img_mod", "lin"), i)
        lin(f"{blk}.txt_mod.1", p + ("txt_mod", "lin"), i)
        for stream, dst_q, dst_norm, dst_out in _QWEN_STREAMS:
            kw = flat(p + (f"{stream}_attn_qkv", "kernel"), i)
            kb = flat(p + (f"{stream}_attn_qkv", "bias"), i)
            for j, s in enumerate(dst_q):
                out[f"{prefix}{blk}.attn.{s}.weight"] = kw[:, j * h:(j + 1) * h].permute(1, 0)
                out[f"{prefix}{blk}.attn.{s}.bias"] = kb[j * h:(j + 1) * h]
            for nm, dst in zip(("query_norm", "key_norm"), dst_norm):
                out[f"{prefix}{blk}.attn.{dst}.weight"] = flat(
                    p + (f"{stream}_attn_qknorm", nm, "scale"), i)
            lin(f"{blk}.attn.{dst_out}", p + (f"{stream}_attn_proj",), i)
            lin(f"{blk}.{stream}_mlp.net.0.proj", p + (f"{stream}_mlp_0",), i)
            lin(f"{blk}.{stream}_mlp.net.2", p + (f"{stream}_mlp_2",), i)
    return out


def _zimage_entries(cfg):
    """Z-Image (Tongyi S3-DiT) <-> the Lumina2 / NextDiT layout of
    z_image_*_bf16.safetensors (the reference's Z_image workflows load it
    through UNETLoader with CLIPLoader type 'lumina2'): x_embedder,
    cap_embedder RMSNorm + Linear, context_refiner / noise_refiner / layers
    JointTransformerBlocks (fused GQA attention.qkv, per-head q/k RMS norms,
    SwiGLU feed_forward.w{1,2,3}, sandwich attention_norm1/2 + ffn_norm1/2,
    tanh-gated adaLN on the modulated blocks), norm_final, the
    scale-modulated final_layer."""
    e = [
        ("x_embedder", ("x_embedder",), "linear", None),
        ("cap_embedder.0", ("cap_norm",), "rms_w", None),
        ("cap_embedder.1", ("cap_proj",), "linear", None),
        ("t_embedder.mlp.0", ("t_mlp_0",), "linear", None),
        ("t_embedder.mlp.2", ("t_mlp_2",), "linear", None),
        ("norm_final", ("norm_final",), "rms_w", None),
        ("final_layer.linear", ("final_linear",), "linear", None),
        ("final_layer.adaLN_modulation.1", ("final_adaLN_1",), "linear", None),
    ]

    def block(ckpt, flax, st, modulated):
        out = [
            (f"{ckpt}.attention.qkv", flax + ("attention", "qkv"), "linear_nb", st),
            (f"{ckpt}.attention.out", flax + ("attention", "out"), "linear_nb", st),
            (f"{ckpt}.attention.q_norm", flax + ("attention", "q_norm"), "rms_w", st),
            (f"{ckpt}.attention.k_norm", flax + ("attention", "k_norm"), "rms_w", st),
            (f"{ckpt}.feed_forward.w1", flax + ("feed_forward", "w1"), "linear_nb", st),
            (f"{ckpt}.feed_forward.w2", flax + ("feed_forward", "w2"), "linear_nb", st),
            (f"{ckpt}.feed_forward.w3", flax + ("feed_forward", "w3"), "linear_nb", st),
            (f"{ckpt}.attention_norm1", flax + ("attention_norm1",), "rms_w", st),
            (f"{ckpt}.attention_norm2", flax + ("attention_norm2",), "rms_w", st),
            (f"{ckpt}.ffn_norm1", flax + ("ffn_norm1",), "rms_w", st),
            (f"{ckpt}.ffn_norm2", flax + ("ffn_norm2",), "rms_w", st),
        ]
        if modulated:
            out.append((f"{ckpt}.adaLN_modulation.1", flax + ("adaLN_modulation_1",),
                        "linear", st))
        return out

    for i in range(cfg.context_refiner_depth):
        e += block(f"context_refiner.{i}", ("context_refiner", "block"),
                   (i, cfg.context_refiner_depth), modulated=False)
    for i in range(cfg.refiner_depth):
        e += block(f"noise_refiner.{i}", ("noise_refiner", "block"), (i, cfg.refiner_depth),
                   modulated=True)
    for i in range(cfg.depth):
        e += block(f"layers.{i}", ("layers", "block"), (i, cfg.depth), modulated=True)
    return e


def import_zimage(state, cfg, prefix: str = "") -> dict:
    return _import(state, _zimage_entries(cfg), prefix)


def export_zimage(state_dict, cfg, prefix: str = "") -> dict:
    return _export(state_dict, _zimage_entries(cfg), prefix)


def import_sd3(state, cfg, prefix: str = "model.diffusion_model.") -> dict:
    # SD3.5 stores the per-head RMS qk-norm scales as '.ln_q/.ln_k.weight'
    state = {k.replace(".ln_q.weight", ".ln_q.scale")
              .replace(".ln_k.weight", ".ln_k.scale"): v
             for k, v in state.items()}
    return _import(state, _sd3_entries(cfg), prefix)


def export_sd3(state_dict, cfg, prefix: str = "model.diffusion_model.") -> dict:
    out = _export(state_dict, _sd3_entries(cfg), prefix)
    return {k.replace(".ln_q.scale", ".ln_q.weight")
             .replace(".ln_k.scale", ".ln_k.weight"): v
            for k, v in out.items()}


def import_wan(state, cfg, prefix: str = "") -> dict:
    # Wan RMSNorm tensors are stored as '.weight'
    state = {k.replace(".norm_q.weight", ".norm_q.scale")
              .replace(".norm_k.weight", ".norm_k.scale"): v
             for k, v in state.items()}
    return _import(state, _wan_entries(cfg), prefix)


def export_wan(state_dict, cfg, prefix: str = "") -> dict:
    out = _export(state_dict, _wan_entries(cfg), prefix)
    return {k.replace(".norm_q.scale", ".norm_q.weight")
             .replace(".norm_k.scale", ".norm_k.weight"): v
            for k, v in out.items()}


def _hyvideo_entries(cfg):
    """HunyuanVideo DiT (models/hyvideo.py) <-> the ComfyUI-native layout of
    `hunyuan_video_t2v_720p_bf16.safetensors`: Flux-style keys for the
    double / single streams (`double_blocks.{i}.img_attn.qkv`,
    `...norm.query_norm.scale`, `single_blocks.{i}.linear1`), the Conv3D
    patch embed `img_in.proj`, and the tencent-named token refiner
    `txt_in.individual_token_refiner.blocks.{i}.*` / `txt_in.t_embedder.
    mlp.{0,2}` / `txt_in.c_embedder.linear_{1,2}`."""
    e = [
        ("img_in.proj", ("img_in",), ("conv3d_as_linear", (cfg.in_channels,) + tuple(cfg.patch)),
         None),
        ("time_in.in_layer", ("time_in", "in_layer"), "linear", None),
        ("time_in.out_layer", ("time_in", "out_layer"), "linear", None),
        ("txt_in.input_embedder", ("txt_in", "input_embedder"), "linear", None),
        ("txt_in.t_embedder.mlp.0", ("txt_in", "t_embedder", "in_layer"), "linear", None),
        ("txt_in.t_embedder.mlp.2", ("txt_in", "t_embedder", "out_layer"), "linear", None),
        ("txt_in.c_embedder.linear_1", ("txt_in", "c_embedder", "in_layer"), "linear", None),
        ("txt_in.c_embedder.linear_2", ("txt_in", "c_embedder", "out_layer"), "linear", None),
        ("final_layer.adaLN_modulation.1", ("final_layer", "adaLN_modulation"), "linear", None),
        ("final_layer.linear", ("final_layer", "linear"), "linear", None),
    ]
    if cfg.vec_dim > 0:
        e += [("vector_in.in_layer", ("vector_in", "in_layer"), "linear", None),
              ("vector_in.out_layer", ("vector_in", "out_layer"), "linear", None)]
    if cfg.guidance_embed:
        e += [("guidance_in.in_layer", ("guidance_in", "in_layer"), "linear", None),
              ("guidance_in.out_layer", ("guidance_in", "out_layer"), "linear", None)]
    for i in range(cfg.refiner_depth):
        b = f"txt_in.individual_token_refiner.blocks.{i}"
        p = ("txt_in", "refiner", "block")
        st = (i, cfg.refiner_depth)
        e += [
            (f"{b}.norm1", p + ("norm1",), "ln", st),
            (f"{b}.norm2", p + ("norm2",), "ln", st),
            (f"{b}.self_attn_qkv", p + ("self_attn_qkv",), "linear", st),
            (f"{b}.self_attn_proj", p + ("self_attn_proj",), "linear", st),
            (f"{b}.mlp.fc1", p + ("mlp_fc1",), "linear", st),
            (f"{b}.mlp.fc2", p + ("mlp_fc2",), "linear", st),
            (f"{b}.adaLN_modulation.1", p + ("adaLN_modulation",), "linear", st),
        ]
    for i in range(cfg.depth_double):
        b = f"double_blocks.{i}"
        p = ("double", "block")
        st = (i, cfg.depth_double)
        for s in ("img", "txt"):
            e += [
                (f"{b}.{s}_mod.lin", p + (f"{s}_mod",), "linear", st),
                (f"{b}.{s}_attn.qkv", p + (f"{s}_attn_qkv",), "linear", st),
                (f"{b}.{s}_attn.norm.query_norm", p + (f"{s}_q_norm",), "rms", st),
                (f"{b}.{s}_attn.norm.key_norm", p + (f"{s}_k_norm",), "rms", st),
                (f"{b}.{s}_attn.proj", p + (f"{s}_attn_proj",), "linear", st),
                (f"{b}.{s}_mlp.0", p + (f"{s}_mlp_fc1",), "linear", st),
                (f"{b}.{s}_mlp.2", p + (f"{s}_mlp_fc2",), "linear", st),
            ]
    for i in range(cfg.depth_single):
        b = f"single_blocks.{i}"
        p = ("single", "block")
        st = (i, cfg.depth_single)
        e += [
            (f"{b}.modulation.lin", p + ("modulation",), "linear", st),
            (f"{b}.linear1", p + ("linear1",), "linear", st),
            (f"{b}.linear2", p + ("linear2",), "linear", st),
            (f"{b}.norm.query_norm", p + ("q_norm",), "rms", st),
            (f"{b}.norm.key_norm", p + ("k_norm",), "rms", st),
        ]
    return e


def import_hyvideo(state, cfg, prefix: str = "") -> dict:
    return _import(state, _hyvideo_entries(cfg), prefix)


def export_hyvideo(state_dict, cfg, prefix: str = "") -> dict:
    return _export(state_dict, _hyvideo_entries(cfg), prefix)


def _wan_vae_entries(cfg):
    """Wan causal video VAE (models/video_vae.py) <-> the public
    wan_2.1_vae.safetensors / qwen_image_vae.safetensors layout
    (`encoder.downsamples.{i}.residual.{0,2,3,6}`, middle res/attn/res,
    `conv1`/`conv2` quant pair, decoder mirror with `num_res_blocks+1`
    blocks per stage).  With `cfg.stage_shortcuts` (Wan2.2) each stage
    nests one more Sequential level, `encoder.downsamples.{i}.downsamples.
    {j}` / `decoder.upsamples.{i}.upsamples.{j}`, and the decoder's
    upsample conv keeps its width."""

    def res(ckpt, flax, cin, cout):
        out = [
            (f"{ckpt}.residual.0", flax + ("norm1",), "gamma4", None),
            (f"{ckpt}.residual.2", flax + ("conv1", "conv"), "conv3d", None),
            (f"{ckpt}.residual.3", flax + ("norm2",), "gamma4", None),
            (f"{ckpt}.residual.6", flax + ("conv2", "conv"), "conv3d", None),
        ]
        if cin != cout:
            out.append((f"{ckpt}.shortcut", flax + ("shortcut", "conv"), "conv3d", None))
        return out

    def attn(ckpt, flax):
        return [
            (f"{ckpt}.norm", flax + ("norm",), "gamma3", None),
            (f"{ckpt}.to_qkv", flax + ("to_qkv",), "conv2d3d", None),
            (f"{ckpt}.proj", flax + ("proj",), "conv2d3d", None),
        ]

    e = [("encoder.conv1", ("encoder", "conv1", "conv"), "conv3d", None)]
    dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
    nested = cfg.stage_shortcuts  # Wan2.2 vae2_2.py Down_/Up_ResidualBlock
    idx = 0
    cin = dims[0]
    for i in range(len(cfg.dim_mult)):
        cout = dims[i + 1]
        if nested:
            stage = f"encoder.downsamples.{i}.downsamples"
            idx = 0
        else:
            stage = "encoder.downsamples"
        for j in range(cfg.num_res_blocks):
            e += res(f"{stage}.{idx}", ("encoder", f"down_{i}_block_{j}"), cin, cout)
            cin = cout
            idx += 1
        if i != len(cfg.dim_mult) - 1:
            e.append((f"{stage}.{idx}.resample.1",
                      ("encoder", f"down_{i}_ds", "resample", "conv"), "conv2d3d", None))
            if cfg.temporal_downsample[i]:
                e.append((f"{stage}.{idx}.time_conv",
                          ("encoder", f"down_{i}_ds", "time_conv"), "conv3d", None))
            idx += 1
    c = dims[-1]
    e += res("encoder.middle.0", ("encoder", "mid_block_1"), c, c)
    e += attn("encoder.middle.1", ("encoder", "mid_attn"))
    e += res("encoder.middle.2", ("encoder", "mid_block_2"), c, c)
    e += [("encoder.head.0", ("encoder", "head_norm"), "gamma4", None),
          ("encoder.head.2", ("encoder", "head_conv", "conv"), "conv3d", None),
          ("conv1", ("quant_conv", "conv"), "conv3d", None),
          ("conv2", ("post_quant_conv", "conv"), "conv3d", None),
          ("decoder.conv1", ("decoder", "conv1", "conv"), "conv3d", None)]
    rev = tuple(reversed(cfg.dim_mult))
    ddims = [cfg.dim * u for u in (rev[0],) + rev]
    temporal_up = tuple(reversed(cfg.temporal_downsample))
    c = ddims[0]
    e += res("decoder.middle.0", ("decoder", "mid_block_1"), c, c)
    e += attn("decoder.middle.1", ("decoder", "mid_attn"))
    e += res("decoder.middle.2", ("decoder", "mid_block_2"), c, c)
    idx = 0
    cin = ddims[0]
    for i in range(len(cfg.dim_mult)):
        cout = ddims[i + 1]
        if nested:
            stage = f"decoder.upsamples.{i}.upsamples"
            idx = 0
        else:
            stage = "decoder.upsamples"
        for j in range(cfg.num_res_blocks + 1):
            e += res(f"{stage}.{idx}", ("decoder", f"up_{i}_block_{j}"), cin, cout)
            cin = cout
            idx += 1
        if i != len(cfg.dim_mult) - 1:
            if temporal_up[i]:
                e.append((f"{stage}.{idx}.time_conv",
                          ("decoder", f"up_{i}_us", "time_conv"), "conv3d", None))
            e.append((f"{stage}.{idx}.resample.1",
                      ("decoder", f"up_{i}_us", "resample", "conv"), "conv2d3d", None))
            idx += 1
            # Wan2.1's upsample conv halves the width; 2.2 keeps it
            cin = cout if nested else cout // 2
    e += [("decoder.head.0", ("decoder", "head_norm"), "gamma4", None),
          ("decoder.head.2", ("decoder", "head_conv", "conv"), "conv3d", None)]
    return e


def import_wan_vae(state, cfg, prefix: str = "") -> dict:
    return _import(state, _wan_vae_entries(cfg), prefix)


def export_wan_vae(state_dict, cfg, prefix: str = "") -> dict:
    return _export(state_dict, _wan_vae_entries(cfg), prefix)


def _qwen_vl_vision_entries(cfg):
    """The Qwen2.5-VL vision tower, HF layout under the `visual.` prefix
    (the qwen_2.5_vl_7b.safetensors the reference's Qwen workflows load;
    the text keys of the same file go through _llama_entries).  The Conv3d
    patch embed maps onto the patchify Linear; the RMS scales are raw
    parameters."""
    e = [
        ("patch_embed.proj", ("patch_embed",),
         ("conv3d_as_linear", (cfg.in_channels, cfg.temporal_patch_size,
                               cfg.patch_size, cfg.patch_size)), None),
        ("merger.ln_q", ("ln_q",), "rms_weight", None),
        ("merger.mlp.0", ("merger_0",), "linear", None),
        ("merger.mlp.2", ("merger_2",), "linear", None),
    ]
    for i in range(cfg.depth):
        b, p, st = f"blocks.{i}", ("blocks", "block"), (i, cfg.depth)
        e += [
            (f"{b}.norm1", p + ("norm1",), "rms_weight", st),
            (f"{b}.norm2", p + ("norm2",), "rms_weight", st),
            (f"{b}.attn.qkv", p + ("qkv",), "linear", st),
            (f"{b}.attn.proj", p + ("proj",), "linear", st),
            (f"{b}.mlp.gate_proj", p + ("gate",), "linear", st),
            (f"{b}.mlp.up_proj", p + ("up",), "linear", st),
            (f"{b}.mlp.down_proj", p + ("down",), "linear", st),
        ]
    return e


def import_qwen_vl_vision(state, cfg, prefix: str = "visual.") -> dict:
    return _import(state, _qwen_vl_vision_entries(cfg), prefix)


def export_qwen_vl_vision(state_dict, cfg, prefix: str = "visual.") -> dict:
    return _export(state_dict, _qwen_vl_vision_entries(cfg), prefix)


# --------------------------------------------------------------------------
# text encoders (models/textenc.py): CLIP and T5 / UMT5 in the HF
# transformers state-dict layouts (CLIPTextModel(.WithProjection),
# T5EncoderModel / UMT5EncoderModel), and CLIP's OpenCLIP layout


def _clip_entries(cfg):
    e = [
        ("embeddings.token_embedding.weight", ("token_embedding",), "raw", None),
        ("embeddings.position_embedding.weight", ("position_embedding",), "raw", None),
        ("final_layer_norm", ("final_ln",), "ln", None),
    ]
    if cfg.projection_dim:
        e.append(("text_projection", ("text_projection",), "raw_linear", None))
    for i in range(cfg.layers):
        b = f"encoder.layers.{i}"
        st = (i, cfg.layers)
        e += [
            (f"{b}.self_attn.q_proj", ("layers", "q"), "linear", st),
            (f"{b}.self_attn.k_proj", ("layers", "k"), "linear", st),
            (f"{b}.self_attn.v_proj", ("layers", "v"), "linear", st),
            (f"{b}.self_attn.out_proj", ("layers", "out"), "linear", st),
            (f"{b}.layer_norm1", ("layers", "ln1"), "ln", st),
            (f"{b}.layer_norm2", ("layers", "ln2"), "ln", st),
            (f"{b}.mlp.fc1", ("layers", "fc1"), "linear", st),
            (f"{b}.mlp.fc2", ("layers", "fc2"), "linear", st),
        ]
    return e


def import_clip(state, cfg, prefix: str = "text_model.") -> dict:
    """HF CLIPTextModel(.WithProjection) -> the CLIPTextEncoder state_dict.

    `text_projection.weight` lives OUTSIDE the text_model prefix in HF
    checkpoints; it is aliased in automatically.  The module's
    `text_projection` is (width, projection_dim), the transpose of a torch
    Linear's weight."""
    state = dict(state)
    for key in ("text_projection.weight", "text_projection"):
        if key in state and prefix + "text_projection.weight" not in state:
            state[prefix + "text_projection.weight"] = state[key]
            break
    return _import(state, _clip_entries(cfg), prefix)


def export_clip(state_dict, cfg, prefix: str = "text_model.") -> dict:
    out = _export(state_dict, _clip_entries(cfg), prefix)
    key = prefix + "text_projection.weight"
    if key in out:
        out["text_projection.weight"] = out.pop(key)
    return out


def _t5_entries(cfg):
    e = [
        ("shared.weight", ("shared",), "raw", None),
        ("encoder.final_layer_norm", ("final_ln",), "ln", None),
    ]
    if not cfg.per_layer_rel_bias:
        e.append(("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
                  ("rel_bias",), "raw", None))
    for i in range(cfg.layers):
        b = f"encoder.block.{i}"
        st = (i, cfg.layers)
        if cfg.per_layer_rel_bias:
            e.append((f"{b}.layer.0.SelfAttention.relative_attention_bias.weight",
                      ("blocks", "rel_bias"), "raw", st))
        e += [
            (f"{b}.layer.0.SelfAttention.q", ("blocks", "q"), "linear_nb", st),
            (f"{b}.layer.0.SelfAttention.k", ("blocks", "k"), "linear_nb", st),
            (f"{b}.layer.0.SelfAttention.v", ("blocks", "v"), "linear_nb", st),
            (f"{b}.layer.0.SelfAttention.o", ("blocks", "o"), "linear_nb", st),
            (f"{b}.layer.0.layer_norm", ("blocks", "ln1"), "ln", st),
            (f"{b}.layer.1.DenseReluDense.wi_0", ("blocks", "wi0"), "linear_nb", st),
            (f"{b}.layer.1.DenseReluDense.wi_1", ("blocks", "wi1"), "linear_nb", st),
            (f"{b}.layer.1.DenseReluDense.wo", ("blocks", "wo"), "linear_nb", st),
            (f"{b}.layer.1.layer_norm", ("blocks", "ln2"), "ln", st),
        ]
    return e


def import_t5(state, cfg, prefix: str = "") -> dict:
    """HF T5EncoderModel / UMT5EncoderModel -> the T5Encoder state_dict."""
    state = dict(state)
    if prefix + "shared.weight" not in state:  # tied-embedding alias
        alt = prefix + "encoder.embed_tokens.weight"
        if alt in state:
            state[prefix + "shared.weight"] = state[alt]
    return _import(state, _t5_entries(cfg), prefix)


def export_t5(state_dict, cfg, prefix: str = "") -> dict:
    return _export(state_dict, _t5_entries(cfg), prefix)


def _llama_entries(cfg):
    e = [
        ("embed_tokens.weight", ("embed_tokens",), "raw", None),
        ("norm", ("final_ln",), "ln", None),
    ]
    for i in range(cfg.layers):
        b = f"layers.{i}"
        st = (i, cfg.layers)
        e += [
            (f"{b}.self_attn.q_proj", ("layers", "q"), "linear", st),
            (f"{b}.self_attn.k_proj", ("layers", "k"), "linear", st),
            (f"{b}.self_attn.v_proj", ("layers", "v"), "linear", st),
            (f"{b}.self_attn.o_proj", ("layers", "o"), "linear", st),
            (f"{b}.input_layernorm", ("layers", "ln1"), "ln", st),
            (f"{b}.post_attention_layernorm", ("layers", "ln2"), "ln", st),
            (f"{b}.mlp.gate_proj", ("layers", "gate"), "linear", st),
            (f"{b}.mlp.up_proj", ("layers", "up"), "linear", st),
            (f"{b}.mlp.down_proj", ("layers", "down"), "linear", st),
        ]
        if getattr(cfg, "qk_norm", False):  # Qwen3 per-head q/k RMSNorm
            e += [(f"{b}.self_attn.q_norm", ("layers", "q_norm"), "ln", st),
                  (f"{b}.self_attn.k_norm", ("layers", "k_norm"), "ln", st)]
    return e


def import_llama(state, cfg, prefix: str = "model.") -> dict:
    """HF LlamaModel / Qwen2Model / Qwen3Model (or their CausalLM) -> the
    LlamaEncoder state_dict.  prefix "" for a bare *Model state dict,
    "model." for *ForCausalLM; where the embedding is not under `prefix`,
    the bare and the Qwen2.5-VL multimodal layouts are tried."""
    if prefix + "embed_tokens.weight" not in state:
        for alt in ("", "language_model.", "model.language_model."):
            if alt + "embed_tokens.weight" in state:
                prefix = alt
                break
    return _import(state, _llama_entries(cfg), prefix)


def export_llama(state_dict, cfg, prefix: str = "model.") -> dict:
    return _export(state_dict, _llama_entries(cfg), prefix)


def import_clip_openclip(state, cfg, prefix: str = "") -> dict:
    """OpenCLIP text-tower layout -> the CLIPTextEncoder state_dict.

    This is the layout embedded in single-file SD2.x/SDXL checkpoints
    (`conditioner.embedders.1.model.*`): fused `attn.in_proj_weight/bias`,
    `transformer.resblocks.{i}.*`, `ln_final`, `positional_embedding`, and
    a `text_projection` stored ALREADY as (width, projection_dim), used as
    `x @ proj`, unlike a torch Linear."""
    sb = _StateBuilder()

    def put(p, v, stack=None):
        if stack is None:
            sb.set(p, v)
        else:
            sb.set_stacked(p, stack[0], stack[1], v)

    g = lambda k: _tensor(state[prefix + k])  # noqa: E731
    put(("token_embedding",), g("token_embedding.weight"))
    put(("position_embedding",), g("positional_embedding"))
    put(("final_ln", "scale"), g("ln_final.weight"))
    put(("final_ln", "bias"), g("ln_final.bias"))
    if cfg.projection_dim:
        tp = g("text_projection")
        if tp.shape[0] == cfg.projection_dim and tp.shape[0] != tp.shape[1]:
            tp = tp.T  # tolerate transposed exports
        put(("text_projection",), tp)
    w = cfg.width
    for i in range(cfg.layers):
        b = f"transformer.resblocks.{i}."
        st = (i, cfg.layers)
        inw = g(b + "attn.in_proj_weight")  # (3w, w) torch layout
        inb = g(b + "attn.in_proj_bias")
        for j, nm in enumerate(("q", "k", "v")):
            put(("layers", nm, "kernel"), t_linear(inw[j * w:(j + 1) * w]), st)
            put(("layers", nm, "bias"), inb[j * w:(j + 1) * w], st)
        put(("layers", "out", "kernel"), t_linear(g(b + "attn.out_proj.weight")), st)
        put(("layers", "out", "bias"), g(b + "attn.out_proj.bias"), st)
        for src, dst in (("ln_1", "ln1"), ("ln_2", "ln2")):
            put(("layers", dst, "scale"), g(f"{b}{src}.weight"), st)
            put(("layers", dst, "bias"), g(f"{b}{src}.bias"), st)
        for src, dst in (("mlp.c_fc", "fc1"), ("mlp.c_proj", "fc2")):
            put(("layers", dst, "kernel"), t_linear(g(f"{b}{src}.weight")), st)
            put(("layers", dst, "bias"), g(f"{b}{src}.bias"), st)
    return sb.build()


# single-file checkpoint splitting (the layout every reference workflow's
# CheckpointLoaderSimple consumes: UNet + CLIP(s) + VAE in one safetensors).
# As in the JAX package, no prefix covers an SD2.x single file's OpenCLIP-H
# tower (`cond_stage_model.model.`).

_SINGLE_FILE_PREFIXES = {
    "unet": ("model.diffusion_model.",),
    "vae": ("first_stage_model.", "vae."),
    # SDXL dual text encoders / SD1.x single
    "clip_l": ("conditioner.embedders.0.transformer.",
               "cond_stage_model.transformer.",
               "text_encoders.clip_l.transformer."),
    "clip_g": ("conditioner.embedders.1.model.",
               "text_encoders.clip_g.transformer.",
               "conditioner.embedders.0.model."),
    "t5": ("text_encoders.t5xxl.transformer.",),
}


def split_checkpoint(state) -> Dict[str, dict]:
    """Split a single-file SD/SDXL/SD3-style state dict into component
    sub-dicts keyed by component name, with prefixes stripped.  Components
    absent from the file are omitted.  The clip_g sub-dict is OpenCLIP
    layout when it came from `conditioner.embedders.*.model.` (single-file
    SDXL) and HF layout when from `text_encoders.*` (SD3-style)."""
    out: Dict[str, dict] = {}
    for comp, prefixes in _SINGLE_FILE_PREFIXES.items():
        for p in prefixes:
            sub = {k[len(p):]: v for k, v in state.items() if k.startswith(p)}
            if sub:
                out.setdefault(comp, sub)
                break
    return out
