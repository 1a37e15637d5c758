"""The port's checkpoint loading (`lanpaint_tpu_torch/models/load.py`,
`native/`) against the JAX package's.

For every family the port imports (the SD UNets, the VAE, CLIP in the HF
and the OpenCLIP layouts, T5 / UMT5, the Llama / Qwen2.5 / Qwen3 trunks,
the Qwen2.5-VL vision tower, the MMDiT in the Flux and the Qwen-Image
layouts, SD3.5 and SD3-Medium, HiDream-I1, HunyuanVideo, Z-Image, the Wan
DiT and both Wan VAEs), a checkpoint state is
made by the JAX exporter from a tree of random values (every leaf
distinct, biases and norm scales included): the port's import must equal
`bridge.params_from_flax` of the JAX import bit for bit, cover the port
module's state_dict exactly, and export back to the checkpoint.  The
reader must give the JAX reader's arrays, dtypes included, on F32 / F16 /
BF16 / F8 files with fp8 scales, through the native conversion and
through torch's.  The full-scale key sets come from the
tables alone and must equal the JAX package's and the independent
manifests of tests/manifests.py.
"""

import dataclasses
import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import manifests as M
from lanpaint_tpu.models import dit as jdit
from lanpaint_tpu.models import hidream as jhidream
from lanpaint_tpu.models import hyvideo as jhyvideo
from lanpaint_tpu.models import load as JL
from lanpaint_tpu.models import sd3 as jsd3
from lanpaint_tpu.models import textenc as jte
from lanpaint_tpu.models import unet as junet
from lanpaint_tpu.models import vae as jvae
from lanpaint_tpu.models import video_vae as jvv
from lanpaint_tpu.models import vision as jvision
from lanpaint_tpu.models import wan as jwan
from lanpaint_tpu.models import zimage as jzimage
from lanpaint_tpu.models import zoo as jzoo
from lanpaint_tpu_torch.models import bridge
from lanpaint_tpu_torch.models import dit as tdit
from lanpaint_tpu_torch.models import hidream as thidream
from lanpaint_tpu_torch.models import hyvideo as thyvideo
from lanpaint_tpu_torch.models import load as TL
from lanpaint_tpu_torch.models import sd3 as tsd3
from lanpaint_tpu_torch.models import textenc as tte
from lanpaint_tpu_torch.models import unet as tunet
from lanpaint_tpu_torch.models import vae as tvae
from lanpaint_tpu_torch.models import video_vae as tvv
from lanpaint_tpu_torch.models import vision as tvision
from lanpaint_tpu_torch.models import wan as twan
from lanpaint_tpu_torch.models import zimage as tzimage
from lanpaint_tpu_torch.models import zoo as tzoo
from lanpaint_tpu_torch.native import loader as tloader
from test_torch_textenc import random_tree


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's tests: their tensors are tiny,
    and under pytest-xdist the workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hf_to_openclip(sd, layers):
    """An HF CLIPTextModelWithProjection state (`export_clip`'s keys) in
    the OpenCLIP text-tower layout of single-file SD2.x / SDXL
    checkpoints."""
    out = {
        "token_embedding.weight": sd["text_model.embeddings.token_embedding.weight"],
        "positional_embedding": sd["text_model.embeddings.position_embedding.weight"],
        "ln_final.weight": sd["text_model.final_layer_norm.weight"],
        "ln_final.bias": sd["text_model.final_layer_norm.bias"],
        # OpenCLIP stores text_projection as (width, proj), used as x @ proj
        "text_projection": np.ascontiguousarray(np.asarray(sd["text_projection.weight"]).T),
    }
    for i in range(layers):
        hf, oc = f"text_model.encoder.layers.{i}.", f"transformer.resblocks.{i}."
        for part in ("weight", "bias"):
            out[oc + "attn.in_proj_" + part] = np.concatenate(
                [sd[hf + f"self_attn.{n}_proj.{part}"] for n in "qkv"], axis=0)
            for src, dst in (("self_attn.out_proj", "attn.out_proj"), ("layer_norm1", "ln_1"),
                             ("layer_norm2", "ln_2"), ("mlp.fc1", "mlp.c_fc"),
                             ("mlp.fc2", "mlp.c_proj")):
                out[f"{oc}{dst}.{part}"] = sd[f"{hf}{src}.{part}"]
    return out


UNET_SD1 = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                transformer_depth=(1, 2), transformer_depth_middle=1, context_dim=24,
                head_dim=None, num_heads=2)
UNET_SDXL = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                 transformer_depth=(0, 2), transformer_depth_middle=3, context_dim=24,
                 head_dim=16, adm_in_channels=40)
CLIP = dict(vocab_size=100, width=32, layers=2, heads=4, intermediate=48, projection_dim=24,
            eos_token_id=3)
T5 = dict(vocab_size=50, d_model=16, head_dim=4, d_ff=40, layers=2, heads=3, rel_buckets=8,
          rel_max_distance=16)


def _unet(kw):
    jcfg = junet.UNetConfig(**kw)
    tree = random_tree(junet.UNetModel(jcfg), jnp.zeros((1, 4, 16, 16)), jnp.zeros((1,)),
                       jnp.zeros((1, 8, jcfg.context_dim)),
                       jnp.zeros((1, jcfg.adm_in_channels)) if jcfg.adm_in_channels else None)
    tree = JL.fuse_unet_qkv(tree)
    return (tree, jcfg, tunet.UNetConfig(**kw), tunet.UNetModel,
            JL.export_unet, JL.import_unet, TL.export_unet, TL.import_unet)


def _vae(quant_conv):
    jcfg = dataclasses.replace(jvae.TINY_VAE_CONFIG, quant_conv=quant_conv, z_channels=6)
    tcfg = dataclasses.replace(tvae.TINY_VAE_CONFIG, quant_conv=quant_conv, z_channels=6)
    tree = random_tree(jvae.VAE(jcfg), jnp.zeros((1, 3, 16, 16)), jax.random.PRNGKey(1))
    return (tree, jcfg, tcfg, tvae.VAE, JL.export_vae, JL.import_vae, TL.export_vae,
            TL.import_vae)


def _clip(proj):
    kw = dict(CLIP, projection_dim=proj, act="gelu" if proj else "quick_gelu")
    jcfg, tcfg = jte.CLIPTextConfig(**kw), tte.CLIPTextConfig(**kw)
    tree = random_tree(jte.CLIPTextEncoder(jcfg), jnp.zeros((1, 12), jnp.int32))
    return (tree, jcfg, tcfg, tte.CLIPTextEncoder, JL.export_clip, JL.import_clip,
            TL.export_clip, TL.import_clip)


def _t5(per_layer):
    kw = dict(T5, per_layer_rel_bias=per_layer)
    jcfg, tcfg = jte.T5Config(**kw), tte.T5Config(**kw)
    tree = random_tree(jte.T5Encoder(jcfg), jnp.zeros((1, 7), jnp.int32))
    return (tree, jcfg, tcfg, tte.T5Encoder, JL.export_t5, JL.import_t5, TL.export_t5,
            TL.import_t5)


def _dit():
    jcfg, tcfg = jdit.TINY_DIT_CONFIG, tdit.TINY_DIT_CONFIG
    tree = random_tree(jdit.MMDiT(jcfg), jnp.zeros((1, jcfg.latent_channels, 8, 8)),
                       jnp.full((1,), 0.5), jnp.zeros((1, 4, jcfg.context_dim)),
                       jnp.zeros((1, jcfg.vec_dim)))
    return (tree, jcfg, tcfg, tdit.MMDiT, JL.export_dit, JL.import_dit, TL.export_dit,
            TL.import_dit)


def _llama(**extra):
    kw = dict(vocab_size=60, dim=16, layers=2, heads=4, kv_heads=2, intermediate=24, **extra)
    jcfg, tcfg = jte.LlamaConfig(**kw), tte.LlamaConfig(**kw)
    tree = random_tree(jte.LlamaEncoder(jcfg), jnp.zeros((1, 5), jnp.int32))
    return (tree, jcfg, tcfg, tte.LlamaEncoder, JL.export_llama, JL.import_llama,
            TL.export_llama, TL.import_llama)


def _vision():
    jcfg, tcfg = jvision.TINY_VL_VISION_CONFIG, tvision.TINY_VL_VISION_CONFIG
    tree = random_tree(jvision.QwenVLVision(jcfg, (1, 4, 4)), jnp.zeros((16, 24)))
    return (tree, jcfg, tcfg, tvision.QwenVLVision, JL.export_qwen_vl_vision,
            JL.import_qwen_vl_vision, TL.export_qwen_vl_vision, TL.import_qwen_vl_vision)


def _zimage():
    jcfg, tcfg = jzimage.TINY_ZIMAGE_CONFIG, tzimage.TINY_ZIMAGE_CONFIG
    tree = random_tree(jzimage.ZImageModel(jcfg), jnp.zeros((1, 4, 8, 8)), jnp.full((1,), 0.5),
                       jnp.zeros((1, 3, jcfg.cap_dim)))
    return (tree, jcfg, tcfg, tzimage.ZImageModel, JL.export_zimage, JL.import_zimage,
            TL.export_zimage, TL.import_zimage)


def _qwen_image():
    kw = dict(depth_single=0, txt_norm=True, vec_dim=0)
    jcfg = dataclasses.replace(jdit.TINY_DIT_CONFIG, **kw)
    tcfg = dataclasses.replace(tdit.TINY_DIT_CONFIG, **kw)
    tree = random_tree(jdit.MMDiT(jcfg), jnp.zeros((1, jcfg.latent_channels, 8, 8)),
                       jnp.full((1,), 0.5), jnp.zeros((1, 4, jcfg.context_dim)))
    return (tree, jcfg, tcfg, tdit.MMDiT, JL.export_qwen, JL.import_qwen, TL.export_qwen,
            TL.import_qwen)


def _sd3(dual):
    kw = {} if dual else dict(dual_attn_layers=(), qk_norm=False)
    jcfg = dataclasses.replace(jsd3.TINY_SD3_CONFIG, **kw)
    tcfg = dataclasses.replace(tsd3.TINY_SD3_CONFIG, **kw)
    tree = random_tree(jsd3.SD3MMDiT(jcfg), jnp.zeros((1, 4, 8, 8)), jnp.full((1,), 0.5),
                       jnp.zeros((1, 3, jcfg.context_dim)), jnp.zeros((1, jcfg.vec_dim)))
    return (tree, jcfg, tcfg, tsd3.SD3MMDiT, JL.export_sd3, JL.import_sd3, TL.export_sd3,
            TL.import_sd3)


def _hidream():
    jcfg, tcfg = jhidream.TINY_HIDREAM_CONFIG, thidream.TINY_HIDREAM_CONFIG
    tree = random_tree(jhidream.HiDreamModel(jcfg), jnp.zeros((1, 4, 8, 8)), jnp.full((1,), 0.5),
                       jnp.zeros((1, 3, jcfg.context_dim)), jnp.zeros((1, jcfg.vec_dim)),
                       jnp.zeros((2, 1, 4, jcfg.llama_dim)))
    return (tree, jcfg, tcfg, thidream.HiDreamModel, JL.export_hidream, JL.import_hidream,
            TL.export_hidream, TL.import_hidream)


def _hyvideo():
    jcfg, tcfg = jhyvideo.TINY_HYVIDEO_CONFIG, thyvideo.TINY_HYVIDEO_CONFIG
    tree = random_tree(jhyvideo.HYVideoDiT(jcfg), jnp.zeros((1, 4, 1, 8, 8)), jnp.full((1,), 0.5),
                       jnp.zeros((1, 3, jcfg.context_dim)), jnp.zeros((1, jcfg.vec_dim)),
                       jnp.full((1,), 6.0))
    return (tree, jcfg, tcfg, thyvideo.HYVideoDiT, JL.export_hyvideo, JL.import_hyvideo,
            TL.export_hyvideo, TL.import_hyvideo)


def _wan():
    jcfg, tcfg = jwan.TINY_WAN_CONFIG, twan.TINY_WAN_CONFIG
    tree = random_tree(jwan.WanModel(jcfg), jnp.zeros((1, jcfg.in_channels, 3, 8, 8)),
                       jnp.full((1,), 0.5), jnp.zeros((1, 4, jcfg.context_dim)))
    return (tree, jcfg, tcfg, twan.WanModel, JL.export_wan, JL.import_wan, TL.export_wan,
            TL.import_wan)


def _wan_vae(name):
    jcfg, tcfg = getattr(jvv, name), getattr(tvv, name)
    tree = random_tree(jvv.WanVAE(jcfg), jnp.zeros((1, 3, 5, 16, 16)))
    return (tree, jcfg, tcfg, tvv.WanVAE, JL.export_wan_vae, JL.import_wan_vae,
            TL.export_wan_vae, TL.import_wan_vae)


FAMILIES = {
    "unet_sd1": lambda: _unet(UNET_SD1), "unet_sdxl": lambda: _unet(UNET_SDXL),
    "vae": lambda: _vae(True), "vae_no_quant": lambda: _vae(False),
    "clip_proj": lambda: _clip(24), "clip_square_proj": lambda: _clip(32),
    "clip_no_proj": lambda: _clip(0), "t5": lambda: _t5(False), "umt5": lambda: _t5(True),
    "dit": _dit, "wan": _wan, "wan21_vae": lambda: _wan_vae("TINY_WAN_VAE_CONFIG"),
    "wan22_vae": lambda: _wan_vae("TINY_WAN22_VAE_CONFIG"),
    "llama": lambda: _llama(rope_scaling=(8.0, 1.0, 4.0, 64)),
    "qwen25": lambda: _llama(qkv_bias=True, mrope_section=(1, 1, 0)),
    "qwen3": lambda: _llama(head_dim=8, qk_norm=True), "qwen_vl_vision": _vision,
    "zimage": _zimage, "qwen_image": _qwen_image, "sd3": lambda: _sd3(True),
    "sd3_medium": lambda: _sd3(False), "hidream": _hidream, "hyvideo": _hyvideo,
}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family_case(request):
    tree, jcfg, tcfg, cls, jexport, jimport, texport, timport = FAMILIES[request.param]()
    state = {k: np.asarray(v) for k, v in jexport(tree, jcfg).items()}
    return request.param, state, jcfg, tcfg, cls, jimport, texport, timport


def _assert_equal_states(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k], want[k]
        assert g.dtype == w.dtype and tuple(g.shape) == tuple(w.shape), k
        assert torch.equal(g, w), k


def test_import_equals_the_bridge_of_the_jax_import(family_case):
    name, state, jcfg, tcfg, cls, jimport, _, timport = family_case
    want = bridge.params_from_flax(jimport(state, jcfg))
    got = timport(state, tcfg)
    _assert_equal_states(got, want)
    with torch.device("meta"):
        module = cls(tcfg)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in module.state_dict().items()}, name


def test_export_of_the_import_is_the_checkpoint(family_case):
    _, state, _, tcfg, _, _, texport, timport = family_case
    out = texport(timport(state, tcfg), tcfg)
    assert sorted(out) == sorted(state)
    for k, v in state.items():
        assert out[k].shape == v.shape, k
        np.testing.assert_array_equal(out[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("square", [False, True])
def test_openclip_import_equals_the_bridge_of_the_jax_import(square):
    tree, jcfg, tcfg, *_ = _clip(32 if square else 24)
    state = _hf_to_openclip({k: np.asarray(v) for k, v in JL.export_clip(tree, jcfg).items()},
                            jcfg.layers)
    want = bridge.params_from_flax(JL.import_clip_openclip(state, jcfg))
    got = TL.import_clip_openclip(state, tcfg)
    _assert_equal_states(got, want)
    # the same tower as its HF layout, and the projection used as x @ proj
    _assert_equal_states(got, bridge.params_from_flax(tree))


def test_openclip_tolerates_a_transposed_projection():
    tree, jcfg, tcfg, *_ = _clip(24)
    state = _hf_to_openclip({k: np.asarray(v) for k, v in JL.export_clip(tree, jcfg).items()},
                            jcfg.layers)
    state["text_projection"] = np.ascontiguousarray(state["text_projection"].T)
    _assert_equal_states(TL.import_clip_openclip(state, tcfg),
                         bridge.params_from_flax(JL.import_clip_openclip(state, jcfg)))


def test_fuse_then_unfuse_is_the_identity():
    tree, jcfg, tcfg, *_ = _unet(UNET_SDXL)
    state = bridge.params_from_flax(tree)
    split = TL.unfuse_unet_qkv(state)
    assert not any(k.endswith(("to_qkv.weight", "kv_cross")) for k in split)
    _assert_equal_states(TL.fuse_unet_qkv(split), state)


def test_split_checkpoint_matches_jax():
    z = np.zeros(1, np.float32)
    state = {k: z for k in (
        "model.diffusion_model.input_blocks.0.0.weight", "first_stage_model.encoder.conv_in.weight",
        "vae.decoder.conv_in.weight",
        "conditioner.embedders.0.transformer.text_model.final_layer_norm.weight",
        "conditioner.embedders.1.model.ln_final.weight",
        "cond_stage_model.transformer.text_model.final_layer_norm.bias",
        "text_encoders.clip_g.transformer.text_model.final_layer_norm.weight",
        "text_encoders.t5xxl.transformer.shared.weight",
        "cond_stage_model.model.ln_final.weight", "unrelated.key")}
    for drop in ((), ("conditioner.embedders.0.transformer.text_model.final_layer_norm.weight",
                      "conditioner.embedders.1.model.ln_final.weight")):
        sub = {k: v for k, v in state.items() if k not in drop}
        want, got = JL.split_checkpoint(sub), TL.split_checkpoint(sub)
        assert {c: sorted(d) for c, d in got.items()} == {c: sorted(d) for c, d in want.items()}
    # as in the JAX package, an SD2.x single file's OpenCLIP-H tower has no prefix
    assert "clip_g" not in TL.split_checkpoint({"cond_stage_model.model.ln_final.weight": z})


# --------------------------------------------------------------------------
# the reader


def _write_checkpoint(path):
    safetensors_torch = pytest.importorskip("safetensors.torch")
    g = torch.Generator().manual_seed(0)
    tensors = {
        "a.weight": torch.randn(64, 48, generator=g),
        "b.weight": torch.randn(32, 16, generator=g).to(torch.float16),
        "c.weight": torch.randn(128, 8, generator=g).to(torch.bfloat16),
        "d.bias": torch.randn(7, generator=g),
        "e.idx": torch.arange(10, dtype=torch.int64),
        "f.weight": (torch.randn(256, 64, generator=g) * 0.1).to(torch.float8_e4m3fn),
        "f.scale_weight": torch.tensor(2.5),
        "g.weight": (torch.randn(31, 5, generator=g) * 0.2).to(torch.float8_e5m2),
        "g.scale_weight": torch.tensor(0.75),
        "h.weight": (torch.randn(6, 3, generator=g) * 0.1).to(torch.float8_e4m3fn),
        "h.scale_weight": torch.rand(6, 1, generator=g) + 0.5,
        "i.weight": torch.randn(3, 3, generator=g).to(torch.bfloat16),
        "i.scale_weight": torch.tensor(0.5),
    }
    safetensors_torch.save_file(tensors, str(path))
    return str(path)


@pytest.mark.parametrize("native", [True, False])
def test_reader_matches_the_jax_reader(tmp_path, native):
    path = _write_checkpoint(tmp_path / "ckpt.safetensors")
    tloader.CONVERSIONS.update(native=0, torch=0)
    got = TL.load_safetensors(path, native=native)
    widened = 5  # c, f, g, h, i
    assert tloader.CONVERSIONS == ({"native": widened, "torch": 0} if native
                                   else {"native": 0, "torch": widened})
    for want in (JL.load_safetensors(path), JL.load_safetensors(path, native=False)):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert "f.scale_weight" not in got and got["f.weight"].dtype == np.float32


def test_native_library_builds_outside_the_sources():
    from lanpaint_tpu_torch import native

    assert native.get_lib() is not None
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "lanpaint_tpu_torch"


def test_header_keys_read_only_the_header(tmp_path):
    path = _write_checkpoint(tmp_path / "ckpt.safetensors")
    assert TL.safetensors_header_keys(path) == JL.safetensors_header_keys(path)


# --------------------------------------------------------------------------
# key sets at full scale: the tables alone, no tensor allocated

PORTED_FAMILIES = ["sd15", "sd21", "sdxl", "flux-dev", "flux-schnell", "wan-14b", "wan-5b"]
# the families this parametrisation named while their models waited; those
# ported since are held to the JAX package's census like PORTED_FAMILIES
WAITING_FAMILIES = ["flux2-dev", "flux2-klein", "krea2", "anima", "qwen", "hidream",
                    "sd35-large", "sd35-medium", "sd3-medium", "zimage", "hyvideo"]


@pytest.mark.parametrize("family", PORTED_FAMILIES)
def test_family_expected_keys_match_jax(family):
    assert tzoo.family_expected_keys(family) == jzoo.family_expected_keys(family)


@pytest.mark.parametrize("family", WAITING_FAMILIES + ["nope"])
def test_family_expected_keys_of_unported_families_raise(family):
    """An unknown family raises the JAX package's ValueError; every family
    once waiting gives the JAX package's key census."""
    if family == "nope":
        with pytest.raises(ValueError) as want:
            jzoo.family_expected_keys(family)
        with pytest.raises(ValueError) as got:
            tzoo.family_expected_keys(family)
        assert str(got.value) == str(want.value)
    else:
        got = tzoo.family_expected_keys(family)
        assert got and got == jzoo.family_expected_keys(family)


def _header_only_file(path, keys):
    """A safetensors header naming `keys` (one-element F32 tensors) with
    no data behind it: the census must read the header alone."""
    hdr = json.dumps({k: {"dtype": "F32", "shape": [1], "data_offsets": [0, 4]}
                      for k in sorted(keys)}).encode()
    path.write_bytes(struct.pack("<Q", len(hdr)) + hdr)
    return str(path)


def test_family_census_from_a_header(tmp_path):
    keys = set(tzoo.family_expected_keys("sdxl"))
    path = _header_only_file(tmp_path / "sdxl.safetensors", keys)
    assert tzoo.family_census(path, "sdxl") == jzoo.family_census(path, "sdxl")
    assert tzoo.family_census(path, "sdxl")["ok"]
    gone = sorted(keys)[:3]
    path = _header_only_file(tmp_path / "bad.safetensors", (keys - set(gone)) | {"extra.w"})
    got = tzoo.family_census(path, "sdxl")
    assert got == jzoo.family_census(path, "sdxl")
    assert got["missing"] == gone and got["leftover"] == ["extra.w"] and not got["ok"]


@pytest.mark.parametrize("name, manifest, entries, prefix", [
    ("sd15", lambda: M.unet_manifest(tunet.SD15_CONFIG, linear_proj=False),
     lambda: TL._unet_entries(tunet.SD15_CONFIG), "model.diffusion_model."),
    ("sd21", lambda: M.unet_manifest(tunet.SD21_CONFIG),
     lambda: TL._unet_entries(tunet.SD21_CONFIG), "model.diffusion_model."),
    ("sdxl", lambda: M.unet_manifest(tunet.SDXL_CONFIG),
     lambda: TL._unet_entries(tunet.SDXL_CONFIG), "model.diffusion_model."),
    ("flux-dev", lambda: M.flux_manifest(tdit.FLUX_DEV_CONFIG),
     lambda: TL._dit_entries(tdit.FLUX_DEV_CONFIG), ""),
    ("wan-14b", lambda: M.wan_manifest(twan.WAN22_T2V_14B_CONFIG),
     lambda: TL._wan_entries(twan.WAN22_T2V_14B_CONFIG), ""),
    ("wan-5b", lambda: M.wan_manifest(twan.WAN22_TI2V_5B_CONFIG),
     lambda: TL._wan_entries(twan.WAN22_TI2V_5B_CONFIG), ""),
    ("wan21-vae", lambda: M.wan_vae_manifest(tvv.WAN21_VAE_CONFIG),
     lambda: TL._wan_vae_entries(tvv.WAN21_VAE_CONFIG), ""),
])
def test_full_scale_key_sets_match_the_manifests(name, manifest, entries, prefix):
    keys = set(manifest())
    if name.startswith("wan-"):  # Wan stores its RMS norm scales as `.weight`
        keys = {k.replace(".norm_q.weight", ".norm_q.scale")
                 .replace(".norm_k.weight", ".norm_k.scale") for k in keys}
    _consumed, leftover, missing = TL.manifest_coverage(keys, entries(), prefix)
    assert not leftover and not missing, (name, sorted(leftover)[:4], sorted(missing)[:4])


# --------------------------------------------------------------------------
# the SD1.5 / SD2.1 configs and the v-prediction denoiser


def test_sd_configs_match_jax():
    for name in ("SD15_CONFIG", "SD21_CONFIG", "SDXL_CONFIG"):
        got = dataclasses.asdict(getattr(tunet, name))
        want = dataclasses.asdict(getattr(junet, name))
        got.pop("dtype"), want.pop("dtype"), want.pop("fused_qkv")
        assert got == want, name


@pytest.mark.parametrize("v_prediction", [False, True])
def test_unet_denoiser_matches_jax(v_prediction):
    """`zoo.build_unet(..., v_prediction=...)`'s x0 against the JAX
    builder's, fp32, on the SD1.x-shaped tiny UNet (8 fixed heads is
    `head_dim=None`): relative 1e-4 of the largest value."""
    kw = dict(UNET_SD1, dtype=jnp.float32)
    jcfg = junet.UNetConfig(**kw)
    tcfg = tunet.UNetConfig(**dict(kw, dtype=torch.float32))
    tree = _unet(UNET_SD1)[0]
    tree = jax.tree.map(lambda a: (0.1 * a).astype(np.float32), tree)
    jden, _ = jzoo.build_unet(jcfg, tree, v_prediction=v_prediction)
    tden, _ = tzoo.build_unet(tcfg, TL.import_unet(JL.export_unet(tree, jcfg), tcfg),
                              v_prediction=v_prediction, device="cpu")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 4, 16, 16)).astype(np.float32) * 3.0
    sigma = np.asarray([0.7, 6.0], np.float32)
    ctx = rng.standard_normal((2, 5, jcfg.context_dim)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jden.apply)(jnp.asarray(x), jnp.asarray(sigma),
                                              {"context": jnp.asarray(ctx)}))
    got = tden.apply(torch.from_numpy(x), torch.from_numpy(sigma),
                     {"context": torch.from_numpy(ctx)}).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
