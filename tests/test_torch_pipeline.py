"""The port's `LanPaintPipeline` against the JAX package's.

A single-file checkpoint is written to disk from tiny components exported
by the JAX package (random values in every leaf): SD1.x-shaped (UNet +
CLIP-L + VAE under the SD1.x prefixes, F32) and SDXL-shaped (UNet with the
ADM vector + CLIP-L in the HF layout + CLIP-G in the OpenCLIP layout + VAE,
BF16, so the reader widens).  Both packages' `from_single_file` read it:
the family and the encoders must agree, the port's UNet, VAE and CLIP
state_dicts must equal `bridge.params_from_flax` of the JAX pipeline's
trees bit for bit, and `pipe.encode` must match JAX's within relative L2
1e-5 (fp32 encoders, JAX at "highest" matmul precision).  `pipe(...)` must
equal the port's own `inpaint_image` fed `pipe.encode(prompt)` /
`pipe.encode("")` and the same seed, bit for bit (`inpaint_image` is held
to JAX by tests/test_torch_pixel.py).  `from_components` gets the same
checks for "flux", "z-image" (a tiny Z-Image, a Qwen3 trunk, the tiny VAE),
"qwen" (a tiny Qwen-Image MMDiT in the diffusers layout, a Qwen2.5
trunk and the tiny vision tower in one llama state, the tiny Wan2.1-graph
VAE at one frame), the latter's encode with and without an image, and
"sd35" (a tiny SD3 MMDiT with a dual-attention layer under the
`model.diffusion_model.` prefix, CLIP-L in the HF layout, CLIP-G in the
OpenCLIP one, a T5, the tiny VAE).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanpaint_tpu import pipeline as jpipeline
from lanpaint_tpu import tokenizers as jtok
from lanpaint_tpu.models import dit as jdit
from lanpaint_tpu.models import load as JL
from lanpaint_tpu.models import sd3 as jsd3
from lanpaint_tpu.models import textenc as jte
from lanpaint_tpu.models import unet as junet
from lanpaint_tpu.models import vae as jvae
from lanpaint_tpu.models import video_vae as jvv
from lanpaint_tpu.models import vision as jvision
from lanpaint_tpu.models import zimage as jzimage
from lanpaint_tpu_torch import api
from lanpaint_tpu_torch import pipeline as tpipeline
from lanpaint_tpu_torch.models import bridge
from lanpaint_tpu_torch.models import dit as tdit
from lanpaint_tpu_torch.models import sd3 as tsd3
from lanpaint_tpu_torch.models import textenc as tte
from lanpaint_tpu_torch.models import unet as tunet
from lanpaint_tpu_torch.models import vae as tvae
from lanpaint_tpu_torch.models import video_vae as tvv
from lanpaint_tpu_torch.models import vision as tvision
from lanpaint_tpu_torch.models import zimage as tzimage
from test_torch_load import _hf_to_openclip
from test_torch_text import QWEN_PAD_ID, _clip_files, _spiece_bytes, qwen_llamas
from test_torch_textenc import random_tree

REL_L2 = 1e-5
CLIP_L = dict(width=8, layers=2, heads=2, intermediate=16, projection_dim=0)
CLIP_G = dict(width=12, layers=3, heads=2, intermediate=24, projection_dim=16, act="gelu")
UNETS = {
    "sd15": dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                 transformer_depth=(1, 1), transformer_depth_middle=1, context_dim=8,
                 head_dim=None, num_heads=2),
    # context = CLIP-L (8) + CLIP-G (12); ADM = CLIP-G's projection 16 + 6 * 256
    "sdxl": dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                 transformer_depth=(0, 2), transformer_depth_middle=1, context_dim=20,
                 head_dim=16, adm_in_channels=16 + 6 * 256),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's tests: their tensors are tiny,
    and under pytest-xdist the workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clip_cfgs(kw, vocab_size):
    kw = dict(kw, vocab_size=vocab_size, eos_token_id=vocab_size - 1)
    return jte.CLIPTextConfig(**kw), tte.CLIPTextConfig(**kw)


def _np(state):
    return {k: np.asarray(v) for k, v in state.items()}


def _write(path, state, bf16):
    """A safetensors file of `state` (numpy), in BF16 with `bf16`."""
    safetensors_torch = pytest.importorskip("safetensors.torch")
    tensors = {k: torch.from_numpy(np.array(v, order="C")) for k, v in state.items()}
    if bf16:
        tensors = {k: v.to(torch.bfloat16) for k, v in tensors.items()}
    safetensors_torch.save_file(tensors, str(path))
    return str(path)


@pytest.fixture(scope="module", params=["sd15", "sdxl"])
def single_file(request, tmp_path_factory):
    """(family, the configs, the file, the vocab files, both pipelines)."""
    family = request.param
    tmp = tmp_path_factory.mktemp(family)
    vp, mp, _ = _clip_files(tmp)
    n_vocab = 49408
    jcfg = junet.UNetConfig(**UNETS[family])
    tcfg = tunet.UNetConfig(**UNETS[family])
    unet_tree = JL.fuse_unet_qkv(random_tree(
        junet.UNetModel(jcfg), jnp.zeros((1, 4, 16, 16)), jnp.zeros((1,)),
        jnp.zeros((1, 8, jcfg.context_dim)),
        jnp.zeros((1, jcfg.adm_in_channels)) if jcfg.adm_in_channels else None, seed=1))
    vae_tree = random_tree(jvae.VAE(jvae.TINY_VAE_CONFIG), jnp.zeros((1, 3, 16, 16)),
                            jax.random.PRNGKey(0), seed=2)
    jl, tl = _clip_cfgs(CLIP_L, n_vocab)
    clip_l = random_tree(jte.CLIPTextEncoder(jl), jnp.zeros((1, 77), jnp.int32), seed=3)
    state = {}
    state.update({"model.diffusion_model." + k: v
                  for k, v in _np(JL.export_unet(unet_tree, jcfg, prefix="")).items()})
    state.update({"first_stage_model." + k: v
                  for k, v in _np(JL.export_vae(vae_tree, jvae.TINY_VAE_CONFIG)).items()})
    configs = dict(unet_config=jcfg, vae_config=jvae.TINY_VAE_CONFIG, clip_l_config=jl)
    tconfigs = dict(unet_config=tcfg, vae_config=tvae.TINY_VAE_CONFIG, clip_l_config=tl)
    if family == "sd15":
        state.update({"cond_stage_model.transformer." + k: v
                      for k, v in _np(JL.export_clip(clip_l, jl)).items()})
    else:
        jg, tg = _clip_cfgs(CLIP_G, n_vocab)
        clip_g = random_tree(jte.CLIPTextEncoder(jg), jnp.zeros((1, 77), jnp.int32), seed=4)
        state.update({"conditioner.embedders.0.transformer." + k: v
                      for k, v in _np(JL.export_clip(clip_l, jl)).items()})
        state.update({"conditioner.embedders.1.model." + k: v for k, v in
                      _hf_to_openclip(_np(JL.export_clip(clip_g, jg)), jg.layers).items()})
        configs["clip_g_config"], tconfigs["clip_g_config"] = jg, tg
    path = _write(tmp / "model.safetensors", state, bf16=family == "sdxl")
    size = dict(height=32, width=48)
    jpipe = jpipeline.LanPaintPipeline.from_single_file(path, vocab=vp, merges=mp, **configs,
                                                        **size)
    tpipe = tpipeline.LanPaintPipeline.from_single_file(path, vocab=vp, merges=mp, **tconfigs,
                                                        **size, device="cpu")
    return family, path, vp, mp, tconfigs, jpipe, tpipe


def _assert_bridged(module, tree):
    want = bridge.params_from_flax(jax.device_get(tree))
    got = module.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_single_file_loads_what_jax_loads(single_file):
    family, _, _, _, _, jpipe, tpipe = single_file
    assert tpipe.family == jpipe.family == family
    assert sorted(tpipe.encoders) == sorted(jpipe.encoders) == \
        (["clip_l"] if family == "sd15" else ["clip_g", "clip_l"])
    _assert_bridged(tpipe.model.module, jpipe.model.params)
    _assert_bridged(tpipe.vae, jpipe.vae_params)
    for name, enc in tpipe.encoders.items():
        _assert_bridged(enc.module, jpipe.encoders[name].params)
        assert enc.device == torch.device("cpu")


def test_encode_matches_jax(single_file):
    *_, jpipe, tpipe = single_file
    for prompt in ("the cat", ""):
        with jax.default_matmul_precision("highest"):
            want = jpipe.encode(prompt)
        got = tpipe.encode(prompt)
        assert sorted(got) == sorted(want)
        for k in want:
            w, g = np.asarray(want[k], np.float64), got[k].double().numpy()
            assert g.shape == w.shape
            assert np.linalg.norm(g - w) / np.linalg.norm(w) <= REL_L2, k


def _image_and_mask(seed=0):
    img = torch.from_numpy(
        np.random.default_rng(seed).uniform(-1, 1, (1, 3, 32, 48)).astype(np.float32))
    mask = torch.zeros((32, 48))
    mask[8:24, 12:36] = 1.0
    return img, mask


def test_call_equals_inpaint_image(single_file):
    *_, tpipe = single_file
    img, mask = _image_and_mask()
    kw = dict(seed=3, steps=3, num_steps=2, cfg=5.0, blend_overlap=3, sequential_cfg=True)
    out = tpipe("the cat", image=img, mask=mask, **kw)
    want = api.inpaint_image(tpipe.model, tpipe.vae, image=img, mask=mask,
                             positive=tpipe.encode("the cat"), negative=tpipe.encode(""), **kw)
    assert out.shape == img.shape and bool(torch.isfinite(out).all())
    assert torch.equal(out, want)
    assert torch.equal(out[..., :2, :], img[..., :2, :])  # beyond the blend: the source


def test_in_memory_state_gives_the_same_pipeline(single_file):
    from lanpaint_tpu_torch.models.load import load_safetensors

    _, path, vp, mp, tconfigs, _, tpipe = single_file
    other = tpipeline.LanPaintPipeline.from_single_file(
        "<in-memory>", state=load_safetensors(path), vocab=vp, merges=mp, **tconfigs,
        device="cpu")
    for a, b in ((other.model.module, tpipe.model.module), (other.vae, tpipe.vae)):
        assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                      b.state_dict().values()))


def test_builds_on_the_card_unless_asked_for_the_cpu(single_file, monkeypatch):
    _, path, vp, mp, tconfigs, *_ = single_file
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipeline.LanPaintPipeline.from_single_file(path, vocab=vp, merges=mp, **tconfigs)


# --------------------------------------------------------------------------
# from_components


def test_from_components_flux(tmp_path):
    vp, mp, _ = _clip_files(tmp_path)
    n_vocab = 49408
    spiece = tmp_path / "spiece.model"
    spiece.write_bytes(_spiece_bytes())
    spiece, n_pieces = str(spiece), len(jtok.load_sentencepiece_model(str(spiece)))
    dcfg = jdit.TINY_DIT_CONFIG
    dit_tree = random_tree(jdit.MMDiT(dcfg), jnp.zeros((1, dcfg.latent_channels, 8, 8)),
                            jnp.full((1,), 0.5), jnp.zeros((1, 4, dcfg.context_dim)),
                            jnp.zeros((1, dcfg.vec_dim)), seed=5)
    vae_tree = random_tree(jvae.VAE(jvae.TINY_VAE_CONFIG), jnp.zeros((1, 3, 16, 16)),
                            jax.random.PRNGKey(0), seed=6)
    jl, tl = _clip_cfgs(dict(CLIP_L, width=dcfg.vec_dim), n_vocab)
    clip_tree = random_tree(jte.CLIPTextEncoder(jl), jnp.zeros((1, 77), jnp.int32), seed=7)
    t5kw = dict(vocab_size=n_pieces, d_model=dcfg.context_dim, head_dim=8, d_ff=40, layers=2,
                heads=3, rel_buckets=8, rel_max_distance=16)
    jt5, tt5 = jte.T5Config(**t5kw), tte.T5Config(**t5kw)
    t5_tree = random_tree(jte.T5Encoder(jt5), jnp.zeros((1, 8), jnp.int32), seed=8)
    files = dict(model=_np(JL.export_dit(dit_tree, dcfg)),
                 vae=_np(JL.export_vae(vae_tree, jvae.TINY_VAE_CONFIG)),
                 clip_l=_np(JL.export_clip(clip_tree, jl)), t5=_np(JL.export_t5(t5_tree, jt5)))
    files = {k: _write(tmp_path / f"{k}.safetensors", v, bf16=False) for k, v in files.items()}
    common = dict(family="flux", clip_vocab=vp, clip_merges=mp, t5_tokenizer=spiece,
                  height=32, width=48, **files)
    jpipe = jpipeline.LanPaintPipeline.from_components(
        model_config=dcfg, vae_config=jvae.TINY_VAE_CONFIG, clip_l_config=jl, t5_config=jt5,
        **common)
    tpipe = tpipeline.LanPaintPipeline.from_components(
        model_config=tdit.TINY_DIT_CONFIG, vae_config=tvae.TINY_VAE_CONFIG, clip_l_config=tl,
        t5_config=tt5, device="cpu", **common)
    assert tpipe.family == jpipe.family == "flux"
    assert sorted(tpipe.encoders) == sorted(jpipe.encoders) == ["clip_l", "t5"]
    _assert_bridged(tpipe.model.module, jpipe.model.params)
    _assert_bridged(tpipe.vae, jpipe.vae_params)
    for name, enc in tpipe.encoders.items():
        _assert_bridged(enc.module, jpipe.encoders[name].params)
    with jax.default_matmul_precision("highest"):
        want = jpipe.encode("a corgi", t5_length=16, guidance=3.5)
    got = tpipe.encode("a corgi", t5_length=16, guidance=3.5)
    assert sorted(got) == sorted(want)
    for k in want:
        w, g = np.asarray(want[k], np.float64), got[k].double().numpy()
        assert np.linalg.norm(g - w) / np.linalg.norm(w) <= REL_L2, k

    img, mask = _image_and_mask(1)
    kw = dict(seed=2, steps=3, num_steps=2, cfg=1.0, blend_overlap=3)
    out = tpipe("a corgi", image=img, mask=mask, encode_kw={"t5_length": 16}, **kw)
    want = api.inpaint_image(tpipe.model, tpipe.vae, image=img, mask=mask,
                             positive=tpipe.encode("a corgi", t5_length=16),
                             negative=tpipe.encode("", t5_length=16), **kw)
    assert torch.equal(out, want) and bool(torch.isfinite(out).all())


def _llama_state(enc):
    """A tiny NativeEncoder's trunk as the HF *ForCausalLM layout ("model.")."""
    return _np(JL.export_llama(enc.params, enc.cfg))


def _sd35_components(tmp_path, **port_kw):
    """(JAX pipeline, port pipeline) of a tiny SD3 MMDiT (one dual-attention
    layer; its `model.diffusion_model.` prefix autodetected), the tiny VAE,
    a CLIP-L and a CLIP-G (whose hidden widths 8 + 12 pad into T5's 32 and
    whose pooled 8 + 8 make the model's vec 16) and a T5, written as files."""
    vp, mp, _ = _clip_files(tmp_path)
    spiece = tmp_path / "spiece.model"
    spiece.write_bytes(_spiece_bytes())
    spiece, n_pieces = str(spiece), len(jtok.load_sentencepiece_model(str(spiece)))
    jcfg, tcfg = jsd3.TINY_SD3_CONFIG, tsd3.TINY_SD3_CONFIG
    mtree = random_tree(jsd3.SD3MMDiT(jcfg), jnp.zeros((1, 4, 8, 8)), jnp.full((1,), 0.5),
                        jnp.zeros((1, 3, jcfg.context_dim)), jnp.zeros((1, jcfg.vec_dim)),
                        seed=5)
    vtree = random_tree(jvae.VAE(jvae.TINY_VAE_CONFIG), jnp.zeros((1, 3, 16, 16)),
                        jax.random.PRNGKey(0), seed=6)
    jl, tl = _clip_cfgs(CLIP_L, 49408)
    jg, tg = _clip_cfgs(dict(CLIP_G, projection_dim=8), 49408)
    ltree = random_tree(jte.CLIPTextEncoder(jl), jnp.zeros((1, 77), jnp.int32), seed=7)
    gtree = random_tree(jte.CLIPTextEncoder(jg), jnp.zeros((1, 77), jnp.int32), seed=8)
    t5kw = dict(vocab_size=n_pieces, d_model=jcfg.context_dim, head_dim=8, d_ff=40, layers=2,
                heads=3, rel_buckets=8, rel_max_distance=16)
    jt5, tt5 = jte.T5Config(**t5kw), tte.T5Config(**t5kw)
    t5_tree = random_tree(jte.T5Encoder(jt5), jnp.zeros((1, 8), jnp.int32), seed=9)
    files = dict(model=_np(JL.export_sd3(mtree, jcfg)),
                 vae=_np(JL.export_vae(vtree, jvae.TINY_VAE_CONFIG)),
                 clip_l=_np(JL.export_clip(ltree, jl)),
                 clip_g=_hf_to_openclip(_np(JL.export_clip(gtree, jg)), jg.layers),
                 t5=_np(JL.export_t5(t5_tree, jt5)))
    files = {k: _write(tmp_path / f"{k}.safetensors", v, bf16=False) for k, v in files.items()}
    common = dict(family="sd35", clip_vocab=vp, clip_merges=mp, t5_tokenizer=spiece, height=16,
                  width=24, **files)
    jpipe = jpipeline.LanPaintPipeline.from_components(
        model_config=jcfg, vae_config=jvae.TINY_VAE_CONFIG, clip_l_config=jl, clip_g_config=jg,
        t5_config=jt5, **common)
    tpipe = tpipeline.LanPaintPipeline.from_components(
        model_config=tcfg, vae_config=tvae.TINY_VAE_CONFIG, clip_l_config=tl, clip_g_config=tg,
        t5_config=tt5, device="cpu", **common, **port_kw)
    return jpipe, tpipe


def test_from_components_builds_the_encoders_in_their_own_dtype(tmp_path):
    """`encoder_dtype` (the port's own argument, as device and param_dtype
    are) gives the text encoders their parameter dtype beside a bf16
    model: their weights stay the files' fp32, bit for bit."""
    jpipe, tpipe = _sd35_components(tmp_path, param_dtype=torch.bfloat16,
                                    encoder_dtype=torch.float32)
    assert {p.dtype for p in tpipe.model.module.parameters()} == {torch.bfloat16}
    assert {p.dtype for p in tpipe.vae.parameters()} == {torch.bfloat16}
    for name, enc in tpipe.encoders.items():
        assert {p.dtype for p in enc.module.parameters()} == {torch.float32}, name
        _assert_bridged(enc.module, jpipe.encoders[name].params)


def _components(family, tmp_path):
    """(JAX pipeline, port pipeline) of tiny components written as files."""
    if family == "sd35":
        return _sd35_components(tmp_path)
    llamas = qwen_llamas()
    (jt, tt) = (enc.tokenizer for enc in llamas["qwen25"])
    if family == "z-image":
        jz, tz = jzimage.TINY_ZIMAGE_CONFIG, tzimage.TINY_ZIMAGE_CONFIG
        ztree = random_tree(jzimage.ZImageModel(jz), jnp.zeros((1, 4, 8, 8)), jnp.full((1,), 0.5),
                            jnp.zeros((1, 4, jz.cap_dim)), seed=5)
        vtree = random_tree(jvae.VAE(jvae.TINY_VAE_CONFIG), jnp.zeros((1, 3, 16, 16)),
                            jax.random.PRNGKey(0), seed=6)
        files = dict(model=_np(JL.export_zimage(ztree, jz)),
                     vae=_np(JL.export_vae(vtree, jvae.TINY_VAE_CONFIG)),
                     llama=_llama_state(llamas["qwen3"][0]))
        jkw = dict(model_config=jz, vae_config=jvae.TINY_VAE_CONFIG,
                   llama_config=llamas["qwen3"][0].cfg)
        tkw = dict(model_config=tz, vae_config=tvae.TINY_VAE_CONFIG,
                   llama_config=llamas["qwen3"][1].cfg)
    else:
        qwen = dict(depth_single=0, txt_norm=True, vec_dim=0, context_dim=24)
        jd = dataclasses.replace(jdit.TINY_DIT_CONFIG, **qwen)
        td = dataclasses.replace(tdit.TINY_DIT_CONFIG, **qwen)
        dtree = random_tree(jdit.MMDiT(jd), jnp.zeros((1, 4, 8, 8)), jnp.full((1,), 0.5),
                            jnp.zeros((1, 4, 24)), seed=5)
        vtree = random_tree(jvv.WanVAE(jvv.TINY_WAN_VAE_CONFIG), jnp.zeros((1, 3, 1, 16, 16)),
                            seed=6, scale=0.1)
        llama = _llama_state(llamas["qwen25"][0])
        llama.update(_np(JL.export_qwen_vl_vision(llamas["vision"][0].params,
                                                  jvision.TINY_VL_VISION_CONFIG)))
        files = dict(model=_np(JL.export_qwen(dtree, jd)),
                     vae=_np(JL.export_wan_vae(vtree, jvv.TINY_WAN_VAE_CONFIG)), llama=llama)
        jkw = dict(model_config=jd, vae_config=jvv.TINY_WAN_VAE_CONFIG,
                   llama_config=llamas["qwen25"][0].cfg, with_vision=True,
                   vision_config=jvision.TINY_VL_VISION_CONFIG)
        tkw = dict(model_config=td, vae_config=tvv.TINY_WAN_VAE_CONFIG,
                   llama_config=llamas["qwen25"][1].cfg, with_vision=True,
                   vision_config=tvision.TINY_VL_VISION_CONFIG)
    files = {k: _write(tmp_path / f"{k}.safetensors", v, bf16=False) for k, v in files.items()}
    common = dict(family=family, height=16, width=24, **files)
    jpipe = jpipeline.LanPaintPipeline.from_components(llama_tokenizer=jt, **jkw, **common)
    tpipe = tpipeline.LanPaintPipeline.from_components(llama_tokenizer=tt, device="cpu", **tkw,
                                                       **common)
    return jpipe, tpipe


def _same_conds(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        w, g = np.asarray(want[k], np.float64), got[k].double().numpy()
        assert g.shape == w.shape
        assert np.linalg.norm(g - w) / np.linalg.norm(w) <= REL_L2, k


@pytest.mark.parametrize("family", ["sd35", "qwen", "z-image", "nope"])
def test_from_components_of_unported_families_raises(family, tmp_path):
    """An unknown family raises JAX's ValueError.  "sd35", "z-image" and
    "qwen", once waiting, load what the JAX package loads (bit-equal to the
    bridge of its trees), encode as it does (qwen with an image: the edit
    conditioning through the vision tower), and the call equals
    `inpaint_image` on the loaded modules bit for bit."""
    kw = dict(family=family, model={}, vae={})
    if family == "nope":
        with pytest.raises(ValueError) as want:
            jpipeline.LanPaintPipeline.from_components(**kw)
        with pytest.raises(ValueError) as got:
            tpipeline.LanPaintPipeline.from_components(**kw)
        assert str(got.value) == str(want.value)
        return
    jpipe, tpipe = _components(family, tmp_path)
    want_family, want_encoders = {"sd35": ("sd3", ["clip_g", "clip_l", "t5"]),
                                  "z-image": ("qwen3", ["llama"]),
                                  "qwen": ("qwen", ["llama", "vision"])}[family]
    assert tpipe.family == jpipe.family == want_family
    assert sorted(tpipe.encoders) == sorted(jpipe.encoders) == want_encoders
    _assert_bridged(tpipe.model.module, jpipe.model.params)
    vae = tpipe.vae.module if family == "qwen" else tpipe.vae
    _assert_bridged(vae, jpipe.vae_params)
    for name, enc in tpipe.encoders.items():
        _assert_bridged(enc.module, jpipe.encoders[name].params)
        assert enc.device == torch.device("cpu")
    encodes = [dict()]
    if family == "qwen":
        source = np.random.default_rng(4).uniform(0, 1, (16, 24, 3)).astype(np.float32)
        encodes.append(dict(image=source, image_pad_id=QWEN_PAD_ID))
    for ek in encodes:
        with jax.default_matmul_precision("highest"):
            want = jpipe.encode("a corgi", **ek)
        _same_conds(tpipe.encode("a corgi", **ek), want)
    if family == "qwen":
        with pytest.raises(ValueError, match="with_vision"):
            tpipeline.LanPaintPipeline(tpipe.model, vae=tpipe.vae, family="qwen",
                                       encoders={"llama": tpipe.encoders["llama"]}).encode(
                "a corgi", image=source)

    img = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (1, 3, 16, 24))
                           .astype(np.float32))
    mask = torch.zeros((16, 24))
    mask[4:12, 6:18] = 1.0
    kw = dict(seed=2, steps=3, num_steps=2, cfg=1.0, scheduler="simple", blend_overlap=3)
    out = tpipe("a corgi", image=img, mask=mask, **kw)
    want = api.inpaint_image(tpipe.model, tpipe.vae, image=img, mask=mask,
                             positive=tpipe.encode("a corgi"), negative=tpipe.encode(""), **kw)
    assert out.shape == img.shape and bool(torch.isfinite(out).all())
    assert torch.equal(out, want)


@pytest.mark.parametrize("arg", ["clip_g", "llama", "llama_tokenizer", "with_vision",
                                 "clip_g_config", "llama_config", "vision_config"])
def test_from_components_refuses_the_arguments_of_unported_families(arg):
    """The arguments of the families once waiting, clip_g and clip_g_config
    (sd35), llama, llama_tokenizer, with_vision, llama_config and
    vision_config (qwen and z-image), are taken, keyword-only, with the JAX
    defaults."""
    import inspect

    got = inspect.signature(tpipeline.LanPaintPipeline.from_components).parameters[arg]
    want = inspect.signature(jpipeline.LanPaintPipeline.from_components).parameters[arg]
    assert got.kind == want.kind == inspect.Parameter.KEYWORD_ONLY
    assert got.default == want.default


@pytest.mark.parametrize("head_dim, want", [(None, []), (64, [(1, 1024, 1, 64)] * 3)])
def test_unet_self_attention_is_routed_by_shape(monkeypatch, head_dim, want):
    """The UNet's self-attention reaches an attention kernel only where the
    JAX package takes its TPU kernel (S >= 1024 and D % 64 == 0): never at
    SD1.x's fixed 8 heads (here D = 8 and 16; SD1.5's are 40, 80, 160),
    and at D = 64 in the three blocks of the 32x32 level (one down, two
    up), not at S = 256 or 64."""
    from lanpaint_tpu_torch.models import layers
    from lanpaint_tpu_torch.ops.attention import attention_ref

    seen = []

    def spy(q, k, v, scale=None):
        seen.append(tuple(q.shape))
        return attention_ref(q, k, v, scale)

    monkeypatch.setattr(layers, "flash_attention", spy)
    monkeypatch.setattr(layers, "wide_attention", spy)
    cfg = tunet.UNetConfig(model_channels=64, channel_mult=(1, 2), num_res_blocks=1,
                           transformer_depth=(1, 1), transformer_depth_middle=1, context_dim=8,
                           head_dim=head_dim, num_heads=8, dtype=torch.float32)
    with torch.device("meta"):
        module = tunet.UNetModel(cfg)
    module = module.to_empty(device="cpu")
    for p in module.parameters():
        torch.nn.init.normal_(p, std=0.02)
    with torch.no_grad():
        module(torch.zeros(1, 4, 32, 32), torch.full((1,), 500.0), torch.zeros(1, 5, 8))
    assert seen == want
