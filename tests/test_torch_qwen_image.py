"""Qwen-Image and Qwen-Image-Edit in the port against the JAX package: the
MMDiT at Qwen-Image's topology (double blocks only, `txt_norm`, no pooled
vector) with reference tokens, the Wan2.1-graph VAE as a one-frame image
VAE (`pipeline._SingleFrameVAE`), the diffusers-layout importer and
exporter, the stand-in families' builders and census guard, and
`api.edit_image`.

Tiny configs in fp32, weights from flax trees carried by models/bridge.py,
inputs from numpy, the JAX side at "highest" matmul precision.
Tolerances: the forward and the VAE 1e-4 relative and 1e-4 of the largest
magnitude element (the MMDiT tests'); `edit_image` through both packages'
samplers (their normals shared by test_torch_api's `shared_normals`) 1e-4
of the image's largest value (tests/test_torch_pixel.py's); the importer
bit-equal to the bridge of the JAX import, its keys those of
tests/manifests.py's `qwen_manifest`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lanpaint_tpu as J
import manifests as M
from lanpaint_tpu import pipeline as jpipeline
from lanpaint_tpu.models import dit as jdit
from lanpaint_tpu.models import load as JL
from lanpaint_tpu.models import video_vae as jvv
from lanpaint_tpu.models import zoo as jzoo
from lanpaint_tpu_torch import api as tapi
from lanpaint_tpu_torch import pipeline as tpipeline
from lanpaint_tpu_torch.models import bridge
from lanpaint_tpu_torch.models import dit as tdit
from lanpaint_tpu_torch.models import load as TL
from lanpaint_tpu_torch.models import video_vae as tvv
from lanpaint_tpu_torch.models import zoo as tzoo
from test_torch_api import shared_normals  # noqa: F401  (a fixture)
from test_torch_textenc import random_tree

QWEN_TINY = dict(depth_single=0, txt_norm=True, vec_dim=0, guidance_embed=False)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def _dit_configs():
    jcfg = dataclasses.replace(jdit.TINY_DIT_CONFIG, dtype=jnp.float32, **QWEN_TINY)
    tcfg = dataclasses.replace(tdit.TINY_DIT_CONFIG, dtype=torch.float32, **QWEN_TINY)
    return jcfg, tcfg


def _dit_tree(jcfg, seed=1):
    return random_tree(jdit.MMDiT(jcfg), jnp.zeros((1, jcfg.latent_channels, 8, 8)),
                       jnp.full((1,), 0.5), jnp.zeros((1, 4, jcfg.context_dim)), seed=seed)


def _vae_configs():
    return (dataclasses.replace(jvv.TINY_WAN_VAE_CONFIG, dtype=jnp.float32),
            dataclasses.replace(tvv.TINY_WAN_VAE_CONFIG, dtype=torch.float32))


@pytest.fixture(scope="module")
def models():
    """(JAX Denoiser, JAX one-frame VAE, its tree, port Denoiser, port VAE)."""
    jcfg, tcfg = _dit_configs()
    tree = _dit_tree(jcfg)
    jden, _ = jzoo.build_dit(jcfg, tree, shift=2.2, is_flux=False, name="qwen-image")
    tden, _ = tzoo.build_dit(tcfg, bridge.dit_params_from_flax(tree), shift=2.2, is_flux=False,
                             name="qwen-image", device="cpu")
    jvcfg, tvcfg = _vae_configs()
    vtree = random_tree(jvv.WanVAE(jvcfg), jnp.zeros((1, 3, 1, 16, 16)), seed=2, scale=0.1)
    jvae = jpipeline._SingleFrameVAE(jvv.WanVAE(jvcfg))
    tvae = tpipeline._SingleFrameVAE(
        tzoo.build_wan_vae(tvcfg, bridge.wan_vae_params_from_flax(vtree), device="cpu"))
    return jden, jvae, vtree, tden, tvae


@pytest.mark.parametrize("n_ref", [0, 24, 30])
def test_qwen_mmdit_without_single_blocks_matches_jax(n_ref):
    """depth_single = 0, txt_norm, no vector input; reference tokens as
    many as the image's (24) or more (30: their RoPE grid wraps)."""
    jcfg, tcfg = _dit_configs()
    tree = _dit_tree(jcfg, seed=3)
    module = tdit.MMDiT(tcfg)
    module.load_state_dict(bridge.dit_params_from_flax(tree))
    assert len(module._modules["single"]) == 0
    rng = np.random.default_rng(n_ref)
    x = rng.standard_normal((2, 4, 8, 12)).astype(np.float32)
    t = rng.uniform(0.05, 0.95, (2,)).astype(np.float32)
    ctx = (rng.standard_normal((2, 9, jcfg.context_dim)) * 3.0).astype(np.float32)
    ref = rng.standard_normal((2, n_ref, 16)).astype(np.float32) if n_ref else None
    with jax.default_matmul_precision("highest"):
        want = jdit.MMDiT(jcfg).apply(tree, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                                      None, None, None if ref is None else jnp.asarray(ref))
    with torch.no_grad():
        got = module(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), None,
                     None, None if ref is None else torch.from_numpy(ref))
    _close(got, want)


def test_single_frame_vae_matches_jax(models):
    """The Wan2.1-graph VAE at T = 1 (k = 0 of the 1+4k law: one frame
    through the causal time pad and the upsampler's frame interleave),
    encode and decode, and the same as the 3D VAE on a one-frame video."""
    _, jvae, vtree, _, tvae = models
    image = np.tanh(np.random.default_rng(5).standard_normal((1, 3, 16, 24))).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        jlat = jvae.apply(vtree, jnp.asarray(image), method="encode")
        jout = jvae.apply(vtree, jlat, method="decode")
    with torch.no_grad():
        lat = tvae.encode(torch.from_numpy(image))
        out = tvae.decode(torch.from_numpy(np.array(jlat)))
        video_lat = tvae.module.encode(torch.from_numpy(image)[:, :, None])
    assert tuple(lat.shape) == (1, 4, 8, 12) and tuple(out.shape) == image.shape
    _close(lat, jlat)
    _close(out, jout)
    assert torch.equal(video_lat[:, :, 0], lat)
    assert [p.data_ptr() for p in tvae.parameters()] == \
        [p.data_ptr() for p in tvae.module.parameters()]


def test_edit_image_matches_jax(models, shared_normals):  # noqa: F811
    """The source image as packed reference latents on both conds, then the
    pixel inpaint: euler "simple", 3 steps x 2 think steps, CFG 4 as two
    sequential passes, blend 3."""
    jden, jvae, vtree, tden, tvae = models
    rng = np.random.default_rng(6)
    image = np.tanh(rng.standard_normal((1, 3, 16, 24))).astype(np.float32)
    mask = np.zeros((16, 24), np.float32)
    mask[4:12, 6:18] = 1.0
    ctx = rng.standard_normal((2, 1, 7, 32)).astype(np.float32)
    kw = dict(seed=2, steps=3, cfg=4.0, scheduler="simple", num_steps=2, sequential_cfg=True,
              blend_overlap=3)
    with jax.default_matmul_precision("highest"):
        want = J.edit_image(jden, jvae, vtree, image=jnp.asarray(image), mask=jnp.asarray(mask),
                            positive={"context": jnp.asarray(ctx[0])},
                            negative={"context": jnp.asarray(ctx[1])}, **kw)
    got = tapi.edit_image(tden, tvae, image=torch.from_numpy(image), mask=torch.from_numpy(mask),
                          positive={"context": torch.from_numpy(ctx[0])},
                          negative={"context": torch.from_numpy(ctx[1])}, **kw)
    assert bool(torch.isfinite(got).all())
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    far = np.ones((16, 24), bool)
    far[1:15, 3:21] = False
    np.testing.assert_array_equal(got.numpy()[..., far], image[..., far])


def test_edit_image_adds_ref_tokens_only_where_missing(models, monkeypatch):
    _, _, _, tden, tvae = models
    seen = {}

    def fake_inpaint(model, vae, *, image, mask, positive, negative, **kw):
        seen.update(positive=positive, negative=negative)
        return image

    monkeypatch.setattr(tapi, "inpaint_image", fake_inpaint)
    image = torch.zeros((1, 3, 16, 24))
    own = torch.ones((1, 5, 16))
    tapi.edit_image(tden, tvae, image=image, mask=torch.zeros((16, 24)),
                    positive={"context": torch.zeros(1, 3, 32), "ref_tokens": own},
                    negative=None)
    assert seen["positive"]["ref_tokens"] is own and seen["negative"] is None
    tapi.edit_image(tden, tvae, image=image, mask=torch.zeros((16, 24)),
                    positive={"context": torch.zeros(1, 3, 32)}, negative={"context": None})
    ref = tdit.pack_latent(tvae.encode(image), 2)
    for k in ("positive", "negative"):
        assert torch.equal(seen[k]["ref_tokens"], ref)


def _qwen_state(jcfg, seed=4):
    return {k: np.asarray(v) for k, v in JL.export_qwen(_dit_tree(jcfg, seed), jcfg).items()}


def test_import_qwen_equals_the_bridge_of_the_jax_import():
    jcfg, tcfg = _dit_configs()
    state = _qwen_state(jcfg)
    assert sorted(state) == sorted(M.qwen_manifest(jcfg))
    for k, shape in M.qwen_manifest(jcfg).items():
        assert state[k].shape == shape, k
    want = bridge.params_from_flax(JL.import_qwen(state, jcfg))
    got = TL.import_qwen(state, tcfg)
    assert sorted(got) == sorted(want)
    assert all(got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]) for k in want)
    with torch.device("meta"):
        module = tdit.MMDiT(tcfg)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in module.state_dict().items()}
    # import_mmdit_auto takes the diffusers layout here, the Flux one there
    # (whose table, as the JAX package's, has no txt_norm row)
    auto = TL.import_mmdit_auto(state, tcfg)
    assert sorted(auto) == sorted(got) and all(torch.equal(auto[k], got[k]) for k in got)
    flux_layout = {k: v.numpy() for k, v in TL.export_dit(got, tcfg).items()}
    auto = TL.import_mmdit_auto(flux_layout, tcfg)
    want = bridge.params_from_flax(JL.import_mmdit_auto(flux_layout, jcfg))
    assert sorted(auto) == sorted(want) and all(torch.equal(auto[k], want[k]) for k in want)
    assert sorted(want) == sorted(k for k in got if k != "txt_norm.weight")


def test_export_qwen_is_the_jax_export():
    jcfg, tcfg = _dit_configs()
    state = _qwen_state(jcfg, seed=5)
    out = TL.export_qwen(TL.import_qwen(state, tcfg), tcfg)
    assert sorted(out) == sorted(state)
    for k, v in state.items():
        np.testing.assert_array_equal(out[k].numpy(), v, err_msg=k)


def test_qwen_key_census_matches_the_manifest():
    from lanpaint_tpu.models.dit import QWEN_IMAGE_CONFIG

    want = set(M.qwen_manifest(QWEN_IMAGE_CONFIG))
    assert TL.qwen_expected_keys(tdit.QWEN_IMAGE_CONFIG) == want
    assert TL.qwen_expected_keys(tdit.QWEN_IMAGE_CONFIG, "m.") == {"m." + k for k in want}
    assert tzoo.family_expected_keys("qwen") == want


@pytest.mark.parametrize("case", ["match", "missing", "leftover"])
def test_import_dit_guarded_matches_jax(case):
    jcfg = dataclasses.replace(jdit.TINY_DIT_CONFIG, dtype=jnp.float32)
    tcfg = dataclasses.replace(tdit.TINY_DIT_CONFIG, dtype=torch.float32)
    tree = random_tree(jdit.MMDiT(jcfg), jnp.zeros((1, 4, 8, 8)), jnp.full((1,), 0.5),
                       jnp.zeros((1, 4, jcfg.context_dim)), jnp.zeros((1, jcfg.vec_dim)),
                       seed=6)
    state = {k: np.asarray(v) for k, v in JL.export_dit(tree, jcfg).items()}
    if case == "missing":
        state.pop("img_in.weight")
    elif case == "leftover":
        state["extra.weight"] = np.zeros(1, np.float32)
    if case == "match":
        got = TL.import_dit_guarded(state, tcfg, "krea2")
        want = bridge.params_from_flax(JL.import_dit_guarded(state, jcfg, "krea2"))
        assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)
        return
    with pytest.raises(ValueError) as want:
        JL.import_dit_guarded(state, jcfg, "krea2")
    with pytest.raises(ValueError) as got:
        TL.import_dit_guarded(state, tcfg, "krea2")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["build_qwen_image", "build_flux2_dev", "build_flux2_klein",
                                  "build_krea2", "build_anima"])
def test_dit_family_builders_match_jax(monkeypatch, name):
    """Each builder hands build_dit the JAX builder's config, shift, flux
    flag and name (the full-size models are not built here)."""
    calls = {}

    def spy(lib):
        def build(config, params=None, **kw):
            calls[lib] = (config, kw)
        return build

    monkeypatch.setattr(jzoo, "build_dit", spy("jax"))
    monkeypatch.setattr(tzoo, "build_dit", spy("torch"))
    getattr(jzoo, name)()
    getattr(tzoo, name)()
    (jcfg, jkw), (tcfg, tkw) = calls["jax"], calls["torch"]
    assert tkw == jkw
    j, t = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
    j.pop("dtype"), t.pop("dtype"), j.pop("attention_impl", None)
    assert t == j


def test_qwen_image_config_matches_jax():
    j = dataclasses.asdict(jdit.QWEN_IMAGE_CONFIG)
    t = dataclasses.asdict(tdit.QWEN_IMAGE_CONFIG)
    j.pop("dtype"), t.pop("dtype"), j.pop("attention_impl", None)
    assert t == j
