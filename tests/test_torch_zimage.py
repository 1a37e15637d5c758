"""The port's Z-Image S3-DiT (`lanpaint_tpu_torch/models/zimage.py`,
`zoo.build_zimage`, `load.import_zimage`) against the JAX package's.

The tiny config (GQA: 4 query heads over 2 k/v heads, one context- and one
noise-refiner block, two main layers) in fp32, weights from one flax tree
carried by `bridge.zimage_params_from_flax`, inputs from numpy; the JAX side
at "highest" matmul precision.  Tolerance: 1e-4 relative and 1e-4 of the
largest magnitude element (the MMDiT tests' fp32 forward tolerance); the
LanPaint slice through both packages' samplers within 1e-4 of the largest
value (tests/test_torch_api.py's).  The importer: bit-equal to the bridge
of the JAX import on a state drawn over tests/manifests.py's
`zimage_manifest`, and the full-size table consumes that manifest exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lanpaint_tpu as J
import manifests as M
from lanpaint_tpu.models import load as JL
from lanpaint_tpu.models import zimage as jz
from lanpaint_tpu.models import zoo as jzoo
from lanpaint_tpu_torch import LanPaintConfig, LanPaintSampler
from lanpaint_tpu_torch.models import bridge
from lanpaint_tpu_torch.models import load as TL
from lanpaint_tpu_torch.models import zimage as tz
from lanpaint_tpu_torch.models import zoo as tzoo
from lanpaint_tpu_torch.ops import norms
from lanpaint_tpu_torch.sigmas import calculate_sigmas
from test_torch_api import shared_normals  # noqa: F401  (a fixture)
from test_torch_textenc import random_tree

TOL = dict(rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(**kw):
    jcfg = dataclasses.replace(jz.TINY_ZIMAGE_CONFIG, dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(tz.TINY_ZIMAGE_CONFIG, dtype=torch.float32, **kw)
    return jcfg, tcfg


def _tree(jcfg, seed=0):
    return random_tree(jz.ZImageModel(jcfg), jnp.zeros((1, jcfg.in_channels, 8, 8)),
                       jnp.full((1,), 0.5), jnp.zeros((1, 5, jcfg.cap_dim)), seed=seed)


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = _configs()
    tree = _tree(jcfg)
    den, module = tzoo.build_zimage(tcfg, bridge.zimage_params_from_flax(tree), device="cpu")
    return jcfg, tree, den, module


def _close(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4 * np.abs(want).max(), **TOL)


@pytest.mark.parametrize("b, n_txt, side", [(1, 5, 8), (2, 7, 12)])
def test_zimage_forward_matches_jax(tiny, b, n_txt, side):
    jcfg, tree, _, module = tiny
    rng = np.random.default_rng(b + n_txt)
    x = rng.standard_normal((b, 4, side, side)).astype(np.float32)
    t = rng.uniform(0.05, 0.95, (b,)).astype(np.float32)
    ctx = rng.standard_normal((b, n_txt, jcfg.cap_dim)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jz.ZImageModel(jcfg).apply(tree, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        got = module(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert got.dtype == torch.float32
    _close(got, want)


def test_zimage_denoiser_matches_jax(tiny):
    """build_zimage's x0 = x - t * v, against the JAX Denoiser's."""
    jcfg, tree, den, _ = tiny
    jden, _ = jzoo.build_zimage(jcfg, tree)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((1, 6, jcfg.cap_dim)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jden.apply(jnp.asarray(x), jnp.asarray([0.6]), {"context": jnp.asarray(ctx)})
    got = den.apply(torch.from_numpy(x), torch.tensor([0.6]), {"context": torch.from_numpy(ctx)})
    _close(got, want)
    assert (den.name, den.latent_channels, den.is_flux) == (jden.name, jden.latent_channels,
                                                            jden.is_flux)
    assert den.sigma_table.shift == jden.sigma_table.shift == 3.0


def test_zimage_lanpaint_slice_matches_jax(tiny, shared_normals):  # noqa: F811
    """A 3-step LanPaint run (2 think steps, euler "simple", cfg 1 as the
    Z_image workflow) through both packages' samplers."""
    jcfg, tree, den, _ = tiny
    jden, _ = jzoo.build_zimage(jcfg, tree)
    rng = np.random.default_rng(4)
    latent = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((1, 5, jcfg.cap_dim)).astype(np.float32)
    mask = np.zeros((64, 64), np.float32)
    mask[16:48, 16:48] = 1.0
    sig = np.asarray(calculate_sigmas(den.sigma_table, "simple", 3), np.float32)
    kw = dict(sampler_name="euler", cfg=1.0)
    with jax.default_matmul_precision("highest"):
        want, _ = J.LanPaintSampler(jden, config=J.LanPaintConfig(n_steps=2), **kw)(
            latent=jnp.asarray(latent), sigmas=jnp.asarray(sig),
            cond={"context": jnp.asarray(ctx)}, mask=jnp.asarray(mask), seed=3)
    got, _ = LanPaintSampler(den, config=LanPaintConfig(n_steps=2), **kw)(
        latent=torch.from_numpy(latent), sigmas=sig, cond={"context": torch.from_numpy(ctx)},
        mask=torch.from_numpy(mask), seed=3)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_attention_routes_by_shape_with_kv_repeated(monkeypatch):
    """At D = 64 on a 64 x 64 latent (1,024 image tokens) the noise refiner
    (S = 1,024) and the main layers (S = n_txt + 1,024) reach the kernel's
    wrapper, with k/v already repeated to the query heads (GQA 2 -> 1); the
    context refiner's 6 text tokens stay plain, as JAX leaves them to XLA."""
    from lanpaint_tpu_torch.models import layers
    from lanpaint_tpu_torch.ops.attention import attention_ref

    seen = []

    def spy(q, k, v, scale=None):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape)))
        return attention_ref(q, k, v, scale)

    monkeypatch.setattr(layers, "flash_attention", spy)
    _, tcfg = _configs(hidden=128, num_heads=2, num_kv_heads=1, ffn_dim=64, axes_dim=(16, 24, 24))
    _, module = tzoo.build_zimage(tcfg, device="cpu", seed=1)
    with torch.no_grad():
        module(torch.randn(1, 4, 64, 64), torch.tensor([0.5]), torch.randn(1, 6, tcfg.cap_dim))
    refiner, main = (1, 1024, 2, 64), (1, 1030, 2, 64)
    assert seen == [(refiner,) * 3] + [(main,) * 3] * tcfg.depth


def test_strided_qk_views_collapse_for_the_row_norm():
    """At full width the q and k views of the fused qkv (row stride
    (30 + 2 * 30) * 128 = 11,520) are (S, 30) rows of 128 the row-norm
    kernel reads in place."""
    cfg = tz.Z_IMAGE_S3_CONFIG
    h, d, s = cfg.num_heads, cfg.head_dim, 4096 + 12
    width = (h + 2 * cfg.num_kv_heads) * d
    with torch.device("meta"):
        qkv = torch.empty((1, s, width))
    q = qkv[..., :h * d].unflatten(-1, (h, d))
    k = qkv[..., h * d:2 * h * d].unflatten(-1, (h, d))
    for view in (q, k):
        assert norms.row_geometry(view.shape, view.stride()) == (s, h, width, d)


def test_full_size_config_matches_jax():
    got = dataclasses.asdict(tz.Z_IMAGE_S3_CONFIG)
    want = dataclasses.asdict(jz.Z_IMAGE_S3_CONFIG)
    got.pop("dtype"), want.pop("dtype")
    assert want.pop("attention_impl") == "auto"  # the port routes by shape only
    assert got == want
    assert (tz.Z_IMAGE_S3_CONFIG.head_dim, tz.Z_IMAGE_S3_CONFIG.t_dim) == (128, 1024)


def test_full_size_tree_bridges_onto_the_module():
    cfg = jz.Z_IMAGE_S3_CONFIG
    shapes = jax.eval_shape(jz.ZImageModel(cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 8, 8)), jnp.full((1,), 0.5),
                            jnp.zeros((1, 4, cfg.cap_dim)))
    tree = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    got = {k: tuple(a.shape) for k, a in bridge.flax_entries(tree)}
    with torch.device("meta"):
        module = tz.ZImageModel(tz.Z_IMAGE_S3_CONFIG)
    assert got == {k: tuple(p.shape) for k, p in module.state_dict().items()}


def test_importer_consumes_the_full_size_manifest():
    man = M.zimage_manifest(jz.Z_IMAGE_S3_CONFIG)
    consumed, leftover, missing = TL.manifest_coverage(
        man, TL._zimage_entries(tz.Z_IMAGE_S3_CONFIG))
    assert not leftover and not missing and len(consumed) == len(man)


def test_import_of_a_manifest_state_equals_the_bridge_of_the_jax_import():
    """Every key of the tiny manifest, a distinct random tensor of its
    shape: the port's import is `bridge.params_from_flax` of the JAX
    import bit for bit, fills the module's state_dict exactly, and
    exports back to the state."""
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(8)
    state = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in sorted(M.zimage_manifest(jcfg).items())}
    want = bridge.params_from_flax(JL.import_zimage(state, jcfg))
    got = TL.import_zimage(state, tcfg)
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    with torch.device("meta"):
        module = tz.ZImageModel(tcfg)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in module.state_dict().items()}
    out = TL.export_zimage(got, tcfg)
    assert sorted(out) == sorted(state)
    for k, v in state.items():
        np.testing.assert_array_equal(out[k].numpy(), v, err_msg=k)


def test_builders_match_jax(monkeypatch):
    """build_tiny_zimage and build_z_image: the config, name and shift of
    the JAX package's."""
    calls = {}

    def spy(lib):
        def build(config=None, params=None, **kw):
            calls[lib] = (config, kw.get("name"), kw.get("shift", 3.0))
        return build

    monkeypatch.setattr(jzoo, "build_zimage", spy("jax"))
    monkeypatch.setattr(tzoo, "build_zimage", spy("torch"))
    for name in ("build_tiny_zimage", "build_z_image"):
        getattr(jzoo, name)()
        getattr(tzoo, name)()
        jcfg, jname, jshift = calls["jax"]
        tcfg, tname, tshift = calls["torch"]
        assert (tname, tshift) == (jname, jshift), name
        if jcfg is None:
            assert tcfg is None
        else:
            j, t = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
            assert {k: v for k, v in t.items() if k != "dtype"} == \
                {k: v for k, v in j.items() if k not in ("dtype", "attention_impl")}


def test_build_zimage_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tzoo.build_tiny_zimage()
