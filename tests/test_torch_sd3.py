"""The port's SD3 / SD3.5 MMDiT (`lanpaint_tpu_torch/models/sd3.py`,
`zoo.build_sd3` and its family builders, `load.import_sd3` /
`export_sd3`) against the JAX package's.

The tiny config (one dual-attention layer, one plain joint block, the
pre-only last block) and a variant without the q/k norm (SD3-Medium's)
run in fp32, weights from one flax tree carried by
`bridge.sd3_params_from_flax`, inputs from numpy, JAX at "highest" matmul
precision.  Tolerances:

* forward, fp32: 1e-4 relative and 1e-4 of the largest magnitude
  element (the MMDiT tests' fp32 forward tolerance); the Denoiser is
  x - t * v of that forward, bit for bit, with the JAX one's metadata;
* forward, bf16: the port's relative L2 error against JAX's fp32 at most
  twice JAX's own bf16 error, plus 1e-3 (the chip check's rule for the
  card against the CPU);
* a 4-step LanPaint run (2 think steps, euler "simple", sequential CFG 4.5)
  with one explicit noise and think-noise feed through both packages'
  samplers: 1e-4 of the largest value (tests/test_torch_api.py's);
* the importer: bit-equal to the bridge of the JAX import, on a state
  drawn over tests/manifests.py's `sd3_manifest`; the full-size tables
  consume that manifest exactly.
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
from lanpaint_tpu.models import sd3 as js
from lanpaint_tpu.models import zoo as jzoo
from lanpaint_tpu_torch import LanPaintConfig, LanPaintSampler
from lanpaint_tpu_torch.models import bridge
from lanpaint_tpu_torch.models import load as TL
from lanpaint_tpu_torch.models import sd3 as ts
from lanpaint_tpu_torch.models import zoo as tzoo
from lanpaint_tpu_torch.ops import norms
from lanpaint_tpu_torch.sigmas import calculate_sigmas
from test_torch_textenc import random_tree

TOL = dict(rtol=1e-4)
VARIANTS = {"tiny": {}, "no_qk_norm": dict(qk_norm=False, dual_attn_layers=())}
# Without the q/k norm the attention logits grow with the square of the
# weights' scale: at random_tree's 0.2 the softmax is nearly one-hot and
# either package's fp32 summation order moves the forward by ~1e-4, which a
# CFG 4.5 run then amplifies past any tolerance.  That variant's weights
# are drawn at 0.1 (logits a quarter as large).
SCALE = {"tiny": 0.2, "no_qk_norm": 0.1}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(dtype="fp32", **kw):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (dataclasses.replace(js.TINY_SD3_CONFIG, dtype=jdt, **kw),
            dataclasses.replace(ts.TINY_SD3_CONFIG, dtype=tdt, **kw))


def tree_of(jcfg, seed=0, scale=0.2):
    return random_tree(js.SD3MMDiT(jcfg), jnp.zeros((1, jcfg.in_channels, 8, 8)),
                       jnp.full((1,), 0.5), jnp.zeros((1, 3, jcfg.context_dim)),
                       jnp.zeros((1, jcfg.vec_dim)), seed=seed, scale=scale)


def close(got, want):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               atol=1e-4 * np.abs(want).max(), **TOL)


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def bf16_within_twice_jax(japply_fp32, japply_bf16, tmodule_bf16, tree, args):
    """(port bf16 error, JAX bf16 error), each relative L2 against JAX fp32
    on the same weights and inputs; asserts the rule."""
    jax_args = [None if a is None else jnp.asarray(a) for a in args]
    with jax.default_matmul_precision("highest"):
        want = np.asarray(japply_fp32(tree, *jax_args), np.float64)
        jax_bf16 = np.asarray(japply_bf16(tree, *jax_args), np.float32)
    with torch.no_grad():
        got = tmodule_bf16(*[None if a is None else torch.from_numpy(a) for a in args])
    port, plain = rel_l2(got.float().numpy(), want), rel_l2(jax_bf16, want)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert port <= 2 * plain + 1e-3, (port, plain)
    return port, plain


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def tiny(request):
    jcfg, tcfg = configs(**VARIANTS[request.param])
    tree = tree_of(jcfg, scale=SCALE[request.param])
    den, module = tzoo.build_sd3(tcfg, bridge.sd3_params_from_flax(tree), device="cpu")
    return jcfg, jax.jit(js.SD3MMDiT(jcfg).apply), tree, den, module


def _inputs(jcfg, b, n_ctx, hh, ww, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, jcfg.in_channels, hh, ww)).astype(np.float32),
            rng.uniform(0.05, 0.95, (b,)).astype(np.float32),
            rng.standard_normal((b, n_ctx, jcfg.context_dim)).astype(np.float32),
            rng.standard_normal((b, jcfg.vec_dim)).astype(np.float32))


@pytest.mark.parametrize("b, n_ctx, hh, ww", [(1, 5, 8, 8), (2, 7, 12, 16)])
def test_sd3_forward_matches_jax(tiny, b, n_ctx, hh, ww):
    """Square and oblong latents: the learned grid's centre crop moves."""
    jcfg, japply, tree, _, module = tiny
    args = _inputs(jcfg, b, n_ctx, hh, ww, seed=b + n_ctx)
    with jax.default_matmul_precision("highest"):
        want = japply(tree, *map(jnp.asarray, args))
    with torch.no_grad():
        got = module(*map(torch.from_numpy, args))
    assert got.dtype == torch.float32
    close(got, want)


def test_sd3_bf16_forward_is_as_close_as_jax_bf16(tiny):
    jcfg, japply, _, _, _ = tiny
    tree = tree_of(jcfg, seed=2, scale=SCALE["tiny"] if jcfg.qk_norm else SCALE["no_qk_norm"])
    _, module = tzoo.build_sd3(dataclasses.replace(configs("bf16")[1], qk_norm=jcfg.qk_norm,
                                                   dual_attn_layers=jcfg.dual_attn_layers),
                               bridge.sd3_params_from_flax(tree), device="cpu")
    jbf16 = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    bf16_within_twice_jax(japply, jax.jit(js.SD3MMDiT(jbf16).apply), module, tree,
                          _inputs(jcfg, 1, 5, 8, 8, seed=5))


def test_sd3_denoiser_is_x_minus_t_v(tiny):
    """build_sd3's x0 = x - t * v of the module (held to JAX above), and the
    JAX Denoiser's kind, name, channels and shift."""
    jcfg, _, tree, den, module = tiny
    jden, _ = jzoo.build_sd3(jcfg, tree)
    denoiser_is_x_minus_t_v(den, module, jden, _inputs(jcfg, 1, 6, 8, 8, seed=3),
                            ("context", "vec"), 3.0)


def denoiser_is_x_minus_t_v(den, module, jden, args, keys, shift, unsqueeze=False):
    """`den.apply(x, t, cond)`, cond the `keys` of args after (x, t), is
    x - t * module(*args) bit for bit (the module on x[:, :, None] where
    `unsqueeze`, squeezed back), and the Denoiser's metadata is the JAX
    one's."""
    x, t, *rest = (None if a is None else torch.from_numpy(a) for a in args)
    cond = {k: v for k, v in zip(keys, rest) if v is not None}
    got = den.apply(x, t, cond)
    xin = x[:, :, None] if unsqueeze else x
    with torch.no_grad():
        want = xin - t.reshape(-1, *[1] * (xin.ndim - 1)) * module(xin, t, *rest)
    assert torch.equal(got, want[:, :, 0] if unsqueeze else want)
    assert (den.kind.name, den.is_flux, den.latent_channels, den.name) == \
        (jden.kind.name, jden.is_flux, jden.latent_channels, jden.name)
    assert den.sigma_table.shift == jden.sigma_table.shift == shift


def lanpaint_run_matches_jax(jden, tden, latent_shape, cond, uncond=None, cfg=1.0,
                             sequential=False, seed=4):
    """A 4-step LanPaint run (2 think steps, euler "simple") of both
    Denoisers with one explicit noise and think-noise feed; the port's
    samples and denoised history within 1e-4 of the largest value."""
    rng = np.random.default_rng(seed)
    latent = rng.standard_normal(latent_shape).astype(np.float32)
    noise = rng.standard_normal(latent_shape).astype(np.float32)
    side = latent_shape[-2:]
    mask = np.zeros(side, np.float32)
    mask[side[0] // 4:3 * side[0] // 4, side[1] // 4:3 * side[1] // 4] = 1.0
    sigmas = calculate_sigmas(tden.sigma_table, "simple", 4)
    feed = rng.standard_normal((len(sigmas) - 1, 2, 5) + tuple(latent_shape)).astype(np.float32)
    kw = dict(sampler_name="euler", cfg=cfg, sequential_cfg=sequential)
    jc = lambda c: None if c is None else {k: jnp.asarray(v) for k, v in c.items()}  # noqa: E731
    tc = lambda c: None if c is None else {k: torch.from_numpy(v) for k, v in c.items()}  # noqa
    with jax.default_matmul_precision("highest"):
        want, want_den = J.LanPaintSampler(jden, config=J.LanPaintConfig(n_steps=2), **kw)(
            latent=jnp.asarray(latent), sigmas=jnp.asarray(sigmas), cond=jc(cond),
            uncond=jc(uncond), mask=jnp.asarray(mask), noise=jnp.asarray(noise),
            noise_feed=jnp.asarray(feed))
    got, got_den = LanPaintSampler(tden, config=LanPaintConfig(n_steps=2), **kw)(
        latent=torch.from_numpy(latent), sigmas=sigmas, cond=tc(cond), uncond=tc(uncond),
        mask=torch.from_numpy(mask), noise=torch.from_numpy(noise),
        noise_feed=torch.from_numpy(feed))
    for g, w in ((got, want), (got_den, want_den)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())
    assert np.abs(got.numpy() - latent)[..., mask > 0].mean() > 1e-2
    return got


def test_sd3_lanpaint_run_matches_jax():
    """Sequential CFG 4.5, as examples/sd35_inpaint.py sets it, on the tiny
    config (a dual-attention layer, the q/k norm)."""
    jcfg, tcfg = configs()
    tree = tree_of(jcfg, seed=1)
    den, _ = tzoo.build_sd3(tcfg, bridge.sd3_params_from_flax(tree), device="cpu")
    jden, _ = jzoo.build_sd3(jcfg, tree)
    rng = np.random.default_rng(6)
    conds = [{"context": rng.standard_normal((1, 5, jcfg.context_dim)).astype(np.float32),
              "vec": rng.standard_normal((1, jcfg.vec_dim)).astype(np.float32)}
             for _ in range(2)]
    lanpaint_run_matches_jax(jden, den, (1, 4, 8, 8), conds[0], conds[1], cfg=4.5,
                             sequential=True)


def test_attention_and_qk_norm_route_by_shape(monkeypatch):
    """At D = 64 on a 64 x 64 latent (1,024 image tokens) the joint
    attention (S = n_ctx + 1,024) and the dual attention (S = 1,024) reach
    the kernel's wrapper; every ln_q / ln_k goes through the row norm's
    wrapper on the strided view of the fused qkv, never a copy."""
    from lanpaint_tpu_torch.models import layers
    from lanpaint_tpu_torch.ops.attention import attention_ref

    seen, rows = [], []

    def spy(q, k, v, scale=None):
        seen.append(tuple(q.shape))
        return attention_ref(q, k, v, scale)

    rmsnorm = norms.rmsnorm

    def rms_spy(x, gamma=None, eps=1e-6):
        rows.append((tuple(x.shape), x.stride()))
        return rmsnorm(x, gamma, eps)

    monkeypatch.setattr(layers, "flash_attention", spy)
    monkeypatch.setattr(layers, "rmsnorm", rms_spy)
    _, tcfg = configs(hidden=128, num_heads=2, depth=3, pos_embed_max=64)
    _, module = tzoo.build_sd3(tcfg, device="cpu", seed=1)
    with torch.no_grad():
        module(torch.randn(1, 4, 64, 64), torch.tensor([0.5]), torch.randn(1, 6, 32),
               torch.randn(1, 16))
    joint, dual = (1, 1030, 2, 64), (1, 1024, 2, 64)
    assert seen == [joint, dual, joint, joint]
    # q and k of both streams (and attn2) in 3 blocks: views of row stride 3 * 128
    assert len(rows) == 2 * (2 * 3 + 1)
    assert all(stride[-3:] == (384, 64, 1) for _, stride in rows)


def test_strided_qk_views_collapse_for_the_row_norm():
    """At SD3.5-Large's width the q / k views of the fused qkv (row stride
    3 * 2,432 = 7,296) are (S, 38) rows of 64 the kernel reads in place."""
    cfg = ts.SD35_LARGE_CONFIG
    h, d, s = cfg.num_heads, cfg.head_dim, 4096 + 333
    with torch.device("meta"):
        qkv = torch.empty((1, s, 3 * cfg.hidden))
    for view in qkv.chunk(3, dim=-1)[:2]:
        view = view.unflatten(-1, (h, d))
        assert norms.row_geometry(view.shape, view.stride()) == (s, h, 7296, 64)


def test_pos_embed_crop_is_the_centre_of_the_grid():
    """A 1024^2 image's 64 x 64 grid of the 192 x 192 table at top = left
    = 64, and an oblong grid's crop, as the JAX module takes them."""
    with torch.device("meta"):
        meta = ts.SD3MMDiT(ts.SD35_LARGE_CONFIG)
    assert tuple(meta.pos_embed.shape) == (1, 192 * 192, 2432)
    _, tcfg = configs(pos_embed_max=10, hidden=8, num_heads=2)
    module = ts.SD3MMDiT(tcfg)
    with torch.no_grad():
        module.pos_embed.copy_(torch.arange(100 * 8, dtype=torch.float32).reshape(1, 100, 8))
    crop = module.cropped_pos_embed(4, 6)[0, :, 0] / 8
    want = [10 * r + c for r in range(3, 7) for c in range(2, 8)]
    assert crop.tolist() == want


@pytest.mark.parametrize("name", ["SD35_LARGE_CONFIG", "SD35_LARGE_TURBO_CONFIG",
                                  "SD35_MEDIUM_CONFIG", "SD3_MEDIUM_CONFIG", "TINY_SD3_CONFIG"])
def test_configs_match_jax(name):
    got, want = dataclasses.asdict(getattr(ts, name)), dataclasses.asdict(getattr(js, name))
    got.pop("dtype"), want.pop("dtype")
    assert want.pop("attention_impl") == "auto"  # the port routes by shape only
    assert got == want


@pytest.mark.parametrize("name", ["SD35_LARGE_CONFIG", "SD35_MEDIUM_CONFIG"])
def test_full_size_tree_bridges_onto_the_module(name):
    cfg = getattr(js, name)
    shapes = jax.eval_shape(js.SD3MMDiT(cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 8, 8)), jnp.full((1,), 0.5),
                            jnp.zeros((1, 4, cfg.context_dim)), jnp.zeros((1, cfg.vec_dim)))
    tree = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    got = {k: tuple(a.shape) for k, a in bridge.flax_entries(tree)}
    with torch.device("meta"):
        module = ts.SD3MMDiT(getattr(ts, name))
    assert got == {k: tuple(p.shape) for k, p in module.state_dict().items()}


@pytest.mark.parametrize("name", ["SD35_LARGE_CONFIG", "SD35_MEDIUM_CONFIG", "SD3_MEDIUM_CONFIG"])
def test_importer_consumes_the_full_size_manifest(name):
    man = M.sd3_manifest(getattr(js, name))
    keys = {k.replace(".ln_q.weight", ".ln_q.scale").replace(".ln_k.weight", ".ln_k.scale")
            for k in man}
    consumed, leftover, missing = TL.manifest_coverage(
        keys, TL._sd3_entries(getattr(ts, name)), "model.diffusion_model.")
    assert not leftover and not missing and len(consumed) == len(man)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_import_of_a_manifest_state_equals_the_bridge_of_the_jax_import(variant):
    """Every key of the tiny manifest a distinct random tensor of its
    shape: the port's import is `bridge.params_from_flax` of the JAX import
    bit for bit, fills the module's state_dict exactly, and exports back."""
    jcfg, tcfg = configs(**VARIANTS[variant])
    rng = np.random.default_rng(8)
    state = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in sorted(M.sd3_manifest(jcfg).items())}
    want = bridge.params_from_flax(JL.import_sd3(state, jcfg))
    got = TL.import_sd3(state, tcfg)
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    with torch.device("meta"):
        module = ts.SD3MMDiT(tcfg)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in module.state_dict().items()}
    out = TL.export_sd3(got, tcfg)
    assert sorted(out) == sorted(state)
    for k, v in state.items():
        np.testing.assert_array_equal(out[k].numpy(), v, err_msg=k)


def builders_match_jax(monkeypatch, jname, tname, names, default_shift):
    """Each JAX builder in `names` and the port's hand their generic builder
    the same config, name and shift."""
    calls = {}

    def spy(lib):
        def build(config=None, params=None, **kw):
            calls[lib] = (config, kw.get("name"), kw.get("shift", default_shift))
        return build

    monkeypatch.setattr(jzoo, jname, spy("jax"))
    monkeypatch.setattr(tzoo, tname, spy("torch"))
    for name in names:
        getattr(jzoo, name)()
        getattr(tzoo, name)()
        jcfg, jn, jshift = calls["jax"]
        tcfg, tn, tshift = calls["torch"]
        assert (tn, tshift) == (jn, jshift), name
        if jcfg is None:
            assert tcfg is None, name
        else:
            j, t = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
            assert {k: v for k, v in t.items() if k != "dtype"} == \
                {k: v for k, v in j.items() if k not in ("dtype", "attention_impl")}, name


def test_builders_match_jax(monkeypatch):
    builders_match_jax(monkeypatch, "build_sd3", "build_sd3",
                       ["build_sd35_large", "build_sd35_large_turbo", "build_sd35_medium",
                        "build_sd3_medium", "build_tiny_sd3"], 3.0)


def test_build_sd3_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tzoo.build_tiny_sd3()
