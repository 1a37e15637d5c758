"""The port's two-model wrappers (lanpaint_tpu_torch.models.zoo
`switching_denoiser` and `dual_model_denoiser`) and the pair bridge,
against the JAX package in fp32 on the CPU.

* The tiny Wan high/low-noise pair (seeds 0 and 1, one flax tree each,
  carried across by the bridge) through both packages' LanPaintSampler on
  the "simple" ladder of 4 (shift 5: 1.0, 0.9375, 0.833, 0.625, 0), which
  switches experts after step 1 at the Wan2.2 boundary 0.875, CFG 5
  batched, one explicit noise and think-noise feed: the samples and the
  denoised stack at rtol 1e-4 with atol 1e-4 * max|want| (as
  tests/test_torch_wan.py's sampler slice), and the routing: the sampler
  picks each call's expert from its host sigma (the pair's own `apply`,
  which reads t, is never called), high for steps 0-1, low for 2-3.
* The pair's `apply` on a given t against the JAX pair's: 1e-4; its
  per-expert cross k/v hoist gives the un-hoisted bits.
* `dual_model_denoiser` over two tiny UNets (seeds 3 and 4) through both
  packages' LanPaintSampler with sequential CFG and `model_select` in the
  negative cond: 1e-4 (max-relative as above); each model runs once per CFG
  pair; batched CFG raises ValueError in both packages.
* `bridge.pair_params_from_flax` maps every parameter of the JAX pair.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lanpaint_tpu as J
from lanpaint_tpu.models import zoo as jzoo
from lanpaint_tpu_torch import LanPaintConfig, LanPaintSampler
from lanpaint_tpu_torch.models import zoo as tzoo
from lanpaint_tpu_torch.models.bridge import (pair_params_from_flax, unet_params_from_flax,
                                              wan_params_from_flax)
from lanpaint_tpu_torch.sigmas import calculate_sigmas
from test_torch_solvers import one_thread  # noqa: F401
from test_torch_unet import _configs, _random_tree
from test_torch_wan import tiny_pair

SHAPE = (1, 4, 3, 8, 8)  # (B, C, F, H, W)


def _close(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def _counted(den, counts, key):
    apply = den.apply

    def counting(x, t, cond):
        counts[key] = counts.get(key, 0) + 1
        return apply(x, t, cond)

    den.apply = counting
    return den


@pytest.fixture(scope="module")
def wan_pair():
    """(JAX pair, port pair, {"high": tree, "low": tree}, forward counts)."""
    trees, jdens, tdens, counts = {}, {}, {}, {}
    for key, seed in (("high", 0), ("low", 1)):
        jcfg, tcfg, trees[key], _ = tiny_pair(seed=seed)
        jdens[key], _ = jzoo.build_wan(jcfg, trees[key])
        tden, _ = tzoo.build_wan(tcfg, wan_params_from_flax(trees[key]), device="cpu")
        tdens[key] = _counted(tden, counts, key)
    return (jzoo.switching_denoiser(jdens["high"], jdens["low"], boundary=0.875),
            tzoo.switching_denoiser(tdens["high"], tdens["low"], boundary=0.875), trees, counts)


def test_wan_pair_through_sampler_matches_jax(wan_pair):
    jpair, tpair, _, counts = wan_pair
    rng = np.random.default_rng(17)
    latent, noise = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2))
    mask = np.zeros(SHAPE[2:], np.float32)
    mask[1:, 2:6, 2:6] = 1.0
    ctx, unctx = (rng.standard_normal((1, 8, 32)).astype(np.float32) for _ in range(2))
    sigmas = calculate_sigmas(tpair.sigma_table, "simple", 4)
    np.testing.assert_allclose(sigmas, [1.0, 0.9375, 0.8333333, 0.625, 0.0], rtol=1e-6)
    feed = rng.standard_normal((4, 2, 5) + SHAPE).astype(np.float32)
    kw = dict(sampler_name="euler", cfg=5.0)

    with jax.default_matmul_precision("highest"):
        want, want_den = J.LanPaintSampler(jpair, config=J.LanPaintConfig(n_steps=2), **kw)(
            latent=jnp.asarray(latent), sigmas=sigmas, mask=jnp.asarray(mask),
            cond={"context": jnp.asarray(ctx)}, uncond={"context": jnp.asarray(unctx)},
            noise=jnp.asarray(noise), noise_feed=jnp.asarray(feed), video=True)

    def unrouted(x, t, cond):
        raise AssertionError("the sampler must route from its host sigma")

    counts.clear()
    sam = LanPaintSampler(tpair, config=LanPaintConfig(n_steps=2), **kw)
    tpair.apply, read_t = unrouted, tpair.apply
    try:
        got, got_den = sam(latent=torch.from_numpy(latent), sigmas=sigmas,
                           mask=torch.from_numpy(mask), cond={"context": torch.from_numpy(ctx)},
                           uncond={"context": torch.from_numpy(unctx)},
                           noise=torch.from_numpy(noise), noise_feed=torch.from_numpy(feed),
                           video=True)
    finally:
        tpair.apply = read_t
    # one batched CFG forward per model call: 3 a step (2 think + the final
    # denoise), 1 on the last (outer early stop); steps 0-1 have t >= 0.875
    assert counts == {"high": 6, "low": 4}
    _close(got_den, want_den)
    _close(got, want)


def test_wan_pair_apply_routes_like_jax(wan_pair):
    jpair, tpair, _, _ = wan_pair
    rng = np.random.default_rng(18)
    x = rng.standard_normal((2,) + SHAPE[1:]).astype(np.float32)
    ctx = rng.standard_normal((2, 8, 32)).astype(np.float32)
    for t, expert in ((0.9, "high"), (0.875, "high"), (0.7, "low")):
        tt = np.full((2,), t, np.float32)
        with jax.default_matmul_precision("highest"):
            want = jpair.apply(jnp.asarray(x), jnp.asarray(tt), {"context": jnp.asarray(ctx)})
        cond = {"context": torch.from_numpy(ctx)}
        got = tpair.apply(torch.from_numpy(x), torch.from_numpy(tt), cond)
        _close(got, want)
        assert tpair.route(t) is tpair.route(0.95 if expert == "high" else 0.1)
        hoisted = tpair.apply(torch.from_numpy(x), torch.from_numpy(tt), tpair.precompute(cond))
        assert torch.equal(got, hoisted)
    pre = tpair.precompute({"context": torch.from_numpy(ctx)})
    assert sorted(pre["experts"]) == ["high", "low"]
    assert all("kv_cache" in pre["experts"][k] for k in ("high", "low"))


def test_wan_pair_bridge_covers_every_parameter(wan_pair):
    _, tpair, trees, _ = wan_pair
    state = pair_params_from_flax(trees)
    want = tpair.module.state_dict()
    assert sorted(state) == sorted(want)
    for k, v in state.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert torch.equal(v, want[k]), k  # the pair was built from these trees
    assert len(state) == 2 * len(wan_params_from_flax(trees["high"]))


@pytest.fixture(scope="module")
def unet_pair():
    jcfg, tcfg = _configs("fp32")
    _, params = jzoo.build_unet(jcfg)
    jdens, tdens, counts = [], [], {}
    for key, seed in (("pos", 3), ("neg", 4)):
        tree = _random_tree(params, seed=seed)
        jdens.append(jzoo.build_unet(jcfg, tree)[0])
        tdens.append(_counted(tzoo.build_unet(tcfg, unet_params_from_flax(tree),
                                              device="cpu")[0], counts, key))
    return (jzoo.dual_model_denoiser(*jdens), tzoo.dual_model_denoiser(*tdens), counts)


def test_dual_model_denoiser_matches_jax(unet_pair):
    jdual, tdual, counts = unet_pair
    rng = np.random.default_rng(19)
    shape = (1, 4, 16, 16)
    latent, noise = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    mask = np.zeros(shape[2:], np.float32)
    mask[4:12, 3:11] = 1.0
    ctx, unctx = (rng.standard_normal((1, 8, 32)).astype(np.float32) for _ in range(2))
    sigmas = calculate_sigmas(tdual.sigma_table, "karras", 3)
    feed = rng.standard_normal((3, 2, 5) + shape).astype(np.float32)
    kw = dict(sampler_name="euler", cfg=4.0, sequential_cfg=True)

    with jax.default_matmul_precision("highest"):
        want = J.LanPaintSampler(jdual, config=J.LanPaintConfig(n_steps=2), **kw)(
            latent=jnp.asarray(latent), sigmas=sigmas, mask=jnp.asarray(mask),
            cond={"context": jnp.asarray(ctx)},
            uncond={"context": jnp.asarray(unctx), "model_select": jnp.ones(())},
            noise=jnp.asarray(noise), noise_feed=jnp.asarray(feed))
    counts.clear()
    got = LanPaintSampler(tdual, config=LanPaintConfig(n_steps=2), **kw)(
        latent=torch.from_numpy(latent), sigmas=sigmas, mask=torch.from_numpy(mask),
        cond={"context": torch.from_numpy(ctx)},
        uncond={"context": torch.from_numpy(unctx), "model_select": 1.0},
        noise=torch.from_numpy(noise), noise_feed=torch.from_numpy(feed))
    # 3 steps of 3 CFG pairs but the last (outer early stop): 7 pairs
    assert counts == {"pos": 7, "neg": 7}
    for g, w in zip(got, want):
        _close(g, w)


def test_dual_model_batched_cfg_raises_like_jax(unet_pair):
    jdual, tdual, _ = unet_pair
    x = np.zeros((1, 4, 16, 16), np.float32)
    ctx = np.zeros((1, 8, 32), np.float32)
    sigmas = np.asarray([2.0, 0.0], np.float32)
    with pytest.raises(ValueError):
        J.LanPaintSampler(jdual, cfg=4.0)(
            latent=jnp.asarray(x), sigmas=sigmas, cond={"context": jnp.asarray(ctx)},
            uncond={"context": jnp.asarray(ctx), "model_select": jnp.ones(())})
    with pytest.raises(ValueError, match="differ in their keys"):
        LanPaintSampler(tdual, cfg=4.0)(
            latent=torch.from_numpy(x), sigmas=sigmas, cond={"context": torch.from_numpy(ctx)},
            uncond={"context": torch.from_numpy(ctx), "model_select": 1.0})
