"""The port's Wan video DiT (lanpaint_tpu_torch.models.wan) against the flax
WanModel.

Weights come from one flax parameter tree carried across by
`models.bridge.wan_params_from_flax`; inputs from numpy.  Both sides run on
the CPU, where JAX's attention and row norms take their plain references
and the port's wrappers take theirs.

Tolerances:
* `_WanQKNorm` in fp32: 1e-6 (the same fp32 formula; mean against sum / dim
  differ by an ulp);
* the tiny WanModel forward in fp32: 1e-4 (GEMMs summed in different
  orders), with and without the precomputed cross-attention k/v;
* the hoisted and the in-forward cross k/v within the port: bit-identical
  (the same submodules compute both);
* `video_ids`: exact;
* the sampler slice: 1e-4 relative to the largest value of each compared
  tensor, as tests/test_torch_dit.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanpaint_tpu import LanPaintConfig as JConfig
from lanpaint_tpu import LanPaintSampler as JSampler
from lanpaint_tpu.models import wan as jwan
from lanpaint_tpu.models import zoo as jzoo
from lanpaint_tpu_torch import LanPaintConfig, LanPaintSampler
from lanpaint_tpu_torch.models import wan as twan
from lanpaint_tpu_torch.models import zoo as tzoo
from lanpaint_tpu_torch.models.bridge import flax_entries, wan_params_from_flax
from lanpaint_tpu_torch.sigmas import calculate_sigmas
from test_torch_dit import _random_tree

SHAPE = (2, 4, 3, 8, 8)  # (B, C, F, H, W): 3 * 4 * 4 = 48 tokens


def _flax_shapes(jcfg, b=1, n_ctx=8):
    x = jnp.zeros((b, jcfg.in_channels, 3, 8, 8), jnp.float32)
    ctx = jnp.zeros((b, n_ctx, jcfg.context_dim), jnp.float32)
    return jax.eval_shape(jwan.WanModel(jcfg).init, jax.random.PRNGKey(0), x,
                          jnp.full((b,), 0.5), ctx)


def tiny_pair(seed=7):
    """(flax config, flax tree, port module), fp32, one set of weights."""
    jcfg = dataclasses.replace(jwan.TINY_WAN_CONFIG, dtype=jnp.float32)
    tcfg = dataclasses.replace(twan.TINY_WAN_CONFIG, dtype=torch.float32)
    tree = _random_tree(_flax_shapes(jcfg), seed)
    module = twan.WanModel(tcfg)
    module.load_state_dict(wan_params_from_flax(tree))
    return jcfg, tcfg, tree, module.eval()


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(SHAPE).astype(np.float32),
            rng.uniform(0.05, 0.95, (SHAPE[0],)).astype(np.float32),
            rng.standard_normal((SHAPE[0], 8, 32)).astype(np.float32))


def test_wan_qk_norm_matches_jax():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 24, 64)) * 1.7 + 0.4).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    want = jwan._WanQKNorm(64, None, 1).apply({"params": {"scale": scale}}, jnp.asarray(x))
    norm = twan._WanQKNorm(64)
    norm.load_state_dict({"weight": torch.from_numpy(scale)})
    with torch.no_grad():
        got = norm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_video_ids_match_jax():
    for b, f, h, w, off in ((1, 3, 4, 5, 0), (2, 2, 3, 3, 4)):
        want = np.asarray(jwan.video_ids(b, f, h, w, frame_offset=off))
        got = twan.video_ids(b, f, h, w, frame_offset=off).numpy()
        np.testing.assert_array_equal(got, want)


def test_wan_forward_matches_flax():
    jcfg, _, tree, module = tiny_pair()
    x, t, ctx = _inputs()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jwan.WanModel(jcfg).apply(tree, jnp.asarray(x), jnp.asarray(t),
                                                    jnp.asarray(ctx)))
        kv = jwan.WanKVPrecompute(jcfg).apply(tree, jnp.asarray(ctx))
        want_kv = np.asarray(jwan.WanModel(jcfg).apply(tree, jnp.asarray(x), jnp.asarray(t),
                                                       jnp.asarray(ctx), kv_cache=kv))
    with torch.no_grad():
        got = module(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
        cache = module.precompute_kv(torch.from_numpy(ctx))
        got_kv = module(torch.from_numpy(x), torch.from_numpy(t), None, kv_cache=cache)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_kv.numpy(), want_kv, rtol=1e-4, atol=1e-4)
    for key in ("k", "v"):
        assert tuple(cache[key].shape) == kv[key].shape == (2, 2, 8, 64)
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(kv[key]), rtol=1e-4,
                                   atol=1e-4)
    # within the port the hoist changes nothing, bit for bit
    assert torch.equal(got, got_kv)


def test_wan_hoisted_cross_kv_is_bit_identical_in_bf16():
    """In the production dtypes (bf16 compute, bf16 residual modulation) the
    precomputed cross k/v give the forward's own bits."""
    _, _, tree, _ = tiny_pair(seed=8)
    cfg = dataclasses.replace(twan.TINY_WAN_CONFIG, residual_dtype=torch.bfloat16)
    module = twan.WanModel(cfg).eval()
    module.load_state_dict(wan_params_from_flax(tree))
    x, t, ctx = (torch.from_numpy(a) for a in _inputs(4))
    with torch.no_grad():
        plain = module(x, t, ctx)
        hoisted = module(x, t, ctx, kv_cache=module.precompute_kv(ctx))
    assert plain.dtype == torch.float32 and torch.equal(plain, hoisted)


def test_wan_bridge_covers_every_parameter():
    _, tcfg, tree, _ = tiny_pair()
    state = wan_params_from_flax(tree)
    want = twan.WanModel(tcfg).state_dict()
    assert sorted(state) == sorted(want)
    for k, v in state.items():
        assert tuple(v.shape) == tuple(want[k].shape), k


def test_ti2v_5b_bridge_maps_every_key_without_allocating():
    shapes = _flax_shapes(jwan.WAN22_TI2V_5B_CONFIG, n_ctx=4)
    tree = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    keys, shape_of = [], {}
    for key, arr in flax_entries(tree):
        keys.append(key)
        shape_of[key] = tuple(arr.shape)
    with torch.device("meta"):
        module = twan.WanModel(twan.WAN22_TI2V_5B_CONFIG)
    assert len(keys) == len(set(keys))
    assert shape_of == {k: tuple(p.shape) for k, p in module.state_dict().items()}
    n_port = sum(p.numel() for p in module.parameters())
    assert 4.9e9 < n_port < 5.1e9, n_port


@pytest.mark.parametrize("field", [dict(seq_axis="seq"), dict(tp_axis="tp", tp_size=2),
                                   dict(tp_size=2)], ids=["seq_axis", "tp_axis", "tp_size"])
def test_parallel_axes_are_not_ported(field, tmp_path):
    """The parallel axes, once refused (ROADMAP A.19), build and match JAX.
    A mesh axis runs over two spawned gloo ranks on a mesh of its own name
    (tests/test_torch_parallel.py), the frames or the weights split between
    them, against JAX's one-device forward; tp_size alone (no axis: half the
    heads and ffn width, no reduce) against JAX's WanModel of the same
    config, in this process."""
    from test_torch_parallel import _axes_ranks, run_ranks

    jcfg, tcfg, tree, _ = tiny_pair()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 4, 8, 8)).astype(np.float32)  # 4 frames over 2 ranks
    t = rng.uniform(0.05, 0.95, (2,)).astype(np.float32)
    ctx = rng.standard_normal((2, 8, 32)).astype(np.float32)
    if "tp_axis" not in field and "seq_axis" not in field:
        jcfg = dataclasses.replace(jcfg, **field)
        tree = _random_tree(_flax_shapes(jcfg), 7)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jwan.WanModel(jcfg).apply(tree, jnp.asarray(x), jnp.asarray(t),
                                                    jnp.asarray(ctx)))
    state = wan_params_from_flax(tree)
    if "tp_axis" in field or "seq_axis" in field:
        outs = [o.numpy() for o in run_ranks(tmp_path, 2, _axes_ranks, field, state,
                                              *(torch.from_numpy(a) for a in (x, t, ctx)))]
        np.testing.assert_array_equal(outs[0], outs[1])
        got = outs[0]
    else:
        module = twan.WanModel(dataclasses.replace(tcfg, **field)).eval()
        module.load_state_dict(state)
        assert tuple(module.blocks[0].self_attn.q.weight.shape) == (32, 64)
        with torch.no_grad():
            got = module(*(torch.from_numpy(a) for a in (x, t, ctx))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_wan_configs_match_jax():
    """The configurations are data: every field equals the JAX package's
    (the dtypes as their torch names, the JAX-only `attention_impl` aside)."""
    names = [n for n in dir(jwan) if n.endswith("_CONFIG")]
    assert names and sorted(names) == sorted(n for n in dir(twan) if n.endswith("_CONFIG"))
    dtypes = {None: None, jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    for name in names:
        jc, tc = dataclasses.asdict(getattr(jwan, name)), dataclasses.asdict(getattr(twan, name))
        jc.pop("attention_impl")
        for key in ("dtype", "residual_dtype"):
            assert dtypes[jc.pop(key)] == tc.pop(key), (name, key)
        assert jc == tc, name


def test_wan_slice_through_sampler_matches_jax():
    """The tiny Wan -> the flow-matching think loop (2 steps) -> euler over
    the "simple" ladder of 4 at CFG 5 (batched cond + uncond, the
    precomputed cross k/v concatenated per branch), a 5D video latent and
    a (T, H, W) mask, one shared explicit noise and think-noise feed,
    through both packages' LanPaintSampler in fp32."""
    jcfg, tcfg, tree, _ = tiny_pair(seed=9)
    jden, _ = jzoo.build_wan(jcfg, tree)
    tden, _ = tzoo.build_wan(tcfg, wan_params_from_flax(tree), device="cpu")
    rng = np.random.default_rng(13)
    shape = (1,) + SHAPE[1:]
    latent = rng.standard_normal(shape).astype(np.float32)
    noise = rng.standard_normal(shape).astype(np.float32)
    mask = np.zeros(shape[2:], np.float32)
    mask[1:, 2:6, 2:6] = 1.0
    ctx, unctx = (rng.standard_normal((1, 8, 32)).astype(np.float32) for _ in range(2))
    sigmas = calculate_sigmas(tden.sigma_table, "simple", 4)
    feed = rng.standard_normal((len(sigmas) - 1, 2, 5) + shape).astype(np.float32)
    kw = dict(sampler_name="euler", cfg=5.0)

    with jax.default_matmul_precision("highest"):
        j_samples, j_den = JSampler(jden, config=JConfig(n_steps=2), **kw)(
            latent=jnp.asarray(latent), sigmas=sigmas, mask=jnp.asarray(mask),
            cond={"context": jnp.asarray(ctx)}, uncond={"context": jnp.asarray(unctx)},
            noise=jnp.asarray(noise), noise_feed=jnp.asarray(feed), video=True)
    t_samples, t_den = LanPaintSampler(tden, config=LanPaintConfig(n_steps=2), **kw)(
        latent=torch.from_numpy(latent), sigmas=sigmas, mask=torch.from_numpy(mask),
        cond={"context": torch.from_numpy(ctx)}, uncond={"context": torch.from_numpy(unctx)},
        noise=torch.from_numpy(noise), noise_feed=torch.from_numpy(feed), video=True)

    assert t_den.shape == (len(sigmas) - 1,) + shape
    for got, want in ((t_den.numpy(), np.asarray(j_den)),
                      (t_samples.numpy(), np.asarray(j_samples))):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    known = np.broadcast_to(mask == 0, shape)
    np.testing.assert_allclose(t_samples.numpy()[known], latent[known], atol=1e-5)
    assert np.abs(t_samples.numpy()[~known] - latent[~known]).mean() > 1e-2


def test_build_wan_precompute_hook():
    """build_wan's precompute adds every block's cross k/v to a dict cond
    (batch-major) and leaves anything else alone; apply gives the same x0
    with and without it."""
    _, tcfg, tree, _ = tiny_pair(seed=5)
    den, module = tzoo.build_wan(tcfg, wan_params_from_flax(tree), device="cpu")
    assert den.latent_channels == 4 and den.sigma_table.shift == 5.0
    x, t, ctx = (torch.from_numpy(a) for a in _inputs(6))
    cond = den.precompute({"context": ctx})
    assert tuple(cond["kv_cache"]["k"].shape) == (2, tcfg.depth, 8, tcfg.hidden)
    assert den.precompute(ctx) is ctx
    assert torch.equal(den.apply(x, t, cond), den.apply(x, t, {"context": ctx}))
