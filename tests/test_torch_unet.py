"""The port's SD UNet (lanpaint_tpu_torch.models) against the flax UNet.

Weights come from one flax parameter tree carried across by
`models.bridge.unet_params_from_flax`; inputs from numpy.  Both sides run
on the CPU, where JAX's attention and row norms take their plain
references and the port's wrappers take theirs.

Tolerances:
* fp32 compute: 1e-4 (the two frameworks sum convolutions and GEMMs in
  different orders; measured max error 3e-6 on outputs of size ~2);
* bf16 compute: relative L2 error 2e-2 against the flax forward in fp32.
  Not elementwise against flax in bf16: the two bf16 programs round at
  different points (flax's Dense adds its bias after rounding the product,
  torch's addmm before; JAX rounds the softmax to bf16 before P @ V), and
  on this net each lies ~1.7e-2 (relative L2) from the fp32 forward and
  up to 4e-2 (absolute) from the other;
* the sampler slice: 1e-4 relative to the largest value of each compared
  tensor.  The random eps-UNet predicts x0 = x - sigma * eps with sigma up
  to 14.6, so the history reaches ~100 and fp32 rounding moves small
  entries by ~5e-4 absolute (5e-6 of the scale).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanpaint_tpu import LanPaintConfig as JConfig
from lanpaint_tpu import LanPaintSampler as JSampler
from lanpaint_tpu.models import unet as junet
from lanpaint_tpu.models import zoo as jzoo
from lanpaint_tpu_torch import LanPaintConfig, LanPaintSampler
from lanpaint_tpu_torch.models import unet as tunet
from lanpaint_tpu_torch.models import zoo as tzoo
from lanpaint_tpu_torch.models.bridge import unet_params_from_flax
from lanpaint_tpu_torch.sigmas import EpsSigmaTable, calculate_sigmas


def _random_tree(tree, seed):
    """Well-conditioned random weights in the flax tree's shapes: kernels
    N(0, 1/fan_in), biases N(0, 0.1^2), norm scales 1 + N(0, 0.1^2), so
    every layer moves the output (the N(0, 0.02^2) bench init barely does)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        shape = np.shape(a)
        if name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "bias":
            v = 0.1 * rng.standard_normal(shape)
        else:
            fan_in = int(np.prod(shape[:3])) if len(shape) == 4 else shape[-2]
            v = rng.standard_normal(shape) / np.sqrt(fan_in)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _configs(dtype):
    jcfg = dataclasses.replace(junet.TINY_UNET_CONFIG,
                               dtype=jnp.float32 if dtype == "fp32" else jnp.bfloat16)
    tcfg = dataclasses.replace(tunet.TINY_UNET_CONFIG,
                               dtype=torch.float32 if dtype == "fp32" else torch.bfloat16)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def tiny_tree():
    jden, params = jzoo.build_unet(junet.TINY_UNET_CONFIG)
    return _random_tree(params, seed=7)


def _models(tree, dtype):
    jcfg, tcfg = _configs(dtype)
    jden, _ = jzoo.build_unet(jcfg, tree)
    tden, module = tzoo.build_unet(tcfg, unet_params_from_flax(tree), device="cpu")
    return jden, tden, module


def test_bridge_covers_every_parameter(tiny_tree):
    _, tcfg = _configs("fp32")
    state = unet_params_from_flax(tiny_tree)
    want = tunet.UNetModel(tcfg).state_dict()
    assert sorted(state) == sorted(want)
    for k, v in state.items():
        assert tuple(v.shape) == tuple(want[k].shape), k


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("hoisted", [False, True], ids=["per_forward_kv", "kv_cache"])
def test_unet_forward_matches_flax(tiny_tree, dtype, hoisted):
    jcfg, _ = _configs("fp32")
    _, _, module = _models(tiny_tree, dtype)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    t = rng.uniform(0.0, 999.0, (2,)).astype(np.float32)
    ctx = rng.standard_normal((2, 8, 32)).astype(np.float32)

    # the flax forward in fp32 (with the hoisted k|v when the port uses one)
    with jax.default_matmul_precision("highest"):
        kv = (jzoo.unet_precompute_kv(tiny_tree, {"context": jnp.asarray(ctx)},
                                      dtype=jcfg.dtype)["kv_cache"] if hoisted else None)
        want = junet.UNetModel(jcfg).apply(tiny_tree, jnp.asarray(x), jnp.asarray(t),
                                           jnp.asarray(ctx), None, kv_cache=kv)
    want = np.asarray(want, np.float32)

    tctx = torch.from_numpy(ctx)
    tkv = (tzoo.unet_precompute_kv(module, {"context": tctx})["kv_cache"]
           if hoisted else None)
    with torch.no_grad():
        got = module(torch.from_numpy(x), torch.from_numpy(t), tctx, None, kv_cache=tkv)
    # the output convolution runs in fp32 in both dtypes
    assert got.dtype == torch.float32 and got.shape == want.shape
    if dtype == "fp32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    else:
        rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert rel <= 2e-2, f"bf16 relative L2 error {rel:.3g} > 2e-2"


def test_sigma_to_timestep_interp_matches_jnp():
    """The port's hand-written interp against jnp.interp, in and out of range."""
    rng = np.random.default_rng(5)
    sig = np.concatenate([rng.uniform(0.01, 20.0, 64), [1e-12, 0.0291675, 14.6146, 500.0]])
    table = np.log(np.asarray(EpsSigmaTable().sigmas, np.float32))
    want = np.asarray(jnp.interp(jnp.log(jnp.maximum(jnp.asarray(sig, jnp.float32), 1e-10)),
                                 jnp.asarray(table), jnp.arange(table.shape[0],
                                                                dtype=jnp.float32)))
    tt = torch.from_numpy(table)
    got = tzoo._interp(torch.log(torch.clamp_min(torch.tensor(sig, dtype=torch.float32),
                                                 1e-10)),
                       tt, torch.arange(tt.shape[0], dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)


def test_slice_through_sampler_matches_jax(tiny_tree):
    """The whole slice: tiny UNet -> CFG 5 sequential -> think loop (2 steps)
    -> euler over karras 4, same explicit noise and think-loop noise feed,
    through both packages' LanPaintSampler, in fp32."""
    jden, tden, _ = _models(tiny_tree, "fp32")
    rng = np.random.default_rng(11)
    shape = (1, 4, 16, 16)
    latent = rng.standard_normal(shape).astype(np.float32)
    noise = rng.standard_normal(shape).astype(np.float32)
    mask = np.zeros((16, 16), np.float32)
    mask[4:12, 4:12] = 1.0
    ctx = rng.standard_normal((1, 8, 32)).astype(np.float32)
    unctx = rng.standard_normal((1, 8, 32)).astype(np.float32)
    sigmas = calculate_sigmas(tden.sigma_table, "karras", 4)
    n_think = 2
    feed = rng.standard_normal((len(sigmas) - 1, n_think, 5) + shape).astype(np.float32)
    kw = dict(sampler_name="euler", cfg=5.0, sequential_cfg=True)

    with jax.default_matmul_precision("highest"):
        jsam = JSampler(jden, config=JConfig(n_steps=n_think), **kw)
        j_samples, j_den = jsam(
            latent=jnp.asarray(latent), sigmas=sigmas, mask=jnp.asarray(mask),
            cond={"context": jnp.asarray(ctx)}, uncond={"context": jnp.asarray(unctx)},
            noise=jnp.asarray(noise), noise_feed=jnp.asarray(feed))

    tsam = LanPaintSampler(tden, config=LanPaintConfig(n_steps=n_think), **kw)
    t_samples, t_den = tsam(
        latent=torch.from_numpy(latent), sigmas=sigmas, mask=torch.from_numpy(mask),
        cond={"context": torch.from_numpy(ctx)}, uncond={"context": torch.from_numpy(unctx)},
        noise=torch.from_numpy(noise), noise_feed=torch.from_numpy(feed))

    assert t_den.shape == (len(sigmas) - 1,) + shape
    for got, want in ((t_den.numpy(), np.asarray(j_den)),
                      (t_samples.numpy(), np.asarray(j_samples))):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    # the known region is the latent itself (the last euler step lands on
    # the blended x0), and the repainted region moved
    known = mask == 0
    np.testing.assert_allclose(t_samples.numpy()[..., known], latent[..., known], atol=1e-5)
    assert np.abs(t_samples.numpy()[..., ~known] - latent[..., ~known]).mean() > 1e-2
