"""The port's MMDiT (lanpaint_tpu_torch.models.dit) against the flax MMDiT.

Weights come from one flax parameter tree carried across by
`models.bridge.dit_params_from_flax`; inputs from numpy.  Both sides run on
the CPU, where JAX's attention and row norms take their plain references
and the port's wrappers take theirs.

Tolerances:
* the DiT layers (RoPE, adaLN LayerNorm, RMSNorm, QKNorm) in fp32: 1e-6
  (the same fp32 formulas; cos/sin differ by an ulp);
* the tiny MMDiT forward in fp32: 1e-4 (GEMMs summed in different orders);
* the full-width Flux-dev bridge: exact key and shape coverage, no weights
  allocated;
* the sampler slice: 1e-4 relative to the largest value of each compared
  tensor, as tests/test_torch_unet.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanpaint_tpu import LanPaintConfig as JConfig
from lanpaint_tpu import LanPaintSampler as JSampler
from lanpaint_tpu.models import dit as jdit
from lanpaint_tpu.models import layers as jlayers
from lanpaint_tpu.models import zoo as jzoo
from lanpaint_tpu_torch import LanPaintConfig, LanPaintSampler
from lanpaint_tpu_torch.models import dit as tdit
from lanpaint_tpu_torch.models import layers as tlayers
from lanpaint_tpu_torch.models import zoo as tzoo
from lanpaint_tpu_torch.models.bridge import dit_params_from_flax, flax_entries
from lanpaint_tpu_torch.sigmas import calculate_sigmas

LAYER_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("axes_dim", [(4, 6, 6), (16, 56, 56)], ids=["tiny", "flux"])
def test_rope_matches_jax(axes_dim):
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 64, (2, 40, 3)).astype(np.int32)
    d = sum(axes_dim)
    x = rng.standard_normal((2, 40, 3, d)).astype(np.float32)
    want_f = jlayers.rope_freqs(jnp.asarray(ids), axes_dim, 10000.0)
    got_f = tlayers.rope_freqs(torch.from_numpy(ids).long(), axes_dim, 10000.0)
    assert got_f.dtype == torch.float32 and tuple(got_f.shape) == want_f.shape
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), **LAYER_TOL)
    want = jlayers.apply_rope(jnp.asarray(x), want_f)
    got = tlayers.apply_rope(torch.from_numpy(x), got_f)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_dit_norms_match_jax():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 24, 4, 32)) * 1.7 + 0.4).astype(np.float32)
    got = tlayers.layernorm_na(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jlayers.layernorm_na(jnp.asarray(x))),
                               **LAYER_TOL)

    sq, sk = (1.0 + 0.1 * rng.standard_normal(32)).astype(np.float32), \
        (1.0 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    k = rng.standard_normal(x.shape).astype(np.float32)
    jq, jk = jlayers.QKNorm(32).apply(
        {"params": {"query_norm": {"scale": sq}, "key_norm": {"scale": sk}}},
        jnp.asarray(x), jnp.asarray(k))
    qk = tlayers.QKNorm(32)
    qk.load_state_dict({"query_norm.weight": torch.from_numpy(sq),
                        "key_norm.weight": torch.from_numpy(sk)})
    with torch.no_grad():
        tq, tk = qk(torch.from_numpy(x), torch.from_numpy(k))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **LAYER_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **LAYER_TOL)
    # RMSNorm alone, as txt_norm uses it over the context width
    jr = jlayers.RMSNorm(32).apply({"params": {"scale": sq}}, jnp.asarray(k))
    np.testing.assert_allclose(qk.query_norm(torch.from_numpy(k)).detach().numpy(),
                               np.asarray(jr), **LAYER_TOL)


def _random_tree(shapes, seed):
    """Well-conditioned random weights in the flax tree's shapes: kernels
    N(0, 1/fan_in), biases N(0, 0.1^2), norm scales 1 + N(0, 0.1^2), so
    every layer moves the output."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif name == "bias":
            v = 0.1 * rng.standard_normal(s.shape)
        else:  # a dense kernel, possibly stacked by nn.scan: fan-in is axis -2
            v = rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


TINY_VARIANTS = {
    "tiny": {},
    "guidance_txtnorm_novec": dict(guidance_embed=True, vec_dim=0, txt_norm=True),
}


def _flax_shapes(jcfg, b=2, hw=16, n_ctx=8):
    x = jnp.zeros((b, jcfg.latent_channels, hw, hw), jnp.float32)
    ctx = jnp.zeros((b, n_ctx, jcfg.context_dim), jnp.float32)
    vec = jnp.zeros((b, jcfg.vec_dim), jnp.float32) if jcfg.vec_dim else None
    return jax.eval_shape(jdit.MMDiT(jcfg).init, jax.random.PRNGKey(0), x,
                          jnp.full((b,), 0.5), ctx, vec)


def _tiny_pair(variant, seed=7):
    """(flax config, flax tree, port module), fp32, one set of weights."""
    jcfg = dataclasses.replace(jdit.TINY_DIT_CONFIG, dtype=jnp.float32, **TINY_VARIANTS[variant])
    tcfg = dataclasses.replace(tdit.TINY_DIT_CONFIG, dtype=torch.float32,
                               **TINY_VARIANTS[variant])
    tree = _random_tree(_flax_shapes(jcfg), seed)
    module = tdit.MMDiT(tcfg)
    module.load_state_dict(dit_params_from_flax(tree))
    return jcfg, tcfg, tree, module.eval()


@pytest.mark.parametrize("variant,ref_tokens", [("tiny", False),
                                                ("guidance_txtnorm_novec", False),
                                                ("tiny", True)],
                         ids=["tiny", "guidance_txtnorm_novec", "ref_tokens"])
def test_mmdit_forward_matches_flax(variant, ref_tokens):
    jcfg, _, tree, module = _tiny_pair(variant)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    t = rng.uniform(0.05, 0.95, (2,)).astype(np.float32)
    ctx = rng.standard_normal((2, 8, 32)).astype(np.float32)
    vec = rng.standard_normal((2, 16)).astype(np.float32) if jcfg.vec_dim else None
    guidance = np.asarray([2.5, 4.0], np.float32) if jcfg.guidance_embed else None
    extra = rng.standard_normal((2, 20, 16)).astype(np.float32) if ref_tokens else None
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    tt = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731

    with jax.default_matmul_precision("highest"):
        want = np.asarray(jdit.MMDiT(jcfg).apply(tree, j(x), j(t), j(ctx), j(vec), j(guidance),
                                                 j(extra)))
    with torch.no_grad():
        got = module(tt(x), tt(t), tt(ctx), tt(vec), tt(guidance), tt(extra))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_flux_dev_bridge_maps_every_key_without_allocating():
    shapes = _flax_shapes(jdit.FLUX_DEV_CONFIG, b=1)
    # zero-stride stand-ins: the full tree's shapes at no memory cost
    tree = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    keys, shape_of = [], {}
    for key, arr in flax_entries(tree):
        keys.append(key)
        shape_of[key] = tuple(arr.shape)
    with torch.device("meta"):
        module = tdit.MMDiT(tdit.FLUX_DEV_CONFIG)
    want = {k: tuple(p.shape) for k, p in module.state_dict().items()}
    assert len(keys) == len(set(keys)), "a key was mapped twice"
    assert set(keys) == set(want), (sorted(set(want) - set(keys))[:5],
                                    sorted(set(keys) - set(want))[:5])
    assert shape_of == want
    n_flax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    n_port = sum(p.numel() for p in module.parameters())
    assert n_flax == n_port and 11.8e9 < n_port < 12.0e9, (n_flax, n_port)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_slice_through_sampler_matches_jax(fused):
    """The tiny DiT -> flow-matching think loop (2 steps) -> euler over the
    "simple" ladder of 4, cfg 1 (is_flux: cfg_big forced to 1), one shared
    explicit noise and think-noise feed, through both packages'
    LanPaintSampler in fp32; the port with and without the fused think-step
    path (its plain versions on the CPU)."""
    jcfg, tcfg, tree, _ = _tiny_pair("tiny", seed=9)
    jden, _ = jzoo.build_dit(jcfg, tree, is_flux=True)
    tden, _ = tzoo.build_dit(tcfg, dit_params_from_flax(tree), is_flux=True, device="cpu")
    rng = np.random.default_rng(13)
    shape = (1, 4, 16, 16)
    latent = rng.standard_normal(shape).astype(np.float32)
    noise = rng.standard_normal(shape).astype(np.float32)
    mask = np.zeros((16, 16), np.float32)
    mask[4:12, 4:12] = 1.0
    ctx = rng.standard_normal((1, 8, 32)).astype(np.float32)
    vec = rng.standard_normal((1, 16)).astype(np.float32)
    sigmas = calculate_sigmas(tden.sigma_table, "simple", 4)
    n_think = 2
    feed = rng.standard_normal((len(sigmas) - 1, n_think, 5) + shape).astype(np.float32)
    kw = dict(sampler_name="euler", cfg=1.0)

    with jax.default_matmul_precision("highest"):
        jsam = JSampler(jden, config=JConfig(n_steps=n_think), **kw)
        j_samples, j_den = jsam(
            latent=jnp.asarray(latent), sigmas=sigmas, mask=jnp.asarray(mask),
            cond={"context": jnp.asarray(ctx), "vec": jnp.asarray(vec)},
            noise=jnp.asarray(noise), noise_feed=jnp.asarray(feed))

    tsam = LanPaintSampler(tden, config=LanPaintConfig(n_steps=n_think, use_fused_kernels=fused),
                           **kw)
    assert tsam.cfg_big == 1.0
    t_samples, t_den = tsam(
        latent=torch.from_numpy(latent), sigmas=sigmas, mask=torch.from_numpy(mask),
        cond={"context": torch.from_numpy(ctx), "vec": torch.from_numpy(vec)},
        noise=torch.from_numpy(noise), noise_feed=torch.from_numpy(feed))

    assert t_den.shape == (len(sigmas) - 1,) + shape
    for got, want in ((t_den.numpy(), np.asarray(j_den)),
                      (t_samples.numpy(), np.asarray(j_samples))):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    known = mask == 0
    np.testing.assert_allclose(t_samples.numpy()[..., known], latent[..., known], atol=1e-5)
    assert np.abs(t_samples.numpy()[..., ~known] - latent[..., ~known]).mean() > 1e-2


def test_port_configs_match_jax():
    """The configurations are data: every field but the compute dtype (and
    the JAX-only `attention_impl`) equals the JAX package's.  FLUX.2 [dev]
    is the exception: the JAX package keeps a stand-in MMDiT under
    FLUX2_DEV_CONFIG, the port the published architecture in
    `models/flux2.py` (`test_torch_flux2.py` holds it to its sizes)."""
    from lanpaint_tpu_torch.models import flux2

    names = [n for n in dir(jdit) if n.endswith("_CONFIG") and n != "FLUX2_DEV_CONFIG"]
    assert names and sorted(names) == sorted(n for n in dir(tdit) if n.endswith("_CONFIG"))
    assert isinstance(jdit.FLUX2_DEV_CONFIG, jdit.DiTConfig)
    assert isinstance(flux2.FLUX2_DEV_CONFIG, flux2.Flux2Config)
    for name in names:
        jc, tc = dataclasses.asdict(getattr(jdit, name)), dataclasses.asdict(getattr(tdit, name))
        for drop in ("dtype", "attention_impl"):
            jc.pop(drop, None)
            tc.pop(drop, None)
        assert jc == tc, name
