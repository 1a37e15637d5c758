"""The port's sampling API beyond the main path (lanpaint_tpu_torch.api):
the mask-less plain path, `ksampler_advanced`, `sample_custom(_advanced)`,
`return_aux` / `trace`, callbacks, `decoupled_noise` and
`denoise_mask_fn`, against the JAX package on the tiny UNet in fp32; and
that an entry point keeps no reference to the model once it returns.

Same numbers on both sides: explicit initial noise and the think loop's
`noise_feed` where the entry point takes them; elsewhere the
`shared_normals` fixture replaces both packages' standard-normal draws by
one function of the shape (the think loop's (5, *shape) draw, 5D for an
image latent and 6D for a video latent, becomes five copies of the shape's
draw, as the JAX engine's five draws then are).

Tolerance: 1e-4 relative to the largest value of each compared tensor, as
tests/test_torch_unet.py's slice test (the random eps-UNet's history
reaches ~100 and fp32 rounding moves small entries by ~5e-4 absolute).
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lanpaint_tpu as J
from lanpaint_tpu.models import zoo as jzoo
from lanpaint_tpu_torch import LanPaintConfig, LanPaintSampler
from lanpaint_tpu_torch import api as tapi
from lanpaint_tpu_torch.models import zoo as tzoo
from lanpaint_tpu_torch.models.bridge import unet_params_from_flax
from lanpaint_tpu_torch.sigmas import calculate_sigmas
from lanpaint_tpu_torch.utils import make_preview_callback
from test_torch_unet import _configs, _random_tree

SHAPE = (1, 4, 16, 16)


def _normal(shape):
    shape = tuple(int(s) for s in shape)
    return np.random.default_rng([7, *shape]).standard_normal(shape).astype(np.float32)


@pytest.fixture
def shared_normals(monkeypatch):
    """torch.randn and jax.random.normal both return `_normal(shape)`."""

    def t_randn(*size, generator=None, dtype=None, device=None, **kw):
        shape = tuple(size[0]) if len(size) == 1 and not isinstance(size[0], int) else size
        arr = (np.stack([_normal(shape[1:])] * 5) if len(shape) >= 5 and shape[0] == 5
               else _normal(shape))
        return torch.from_numpy(arr).to(device=device or "cpu", dtype=dtype or torch.float32)

    def j_normal(key, shape=(), dtype=jnp.float32):
        return jnp.asarray(_normal(shape), dtype)

    monkeypatch.setattr(torch, "randn", t_randn)
    monkeypatch.setattr(jax.random, "normal", j_normal)


@pytest.fixture(scope="module")
def models():
    """(JAX Denoiser, port Denoiser) of one tiny-UNet tree, fp32."""
    jcfg, tcfg = _configs("fp32")
    _, params = jzoo.build_unet(jcfg)
    tree = _random_tree(params, seed=7)
    jden, _ = jzoo.build_unet(jcfg, tree)
    tden, _ = tzoo.build_unet(tcfg, unet_params_from_flax(tree), device="cpu")
    return jden, tden


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(21)
    mask = np.zeros(SHAPE[2:], np.float32)
    mask[4:12, 3:11] = 1.0
    return dict(latent=rng.standard_normal(SHAPE).astype(np.float32),
                noise=rng.standard_normal(SHAPE).astype(np.float32), mask=mask,
                ctx=rng.standard_normal((1, 8, 32)).astype(np.float32),
                unctx=rng.standard_normal((1, 8, 32)).astype(np.float32))


def _conds(inputs, lib):
    to = jnp.asarray if lib is jnp else torch.from_numpy
    return {"context": to(inputs["ctx"])}, {"context": to(inputs["unctx"])}


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_plain_path_matches_jax(models, inputs):
    """No mask: every outer step is one CFG denoise, no think loop."""
    jden, tden = models
    sigmas = calculate_sigmas(tden.sigma_table, "karras", 4)
    kw = dict(sampler_name="euler", cfg=5.0, sequential_cfg=True)
    with jax.default_matmul_precision("highest"):
        cond, uncond = _conds(inputs, jnp)
        want = J.LanPaintSampler(jden, **kw)(latent=jnp.asarray(inputs["latent"]), sigmas=sigmas,
                                            cond=cond, uncond=uncond,
                                            noise=jnp.asarray(inputs["noise"]))
    cond, uncond = _conds(inputs, torch)
    sam = LanPaintSampler(tden, return_aux=True, **kw)
    samples, den, aux = sam(latent=torch.from_numpy(inputs["latent"]), sigmas=sigmas, cond=cond,
                            uncond=uncond, noise=torch.from_numpy(inputs["noise"]))
    assert aux is None  # no think loop to report on
    _close(den, want[1])
    _close(samples, want[0])


def test_ksampler_advanced_leftover_noise_and_resume(models, inputs, shared_normals):
    """Steps 0-2 of a karras 4 ladder returning the leftover noise, then
    steps 2-4 resumed from it with add_noise off, both as the JAX package."""
    jden, tden = models
    legs = [dict(add_noise=True, start_at_step=0, end_at_step=2,
                 return_with_leftover_noise=True),
            dict(add_noise=False, start_at_step=2, end_at_step=10000)]
    kw = dict(noise_seed=3, steps=4, cfg=5.0, num_steps=2, sequential_cfg=True)
    j_lat = jnp.asarray(inputs["latent"])
    t_lat = torch.from_numpy(inputs["latent"])
    for leg in legs:
        with jax.default_matmul_precision("highest"):
            cond, uncond = _conds(inputs, jnp)
            j_lat = J.ksampler_advanced(jden, positive=cond, negative=uncond, latent=j_lat,
                                        mask=jnp.asarray(inputs["mask"]), **kw, **leg)
        cond, uncond = _conds(inputs, torch)
        t_lat = tapi.ksampler_advanced(tden, positive=cond, negative=uncond, latent=t_lat,
                                       mask=torch.from_numpy(inputs["mask"]), **kw, **leg)
        _close(t_lat, j_lat)
    # an empty step range returns the latent itself
    assert tapi.ksampler_advanced(tden, positive=cond, latent=t_lat, start_at_step=9,
                                  steps=4) is t_lat


@pytest.mark.parametrize("entry", ["sample_custom", "sample_custom_advanced"])
def test_sample_custom_matches_jax(models, inputs, shared_normals, entry):
    jden, tden = models
    sigmas = calculate_sigmas(tden.sigma_table, "karras", 3)
    kw = dict(noise_seed=5, cfg=4.0, sigmas=sigmas, num_steps=2, sequential_cfg=True)
    if entry == "sample_custom_advanced":
        kw.update(lamb=8.0, step_size=0.3, beta=0.9, friction=10.0, early_stop=2)
    with jax.default_matmul_precision("highest"):
        cond, uncond = _conds(inputs, jnp)
        extra = ({"noise": jnp.asarray(inputs["noise"])} if entry == "sample_custom_advanced"
                 else {})
        want = getattr(J, entry)(jden, positive=cond, negative=uncond,
                                 latent=jnp.asarray(inputs["latent"]),
                                 mask=jnp.asarray(inputs["mask"]), **kw, **extra)
    cond, uncond = _conds(inputs, torch)
    extra = ({"noise": torch.from_numpy(inputs["noise"])} if entry == "sample_custom_advanced"
             else {})
    got = getattr(tapi, entry)(tden, positive=cond, negative=uncond,
                               latent=torch.from_numpy(inputs["latent"]),
                               mask=torch.from_numpy(inputs["mask"]), **kw, **extra)
    for g, w in zip(got, want):  # (output, denoised_output)
        _close(g, w)


def test_ksampler_trace_and_steps_done_match_jax(models, inputs, shared_normals):
    """`trace` receives the think loop's per-step iteration counts and the
    8-column rows of every inner step (record_trace), as the JAX package's."""
    jden, tden = models
    kw = dict(seed=2, steps=3, cfg=5.0, scheduler="karras", num_steps=2, sequential_cfg=True)
    j_trace, t_trace = {}, {}
    with jax.default_matmul_precision("highest"):
        cond, uncond = _conds(inputs, jnp)
        want = J.ksampler(jden, positive=cond, negative=uncond,
                          latent=jnp.asarray(inputs["latent"]),
                          mask=jnp.asarray(inputs["mask"]), trace=j_trace, **kw)
    cond, uncond = _conds(inputs, torch)
    got = tapi.ksampler(tden, positive=cond, negative=uncond,
                        latent=torch.from_numpy(inputs["latent"]),
                        mask=torch.from_numpy(inputs["mask"]), trace=t_trace, **kw)
    _close(got, want)
    # 3 outer steps: 2 think steps each but the last (outer early stop 1)
    np.testing.assert_array_equal(t_trace["steps_done"], [2, 2, 0])
    np.testing.assert_array_equal(t_trace["steps_done"], j_trace["steps_done"])
    assert t_trace["trace"].shape == (3, 2, 8)
    np.testing.assert_array_equal(t_trace["trace"][..., 0], j_trace["trace"][..., 0])
    np.testing.assert_allclose(t_trace["trace"], j_trace["trace"], rtol=1e-4, atol=1e-6)


def test_denoise_mask_fn_matches_jax(models, inputs):
    """A per-step mask (here: repaint nothing once sigma falls below 2)."""
    jden, tden = models
    sigmas = calculate_sigmas(tden.sigma_table, "karras", 3)
    feed = np.random.default_rng(4).standard_normal((3, 2, 5) + SHAPE).astype(np.float32)
    kw = dict(config_kw=dict(n_steps=2), cfg=5.0, sequential_cfg=True,
              denoise_mask_fn=lambda sigma, m: m * (sigma > 2.0))

    def run(lib, sampler_cls, config_cls, to):
        cond, uncond = _conds(inputs, lib)
        sam = sampler_cls(jden if lib is jnp else tden, config=config_cls(**kw["config_kw"]),
                          cfg=kw["cfg"], sequential_cfg=True,
                          denoise_mask_fn=kw["denoise_mask_fn"])
        return sam(latent=to(inputs["latent"]), sigmas=sigmas, cond=cond, uncond=uncond,
                   mask=to(inputs["mask"]), noise=to(inputs["noise"]), noise_feed=to(feed))

    with jax.default_matmul_precision("highest"):
        want = run(jnp, J.LanPaintSampler, J.LanPaintConfig, jnp.asarray)
    got = run(torch, LanPaintSampler, LanPaintConfig, torch.from_numpy)
    _close(got[1], want[1])
    _close(got[0], want[0])


def _toy():
    from lanpaint_tpu_torch import Denoiser, ModelKind
    from lanpaint_tpu_torch.sigmas import EpsSigmaTable

    return Denoiser(apply=lambda x, t, cond: torch.tanh(x) * cond["c"].reshape(-1, 1, 1, 1),
                    kind=ModelKind.EPS, sigma_table=EpsSigmaTable())


def _toy_run(sam, **kw):
    mask = torch.zeros((8, 8))
    mask[2:6, 2:6] = 1.0
    latent = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 4, 8, 8)).astype(
        np.float32))
    return sam(latent=latent, sigmas=calculate_sigmas(sam.model.sigma_table, "karras", 5),
               cond={"c": torch.ones(1)}, uncond={"c": torch.full((1,), 0.5)}, mask=mask,
               **{"seed": 4, **kw})


def test_callbacks_once_per_step_with_the_step_results():
    seen = []
    sam = LanPaintSampler(_toy(), config=LanPaintConfig(n_steps=1), cfg=2.0,
                          callback=lambda i, den, x: seen.append((i, den.clone(), x.clone())))
    samples, den = _toy_run(sam)
    assert [i for i, _, _ in seen] == list(range(5))
    for i, d, _ in seen:
        assert torch.equal(d, den[i])
    assert torch.equal(seen[-1][2], samples)  # eps: the last x is the samples
    previews = []
    cb = make_preview_callback(lambda i, d: previews.append(i), every=2)
    _toy_run(LanPaintSampler(_toy(), config=LanPaintConfig(n_steps=1), cfg=2.0, callback=cb))
    assert previews == [0, 2, 4]


@pytest.mark.parametrize("seed,think_seed", [(4, 5), (2**32 - 1, 0), (-1, 0), (2**33 + 7, 8)])
def test_decoupled_noise_draws_from_seed_plus_one(monkeypatch, seed, think_seed):
    """The think loop's replace-step noise comes from a generator seeded
    seed + 1, the seed taken to its low 32 bits first (the JAX package's
    uint32 wrap); without decoupling it is the initial noise."""
    seen = []
    real = tapi.lanpaint_update

    def spy(*args, **kw):
        seen.append(kw["noise"])
        return real(*args, **kw)

    monkeypatch.setattr(tapi, "lanpaint_update", spy)
    sam = LanPaintSampler(_toy(), config=LanPaintConfig(n_steps=1), cfg=2.0)
    for decoupled in (True, False):
        seen.clear()
        _toy_run(sam, decoupled_noise=decoupled, seed=seed)
        gen = torch.Generator().manual_seed(think_seed if decoupled else seed & 0xFFFFFFFF)
        want = torch.randn((1, 4, 8, 8), generator=gen)
        assert len(seen) == 5 and all(torch.equal(n, want) for n in seen)


@pytest.mark.parametrize("entry", ["ksampler", "ksampler_advanced", "sample_custom",
                                   "sample_custom_advanced"])
def test_entry_point_holds_no_reference_to_the_model(inputs, entry):
    """Each entry point builds its sampler for the call: once the caller
    drops the model, nothing the API kept alive holds it (a model's weights
    leave the card with its last reference)."""
    den, _ = tzoo.build_unet(_configs("fp32")[1], device="cpu")
    alive = weakref.ref(den)
    cond, uncond = _conds(inputs, torch)
    kw = dict(positive=cond, negative=uncond, latent=torch.from_numpy(inputs["latent"]),
              mask=torch.from_numpy(inputs["mask"]), num_steps=1)
    if entry.startswith("sample_custom"):
        kw["sigmas"] = calculate_sigmas(den.sigma_table, "karras", 2)
    else:
        kw["steps"] = 2
    if entry == "ksampler":
        kw["callback"] = lambda i, d, x: None
    getattr(tapi, entry)(den, **kw)
    del den
    gc.collect()
    assert alive() is None


def test_one_sigma_ladder_with_trace():
    """start_at_step == end_at_step leaves a one-sigma ladder: no step, the
    noise-scaled start comes back and the trace holds None (the JAX
    package's sampler returns a pair there, which its trace path cannot
    unpack)."""
    trace = {}
    latent = torch.zeros((1, 4, 8, 8))
    out = tapi.ksampler_advanced(_toy(), positive={"c": torch.ones(1)}, latent=latent,
                                 mask=torch.ones((8, 8)), steps=4, start_at_step=2,
                                 end_at_step=2, return_with_leftover_noise=True, trace=trace)
    assert out.shape == latent.shape and bool(torch.isfinite(out).all())
    assert trace == {"steps_done": None, "trace": None}
