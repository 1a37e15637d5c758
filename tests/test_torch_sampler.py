"""The port's sampler API (lanpaint_tpu_torch.api / samplers / masks).

1. The six `LADDER_CASES` of tests/data/reference_goldens.npz (five euler,
   one dpmpp_2m): full ladders recorded from the original torch LanPaint's
   outer path, replayed through the port's public `LanPaintSampler` with
   the per-step noise feed, at the JAX package's 5e-4.
2. `prepare_mask` against the JAX package for 2D, 3D and 4D image masks
   and the video layouts, exactly (it is an index gather).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanpaint_tpu.masks import prepare_mask as j_prepare_mask
from lanpaint_tpu.samplers import SAMPLER_NAMES as J_SAMPLER_NAMES
from lanpaint_tpu_torch import Denoiser, LanPaintConfig, LanPaintSampler, ModelKind
from lanpaint_tpu_torch.masks import prepare_mask
from lanpaint_tpu_torch.samplers import SAMPLER_NAMES, get_solver
from test_reference_golden import DATA, LADDER_CASES, build_ladder_feed

EULER_LADDERS = [n for n in LADDER_CASES if "euler" in n]


@pytest.fixture(scope="module")
def goldens():
    return np.load(DATA)


def test_euler_ladders_are_the_five_named():
    assert EULER_LADDERS == ["ladder_euler_eps", "ladder_euler_flow",
                             "ladder_euler_flow_leftover", "ladder_euler_eps_tail2",
                             "ladder_euler_eps_video"]


@pytest.mark.parametrize("name", LADDER_CASES)
def test_reference_ladder_through_port(goldens, name):
    """Same construction as tests/test_reference_golden.py's ladder test: the
    reference's dummy (0.4x+g, 0.55x-0.5g) expressed as cond/uncond passes
    that the CFG double pass (cfg 2, cfg_big 0.5) mixes back."""
    z = goldens
    n_think, lamb, step_size, beta, friction, early_stop = (
        float(v) for v in z[f"{name}/meta"])
    kind = ModelKind.FLOW if int(z[f"{name}/kind"]) else ModelKind.EPS
    g = torch.from_numpy(z[f"{name}/g"])

    def apply(x, t, cond):
        c = cond.reshape((-1,) + (1,) * (x.ndim - 1))
        return c * (0.5 * x) + (1.0 - c) * (0.6 * x - g)

    config = LanPaintConfig(n_steps=int(n_think), lamb=lamb, step_size=step_size, beta=beta,
                            friction=friction, outer_early_stop=int(early_stop))
    sam = LanPaintSampler(Denoiser(apply=apply, kind=kind), config=config,
                          sampler_name="dpmpp_2m" if "dpmpp2m" in name else "euler",
                          cfg=2.0, cfg_big=0.5)
    sigmas = z[f"{name}/sigmas"]
    shape = z[f"{name}/g"].shape
    feed = build_ladder_feed(z, name, len(sigmas) - 1, max(int(n_think), 1), shape)
    video = len(shape) == 5
    samples, den = sam(
        latent=torch.from_numpy(z[f"{name}/latent"]), sigmas=sigmas,
        cond=torch.ones((1, 1)), uncond=torch.zeros((1, 1)),
        mask=torch.from_numpy(z[f"{name}/mask"][0, 0]), seed=0, video=video,
        noise=torch.from_numpy(z[f"{name}/noise"]), noise_feed=torch.from_numpy(feed))
    np.testing.assert_allclose(den.numpy(), z[f"{name}/outs"], rtol=5e-4, atol=5e-4,
                               err_msg=f"{name}: per-step denoised history mismatch")
    np.testing.assert_allclose(samples.numpy(), z[f"{name}/samples"], rtol=5e-4, atol=5e-4,
                               err_msg=f"{name}: final samples mismatch")


@pytest.mark.parametrize("mask_shape,latent_shape,video", [
    ((128, 96), (2, 4, 16, 12), False),        # 2D pixel mask
    ((3, 40, 40), (3, 4, 5, 5), False),        # 3D batch of masks
    ((1, 64, 64), (2, 4, 8, 8), False),        # 3D, batch repeat
    ((2, 1, 33, 17), (2, 16, 8, 4), False),    # 4D, channel repeat
    ((1, 3, 24, 24), (3, 4, 6, 6), False),     # 4D, batch and channel repeat
    ((5, 64, 64), (1, 4, 3, 8, 8), True),      # video frame stack (F, H, W)
    ((64, 64), (1, 4, 3, 8, 8), True),         # one mask for every frame
    ((1, 1, 32, 32), (2, 4, 3, 8, 8), False),  # 4D image mask on a 5D latent
])
def test_prepare_mask_matches_jax(mask_shape, latent_shape, video):
    rng = np.random.default_rng(sum(mask_shape))
    m = (rng.uniform(size=mask_shape) > 0.5).astype(np.float32)
    want = np.asarray(j_prepare_mask(jnp.asarray(m), latent_shape, video))
    got = prepare_mask(torch.from_numpy(m), latent_shape, video)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_get_solver_names_unported_solvers():
    """No solver is left unported: every name the JAX package registers
    resolves (dpm_fast to `_sample_dpm_fast`), and a LanPaintSampler
    takes it; only an unknown name raises."""
    assert SAMPLER_NAMES == J_SAMPLER_NAMES  # the same names in the same order
    for name in SAMPLER_NAMES:
        assert callable(get_solver(name)), name
        LanPaintSampler(Denoiser(apply=lambda x, t, c: x, kind=ModelKind.EPS),
                        sampler_name=name)
    with pytest.raises(ValueError, match="unknown sampler"):
        get_solver("no_such_solver")


def test_register_solver_matches_jax(monkeypatch):
    """A solver registered through the decorator joins `SAMPLER_NAMES` (name
    then aliases, at the end) and the table, as in the JAX package, and a
    LanPaintSampler runs it: here euler under two new names."""
    from lanpaint_tpu import samplers as jsamplers
    from lanpaint_tpu_torch import samplers as tsamplers

    for mod in (jsamplers, tsamplers):
        monkeypatch.setattr(mod, "SAMPLER_NAMES", list(mod.SAMPLER_NAMES))
        monkeypatch.setattr(mod, "_SOLVERS", dict(mod._SOLVERS))
    for mod in (jsamplers, tsamplers):
        fn = mod._SOLVERS["euler"]
        assert mod.register_solver("my_euler", "my_euler_alias")(fn) is fn
    assert tsamplers.SAMPLER_NAMES == jsamplers.SAMPLER_NAMES
    assert tsamplers.SAMPLER_NAMES[-2:] == ["my_euler", "my_euler_alias"]
    assert tsamplers.get_solver("my_euler_alias") is tsamplers._SOLVERS["euler"]

    model = Denoiser(apply=lambda x, t, c: 0.5 * x, kind=ModelKind.EPS)
    latent = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 4, 8, 8)).astype(
        np.float32))
    sigmas = np.asarray([14.6, 3.0, 0.5, 0.0], np.float32)
    outs = [LanPaintSampler(model, sampler_name=name)(latent=latent, sigmas=sigmas, cond={},
                                                      seed=1)[0]
            for name in ("euler", "my_euler")]
    assert torch.equal(outs[0], outs[1])


def _toy_x0(lib):
    def model_x0(x, t, cond):
        c = cond["c"] if isinstance(cond, dict) else cond
        s = t.reshape((-1,) + (1,) * (x.ndim - 1))
        return lib.tanh(x) * c.reshape((-1,) + (1,) * (x.ndim - 1)) - 0.1 * s * x
    return model_x0


@pytest.mark.parametrize("cfg,sequential,pre_cfg", [
    (5.0, False, False), (5.0, True, False), (1.0, False, False), (3.0, True, True)],
    ids=["batched", "sequential", "cfg1_skip", "pre_cfg_fn"])
def test_cfg_double_denoiser_matches_jax(cfg, sequential, pre_cfg):
    from lanpaint_tpu import guidance as jg
    from lanpaint_tpu_torch import guidance as tg

    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 3, 4, 4)).astype(np.float32)
    t = np.asarray([1.3, 0.4], np.float32)
    cond, uncond = np.asarray([1.5, 0.5], np.float32), np.asarray([0.2, -0.3], np.float32)
    fns = ([lambda a: [a["conds_out"][0] * 1.1, a["conds_out"][1] - 0.05 * a["input"]]]
           if pre_cfg else None)
    for prompt_mode in ("Image First", "Prompt First"):
        assert tg.resolve_cfg_big(prompt_mode, cfg) == jg.resolve_cfg_big(prompt_mode, cfg)
    cfg_big = tg.resolve_cfg_big("Prompt First", cfg)
    want = jg.make_cfg_double_denoiser(_toy_x0(jnp), {"c": jnp.asarray(cond)},
                                       {"c": jnp.asarray(uncond)}, cfg, cfg_big,
                                       pre_cfg_fns=fns, sequential=sequential)(
        jnp.asarray(x), jnp.asarray(t))
    got = tg.make_cfg_double_denoiser(_toy_x0(torch), {"c": torch.from_numpy(cond)},
                                      {"c": torch.from_numpy(uncond)}, cfg, cfg_big,
                                      pre_cfg_fns=fns, sequential=sequential)(
        torch.from_numpy(x), torch.from_numpy(t))
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("adapter", ["x0_from_eps", "x0_from_v", "x0_from_flow_velocity"])
def test_x0_adapters_match_jax(adapter):
    from lanpaint_tpu.models import base as jb
    from lanpaint_tpu_torch.models import base as tb

    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 4, 3, 3)).astype(np.float32)
    t = np.asarray([0.7, 3.1], np.float32)
    want = getattr(jb, adapter)(lambda x_, t_, c: jnp.sin(x_) * c)(
        jnp.asarray(x), jnp.asarray(t), 2.0)
    got = getattr(tb, adapter)(lambda x_, t_, c: torch.sin(x_) * c)(
        torch.from_numpy(x), torch.from_numpy(t), 2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _toy_denoiser(kind=ModelKind.EPS):
    from lanpaint_tpu_torch.sigmas import EpsSigmaTable

    return Denoiser(apply=lambda x, t, cond: 0.5 * x * cond.reshape(-1, 1, 1, 1),
                    kind=kind, sigma_table=EpsSigmaTable())


def test_ksampler_is_the_sampler_with_reference_defaults():
    from lanpaint_tpu_torch import ksampler
    from lanpaint_tpu_torch.sigmas import calculate_sigmas

    rng = np.random.default_rng(10)
    latent = torch.from_numpy(rng.standard_normal((1, 4, 8, 8)).astype(np.float32))
    mask = torch.zeros((64, 64))
    mask[16:48, 16:48] = 1.0
    den = _toy_denoiser()
    kw = dict(cond=torch.ones(1), uncond=torch.full((1,), 0.5), mask=mask, seed=3)
    got = ksampler(den, seed=3, steps=4, cfg=5.0, positive=kw["cond"],
                   negative=kw["uncond"], latent=latent, mask=mask, num_steps=2)
    want, _ = LanPaintSampler(den, config=LanPaintConfig(n_steps=2), cfg=5.0)(
        latent=latent, sigmas=calculate_sigmas(den.sigma_table, "karras", 4), **kw)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_one_sigma_ladder_returns_the_scaled_start_like_jax():
    """A ladder with no step returns the noise-scaled latent, as the JAX
    package does, and an empty history."""
    from lanpaint_tpu import Denoiser as JDenoiser
    from lanpaint_tpu import LanPaintSampler as JSampler
    from lanpaint_tpu.config import ModelKind as JKind

    rng = np.random.default_rng(12)
    latent, noise = (rng.standard_normal((1, 4, 8, 8)).astype(np.float32) for _ in range(2))
    mask = np.ones((8, 8), np.float32)
    sigmas = np.asarray([2.5], np.float32)
    want, want_den = JSampler(JDenoiser(apply=lambda x, t, c: x, kind=JKind.EPS))(
        latent=jnp.asarray(latent), sigmas=sigmas, cond=jnp.ones((1, 1)),
        mask=jnp.asarray(mask), noise=jnp.asarray(noise))
    got, got_den = LanPaintSampler(Denoiser(apply=lambda x, t, c: x, kind=ModelKind.EPS))(
        latent=torch.from_numpy(latent), sigmas=sigmas, cond=torch.ones((1, 1)),
        mask=torch.from_numpy(mask), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert tuple(got_den.shape) == tuple(want_den.shape) == (0, 1, 4, 8, 8)
