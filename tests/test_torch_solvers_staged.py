"""The port's multi-stage solvers through `LanPaintSampler`, against the JAX
package on the tiny UNet in fp32.

1. heun, heunpp2, dpm_2 and dpmpp_sde: both packages' LanPaintSampler over
   a karras ladder of 5 steps at CFG 5 (sequential), 2 think steps, outer
   early stop 1, one explicit initial noise and one think-noise feed, the
   port's solver noise fed the JAX solver's draws (its key is the third
   split of the seed's key).  A multi-stage step calls the model at sigmas
   between the ladder's; the think loop's length (the outer early stop) and
   its feed row follow the step of the nearest ladder sigma, as the JAX
   package's inpaint wrapper assigns it (lanpaint_tpu/api.py:184): under the
   loop counter heun's and dpm_2's second stage on the second-to-last step
   would run 2 think steps where JAX runs none, and read the wrong feed
   row.  Limit: rtol 1e-4 with atol 1e-4 * max|want|, as
   tests/test_torch_api.py's.
2. The model-call steps of heun, heunpp2 and dpm_2, recorded.

tests/test_torch_solvers_chunks.py holds deis, dpm_fast and the JAX
package's chunked runs (two files, so that pytest-xdist's workers share
JAX's compiles).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lanpaint_tpu as J
from lanpaint_tpu.models import zoo as jzoo
from lanpaint_tpu_torch import LanPaintConfig, LanPaintSampler
from lanpaint_tpu_torch import samplers as tsamplers
from lanpaint_tpu_torch.models import zoo as tzoo
from lanpaint_tpu_torch.models.bridge import unet_params_from_flax
from lanpaint_tpu_torch.sigmas import calculate_sigmas
from test_torch_solvers import jax_draws, one_thread  # noqa: F401
from test_torch_unet import _configs, _random_tree

SHAPE = (1, 4, 16, 16)
STEPS = 5


@pytest.fixture(scope="module")
def models():
    """(JAX Denoiser, port Denoiser) of one tiny-UNet tree, fp32."""
    jcfg, tcfg = _configs("fp32")
    _, params = jzoo.build_unet(jcfg)
    tree = _random_tree(params, seed=11)
    jden, _ = jzoo.build_unet(jcfg, tree)
    tden, _ = tzoo.build_unet(tcfg, unet_params_from_flax(tree), device="cpu")
    return jden, tden


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(31)
    mask = np.zeros(SHAPE[2:], np.float32)
    mask[3:12, 4:13] = 1.0
    return dict(latent=rng.standard_normal(SHAPE).astype(np.float32),
                noise=rng.standard_normal(SHAPE).astype(np.float32), mask=mask,
                feed=rng.standard_normal((STEPS, 2, 5) + SHAPE).astype(np.float32),
                ctx=rng.standard_normal((1, 8, 32)).astype(np.float32),
                unctx=rng.standard_normal((1, 8, 32)).astype(np.float32))


def _run(sampler_cls, config_cls, den, inputs, to, name, **call_kw):
    sam = sampler_cls(den, config=config_cls(n_steps=2), sampler_name=name, cfg=5.0,
                      sequential_cfg=True)
    # the feed holds a row per outer step
    return sam(latent=to(inputs["latent"]), sigmas=calculate_sigmas(
                   den.sigma_table, "karras", len(inputs["feed"])), mask=to(inputs["mask"]),
               cond={"context": to(inputs["ctx"])}, uncond={"context": to(inputs["unctx"])},
               noise=to(inputs["noise"]), seed=3, **call_kw)


def check_against_jax(models, inputs, monkeypatch, name, **jax_kw):
    """The port's run against the JAX package's, `jax_kw` passed to the JAX
    package's call alone."""
    jden, tden = models
    with jax.default_matmul_precision("highest"):
        want = _run(J.LanPaintSampler, J.LanPaintConfig, jden, inputs, jnp.asarray, name,
                    noise_feed=jnp.asarray(inputs["feed"]), **jax_kw)
    k_solve = jax.random.split(jax.random.PRNGKey(3), 3)[2]
    monkeypatch.setattr(tsamplers, "_noise_like", jax_draws(k_solve))
    got = _run(LanPaintSampler, LanPaintConfig, tden, inputs, torch.from_numpy, name,
               noise_feed=torch.from_numpy(inputs["feed"]))
    for g, w in zip(got, want):  # (samples, denoised history)
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("name", ["heun", "heunpp2", "dpm_2", "dpmpp_sde"])
def test_solver_through_sampler_matches_jax(models, inputs, monkeypatch, name):
    check_against_jax(models, inputs, monkeypatch, name)


@pytest.mark.parametrize("name,want", [
    # two stages a step, the second at sigma_next (the next step's), one on the last
    ("heun", [0, 1, 1, 2, 2, 3, 3, 4, 4]),
    # three stages, two on the second-to-last step, one on the last
    ("heunpp2", [0, 1, 2, 1, 2, 3, 2, 3, 4, 3, 4, 4]),
    # the midpoint (geometric mean) lies nearer sigma_{i+1} on this ladder
    ("dpm_2", [0, 1, 1, 2, 2, 3, 3, 4, 4]),
])
def test_model_calls_take_the_step_of_the_nearest_sigma(name, want):
    seen = []

    def model(x, sigma, step):
        seen.append(step)
        return x / (1.0 + sigma**2), x

    sigmas = np.asarray([14.6, 4.0, 1.2, 0.3, 0.05, 0.0], np.float32)
    tsamplers.sample(model, torch.ones((1, 1, 2, 2)), sigmas, sampler=name)
    assert seen == want
