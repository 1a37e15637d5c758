"""The port's think loop (lanpaint_tpu_torch.engine.lanpaint_update).

1. The 12 engine `CASES` of tests/data/reference_goldens.npz, recorded from
   the original torch LanPaint, replayed through the port's `noise_feed`
   at the tolerance the JAX package meets (2e-4), with the same number of
   think iterations (the semantic early stop must fire at the same step).
2. The port against the JAX engine on a nonlinear toy denoiser with one
   shared noise feed, at 1e-5: default settings, and the semantic stop
   with its 8-column trace.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanpaint_tpu.config import LanPaintConfig as JConfig
from lanpaint_tpu.config import ModelKind as JKind
from lanpaint_tpu.engine import lanpaint_update as j_update
from lanpaint_tpu.schedule import unify_times as j_unify
from lanpaint_tpu_torch.config import LanPaintConfig, ModelKind
from lanpaint_tpu_torch.engine import lanpaint_update
from lanpaint_tpu_torch.schedule import Times, unify_times
from test_reference_golden import CASES, DATA, build_noise_feed


@pytest.fixture(scope="module")
def goldens():
    return np.load(DATA)


@pytest.mark.parametrize("name", CASES)
def test_reference_cases_through_port(goldens, name):
    run_reference_case(goldens, name, use_fused_kernels=False)


def run_reference_case(z, name, use_fused_kernels):
    """Replay golden case `name` through the port's engine and hold it to
    the reference at 2e-4 with the same number of think iterations."""
    n_steps, lamb, step_size, beta, friction = (float(v) for v in z[f"{name}/meta"])
    n_steps = int(n_steps)
    kind = ModelKind.FLOW if int(z[f"{name}/kind"]) else ModelKind.EPS
    x = z[f"{name}/x"]
    g = torch.from_numpy(z[f"{name}/g"])

    def denoiser(xm, t):
        return 0.4 * xm + g, 0.55 * xm - 0.5 * g

    times = Times(*(torch.from_numpy(z[f"{name}/{k}"]) for k in ("ve", "abt", "tflow")))
    stop_threshold, stop_patience, executed, *rest = (float(v) for v in z[f"{name}/stop"])
    custom = bool(rest) and rest[0] > 0
    distance_fn = ((lambda prev, cur, ctx: torch.mean(torch.abs(cur - prev)))
                   if custom else None)
    config = LanPaintConfig(
        n_steps=max(n_steps, 1), lamb=lamb, step_size=step_size, beta=beta,
        friction=friction, inner_threshold=stop_threshold,
        inner_patience=int(stop_patience), distance_fn=distance_fn,
        use_fused_kernels=use_fused_kernels)
    fallback = f"{name}/fallback" in z and int(z[f"{name}/fallback"]) == 1
    feed = build_noise_feed(z, name, n_steps, int(executed), x.shape, fallback=fallback)

    out, x_ref, aux = lanpaint_update(
        denoiser, torch.from_numpy(x),
        latent_image=torch.from_numpy(z[f"{name}/latent"]),
        noise=torch.from_numpy(z[f"{name}/noise"]),
        latent_mask=torch.from_numpy(z[f"{name}/mask"]),
        times=times, n_steps=n_steps, config=config, kind=kind,
        generator=torch.Generator().manual_seed(0),
        noise_feed=torch.from_numpy(feed))

    assert aux.steps_done == int(executed), (
        f"{name}: port ran {aux.steps_done} think iterations, reference ran {int(executed)}")
    np.testing.assert_allclose(x_ref.numpy(), z[f"{name}/x_refined"], rtol=2e-4, atol=2e-4,
                               err_msg=f"{name}: refined latent mismatch")
    np.testing.assert_allclose(out.numpy(), z[f"{name}/out"], rtol=2e-4, atol=2e-4,
                               err_msg=f"{name}: blended x0 mismatch")


def _toy(xm, t, lib, w, g):
    """Nonlinear, time-dependent (x0, x0_big) pair, written once for both."""
    s = t.reshape((-1,) + (1,) * (xm.ndim - 1))
    base = lib.tanh(xm / (1.0 + s)) * w
    return base + g, 0.8 * base - 0.3 * g


@pytest.mark.parametrize("kind", ["eps", "flow"])
@pytest.mark.parametrize("stop", [False, True], ids=["default", "semantic_stop"])
def test_port_matches_jax_engine(kind, stop):
    rng = np.random.default_rng(21 if stop else 20)
    shape = (2, 4, 12, 12)
    n_steps = 4
    x, latent, noise, w, g = (rng.standard_normal(shape).astype(np.float32)
                              for _ in range(5))
    mask = np.zeros(shape, np.float32)
    mask[:, :, :, :5] = 1.0  # known on the left
    sigma = (np.asarray([2.3, 0.9], np.float32) if kind == "eps"
             else np.asarray([0.7, 0.35], np.float32))
    feed = rng.standard_normal((n_steps, 5) + shape).astype(np.float32)
    kw = dict(n_steps=n_steps, record_trace=True)
    if stop:
        kw.update(inner_threshold=0.5, inner_patience=1)
    jk, tk = JKind(kind), ModelKind(kind)

    with jax.default_matmul_precision("highest"):
        jw, jg = jnp.asarray(w), jnp.asarray(g)
        j_out, j_x, j_aux = j_update(
            lambda xm, t: _toy(xm, t, jnp, jw, jg), jnp.asarray(x),
            latent_image=jnp.asarray(latent), noise=jnp.asarray(noise),
            latent_mask=jnp.asarray(mask), sigma=jnp.asarray(sigma),
            times=j_unify(jnp.asarray(sigma), jk), n_steps=jnp.int32(n_steps),
            config=JConfig(**kw), kind=jk, key=jax.random.PRNGKey(0),
            noise_feed=jnp.asarray(feed))

    tw, tg = torch.from_numpy(w), torch.from_numpy(g)
    t_out, t_x, t_aux = lanpaint_update(
        lambda xm, t: _toy(xm, t, torch, tw, tg), torch.from_numpy(x),
        latent_image=torch.from_numpy(latent), noise=torch.from_numpy(noise),
        latent_mask=torch.from_numpy(mask), times=unify_times(torch.from_numpy(sigma), tk),
        n_steps=n_steps, config=LanPaintConfig(**kw), kind=tk,
        generator=torch.Generator().manual_seed(0), noise_feed=torch.from_numpy(feed))

    assert t_aux.steps_done == int(j_aux.steps_done)
    if stop:
        assert 0 < t_aux.steps_done < n_steps, "the case must exercise an early stop"
    np.testing.assert_allclose(t_x.numpy(), np.asarray(j_x), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_aux.trace.numpy(), np.asarray(j_aux.trace),
                               rtol=1e-5, atol=1e-5)


def test_use_fused_kernels_runs_the_fused_plain_versions_on_cpu():
    """On the CPU the flag runs the fused kernels' plain versions
    (ops/fused.py) on the generator's draws; the kernels themselves run on
    the card, in chip_smoke.py."""
    shape = (1, 4, 4, 4)
    zero = torch.zeros(shape)
    out, _, _ = lanpaint_update(
        lambda xm, t: (xm * 0, xm * 0), zero, latent_image=zero, noise=torch.ones(shape),
        latent_mask=torch.ones(shape), times=unify_times(torch.tensor([1.0]), ModelKind.EPS),
        n_steps=1, config=LanPaintConfig(n_steps=1, use_fused_kernels=True),
        kind=ModelKind.EPS)
    assert torch.equal(out, zero)
