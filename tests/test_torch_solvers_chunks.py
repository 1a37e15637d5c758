"""deis and dpm_fast through the port's `LanPaintSampler` against the JAX
package, and the port's one run against the JAX package's chunked runs.

1. deis and dpm_fast on the tiny UNet in fp32, as
   tests/test_torch_solvers_staged.py checks the multi-stage solvers (the
   same inputs and limit): deis reads its coefficient rows, dpm_fast runs
   its own uniform-t grid, each call taking the step of its nearest ladder
   sigma.
2. The JAX package runs a ladder as segments of `chunk_steps` outer steps
   (one compiled launch each, lanpaint_tpu/api.py:340-420); the port runs
   every ladder in one loop.  For deis, heunpp2, dpmpp_3m_sde and dpm_fast
   the port's one run equals the JAX package's chunked run, at the same
   inputs and limit, over a 7-step ladder: dpm_fast's 6 grid steps fall
   into groups of 3, 2 and 1, which its segments keep whole.  heunpp2 takes
   one feed row for every step: its third stage, at sigma_{i+2}, lies past
   the end of a segment's ladder whenever i is a segment's last step but
   one, and the JAX package's chunked run then gives it the segment's last
   step and feed row where its one run gives it step i + 2, so with a
   random row per step the JAX package's own chunked run leaves its one run
   from step 2 on (tests/test_torch_solvers_staged.py holds the port's
   heunpp2 against the JAX package's one run with a random row per step).
"""

import numpy as np
import pytest

from test_torch_solvers_staged import (SHAPE, check_against_jax, inputs, models,  # noqa: F401
                                      one_thread)


@pytest.fixture(scope="module")
def inputs_7(inputs):  # noqa: F811
    """`inputs` with a think-noise feed for a 7-step ladder."""
    feed = np.random.default_rng(32).standard_normal((7, 2, 5) + SHAPE).astype(np.float32)
    return dict(inputs, feed=feed)


@pytest.mark.parametrize("name", ["deis", "dpm_fast"])
def test_solver_through_sampler_matches_jax(models, inputs, monkeypatch, name):  # noqa: F811
    check_against_jax(models, inputs, monkeypatch, name)


@pytest.mark.parametrize("name,chunk", [("deis", 2), ("heunpp2", 2), ("dpmpp_3m_sde", 3),
                                        ("dpm_fast", 1), ("dpm_fast", 3)])
def test_chunked_run_equals_one_run(models, inputs_7, monkeypatch, name, chunk):  # noqa: F811
    inputs = inputs_7
    if name == "heunpp2":
        feed = inputs["feed"]
        inputs = dict(inputs, feed=np.broadcast_to(feed[:1], feed.shape).copy())
    check_against_jax(models, inputs, monkeypatch, name, chunk_steps=chunk)
