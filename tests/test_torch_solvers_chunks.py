"""deis and dpm_fast through the port's `LanPaintSampler` against the JAX
package, and chunked runs against one run.

1. deis and dpm_fast on the tiny UNet in fp32, as
   tests/test_torch_solvers_staged.py checks the multi-stage solvers (the
   same inputs and limit): deis reads its coefficient rows, dpm_fast runs
   its own uniform-t grid, each call taking the step of its nearest ladder
   sigma.
2. A chunked run equals one run bit for bit on the CPU for deis, heunpp2,
   dpmpp_3m_sde and dpm_fast: the full ladder's table rows sliced per
   segment, the solver carry threaded on, dpm_fast's launches cut at its
   group boundaries (lanpaint_tpu/api.py:344-360).
"""

import pytest
import torch

from lanpaint_tpu_torch import LanPaintConfig, LanPaintSampler
from lanpaint_tpu_torch import api as tapi
from lanpaint_tpu_torch import samplers as tsamplers
from lanpaint_tpu_torch.sigmas import calculate_sigmas
from test_torch_solvers_staged import (check_against_jax, inputs, models,  # noqa: F401
                                      one_thread)


@pytest.mark.parametrize("name", ["deis", "dpm_fast"])
def test_solver_through_sampler_matches_jax(models, inputs, monkeypatch, name):  # noqa: F811
    check_against_jax(models, inputs, monkeypatch, name)


@pytest.mark.parametrize("name,chunk", [("deis", 2), ("heunpp2", 2), ("dpmpp_3m_sde", 3),
                                        ("dpm_fast", 1), ("dpm_fast", 3)])
def test_chunked_run_equals_one_run(models, inputs, name, chunk):
    _, tden = models
    calls = {}
    for chunk_steps in (None, chunk):
        calls[chunk_steps] = []
        sam = LanPaintSampler(tden, config=LanPaintConfig(n_steps=2), sampler_name=name,
                              cfg=5.0, sequential_cfg=True, return_aux=True,
                              callback=lambda i, den, x, _c=calls[chunk_steps]: _c.append(i))
        out = sam(latent=torch.from_numpy(inputs["latent"]),
                  sigmas=calculate_sigmas(tden.sigma_table, "karras", 7),
                  mask=torch.from_numpy(inputs["mask"]), seed=9, chunk_steps=chunk_steps,
                  cond={"context": torch.from_numpy(inputs["ctx"])},
                  uncond={"context": torch.from_numpy(inputs["unctx"])})
        calls[chunk_steps].append(out)
    (*idx_one, one), (*idx_chunked, chunked) = calls[None], calls[chunk]
    assert idx_one == idx_chunked
    for a, b in zip(one[:2], chunked[:2]):
        assert torch.equal(a, b), name
    assert torch.equal(one[2].steps_done, chunked[2].steps_done)


def test_dpm_fast_chunks_snap_to_groups():
    # 7 steps: 6 grid steps as groups of 3, 2, 1 (k-diffusion's grouping)
    assert tsamplers.dpm_fast_groups(7) == [3, 2, 1]
    assert tapi._dpm_fast_ranges(7, 7) == [(0, 3, True)]
    assert tapi._dpm_fast_ranges(7, 1) == [(0, 1, False), (1, 2, False), (2, 3, True)]
    assert tapi._dpm_fast_ranges(7, 3) == [(0, 1, False), (1, 3, True)]
    assert tapi._dpm_fast_ranges(7, 5) == [(0, 2, False), (2, 3, True)]
