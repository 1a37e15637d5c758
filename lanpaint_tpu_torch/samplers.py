"""Outer denoising solvers as a host-side Python loop.

PyTorch counterpart of `lanpaint_tpu/samplers.py`.  The contract differs
from stock k-diffusion the same way: the model callback returns
`(denoised, x_new)` and the solver continues from `x_new`, the
Langevin-refined iterate (the reference's in-place `input_x.copy_`,
lanpaint.py:122).

ModelFn signature: (x, sigma, step) -> (denoised, x_new), where `sigma` is
the host np.float32 ladder value and `step` the outer step index (the loop
counter replaces the JAX package's argmin over the ladder).

Only euler is ported; `get_solver` names each solver still to port.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

ModelFn = Callable[[torch.Tensor, np.float32, int], Tuple[torch.Tensor, torch.Tensor]]

# Every solver name the JAX package registers (lanpaint_tpu/samplers.py).
SAMPLER_NAMES = [
    "euler", "euler_ancestral", "heun", "heunpp2", "dpm_2", "dpm_2_ancestral",
    "ddpm", "dpmpp_2m", "dpmpp_2m_sde", "dpmpp_2m_sde_gpu", "dpmpp_3m_sde",
    "dpmpp_3m_sde_gpu", "dpmpp_sde", "dpmpp_sde_gpu", "res_multistep",
    "res_multistep_ancestral", "seeds_2", "seeds_3", "er_sde",
    "gradient_estimation", "deis", "dpm_fast",
]


class SolverCarry(NamedTuple):
    x: torch.Tensor
    hist1: torch.Tensor   # previous denoised (multistep slot 1)
    hist2: torch.Tensor   # slot 2 (3m methods)
    h1: float             # previous log-step h
    h2: float             # h before that
    nhist: int            # number of valid history entries


def init_carry(x: torch.Tensor) -> SolverCarry:
    """Fresh solver state for a ladder starting at latent `x`."""
    zero = torch.zeros_like(x)
    return SolverCarry(x=x, hist1=zero, hist2=zero, h1=0.0, h2=0.0, nhist=0)


def _to_d(x, sigma, denoised):
    return (x - denoised) / float(np.maximum(np.float32(sigma), np.float32(1e-10)))


def _euler(model: ModelFn, c: SolverCarry, s, sn, i: int, generator=None):
    den, x = model(c.x, s, i)
    x = x + _to_d(x, s, den) * float(np.float32(sn) - np.float32(s))
    return c._replace(x=x), den


_SOLVERS = {"euler": _euler}


def get_solver(name: str):
    if name in _SOLVERS:
        return _SOLVERS[name]
    if name in SAMPLER_NAMES:
        raise NotImplementedError(
            f"sampler {name!r} is not ported to lanpaint_tpu_torch yet; "
            f"ported: {sorted(_SOLVERS)}")
    raise ValueError(f"unknown sampler {name!r}; available: {sorted(SAMPLER_NAMES)}")


def sample(
    model: ModelFn,
    noise_x: torch.Tensor,
    sigmas,
    *,
    sampler: str = "euler",
    generator: torch.Generator = None,
):
    """Run the outer sampling loop.

    `noise_x` is the initial latent AFTER initial noise scaling (reference
    nodes.py:221); `sigmas` the host [steps+1] descending ladder.  Returns
    (samples, all_denoised) with all_denoised[i] the x0 prediction of step i.
    """
    step_fn = get_solver(sampler)
    sigmas = np.asarray(sigmas, dtype=np.float32)
    carry = init_carry(noise_x)
    dens = []
    for i in range(sigmas.shape[0] - 1):
        carry, den = step_fn(model, carry, sigmas[i], sigmas[i + 1], i, generator)
        dens.append(den)
    if not dens:
        return carry.x, noise_x.new_zeros((0,) + tuple(noise_x.shape))
    return carry.x, torch.stack(dens)
