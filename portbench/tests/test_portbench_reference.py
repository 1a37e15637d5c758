"""The plain reference held to the port at tiny sizes on the CPU, in
float32: the UNet and the MMDiT forwards, the sigma ladders, the latent
mask, and whole LanPaint jobs (think loop, CFG, euler, the known-region
blend and the replayed draws) followed step by step.  Only these tests
import the port beside the reference; at run time the reference never
calls it."""

import numpy as np
import pytest
import torch

from portbench.harness import compare, files, weights
from portbench.reference import lanpaint as ref
from portbench.tests import tiny


def _port_fp32(name, sizes, state):
    """The port's Denoiser of `sizes`, computing in float32."""
    from lanpaint_tpu_torch.models import dit, unet, zoo

    if name == "sdxl-1024":
        return zoo.build_unet(files.config_of(unet.UNetConfig, sizes, dtype=torch.float32),
                              state, device="cpu")[0]
    return zoo.build_dit(files.config_of(dit.DiTConfig, sizes, dtype=torch.float32), state,
                         shift=sizes["shift"], device="cpu")[0]


def _pair(name, seed=3):
    config, sizes = files.config_module(name), tiny.SIZES[name]
    x0, module = config.build_reference(sizes)
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    state = weights.draw(shapes, seed, "cpu", torch.float32)
    module.load_state_dict(state, assign=True)
    module.requires_grad_(False)
    return config, sizes, x0, _port_fp32(name, sizes, state)


def _cond(config, sizes, seed):
    gen = torch.Generator().manual_seed(seed)
    return config.conditioning(sizes, gen, "cpu")


@pytest.mark.parametrize("name", list(tiny.SIZES))
@pytest.mark.parametrize("t", [0.9, 0.3])
def test_forward_matches_the_port(name, t):
    config, sizes, x0, port = _pair(name)
    cond = _cond(config, sizes, 1)
    x = torch.randn((1, *sizes["latent_shape"]), generator=torch.Generator().manual_seed(2))
    tt = torch.full((1,), t if config.KIND == "flow" else 14.6 * t)
    with torch.no_grad():
        want = x0(x, tt, x0.prepare(cond))
        got = port.apply(x, tt, cond)
    assert compare.l2(got - want) / compare.l2(want) < 2e-5


@pytest.mark.parametrize("scheduler,steps", [("karras", 20), ("simple", 20), ("karras", 7)])
def test_ladders(scheduler, steps):
    from lanpaint_tpu_torch import sigmas

    eps = files.config_module("sdxl-1024").sigma_table(tiny.SIZES["sdxl-1024"])
    flow = files.config_module("flux-dev-1024").sigma_table(tiny.SIZES["flux-dev-1024"])
    for table, port in ((eps, sigmas.EpsSigmaTable()), (flow, sigmas.FlowSigmaTable(1.15))):
        np.testing.assert_allclose(ref.ladder(scheduler, steps, table),
                                   sigmas.calculate_sigmas(port, scheduler, steps), rtol=1e-6)


def test_latent_mask():
    from lanpaint_tpu_torch.masks import prepare_mask

    mask = torch.zeros((128, 96))
    mask[24:88, 8:72] = 1.0
    shape = (2, 4, 16, 12)
    want = 1.0 - (prepare_mask(mask, shape) > 0.5).float()
    assert torch.equal(ref.latent_mask(mask, shape), want)


@pytest.mark.parametrize("name", list(tiny.SIZES))
def test_whole_job_followed_step_by_step(name):
    """Every outer step of a port job in float32, followed by the reference
    from the port's own states (step 0 from the reference's own), agrees
    to float32 rounding; the known region is exact."""
    from lanpaint_tpu_torch import api

    config, sizes, x0, port = _pair(name)
    t = tiny.traffic(files.cell(tiny.CELLS[name], files.benchmark())["name"])
    gen = torch.Generator().manual_seed(5)
    latent = torch.randn((1, *sizes["latent_shape"]), generator=gen)
    mask = torch.zeros(tuple(sizes["image_size"]))
    mask[32:96, 16:80] = 1.0
    cond = _cond(config, sizes, 6)
    uncond = None if t["cfg"] == 1.0 else _cond(config, sizes, 7)
    record = []
    api.ksampler(port, seed=2**32 + 9, steps=t["steps"], cfg=t["cfg"], sampler_name="euler",
                 scheduler=t["scheduler"], positive=cond, negative=uncond, latent=latent,
                 mask=mask, num_steps=t["think"],
                 callback=lambda i, den, x: record.append((den, x)))
    table = config.sigma_table(sizes)
    job = dict(latent=latent, mask=mask, cond=cond, uncond=uncond, seed=2**32 + 9,
               kind=config.KIND, sigmas=ref.ladder(t["scheduler"], t["steps"], table),
               sigma_max=float(table[-1]), n_steps=t["think"], cfg=t["cfg"],
               cfg_big=config.cfg_big(t["cfg"]))
    result = compare.judge(x0, job, record, list(range(t["steps"])))
    assert result["numbers"]["known_err"] == 0.0
    assert result["numbers"]["step_err"] < 1e-4, result["per_step"]
