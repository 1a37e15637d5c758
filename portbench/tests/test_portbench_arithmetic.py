"""The analytic work of each configuration against PyTorch's own count on
the plain reference, the attention bound, the seeds and the weights."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness import files, peaks, seeds, weights
from portbench.reference import nn as rnn
from portbench.tests import tiny


def _reference(name):
    config = files.config_module(name)
    sizes = tiny.SIZES[name]
    x0, module = config.build_reference(sizes)
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    module.load_state_dict(weights.draw(shapes, 7, "cpu", torch.float32), assign=True)
    module.requires_grad_(False)
    return config, sizes, x0, module


def _inputs(config, sizes, batch):
    gen = torch.Generator().manual_seed(0)
    cond = config.conditioning(sizes, gen, "cpu")
    cond = {k: v.expand(batch, *v.shape[1:]) for k, v in cond.items()}
    x = torch.randn((batch, *sizes["latent_shape"]), generator=gen)
    return x, cond


@pytest.mark.parametrize("name", list(tiny.SIZES))
@pytest.mark.parametrize("batch", [1, 2])
def test_flops_match_flop_counter(name, batch):
    config, sizes, x0, module = _reference(name)
    x, cond = _inputs(config, sizes, batch)
    cond = x0.prepare(cond)  # the cross-attention k | v: once a job, not counted
    t = torch.full((batch,), 0.5)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        x0(x, t, cond)
    assert config.flops(sizes, batch) == counter.get_total_flops()


@pytest.mark.parametrize("name", list(tiny.SIZES))
def test_attention_calls_are_the_forward_self_attention(name, monkeypatch):
    config, sizes, x0, module = _reference(name)
    x, cond = _inputs(config, sizes, 2)
    seen = {}
    plain = rnn.attention

    def spy(q, k, v):
        if k.shape[1] == q.shape[1]:
            b, s, h, d = q.shape
            seen[(b, h, s, s, d)] = seen.get((b, h, s, s, d), 0) + 1
        return plain(q, k, v)

    monkeypatch.setattr(rnn, "attention", spy)
    with torch.no_grad():
        x0(x, torch.full((2,), 0.5), x0.prepare(cond))
    assert sorted(config.attention_calls(sizes, 2)) == sorted(k + (n,) for k, n in seen.items())


def test_full_size_work():
    """The published configurations' numbers, for the record."""
    sdxl, flux = (files.config_module(n) for n in ("sdxl-1024", "flux-dev-1024"))
    s_sdxl, s_flux = files.config_sizes("sdxl-1024"), files.config_sizes("flux-dev-1024")
    assert round(sdxl.flops(s_sdxl, 2) / 1e12, 3) == 13.418
    assert round(flux.flops(s_flux, 1) / 1e12, 3) == 74.385
    assert sdxl.attention_calls(s_sdxl, 2) == [(2, 10, 4096, 4096, 64, 10),
                                               (2, 20, 1024, 1024, 64, 60)]
    assert flux.attention_calls(s_flux, 1) == [(1, 24, 4608, 4608, 128, 57)]


def test_attention_bound():
    # Flux's (1, 4608, 24, 128): 2.609e11 operations at 989 TFLOP/s bound it
    b, h, s, d = 1, 24, 4608, 128
    assert peaks.attention_ops(b, h, s, s, d) == 4 * b * h * s * s * d
    assert peaks.attention_bytes(b, h, s, s, d) == 2 * b * h * d * 4 * s
    assert peaks.attention_bound_s([(b, h, s, s, d, 1)]) == pytest.approx(263.8e-6, rel=1e-3)
    # a short sequence is bound by its bytes
    n_bytes = peaks.attention_bytes(1, 1, 64, 64, 64)
    assert peaks.bound_s(peaks.attention_ops(1, 1, 64, 64, 64), n_bytes) == n_bytes / 3.35e12
    assert peaks.attention_bound_s([(b, h, s, s, d, 3)]) == pytest.approx(
        3 * peaks.attention_bound_s([(b, h, s, s, d, 1)]))


def test_seeds_are_stable_and_distinct():
    big = 2**31 + 12345
    assert seeds.derive(big, "job", 3) == seeds.derive(big, "job", 3)
    assert len({seeds.derive(big, "job", i) for i in range(50)}) == 50
    assert seeds.derive(big, "weights") != seeds.derive(big + 1, "weights")
    assert 0 <= seeds.derive(2**40, "x") < 2**63


def test_weights_draw():
    shapes = {"a.weight": (3, 4), "a.bias": (3,), "n.weight": (5,), "k": (2, 2, 3)}
    w = weights.draw(shapes, 2**31 + 5, "cpu", torch.float32)
    again = weights.draw(shapes, 2**31 + 5, "cpu", torch.float32)
    assert all(torch.equal(w[k], again[k]) and tuple(w[k].shape) == shapes[k] for k in shapes)
    assert (w["n.weight"] - 1).abs().max() < 0.2 and w["a.bias"].abs().max() < 0.2
    assert w["a.weight"].abs().max() < 0.2 and w["a.weight"].std() > 0.005
