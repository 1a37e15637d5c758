"""FLUX.2 [dev] at its published architecture (`models/flux2.py`) held to
the benchmark's plain reference (`portbench/reference/flux2.py`, which
imports neither JAX nor the port) at tiny sizes on the CPU, in float32, on
one seeded draw of the weights: the forward with and without reference
tokens, and a whole LanPaint job through `api.ksampler` followed step by
step by `reference/lanpaint.follow` (the cell's comparison,
`entries/ksampler.py`).  Beside them: the public configuration's size and
shapes, the shared-modulation and SwiGLU counters, the importer's table and
`zoo._materialize` holding a state's tensors in place."""

import dataclasses
import functools
from types import SimpleNamespace

import pytest
import torch

from lanpaint_tpu_torch import telemetry
from lanpaint_tpu_torch.models import flux2, load, zoo
from portbench.harness import compare, files, weights

CELL = "flux2-dev-1248x832.single"
CONFIG = "flux2-dev-1248x832"
# hidden 128, 4 heads of 32, axes (8, 8, 8, 8); the published latent (32
# channels in 2x2 patches) and reference-time coordinate
SIZES = {
    "name": CONFIG, "family": "flux2", "in_channels": 128, "hidden": 128, "num_heads": 4,
    "mlp_ratio": 3.0, "depth_double": 2, "depth_single": 2, "context_dim": 32,
    "axes_dim": [8, 8, 8, 8], "theta": 2000.0, "time_channels": 256, "patch": 2,
    "latent_channels": 32, "ref_time": 10, "shift": 1.15, "guidance": 4.0,
    "dtype": "bfloat16", "latent_shape": [32, 8, 12], "image_size": [64, 96],
    "context_tokens": 8, "ref_tokens": 24}


def _config():
    return files.config_module(CONFIG)


def _fp32(sizes):
    return files.config_of(flux2.Flux2Config, sizes, dtype=torch.float32)


def _draw(shapes, seed, device, dtype=torch.bfloat16):
    """The benchmark's draw with every matrix at std 0.1, not 0.02: at these
    widths 0.02 leaves the blocks' residual contributions (gated by the
    modulation) at ~1e-7 of the output, so a miswired block would pass;
    at 0.1 they move it by percents."""
    return _draw_with(weights.draw, shapes, seed, device, dtype)


MATRIX_SCALE = 5.0


def _pair(sizes=SIZES, seed=3):
    """The reference and the port's fp32 Denoiser on one draw of weights."""
    x0, module = _config().build_reference(sizes)
    state = _draw({k: tuple(v.shape) for k, v in module.state_dict().items()}, seed, "cpu",
                  torch.float32)
    module.load_state_dict(state, assign=True)
    module.requires_grad_(False)
    den, _ = zoo.build_flux2(_fp32(sizes), state, shift=sizes["shift"], device="cpu")
    return x0, den


def test_the_public_configuration():
    """FLUX2_DEV_CONFIG is the published transformer: 8 double and 48
    single blocks, hidden 6,144 in 48 heads of 128, SwiGLU 18,432, context
    15,360, 128 input features, RoPE 4 x 32 at theta 2,000, no bias, 32.22 B
    parameters; the configuration file names the same sizes, and a forward
    at 1248x832 with its reference latent is ~5.76e14 FLOP over S = 8,624."""
    cfg = flux2.FLUX2_DEV_CONFIG
    assert (cfg.depth_double, cfg.depth_single, cfg.hidden, cfg.num_heads, cfg.head_dim,
            cfg.mlp_hidden, cfg.context_dim, cfg.in_channels, cfg.axes_dim, cfg.theta) == (
        8, 48, 6144, 48, 128, 18432, 15360, 128, (32, 32, 32, 32), 2000.0)
    assert sum(cfg.axes_dim) == cfg.head_dim
    with torch.device("meta"):
        module = flux2.Flux2(cfg)
    count = sum(p.numel() for p in module.parameters())
    assert abs(count - 32.22e9) <= 0.005 * 32.22e9
    assert not any(name.endswith("bias") for name, _ in module.named_parameters())
    sizes = files.config_sizes(CONFIG)
    assert files.config_of(flux2.Flux2Config, sizes, dtype=torch.bfloat16) == cfg
    assert sizes["published"]["parameters"] == count
    one = _config().flops(sizes, 1)
    assert 5.70e14 < one < 5.82e14 and _config().flops(sizes, 2) == 2 * one
    assert _config().attention_calls(sizes, 1) == [(1, 48, 8624, 8624, 128, 56)]


@pytest.mark.parametrize("with_ref", [True, False], ids=["ref_tokens", "no_ref"])
@pytest.mark.parametrize("t", [0.9, 0.3])
def test_forward_matches_the_reference(with_ref, t):
    """The port's fp32 forward against the reference's within 2e-5 of its
    L2 norm: both compute in float32; they differ in the RoPE table (the
    port's angles in fp32, the reference's in float64, ~1e-6 at these
    positions) and the LayerNorm variance (one-pass E[x^2] - E[x]^2 against
    two-pass), each a few float32 roundings."""
    x0, den = _pair()
    gen = torch.Generator().manual_seed(1)
    cond = _config().conditioning(SIZES, gen, "cpu")
    if not with_ref:
        cond.pop("ref_tokens")
    x = torch.randn((1, *SIZES["latent_shape"]), generator=gen)
    tt = torch.full((1,), t)
    with torch.no_grad():
        want = x0(x, tt, cond)
        got = den.apply(x, tt, cond)
    assert compare.l2(got - want) / compare.l2(want) < 2e-5


def test_reference_tokens_change_the_output_and_sit_on_their_own_time():
    """The reference tokens join the attention (the output moves with
    them), on RoPE positions (10, y, x, 0) over the target's grid."""
    _, den = _pair()
    gen = torch.Generator().manual_seed(4)
    cond = _config().conditioning(SIZES, gen, "cpu")
    x = torch.randn((1, *SIZES["latent_shape"]), generator=gen)
    t = torch.full((1,), 0.5)
    with torch.no_grad():
        a = den.apply(x, t, cond)
        b = den.apply(x, t, dict(cond, ref_tokens=cond["ref_tokens"] * 2))
    assert compare.l2(a - b) > 1e-2 * compare.l2(a)
    ids = flux2.flux2_ids(1, 8, 12, 3, 24, flux2.TINY_FLUX2_CONFIG)
    assert ids.shape == (1, 3 + 24 + 24, 4)
    assert ids[0, :3].tolist() == [[0, 0, 0, 0], [0, 0, 0, 1], [0, 0, 0, 2]]
    assert ids[0, 3 + 13].tolist() == [0, 2, 1, 0]
    assert ids[0, 3 + 24 + 13].tolist() == [10, 2, 1, 0]


def test_a_whole_job_is_followed_by_the_reference(monkeypatch):
    """A tiny job through the cell's entry (`api.ksampler`, euler simple,
    cfg 1, the reference tokens in the cond), in float32, judged by the
    cell's comparison (`reference/lanpaint.follow`): every checked step
    agrees to float32 rounding and the known region is exact."""
    config = _config()
    monkeypatch.setattr(weights, "draw", functools.partial(_draw_with, weights.draw))
    # the drawn bf16 weights, widened: the reference holds the same values
    monkeypatch.setattr(config, "build_program", lambda sizes, state, device: zoo.build_flux2(
        _fp32(sizes), state, shift=sizes["shift"], device=device))
    entry = files.entry_module("ksampler")
    traffic = dict(files.traffic(CELL), steps=4, think=2, warmup_steps=1)
    ctx = SimpleNamespace(seed=2**32 + 11, device="cpu", config=config, traffic=traffic,
                          sizes=SIZES)
    entry.setup(ctx)
    assert entry.run_job(ctx, 0)
    result = entry.check(ctx)
    assert len(result["steps"]) == 3 and result["steps"][0] == 0 and result["steps"][-1] == 3
    assert result["numbers"]["known_err"] == 0.0
    assert result["numbers"]["step_err"] < 1e-4, result["per_step"]


def _draw_with(draw, shapes, seed, device, dtype=torch.bfloat16):
    state = draw(shapes, seed, device, dtype)
    return {k: v if weights.is_norm_scale(k, v.shape) else v * MATRIX_SCALE
            for k, v in state.items()}


def test_the_counters_read_3_modulations_and_64_swiglus_a_forward():
    """At the published depths (8 + 48 blocks), narrow widths: one forward
    computes the three shared modulations once and SwiGLU 2 x 8 + 48
    times; `telemetry.summary()` carries both counters."""
    cfg = dataclasses.replace(flux2.FLUX2_DEV_CONFIG, hidden=64, num_heads=2, context_dim=16,
                              axes_dim=(8, 8, 8, 8), dtype=torch.float32)
    den, _ = zoo.build_flux2(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    cond = {"context": torch.randn((1, 4, 16), generator=gen),
            "ref_tokens": torch.randn((1, 4, 128), generator=gen)}
    before = telemetry.summary()
    with torch.no_grad():
        den.apply(torch.randn((1, 32, 4, 4), generator=gen), torch.full((1,), 0.5), cond)
    after = telemetry.summary()
    assert after["modulation_calls"] - before["modulation_calls"] == 3
    assert after["swiglu_calls"] - before["swiglu_calls"] == 64
    assert after["modulation_calls"] == flux2.SharedModulation.calls
    assert after["swiglu_calls"] == flux2.swiglu.calls


def _aligned_views(state: dict) -> dict:
    """`state` copied into one flat buffer, each tensor a view at an address
    that is a multiple of `zoo.HELD_ALIGNMENT` (as the benchmark's draw lays
    out a published model's widths on the card)."""
    step = zoo.HELD_ALIGNMENT // 4  # float32 elements
    sizes = {k: -(-v.numel() // step) * step for k, v in state.items()}
    flat = torch.empty(sum(sizes.values()) + step)
    at = (-flat.data_ptr() % zoo.HELD_ALIGNMENT) // 4
    out = {}
    for k, v in state.items():
        out[k] = flat[at:at + v.numel()].view(v.shape).copy_(v)
        at += sizes[k]
    return out


def test_materialize_holds_the_callers_tensors_in_place():
    """A state's tensors on the target device, in the parameters' dtype,
    contiguous and aligned as a fresh allocation (`zoo.HELD_ALIGNMENT`)
    become the parameters themselves (the same storage, no second copy); a
    misaligned one, another dtype, or a non-contiguous one is copied."""
    cfg = dataclasses.replace(flux2.TINY_FLUX2_CONFIG, dtype=torch.float32)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in flux2.Flux2(cfg).state_dict().items()}
    state = _aligned_views(weights.draw(shapes, 5, "cpu", torch.float32))
    odd = "final_layer.linear.weight"
    backing = torch.empty(state[odd].numel() + 1)
    state[odd] = backing[1:].view(shapes[odd]).copy_(state[odd])  # 4 bytes off alignment
    assert state[odd].data_ptr() % 16
    half = "img_in.weight"
    state[half] = state[half].bfloat16()
    wide = "txt_in.weight"
    state[wide] = state[wide].t().contiguous().t()
    assert not state[wide].is_contiguous()
    _, module = zoo.build_flux2(cfg, state, device="cpu")
    params = dict(module.named_parameters())
    copied = {odd, half, wide}
    for k, v in state.items():
        held = params[k].data_ptr() == v.data_ptr()
        assert held == (k not in copied), k
        assert torch.equal(params[k], v.float())
    assert params[odd].data_ptr() % 16 == 0 and params[half].dtype == torch.float32
    assert all(not p.requires_grad for p in params.values())


def test_a_mesh_build_is_not_ported():
    with pytest.raises(NotImplementedError, match="FLUX.2"):
        zoo.build_flux2(flux2.TINY_FLUX2_CONFIG, device="cpu", mesh=object())


def test_the_import_table_checks_the_keys():
    """`import_flux2` takes the published key names (`double_blocks`,
    `.scale` for the q / k norms, `adaLN_modulation.1`) to the module's
    state_dict, and a file whose keys differ raises with the census before
    any tensor is taken."""
    cfg = flux2.TINY_FLUX2_CONFIG
    _, module = zoo.build_flux2(cfg, device="cpu", seed=2)
    sd = module.state_dict()
    ckpt = {k: sd[m] for k, m in load._flux2_entries(cfg)}
    assert set(ckpt) == load.flux2_expected_keys(cfg)
    assert {"double_blocks.1.txt_attn.norm.key_norm.scale", "single_blocks.0.linear1.weight",
            "final_layer.adaLN_modulation.1.weight", "single_stream_modulation.lin.weight",
            "time_in.in_layer.weight"} <= set(ckpt)
    back = load.import_flux2(ckpt, cfg)
    assert sorted(back) == sorted(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    ckpt.pop("img_in.weight")
    with pytest.raises(ValueError, match="img_in.weight"):
        load.import_flux2(ckpt, cfg)
