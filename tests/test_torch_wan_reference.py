"""The port's Wan2.2 TI2V-5B path held to the benchmark's plain reference
(`portbench/reference/wan.py`, `wan_vae.py`) at tiny sizes on the CPU, in
float32, on one seeded draw of the weights: the DiT forward, the VAE's
whole-clip encode and decode against the reference's chunk-by-chunk causal
form, and a whole `inpaint_video` job followed step by step by the
reference through the video cell's comparison (`entries/inpaint_video.py`,
`harness/video.py`)."""

from types import SimpleNamespace

import pytest
import torch

from lanpaint_tpu_torch.models import video_vae, wan, zoo
from portbench.harness import compare, files, weights

CELL = "wan22-ti2v-5b.video"
SIZES = {
    "name": "wan22-ti2v-5b", "family": "wan", "in_channels": 4, "out_channels": 4,
    "hidden": 64, "num_heads": 4, "depth": 2, "ffn_dim": 128, "context_dim": 32,
    "patch": [1, 2, 2], "axes_dim": [8, 4, 4], "eps": 1e-6, "shift": 5.0, "dtype": "bfloat16",
    "num_frames": 5, "height": 64, "width": 64, "context_tokens": 8,
    "vae": {"dim": 8, "z_channels": 4, "dim_mult": [1, 2, 2], "num_res_blocks": 1,
            "temporal_downsample": [True, False], "patch": 2, "stage_shortcuts": True},
    "latent_shape": [4, 3, 8, 8]}


def _config():
    return files.config_module("wan22-ti2v-5b")


def _fp32_configs(sizes):
    """The port's configurations of `sizes`, computing in float32."""
    return (files.config_of(wan.WanConfig, sizes, dtype=torch.float32),
            files.config_of(video_vae.WanVAEConfig, sizes["vae"], dtype=torch.float32,
                            latents_mean=None, latents_std=None))


def _loaded(module, state):
    module.load_state_dict(state, assign=True)
    return module.requires_grad_(False)


def _dit_pair(seed=3):
    x0, module = _config().build_reference(SIZES)
    state = weights.draw({k: tuple(v.shape) for k, v in module.state_dict().items()}, seed,
                         "cpu", torch.float32)
    _loaded(module, state)
    return x0, zoo.build_wan(_fp32_configs(SIZES)[0], state, shift=SIZES["shift"],
                             device="cpu")[0]


def _vae_pair(seed=4):
    config = _config()
    module = config.build_reference_vae(SIZES)
    state = config.draw_vae({k: tuple(v.shape) for k, v in module.state_dict().items()}, seed,
                            "cpu")
    _loaded(module, state)
    return module, zoo.build_wan_vae(_fp32_configs(SIZES)[1], state, device="cpu")


def test_the_published_sizes_are_the_ports_named_configurations():
    """The configuration file builds WAN22_TI2V_5B_CONFIG and WAN22_VAE_CONFIG,
    and one batch-1 forward is ~93.4 TFLOP (GEMMs 68.8, self-attention 23.1,
    cross-attention 1.5; the text embedding and cross k / v, hoisted to once a
    job, left out)."""
    config = _config()
    sizes = files.config_sizes("wan22-ti2v-5b")
    assert config.program_configs(sizes) == (wan.WAN22_TI2V_5B_CONFIG,
                                             video_vae.WAN22_VAE_CONFIG)
    one = config.flops(sizes, 1)
    assert 93.3e12 < one < 93.5e12 and config.flops(sizes, 2) == 2 * one
    assert config.attention_calls(sizes, 2) == [(2, 24, 7920, 7920, 128, 30)]


@pytest.mark.parametrize("t", [0.95, 0.4])
def test_dit_forward_matches_the_reference(t):
    x0, port = _dit_pair()
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((2, *SIZES["latent_shape"]), generator=gen)
    cond = {"context": torch.randn((2, SIZES["context_tokens"], SIZES["context_dim"]),
                                   generator=gen)}
    tt = torch.tensor([t, t / 2])
    with torch.no_grad():
        want = x0(x, tt, cond)
        got = port.apply(x, tt, port.precompute(cond))
    assert compare.l2(got - want) / compare.l2(want) < 2e-5


@pytest.mark.parametrize("frames", [1, 7])
def test_vae_matches_the_chunked_reference(frames):
    """The port's whole-clip causal VAE against the reference's first frame
    alone, then chunks of the temporal stride, each causal convolution fed
    its cache: encode, and decode of a latent of every frame count."""
    ref, port = _vae_pair()
    gen = torch.Generator().manual_seed(5)
    clip = torch.rand((1, 3, frames, 64, 48), generator=gen) * 2 - 1
    with torch.no_grad():
        z_port, z_ref = port.encode(clip), ref.encode(clip)
        assert z_port.shape == z_ref.shape == (1, 4, (frames - 1) // 2 + 1, 8, 6)
        assert compare.l2(z_port - z_ref) / compare.l2(z_ref) < 1e-5
        z = torch.randn(z_ref.shape, generator=gen)
        x_port, x_ref = port.decode(z), ref.decode(z)
    assert x_port.shape == x_ref.shape == clip.shape
    assert compare.l2(x_port - x_ref) / compare.l2(x_ref) < 1e-5


def test_a_whole_video_job_is_followed_by_the_reference(monkeypatch):
    """A tiny job through the cell's entry (`api.inpaint_video`), in float32,
    judged by the cell's comparison: every checked step agrees to float32
    rounding, the known region and the pixels beyond the blend are exact."""
    config = _config()
    monkeypatch.setattr(config, "program_configs", _fp32_configs)
    entry = files.entry_module("inpaint_video")
    traffic = dict(files.traffic(CELL), steps=4, think=2, warmup_steps=1)
    ctx = SimpleNamespace(seed=2**32 + 9, device="cpu", config=config, traffic=traffic,
                          sizes=SIZES)
    entry.setup(ctx)
    assert entry.run_job(ctx, 0)
    result = entry.check(ctx)
    numbers = result["numbers"]
    assert result["steps"] == [0, 1, 3] or result["steps"] == [0, 2, 3]
    assert numbers["known_err"] == 0.0 and numbers["blend_err"] == 0.0
    assert numbers["step_err"] < 1e-4, result["per_step"]
    assert numbers["encode_err"] < 1e-5 and numbers["decode_err"] < 1e-5
