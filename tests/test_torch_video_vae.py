"""The port's Wan video VAE (lanpaint_tpu_torch.models.video_vae) and the
video VAE's mid-attention route (D = 384 / 640), against the JAX package.

Weights come from one flax parameter tree carried across by
`models.bridge.wan_vae_params_from_flax`; inputs from numpy.  Both sides run
on the CPU, where JAX's attention takes XLA's plain path and the port's
wrappers take `attention_ref`.

Tolerances:
* encode and decode in fp32: 1e-4 of the compared tensor's largest value
  (the frameworks sum 3D convolutions in different orders);
* the pure data movements (`_avg_down3d`, `_dup_up3d`, `_patchify` /
  `_unpatchify`, the upsample's frame interleave): bit-exact, on
  integer-valued inputs whose group means and 0/1-weight convolutions are
  exact in any summation order;
* attention through the router: 1e-5 (the same fp32 softmax on both sides);
* the stochastic encode: standardized draws have mean 0 within 0.1 and
  standard deviation 1 within 5% over >= 8,192 samples (4 sigma of the
  sampling error);
* the normalization convention: 1e-5 relative.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanpaint_tpu.models import video_vae as jvv
from lanpaint_tpu.models.layers import attention_bshd as j_attention
from lanpaint_tpu_torch.models import layers as tlayers
from lanpaint_tpu_torch.models import video_vae as tvv
from lanpaint_tpu_torch.models import zoo as tzoo
from lanpaint_tpu_torch.models.bridge import flax_entries, wan_vae_params_from_flax
from lanpaint_tpu_torch.ops import attention as tattn

# the Wan2.1 structure with the public normalization (its first 4 channels),
# and the Wan2.2 structure (patch 2, stage shortcuts, no normalization)
CONFIGS = {
    "wan21": ("TINY_WAN_VAE_CONFIG", dict(latents_mean=jvv.WAN21_LATENTS_MEAN[:4],
                                          latents_std=jvv.WAN21_LATENTS_STD[:4])),
    "wan22": ("TINY_WAN22_VAE_CONFIG", {}),
}
SIDE = {"wan21": 16, "wan22": 32}  # pixel side: 8 and 4 latent pixels


def _configs(name, dtype="fp32"):
    base, extra = CONFIGS[name]
    jcfg = dataclasses.replace(getattr(jvv, base), dtype=jnp.float32, **extra)
    tcfg = dataclasses.replace(getattr(tvv, base), **extra,
                               dtype=torch.float32 if dtype == "fp32" else torch.bfloat16)
    return jcfg, tcfg


def random_tree(tree, seed):
    """Well-conditioned random weights in the flax tree's shapes: kernels
    N(0, 1/fan_in), biases N(0, 0.1^2), RMS gammas 1 + N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name, shape = path[-1].key, np.shape(a)
        if name == "gamma":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "bias":
            v = 0.1 * rng.standard_normal(shape)
        else:
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


@functools.lru_cache(maxsize=None)
def flax_vae(name, seed=11):
    """(flax module, random tree) of one tiny config in fp32 (built once
    per process; the tree's arrays are only read)."""
    jcfg, _ = _configs(name)
    module = jvv.WanVAE(jcfg)
    side = SIDE[name]
    tree = jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 3, 5, side, side)))
    return module, random_tree(tree, seed)


def port_vae(name, tree, dtype="fp32"):
    return tzoo.build_wan_vae(_configs(name, dtype)[1], wan_vae_params_from_flax(tree),
                              device="cpu")


@pytest.fixture(scope="module", params=[(n, t) for n in CONFIGS for t in (5, 1)],
                ids=[f"{n}-T{t}" for n in CONFIGS for t in (5, 1)])
def vae_case(request):
    """(name, flax module, tree, pixels, JAX encode, JAX decode of it)."""
    name, frames = request.param
    module, tree = flax_vae(name)
    side = SIDE[name]
    rng = np.random.default_rng(4)
    x = np.tanh(rng.standard_normal((2, 3, frames, side, side))).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        z = jax.jit(lambda p, x: module.apply(p, x, method="encode"))(tree, jnp.asarray(x))
        y = jax.jit(lambda p, z: module.apply(p, z, method="decode"))(tree, z)
    return name, module, tree, x, np.asarray(z), np.asarray(y)


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_wan_vae_bridge_covers_every_parameter(name):
    _, tree = flax_vae(name)
    state = wan_vae_params_from_flax(tree)
    want = tvv.WanVAE(_configs(name)[1]).state_dict()
    assert sorted(state) == sorted(want)
    for k, v in state.items():
        assert tuple(v.shape) == tuple(want[k].shape), k


@pytest.mark.parametrize("name", ["WAN21_VAE_CONFIG", "WAN22_VAE_CONFIG"])
def test_full_size_wan_vae_bridge_maps_every_key_without_allocating(name):
    shapes = jax.eval_shape(jvv.WanVAE(getattr(jvv, name)).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 3, 1, 32, 32)))
    tree = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    shape_of = {key: tuple(arr.shape) for key, arr in flax_entries(tree)}
    with torch.device("meta"):
        module = tvv.WanVAE(getattr(tvv, name))
    assert shape_of == {k: tuple(p.shape) for k, p in module.state_dict().items()}


def test_wan_vae_encode_decode_match_flax(vae_case):
    """The normalized posterior mean, the decode of the JAX latent and the
    round trip, at T = 5 and the image case T = 1."""
    name, _, tree, x, z, y = vae_case
    vae = port_vae(name, tree)
    with torch.no_grad():
        got_z = vae.encode(torch.from_numpy(x))
        got_y = vae.decode(torch.from_numpy(z))
        got_round = vae(torch.from_numpy(x))
    assert got_z.dtype == got_y.dtype == torch.float32  # the fp32 heads
    assert got_z.shape == z.shape and got_y.shape == y.shape == x.shape
    assert z.shape[2] == (x.shape[2] - 1) // 2 + 1  # 1 + 4k frames -> 1 + k (tiny: 2x)
    _close(got_z.numpy(), z)
    _close(got_y.numpy(), y)
    _close(got_round.numpy(), y)


def test_wan_vae_bf16_is_close_to_fp32(vae_case):
    name, _, tree, x, z, y = vae_case
    vae = port_vae(name, tree, "bf16")
    with torch.no_grad():
        got_z = vae.encode(torch.from_numpy(x)).numpy()
        got_y = vae.decode(torch.from_numpy(z)).numpy()
    for got, want in ((got_z, z), (got_y, y)):
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 3e-2, f"bf16 relative L2 error {rel:.3g} > 3e-2"


def test_wan_vae_normalization_round_trip():
    """encode gives (mean - m) / s per channel and decode inverts it: the
    same weights without normalization give the raw mean and the same
    decoded video."""
    _, tree = flax_vae("wan21")
    vae = port_vae("wan21", tree)
    _, tcfg = _configs("wan21")
    plain = tvv.WanVAE(dataclasses.replace(tcfg, latents_mean=None, latents_std=None))
    plain.load_state_dict(vae.state_dict())
    x = torch.from_numpy(np.tanh(np.random.default_rng(8).standard_normal((1, 3, 5, 16, 16)))
                         .astype(np.float32))
    with torch.no_grad():
        z, raw = vae.encode(x), plain.encode(x)
        m = torch.tensor(tcfg.latents_mean).reshape(1, -1, 1, 1, 1)
        s = torch.tensor(tcfg.latents_std).reshape(1, -1, 1, 1, 1)
        np.testing.assert_allclose(z.numpy(), ((raw - m) / s).numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(vae.decode(z).numpy(), plain.decode(raw).numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_wan_vae_stochastic_encode_statistics():
    """encode(x, generator) samples mean + exp(logvar / 2) * eps with the
    log-variance clipped to [-30, 20]: seeded draws repeat, standardized
    draws are N(0, 1), also where the clip is in force."""
    _, tree = flax_vae("wan22")
    vae = port_vae("wan22", tree)
    zc = vae.cfg.z_channels
    xt = torch.from_numpy(np.tanh(np.random.default_rng(9).standard_normal((2, 3, 5, 32, 32)))
                          .astype(np.float32))
    last = vae.quant_conv.conv
    with torch.no_grad():
        mean = vae.encode(xt)
        a = vae.encode(xt, torch.Generator().manual_seed(1))
        assert torch.equal(a, vae.encode(xt, torch.Generator().manual_seed(1)))
        assert not torch.equal(a, vae.encode(xt, torch.Generator().manual_seed(2)))
        for clip in (False, True):
            logvar = vae.quant_conv(vae.encoder(
                xt.permute(0, 2, 3, 4, 1).contiguous())).permute(0, 4, 1, 2, 3)[:, zc:]
            logvar = torch.clamp(logvar, -30.0, 20.0)
            if clip:
                assert float(logvar.min()) == 20.0
            gen = torch.Generator().manual_seed(3)
            draws = torch.stack([vae.encode(xt, gen) for _ in range(22)])
            eps = (draws - mean) / torch.exp(0.5 * logvar)
            assert eps.numel() >= 8192
            assert abs(float(eps.mean())) < 0.1 and abs(float(eps.std()) - 1.0) < 0.05, clip
            last.bias[zc:] += 100.0  # push every log-variance above the clip


# -- the pure data movements, bit for bit ---------------------------------------


def _ints(shape, seed):
    return np.random.default_rng(seed).integers(-64, 64, shape).astype(np.float32)


@pytest.mark.parametrize("t,ft,fs", [(5, 2, 2), (4, 2, 2), (3, 1, 2), (2, 1, 1)])
def test_avg_down3d_is_bit_exact(t, ft, fs):
    c, out_ch = 8, 8 * ft * fs * fs // 4  # groups of 4: the means are exact
    x = _ints((2, t, 4, 6, c), t * 10 + ft)
    want = np.asarray(jvv._avg_down3d(jnp.asarray(x), out_ch, ft, fs))
    got = tvv._avg_down3d(torch.from_numpy(x), out_ch, ft, fs).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ft,fs", [(2, 2), (1, 2)])
def test_dup_up3d_is_bit_exact(ft, fs):
    x = _ints((2, 3, 2, 3, 8), ft)
    out_ch = 4
    want = np.asarray(jvv._dup_up3d(jnp.asarray(x), out_ch, ft, fs))
    got = tvv._dup_up3d(torch.from_numpy(x), out_ch, ft, fs).numpy()
    assert got.shape == want.shape == (2, 3 * ft - (ft - 1), 2 * fs, 3 * fs, out_ch)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [1, 2])
def test_patchify_and_unpatchify_are_bit_exact(p):
    x = _ints((2, 3, 8, 6, 3), p)
    want = np.asarray(jvv._patchify(jnp.asarray(x), p))
    got = tvv._patchify(torch.from_numpy(x), p)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tvv._unpatchify(got, p).numpy(),
                                  np.asarray(jvv._unpatchify(jnp.asarray(want), p)))
    np.testing.assert_array_equal(tvv._unpatchify(got, p).numpy(), x)


@pytest.mark.parametrize("halve", [True, False])
def test_upsample_frame_interleave_is_bit_exact(halve):
    """WanUpsample with 0/1 weights: the time conv's last tap copies each
    frame's channels into both halves of the channel pair (the second
    doubled), the spatial conv's centre tap copies channels through; on
    integer inputs every sum is exact, so the interleave (first frame
    dropped: T -> 2T - 1) and the nearest 2x show bit for bit."""
    dim, t = 4, 3
    eye = np.eye(dim, dtype=np.float32)
    time_k = np.zeros((3, 1, 1, dim, 2 * dim), np.float32)
    time_k[2, 0, 0] = np.concatenate([eye, 2 * eye], axis=1)
    out = dim // 2 if halve else dim
    sp_k = np.zeros((1, 3, 3, dim, out), np.float32)
    sp_k[0, 1, 1] = eye[:, :out]
    tree = {"params": {"time_conv": {"kernel": time_k, "bias": np.zeros(2 * dim, np.float32)},
                       "resample": {"conv": {"kernel": sp_k, "bias": np.zeros(out, np.float32)}}}}
    x = _ints((1, t, 3, 2, dim), 5)
    want = np.asarray(jvv.WanUpsample(dim, True, halve=halve).apply(tree, jnp.asarray(x)))
    mod = tvv.WanUpsample(dim, True, halve=halve)
    mod.load_state_dict(wan_vae_params_from_flax(tree))
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 2 * t - 1, 6, 4, out)
    np.testing.assert_array_equal(got, want)


# -- the mid attention at D = 384 / 640 -------------------------------------------


@pytest.mark.parametrize("d", [384, 640])
def test_mid_attention_route_at_video_head_dims(d, monkeypatch):
    """Self-attention with S >= 1024 and D = 384 / 640 is routed to
    `wide_attention` (the D <= 128 kernel never sees it); on the CPU that
    wrapper takes the plain reference, which matches JAX's XLA attention
    and counts no launch."""
    calls = []
    for wrapper in ("wide_attention", "flash_attention"):
        real = getattr(tlayers, wrapper)
        monkeypatch.setattr(tlayers, wrapper,
                            lambda *a, _w=wrapper, _f=real: calls.append(_w) or _f(*a))
    rng = np.random.default_rng(d)
    qkv = rng.standard_normal((2, 1024, 1, 3 * d)).astype(np.float32)
    q, k, v = np.split(qkv, 3, axis=-1)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(j_attention(*(jnp.asarray(t) for t in (q, k, v)), impl="xla"))
    before = tattn.wide_attention.launches
    got = tlayers.attention_bshd(*torch.from_numpy(qkv).chunk(3, dim=-1))
    assert calls == ["wide_attention"]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert tattn.wide_attention.launches == before


@pytest.mark.parametrize("d", [384, 640])
def test_fused_qkv_views_meet_the_kernel_contract(d):
    """The video VAE hands the kernel column slices of one fused q|k|v
    projection: (B*T, S, 1, 3C) split three ways, row strides 3C (1,152 /
    1,920 elements) and k/v offsets of 2C / 4C bytes.  The wrapper's input
    checks take them without a copy; a head dim outside WIDE_HEAD_DIMS is
    refused."""
    assert d in tattn.WIDE_HEAD_DIMS
    qkv = torch.zeros((9, 64, 1, 3 * d), dtype=torch.bfloat16)
    q, k, v = qkv.chunk(3, dim=-1)
    assert q.stride() == (64 * 3 * d, 3 * d, 3 * d, 1)
    assert (k.data_ptr() - q.data_ptr(), v.data_ptr() - q.data_ptr()) == (2 * d, 4 * d)
    tattn._check_cuda_inputs("wide_attention", q, k, v, tattn.WIDE_HEAD_DIMS)
    bad = torch.zeros((1, 64, 1, 3 * 448), dtype=torch.bfloat16).chunk(3, dim=-1)
    with pytest.raises(ValueError, match="head dim 448"):
        tattn._check_cuda_inputs("wide_attention", *bad, tattn.WIDE_HEAD_DIMS)


@pytest.mark.parametrize("c", [384, 640])
def test_video_vae_attention_block_matches_flax(c):
    """The mid attention block at C = D = 384 / 640 on two 32 x 32 frames
    (S = 1024 a frame, so the router takes `wide_attention`), against flax."""
    rng = np.random.default_rng(c)
    x = rng.standard_normal((1, 2, 32, 32, c)).astype(np.float32)
    module = jvv.WanVAEAttnBlock(dtype=jnp.float32)
    tree = random_tree(module.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 32, 32, c))), 2)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(module.apply(tree, jnp.asarray(x)))
    block = tvv.WanVAEAttnBlock(c)
    block.load_state_dict(wan_vae_params_from_flax(tree))
    with torch.no_grad():
        got = block(torch.from_numpy(x))
    _close(got.numpy(), want)


def test_wan_vae_configs_match_jax():
    for name in ("WAN21_VAE_CONFIG", "QWEN_IMAGE_VAE_CONFIG", "WAN22_VAE_CONFIG",
                 "TINY_WAN_VAE_CONFIG", "TINY_WAN22_VAE_CONFIG"):
        want = dataclasses.asdict(getattr(jvv, name))
        got = dataclasses.asdict(getattr(tvv, name))
        assert want.pop("dtype") == jnp.bfloat16 and got.pop("dtype") == torch.bfloat16
        assert got == want, name
    assert tvv.WAN21_LATENTS_MEAN == jvv.WAN21_LATENTS_MEAN
    assert tvv.WAN21_LATENTS_STD == jvv.WAN21_LATENTS_STD


def test_build_wan_vae_random_weights():
    """Random weights from a seed, in the parameter dtype asked for, the
    RMS gammas one; the same seed gives the same weights; the image case
    T = 1 encodes to one latent frame."""
    kw = dict(param_dtype=torch.bfloat16, seed=3, device="cpu")
    vae = tzoo.build_wan_vae(tvv.TINY_WAN22_VAE_CONFIG, **kw)
    again = tzoo.build_wan_vae(tvv.TINY_WAN22_VAE_CONFIG, **kw)
    assert all(p.dtype == torch.bfloat16 for p in vae.parameters())
    assert all(torch.equal(a, b) for a, b in zip(vae.state_dict().values(),
                                                 again.state_dict().values()))
    assert bool((vae.encoder.head_norm.gamma == 1).all())
    x = torch.rand((1, 3, 1, 32, 48)) * 2 - 1
    with torch.no_grad():
        z = vae.encode(x)
        y = vae.decode(z)
    assert z.shape == (1, 4, 1, 4, 6) and y.shape == x.shape
    assert bool(torch.isfinite(y).all())
