"""The port's image autoencoders (lanpaint_tpu_torch.models.vae / taesd)
and the VAE's mid attention route, against the JAX package.

Weights come from one flax parameter tree carried across by
`models.bridge.vae_params_from_flax` (also the TAESD's); inputs
from numpy.  Both sides run on the CPU, where JAX's attention takes XLA's
plain path and the port's wrappers take `attention_ref`.

Tolerances:
* fp32: 1e-4 of the compared tensor's largest value (the frameworks sum
  convolutions in different orders; measured ~2e-6 on outputs of size ~1);
* bf16: relative L2 error 3e-2 against the flax forward in fp32 (bf16
  keeps ~3 significant digits and every convolution rounds its output);
* attention through the router: 1e-5 (the same fp32 softmax on both sides);
* the stochastic encode: the standardized draws have mean 0 within 0.1 and
  standard deviation 1 within 5% over 8,192 samples (4 sigma of the
  sampling error);
* the scale and shift convention: 1e-5 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanpaint_tpu.models import taesd as jtaesd
from lanpaint_tpu.models import vae as jvae
from lanpaint_tpu.models.layers import attention_bshd as j_attention
from lanpaint_tpu_torch.models import taesd as ttaesd
from lanpaint_tpu_torch.models import vae as tvae
from lanpaint_tpu_torch.models import zoo as tzoo
from lanpaint_tpu_torch.models.bridge import vae_params_from_flax
from lanpaint_tpu_torch.models.layers import attention_bshd
from lanpaint_tpu_torch.ops import attention as tattn

# the tiny 4-channel config, and a 16-channel one without quant convs (the
# SD3/Flux layout) with Flux's scale and shift
CONFIGS = {"tiny": {}, "tiny16": dict(z_channels=16, quant_conv=False, scale_factor=0.3611,
                                      shift_factor=0.1159)}


def _configs(name, dtype="fp32"):
    jcfg = dataclasses.replace(jvae.TINY_VAE_CONFIG, dtype=jnp.float32, **CONFIGS[name])
    tcfg = dataclasses.replace(tvae.TINY_VAE_CONFIG, **CONFIGS[name],
                               dtype=torch.float32 if dtype == "fp32" else torch.bfloat16)
    return jcfg, tcfg


def _random_tree(tree, seed, kernel_gain=1.0):
    """Well-conditioned random weights in the flax tree's shapes: kernels
    N(0, gain^2/fan_in), biases N(0, 0.1^2), norm scales 1 + N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        shape = np.shape(a)
        if name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "bias":
            v = 0.1 * rng.standard_normal(shape)
        else:
            v = kernel_gain * rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module", params=list(CONFIGS))
def vae_case(request):
    """(name, flax module, flax tree, pixels, JAX encode, JAX decode of it)."""
    name = request.param
    jcfg, _ = _configs(name)
    module = jvae.VAE(jcfg)
    tree = jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32)))
    tree = _random_tree(tree, seed=11)
    rng = np.random.default_rng(4)
    x = np.tanh(rng.standard_normal((2, 3, 32, 32))).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        z = jax.jit(lambda p, x: module.apply(p, x, method="encode"))(tree, jnp.asarray(x))
        y = jax.jit(lambda p, z: module.apply(p, z, method="decode"))(tree, z)
    return name, module, tree, x, np.asarray(z), np.asarray(y)


def _port(name, tree, dtype="fp32"):
    _, tcfg = _configs(name, dtype)
    return tzoo.build_vae(tcfg, vae_params_from_flax(tree), device="cpu")


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


def test_vae_bridge_covers_every_parameter(vae_case):
    name, _, tree, *_ = vae_case
    state = vae_params_from_flax(tree)
    want = tvae.VAE(_configs(name)[1]).state_dict()
    assert sorted(state) == sorted(want)
    for k, v in state.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
    assert ("encoder.quant_conv.weight" in state) == CONFIGS[name].get("quant_conv", True)


def test_vae_encode_decode_match_flax(vae_case):
    """The posterior mean, the decode of the JAX latent, and the round trip."""
    name, _, tree, x, z, y = vae_case
    vae = _port(name, tree)
    with torch.no_grad():
        got_z = vae.encode(torch.from_numpy(x))
        got_y = vae.decode(torch.from_numpy(z))
        got_round = vae(torch.from_numpy(x))
    assert got_z.dtype == got_y.dtype == torch.float32  # the fp32 output convolutions
    assert got_z.shape == z.shape and got_y.shape == y.shape == x.shape
    _close(got_z.numpy(), z)
    _close(got_y.numpy(), y)
    _close(got_round.numpy(), y)


def test_vae_bf16_is_close_to_fp32(vae_case):
    name, _, tree, x, z, y = vae_case
    vae = _port(name, tree, "bf16")
    with torch.no_grad():
        got_z = vae.encode(torch.from_numpy(x)).numpy()
        got_y = vae.decode(torch.from_numpy(z)).numpy()
    for got, want in ((got_z, z), (got_y, y)):
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 3e-2, f"bf16 relative L2 error {rel:.3g} > 3e-2"


def test_vae_scale_and_shift_convention(vae_case):
    """encode gives (mean - shift) * scale and decode inverts it: another
    scale and shift change the latent and not the decoded image."""
    name, _, tree, x, z, y = vae_case
    _, tcfg = _configs(name)
    vae = _port(name, tree)
    other = tvae.VAE(dataclasses.replace(tcfg, scale_factor=2.0, shift_factor=0.25))
    other.load_state_dict(vae.state_dict())
    with torch.no_grad():
        z2 = other.encode(torch.from_numpy(x)).numpy()
        y2 = other.decode(torch.from_numpy(z2)).numpy()
    mean = z / tcfg.scale_factor + tcfg.shift_factor
    np.testing.assert_allclose(z2, (mean - 0.25) * 2.0, rtol=1e-5, atol=1e-5)
    _close(y2, y)


def test_vae_stochastic_encode_statistics(vae_case):
    """encode(x, generator) samples mean + exp(logvar / 2) * eps with the
    log-variance clipped to [-30, 20]: seeded draws repeat, and standardized
    draws are N(0, 1), also where the clip is in force."""
    name, _, tree, x, z, _ = vae_case
    _, tcfg = _configs(name)
    vae = _port(name, tree)
    xt = torch.from_numpy(x)
    last = vae.encoder.quant_conv if vae.encoder.quant_conv is not None else vae.encoder.conv_out
    zc = tcfg.z_channels
    with torch.no_grad():
        logvar = torch.clamp(vae.encoder(xt)[:, zc:], -30.0, 20.0)
        a = vae.encode(xt, torch.Generator().manual_seed(1))
        assert torch.equal(a, vae.encode(xt, torch.Generator().manual_seed(1)))
        assert not torch.equal(a, vae.encode(xt, torch.Generator().manual_seed(2)))
        for clip in (False, True):
            if clip:  # push every log-variance above the clip
                last.bias[zc:] += 100.0
                logvar = torch.full_like(logvar, 20.0)
            gen = torch.Generator().manual_seed(3)
            draws = torch.stack([vae.encode(xt, gen) for _ in range(4)])
            eps = (draws / tcfg.scale_factor + tcfg.shift_factor
                   - (torch.from_numpy(z) / tcfg.scale_factor + tcfg.shift_factor))
            eps = eps / torch.exp(0.5 * logvar)
            assert eps.numel() >= 8192
            assert abs(float(eps.mean())) < 0.1 and abs(float(eps.std()) - 1.0) < 0.05, clip


@pytest.mark.parametrize("d", [64, 512])
def test_mid_attention_route_matches_jax_xla(d):
    """At the tiny VAE's S = 1024 the port's router sends self-attention to
    a kernel wrapper (`wide_attention` for D = 512), whose CPU path is the
    plain reference; it matches JAX's XLA attention and counts no launch."""
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((2, 1024, 1, d)).astype(np.float32) for _ in range(3))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(j_attention(*(jnp.asarray(t) for t in (q, k, v)), impl="xla"))
    before = (tattn.flash_attention.launches, tattn.wide_attention.launches)
    got = attention_bshd(*(torch.from_numpy(t) for t in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert (tattn.flash_attention.launches, tattn.wide_attention.launches) == before


def test_vae_attention_block_at_head_dim_512_matches_flax():
    """The mid attention block itself at C = D = 512 on a 32 x 32 grid
    (S = 1024, so the router takes `wide_attention`), against flax."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 32, 32, 512)).astype(np.float32)
    module = jvae.VAEAttnBlock(dtype=jnp.float32)
    tree = _random_tree(module.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 512))), 2)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(module.apply(tree, jnp.asarray(x)))
    block = tvae.VAEAttnBlock(512)
    block.load_state_dict(vae_params_from_flax(tree))
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got.numpy(), want)


def test_wide_attention_cpu_path_and_devices():
    q = torch.randn((1, 64, 2, 512))
    assert torch.equal(tattn.wide_attention(q, q, q), tattn.attention_ref(q, q, q))
    with pytest.raises(ValueError, match="unsupported device"):
        tattn.wide_attention(*(torch.empty((1, 64, 1, 512), device="meta"),) * 3)


def test_vae_configs_match_jax():
    for name in ("SD_VAE_CONFIG", "SDXL_VAE_CONFIG", "FLUX_VAE_CONFIG", "SD3_VAE_CONFIG",
                 "TINY_VAE_CONFIG"):
        want = dataclasses.asdict(getattr(jvae, name))
        got = dataclasses.asdict(getattr(tvae, name))
        assert want.pop("dtype") == jnp.bfloat16 and got.pop("dtype") == torch.bfloat16
        assert got == want, name


def test_build_vae_random_weights():
    """Random weights from a seed, in the parameter dtype asked for; the
    same seed gives the same weights."""
    vae = tzoo.build_vae(tvae.TINY_VAE_CONFIG, param_dtype=torch.bfloat16, seed=3,
                         device="cpu")
    again = tzoo.build_vae(tvae.TINY_VAE_CONFIG, param_dtype=torch.bfloat16, seed=3,
                           device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in vae.parameters())
    assert all(torch.equal(a, b) for a, b in zip(vae.state_dict().values(),
                                                 again.state_dict().values()))
    x = torch.rand((1, 3, 16, 24)) * 2 - 1
    with torch.no_grad():
        z = vae.encode(x)
        y = vae.decode(z)
    assert z.shape == (1, 4, 8, 12) and y.shape == x.shape
    assert bool(torch.isfinite(y).all())


# -- TAESD --------------------------------------------------------------------


@pytest.fixture(scope="module")
def taesd_tree():
    module = jtaesd.TAESDDecoder(latent_channels=4, dtype=jnp.float32)
    tree = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 4)))
    return module, _random_tree(tree, seed=5, kernel_gain=0.5)


def test_taesd_decoder_matches_flax(taesd_tree):
    module, tree = taesd_tree
    x = (2.0 * np.random.default_rng(1).standard_normal((2, 4, 6, 5))).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(module.apply)(tree, jnp.asarray(x)))
    dec = ttaesd.TAESDDecoder(4, dtype=torch.float32)
    dec.load_state_dict(vae_params_from_flax(tree))
    with torch.no_grad():
        got = dec(torch.from_numpy(x))
    assert got.shape == (2, 3, 48, 40) and got.dtype == torch.float32
    _close(got.numpy(), want)


def test_taesd_import_export_round_trip(taesd_tree):
    """The public layout the JAX package exports imports onto exactly the
    bridge's state dict, and exports back unchanged; a file without the
    "decoder." prefix imports the same."""
    _, tree = taesd_tree
    public = jtaesd.export_taesd_decoder(tree)
    state = ttaesd.import_taesd_decoder(public)
    want = vae_params_from_flax(tree)
    assert sorted(state) == sorted(want) == sorted(ttaesd.TAESDDecoder(4).state_dict())
    assert all(torch.equal(state[k], want[k]) for k in want)
    back = ttaesd.export_taesd_decoder(state)
    assert sorted(back) == sorted(public)
    assert all(np.array_equal(back[k].numpy(), public[k]) for k in public)
    bare = ttaesd.import_taesd_decoder({k[len("decoder."):]: v for k, v in public.items()})
    assert all(torch.equal(bare[k], state[k]) for k in state)
    assert [e[0] for e in ttaesd.taesd_entries()] == [e[0] for e in jtaesd.taesd_entries()]
