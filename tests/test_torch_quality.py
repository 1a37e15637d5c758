"""The port's masked quality metrics (lanpaint_tpu_torch.quality) against the
JAX package, and its persistence and profiling utilities (utils).

Same images, masks and LPIPS weights on both sides (numpy, and the JAX
package's random LPIPS tree carried over key by key: its VGG kernels are
already in torch's OIHW layout).  Tolerance 1e-5 relative (fp32 on both
sides; the 13 VGG convolutions sum in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanpaint_tpu import quality as jq
from lanpaint_tpu_torch import quality as tq
from lanpaint_tpu_torch import utils as tu
from lanpaint_tpu_torch.models import vae as tvae
from lanpaint_tpu_torch.models import zoo as tzoo


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(3)
    a = np.tanh(rng.standard_normal((2, 3, 32, 32))).astype(np.float32)
    b = np.clip(a + 0.3 * rng.standard_normal(a.shape), -1, 1).astype(np.float32)
    mask = np.zeros((32, 32), np.float32)
    mask[6:22, 9:27] = 1.0
    return a, b, mask


@pytest.fixture(scope="module")
def lpips_weights():
    tree = jq.init_lpips_params(jax.random.PRNGKey(4))
    state = {f"vgg.{name}.{'weight' if leaf == 'kernel' else leaf}": np.asarray(v)
             for name, conv in tree["vgg"].items() for leaf, v in conv.items()}
    state.update({f"lin.{name}": np.asarray(v) for name, v in tree["lin"].items()})
    mod = tq.LPIPS()
    mod.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in state.items()})
    return tree, mod.eval().requires_grad_(False)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("metric", ["masked_mse", "masked_psnr", "masked_ssim"])
@pytest.mark.parametrize("masked", [False, True])
def test_pixel_metrics_match_jax(images, metric, masked):
    a, b, mask = images
    m = mask if masked else None
    want = getattr(jq, metric)(jnp.asarray(a), jnp.asarray(b),
                               None if m is None else jnp.asarray(m))
    got = getattr(tq, metric)(torch.from_numpy(a), torch.from_numpy(b),
                              None if m is None else torch.from_numpy(m))
    _close(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_lpips_matches_jax(images, lpips_weights, masked):
    a, b, mask = images
    tree, mod = lpips_weights
    m = mask if masked else None
    with jax.default_matmul_precision("highest"):
        want_maps = jq.lpips_maps(tree, jnp.asarray(a), jnp.asarray(b))
        want = jq.lpips(tree, jnp.asarray(a), jnp.asarray(b), None if m is None else jnp.asarray(m))
    with torch.no_grad():
        got_maps = tq.lpips_maps(mod, torch.from_numpy(a), torch.from_numpy(b))
        got = tq.lpips(mod, torch.from_numpy(a), torch.from_numpy(b),
                       None if m is None else torch.from_numpy(m))
    assert [tuple(g.shape) for g in got_maps] == [tuple(w.shape) for w in want_maps]
    for g, w in zip(got_maps, want_maps):
        _close(g.numpy(), w)
    assert got.shape == (2,)
    _close(got.numpy(), want)


@pytest.mark.parametrize("n_in,n_out", [(32, 16), (32, 4), (32, 2), (10, 3), (8, 8), (4, 10)])
def test_mask_resize_weights_match_jax_image_resize(n_in, n_out):
    x = np.random.default_rng(n_in * n_out).uniform(size=(n_in,)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (n_out,), "linear"))
    got = torch.from_numpy(x) @ tq._linear_resize_weights(n_in, n_out, "cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_quality_report_matches_jax(images, lpips_weights):
    a, b, mask = images
    tree, mod = lpips_weights
    with jax.default_matmul_precision("highest"):
        want = jq.quality_report(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask), tree)
    got = tq.quality_report(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(mask),
                            mod)
    assert sorted(got) == sorted(want) == ["masked_lpips", "masked_psnr", "masked_ssim"]
    for k in want:
        _close(got[k], want[k])


def test_load_lpips_params_reads_the_same_files_as_jax(tmp_path, lpips_weights):
    """A torchvision-layout VGG16 file and an LPIPS calibration file load
    into the same weights in both packages; without the calibration the
    stage weights are uniform 1/C."""
    tree, mod = lpips_weights
    vgg = {}
    for i, idx in enumerate(tq._TORCHVISION_CONV_IDX):
        vgg[f"features.{idx}.weight"] = mod.vgg[f"conv{i}"].weight.detach().clone()
        vgg[f"features.{idx}.bias"] = mod.vgg[f"conv{i}"].bias.detach().clone()
    lin = {f"lin{i}.model.1.weight": mod.lin[f"lin{i}"].detach().reshape(1, -1, 1, 1).clone()
           for i in range(5)}
    torch.save(vgg, tmp_path / "vgg16.pth")
    torch.save(lin, tmp_path / "vgg.pth")
    got = tq.load_lpips_params(str(tmp_path / "vgg16.pth"), str(tmp_path / "vgg.pth"),
                               device="cpu")
    want = jq.load_lpips_params(str(tmp_path / "vgg16.pth"), str(tmp_path / "vgg.pth"))
    for i in range(13):
        np.testing.assert_array_equal(got.vgg[f"conv{i}"].weight.numpy(),
                                      np.asarray(want["vgg"][f"conv{i}"]["kernel"]))
    for i in range(5):
        np.testing.assert_array_equal(got.lin[f"lin{i}"].numpy(),
                                      np.asarray(want["lin"][f"lin{i}"]))
    plain = tq.load_lpips_params(str(tmp_path / "vgg16.pth"), device="cpu")
    for i, ch in enumerate(tq._STAGE_CHANNELS):
        assert torch.equal(plain.lin[f"lin{i}"], torch.full((ch,), 1.0 / ch))


def test_lpips_refuses_images_on_another_device(images):
    """LPIPS runs where its weights are: images on another device raise
    instead of being moved there."""
    a, b, _ = images
    mod = tq.init_lpips_params(device="meta")
    with pytest.raises(ValueError, match="LPIPS weights are on meta"):
        tq.lpips(mod, torch.from_numpy(a), torch.from_numpy(b))


def test_init_lpips_params_is_seeded():
    a = tq.init_lpips_params(torch.Generator().manual_seed(1), device="cpu")
    b = tq.init_lpips_params(torch.Generator().manual_seed(1), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    for i, ch in enumerate(tq._STAGE_CHANNELS):
        w = a.lin[f"lin{i}"]
        assert w.shape == (ch,) and float(w.min()) >= 0.0 and float(w.max()) < 2.0 / ch


def test_save_and_load_params_round_trip(tmp_path):
    vae = tzoo.build_vae(tvae.TINY_VAE_CONFIG, seed=2, device="cpu")
    tu.save_params(str(tmp_path / "vae.pt"), vae)
    state = tu.load_params(str(tmp_path / "vae.pt"))
    assert sorted(state) == sorted(vae.state_dict())
    other = tzoo.build_vae(tvae.TINY_VAE_CONFIG, seed=3, device="cpu")
    assert tu.load_params(str(tmp_path / "vae.pt"), like=other) is other
    assert all(torch.equal(x, y) for x, y in zip(other.state_dict().values(),
                                                 vae.state_dict().values()))


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with tu.profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones((64, 64)) @ torch.ones((64, 64))
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())
