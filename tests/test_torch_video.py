"""The port's video workflow (`api.inpaint_video`) against the JAX package,
and the device rule of the port's builders.

`inpaint_video`: a tiny Wan VAE (fp32; the Wan2.1 structure and the Wan2.2
structure) encodes a 5-frame video, LanPaint on the tiny Wan (fp32)
repaints the latent through the video mask path at CFG 5, the VAE decodes
and MaskBlend feathers every frame into the source.  Both packages draw the
same normals through test_torch_api's `shared_normals` fixture.  Tolerance:
1e-4 of the compared video's largest value (the fp32 slice's, as
tests/test_torch_pixel.py); beyond the dilated and feathered mask the port
returns the source pixels exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lanpaint_tpu as J
from lanpaint_tpu.models import zoo as jzoo
from lanpaint_tpu_torch import api as tapi
from lanpaint_tpu_torch import inpaint_video, quality
from lanpaint_tpu_torch.models import video_vae as tvv
from lanpaint_tpu_torch.models import vae as tvae
from lanpaint_tpu_torch.models import zoo as tzoo
from lanpaint_tpu_torch.models.bridge import wan_params_from_flax
from test_torch_api import shared_normals  # noqa: F401  (a fixture)
from test_torch_video_vae import flax_vae, port_vae
from test_torch_wan import tiny_pair

KW = dict(seed=1, steps=3, cfg=5.0, num_steps=2, sequential_cfg=True, blend_overlap=5)
FRAMES = 5


@pytest.fixture(scope="module")
def wan_pair():
    """(JAX Denoiser, port Denoiser) of one tiny-Wan tree, fp32."""
    jcfg, tcfg, tree, _ = tiny_pair(seed=7)
    jden, _ = jzoo.build_wan(jcfg, tree)
    tden, _ = tzoo.build_wan(tcfg, wan_params_from_flax(tree), device="cpu")
    return jden, tden


def _cond(lib):
    ctx = np.random.default_rng(2).standard_normal((2, 1, 8, 32)).astype(np.float32)
    to = jnp.asarray if lib is jnp else torch.from_numpy
    return {"context": to(ctx[0])}, {"context": to(ctx[1])}


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("vae_name,mask_dims", [("wan21", 2), ("wan22", 2), ("wan22", 3)],
                         ids=["wan21-mask2d", "wan22-mask2d", "wan22-mask3d"])
def test_inpaint_video_matches_jax(wan_pair, shared_normals, vae_name, mask_dims):  # noqa: F811
    jden, tden = wan_pair
    jv, vtree = flax_vae(vae_name, seed=3)
    tv = port_vae(vae_name, vtree)
    side = 32  # a 16 x 16 (Wan2.1) or 4 x 4 (Wan2.2) latent
    lo, hi = side // 4, 3 * side // 4
    video = np.tanh(np.random.default_rng(5).standard_normal((1, 3, FRAMES, side, side)))
    video = video.astype(np.float32)
    mask = np.zeros((FRAMES, side, side), np.float32)
    mask[:, lo:hi, lo:hi] = 1.0
    if mask_dims == 2:
        mask = mask[0]
    else:
        mask[0] = 0.0  # the first frame kept whole
    with jax.default_matmul_precision("highest"):
        pos, neg = _cond(jnp)
        want = J.inpaint_video(jden, jv, vtree, video=jnp.asarray(video), mask=jnp.asarray(mask),
                               positive=pos, negative=neg, **KW)
    pos, neg = _cond(torch)
    got = inpaint_video(tden, tv, video=torch.from_numpy(video), mask=torch.from_numpy(mask),
                        positive=pos, negative=neg, **KW)
    assert bool(torch.isfinite(got).all())
    _close(got, want)
    o = KW["blend_overlap"]
    far = np.ones((side, side), bool)
    far[lo - o:hi + o, lo - o:hi + o] = False
    np.testing.assert_array_equal(got.numpy()[..., far], video[..., far])
    repaint = np.broadcast_to(mask, (FRAMES, side, side)) > 0
    assert np.abs(got.numpy()[:, :, repaint] - video[:, :, repaint]).mean() > 1e-2
    if mask_dims == 3:  # the kept frame is the source, bit for bit
        np.testing.assert_array_equal(got.numpy()[:, :, 0], video[:, :, 0])
    # blend_overlap 0: the decoded video itself
    raw = tapi.inpaint_video(tden, tv, video=torch.from_numpy(video),
                             mask=torch.from_numpy(mask), positive=pos, negative=neg,
                             **dict(KW, blend_overlap=0))
    assert not np.array_equal(raw.numpy()[..., far], video[..., far])


def _vgg_checkpoint(directory) -> str:
    """A torchvision-layout VGG16 state dict of random LPIPS weights, saved
    in `directory`; its path."""
    mod = quality.init_lpips_params(torch.Generator().manual_seed(0), device="cpu")
    path = str(directory / "vgg16.pth")
    torch.save({f"features.{idx}.{leaf}": getattr(mod.vgg[f"conv{i}"], leaf)
                for i, idx in enumerate(quality._TORCHVISION_CONV_IDX)
                for leaf in ("weight", "bias")}, path)
    return path


# each builder as a function of a scratch directory and the keywords
BUILDERS = {
    "build_tiny_unet": lambda tmp, **kw: tzoo.build_tiny_unet(**kw),
    "build_tiny_dit": lambda tmp, **kw: tzoo.build_tiny_dit(**kw),
    "build_tiny_wan": lambda tmp, **kw: tzoo.build_tiny_wan(**kw),
    "build_vae": lambda tmp, **kw: tzoo.build_vae(tvae.TINY_VAE_CONFIG, **kw),
    "build_wan_vae": lambda tmp, **kw: tzoo.build_wan_vae(tvv.TINY_WAN_VAE_CONFIG, **kw),
    "init_lpips_params": lambda tmp, **kw: quality.init_lpips_params(**kw),
    "load_lpips_params": lambda tmp, **kw: quality.load_lpips_params(_vgg_checkpoint(tmp), **kw),
}


@pytest.mark.parametrize("name", list(BUILDERS))
def test_builders_run_on_the_card_unless_asked_for_the_cpu(name, monkeypatch, tmp_path):
    """With no `device` a builder targets the CUDA card: on a machine
    without one it raises instead of building on the CPU.  device="cpu"
    builds on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BUILDERS[name](tmp_path)
    built = BUILDERS[name](tmp_path, device="cpu")
    module = built[1] if isinstance(built, tuple) else built
    assert next(module.parameters()).device.type == "cpu"


def test_wan_vae_config_of_the_5b_main_path():
    """TI2V-5B's published 704x1280 with the Wan2.2 VAE: 16x spatial and 4x
    temporal compression to 48 channels, the mid attention at D = 640 over
    44 x 80 = 3,520 tokens a frame (the shapes chip_smoke.py drives)."""
    cfg = tvv.WAN22_VAE_CONFIG
    stride = cfg.patch * 2 ** (len(cfg.dim_mult) - 1)
    assert (stride, cfg.z_channels, cfg.dim * cfg.dim_mult[-1]) == (16, 48, 640)
    assert (704 // stride) * (1280 // stride) == 3520
    frames = 33
    for temporal in cfg.temporal_downsample:
        frames = (frames - 1) // 2 + 1 if temporal else frames
    assert frames == 9
    wan21 = tvv.WAN21_VAE_CONFIG
    assert wan21.dim * wan21.dim_mult[-1] == 384 and (480 // 8) * (832 // 8) == 6240
