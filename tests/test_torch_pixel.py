"""The port's pixel-space workflows (`api.inpaint_image`, `api.outpaint_image`)
against the JAX package: the tiny VAE (fp32) encodes, LanPaint on the tiny
UNet (fp32) repaints, the VAE decodes and MaskBlend feathers the result into
the source image.

Both packages draw the same normals through test_torch_api's
`shared_normals` fixture.  Tolerance: 1e-4 of the compared image's largest
value (the fp32 slice's, as tests/test_torch_api.py); beyond the dilated
and feathered mask the port returns the source pixels exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lanpaint_tpu as J
from lanpaint_tpu.models import vae as jvae
from lanpaint_tpu.models import zoo as jzoo
from lanpaint_tpu_torch import api as tapi
from lanpaint_tpu_torch.models import vae as tvae
from lanpaint_tpu_torch.models import zoo as tzoo
from lanpaint_tpu_torch.models.bridge import unet_params_from_flax, vae_params_from_flax
from test_torch_api import shared_normals  # noqa: F401  (a fixture)
from test_torch_unet import _configs
from test_torch_unet import _random_tree as unet_tree
from test_torch_vae import _random_tree as vae_tree


@pytest.fixture(scope="module")
def pipeline():
    """(JAX Denoiser, flax VAE, its tree, port Denoiser, port VAE), fp32."""
    jcfg, tcfg = _configs("fp32")
    _, params = jzoo.build_unet(jcfg)
    tree = unet_tree(params, seed=7)
    jden, _ = jzoo.build_unet(jcfg, tree)
    tden, _ = tzoo.build_unet(tcfg, unet_params_from_flax(tree), device="cpu")
    jvcfg = dataclasses.replace(jvae.TINY_VAE_CONFIG, dtype=jnp.float32)
    jv = jvae.VAE(jvcfg)
    vtree = vae_tree(jax.jit(jv.init)(jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32))), 3)
    tv = tzoo.build_vae(dataclasses.replace(tvae.TINY_VAE_CONFIG, dtype=torch.float32),
                        vae_params_from_flax(vtree), device="cpu")
    return jden, jv, vtree, tden, tv


KW = dict(seed=1, steps=3, cfg=5.0, scheduler="karras", num_steps=2, sequential_cfg=True,
          blend_overlap=5)


def _cond(lib):
    ctx = np.random.default_rng(2).standard_normal((2, 1, 8, 32)).astype(np.float32)
    to = jnp.asarray if lib is jnp else torch.from_numpy
    return {"context": to(ctx[0])}, {"context": to(ctx[1])}


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_inpaint_image_matches_jax(pipeline, shared_normals):  # noqa: F811
    jden, jv, vtree, tden, tv = pipeline
    image = np.tanh(np.random.default_rng(5).standard_normal((1, 3, 32, 32))).astype(np.float32)
    mask = np.zeros((32, 32), np.float32)
    mask[12:20, 10:22] = 1.0
    with jax.default_matmul_precision("highest"):
        pos, neg = _cond(jnp)
        want = J.inpaint_image(jden, jv, vtree, image=jnp.asarray(image), mask=jnp.asarray(mask),
                               positive=pos, negative=neg, **KW)
    pos, neg = _cond(torch)
    got = tapi.inpaint_image(tden, tv, image=torch.from_numpy(image),
                             mask=torch.from_numpy(mask), positive=pos, negative=neg, **KW)
    assert bool(torch.isfinite(got).all())
    _close(got, want)
    far = np.ones((32, 32), bool)
    far[12 - 5:20 + 5, 10 - 5:22 + 5] = False
    np.testing.assert_array_equal(got.numpy()[..., far], image[..., far])
    assert np.abs(got.numpy()[..., mask > 0] - image[..., mask > 0]).mean() > 1e-2
    # blend_overlap 0: the decoded image itself
    raw = tapi.inpaint_image(tden, tv, image=torch.from_numpy(image),
                             mask=torch.from_numpy(mask), positive=pos, negative=neg,
                             **dict(KW, blend_overlap=0))
    assert not np.array_equal(raw.numpy()[..., far], image[..., far])


def test_outpaint_image_matches_jax(pipeline, shared_normals):  # noqa: F811
    jden, jv, vtree, tden, tv = pipeline
    image = np.tanh(np.random.default_rng(6).standard_normal((1, 3, 16, 20))).astype(np.float32)
    padding = (8, 8, 6, 6)  # (top, bottom, left, right): a 32 x 32 canvas
    with jax.default_matmul_precision("highest"):
        pos, neg = _cond(jnp)
        want = J.outpaint_image(jden, jv, vtree, image=jnp.asarray(image), padding=padding,
                                positive=pos, negative=neg, **KW)
    pos, neg = _cond(torch)
    got = tapi.outpaint_image(tden, tv, image=torch.from_numpy(image), padding=padding,
                              positive=pos, negative=neg, **KW)
    assert got.shape == (1, 3, 32, 32)
    _close(got, want)
