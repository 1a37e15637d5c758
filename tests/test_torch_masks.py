"""The port's pixel-space mask blend (lanpaint_tpu_torch.masks) against the
JAX package and the reference MaskBlend node's recorded outputs.

Tolerances: against the JAX function 1e-6 (both sides run the same fp32
max pool and Gaussian convolution; they sum the 81 products of a 9x9 window
in different orders); against the reference goldens 1e-5, the JAX package's
own tolerance there (tests/test_reference_golden.py); the checkerboard mask
exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanpaint_tpu import masks as jm
from lanpaint_tpu_torch import masks as tm
from test_reference_golden import DATA


@pytest.mark.parametrize("size", [1, 3, 5, 9])
def test_gaussian_kernel_matches_jax(size):
    np.testing.assert_allclose(tm.gaussian_kernel(size).numpy(),
                               np.asarray(jm.gaussian_kernel(size)), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("overlap", [1, 5, 9])
def test_mask_blend_matches_jax(overlap):
    rng = np.random.default_rng(overlap)
    img1, img2 = (rng.uniform(-1, 1, (2, 40, 32, 3)).astype(np.float32) for _ in range(2))
    mask = np.zeros((2, 40, 32), np.float32)
    mask[0, 10:25, 8:20] = 1.0
    mask[1] = (rng.uniform(size=(40, 32)) > 0.9).astype(np.float32)
    want = np.asarray(jm.mask_blend(jnp.asarray(img1), jnp.asarray(img2), jnp.asarray(mask),
                                    blend_overlap=overlap))
    got = tm.mask_blend(torch.from_numpy(img1), torch.from_numpy(img2), torch.from_numpy(mask),
                        blend_overlap=overlap)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # farther than the overlap from the mask, the first image comes back exactly
    far = np.ones((40, 32), bool)
    far[max(10 - overlap, 0):25 + overlap, max(8 - overlap, 0):20 + overlap] = False
    np.testing.assert_array_equal(got.numpy()[0][far], img1[0][far])


@pytest.mark.parametrize("overlap", [3, 9])
def test_mask_blend_matches_reference_goldens(overlap):
    z = np.load(DATA)
    p = f"maskblend_o{overlap}"
    out = tm.mask_blend(*(torch.from_numpy(z[f"{p}/{n}"]) for n in ("img1", "img2", "mask")),
                        blend_overlap=overlap)
    np.testing.assert_allclose(out.numpy(), z[f"{p}/out"], rtol=1e-5, atol=1e-5)


def test_mask_blend_refuses_mismatched_images():
    with pytest.raises(ValueError, match="size mismatch"):
        tm.mask_blend(torch.zeros((1, 8, 8, 3)), torch.zeros((1, 8, 16, 3)),
                      torch.zeros((1, 8, 8)))


@pytest.mark.parametrize("shape,scale", [((2, 4, 7, 9), 2), ((1, 16, 8, 8), 3)])
def test_checkerboard_noise_mask_matches_jax(shape, scale):
    got = tm.checkerboard_noise_mask(shape, scale)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jm.checkerboard_noise_mask(shape, scale)))
