"""The port's Qwen2.5-VL vision tower (`lanpaint_tpu_torch/models/vision.py`)
and `text.VisionEncoder` against the JAX package's, fed the same weights
through models/bridge.py.

The tiny config on a grid whose windows are all full, (1, 8, 12), and on
one whose merged size is not a multiple of the window (1, 6, 10: padded
edge windows, masked keys), in fp32 at "highest" matmul precision.
Tolerance: relative L2 error <= 1e-5 and 1e-4 of the largest magnitude
element by element (test_torch_textenc's).  The host preprocessing
(bicubic resize, normalization, the processor's patch order): the resize
weights within 1e-6 of JAX's, the patches bit-equal where no resize
happens, within 1e-5 of JAX's on the tiny upscaled images and within 4e-4
on a downscaled full-size one (XLA-CPU's contraction error there, see the
test).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanpaint_tpu import text as jtext
from lanpaint_tpu.models import load as JL
from lanpaint_tpu.models import vision as jv
from lanpaint_tpu_torch import text as ttext
from lanpaint_tpu_torch.models import bridge
from lanpaint_tpu_torch.models import load as TL
from lanpaint_tpu_torch.models import vision as tv
from lanpaint_tpu_torch.models import zoo as tzoo
from test_torch_textenc import _close

GRIDS = {"full_windows": (1, 8, 12), "padded_windows": (1, 6, 10)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed=0):
    cfg = jv.TINY_VL_VISION_CONFIG
    patch_in = cfg.in_channels * cfg.temporal_patch_size * cfg.patch_size ** 2
    shapes = jax.eval_shape(jv.QwenVLVision(cfg, (1, 4, 4)).init, jax.random.PRNGKey(0),
                            jnp.zeros((16, patch_in)))
    rng = np.random.default_rng(seed)

    def leaf(path, s):  # the raw RMS scales near one, every other leaf N(0, 0.2^2)
        if path[-1].key in ("norm1", "norm2", "ln_q"):
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.2 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def tower():
    tree = _tree()
    module = tzoo.build_vision(tv.TINY_VL_VISION_CONFIG, bridge.vision_params_from_flax(tree),
                               device="cpu")
    return tree, module


@pytest.mark.parametrize("grid", sorted(GRIDS.values()), ids=sorted(GRIDS))
def test_vision_tower_matches_jax(tower, grid):
    tree, module = tower
    cfg = jv.TINY_VL_VISION_CONFIG
    t, h, w = grid
    patches = np.random.default_rng(3).standard_normal(
        (t * h * w, cfg.in_channels * cfg.temporal_patch_size * cfg.patch_size ** 2)
    ).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jv.QwenVLVision(cfg, grid).apply(tree, jnp.asarray(patches)))
    with torch.no_grad():
        got = module(torch.from_numpy(patches), grid)
    assert tuple(got.shape) == want.shape == (t * h * w // cfg.merge_unit, cfg.out_hidden)
    _close(got, want)


def test_device_plan_is_the_host_plan(tower):
    _, module = tower
    plan = module.device_plan((1, 6, 10), "cpu")
    host = tv.vision_plan(tv.TINY_VL_VISION_CONFIG, (1, 6, 10))
    for k in ("gather", "valid", "inv", "cos", "sin"):
        np.testing.assert_array_equal(plan[k].numpy(), host[k], err_msg=k)
    assert plan["key_ok"].shape[0] == host["valid"].shape[0] * 4
    assert (plan["n_win"], plan["win_len"]) == (host["n_win"], host["win_len"])


@pytest.mark.parametrize("size", [(24, 40), (26, 42), (30, 30)])
def test_preprocess_matches_jax_tiny(size):
    """(24, 40): multiples of the tiny factor 4, no resize; (26, 42) and
    (30, 30): resized up to the minimum pixel budget."""
    img = np.random.default_rng(sum(size)).uniform(0, 1, size + (3,)).astype(np.float32)
    want, wgrid = jv.preprocess_image(img, jv.TINY_VL_VISION_CONFIG)
    got, grid = tv.preprocess_image(img, tv.TINY_VL_VISION_CONFIG)
    assert grid == wgrid and got.shape == want.shape and got.dtype == want.dtype
    if size == (24, 40):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_preprocess_matches_jax_downscaled():
    """Qwen2.5-VL's own config on a 1050 x 980 image, above the pixel
    budget: smart_resize shrinks it to 1036 x 952 (antialiased bicubic).
    The port's resize is within 1e-6 of the same weights contracted in
    float64; XLA-CPU's contraction in `jax.image.resize` is 8.3e-5 from it
    on this image, so the patches (pixels over the CLIP std, ~0.27) agree
    with JAX's within 4e-4."""
    img = np.random.default_rng(9).uniform(0, 1, (1050, 980, 3)).astype(np.float32)
    th, tw = tv.smart_resize(1050, 980, 28)
    wh, ww = (tv._cubic_resize_weights(n, m).astype(np.float64)
              for n, m in ((1050, th), (980, tw)))
    exact = np.einsum("hwc,hy->ywc", img.astype(np.float64), wh, optimize=True)
    exact = np.einsum("hwc,wx->hxc", exact, ww, optimize=True)
    np.testing.assert_allclose(tv.resize_bicubic(img, th, tw), exact, rtol=0, atol=1e-6)
    want, wgrid = jv.preprocess_image(img, jv.QWEN25_VL_VISION_CONFIG)
    got, grid = tv.preprocess_image(img, tv.QWEN25_VL_VISION_CONFIG)
    assert grid == wgrid == (1, th // 14, tw // 14) and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-4)


@pytest.mark.parametrize("n_in, n_out", [(30, 44), (1024, 980), (7, 7), (13, 5)])
def test_cubic_resize_weights_match_jax(n_in, n_out):
    from jax._src.image import scale as jscale

    want = jscale.compute_weight_mat(n_in, n_out, n_out / n_in, 0.0,
                                     jscale._fill_keys_cubic_kernel, True)
    np.testing.assert_allclose(tv._cubic_resize_weights(n_in, n_out), np.asarray(want),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [(24, 40), (26, 42)])
def test_vision_encoder_matches_jax(tower, size):
    """text.VisionEncoder: one image through preprocessing and the tower,
    the grid's plan made once (a second call reuses it)."""
    tree, module = tower
    img = np.random.default_rng(4).uniform(0, 1, size + (3,)).astype(np.float32)
    jenc = jtext.VisionEncoder(tree, jv.TINY_VL_VISION_CONFIG)
    tenc = ttext.VisionEncoder(module, tv.TINY_VL_VISION_CONFIG)
    with jax.default_matmul_precision("highest"):
        want, wgrid = jenc(img)
    got, grid = tenc(torch.from_numpy(img))
    assert grid == wgrid and list(tenc._plans) == [grid]
    _close(got, np.asarray(want))
    again, _ = tenc(img)
    assert torch.equal(again, got) and len(tenc._plans) == 1


def test_vision_encoder_builds_from_a_state_dict(tower):
    tree, module = tower
    enc = ttext.VisionEncoder(bridge.params_from_flax(tree), tv.TINY_VL_VISION_CONFIG,
                              device="cpu")
    sd, want = enc.module.state_dict(), module.state_dict()
    assert sd.keys() == want.keys() and all(torch.equal(sd[k], want[k]) for k in sd)


def test_full_size_config_and_table_match_jax():
    got = dataclasses.asdict(tv.QWEN25_VL_VISION_CONFIG)
    want = dataclasses.asdict(jv.QWEN25_VL_VISION_CONFIG)
    got.pop("dtype"), want.pop("dtype")
    assert got == want
    cfg = tv.QWEN25_VL_VISION_CONFIG
    assert (cfg.head_dim, cfg.merge_unit, cfg.window_units) == (80, 4, 4)
    assert TL.expected_keys(TL._qwen_vl_vision_entries(cfg), "visual.") == \
        JL.expected_keys(JL._qwen_vl_vision_entries(jv.QWEN25_VL_VISION_CONFIG), "visual.")


def test_full_size_tree_bridges_onto_the_module():
    cfg = jv.QWEN25_VL_VISION_CONFIG
    shapes = jax.eval_shape(jv.QwenVLVision(cfg, (1, 8, 8)).init, jax.random.PRNGKey(0),
                            jnp.zeros((64, 3 * 2 * 14 * 14)))
    tree = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    got = {k: tuple(a.shape) for k, a in bridge.flax_entries(tree)}
    with torch.device("meta"):
        module = tv.QwenVLVision(tv.QWEN25_VL_VISION_CONFIG)
    assert got == {k: tuple(p.shape) for k, p in module.state_dict().items()}


def test_random_init_sets_the_raw_norm_scales_to_one():
    module = tzoo.build_vision(tv.TINY_VL_VISION_CONFIG, device="cpu", seed=1)
    for name, p in module.named_parameters():
        if name.split(".")[-1] in ("norm1", "norm2", "ln_q"):
            assert torch.equal(p, torch.ones_like(p)), name


def test_build_vision_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tzoo.build_vision(tv.TINY_VL_VISION_CONFIG)
