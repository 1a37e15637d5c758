"""The port's HunyuanVideo DiT (`lanpaint_tpu_torch/models/hyvideo.py`,
`zoo.build_hyvideo`, `load.import_hyvideo` / `export_hyvideo`) against the
JAX package's.

The tiny config (2 double, 2 single and 2 refiner blocks) in fp32, weights
from one flax tree carried by `bridge.hyvideo_params_from_flax`, inputs
from numpy, JAX at "highest" matmul precision.  Tolerances as
tests/test_torch_sd3.py: fp32 forward 1e-4; bf16 within twice JAX's own
bf16 error plus 1e-3; a 4-step LanPaint run with a shared noise feed 1e-4
of the largest value; the importer bit-equal to the bridge of the JAX
import.  The Denoiser takes a 4D image latent (one frame) and a 5D video
latent, as the JAX one does: x - t * v of the forward, bit for bit, and
the 4-step run goes through it on a 4D latent.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import manifests as M
from lanpaint_tpu.models import hyvideo as jy
from lanpaint_tpu.models import load as JL
from lanpaint_tpu.models import zoo as jzoo
from lanpaint_tpu_torch.models import bridge
from lanpaint_tpu_torch.models import hyvideo as ty
from lanpaint_tpu_torch.models import load as TL
from lanpaint_tpu_torch.models import zoo as tzoo
from lanpaint_tpu_torch.ops import norms
from test_torch_sd3 import bf16_within_twice_jax, builders_match_jax, close, \
    denoiser_is_x_minus_t_v, lanpaint_run_matches_jax
from test_torch_textenc import random_tree


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(dtype="fp32", **kw):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (dataclasses.replace(jy.TINY_HYVIDEO_CONFIG, dtype=jdt, **kw),
            dataclasses.replace(ty.TINY_HYVIDEO_CONFIG, dtype=tdt, **kw))


def tree_of(jcfg, seed=0):
    return random_tree(jy.HYVideoDiT(jcfg), jnp.zeros((1, jcfg.in_channels, 1, 8, 8)),
                       jnp.full((1,), 0.5), jnp.zeros((1, 3, jcfg.context_dim)),
                       jnp.zeros((1, jcfg.vec_dim)), jnp.full((1,), 6.0), seed=seed)


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = configs()
    tree = tree_of(jcfg)
    den, module = tzoo.build_hyvideo(tcfg, bridge.hyvideo_params_from_flax(tree), device="cpu")
    return jcfg, jax.jit(jy.HYVideoDiT(jcfg).apply), tree, den, module


def _inputs(jcfg, b, n_txt, frames, hh, ww, seed, guidance=True):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, jcfg.in_channels, frames, hh, ww)).astype(np.float32),
            rng.uniform(0.05, 0.95, (b,)).astype(np.float32),
            rng.standard_normal((b, n_txt, jcfg.context_dim)).astype(np.float32),
            rng.standard_normal((b, jcfg.vec_dim)).astype(np.float32),
            rng.uniform(1.0, 8.0, (b,)).astype(np.float32) if guidance else None)


@pytest.mark.parametrize("b, n_txt, frames, hh, ww, guidance",
                         [(1, 5, 1, 8, 8, True), (2, 7, 3, 8, 12, True), (1, 4, 1, 8, 8, False)])
def test_hyvideo_forward_matches_jax(tiny, b, n_txt, frames, hh, ww, guidance):
    """One frame and three frames; without a guidance scale, 6.0."""
    jcfg, japply, tree, _, module = tiny
    args = _inputs(jcfg, b, n_txt, frames, hh, ww, seed=b + n_txt, guidance=guidance)
    with jax.default_matmul_precision("highest"):
        want = japply(tree, *[None if a is None else jnp.asarray(a) for a in args])
    with torch.no_grad():
        got = module(*[None if a is None else torch.from_numpy(a) for a in args])
    assert got.dtype == torch.float32
    close(got, want)


def test_hyvideo_bf16_forward_is_as_close_as_jax_bf16(tiny):
    jcfg, japply, _, _, _ = tiny
    tree = tree_of(jcfg, seed=2)
    _, module = tzoo.build_hyvideo(configs("bf16")[1], bridge.hyvideo_params_from_flax(tree),
                                   device="cpu")
    bf16_within_twice_jax(japply, jax.jit(jy.HYVideoDiT(configs("bf16")[0]).apply), module,
                          tree, _inputs(jcfg, 2, 7, 3, 8, 12, seed=5))


@pytest.mark.parametrize("frames", [None, 2], ids=["4d", "5d"])
def test_hyvideo_denoiser_takes_4d_and_5d_latents(tiny, frames):
    """A 4D image latent runs as one frame and comes back 4D (x - t * v of
    the module on x[:, :, None]); a 5D video latent stays 5D."""
    jcfg, _, tree, den, module = tiny
    jden, _ = jzoo.build_hyvideo(jcfg, tree)
    x, t, *rest = _inputs(jcfg, 1, 5, frames or 1, 8, 8, seed=3)
    if frames is None:
        x = x[:, :, 0]
    denoiser_is_x_minus_t_v(den, module, jden, (x, t, *rest), ("context", "vec", "guidance"),
                            7.0, unsqueeze=frames is None)


def test_hyvideo_lanpaint_run_matches_jax(tiny):
    """cfg 1 and the distilled guidance 6.0, as examples/hunyuan_inpaint.py
    sets them, on a 4D image latent."""
    jcfg, _, tree, den, _ = tiny
    jden, _ = jzoo.build_hyvideo(jcfg, tree)
    rng = np.random.default_rng(6)
    cond = {"context": rng.standard_normal((1, 5, jcfg.context_dim)).astype(np.float32),
            "vec": rng.standard_normal((1, jcfg.vec_dim)).astype(np.float32),
            "guidance": np.asarray([6.0], np.float32)}
    lanpaint_run_matches_jax(jden, den, (1, 4, 8, 8), cond)


def test_pack_unpack_and_ids_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 4, 6, 8)).astype(np.float32)
    for patch in ((1, 2, 2), (2, 2, 2)):
        want = np.asarray(jy.pack_video(jnp.asarray(x), patch))
        got = ty.pack_video(torch.from_numpy(x), patch)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(ty.unpack_video(got, 4, 6, 8, patch).numpy(), x)
        np.testing.assert_array_equal(ty.video_ids(2, 4, 6, 8, patch).numpy(),
                                      np.asarray(jy.video_ids(2, 4, 6, 8, patch)))


def test_strided_qk_views_collapse_for_the_row_norm():
    """At full width the q / k views of a double block's fused qkv (row
    stride 3 * 3,072 = 9,216) and of a single block's linear1 (3 * 3,072 +
    12,288 = 21,504) are (S, 24) rows of 128 the kernel reads in place."""
    cfg = ty.HUNYUAN_VIDEO_720P_CONFIG
    h, d, s = cfg.num_heads, cfg.head_dim, 4096 + 77
    for width in (3 * cfg.hidden, 3 * cfg.hidden + cfg.mlp_hidden):
        with torch.device("meta"):
            fused = torch.empty((1, s, width))
        for view in fused[..., :3 * cfg.hidden].chunk(3, dim=-1)[:2]:
            view = view.unflatten(-1, (h, d))
            assert norms.row_geometry(view.shape, view.stride()) == (s, h, width, d)
    assert (3 * cfg.hidden, 3 * cfg.hidden + cfg.mlp_hidden) == (9216, 21504)


def test_configs_match_jax():
    for name in ("HUNYUAN_VIDEO_720P_CONFIG", "TINY_HYVIDEO_CONFIG"):
        got = dataclasses.asdict(getattr(ty, name))
        want = dataclasses.asdict(getattr(jy, name))
        got.pop("dtype"), want.pop("dtype")
        assert want.pop("attention_impl") == "auto"
        assert got == want, name


def test_full_size_tree_bridges_onto_the_module():
    cfg = jy.HUNYUAN_VIDEO_720P_CONFIG
    shapes = jax.eval_shape(jy.HYVideoDiT(cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 1, 8, 8)), jnp.full((1,), 0.5),
                            jnp.zeros((1, 4, cfg.context_dim)), jnp.zeros((1, cfg.vec_dim)),
                            jnp.full((1,), 6.0))
    tree = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    got = {k: tuple(a.shape) for k, a in bridge.flax_entries(tree)}
    with torch.device("meta"):
        module = ty.HYVideoDiT(ty.HUNYUAN_VIDEO_720P_CONFIG)
    assert got == {k: tuple(p.shape) for k, p in module.state_dict().items()}
    n = sum(p.numel() for p in module.parameters())
    assert 12.5e9 < n < 13.5e9, n


def test_importer_consumes_the_full_size_manifest():
    man = M.hyvideo_manifest(jy.HUNYUAN_VIDEO_720P_CONFIG)
    consumed, leftover, missing = TL.manifest_coverage(
        man, TL._hyvideo_entries(ty.HUNYUAN_VIDEO_720P_CONFIG))
    assert not leftover and not missing and len(consumed) == len(man)


def test_import_of_a_manifest_state_equals_the_bridge_of_the_jax_import():
    jcfg, tcfg = configs()
    rng = np.random.default_rng(8)
    state = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in sorted(M.hyvideo_manifest(jcfg).items())}
    want = bridge.params_from_flax(JL.import_hyvideo(state, jcfg))
    got = TL.import_hyvideo(state, tcfg)
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    with torch.device("meta"):
        module = ty.HYVideoDiT(tcfg)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in module.state_dict().items()}
    out = TL.export_hyvideo(got, tcfg)
    assert sorted(out) == sorted(state)
    for k, v in state.items():
        np.testing.assert_array_equal(out[k].numpy(), v, err_msg=k)


def test_builders_match_jax(monkeypatch):
    builders_match_jax(monkeypatch, "build_hyvideo", "build_hyvideo", ["build_tiny_hyvideo"], 7.0)


def test_build_hyvideo_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tzoo.build_tiny_hyvideo()
