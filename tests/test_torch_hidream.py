"""The port's HiDream-I1 MoE-MMDiT (`lanpaint_tpu_torch/models/hidream.py`,
`zoo.build_hidream`, `load.import_hidream` / `export_hidream`) against the
JAX package's.

The tiny config (2 double and 2 single blocks, 4 routed experts, top 2) in
fp32, weights from one flax tree carried by `bridge.hidream_params_from_
flax`, inputs from numpy, JAX at "highest" matmul precision; the Llama
stack has 3 layers, so the double blocks take layers 0 and 1 and the
single ones layers 2 and 0.  Tolerances as tests/test_torch_sd3.py: fp32
forward 1e-4 (the Denoiser x - t * v of it, bit for bit); bf16 within
twice JAX's own bf16 error plus 1e-3; a 4-step
LanPaint run with a shared noise feed 1e-4 of the largest value; the
importer bit-equal to the bridge of the JAX import.  The router's top 2
on tied probabilities picks the experts `jax.lax.top_k` picks (the lower
index first).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import manifests as M
from lanpaint_tpu.models import hidream as jh
from lanpaint_tpu.models import load as JL
from lanpaint_tpu.models import zoo as jzoo
from lanpaint_tpu_torch.models import bridge
from lanpaint_tpu_torch.models import hidream as th
from lanpaint_tpu_torch.models import load as TL
from lanpaint_tpu_torch.models import zoo as tzoo
from test_torch_sd3 import bf16_within_twice_jax, builders_match_jax, close, \
    denoiser_is_x_minus_t_v, lanpaint_run_matches_jax
from test_torch_textenc import random_tree

N_LAYERS = 3  # Llama hidden-state slices handed to the model


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(dtype="fp32", **kw):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (dataclasses.replace(jh.TINY_HIDREAM_CONFIG, dtype=jdt, **kw),
            dataclasses.replace(th.TINY_HIDREAM_CONFIG, dtype=tdt, **kw))


def tree_of(jcfg, seed=0):
    return random_tree(jh.HiDreamModel(jcfg), jnp.zeros((1, jcfg.latent_channels, 8, 8)),
                       jnp.full((1,), 0.5), jnp.zeros((1, 3, jcfg.context_dim)),
                       jnp.zeros((1, jcfg.vec_dim)), jnp.zeros((2, 1, 4, jcfg.llama_dim)),
                       seed=seed)


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = configs()
    tree = tree_of(jcfg)
    den, module = tzoo.build_hidream(tcfg, bridge.hidream_params_from_flax(tree), device="cpu")
    return jcfg, jax.jit(jh.HiDreamModel(jcfg).apply), tree, den, module


def _inputs(jcfg, b, n_t5, n_ll, side, seed, n_layers=N_LAYERS):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, jcfg.latent_channels, side, side)).astype(np.float32),
            rng.uniform(0.05, 0.95, (b,)).astype(np.float32),
            rng.standard_normal((b, n_t5, jcfg.context_dim)).astype(np.float32),
            rng.standard_normal((b, jcfg.vec_dim)).astype(np.float32),
            None if n_layers is None else
            rng.standard_normal((n_layers, b, n_ll, jcfg.llama_dim)).astype(np.float32))


@pytest.mark.parametrize("b, n_t5, n_ll, side, n_layers",
                         [(1, 5, 4, 8, N_LAYERS), (2, 6, 3, 12, N_LAYERS), (1, 4, 1, 8, None)])
def test_hidream_forward_matches_jax(tiny, b, n_t5, n_ll, side, n_layers):
    """With a 3-layer Llama stack, and without one (one zero slice)."""
    jcfg, japply, tree, _, module = tiny
    args = _inputs(jcfg, b, n_t5, n_ll, side, seed=b + n_t5, n_layers=n_layers)
    with jax.default_matmul_precision("highest"):
        want = japply(tree, *[None if a is None else jnp.asarray(a) for a in args])
    with torch.no_grad():
        got = module(*[None if a is None else torch.from_numpy(a) for a in args])
    assert got.dtype == torch.float32
    close(got, want)


def test_hidream_bf16_forward_is_as_close_as_jax_bf16(tiny):
    """bf16 rounding flips the router's top 2 on near-tied tokens, in
    either package, which makes the error of a few tokens jump: the check
    runs over 72 image tokens (two 12 x 12 latents), not 16."""
    jcfg, japply, _, _, _ = tiny
    tree = tree_of(jcfg, seed=2)
    _, module = tzoo.build_hidream(configs("bf16")[1], bridge.hidream_params_from_flax(tree),
                                   device="cpu")
    bf16_within_twice_jax(japply, jax.jit(jh.HiDreamModel(configs("bf16")[0]).apply), module,
                          tree, _inputs(jcfg, 2, 6, 3, 12, seed=5))


def test_hidream_denoiser_is_x_minus_t_v(tiny):
    jcfg, _, tree, den, module = tiny
    jden, _ = jzoo.build_hidream(jcfg, tree)
    denoiser_is_x_minus_t_v(den, module, jden, _inputs(jcfg, 1, 5, 4, 8, seed=3),
                            ("context", "vec", "llama"), 3.0)


def test_hidream_lanpaint_run_matches_jax(tiny):
    """cfg 1, as examples/hidream_inpaint.py sets it."""
    jcfg, _, tree, den, _ = tiny
    jden, _ = jzoo.build_hidream(jcfg, tree)
    _, _, ctx, vec, llama = _inputs(jcfg, 1, 5, 4, 8, seed=6)
    lanpaint_run_matches_jax(jden, den, (1, 4, 8, 8), {"context": ctx, "vec": vec,
                                                       "llama": llama})


TIES = np.array([[0.0, 0.0, 0.0, 0.0],      # all four tied: experts 0 and 1
                 [1.0, 2.0, 2.0, 1.0],      # the top pair tied: 1 and 2
                 [3.0, 1.0, 1.0, 1.0],      # the second place tied: 0 and 1
                 [0.5, 0.5, 2.0, 0.5],      # 2, then the first of the rest
                 [-1.0, 4.0, -1.0, 4.0]],   # 1 and 3
                np.float32)


def test_router_breaks_ties_as_jax_top_k():
    want_v, want_i = jax.lax.top_k(jax.nn.softmax(jnp.asarray(TIES), axis=-1), 2)
    got_v, got_i = th.top_k_lower_first(torch.softmax(torch.from_numpy(TIES), dim=-1), 2)
    assert got_i.tolist() == np.asarray(want_i).tolist()
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_i[:, 0].tolist() == [0, 1, 0, 2, 1]


def test_moe_on_tied_gates_runs_jax_experts():
    """A zero gate ties all four experts for every token: the MoE must run
    experts 0 and 1 at weight 1/2 each, as the JAX module does; with
    distinct experts any other pair would change the output."""
    jcfg, tcfg = configs()
    tree = random_tree(jh.MoEFeedForward(jcfg), jnp.zeros((1, 5, jcfg.hidden)), seed=4)
    tree = jax.tree_util.tree_map_with_path(
        lambda p, a: np.zeros_like(a) if "gate" in jax.tree_util.keystr(p) else a, tree)
    module = th.MoEFeedForward(tcfg)
    module.load_state_dict(bridge.params_from_flax(tree))
    x = np.random.default_rng(9).standard_normal((2, 5, jcfg.hidden)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jh.MoEFeedForward(jcfg).apply(tree, jnp.asarray(x))
    with torch.no_grad():
        got = module(torch.from_numpy(x))
    close(got, want)
    weights = th.route(torch.zeros(3, 4), 2)
    assert weights.tolist() == [[0.5, 0.5, 0.0, 0.0]] * 3


def test_full_size_config_matches_jax():
    for name in ("HIDREAM_I1_CONFIG", "TINY_HIDREAM_CONFIG"):
        got = dataclasses.asdict(getattr(th, name))
        want = dataclasses.asdict(getattr(jh, name))
        got.pop("dtype"), want.pop("dtype")
        assert want.pop("attention_impl") == "auto"
        assert got == want, name
    assert th.HIDREAM_I1_CONFIG.head_dim == 128


def test_full_size_tree_bridges_onto_the_module():
    cfg = jh.HIDREAM_I1_CONFIG
    shapes = jax.eval_shape(jh.HiDreamModel(cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 8, 8)), jnp.full((1,), 0.5),
                            jnp.zeros((1, 4, cfg.context_dim)), jnp.zeros((1, cfg.vec_dim)),
                            jnp.zeros((2, 1, 4, cfg.llama_dim)))
    tree = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    got = {k: tuple(a.shape) for k, a in bridge.flax_entries(tree)}
    with torch.device("meta"):
        module = th.HiDreamModel(th.HIDREAM_I1_CONFIG)
    assert got == {k: tuple(p.shape) for k, p in module.state_dict().items()}
    n = sum(p.numel() for p in module.parameters())
    assert 18.3e9 < n < 18.4e9, n  # 36.7 GB in bf16


def test_expected_keys_are_the_full_size_manifest():
    assert TL.hidream_expected_keys(th.HIDREAM_I1_CONFIG) == \
        set(M.hidream_manifest(jh.HIDREAM_I1_CONFIG)) == \
        JL.hidream_expected_keys(jh.HIDREAM_I1_CONFIG)


def test_import_of_a_manifest_state_equals_the_bridge_of_the_jax_import():
    """Every key of the tiny manifest a distinct random tensor of its shape
    (the per-expert weights stack on import): bit-equal to the bridge of the
    JAX import, the module's state_dict filled exactly, and the export
    gives the state back."""
    jcfg, tcfg = configs()
    rng = np.random.default_rng(8)
    state = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in sorted(M.hidream_manifest(jcfg).items())}
    want = bridge.params_from_flax(JL.import_hidream(state, jcfg))
    got = TL.import_hidream(state, tcfg)
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    with torch.device("meta"):
        module = th.HiDreamModel(tcfg)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in module.state_dict().items()}
    out = TL.export_hidream(got, tcfg)
    assert sorted(out) == sorted(state)
    for k, v in state.items():
        np.testing.assert_array_equal(out[k].numpy(), v, err_msg=k)


def test_builders_match_jax(monkeypatch):
    builders_match_jax(monkeypatch, "build_hidream", "build_hidream",
                       ["build_tiny_hidream"], 3.0)


def test_build_hidream_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tzoo.build_tiny_hidream()
