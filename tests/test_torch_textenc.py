"""The port's text encoders (`lanpaint_tpu_torch/models/textenc.py`)
against the JAX package's, fed the same weights through models/bridge.py.

CLIP with quick_gelu, with gelu, and with a projection head; T5 (one shared
relative-bias table) and UMT5 (one a layer), with and without a key mask;
all in fp32 at tiny widths, the ids from a numpy seed, the JAX side jitted
once per case at "highest" matmul precision.  Tolerance: relative L2 error
<= 1e-5 on every output (hidden states, last LN, pooled; T5's last hidden
state), and 1e-4 of the largest magnitude element by element.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanpaint_tpu.models import textenc as jte
from lanpaint_tpu_torch import text as ttext
from lanpaint_tpu_torch.models import bridge
from lanpaint_tpu_torch.models import textenc as tte
from lanpaint_tpu_torch.models import zoo as tzoo

REL_L2 = 1e-5
ELEMENT = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's tests: their tensors are tiny,
    and under pytest-xdist the workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_tree(module, *args, seed=0, scale=0.2):
    """Every leaf N(0, scale^2), norm scales 1 + N(0, 0.1^2), from a numpy
    seed (shapes from jax.eval_shape)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if path[-1].key == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (scale * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _close(got, want):
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= REL_L2, rel
    np.testing.assert_allclose(got, want, rtol=0, atol=ELEMENT * np.abs(want).max())


CLIP_CASES = {
    "quick_gelu": dict(act="quick_gelu", projection_dim=0),
    "gelu": dict(act="gelu", projection_dim=0),
    "projection": dict(act="gelu", projection_dim=24),
}


@pytest.fixture(scope="module", params=sorted(CLIP_CASES))
def clip_case(request):
    kw = dict(vocab_size=100, width=32, layers=3, heads=4, intermediate=48, eos_token_id=3,
              **CLIP_CASES[request.param])
    jcfg, tcfg = jte.CLIPTextConfig(**kw), tte.CLIPTextConfig(**kw)
    tree = random_tree(jte.CLIPTextEncoder(jcfg), jnp.zeros((2, 13), jnp.int32))
    ids = np.random.default_rng(7).integers(4, 100, size=(2, 13))
    ids[0, 6], ids[1, 9] = 3, 3  # the EOT positions the pooled output reads
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jte.CLIPTextEncoder(jcfg).apply)(tree, jnp.asarray(ids, jnp.int32))
    module = tzoo.build_clip(tcfg, bridge.params_from_flax(tree), device="cpu")
    return tree, jcfg, module, ids, [np.asarray(w) for w in want]


def test_clip_matches_jax(clip_case):
    _, _, module, ids, want = clip_case
    with torch.no_grad():
        got = module(torch.from_numpy(ids))
    for g, w in zip(got, want):
        _close(g, w)


def test_clip_encode_takes_the_penultimate_hidden_state(clip_case):
    tree, jcfg, module, ids, _ = clip_case
    for skip in (1, 2):
        with jax.default_matmul_precision("highest"):
            want = jax.jit(lambda p, i: jte.clip_encode(p, i, jcfg, clip_skip=skip))(
                tree, jnp.asarray(ids, jnp.int32))
        got = tte.clip_encode(module, torch.from_numpy(ids), clip_skip=skip)
        for g, w in zip(got, want):
            _close(g, w)


T5_CASES = {"t5": False, "umt5": True}


@pytest.fixture(scope="module", params=sorted(T5_CASES))
def t5_case(request):
    kw = dict(vocab_size=60, d_model=32, head_dim=8, d_ff=48, layers=2, heads=3,
              rel_buckets=8, rel_max_distance=16, per_layer_rel_bias=T5_CASES[request.param])
    jcfg, tcfg = jte.T5Config(**kw), tte.T5Config(**kw)
    tree = random_tree(jte.T5Encoder(jcfg), jnp.zeros((2, 19), jnp.int32))
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 60, size=(2, 19))
    mask = np.ones((2, 19), np.int32)
    mask[1, 14:] = 0
    fn = jax.jit(jte.T5Encoder(jcfg).apply)
    with jax.default_matmul_precision("highest"):
        want = [np.asarray(fn(tree, jnp.asarray(ids, jnp.int32), m))
                for m in (None, jnp.asarray(mask))]
    module = tzoo.build_t5(tcfg, bridge.params_from_flax(tree), device="cpu")
    return module, ids, mask, want


def test_t5_matches_jax(t5_case):
    module, ids, _, want = t5_case
    _close(tte.t5_encode(module, torch.from_numpy(ids)), want[0])


def test_t5_with_a_key_mask_matches_jax(t5_case):
    module, ids, mask, want = t5_case
    got = tte.t5_encode(module, torch.from_numpy(ids), torch.from_numpy(mask))
    _close(got, want[1])


@pytest.mark.parametrize("qlen, klen, buckets, maxdist", [
    (19, 19, 8, 16), (512, 512, 32, 128), (7, 300, 32, 128), (77, 40, 16, 64)])
def test_relative_buckets_match_jax(qlen, klen, buckets, maxdist):
    got = tte.t5_relative_buckets(qlen, klen, buckets, maxdist)
    want = jte.t5_relative_buckets(qlen, klen, buckets, maxdist)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_full_size_configs_match_jax():
    for name in ("CLIP_L_CONFIG", "CLIP_G_CONFIG", "CLIP_H_CONFIG", "T5_XXL_CONFIG",
                 "UMT5_XXL_CONFIG"):
        got, want = dataclasses.asdict(getattr(tte, name)), dataclasses.asdict(getattr(jte, name))
        got.pop("dtype"), want.pop("dtype")
        assert got == want, name


def test_full_size_trees_bridge_onto_the_modules():
    """The JAX package's full-size CLIP-G and UMT5-XXL trees map onto the
    port modules' keys and shapes (zero-stride arrays and meta tensors:
    nothing is allocated)."""
    for name, cls, n in (("CLIP_G_CONFIG", "CLIPTextEncoder", 77),
                         ("UMT5_XXL_CONFIG", "T5Encoder", 8)):
        shapes = jax.eval_shape(getattr(jte, cls)(getattr(jte, name)).init,
                                jax.random.PRNGKey(0), jnp.zeros((1, n), jnp.int32))
        tree = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
        got = {k: tuple(a.shape) for k, a in bridge.flax_entries(tree)}
        with torch.device("meta"):
            module = getattr(tte, cls)(getattr(tte, name))
        assert got == {k: tuple(p.shape) for k, p in module.state_dict().items()}, name


def test_builders_default_to_the_card(monkeypatch):
    """Without a device named they build on the card, and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tzoo.build_clip(tte.CLIPTextConfig(vocab_size=10, width=8, layers=1, heads=2,
                                          intermediate=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tzoo.build_t5(tte.T5Config(vocab_size=10, d_model=8, d_ff=8, layers=1, heads=2,
                                  head_dim=4))


def test_unported_encoder_kinds_raise():
    """"llama" (waiting once) builds the Llama trunk from its state_dict and
    encodes as the JAX package's NativeEncoder; an unknown kind raises."""
    from lanpaint_tpu import text as jtext

    class Tok:
        def encode(self, text):
            return [ord(c) % 40 for c in text]

    kw = dict(vocab_size=40, dim=16, layers=2, heads=4, kv_heads=2, intermediate=24,
              head_dim=8, qk_norm=True, rms_eps=1e-6)
    jcfg, tcfg = jte.LlamaConfig(**kw), tte.LlamaConfig(**kw)
    tree = random_tree(jte.LlamaEncoder(jcfg), jnp.zeros((1, 6), jnp.int32))
    enc = ttext.NativeEncoder("llama", bridge.params_from_flax(tree), tcfg, Tok(), device="cpu")
    assert isinstance(enc.module, tte.LlamaEncoder) and enc.device == torch.device("cpu")
    with jax.default_matmul_precision("highest"):
        want = jtext.NativeEncoder("llama", tree, jcfg, Tok())("a cat")
    for g, w in zip(enc("a cat"), want):
        _close(g, w)
    with pytest.raises(ValueError):
        ttext.NativeEncoder("bert", None, None, None)
