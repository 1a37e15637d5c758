"""The port's Llama / Qwen text trunk (`lanpaint_tpu_torch/models/textenc.py`
LlamaEncoder) against the JAX package's, fed the same weights through
models/bridge.py.

One tiny config per family: Llama-3 (GQA, llama3 rope scaling), Qwen2.5
(qkv bias, multimodal rope sections) and Qwen3 (decoupled head width,
per-head q/k RMS before RoPE); each with and without a key mask, the
Qwen2.5 one with Qwen2.5-VL 3-stream position ids too.  Also the
NativeEncoder's llama kind and its `with_vision` splice, and the host-side
rope tables.  All in fp32, the ids and weights from a numpy seed, the JAX
side at "highest" matmul precision.  Tolerance (test_torch_textenc's):
relative L2 error <= 1e-5 on every output (the hidden-state stack and the
final-normed state), and 1e-4 of the largest magnitude element by element.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanpaint_tpu import text as jtext
from lanpaint_tpu.models import textenc as jte
from lanpaint_tpu_torch import text as ttext
from lanpaint_tpu_torch.models import bridge
from lanpaint_tpu_torch.models import textenc as tte
from lanpaint_tpu_torch.models import zoo as tzoo
from test_torch_textenc import _close, random_tree

LLAMA_CASES = {
    "llama3": dict(rope_scaling=(8.0, 1.0, 4.0, 64), rope_theta=500000.0),
    "qwen25": dict(qkv_bias=True, rms_eps=1e-6, rope_theta=1000000.0, mrope_section=(2, 3, 3)),
    "qwen3": dict(head_dim=16, qk_norm=True, rms_eps=1e-6, rope_theta=1000000.0),
}
S = 13


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(name):
    kw = dict(vocab_size=100, dim=32, layers=2, heads=4, kv_heads=2, intermediate=48,
              **LLAMA_CASES[name])
    return jte.LlamaConfig(**kw), tte.LlamaConfig(**kw)


@pytest.fixture(scope="module", params=sorted(LLAMA_CASES))
def llama_case(request):
    jcfg, tcfg = _configs(request.param)
    tree = random_tree(jte.LlamaEncoder(jcfg), jnp.zeros((2, S), jnp.int32), seed=3)
    ids = np.random.default_rng(11).integers(0, 100, size=(2, S))
    module = tzoo.build_llama(tcfg, bridge.llama_params_from_flax(tree), device="cpu")
    return request.param, jcfg, tree, module, ids


def _jax(jcfg, tree, ids, **kw):
    kw = {k: None if v is None else jnp.asarray(v) for k, v in kw.items()}
    with jax.default_matmul_precision("highest"):
        return [np.asarray(w) for w in jax.jit(
            lambda p, i, kw: jte.LlamaEncoder(jcfg).apply(p, i, **kw))(
                tree, jnp.asarray(ids, jnp.int32), kw)]


def test_llama_matches_jax(llama_case):
    _, jcfg, tree, module, ids = llama_case
    want = _jax(jcfg, tree, ids)
    got = tte.llama_encode(module, torch.from_numpy(ids))
    assert tuple(got[0].shape) == (jcfg.layers + 1, 2, S, jcfg.dim)
    for g, w in zip(got, want):
        _close(g, w)


def test_llama_with_a_key_mask_matches_jax(llama_case):
    """Right padding in row 0, left padding in row 1: the left-padded
    queries see no valid key, and both packages average every value."""
    _, jcfg, tree, module, ids = llama_case
    mask = np.ones((2, S), np.int32)
    mask[0, 9:] = 0
    mask[1, :3] = 0
    want = _jax(jcfg, tree, ids, attn_mask=mask)
    got = tte.llama_encode(module, torch.from_numpy(ids), torch.from_numpy(mask))
    for g, w in zip(got, want):
        _close(g, w)


def _vision_pos_ids():
    return jtext.qwen_vl_pos_ids(3, (1, 4, 6), S - 3 - 6)


def test_mrope_with_vision_ids_matches_jax():
    """Qwen2.5-VL's multimodal rope (the only config with sections) on
    spliced embeddings and the 3-stream ids of an image span."""
    jcfg, tcfg = _configs("qwen25")
    tree = random_tree(jte.LlamaEncoder(jcfg), jnp.zeros((2, S), jnp.int32), seed=3)
    ids = np.random.default_rng(11).integers(0, 100, size=(2, S))
    module = tzoo.build_llama(tcfg, bridge.llama_params_from_flax(tree), device="cpu")
    pos = _vision_pos_ids()
    emb = np.random.default_rng(5).standard_normal((2, S, jcfg.dim)).astype(np.float32)
    want = _jax(jcfg, tree, ids, embeds=emb, pos_ids=pos)
    with torch.no_grad():
        got = module(torch.from_numpy(ids), embeds=torch.from_numpy(emb),
                     pos_ids=torch.from_numpy(pos))
    for g, w in zip(got, want):
        _close(g, w)


def test_mrope_of_text_ids_is_plain_rope():
    """For text alone the three streams are equal and the multimodal rope
    is the plain one: the same outputs with pos_ids = arange in every
    stream as without pos_ids (bit for bit up to cos/sin of equal angles)."""
    _, tcfg = _configs("qwen25")
    module = tzoo.build_llama(tcfg, device="cpu", seed=2)
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, 100, size=(1, S)))
    pos = torch.arange(S)[None].expand(3, S)
    with torch.no_grad():
        plain = module(ids)
        multi = module(ids, pos_ids=pos)
    for p, m in zip(plain, multi):
        torch.testing.assert_close(m, p, rtol=1e-6, atol=1e-6)
    cos, sin = tte._llama_rope(S, tcfg.head_width, tcfg.rope_theta)
    mcos, msin = tte._mrope_tables(pos, tcfg.head_width, tcfg.rope_theta, tcfg.mrope_section)
    torch.testing.assert_close(mcos, cos, rtol=0, atol=1e-6)
    torch.testing.assert_close(msin, sin, rtol=0, atol=1e-6)


@pytest.mark.parametrize("scaling", [None, (8.0, 1.0, 4.0, 8192), (32.0, 1.0, 4.0, 8192)])
def test_rope_tables_match_jax(scaling):
    for hd, theta in ((128, 500000.0), (16, 1000000.0)):
        want = jte._llama_rope(64, hd, theta, scaling)
        got = tte._llama_rope(64, hd, theta, scaling)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    pos = _vision_pos_ids()
    want = jte._mrope_tables(jnp.asarray(pos), 16, 1e6, (2, 3, 3))
    got = tte._mrope_tables(torch.from_numpy(pos), 16, 1e6, (2, 3, 3))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


def test_full_size_configs_match_jax():
    for name in ("LLAMA31_8B_CONFIG", "QWEN25_7B_CONFIG", "QWEN3_06B_CONFIG",
                 "QWEN3_4B_CONFIG", "QWEN3_8B_CONFIG"):
        got, want = dataclasses.asdict(getattr(tte, name)), dataclasses.asdict(getattr(jte, name))
        got.pop("dtype"), want.pop("dtype")
        assert got == want, name
        assert getattr(tte, name).head_width == getattr(jte, name).head_width


@pytest.mark.parametrize("name", ["QWEN25_7B_CONFIG", "QWEN3_4B_CONFIG"])
def test_full_size_trees_bridge_onto_the_module(name):
    """The JAX package's full-size Qwen trees map onto the port module's
    keys and shapes (zero-stride arrays and meta tensors: nothing is
    allocated)."""
    shapes = jax.eval_shape(jte.LlamaEncoder(getattr(jte, name)).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 4), jnp.int32))
    tree = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    got = {k: tuple(a.shape) for k, a in bridge.flax_entries(tree)}
    with torch.device("meta"):
        module = tte.LlamaEncoder(getattr(tte, name))
    assert got == {k: tuple(p.shape) for k, p in module.state_dict().items()}


class _Tok:
    """A tokenizer over the tiny vocabulary: one id per character."""

    def encode(self, text):
        return [ord(c) % 97 + 2 for c in text]


def test_native_llama_encoder_matches_jax(llama_case):
    _, jcfg, tree, module, _ = llama_case
    jenc = jtext.NativeEncoder("llama", tree, jcfg, _Tok())
    tenc = ttext.NativeEncoder("llama", module, module.cfg, _Tok())
    with jax.default_matmul_precision("highest"):
        want = jenc("a small prompt")
    got = tenc("a small prompt")
    for g, w in zip(got, want):
        _close(g, np.asarray(w))


@pytest.mark.parametrize("pos", [3, 0, 7])
def test_with_vision_matches_jax(pos):
    """The vision span spliced into the embeddings at `pos` (7: it ends the
    sequence), with the 3-stream position ids of the image grid."""
    jcfg, tcfg = _configs("qwen25")
    tree = random_tree(jte.LlamaEncoder(jcfg), jnp.zeros((1, S), jnp.int32), seed=6)
    ids = np.random.default_rng(7).integers(0, 100, size=(1, S)).astype(np.int32)
    vt = np.random.default_rng(8).standard_normal((6, jcfg.dim)).astype(np.float32)
    jenc = jtext.NativeEncoder("llama", tree, jcfg, _Tok())
    tenc = ttext.NativeEncoder("llama", bridge.params_from_flax(tree), tcfg, _Tok(),
                               device="cpu")
    with jax.default_matmul_precision("highest"):
        want = jenc.with_vision(jnp.asarray(ids), jnp.asarray(vt), pos, (1, 4, 6))
    got = tenc.with_vision(torch.from_numpy(ids).long(), torch.from_numpy(vt), pos, (1, 4, 6))
    for g, w in zip(got, want):
        _close(g, np.asarray(w))


def test_with_vision_needs_a_llama_encoder():
    with pytest.raises(ValueError, match="llama"):
        ttext.NativeEncoder("clip", torch.nn.Linear(1, 1), None, _Tok()).with_vision(
            torch.zeros((1, 4), dtype=torch.long), torch.zeros((1, 1)), 0, (1, 2, 2))


def test_build_llama_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tzoo.build_llama(_configs("qwen3")[1])
