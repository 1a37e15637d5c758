"""The port's tokenizers and text conditioning (`lanpaint_tpu_torch/
tokenizers.py`, `text.py`) against the JAX package's.

* The copied tokenizers give the JAX package's ids: the CLIP BPE from
  vocab.json / merges.txt files (ASCII, Unicode, padding, a prompt over 77
  tokens truncated, a CLIP-G pad id), a byte-level BPE from a synthetic
  tokenizer.json dict with added tokens, and a SentencePiece unigram model
  built in memory (protobuf bytes) with padding and truncation.
* `sdxl_pooled_y` and every cond builder give JAX's numbers.
* `encode_prompt` for sd15, sdxl, sd3, flux and wan, with tiny CLIP and T5
  encoders fed the same weights (models/bridge.py), and for qwen, qwen3
  and qwen_edit, with tiny Qwen2.5 / Qwen3 trunks and the tiny Qwen2.5-VL
  vision tower behind a byte-level BPE with the chat templates' special
  tokens, matches JAX's `encode_prompt` within relative L2 1e-5 on every
  cond entry (fp32, JAX at "highest" matmul precision), and so do hidream
  and hyvideo (the tiny Qwen2.5 trunk standing in for Llama-3.1, with the
  tiny CLIP-L and T5).
* `encode_prompt_hf`, fed a module with HuggingFace CLIP's call contract,
  gives JAX's conds.
"""

import json
import struct
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanpaint_tpu import text as jtext
from lanpaint_tpu import tokenizers as jtok
from lanpaint_tpu.models import textenc as jte
from lanpaint_tpu.models import unet as junet
from lanpaint_tpu.models import vision as jvision
from lanpaint_tpu_torch import text as ttext
from lanpaint_tpu_torch import tokenizers as ttok
from lanpaint_tpu_torch.models import bridge
from lanpaint_tpu_torch.models import textenc as tte
from lanpaint_tpu_torch.models import unet as tunet
from test_torch_textenc import random_tree

REL_L2 = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's tests: their tensors are tiny,
    and under pytest-xdist the workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want):
    got = np.asarray(got.detach().double() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    denom = max(np.linalg.norm(want), 1e-30)
    assert np.linalg.norm(got - want) / denom <= REL_L2


def _same_cond(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])


# --------------------------------------------------------------------------
# tokenizers

PROMPTS = [
    "a photo of a cat sitting on a mat",
    "The Quick brown fox!!  jumps... over (the) lazy dog's tail",
    "unicode café naïve über — ½ ² 東京 \U0001f600",
    "",
    "x" * 3 + " " + " ".join(f"word{i}" for i in range(120)),  # over 77 tokens
]


def _clip_files(tmp_path):
    byte_enc = jtok.bytes_to_unicode()
    chars = sorted(byte_enc.values())
    vocab = {ch: i for i, ch in enumerate(chars)}
    for ch in chars:
        vocab[ch + "</w>"] = len(vocab)
    merges = [("c", "a"), ("ca", "t</w>"), ("t", "h"), ("th", "e</w>"), ("o", "f</w>"),
              ("a", "t"), ("p", "h"), ("ph", "o"), ("pho", "t"), ("phot", "o</w>"),
              ("w", "o"), ("wo", "r"), ("wor", "d")]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    # the tokenizer's default special ids, as in every CLIP release (49,408 entries)
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = 49406, 49407
    vp, mp = tmp_path / "vocab.json", tmp_path / "merges.txt"
    vp.write_text(json.dumps(vocab), encoding="utf-8")
    mp.write_text("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges),
                  encoding="utf-8")
    return str(vp), str(mp), vocab


@pytest.mark.parametrize("pad", [None, 0])
def test_clip_tokenizer_matches_jax(tmp_path, pad):
    vp, mp, vocab = _clip_files(tmp_path)
    kw = dict(bos_token_id=vocab["<|startoftext|>"], eos_token_id=vocab["<|endoftext|>"],
              pad_token_id=pad)
    j = jtok.ClipBpeTokenizer.from_files(vp, mp, **kw)
    t = ttok.ClipBpeTokenizer.from_files(vp, mp, **kw)
    for text in PROMPTS:
        got = t.encode(text)
        assert got == j.encode(text), repr(text)
        assert len(got) == 77 and got[0] == kw["bos_token_id"]
    assert t.encode(PROMPTS[-1])[-1] == kw["eos_token_id"]  # truncated, then closed


def _bpe_dict():
    byte_enc = jtok.bytes_to_unicode()
    vocab = {ch: i for i, ch in enumerate(sorted(byte_enc.values()))}
    merges = ["Ġ c", "Ġc a", "Ġca t", "t h", "th e", "Ġ m", "Ġm a", "Ġma t"]
    for m in merges:
        vocab[m.replace(" ", "")] = len(vocab)
    added = [{"id": len(vocab), "content": "<|image_pad|>"},
             {"id": len(vocab) + 1, "content": "<|im_start|>"}]
    return {"model": {"type": "BPE", "vocab": vocab, "merges": merges},
            "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False},
            "added_tokens": added}


def test_bpe_tokenizer_json_matches_jax():
    data = _bpe_dict()
    j, t = jtok.from_tokenizer_dict(data), ttok.from_tokenizer_dict(data)
    for text in PROMPTS + ["<|im_start|>the cat on the mat", "before <|image_pad|> after"]:
        assert t.encode(text) == j.encode(text), repr(text)


def _spiece_bytes():
    """A SentencePiece model's protobuf: the piece list (field 1) with
    scores and types, and an unknown trailing field."""
    def varint(n):
        out = b""
        while True:
            b7 = n & 0x7F
            n >>= 7
            out += bytes([b7 | (0x80 if n else 0)])
            if not n:
                return out

    def piece(p, score, ptype=None):
        body = b"\x0a" + varint(len(p.encode())) + p.encode()
        body += b"\x15" + struct.pack("<f", score)
        if ptype is not None:
            body += b"\x18" + varint(ptype)
        return b"\x0a" + varint(len(body)) + body

    pieces = [piece("<pad>", 0.0, 3), piece("</s>", 0.0, 3), piece("<unk>", 0.0, 2)]
    pieces += [piece("▁", -3.0)] + [piece(f"▁{w}", -1.5) for w in ("the", "cat", "a", "photo")]
    pieces += [piece(c, -4.0) for c in "abcdefghijklmnopqrstuvwxyz"]
    pieces += [piece(f"<0x{b:02X}>", -20.0, 6) for b in range(256)]
    return b"".join(pieces) + b"\x12\x03abc"


def test_unigram_sentencepiece_matches_jax(tmp_path):
    path = tmp_path / "spiece.model"
    path.write_bytes(_spiece_bytes())
    assert ttok.load_sentencepiece_model(str(path)) == jtok.load_sentencepiece_model(str(path))
    j = jtok.unigram_from_sentencepiece(str(path))
    t = ttok.unigram_from_sentencepiece(str(path))
    for text in PROMPTS:
        assert t.encode(text) == j.encode(text), repr(text)
        for kw in (dict(pad_to=512), dict(max_length=8, pad_to=16), dict(add_eos=False)):
            assert t.encode(text, **kw) == j.encode(text, **kw), (repr(text), kw)
    data = {"model": {"type": "Unigram", "vocab": [(p, s) for p, s, _ in
                                                   jtok.load_sentencepiece_model(str(path))],
                      "unk_id": 2, "byte_fallback": True},
            "added_tokens": [{"id": 1, "content": "</s>"}]}
    for text in PROMPTS:
        assert ttok.from_tokenizer_dict(data).encode(text) == \
            jtok.from_tokenizer_dict(data).encode(text)


# --------------------------------------------------------------------------
# cond builders


def test_sdxl_pooled_y_matches_jax():
    pooled = np.random.default_rng(0).standard_normal((2, 1280)).astype(np.float32)
    for kw in (dict(), dict(height=768, width=1344, crop_h=16, crop_w=32, target_h=1024,
                            target_w=1024)):
        want = junet.sdxl_pooled_y(jnp.asarray(pooled), **kw)
        got = tunet.sdxl_pooled_y(torch.from_numpy(pooled), **kw)
        assert tuple(got.shape) == (2, 2816)
        _close(got, want)


def test_cond_builders_match_jax():
    rng = np.random.default_rng(1)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    h_l, h_g, t5, p_l, p_g, llm = r(1, 77, 8), r(1, 77, 12), r(1, 20, 32), r(1, 8), r(1, 12), \
        r(1, 9, 16)
    stack = r(3, 1, 9, 16)
    cases = [
        ("sd15_cond", (h_l,), {}), ("sdxl_cond", (h_l, h_g, r(1, 1280)), {}),
        ("sdxl_cond", (h_l, h_g, r(1, 1280)), dict(height=512, width=768, crop_h=8)),
        ("sd3_cond", (t5, h_l, h_g, p_l, p_g), {}), ("flux_cond", (t5, p_l), {}),
        ("flux_cond", (t5, p_l), dict(guidance=3.5)), ("qwen_cond", (llm,), {}),
        ("wan_cond", (t5,), {}), ("hidream_cond", (t5, p_l, stack), {}),
        ("hyvideo_cond", (llm, p_l), {}),
    ]
    for name, args, kw in cases:
        want = getattr(jtext, name)(*args, **kw)
        got = getattr(ttext, name)(*(torch.from_numpy(a) for a in args), **kw)
        assert all(v.dtype == torch.float32 for v in got.values())
        _same_cond(got, want)


# --------------------------------------------------------------------------
# encode_prompt with tiny encoders


@pytest.fixture(scope="module")
def encoders(tmp_path_factory):
    """{name: (JAX NativeEncoder, port NativeEncoder)} over one set of
    weights each: CLIP-L (no projection), CLIP-G (a projection), T5."""
    vp, mp, vocab = _clip_files(tmp_path_factory.mktemp("clip"))
    out = {}
    for name, seed, kw in (("clip_l", 1, dict(width=8, projection_dim=0)),
                           ("clip_g", 2, dict(width=12, projection_dim=20, act="gelu"))):
        kw = dict(vocab_size=49408, layers=2, heads=2, intermediate=16,
                  eos_token_id=vocab["<|endoftext|>"], **kw)
        jcfg, tcfg = jte.CLIPTextConfig(**kw), tte.CLIPTextConfig(**kw)
        tree = random_tree(jte.CLIPTextEncoder(jcfg), jnp.zeros((1, 77), jnp.int32), seed=seed)
        tokens = dict(bos_token_id=vocab["<|startoftext|>"], eos_token_id=vocab["<|endoftext|>"])
        out[name] = (
            jtext.NativeEncoder("clip", tree, jcfg, jtok.ClipBpeTokenizer.from_files(vp, mp,
                                                                                  **tokens)),
            ttext.NativeEncoder("clip", bridge.params_from_flax(tree), tcfg,
                                ttok.ClipBpeTokenizer.from_files(vp, mp, **tokens), device="cpu"))
    path = tmp_path_factory.mktemp("t5") / "spiece.model"
    path.write_bytes(_spiece_bytes())
    kw = dict(vocab_size=len(jtok.load_sentencepiece_model(str(path))), d_model=32, head_dim=8,
              d_ff=40, layers=2, heads=3, rel_buckets=8, rel_max_distance=16)
    jcfg, tcfg = jte.T5Config(**kw), tte.T5Config(**kw)
    tree = random_tree(jte.T5Encoder(jcfg), jnp.zeros((1, 16), jnp.int32), seed=3)
    out["t5"] = (jtext.NativeEncoder("t5", tree, jcfg, jtok.unigram_from_sentencepiece(str(path))),
                 ttext.NativeEncoder("t5", bridge.params_from_flax(tree), tcfg,
                                     ttok.unigram_from_sentencepiece(str(path)), device="cpu"))
    return out


FAMILIES = {
    "sd15": (("clip_l",), {}),
    "sdxl": (("clip_l", "clip_g"), dict(height=768, width=1024)),
    "sd3": (("clip_l", "clip_g", "t5"), {}),
    "flux": (("clip_g", "t5"), dict(t5_length=32, guidance=3.5)),
    "wan": (("t5",), dict(t5_length=24)),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_encode_prompt_matches_jax(encoders, family):
    names, kw = FAMILIES[family]
    slots = {"clip_l": "clip_l", "clip_g": "clip_g", "t5": "t5"}
    if family == "flux":  # Flux's CLIP-L pooled: the projected tiny tower stands in
        slots = {"clip_g": "clip_l", "t5": "t5"}
    for prompt in ("a photo of the cat", "unicode café über ½"):
        with jax.default_matmul_precision("highest"):
            want = jtext.encode_prompt(prompt, family=family, **kw,
                                       **{slots[n]: encoders[n][0] for n in names})
        got = ttext.encode_prompt(prompt, family=family, **kw,
                                  **{slots[n]: encoders[n][1] for n in names})
        _same_cond(got, want)


# the special tokens of the Qwen chat templates, after the 256 byte symbols
QWEN_SPECIAL = ("<|im_start|>", "<|im_end|>", "<|vision_start|>", "<|image_pad|>",
                "<|vision_end|>")
QWEN_PAD_ID = 256 + QWEN_SPECIAL.index("<|image_pad|>")


def qwen_tokenizers():
    """(JAX, port) byte-level BPE tokenizers with the Qwen templates'
    special tokens: 256 byte symbols, two merges, ids 256-260 added."""
    vocab = {ch: i for i, ch in enumerate(sorted(jtok.bytes_to_unicode().values()))}
    merges = [("Ġ", "c"), ("Ġc", "a")]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    added = {t: 256 + i for i, t in enumerate(QWEN_SPECIAL)}
    vocab = {k: (v if v < 256 else v + len(added)) for k, v in vocab.items()}
    return tuple(lib.BpeTokenizer(vocab, merges, added_tokens=added) for lib in (jtok, ttok))


def qwen_llamas(dim=24, seed=10):
    """{"qwen25" / "qwen3": (JAX NativeEncoder, port NativeEncoder)} of tiny
    trunks over the tokenizers' 263 ids, and "vision": (JAX, port)
    VisionEncoder of the tiny tower (out_hidden 24, the Qwen2.5 width)."""
    jt, tt = qwen_tokenizers()
    out = {}
    for name, kw in (("qwen25", dict(heads=2, kv_heads=1, qkv_bias=True, rms_eps=1e-6,
                                     rope_theta=1e6, mrope_section=(2, 2, 2))),
                     ("qwen3", dict(heads=4, kv_heads=2, head_dim=8, qk_norm=True,
                                    rms_eps=1e-6, rope_theta=1e6))):
        kw = dict(vocab_size=263, dim=dim, layers=2, intermediate=40, **kw)
        jcfg, tcfg = jte.LlamaConfig(**kw), tte.LlamaConfig(**kw)
        tree = random_tree(jte.LlamaEncoder(jcfg), jnp.zeros((1, 8), jnp.int32), seed=seed)
        out[name] = (jtext.NativeEncoder("llama", tree, jcfg, jt),
                     ttext.NativeEncoder("llama", bridge.params_from_flax(tree), tcfg, tt,
                                         device="cpu"))
        seed += 1
    vcfg = jvision.TINY_VL_VISION_CONFIG
    tree = random_tree(jvision.QwenVLVision(vcfg, (1, 4, 4)), jnp.zeros((16, 24)), seed=seed)
    from lanpaint_tpu_torch.models import vision as tvision

    out["vision"] = (jtext.VisionEncoder(tree, vcfg),
                     ttext.VisionEncoder(bridge.params_from_flax(tree),
                                         tvision.TINY_VL_VISION_CONFIG, device="cpu"))
    return out


@pytest.fixture(scope="module")
def llamas():
    return qwen_llamas()


def _edit_image():
    return np.random.default_rng(12).uniform(0, 1, (22, 30, 3)).astype(np.float32)


@pytest.mark.parametrize("family", ["qwen", "qwen_edit", "qwen3", "hidream", "hyvideo", "nope"])
def test_encode_prompt_of_unported_families_raises(encoders, llamas, family):
    """qwen (the Qwen-Image template, its 34 prefix states dropped),
    qwen_edit (the source image's vision tokens spliced at <|image_pad|>,
    64 prefix states dropped), qwen3 (the bare final states), hidream (the
    Qwen2.5 trunk's per-layer states standing in for Llama-3.1's, CLIP-L
    pooled, T5; with CLIP-G as well, CLIP-G's pooled output follows
    CLIP-L's in the vec) and hyvideo (the image template, 36 prefix states
    cropped, CLIP-L pooled; and the video template, 95 cropped), once
    waiting, match JAX; an unknown family raises JAX's ValueError."""
    if family == "nope":
        with pytest.raises(ValueError) as want:
            jtext.encode_prompt("a cat", family=family)
        with pytest.raises(ValueError) as got:
            ttext.encode_prompt("a cat", family=family)
        assert str(got.value) == str(want.value)
        return
    if family in ("hidream", "hyvideo"):
        cases = ([dict(t5_length=24)] if family == "hidream"
                 else [{}, dict(video=True)])
        for prompt, kw in ((p, kw) for p in ("a photo of the cat", "unicode café über ½")
                           for kw in cases):
            libs = [dict(llama=enc, clip_l=clip) for enc, clip in
                    zip(llamas["qwen25"], encoders["clip_l"])]
            if family == "hidream":
                for lib, t5 in zip(libs, encoders["t5"]):
                    lib["t5"] = t5
            with jax.default_matmul_precision("highest"):
                want = jtext.encode_prompt(prompt, family=family, **kw, **libs[0])
            got = ttext.encode_prompt(prompt, family=family, **kw, **libs[1])
            _same_cond(got, want)
            want_keys = ["context", "llama", "vec"] if family == "hidream" else ["context", "vec"]
            assert sorted(got) == want_keys
            if family == "hidream":
                # with CLIP-G too (the port's own argument: HIDREAM_I1_CONFIG's
                # vec is CLIP-L's pooled 768 + CLIP-G's 1280), the same cond
                # but for the vec, which gains CLIP-G's pooled output
                both = ttext.encode_prompt(prompt, family=family, clip_g=encoders["clip_g"][1],
                                           **kw, **libs[1])
                _, _, pooled_g = encoders["clip_g"][1](prompt)
                for k in ("context", "llama"):
                    assert torch.equal(both[k], got[k])
                assert torch.equal(both["vec"], torch.cat([got["vec"], pooled_g], dim=-1))
        return
    stack = "qwen3" if family == "qwen3" else "qwen25"
    kw = {}
    if family == "qwen_edit":
        kw = dict(image_pad_id=QWEN_PAD_ID, image=_edit_image())
    for prompt in ("a photo of the cat", "unicode café über ½"):
        libs = [dict(llama=enc) for enc in llamas[stack]]
        if family == "qwen_edit":
            for lib, vis in zip(libs, llamas["vision"]):
                lib["vision"] = vis
        with jax.default_matmul_precision("highest"):
            want = jtext.encode_prompt(prompt, family=family, **kw, **libs[0])
        got = ttext.encode_prompt(prompt, family=family, **kw, **libs[1])
        _same_cond(got, want)
        assert got["context"].shape[-1] == 24


@pytest.mark.parametrize("arg", ["llama", "vision", "image"])
@pytest.mark.parametrize("family", ["sd15", "wan"])
def test_encode_prompt_refuses_the_llama_stack_arguments(encoders, llamas, family, arg):
    """The JAX signature's llama / vision / image arguments, once waiting,
    are taken: a family that does not use one gives JAX's cond with it."""
    values = {"llama": llamas["qwen25"], "vision": llamas["vision"],
              "image": (_edit_image(),) * 2}[arg]
    kw = dict(t5=encoders["t5"], t5_length=(24, 24)) if family == "wan" else dict(
        clip_l=encoders["clip_l"])
    with jax.default_matmul_precision("highest"):
        want = jtext.encode_prompt("a cat", family=family, **{k: v[0] for k, v in kw.items()},
                                   **{arg: values[0]})
    got = ttext.encode_prompt("a cat", family=family, **{k: v[1] for k, v in kw.items()},
                              **{arg: values[1]})
    _same_cond(got, want)


@pytest.mark.parametrize("name", ["QWEN_IMAGE_TEMPLATE", "QWEN_IMAGE_EDIT_TEMPLATE",
                                  "HYVIDEO_IMAGE_TEMPLATE", "HYVIDEO_VIDEO_TEMPLATE",
                                  "QWEN_EDIT_DROP_PREFIX", "QWEN_VL_IMAGE_PAD_ID",
                                  "HYVIDEO_IMAGE_CROP", "HYVIDEO_VIDEO_CROP"])
def test_templates_and_constants_match_jax(name):
    assert getattr(ttext, name) == getattr(jtext, name)


class _FakeHFClip(torch.nn.Module):
    """A HuggingFace CLIPTextModel(WithProjection)'s call contract in a few
    layers: `model(input_ids=..., output_hidden_states=True)` -> hidden
    states, last_hidden_state, pooler_output, and text_embeds with a
    projection."""

    def __init__(self, width, proj, seed):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.emb = torch.nn.Parameter(torch.randn(64, width, generator=g))
        self.layers = torch.nn.ParameterList(
            torch.nn.Parameter(torch.randn(width, width, generator=g) / width**0.5)
            for _ in range(2))
        self.proj = torch.nn.Parameter(torch.randn(width, proj, generator=g)) if proj else None

    def forward(self, input_ids, output_hidden_states=False):
        hs = [self.emb[input_ids]]
        for w in self.layers:
            hs.append(torch.tanh(hs[-1] @ w))
        pooled = hs[-1][:, 4]
        out = types.SimpleNamespace(hidden_states=tuple(hs), last_hidden_state=hs[-1],
                                    pooler_output=pooled)
        if self.proj is not None:
            out.text_embeds = pooled @ self.proj
        return out


@pytest.mark.parametrize("family", ["sd15", "sdxl"])
def test_encode_prompt_hf_matches_jax(family):
    def tokenizer(texts, **_):
        ids = torch.full((len(texts), 77), 2, dtype=torch.long)
        ids[:, 0], ids[:, 1:5] = 1, torch.arange(10, 14)
        return {"input_ids": ids}

    kw = dict(clip_l=_FakeHFClip(16, 0, 0), clip_g=_FakeHFClip(24, 12, 1), tokenizer_l=tokenizer,
              tokenizer_g=tokenizer, family=family)
    _same_cond(ttext.encode_prompt_hf("a cat", **kw), jtext.encode_prompt_hf("a cat", **kw))
