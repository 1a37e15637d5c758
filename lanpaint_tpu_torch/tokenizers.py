"""Standalone tokenizers: prompt string -> token ids, no runtime downloads.

The reference delegates tokenization to its ComfyUI host's CLIP loader
nodes; a standalone framework needs prompt -> ids natively.  These are
pure-Python implementations of the three vocab formats the supported text
encoders ship with (the user supplies the vocab files next to the model
checkpoints, exactly as they supply the weights):

- `ClipBpeTokenizer` — CLIP's lowercased, end-of-word-marked byte BPE
  (vocab.json + merges.txt): SD1.x/2.x, SDXL, SD3.5 CLIP-L/G, Flux CLIP-L.
- `BpeTokenizer` — HF tokenizer.json byte-level BPE (GPT-2/Llama-3/Qwen2
  style, incl. `ignore_merges` and a Split pre-tokenizer regex): HiDream's
  Llama-3.1, Qwen-Image's Qwen2.5.
- `UnigramTokenizer` — HF tokenizer.json SentencePiece-Unigram with
  Metaspace pre-tokenization, Viterbi segmentation and byte fallback:
  T5-XXL (SD3.5/Flux/HiDream) and UMT5-XXL (Wan2.2).

`from_tokenizer_json(path)` auto-detects BPE vs Unigram.  Golden-tested
against the HF `tokenizers` runtime over randomized corpora
(tests/test_tokenizers.py).
"""

from __future__ import annotations

import functools
import json
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

try:  # \p{L}/\p{N} classes need the third-party regex module
    import regex as _re
except ImportError:  # pragma: no cover
    import re as _re  # type: ignore[no-redef]


# --------------------------------------------------------------------------
# byte-level plumbing (GPT-2 convention, shared by CLIP and byte-level BPE)


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAC + 1)) + list(range(0xAE, 0xFF + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _get_pairs(word: Sequence[str]) -> set:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _bpe_merge(word: Tuple[str, ...], ranks: Dict[Tuple[str, str], int]
               ) -> Tuple[str, ...]:
    """Iteratively apply the lowest-rank merge (the standard BPE loop)."""
    while len(word) > 1:
        pairs = _get_pairs(word)
        best = min(pairs, key=lambda p: ranks.get(p, 1 << 60))
        if best not in ranks:
            break
        first, second = best
        out: List[str] = []
        i = 0
        while i < len(word):
            if (i < len(word) - 1 and word[i] == first
                    and word[i + 1] == second):
                out.append(first + second)
                i += 2
            else:
                out.append(word[i])
                i += 1
        word = tuple(out)
    return word


# --------------------------------------------------------------------------
# CLIP BPE


_CLIP_PATTERN = (r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
                 r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+")


class ClipBpeTokenizer:
    """CLIP text tokenizer from vocab.json + merges.txt.

    Encoding convention (the one every SD/SDXL/SD3/Flux text stack uses):
    lowercase + whitespace-collapse, byte-to-unicode, per-word BPE with the
    `</w>` end-of-word marker, then `[bos] tokens [eos]` padded to
    `context_length` (77) with `pad_token_id` (defaults to eos, the CLIP-L
    convention; CLIP-G checkpoints pad with 0).
    """

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 bos_token_id: int = 49406, eos_token_id: int = 49407,
                 pad_token_id: Optional[int] = None, context_length: int = 77):
        self.vocab = vocab
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.bos_token_id = bos_token_id
        self.eos_token_id = eos_token_id
        self.pad_token_id = eos_token_id if pad_token_id is None else pad_token_id
        self.context_length = context_length
        self.byte_encoder = bytes_to_unicode()
        self._pat = _re.compile(_CLIP_PATTERN, _re.IGNORECASE)
        self._cache: Dict[str, Tuple[str, ...]] = {}

    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str, **kw
                   ) -> "ClipBpeTokenizer":
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(merges_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        return cls(vocab, merges, **kw)

    def _bpe(self, token: str) -> Tuple[str, ...]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        word = _bpe_merge(word, self.ranks)
        self._cache[token] = word
        return word

    def tokenize(self, text: str) -> List[int]:
        text = _re.sub(r"\s+", " ", text).strip().lower()
        ids: List[int] = []
        for tok in self._pat.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.vocab[p] for p in self._bpe(tok))
        return ids

    def encode(self, text: str) -> List[int]:
        """[bos] + tokens (truncated) + [eos], padded to context_length."""
        ids = self.tokenize(text)[: self.context_length - 2]
        full = [self.bos_token_id] + ids + [self.eos_token_id]
        full += [self.pad_token_id] * (self.context_length - len(full))
        return full


# --------------------------------------------------------------------------
# HF tokenizer.json byte-level BPE (GPT-2 / Llama-3 / Qwen2)


_GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"
                 r" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")


class BpeTokenizer:
    """Byte-level BPE from an HF tokenizer.json (model.type == "BPE")."""

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 pattern: str = _GPT2_PATTERN, ignore_merges: bool = False,
                 added_tokens: Optional[Dict[str, int]] = None,
                 add_prefix_space: bool = False):
        self.vocab = vocab
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.ignore_merges = ignore_merges
        self.added = dict(added_tokens or {})
        self.add_prefix_space = add_prefix_space
        self.byte_encoder = bytes_to_unicode()
        self._pat = _re.compile(pattern)
        if self.added:
            self._added_pat = _re.compile(
                "(" + "|".join(_re.escape(t) for t in
                               sorted(self.added, key=len, reverse=True)) + ")")
        else:
            self._added_pat = None
        self._cache: Dict[str, Tuple[str, ...]] = {}

    def _bpe(self, token: str) -> Tuple[str, ...]:
        if self.ignore_merges and token in self.vocab:
            return (token,)
        if token in self._cache:
            return self._cache[token]
        word = _bpe_merge(tuple(token), self.ranks)
        self._cache[token] = word
        return word

    def _encode_chunk(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in self._pat.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.vocab[p] for p in self._bpe(tok))
        return ids

    def encode(self, text: str) -> List[int]:
        if self.add_prefix_space and text and not text[0].isspace():
            text = " " + text
        if self._added_pat is None:
            return self._encode_chunk(text)
        ids: List[int] = []
        for part in self._added_pat.split(text):
            if not part:
                continue
            if part in self.added:
                ids.append(self.added[part])
            else:
                ids.extend(self._encode_chunk(part))
        return ids


# --------------------------------------------------------------------------
# HF tokenizer.json SentencePiece-Unigram (T5 / UMT5)


class UnigramTokenizer:
    """Unigram LM tokenizer (model.type == "Unigram") with Metaspace
    pre-tokenization, Viterbi segmentation and optional byte fallback.

    Normalization approximates the precompiled nmt-NFKC charsmap with
    NFKC + whitespace collapse — exact for ASCII prompts, documented
    approximation beyond.
    """

    SPACE = "▁"  # '▁'

    def __init__(self, pieces: List[Tuple[str, float]], unk_id: int,
                 byte_fallback: bool = False, eos_token_id: Optional[int] = 1,
                 added_tokens: Optional[Dict[str, int]] = None,
                 nfkc: bool = True):
        self.pieces = {p: (i, s) for i, (p, s) in enumerate(pieces)}
        self.unk_id = unk_id
        self.byte_fallback = byte_fallback
        self.eos_token_id = eos_token_id
        self.added = dict(added_tokens or {})
        self.nfkc = nfkc
        self.max_piece_len = max((len(p) for p, _ in pieces), default=1)
        if self.added:
            self._added_pat = _re.compile(
                "(" + "|".join(_re.escape(t) for t in
                               sorted(self.added, key=len, reverse=True)) + ")")
        else:
            self._added_pat = None

    def _viterbi(self, text: str) -> List[int]:
        n = len(text)
        best = [float("-inf")] * (n + 1)
        back: List[Optional[Tuple[int, str]]] = [None] * (n + 1)
        best[0] = 0.0
        unk_penalty = min((s for _, s in self.pieces.values()), default=0.0) - 10.0
        for i in range(n):
            if best[i] == float("-inf"):
                continue
            for j in range(i + 1, min(n, i + self.max_piece_len) + 1):
                sub = text[i:j]
                if sub in self.pieces:
                    _, score = self.pieces[sub]
                    if best[i] + score > best[j]:
                        best[j] = best[i] + score
                        back[j] = (i, sub)
            # unk: single char fallback keeps the lattice connected
            j = i + 1
            if best[i] + unk_penalty > best[j]:
                best[j] = best[i] + unk_penalty
                back[j] = (i, text[i:j])
        out: List[int] = []
        pos = n
        rev: List[int] = []
        while pos > 0:
            i, sub = back[pos]  # type: ignore[misc]
            if sub in self.pieces:
                rev.append(self.pieces[sub][0])
            elif self.byte_fallback:
                for b in reversed(sub.encode("utf-8")):
                    bp = f"<0x{b:02X}>"
                    rev.append(self.pieces[bp][0]
                               if bp in self.pieces else self.unk_id)
            else:
                rev.append(self.unk_id)
            pos = i
        out.extend(reversed(rev))
        # merge consecutive unks (sentencepiece emits one unk per run)
        merged: List[int] = []
        for t in out:
            if t == self.unk_id and merged and merged[-1] == self.unk_id:
                continue
            merged.append(t)
        return merged

    def _encode_chunk(self, text: str, first: bool) -> List[int]:
        if self.nfkc:
            text = unicodedata.normalize("NFKC", text)
        text = _re.sub(r"\s+", " ", text)
        if first:
            text = text.strip()
        text = text.replace(" ", self.SPACE)
        if first and not text.startswith(self.SPACE):
            text = self.SPACE + text  # Metaspace prepend_scheme
        if not text:
            return []
        # Metaspace split=True: segment before each SPACE marker, Viterbi
        # runs per word (pieces never span word boundaries)
        words = [self.SPACE + w for w in text.split(self.SPACE)[1:]] \
            if text.startswith(self.SPACE) else \
            [text.split(self.SPACE)[0]] + \
            [self.SPACE + w for w in text.split(self.SPACE)[1:]]
        ids: List[int] = []
        for w in words:
            if w:
                ids.extend(self._viterbi(w))
        return ids

    def encode(self, text: str, add_eos: bool = True,
               max_length: Optional[int] = None,
               pad_to: Optional[int] = None, pad_id: int = 0) -> List[int]:
        if self._added_pat is None:
            ids = self._encode_chunk(text, first=True)
        else:
            ids = []
            first = True
            for part in self._added_pat.split(text):
                if not part:
                    continue
                if part in self.added:
                    ids.append(self.added[part])
                else:
                    ids.extend(self._encode_chunk(part, first=first))
                first = False
        if add_eos and self.eos_token_id is not None:
            ids.append(self.eos_token_id)
        if max_length is not None and len(ids) > max_length:
            ids = ids[:max_length]
            if add_eos and self.eos_token_id is not None:
                ids[-1] = self.eos_token_id
        if pad_to is not None:
            ids = ids + [pad_id] * (pad_to - len(ids))
        return ids


# --------------------------------------------------------------------------
# tokenizer.json loader


def _split_pattern_from_pretokenizer(pre) -> Optional[str]:
    if pre is None:
        return None
    if pre.get("type") == "Sequence":
        for sub in pre["pretokenizers"]:
            pat = _split_pattern_from_pretokenizer(sub)
            if pat is not None:
                return pat
        return None
    if pre.get("type") == "Split":
        pat = pre["pattern"]
        return pat.get("Regex") or pat.get("String")
    if pre.get("type") == "ByteLevel" and pre.get("use_regex", True):
        return _GPT2_PATTERN
    return None


def _bytelevel_prefix_space(pre) -> bool:
    if pre is None:
        return False
    if pre.get("type") == "Sequence":
        return any(_bytelevel_prefix_space(s) for s in pre["pretokenizers"])
    return bool(pre.get("type") == "ByteLevel"
                and pre.get("add_prefix_space", False))


def from_tokenizer_json(path: str):
    """Load a BpeTokenizer or UnigramTokenizer from an HF tokenizer.json."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return from_tokenizer_dict(data)


def from_tokenizer_dict(data: dict):
    model = data["model"]
    added = {t["content"]: t["id"] for t in data.get("added_tokens", [])}
    if model["type"] == "BPE":
        merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
                  for m in model["merges"]]
        pat = _split_pattern_from_pretokenizer(data.get("pre_tokenizer"))
        return BpeTokenizer(
            model["vocab"], merges, pattern=pat or _GPT2_PATTERN,
            ignore_merges=model.get("ignore_merges", False),
            added_tokens=added,
            add_prefix_space=_bytelevel_prefix_space(data.get("pre_tokenizer")))
    if model["type"] == "Unigram":
        pieces = [(p, s) for p, s in model["vocab"]]
        eos = added.get("</s>", 1)
        return UnigramTokenizer(pieces, unk_id=model.get("unk_id", 0),
                                byte_fallback=model.get("byte_fallback", False),
                                eos_token_id=eos, added_tokens=added)
    raise ValueError(f"unsupported tokenizer model type {model['type']!r}")


# --------------------------------------------------------------------------
# sentencepiece .model (protobuf) reader — T5 checkpoints often ship
# spiece.model instead of tokenizer.json; this parses just the piece list
# (field 1: repeated SentencePiece{piece=1:string, score=2:float, type=3:enum})


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def load_sentencepiece_model(path: str) -> List[Tuple[str, float, int]]:
    """Returns [(piece, score, type)] — type 1=normal 2=unk 3=control 6=byte."""
    import struct

    with open(path, "rb") as f:
        buf = f.read()
    pieces: List[Tuple[str, float, int]] = []
    i = 0
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # SentencePiece submessage
            ln, i = _read_varint(buf, i)
            sub = buf[i:i + ln]
            i += ln
            piece, score, ptype = "", 0.0, 1
            j = 0
            while j < len(sub):
                t, j = _read_varint(sub, j)
                f2, w2 = t >> 3, t & 7
                if f2 == 1 and w2 == 2:
                    sl, j = _read_varint(sub, j)
                    piece = sub[j:j + sl].decode("utf-8")
                    j += sl
                elif f2 == 2 and w2 == 5:
                    score = struct.unpack("<f", sub[j:j + 4])[0]
                    j += 4
                elif f2 == 3 and w2 == 0:
                    ptype, j = _read_varint(sub, j)
                elif w2 == 2:
                    sl, j = _read_varint(sub, j)
                    j += sl
                elif w2 == 0:
                    _, j = _read_varint(sub, j)
                elif w2 == 5:
                    j += 4
                elif w2 == 1:
                    j += 8
            pieces.append((piece, score, ptype))
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            i += ln
        elif wire == 0:
            _, i = _read_varint(buf, i)
        elif wire == 5:
            i += 4
        elif wire == 1:
            i += 8
    return pieces


def unigram_from_sentencepiece(path: str, **kw) -> UnigramTokenizer:
    raw = load_sentencepiece_model(path)
    pieces = [(p, s) for p, s, _t in raw]
    unk_id = next((i for i, (_p, _s, t) in enumerate(raw) if t == 2), 0)
    byte_fallback = any(t == 6 for _p, _s, t in raw)
    return UnigramTokenizer(pieces, unk_id=unk_id,
                            byte_fallback=byte_fallback, **kw)
