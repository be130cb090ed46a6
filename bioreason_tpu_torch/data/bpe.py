r"""Byte-level BPE tokenizer from an HF `tokenizer.json`, on the standard
library alone (the port of bioreason_tpu/data/bpe.py, which needs the
`regex` module).

The reference's text tokenizer is the HF Qwen fast tokenizer
(dna_llm.py:67-74). This module reads the same file with no dependency on
`transformers`, `tokenizers` or `regex`. The split patterns of Qwen2/Qwen3
and GPT-2 use the Unicode classes `\p{L}` and `\p{N}`, which `re` lacks:
`translate_pattern` rewrites them into explicit character classes read
once from `unicode_classes.json` beside this module: the ranges the `regex`
module gives them, written by `tools/unicode_classes.py`. They are not
taken from `unicodedata`, whose Unicode version is the Python's and may be
older than `regex`'s (Python 3.12's 15.0.0 leaves out 9,568 letters and 93
numbers that `regex` 2026.7.19 has), nor from `[^\W\d_]`, which takes
letter-like marks and leaves out letters (and `\d` is Nd alone). `\s` and
`\S` are rewritten too: `re`'s `\s` also matches U+001C..U+001F, which are not
Unicode White_Space, as `regex` and HF's tokenizers read `\s`. Scoped
`(?i:...)` and `(?!\S)` work in `re` as they are.

Supported `tokenizer.json` features (everything Qwen2/Qwen3 and GPT-2
tokenizers use):
  * model.type == "BPE" with vocab + merges (string or pair form);
  * normalizer: none or NFC / NFKC / NFD / NFKD;
  * pre_tokenizer: ByteLevel (with or without its GPT-2 regex,
    add_prefix_space), Split(Regex or String, behavior Isolated / Removed),
    or a Sequence of those;
  * added_tokens with `special` flags (split out before normalization).

Anything else raises `UnsupportedTokenizerError`, naming the feature.
"""

from __future__ import annotations

import functools
import json
import os
import re
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# tiktoken/GPT-2 byte-level split pattern (a ByteLevel pre-tokenizer with
# use_regex=true)
GPT2_SPLIT = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"
              r" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")

# the `regex` module's \p{L} and \p{N} (tools/unicode_classes.py writes it)
_CLASSES_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "unicode_classes.json")
# Unicode White_Space (PropList.txt): `regex`'s and the HF tokenizers' \s
_WHITE_SPACE = ((0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0), (0x1680, 0x1680),
                (0x2000, 0x200A), (0x2028, 0x2029), (0x202F, 0x202F), (0x205F, 0x205F),
                (0x3000, 0x3000))


class UnsupportedTokenizerError(ValueError):
    pass


@functools.lru_cache(maxsize=1)
def _unicode_classes() -> Dict[str, Tuple[Tuple[int, int], ...]]:
    with open(_CLASSES_PATH) as f:
        raw = json.load(f)
    return {name: tuple((a, b) for a, b in raw[name]) for name in ("L", "N")}


def unicode_class(name: str) -> Tuple[Tuple[int, int], ...]:
    """The code point ranges of `\\p{name}` for name L or N, as the `regex`
    module reads them (`unicode_classes.json`, read once)."""
    classes = _unicode_classes()
    if name not in classes:
        raise UnsupportedTokenizerError(f"unicode class \\p{{{name}}}")
    return classes[name]


def _class_body(ranges) -> str:
    def esc(c: int) -> str:
        return f"\\U{c:08x}"
    return "".join(esc(a) if a == b else f"{esc(a)}-{esc(b)}" for a, b in ranges)


def translate_pattern(pattern: str) -> str:
    """A `regex`-module pattern as a `re` pattern: `\\p{L}`, `\\p{N}`,
    `\\P{..}`, `\\s` and `\\S` become explicit classes (inside a bracketed
    class, their ranges are inlined). Raises on a negated class inside a
    bracketed class, which `re` cannot express."""
    out: List[str] = []
    i, n, in_class = 0, len(pattern), False
    while i < n:
        c = pattern[i]
        if c == "\\" and i + 1 < n:
            nxt = pattern[i + 1]
            if nxt in "pP" and i + 2 < n and pattern[i + 2] == "{":
                end = pattern.index("}", i)
                body = _class_body(unicode_class(pattern[i + 3:end]))
                neg = nxt == "P"
                i = end + 1
            elif nxt in "sS":
                body, neg = _class_body(_WHITE_SPACE), nxt == "S"
                i += 2
            else:
                out.append(pattern[i:i + 2])
                i += 2
                continue
            if in_class:
                if neg:
                    raise UnsupportedTokenizerError(f"a negated class inside [...] in {pattern!r}")
                out.append(body)
            else:
                out.append(f"[{'^' if neg else ''}{body}]")
            continue
        if in_class and c == "]":
            in_class = False
        elif not in_class and c == "[":
            in_class = True
            out.append(c)
            i += 1
            # a leading ^ and a leading ] belong to the class
            if i < n and pattern[i] == "^":
                out.append("^")
                i += 1
            if i < n and pattern[i] == "]":
                out.append("\\]")
                i += 1
            continue
        out.append(c)
        i += 1
    return "".join(out)


def compile_pattern(pattern: str) -> "re.Pattern":
    return re.compile(translate_pattern(pattern))


@functools.lru_cache(maxsize=1)
def byte_encoder() -> Dict[int, str]:
    """GPT-2 bytes->unicode alphabet (the printable stand-ins BPE runs on)."""
    bs = (list(range(ord("!"), ord("~") + 1)) +
          list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


@functools.lru_cache(maxsize=1)
def byte_decoder() -> Dict[str, int]:
    return {c: b for b, c in byte_encoder().items()}


class _PreTokenizer:
    """Composed split pipeline from the tokenizer.json pre_tokenizer spec."""

    def __init__(self, spec: Optional[dict]):
        self.steps: List[Tuple[object, str]] = []   # (compiled, behavior)
        self.add_prefix_space = False
        for sub in self._flatten(spec):
            t = sub.get("type")
            if t == "ByteLevel":
                self.add_prefix_space = bool(sub.get("add_prefix_space", True))
                if sub.get("use_regex", True):
                    self.steps.append((compile_pattern(GPT2_SPLIT), "isolated"))
                # the byte mapping itself happens during BPE encoding
            elif t == "Split":
                pat = sub.get("pattern", {})
                if "Regex" in pat:
                    compiled = compile_pattern(pat["Regex"])
                elif "String" in pat:
                    compiled = re.compile(re.escape(pat["String"]))
                else:
                    raise UnsupportedTokenizerError(f"Split pattern {pat}")
                behavior = sub.get("behavior", "Isolated").lower()
                if behavior not in ("isolated", "removed"):
                    raise UnsupportedTokenizerError(f"Split behavior {behavior}")
                if sub.get("invert"):
                    raise UnsupportedTokenizerError("Split invert=true")
                self.steps.append((compiled, behavior))
            else:
                raise UnsupportedTokenizerError(f"pre_tokenizer {t}")

    @staticmethod
    def _flatten(spec: Optional[dict]) -> List[dict]:
        if spec is None:
            return []
        if spec.get("type") == "Sequence":
            out = []
            for sub in spec.get("pretokenizers", []):
                out.extend(_PreTokenizer._flatten(sub))
            return out
        return [spec]

    def split(self, text: str) -> List[str]:
        if self.add_prefix_space and text and not text.startswith(" "):
            text = " " + text
        pieces = [text]
        for compiled, behavior in self.steps:
            nxt: List[str] = []
            for piece in pieces:
                pos = 0
                for m in compiled.finditer(piece):
                    if m.start() > pos:
                        nxt.append(piece[pos:m.start()])
                    if behavior == "isolated" and m.group():
                        nxt.append(m.group())
                    pos = m.end()
                if pos < len(piece):
                    nxt.append(piece[pos:])
            pieces = nxt
        return [p for p in pieces if p]


class BPETokenizer:
    """Byte-level BPE with the ByteTextTokenizer interface. Construct with
    `BPETokenizer.from_dir(path)` (a directory holding `tokenizer.json` and
    optionally `tokenizer_config.json`) or `from_tokenizer_json(file)`."""

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 pre_tokenizer: Optional[dict] = None,
                 normalizer: Optional[dict] = None,
                 added_tokens: Sequence[dict] = (),
                 eos_token: Optional[str] = None,
                 pad_token: Optional[str] = None):
        self.vocab = dict(vocab)
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.pre = _PreTokenizer(pre_tokenizer)
        self.normalizer = self._check_normalizer(normalizer)
        self._be = byte_encoder()
        self._bd = byte_decoder()
        self._bpe_cache: Dict[str, List[str]] = {}

        # added tokens: split out before normalization, own ids, special flag
        self.added: Dict[str, int] = {}
        self._special_ids: set = set()
        next_id = (max(self.vocab.values()) + 1) if self.vocab else 0
        for at in added_tokens:
            content, tid = at["content"], at.get("id")
            if tid is None:
                tid = next_id
            self.added[content] = tid
            next_id = max(next_id, tid + 1)
            if at.get("special"):
                self._special_ids.add(tid)
        self._rebuild_added_regex()

        self.id_to_token: Dict[int, str] = {v: k for k, v in self.vocab.items()}
        self.id_to_added: Dict[int, str] = {v: k for k, v in self.added.items()}

        all_tokens = {**self.vocab, **self.added}
        self.eos_token = eos_token or next(
            (t for t in ("<|im_end|>", "<|endoftext|>", "</s>") if t in all_tokens), None)
        if self.eos_token is None:
            raise UnsupportedTokenizerError("no eos token found")
        self.eos_token_id = all_tokens[self.eos_token]
        # the reference sets pad = eos (dna_llm.py:70)
        self.pad_token = pad_token or self.eos_token
        self.pad_token_id = all_tokens[self.pad_token]

    # -- construction ------------------------------------------------------

    @classmethod
    def from_tokenizer_json(cls, path: str, **kw) -> "BPETokenizer":
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        model = spec.get("model", {})
        if model.get("type") != "BPE":
            raise UnsupportedTokenizerError(f"model type {model.get('type')}")
        for field in ("continuing_subword_prefix", "end_of_word_suffix"):
            if model.get(field):
                raise UnsupportedTokenizerError(f"BPE {field}")
        merges = [tuple(m) if isinstance(m, list) else tuple(m.split(" ", 1))
                  for m in model.get("merges", [])]
        return cls(vocab=model.get("vocab", {}), merges=merges,
                   pre_tokenizer=spec.get("pre_tokenizer"),
                   normalizer=spec.get("normalizer"),
                   added_tokens=spec.get("added_tokens", []), **kw)

    @classmethod
    def from_dir(cls, path: str) -> "BPETokenizer":
        tj = os.path.join(path, "tokenizer.json")
        if not os.path.exists(tj):
            raise UnsupportedTokenizerError(f"no tokenizer.json in {path}")
        eos = pad = None
        cfg_path = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                cfg = json.load(f)
            eos = _token_content(cfg.get("eos_token"))
            pad = _token_content(cfg.get("pad_token"))
        return cls.from_tokenizer_json(tj, eos_token=eos, pad_token=pad)

    @staticmethod
    def _check_normalizer(spec: Optional[dict]):
        if spec is None:
            return None
        if spec.get("type") in ("NFC", "NFKC", "NFD", "NFKD"):
            return spec["type"]
        raise UnsupportedTokenizerError(f"normalizer {spec.get('type')}")

    def _rebuild_added_regex(self):
        if self.added:
            pat = "|".join(re.escape(t) for t in sorted(self.added, key=len, reverse=True))
            self._added_re = re.compile(f"({pat})")
        else:
            self._added_re = None

    # -- special-token management ------------------------------------------

    def add_special_tokens(self, tokens: Iterable[str]) -> int:
        """Append new special tokens (HF add_special_tokens semantics: new
        ids continue after the current max id). Returns the number added."""
        n = 0
        next_id = max(list(self.vocab.values()) + list(self.added.values())) + 1
        for t in tokens:
            if t in self.added or t in self.vocab:
                continue
            self.added[t] = next_id
            self.id_to_added[next_id] = t
            self._special_ids.add(next_id)
            next_id += 1
            n += 1
        if n:
            self._rebuild_added_regex()
        return n

    # -- core BPE ------------------------------------------------------------

    def _bpe(self, piece: str) -> List[str]:
        """piece: unicode-alphabet string (bytes already mapped)."""
        cached = self._bpe_cache.get(piece)
        if cached is not None:
            return cached
        word = list(piece)
        while len(word) > 1:
            best_rank, best_pair = None, None
            for pair in zip(word, word[1:]):
                r = self.ranks.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_pair = r, pair
            if best_pair is None:
                break
            merged, i = [], 0
            a, b = best_pair
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._bpe_cache[piece] = word
        return word

    def _encode_segment(self, text: str) -> List[int]:
        if self.normalizer:
            text = unicodedata.normalize(self.normalizer, text)
        ids: List[int] = []
        for pre in self.pre.split(text):
            mapped = "".join(self._be[b] for b in pre.encode("utf-8"))
            for piece in self._bpe(mapped):
                tid = self.vocab.get(piece)
                if tid is not None:
                    ids.append(tid)
                else:                      # degenerate vocab: per-char fallback
                    ids.extend(self.vocab[c] for c in piece if c in self.vocab)
        return ids

    # -- public interface (ByteTextTokenizer-compatible) ---------------------

    @property
    def vocab_size(self) -> int:
        # HF len(tokenizer): distinct ids across vocab + added
        return len(set(self.vocab.values()) | set(self.added.values()))

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        if self._added_re is None:
            return self._encode_segment(text)
        ids: List[int] = []
        for part in self._added_re.split(text):
            if not part:
                continue
            tid = self.added.get(part)
            if tid is not None:
                ids.append(tid)
            else:
                ids.extend(self._encode_segment(part))
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        out: List[str] = []
        buf = bytearray()

        def flush():
            if buf:
                out.append(buf.decode("utf-8", errors="replace"))
                buf.clear()

        for i in ids:
            i = int(i)
            added = self.id_to_added.get(i)
            if added is not None:
                flush()
                if skip_special_tokens and i in self._special_ids:
                    continue
                out.append(added)
                continue
            tok = self.id_to_token.get(i)
            if tok is None:
                continue
            if skip_special_tokens and i in self._special_ids:
                flush()
                continue
            for c in tok:
                b = self._bd.get(c)
                if b is None:            # a character outside the byte alphabet
                    flush()
                    out.append(c)
                else:
                    buf.append(b)
        flush()
        return "".join(out)

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch]

    def convert_tokens_to_ids(self, token: str):
        if token in self.added:
            return self.added[token]
        return self.vocab.get(token)

    def convert_ids_to_tokens(self, i: int) -> Optional[str]:
        return self.id_to_token.get(i) or self.id_to_added.get(i)

    def __call__(self, texts, max_length: Optional[int] = None, padding: bool = True,
                 truncation: bool = True, padding_side: str = "left",
                 pad_to: Optional[int] = None, add_special_tokens: bool = False):
        if isinstance(texts, str):
            texts = [texts]
        encoded = [self.encode(t) for t in texts]
        if truncation and max_length is not None:
            encoded = [e[:max_length] for e in encoded]
        if not padding:
            return {"input_ids": encoded,
                    "attention_mask": [[1] * len(e) for e in encoded]}
        width = pad_to if pad_to is not None else (
            max(len(e) for e in encoded) if encoded else 0)
        n = len(encoded)
        input_ids = np.full((n, width), self.pad_token_id, dtype=np.int32)
        attention_mask = np.zeros((n, width), dtype=np.int32)
        for r, e in enumerate(encoded):
            e = e[:width]
            if padding_side == "left":
                input_ids[r, width - len(e):] = e
                attention_mask[r, width - len(e):] = 1
            else:
                input_ids[r, :len(e)] = e
                attention_mask[r, :len(e)] = 1
        return {"input_ids": input_ids, "attention_mask": attention_mask}


def _token_content(t) -> Optional[str]:
    if t is None:
        return None
    if isinstance(t, dict):
        return t.get("content")
    return str(t)
