"""Byte-level text tokenizer with the Qwen3 special-token surface (+DNA
tokens), the port's copy of bioreason_tpu/data/text_tokenizer.py:40-128.

Token id == byte value for 0..255; atomic tokens occupy ids 256+. The
reference appends `<|dna_start|>`, `<|dna_pad|>`, `<|dna_end|>` to the Qwen
tokenizer (dna_llm.py:72-74) and sets `pad_token = eos_token` (:70).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

import numpy as np

# `special=True` tokens are removed by skip_special_tokens decoding;
# <think>/</think> are atomic but NOT special (Qwen3 keeps them in decoded
# text, which reward parsing depends on — reference reason.py:117-121).
SPECIAL_TOKENS: List[str] = [
    "<|endoftext|>", "<|im_start|>", "<|im_end|>",
    "<|dna_start|>", "<|dna_pad|>", "<|dna_end|>",
]
ATOMIC_NONSPECIAL_TOKENS: List[str] = ["<think>", "</think>", "<tool_call>", "</tool_call>"]


class ByteTextTokenizer:
    """Byte-level tokenizer with Qwen3-style special tokens.

    ids 0..255   : raw bytes
    ids 256..    : SPECIAL_TOKENS + ATOMIC_NONSPECIAL_TOKENS in order
    """

    def __init__(self):
        self._atomic = SPECIAL_TOKENS + ATOMIC_NONSPECIAL_TOKENS
        self.token_to_id: Dict[str, int] = {t: 256 + i for i, t in enumerate(self._atomic)}
        self._id_to_token = {v: k for k, v in self.token_to_id.items()}
        self._special_ids = {self.token_to_id[t] for t in SPECIAL_TOKENS}
        pat = "|".join(re.escape(t) for t in sorted(self._atomic, key=len, reverse=True))
        self._split_re = re.compile(f"({pat})")

        self.eos_token = "<|im_end|>"          # Qwen3 chat eos
        self.eos_token_id = self.token_to_id[self.eos_token]
        self.pad_token = self.eos_token
        self.pad_token_id = self.eos_token_id
        self.dna_start_id = self.token_to_id["<|dna_start|>"]
        self.dna_pad_id = self.token_to_id["<|dna_pad|>"]
        self.dna_end_id = self.token_to_id["<|dna_end|>"]

    @property
    def vocab_size(self) -> int:
        return 256 + len(self._atomic)

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids: List[int] = []
        for part in self._split_re.split(text):
            if not part:
                continue
            if part in self.token_to_id:
                ids.append(self.token_to_id[part])
            else:
                ids.extend(part.encode("utf-8"))
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        out: List[str] = []
        buf = bytearray()
        for i in ids:
            i = int(i)
            if i >= 256:
                if buf:
                    out.append(buf.decode("utf-8", errors="replace"))
                    buf = bytearray()
                if skip_special_tokens and i in self._special_ids:
                    continue
                out.append(self._id_to_token.get(i, ""))
            else:
                buf.append(i)
        if buf:
            out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch]

    def convert_tokens_to_ids(self, token: str) -> int:
        return self.token_to_id[token]

    def __call__(self, texts, max_length: Optional[int] = None, padding: bool = True,
                 truncation: bool = True, padding_side: str = "left",
                 pad_to: Optional[int] = None, add_special_tokens: bool = False):
        if isinstance(texts, str):
            texts = [texts]
        encoded = [self.encode(t) for t in texts]
        if truncation and max_length is not None:
            encoded = [e[:max_length] for e in encoded]
        if not padding:
            return {"input_ids": encoded, "attention_mask": [[1] * len(e) for e in encoded]}
        width = pad_to if pad_to is not None else (max(len(e) for e in encoded) if encoded else 0)
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


DNA_SPECIAL_TOKENS = ["<|dna_start|>", "<|dna_pad|>", "<|dna_end|>"]


def load_hf_tokenizer(path: str):
    """A local HF tokenizer directory (e.g. a Qwen3 download) through the
    port's byte-level BPE (`data/bpe.py`), with the DNA special tokens
    appended after the highest id as the reference adds them
    (dna_llm.py:67-74; text_tokenizer.py:145-148). Where the JAX package
    falls back to `transformers`, this raises `UnsupportedTokenizerError`
    naming the feature the native loader lacks."""
    from bioreason_tpu_torch.data.bpe import BPETokenizer
    tok = BPETokenizer.from_dir(path)
    tok.add_special_tokens(DNA_SPECIAL_TOKENS)
    tok.dna_start_id = tok.convert_tokens_to_ids("<|dna_start|>")
    tok.dna_pad_id = tok.convert_tokens_to_ids("<|dna_pad|>")
    tok.dna_end_id = tok.convert_tokens_to_ids("<|dna_end|>")
    return tok
