"""Evo2-style character-level (byte) DNA tokenizer (the port of
bioreason_tpu/data/char_tokenizer.py, pure Python).

Token id == byte value of the character (vocab_size 512 as in Evo2), pad id
1, eos id 0, LEFT padding, truncation to max_length, and a batch padded to
its longest sequence unless `pad_to` is given (reference
bioreason/models/evo2_tokenizer.py:129-147 ignores max_length when padding).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


class CharDNATokenizer:
    """Byte/char-level DNA tokenizer (Evo2-compatible)."""

    def __init__(self, vocab_size: int = 512, pad_id: int = 1, eos_id: int = 0):
        self._vocab_size = vocab_size
        self.pad_id = pad_id
        self.eos_id = eos_id

    @property
    def vocab_size(self) -> int:
        return self._vocab_size

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8", errors="replace"))

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return bytes(int(i) % 256 for i in ids).decode("utf-8", errors="replace")

    def batch_decode(self, batch: Sequence[Sequence[int]], **kw) -> List[str]:
        return [self.decode(ids) for ids in batch]

    def __call__(self, sequences: Sequence[str], max_length: Optional[int] = None,
                 padding: bool = True, truncation: bool = True,
                 padding_side: str = "left", pad_to: Optional[int] = None):
        if isinstance(sequences, str):
            sequences = [sequences]
        encoded = [self.encode(s) for s in sequences]
        if truncation and max_length is not None:
            encoded = [e[:max_length] for e in encoded]
        if not padding:
            return {"input_ids": encoded,
                    "attention_mask": [[1] * len(e) for e in encoded]}
        width = pad_to if pad_to is not None else max((len(e) for e in encoded), default=0)
        n = len(encoded)
        input_ids = np.full((n, width), self.pad_id, dtype=np.int32)
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
