"""Bi-modal (text + DNA) input processor (the port's copy of
bioreason_tpu/data/processor.py, itself a rebuild of the reference
`DLProcessor`, bioreason/models/dl/processing_dl.py).

* DNA sequences for the whole batch are flattened and tokenized together,
  with a `batch_idx_map` recording which batch item each belongs to.
* Each `<|dna_pad|>` in the rendered text is expanded to N copies, N being
  the count of non-pad tokens of the corresponding DNA sequence, in order.
* Text is tokenized with max length `max_length_text + 2 * max_length_dna`
  and batch-padded (callers ask for LEFT padding).
* Items are padded to the same number of DNA sequences with all-pad rows so
  the splice stays row-local (models/fusion.py splice_embeddings_per_item).

Outputs are numpy arrays; the engine moves them to its device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


@dataclass
class ProcessorOutput:
    input_ids: np.ndarray            # [B, T] int32
    attention_mask: np.ndarray       # [B, T] int32
    dna_input_ids: Optional[np.ndarray] = None       # [S, L] int32 (flattened over batch)
    dna_attention_mask: Optional[np.ndarray] = None  # [S, L] int32
    batch_idx_map: List[int] = field(default_factory=list)  # len S

    def asdict(self) -> Dict[str, Any]:
        return {"input_ids": self.input_ids, "attention_mask": self.attention_mask,
                "dna_input_ids": self.dna_input_ids,
                "dna_attention_mask": self.dna_attention_mask,
                "batch_idx_map": self.batch_idx_map}


class BioProcessor:
    """Combines a text tokenizer and a DNA tokenizer into one input pipeline."""

    dna_token = "<|dna_pad|>"
    _placeholder = "<|placeholder|>"

    def __init__(self, text_tokenizer, dna_tokenizer):
        self.text_tokenizer = text_tokenizer
        self.dna_tokenizer = dna_tokenizer

    def tokenize_dna(self, batch_dna_sequences: Sequence[Sequence[str]],
                     max_length: int = 2048, pad_to: Optional[int] = None):
        """Flatten per-item DNA lists and tokenize as one dense batch."""
        batch_idx_map: List[int] = []
        flat: List[str] = []
        for b, seqs in enumerate(batch_dna_sequences):
            for s in seqs:
                flat.append(s)
                batch_idx_map.append(b)
        if not flat:
            return None, batch_idx_map
        toks = self.dna_tokenizer(flat, max_length=max_length, padding=True,
                                  truncation=True, pad_to=pad_to)
        return toks, batch_idx_map

    def __call__(
        self,
        text: Sequence[str],
        batch_dna_sequences: Optional[Sequence[Sequence[str]]] = None,
        max_length_text: int = 512,
        max_length_dna: int = 2048,
        padding_side: str = "left",
        pad_text_to: Optional[int] = None,
        pad_dna_to: Optional[int] = None,
    ) -> ProcessorOutput:
        if isinstance(text, str):
            text = [text]
        text = list(text)

        dna_toks, batch_idx_map = (None, [])
        if batch_dna_sequences is not None:
            dna_toks, batch_idx_map = self.tokenize_dna(
                batch_dna_sequences, max_length=max_length_dna, pad_to=pad_dna_to)

            if dna_toks is not None:
                pad_id = self.dna_tokenizer.pad_id
                counts = (np.asarray(dna_toks["input_ids"]) != pad_id).sum(axis=1)
                idx = 0
                for i in range(len(text)):
                    while self.dna_token in text[i]:
                        n = int(counts[idx])
                        text[i] = text[i].replace(self.dna_token, self._placeholder * n, 1)
                        idx += 1
                    text[i] = text[i].replace(self._placeholder, self.dna_token)

        text_out = self.text_tokenizer(
            text,
            max_length=max_length_text + 2 * max_length_dna,
            padding=True, truncation=True,
            padding_side=padding_side, pad_to=pad_text_to,
        )

        dna_ids = dna_mask = None
        if dna_toks is not None:
            dna_ids = np.asarray(dna_toks["input_ids"], dtype=np.int32)
            dna_mask = np.asarray(dna_toks["attention_mask"], dtype=np.int32)
            dna_ids, dna_mask, batch_idx_map = self._uniformize(
                dna_ids, dna_mask, batch_idx_map, len(text))

        return ProcessorOutput(
            input_ids=np.asarray(text_out["input_ids"], dtype=np.int32),
            attention_mask=np.asarray(text_out["attention_mask"], dtype=np.int32),
            dna_input_ids=dna_ids,
            dna_attention_mask=dna_mask,
            batch_idx_map=batch_idx_map,
        )

    def _uniformize(self, dna_ids, dna_mask, batch_idx_map, batch_size):
        """Pad every item to the same number of DNA sequences with all-pad
        dummy rows (zero valid tokens — they consume no placeholders)."""
        counts = np.bincount(np.asarray(batch_idx_map, np.int64), minlength=batch_size)
        k = int(counts.max()) if len(batch_idx_map) else 0
        if k == 0 or (counts == k).all():
            return dna_ids, dna_mask, batch_idx_map
        width = dna_ids.shape[1]
        pad_id = self.dna_tokenizer.pad_id
        new_ids = np.full((batch_size * k, width), pad_id, np.int32)
        new_mask = np.zeros((batch_size * k, width), np.int32)
        slot = {b: 0 for b in range(batch_size)}
        for row, b in enumerate(batch_idx_map):
            r = b * k + slot[b]
            new_ids[r] = dna_ids[row]
            new_mask[r] = dna_mask[row]
            slot[b] += 1
        new_map = [b for b in range(batch_size) for _ in range(k)]
        return new_ids, new_mask, new_map

    def batch_decode(self, *a, **kw):
        """The text tokenizer's `batch_decode`."""
        return self.text_tokenizer.batch_decode(*a, **kw)

    def decode(self, *a, **kw):
        """The text tokenizer's `decode`."""
        return self.text_tokenizer.decode(*a, **kw)
