"""Nucleotide-Transformer-style k-mer DNA tokenizer, pure Python (the
port's copy of bioreason_tpu/data/nt_tokenizer.py without its native fast
path; the ids are identical).

HF `EsmTokenizer` with the NT-v2 vocab (reference dna_llm.py:79-83) consumes
a DNA string 6-mer by 6-mer with a greedy longest-prefix match, falling back
to single nucleotides wherever a full ACGT 6-mer is not available.

Vocabulary layout (NT-v2 convention):
  0..5   : <unk> <pad> <mask> <cls> <eos> <bos>
  6..4101: all 4^6 = 4096 6-mers over "ACGT" in itertools.product order
  4102.. : single nucleotides "A" "C" "G" "T" "N"

`<cls>` is prepended to every sequence; no EOS is appended. Pad id is 1,
which the bi-modal processor counts with `!= pad_id` like the reference
(processing_dl.py:188).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence

import numpy as np

_SPECIALS = ["<unk>", "<pad>", "<mask>", "<cls>", "<eos>", "<bos>"]
_ALPHABET = "ACGT"


def _default_vocab(kmer: int = 6) -> List[str]:
    kmers = ["".join(p) for p in itertools.product(_ALPHABET, repeat=kmer)]
    return _SPECIALS + kmers + ["A", "C", "G", "T", "N"]


class KmerTokenizer:
    """Greedy longest-match k-mer tokenizer (NT-v2 compatible)."""

    def __init__(self, vocab: Optional[Sequence[str]] = None, kmer: int = 6,
                 prepend_cls: bool = True, append_eos: bool = False):
        self.kmer = kmer
        self.vocab: List[str] = list(vocab) if vocab is not None else _default_vocab(kmer)
        self.token_to_id: Dict[str, int] = {t: i for i, t in enumerate(self.vocab)}
        self.prepend_cls = prepend_cls
        self.append_eos = append_eos

        self.unk_id = self.token_to_id["<unk>"]
        self.pad_id = self.token_to_id["<pad>"]
        self.mask_id = self.token_to_id["<mask>"]
        self.cls_id = self.token_to_id["<cls>"]
        self.eos_id = self.token_to_id.get("<eos>")
        self.bos_id = self.token_to_id.get("<bos>")
        # longest-match candidate lengths, descending (k-mer first, then chars)
        self._lengths = sorted({len(t) for t in self.vocab if t not in _SPECIALS}, reverse=True)

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "KmerTokenizer":
        """The vocabulary of a checkpoint's `vocab.txt`, one token per line
        in id order (NT-v2-500M: 4,107 tokens)."""
        with open(path, encoding="utf-8") as f:
            vocab = [line.strip() for line in f if line.strip()]
        return cls(vocab=vocab, **kw)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def tokenize(self, text: str) -> List[str]:
        """Greedy longest-prefix-match over the vocab (EsmTokenizer trie behavior)."""
        out: List[str] = []
        i, n = 0, len(text)
        while i < n:
            for length in self._lengths:
                piece = text[i:i + length]
                if len(piece) == length and piece in self.token_to_id:
                    out.append(piece)
                    i += length
                    break
            else:
                out.append(text[i])  # unknown char -> single-char token (likely <unk>)
                i += 1
        return out

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = [self.token_to_id.get(t, self.unk_id) for t in self.tokenize(text)]
        if add_special_tokens:
            if self.prepend_cls:
                ids = [self.cls_id] + ids
            if self.append_eos and self.eos_id is not None:
                ids = ids + [self.eos_id]
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        toks = []
        for i in ids:
            t = self.vocab[int(i)] if 0 <= int(i) < len(self.vocab) else "<unk>"
            if skip_special_tokens and t in _SPECIALS:
                continue
            toks.append(t)
        return "".join(toks)

    def __call__(self, sequences: Sequence[str], max_length: Optional[int] = None,
                 padding: bool = True, truncation: bool = True,
                 padding_side: str = "right", pad_to: Optional[int] = None):
        """Batch-encode to numpy arrays: right padding, truncation to
        `max_length` *including* the CLS token, `pad_to` forces a width."""
        if isinstance(sequences, str):
            sequences = [sequences]
        encoded = [self.encode(s) for s in sequences]
        if truncation and max_length is not None:
            encoded = [e[:max_length] for e in encoded]
        if not padding:
            return {"input_ids": encoded,
                    "attention_mask": [[1] * len(e) for e in encoded]}
        width = pad_to if pad_to is not None else (max(len(e) for e in encoded) if encoded else 0)
        n = len(encoded)
        input_ids = np.full((n, width), self.pad_id, dtype=np.int32)
        attention_mask = np.zeros((n, width), dtype=np.int32)
        for r, e in enumerate(encoded):
            e = e[:width]
            if padding_side == "right":
                input_ids[r, :len(e)] = e
                attention_mask[r, :len(e)] = 1
            else:
                input_ids[r, width - len(e):] = e
                attention_mask[r, width - len(e):] = 1
        return {"input_ids": input_ids, "attention_mask": attention_mask}
