"""SFT batch collation (the port's copy of `sft_collate` and
`mask_non_assistant_labels`, bioreason_tpu/data/collate.py:38-151, and of
`classifier_collate`, :154-176, the DNA-only classifier's pairs; reference
`qwen_dna_collate_fn`, bioreason/dataset/kegg.py:223-333).

Render the chat, run the bi-modal processor with left padding, then set
labels = -100 everywhere except assistant spans, found by scanning the
token-level `<|im_start|>assistant\n` / `<|im_end|>` markers. Pad tokens are
re-masked afterwards (pad == <|im_end|>, so every end marker is masked too,
as in the reference) unless `supervise_eos`. `bucket` rounds the padded
widths up to a multiple so shapes repeat.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from bioreason_tpu_torch.data.chat_template import apply_chat_template, render_chat
from bioreason_tpu_torch.data.processor import BioProcessor

IGNORE_INDEX = -100


def _find_subsequence(row: np.ndarray, pattern: np.ndarray) -> List[int]:
    """Start indices of all occurrences of `pattern` in 1-D `row`."""
    n, m = len(row), len(pattern)
    if m == 0 or n < m:
        return []
    windows = np.lib.stride_tricks.sliding_window_view(row, m)
    return list(np.nonzero((windows == pattern).all(axis=1))[0])


def mask_non_assistant_labels(input_ids: np.ndarray, text_tokenizer,
                              pad_token_id: Optional[int] = None,
                              supervise_eos: bool = False,
                              attention_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """labels := input_ids on assistant spans, IGNORE_INDEX elsewhere.

    `supervise_eos=True` extends each span through its closing `<|im_end|>`
    and masks padding by `attention_mask` instead of the pad id, so a model
    trained from scratch learns to stop."""
    labels = np.full_like(input_ids, IGNORE_INDEX)
    start_marker = np.asarray(text_tokenizer.encode("<|im_start|>assistant\n"),
                              dtype=input_ids.dtype)
    end_marker = np.asarray(text_tokenizer.encode("<|im_end|>"), dtype=input_ids.dtype)

    for i in range(input_ids.shape[0]):
        row = input_ids[i]
        seq_len = row.shape[0]
        starts = [p + len(start_marker) for p in _find_subsequence(row, start_marker)]
        ends = _find_subsequence(row, end_marker)
        for start in starts:
            valid_ends = [e for e in ends if e > start]
            end = min(valid_ends) if valid_ends else seq_len
            if supervise_eos and valid_ends:
                end += len(end_marker)
            end = min(end, seq_len)
            if start < end:
                labels[i, start:end] = row[start:end]

    if supervise_eos:
        if attention_mask is None:
            raise ValueError("supervise_eos=True needs attention_mask for pad masking")
        labels[np.asarray(attention_mask) == 0] = IGNORE_INDEX
    else:
        pad_id = pad_token_id if pad_token_id is not None else text_tokenizer.pad_token_id
        labels[input_ids == pad_id] = IGNORE_INDEX
    return labels


def _bucket(width: int, multiple: Optional[int]) -> Optional[int]:
    if multiple is None:
        return None
    return ((max(width, 1) + multiple - 1) // multiple) * multiple


def sft_collate(
    examples: Sequence[Dict[str, Any]],
    processor: BioProcessor,
    max_length_text: int,
    max_length_dna: int,
    bucket: Optional[int] = None,
    return_answer: bool = False,
    supervise_eos: bool = False,
) -> Dict[str, Any]:
    """Collate chat-formatted examples ('prompt' messages, 'dna_sequences')
    into numpy arrays with SFT labels. `supervise_eos=True` keeps the final
    assistant `<|im_end|>` in the text and in the labels."""
    if supervise_eos:
        def _render(ex):
            text = render_chat(ex["prompt"], add_generation_prompt=False)
            end = text.rindex("<|im_end|>") + len("<|im_end|>")
            return text[:end]
        prompts_text = [_render(ex) for ex in examples]
    else:
        prompts_text = [apply_chat_template(ex)["prompt"] for ex in examples]
    batch_dna = [ex["dna_sequences"] for ex in examples]

    def run(pad_text_to=None, pad_dna_to=None):
        return processor(text=prompts_text, batch_dna_sequences=batch_dna,
                         max_length_text=max_length_text, max_length_dna=max_length_dna,
                         padding_side="left", pad_text_to=pad_text_to, pad_dna_to=pad_dna_to)

    out = run()
    if bucket is not None:
        # tokenize once to learn the expanded widths, then pad to the bucket
        d_w = (_bucket(out.dna_input_ids.shape[1], bucket)
               if out.dna_input_ids is not None else None)
        out = run(_bucket(out.input_ids.shape[1], bucket), d_w)

    labels = mask_non_assistant_labels(out.input_ids, processor.text_tokenizer,
                                       supervise_eos=supervise_eos,
                                       attention_mask=out.attention_mask)
    batch: Dict[str, Any] = {
        "input_ids": out.input_ids,
        "attention_mask": out.attention_mask,
        "dna_input_ids": out.dna_input_ids,
        "dna_attention_mask": out.dna_attention_mask,
        "batch_idx_map": out.batch_idx_map,
        "labels": labels,
    }
    if return_answer:
        batch["answer"] = [ex["answer"].strip() for ex in examples]
    return batch


def classifier_collate(
    examples: Sequence[Dict[str, Any]],
    dna_tokenizer,
    label2id: Dict[str, int],
    max_length: int = 2048,
    bucket: Optional[int] = None,
) -> Dict[str, Any]:
    """(ref, alt) DNA pairs and their class ids for the DNA-only classifier
    (bioreason_tpu/data/collate.py:154-176): both sides right-padded to one
    width, the longest sequence (+1, its CLS) rounded up to `bucket` and
    capped at `max_length`."""
    ref = [ex["reference_sequence"] for ex in examples]
    alt = [ex["variant_sequence"] for ex in examples]
    pad_to = None
    if bucket is not None:
        longest = max(max(len(dna_tokenizer.encode(s)) + 1 for s in ref + alt), 1)
        pad_to = _bucket(min(longest, max_length), bucket)
    t_ref = dna_tokenizer(ref, max_length=max_length, padding=True, truncation=True, pad_to=pad_to)
    t_alt = dna_tokenizer(alt, max_length=max_length, padding=True, truncation=True, pad_to=pad_to)
    labels = np.asarray([label2id[ex["answer"]] for ex in examples], dtype=np.int32)
    return {
        "ref_ids": np.asarray(t_ref["input_ids"], dtype=np.int32),
        "ref_attention_mask": np.asarray(t_ref["attention_mask"], dtype=np.int32),
        "alt_ids": np.asarray(t_alt["input_ids"], dtype=np.int32),
        "alt_attention_mask": np.asarray(t_alt["attention_mask"], dtype=np.int32),
        "labels": labels,
    }
