"""KEGG prompt formatting and the synthetic KEGG-shaped corpus (the port's
copy of bioreason_tpu/data/kegg.py:42-196).

`format_kegg_prompt_only` is the GRPO/serving prompt mapping (reference
reason.py:128-148): two DNA content parts (reference + variant) followed by
the question. `format_kegg_for_dna_llm` is the SFT example: the same user
turn and an assistant turn with the reasoning trace and `Answer: ...`;
`format_kegg_for_llm` pastes the sequences into the question instead.
`process_kegg_item` normalizes a raw KEGG record. `synthetic_kegg_items`
makes deterministic KEGG-shaped items for tests and the chip smoke run (no
dataset is downloaded).
"""

from __future__ import annotations

import random
from typing import Any, Dict, List


def process_kegg_item(item: Dict[str, Any]) -> Dict[str, Any]:
    """Answer lower-cased and stripped, reasoning steps joined by newlines,
    sequences upper-cased and stripped (reference kegg.py:41-71)."""
    return {
        "question": item.get("question", ""),
        "answer": item.get("answer", "").lower().strip(),
        "reasoning": "\n".join(item.get("reasoning", {}).get("reasoning_steps", [])),
        "reference_sequence": item.get("reference_sequence", "").upper().strip(),
        "variant_sequence": item.get("variant_sequence", "").upper().strip(),
    }


def format_kegg_for_dna_llm(example: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "prompt": [
            {
                "role": "user",
                "content": [
                    *({"type": "dna", "text": None} for _ in range(2)),
                    {"type": "text", "text": example["question"].strip()},
                ],
            },
            {
                "role": "assistant",
                "reasoning_content": example["reasoning"].strip(),
                "content": [{"type": "text", "text": f"Answer: {example['answer'].strip()}"}],
            },
        ],
        "dna_sequences": [example["reference_sequence"], example["variant_sequence"]],
        "answer": example["answer"],
    }


def format_kegg_for_llm(example: Dict[str, Any]) -> Dict[str, Any]:
    """The LLM-only SFT example (`--llm_only`): the sequences pasted into the
    question text, empty DNA strings (reference kegg.py:190-220)."""
    question = (f"Reference sequence: {example['reference_sequence']}\n"
                f"Variant sequence: {example['variant_sequence']}\n"
                f"Question: {example['question']}")
    return {
        "prompt": [
            {
                "role": "user",
                "content": [
                    *({"type": "dna", "text": None} for _ in range(2)),
                    {"type": "text", "text": question.strip()},
                ],
            },
            {
                "role": "assistant",
                "reasoning_content": example["reasoning"].strip(),
                "content": [{"type": "text", "text": f"Answer: {example['answer'].strip()}"}],
            },
        ],
        "dna_sequences": ["", ""],
        "answer": example["answer"],
    }


def format_kegg_prompt_only(example: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "prompt": [
            {
                "role": "user",
                "content": [
                    *({"type": "dna", "text": None} for _ in range(2)),
                    {"type": "text", "text": example["question"]},
                ],
            },
        ],
        "dna_sequences": [example["reference_sequence"], example["variant_sequence"]],
        "answer": example["answer"],
    }


_PATHWAYS = [
    "mapk signaling pathway", "p53 signaling pathway", "wnt signaling pathway",
    "apoptosis", "cell cycle", "dna repair", "notch signaling pathway",
    "hedgehog signaling pathway",
]


def synthetic_kegg_items(n: int = 64, seq_len: int = 256, seed: int = 0,
                         learnable: bool = False,
                         fixed_positions: bool = False) -> List[Dict[str, Any]]:
    """Deterministic KEGG-shaped items, identical to the JAX package's.

    `learnable=True` makes the answer a function of the DNA content
    (pathway index = 2 * base(alt) + (pos in second half)).
    `fixed_positions=True` puts the mismatch at one of two fixed loci as an
    8-base run of the alt base."""
    rng = random.Random(seed)
    loci = (seq_len // 4, (3 * seq_len) // 4)
    run = 8
    items = []
    for i in range(n):
        ref = "".join(rng.choice("ACGT") for _ in range(seq_len))
        pos = rng.choice(loci) if fixed_positions else rng.randrange(seq_len)
        alt_base = rng.choice([b for b in "ACGT" if b != ref[pos]])
        if fixed_positions:
            r = min(run, seq_len - pos)
            var = ref[:pos] + alt_base * r + ref[pos + r:]
        else:
            var = ref[:pos] + alt_base + ref[pos + 1:]
        if learnable:
            half = "second" if pos >= seq_len // 2 else "first"
            answer = _PATHWAYS["ACGT".index(alt_base) * 2
                               + (pos >= seq_len // 2)]
            reasoning = (f"The variant substitutes {alt_base} in the "
                         f"{half} half of the sequence.\n"
                         f"This affects a regulatory region linked to the {answer}.\n"
                         f"Therefore the most likely disrupted pathway is the {answer}.")
        else:
            answer = rng.choice(_PATHWAYS)
            reasoning = (f"The variant at position {pos} changes {ref[pos]} to {alt_base}.\n"
                         f"This affects a regulatory region linked to the {answer}.\n"
                         f"Therefore the most likely disrupted pathway is the {answer}.")
        items.append({
            "question": ("Given the reference and variant DNA sequences, which KEGG "
                         "pathway is most likely disrupted by this variant?"),
            "answer": answer,
            "reasoning": reasoning,
            "reference_sequence": ref,
            "variant_sequence": var,
        })
    return items
