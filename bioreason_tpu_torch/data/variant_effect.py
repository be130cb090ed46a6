"""ClinVar variant-effect dataset layer (the port's copy of
bioreason_tpu/data/variant_effect.py; reference bioreason/dataset/variant_effect.py).

VEP examples have no reasoning traces; the assistant `reasoning_content` is
the answer line itself (reference :57).
"""

from __future__ import annotations

from typing import Any, Dict


def clean_variant_effect_example(example: Dict[str, Any]) -> Dict[str, Any]:
    """Coding VEP: keep text before ';', lower-case (reference :26-31)."""
    example["answer"] = example["answer"].split(";")[0].strip().lower()
    return example


def clean_variant_effect_non_snv_example(example: Dict[str, Any]) -> Dict[str, Any]:
    """Non-SNV VEP: strip brackets/quotes, underscores -> spaces (reference :34-39)."""
    example["answer"] = (example["answer"].replace("[", "").replace("]", "")
                         .replace("'", "").replace("_", " ").strip())
    return example


def get_format_variant_effect_function(model_name: str):
    if model_name.lower() == "llm":
        return format_variant_effect_for_llm
    if model_name.lower() == "dna-llm":
        return format_variant_effect_for_dna_llm
    raise ValueError(f"Unsupported model name: {model_name}")


def format_variant_effect_for_dna_llm(example: Dict[str, Any]) -> Dict[str, Any]:
    answer = example["answer"].strip()
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
                "reasoning_content": f"Answer: {answer}",
                "content": [{"type": "text", "text": f"Answer: {answer}"}],
            },
        ],
        "dna_sequences": [example["reference_sequence"], example["variant_sequence"]],
        "answer": answer,
    }


def format_variant_effect_for_llm(example: Dict[str, Any]) -> Dict[str, Any]:
    answer = example["answer"].strip()
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
                "reasoning_content": f"Answer: {answer}",
                "content": [{"type": "text", "text": f"Answer: {answer}"}],
            },
        ],
        "dna_sequences": ["", ""],
        "answer": answer,
    }
