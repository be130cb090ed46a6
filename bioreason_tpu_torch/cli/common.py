"""Shared CLI plumbing: model-size presets, the DNA tower's config and
dataset loading (the port's counterpart of bioreason_tpu/cli/common.py:
KEGG and the two ClinVar variant-effect tasks, with the DNA through the
tower or pasted as text)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from bioreason_tpu_torch.config import DecoderConfig, EncoderConfig, HyenaConfig
from bioreason_tpu_torch.data.char_tokenizer import CharDNATokenizer
from bioreason_tpu_torch.data.kegg import (format_kegg_for_dna_llm, format_kegg_for_llm,
                                           synthetic_kegg_items)
from bioreason_tpu_torch.data.nt_tokenizer import KmerTokenizer
from bioreason_tpu_torch.data.utils import split_dataset, truncate_dna
from bioreason_tpu_torch.data.variant_effect import (
    clean_variant_effect_example, clean_variant_effect_non_snv_example,
    format_variant_effect_for_dna_llm, format_variant_effect_for_llm)

DECODER_PRESETS = {"tiny": DecoderConfig.tiny, "qwen3-0.6b": DecoderConfig.qwen3_0_6b,
                   "qwen3-1.7b": DecoderConfig.qwen3_1_7b, "qwen3-4b": DecoderConfig.qwen3_4b}
ENCODER_PRESETS = {"tiny": EncoderConfig.tiny, "nt-50m": EncoderConfig.nt_v2_50m,
                   "nt-250m": EncoderConfig.nt_v2_250m, "nt-500m": EncoderConfig.nt_v2_500m}
HYENA_PRESETS = {"evo2-tiny": HyenaConfig.tiny, "evo2-1b": HyenaConfig.evo2_1b}
DATASET_TYPES = ("kegg", "variant_effect_coding", "variant_effect_non_snv")


def build_encoder_config(name: str, dna_embedding_layer: int = -1):
    """(encoder_kind, EncoderConfig, HyenaConfig or None, DNA tokenizer) of
    a DNA tower preset (common.py:32-50). An Evo2 preset brings the char
    tokenizer, the named-layer embedding tap `dna_embedding_layer` when it
    is >= 0 (reference --dna_embedding_layer, dna_llm.py:127-146) and an
    unused tiny EncoderConfig, as the JAX package builds it."""
    if name in HYENA_PRESETS:
        hy = HYENA_PRESETS[name]()
        if dna_embedding_layer >= 0:
            hy = dataclasses.replace(hy, embedding_tap_layer=dna_embedding_layer)
        return "evo2", EncoderConfig.tiny(), hy, CharDNATokenizer()
    return "nt", ENCODER_PRESETS[name](), None, KmerTokenizer()


def load_items(dataset_type: str, data_dir: Optional[str], n_synthetic: int,
               truncate_per_side: int, seed: int = 42, llm_only: bool = False,
               synthetic_seq_len: int = 512
               ) -> Tuple[List[Dict], List[Dict], List[Dict]]:
    """Load (a local JSON dir, else the synthetic KEGG corpus), clean,
    truncate, split 80/10/10 and chat-format the items (common.py:53-79):
    KEGG, or the coding / non-SNV variant-effect tasks, whose answers are
    cleaned as the reference cleans them; `llm_only` pastes the sequences
    into the question text."""
    if dataset_type not in DATASET_TYPES:
        raise ValueError(f"dataset_type {dataset_type!r}: expected one of {DATASET_TYPES}")
    if data_dir:
        from bioreason_tpu_torch.data.loaders import load_local_dataset
        raw = load_local_dataset(data_dir)
    else:
        raw = synthetic_kegg_items(n_synthetic, seq_len=synthetic_seq_len, seed=seed)
    if dataset_type == "kegg":
        fmt = format_kegg_for_llm if llm_only else format_kegg_for_dna_llm
    else:
        clean = (clean_variant_effect_example if dataset_type == "variant_effect_coding"
                 else clean_variant_effect_non_snv_example)
        raw = [clean(dict(x)) for x in raw]
        fmt = format_variant_effect_for_llm if llm_only else format_variant_effect_for_dna_llm
    raw = [truncate_dna(dict(x), truncate_per_side) for x in raw]
    train, val, test = split_dataset(raw, seed=seed)
    return [fmt(x) for x in train], [fmt(x) for x in val], [fmt(x) for x in test]
