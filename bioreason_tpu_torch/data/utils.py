"""Dataset utilities (the port's copy of bioreason_tpu/data/utils.py;
reference bioreason/dataset/utils.py)."""

from __future__ import annotations

import random
from typing import Any, Dict, Sequence


def truncate_dna(example: Dict[str, Any], truncate_dna_per_side: int = 1024) -> Dict[str, Any]:
    """Remove `truncate_dna_per_side` bp from each end of both sequences when
    the sequence is longer than 2 * per_side + 8 (reference utils.py:6-20).
    per_side <= 0 keeps whole sequences (the reference's `seq[0:-0]` would
    empty them)."""
    if truncate_dna_per_side <= 0:
        return example
    for key in ("reference_sequence", "variant_sequence"):
        seq = example[key]
        if len(seq) > 2 * truncate_dna_per_side + 8:
            example[key] = seq[truncate_dna_per_side:-truncate_dna_per_side]
    return example


def split_dataset(items: Sequence[Any], train_ratio: float = 0.8, val_ratio: float = 0.1,
                  test_ratio: float = 0.1, seed: int = 42):
    """Seeded random 80/10/10 split (reference kegg.py:82-119)."""
    if abs(train_ratio + val_ratio + test_ratio - 1.0) >= 1e-9:
        raise ValueError("Ratios must sum to 1")
    n = len(items)
    n_train = int(train_ratio * n)
    n_val = int(val_ratio * n)
    idx = list(range(n))
    random.Random(seed).shuffle(idx)

    def take(sl):
        return [items[i] for i in sl]
    return take(idx[:n_train]), take(idx[n_train:n_train + n_val]), take(idx[n_train + n_val:])
