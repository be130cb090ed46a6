"""Trainable/frozen parameter partitioning (the port of
bioreason_tpu/train/trainable.py).

The JAX package splits its tree into two flat lists by a regex over leaf
paths; here the same regexes run over the port's parameter names (dots
instead of slashes, nn.Linear's `weight` for `kernel`) and set
`requires_grad`. Trainable parameters become fp32 masters; frozen float
parameters of two or more dimensions may be stored in a lower dtype, since
they carry no optimizer state and are cast to the compute dtype on every
call anyway.
"""

from __future__ import annotations

import re
from typing import List

import torch
from torch import nn

# SFT/GRPO default: adapters + fusion projection train; everything else frozen
# (reference: projection always unfrozen, DNA tower always frozen).
LORA_TRAINABLE = r"(lora_[ab]$)|(^dna_projection\.(weight|bias)$)"
FULL_FINETUNE = r"(^decoder\.)|(^dna_projection\.)"
ENCODER = r"(^encoder\.)"


def set_trainable(model: nn.Module, trainable_regex: str,
                  frozen_dtype: str = "") -> List[nn.Parameter]:
    """Mark the parameters whose names match `trainable_regex` trainable
    (fp32, requires_grad) and freeze the rest, storing frozen float
    parameters of >= 2 dims in `frozen_dtype` when it is given. Returns the
    trainable parameters in `named_parameters` order (the optimizer's)."""
    pat = re.compile(trainable_regex)
    low = getattr(torch, frozen_dtype) if frozen_dtype else None
    trainable = []
    for name, p in model.named_parameters():
        if pat.search(name):
            p.data = p.data.float()
            p.requires_grad_(True)
            trainable.append(p)
        else:
            p.requires_grad_(False)
            if low is not None and p.is_floating_point() and p.dim() >= 2:
                p.data = p.data.to(low)
    return trainable


def trainable_names(model: nn.Module) -> List[str]:
    return [n for n, p in model.named_parameters() if p.requires_grad]

