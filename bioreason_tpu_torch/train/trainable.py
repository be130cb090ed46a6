"""Trainable/frozen parameter partitioning (the port of
bioreason_tpu/train/trainable.py).

The JAX package splits its tree into two flat lists by a regex over leaf
paths; here the same regexes run over the port's parameter names (dots
instead of slashes, nn.Linear's `weight` for `kernel`) and set
`requires_grad`. Trainable parameters become fp32 masters; frozen fp32
parameters may be stored in a lower dtype, since they carry no optimizer
state and are cast to the compute dtype on every call anyway. Which ones
follows the JAX rule, `ndim >= 2` (train/sft.py:88-99), read on the JAX
package's layout: its towers stack every per-layer leaf along a leading
[L] axis, so a layer's norm scales, `q_norm` / `k_norm` and biases are 2-D
there and are stored low too, while the port keeps them 1-D, one module
per layer (`frozen_cast`). The Evo2 tower's blocks are a list in JAX, not a
stack, so its 1-D leaves stay fp32 on both sides.
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
# the DNA-only classifier's default: the pooler and the head train, the
# encoder is frozen (bioreason_tpu/train/trainable.py:21)
CLASSIFIER_HEAD = r"(^pooler\.)|(^classifier\.)"
# the per-layer modules JAX stacks [L, ...]: the decoder's and the NT encoder's
STACKED = re.compile(r"^(decoder|encoder)\.layers\.\d+\.")


def frozen_cast(name: str, p: torch.Tensor) -> bool:
    """Whether a frozen parameter is stored in the frozen dtype: an fp32
    leaf that is at least 2-D in the JAX package's tree."""
    return p.dtype == torch.float32 and (p.dim() >= 2 or bool(STACKED.match(name)))


def set_trainable(model: nn.Module, trainable_regex: str,
                  frozen_dtype: str = "") -> List[nn.Parameter]:
    """Mark the parameters whose names match `trainable_regex` trainable
    (fp32, requires_grad) and freeze the rest, storing the frozen ones that
    `frozen_cast` names in `frozen_dtype` when it is given. Returns the
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
            if low is not None and frozen_cast(name, p):
                p.data = p.data.to(low)
    return trainable


def trainable_names(model: nn.Module) -> List[str]:
    return [n for n, p in model.named_parameters() if p.requires_grad]

