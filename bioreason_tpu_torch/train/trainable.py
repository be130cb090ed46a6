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

import copy
import re
from typing import Callable, List

import torch
from torch import nn

def refuse_moe(decoder_cfg, what: str) -> None:
    """Training through a Mixture-of-Experts decoder is not ported yet: the
    trainers and their CLIs call this first (ROADMAP.md, queue 1, item 8b:
    MoE training; the MoE serves)."""
    if decoder_cfg.num_experts:
        raise NotImplementedError(
            f"{what}: training a Mixture-of-Experts decoder is not ported yet (ROADMAP.md, "
            f"queue 1, item 8b: MoE training); the port serves it")


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
    (fp32, requires_grad) and freeze the rest, storing them as
    `store_frozen` does. Returns the trainable parameters in
    `named_parameters` order (the optimizer's)."""
    pat = re.compile(trainable_regex)
    trainable = []
    for name, p in model.named_parameters():
        if pat.search(name):
            p.data = p.data.float()
            p.requires_grad_(True)
            trainable.append(p)
        else:
            p.requires_grad_(False)
    store_frozen(model, frozen_dtype, lambda name: not pat.search(name))
    return trainable


@torch.no_grad()
def store_frozen(model: nn.Module, frozen_dtype: str, frozen: Callable[[str], bool]) -> None:
    """Store the parameters whose names `frozen` accepts and that
    `frozen_cast` names in `frozen_dtype`, when it is given ("int8" stores
    them in bf16, JAX train/sft.py:92-95). The fp32 `scale` buffers of int8
    modules (train/quant.py) are stored in that dtype too: JAX's scales are
    frozen leaves of two or more dimensions ([L, 1, out] stacked, [1, out]
    in an Evo2 block), so its dequantized weights use rounded scales."""
    frozen_dtype = "bfloat16" if frozen_dtype == "int8" else frozen_dtype
    if not frozen_dtype:
        return
    low = getattr(torch, frozen_dtype)
    for name, p in model.named_parameters():
        if frozen(name) and frozen_cast(name, p):
            p.data = p.data.to(low)
    for mod in model.modules():
        w, scale = getattr(mod, "weight", None), getattr(mod, "scale", None)
        if (isinstance(w, torch.Tensor) and w.dtype == torch.int8
                and isinstance(scale, torch.Tensor) and scale.dtype == torch.float32):
            mod.scale = scale.to(low)


def trainable_names(model: nn.Module) -> List[str]:
    return [n for n, p in model.named_parameters() if p.requires_grad]


def shared_copy(model: nn.Module,
                param: Callable[[nn.Parameter], nn.Parameter] = lambda p: p) -> nn.Module:
    """A second module tree of `model` that holds its tensors themselves:
    every buffer (int8 weights and scales among them) and, for each
    parameter, what `param` gives (the parameter itself by default). The
    modules are new, so adapters dropped or weights quantized in the copy
    leave `model` as it is."""
    memo = {id(b): b for b in model.buffers()}
    memo.update((id(p), param(p)) for p in model.parameters())
    return copy.deepcopy(model, memo)
