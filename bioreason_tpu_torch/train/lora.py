"""LoRA over the decoder's dense layers (the port of bioreason_tpu/train/lora.py).

The reference uses PEFT `get_peft_model` over all linear layers of the text
tower, excluding lm_head/embeddings and anything named 'dna'
(train_dna_qwen.py:103-177). Here an adapter rides on its `nn.Linear`
(`layers.add_adapter`: `lora_a` [in, r], `lora_b` [r, out], `lora_scale`)
and `layers.dense` adds y += ((x @ A) @ B) * alpha / r. Three operations, in
place on the model (PyTorch idiom; the JAX functions return new trees):

  * `attach_lora` - A ~ N(0, 1/r^2), B = 0 on every targeted layer, so the
    function is unchanged at attach;
  * `merge_lora`  - fold (A @ B) * scale into the weight and drop the
    adapter (PEFT merge_and_unload);
  * `strip_lora`  - drop the adapter without merging: the base model.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch
from torch import nn

from bioreason_tpu_torch.config import LoRAConfig
from bioreason_tpu_torch.models.layers import add_adapter, has_adapter


def _targets(model: nn.Module, cfg: LoRAConfig) -> Iterator[Tuple[str, nn.Linear]]:
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Linear) and not any(p in name for p in cfg.exclude_patterns):
            yield name, mod


def attach_lora(model: nn.Module, cfg: LoRAConfig,
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """Attach an adapter to every `nn.Linear` whose name matches none of
    `cfg.exclude_patterns` (embed, lm_head, encoder, dna_projection): A drawn
    N(0, 1/r^2) in fp32 from `generator`, B zero. Returns the model."""
    for _, lin in _targets(model, cfg):
        dev = lin.weight.device
        a = torch.randn((lin.in_features, cfg.r), generator=generator, device=dev,
                        dtype=torch.float32) * (1.0 / cfg.r)
        add_adapter(lin, a, torch.zeros((cfg.r, lin.out_features), device=dev),
                    cfg.alpha / cfg.r)
    return model


def _adapted(model: nn.Module) -> Iterator[nn.Linear]:
    return (m for m in model.modules() if isinstance(m, nn.Linear) and has_adapter(m))


def _drop(lin: nn.Linear) -> None:
    del lin.lora_a, lin.lora_b, lin.lora_scale


@torch.no_grad()
def merged_weight(lin: nn.Linear) -> torch.Tensor:
    """The weight with its adapter folded in, as JAX `_fold` computes it:
    W + ((A @ B) * scale)^T, the fp32 delta cast to W's dtype first."""
    delta = (lin.lora_a @ lin.lora_b) * lin.lora_scale
    return lin.weight + delta.t().to(lin.weight.dtype)


@torch.no_grad()
def merge_lora(model: nn.Module) -> nn.Module:
    """Fold every adapter into its weight (`merged_weight`) and drop the
    adapters. Raises ValueError, changing nothing, on an adapter over an
    int8 weight (a QLoRA base): the sum would have to be quantized again,
    another function than the one trained."""
    adapted = list(_adapted(model))
    if any(lin.weight.dtype == torch.int8 for lin in adapted):
        raise ValueError("cannot merge LoRA adapters into int8 weights (a QLoRA base): "
                         "keep the adapters beside them")
    for lin in adapted:
        lin.weight.copy_(merged_weight(lin))
        _drop(lin)
    return model


def strip_lora(model: nn.Module) -> nn.Module:
    """Drop every adapter without merging (the base model's function)."""
    for lin in list(_adapted(model)):
        _drop(lin)
    return model


def has_lora(model: nn.Module) -> bool:
    return any(True for _ in _adapted(model))
