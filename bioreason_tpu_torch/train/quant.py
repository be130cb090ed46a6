"""Int8 storage for frozen weights (the port of bioreason_tpu/train/quant.py).

`quantize_frozen_int8(model)` rewrites, in place, every `nn.Linear` of the
decoder and the DNA tower to an int8 `weight` [out, in] buffer with an fp32
`scale` [out, 1] buffer (symmetric absmax per output channel) and frees the
float weight; biases, norms, LoRA adapters and the trainable DNA projection
stay as they are. `layers.dense` dequantizes in the compute dtype on every
call (or, with cfg.act_int8, runs the W8A8 product), so the resident
weights take half the bytes of bf16. `include_embed=True` also stores the
decoder's embedding int8 with one scale per vocabulary row, and its
`lm_head` where it has one (a tied head reads the embedding): the serving
configuration, in which every weight byte a decode step reads is int8.

Training (QLoRA: `SFTConfig` / `GRPOConfig` `frozen_dtype="int8"`) runs the
same walk after the LoRA adapters are attached: they are parameters of
their own beside the weight, so they stay fp32 and train, while the frozen
weights under them go int8 (JAX quant.py:10-15). `trainable.set_trainable`
then stores the scales in bf16, as JAX stores its [L, 1, out] scale leaves,
and `layers.Int8Linear` keeps the int8 weight, not a float copy, for the
backward.

Layouts: JAX kernels are [in, out] and take their absmax over axis -2
(quant.py:36); the port's weights are [out, in], so it is dim -1 here, one
scale per output channel either way. Weight scales clamp at 1e-12 after
the division by 127 (quant.py:36-37); the KV cache's clamp at 1e-8 before
it (`qwen3._kv_quantize`). `torch.round` rounds half to even, as `jnp.rint`.

Mixture-of-Experts expert banks ([E, in, out] in both packages) take one
scale per (expert, output channel), [E, 1, out], their absmax over the
input axis -2 (JAX quant.py:83-89); the router is an `nn.Linear` like any
other and goes int8 too, as the JAX walk quantizes its `kernel` leaf.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from bioreason_tpu_torch.models import layers as L


def _absmax_int8(w: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    w = w.detach().float()
    scale = (w.abs().amax(dim, keepdim=True) / 127.0).clamp(min=1e-12)
    return torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8), scale


def quantize_kernel_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[out, in] float weight -> (int8 [out, in], fp32 scale [out, 1]):
    symmetric absmax per output channel, computed in fp32."""
    return _absmax_int8(w, -1)


def quantize_bank_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[E, in, out] expert bank -> (int8 [E, in, out], fp32 scale
    [E, 1, out]): absmax over the input axis, computed in fp32."""
    return _absmax_int8(w, -2)


# the embedding is [V, H] in both packages and also takes its absmax over
# the last axis, one scale per vocabulary row (JAX quant.py:42-51)
quantize_embedding_int8 = quantize_kernel_int8


def dequantize_kernel(q: torch.Tensor, scale: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return q.to(dtype) * scale.to(dtype)


@torch.no_grad()
def store_int8(mod: nn.Module, q: torch.Tensor, scale: torch.Tensor) -> None:
    """Replace `mod.weight` (an nn.Linear's, an Embedding's or an
    ExpertBank's) by the int8 buffer `q` and a `scale` buffer in the dtype
    it is given (fp32 from `quantize_kernel_int8`; bf16 when fused in a
    QLoRA model, whose trainer stored its scales so); the float weight is
    dropped."""
    if tuple(q.shape) != tuple(mod.weight.shape) or q.dtype != torch.int8:
        raise ValueError(f"int8 {tuple(q.shape)} {q.dtype} does not replace a weight "
                         f"{tuple(mod.weight.shape)}")
    device = mod.weight.device
    del mod.weight
    mod.register_buffer("weight", q.to(device))
    mod.register_buffer("scale", scale.to(device))


def _quantize(mod: nn.Module) -> None:
    if not L.is_int8(mod):
        quant = quantize_bank_int8 if isinstance(mod, L.ExpertBank) else quantize_kernel_int8
        store_int8(mod, *quant(mod.weight))


@torch.no_grad()
def quantize_frozen_int8(model: nn.Module, subtrees: Sequence[str] = ("decoder", "encoder"),
                         include_embed: bool = False) -> nn.Module:
    """Quantize, in place, every `nn.Linear` and MoE expert bank under the
    named submodules of a `FusionModel` (the decoder and the DNA tower, NT
    or Evo2: the JAX walk over the `kernel` and `experts` leaves of those
    subtrees). `include_embed` adds the
    decoder's embedding and its separate `lm_head`; otherwise an `lm_head`
    stays float, as the JAX walk leaves it (quant.py:76-78). Already int8
    modules are left as they are. Returns the model."""
    for name in subtrees:
        tower = getattr(model, name, None)
        if tower is None:
            continue
        for mod_name, mod in tower.named_modules():
            if (isinstance(mod, L.ExpertBank)
                    or isinstance(mod, nn.Linear) and (mod_name != "lm_head" or include_embed)):
                _quantize(mod)
        if name == "decoder" and include_embed:
            _quantize(tower.embed)
    return model


def storage_bytes(module: nn.Module) -> int:
    """Bytes of every parameter and buffer `module` holds."""
    return sum(t.numel() * t.element_size()
               for t in list(module.parameters()) + list(module.buffers()))
