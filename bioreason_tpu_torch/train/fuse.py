"""Fused projections: q/k/v into one `qkv` linear and gate/up into one
`gateup` (the port of bioreason_tpu/train/fuse.py).

A one-time rewrite of the model, in place, at load time: the fused linear
replaces the per-projection ones, its weight the concatenation of theirs
along the output axis (dim 0 of the [out, in] weights; float, or int8 with
its per-channel scales), its bias theirs concatenated. One wide product
then serves the group (`layers.qkv_proj`, `layers.swiglu`). A projection's
LoRA adapter stays behind on a `layers.Adapter` under the projection's old
name and is added to its split output. `unfuse_projections` splits them
back. Both are idempotent and touch only the decoder's and the NT encoder's
layers; the Evo2 tower's blocks are left as they are.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from bioreason_tpu_torch.models import layers as L
from bioreason_tpu_torch.train.quant import store_int8

LORA = ("lora_a", "lora_b", "lora_scale")


def _linear_like(src: nn.Linear, in_features: int, out_features: int, bias: bool) -> nn.Linear:
    w = src.weight
    dtype = torch.float32 if L.is_int8(src) else w.dtype
    return L.linear(in_features, out_features, bias, w.device, dtype)


def _move_adapter(src: nn.Module, dst: nn.Module) -> None:
    dst.lora_a, dst.lora_b = src.lora_a, src.lora_b
    dst.register_buffer("lora_scale", src.lora_scale)


@torch.no_grad()
def _fuse_group(parent: nn.Module, names: Sequence[str], fused_name: str) -> bool:
    """Move the base weights and biases of parent.<names> into one linear
    parent.<fused_name>; adapters stay on `Adapter`s. False (nothing done)
    when the group is fused already."""
    if hasattr(parent, fused_name):
        return False
    subs: List[nn.Linear] = [getattr(parent, n) for n in names]
    int8 = [L.is_int8(s) for s in subs]
    if any(int8) and not all(int8):
        raise ValueError("cannot fuse mixed int8/float projection kernels")
    has_bias = [s.bias is not None for s in subs]
    if any(has_bias) and not all(has_bias):
        raise ValueError(f"cannot fuse {tuple(names)}: mixed bias/no-bias")
    fused = _linear_like(subs[0], subs[0].in_features, sum(s.out_features for s in subs),
                         all(has_bias))
    if all(int8):
        store_int8(fused, torch.cat([s.weight for s in subs]), torch.cat([s.scale for s in subs]))
    else:
        fused.weight.copy_(torch.cat([s.weight for s in subs]))
    if all(has_bias):
        fused.bias.copy_(torch.cat([s.bias for s in subs]))
    setattr(parent, fused_name, fused)
    for n, s in zip(names, subs):
        delattr(parent, n)
        if L.has_adapter(s):
            ad = L.Adapter(s.in_features, s.out_features)
            _move_adapter(s, ad)
            setattr(parent, n, ad)
    return True


@torch.no_grad()
def _unfuse_group(parent: nn.Module, names: Sequence[str], fused_name: str,
                  sizes: Sequence[int]) -> bool:
    if not hasattr(parent, fused_name):
        return False
    fused: nn.Linear = getattr(parent, fused_name)
    int8 = L.is_int8(fused)
    weights = fused.weight.split(list(sizes))
    scales = fused.scale.split(list(sizes)) if int8 else [None] * len(sizes)
    biases = fused.bias.split(list(sizes)) if fused.bias is not None else [None] * len(sizes)
    delattr(parent, fused_name)
    for n, w, sc, b in zip(names, weights, scales, biases):
        lin = _linear_like(fused, fused.in_features, w.shape[0], b is not None)
        if int8:
            store_int8(lin, w.clone(), sc.clone())
        else:
            lin.weight.copy_(w)
        if b is not None:
            lin.bias.copy_(b)
        old = getattr(parent, n, None)
        if old is not None and L.has_adapter(old):
            _move_adapter(old, lin)
        if old is not None:
            delattr(parent, n)
        setattr(parent, n, lin)
    return True


def _nt_layers(model: nn.Module, subtrees: Sequence[str]):
    for name in subtrees:
        tower = getattr(model, name, None)
        layers = getattr(tower, "layers", None)      # the Evo2 tower has `blocks`
        if layers is not None:
            yield from layers


def fuse_projections(model: nn.Module,
                     subtrees: Sequence[str] = ("decoder", "encoder")) -> nn.Module:
    """Fuse q/k/v -> qkv and gate/up -> gateup in every layer of the named
    towers, in place; a tower without `layers` (Evo2) and a fused group are
    left as they are. Raises on mixed int8/float or bias/no-bias groups.
    Returns the model."""
    for layer in _nt_layers(model, subtrees):
        _fuse_group(layer.attn, ("q", "k", "v"), "qkv")
        if hasattr(layer.mlp, "gate") or hasattr(layer.mlp, "gateup"):
            _fuse_group(layer.mlp, ("gate", "up"), "gateup")
    return model


def unfuse_projections(model: nn.Module,
                       subtrees: Sequence[str] = ("decoder", "encoder")) -> nn.Module:
    """The inverse of `fuse_projections`, in place: q's width is what `o`
    reads, k and v halve the rest; gate and up halve `gateup`. Adapters
    return to their projections. Returns the model."""
    for layer in _nt_layers(model, subtrees):
        attn = layer.attn
        if hasattr(attn, "qkv"):
            q_out = attn.o.in_features
            kv = (attn.qkv.out_features - q_out) // 2
            _unfuse_group(attn, ("q", "k", "v"), "qkv", (q_out, kv, kv))
        if hasattr(layer.mlp, "gateup"):
            hid = layer.mlp.gateup.out_features // 2
            _unfuse_group(layer.mlp, ("gate", "up"), "gateup", (hid, hid))
    return model
