"""Import the JAX package's parameter tree into the port's modules.

`from_jax_params(tree, cfg)` takes the nested dict that
`bioreason_tpu.models.init_fusion` (or a checkpoint load) returns, with its
leaves as numpy arrays, e.g. `jax.tree.map(np.asarray, params)`, and fills a
`FusionModel`. The conversion:

* layer leaves are stacked `[L, ...]` (qwen3.py:59, nt_encoder.py:47) and are
  unstacked into one module per layer; the Evo2 tower's blocks are a list
  of per-flavor subtrees (evo2.py:init_hyena), copied block by block;
* `dense` kernels are `[in, out]` (layers.py:25); the port stores them
  TRANSPOSED, as `nn.Linear`'s `[out, in]` weight, so `F.linear` runs them
  as they are;
* dense weights and embeddings are cast to the tower's dtype (the JAX package
  keeps fp32 masters and casts them on every call, which gives the same
  values); norm scales, biases and the Evo2 filter leaves stay fp32;
* LoRA leaves (`lora_a` [L, in, r], `lora_b` [L, r, out], `lora_scale` [L]
  beside a stacked kernel, train/lora.py) become one adapter per layer on
  the `nn.Linear`, in the JAX layouts, fp32 (`layers.add_adapter`);
* trainable leaves stay fp32: the adapters and the DNA projection;
* a tied decoder (no `lm_head` leaf) keeps `lm_head = None` and
  `layers.lm_logits` reads the embedding as the head;
* int8 storage (`{"q", "scale"}` leaves of train/quant.py: q [in, out]
  int8, scale [1, out] fp32; the embedding's q [V, H], scale [V, 1]) is
  carried bit for bit: the port's model is quantized first for its
  structure (`train.quant.quantize_frozen_int8`), then every int8 value and
  scale is copied in, transposed to [out, in] / [out, 1];
* a MoE MLP's `router` dense is transposed like any other, its expert
  banks `experts/{gate,up,down}` [E, in, out] are copied in the JAX layout,
  which the port keeps (int8: q and scale [E, 1, out] as they are);
* fused `qkv` / `gateup` leaves (train/fuse.py) likewise: the port's model
  is fused first (`train.fuse.fuse_projections`), and an adapter left on a
  fused projection becomes a `layers.Adapter`.

A tree with `pooler` and `classifier` (bioreason_tpu/models/classifier.py)
is a DNA-only classifier's: give `cfg` as its `EncoderConfig` and get a
`DnaClassifier` (fp32, as its trainer takes it).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from bioreason_tpu_torch.config import EncoderConfig, FusionConfig
from bioreason_tpu_torch.models.classifier import DnaClassifier
from bioreason_tpu_torch.models.fusion import FusionModel
from bioreason_tpu_torch.models.layers import Adapter, MoE, add_adapter, is_int8
from bioreason_tpu_torch.train.fuse import fuse_projections
from bioreason_tpu_torch.train.quant import quantize_frozen_int8
from bioreason_tpu_torch.utils.devices import resolve_device


def _copy(dst: torch.Tensor, src: Any, transpose: bool = False) -> None:
    arr = np.asarray(src, dtype=np.int8 if dst.dtype == torch.int8 else np.float32)
    if transpose:
        arr = arr.T
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(arr.shape)} does not fit {tuple(dst.shape)}")
    dst.copy_(torch.tensor(arr))


def _is_int8(leaf: Any) -> bool:
    return isinstance(leaf, dict) and "q" in leaf


def _adapter(lin: nn.Module, p: Dict[str, Any], device) -> None:
    add_adapter(lin, torch.tensor(np.asarray(p["lora_a"], np.float32)),
                torch.tensor(np.asarray(p["lora_b"], np.float32)),
                float(np.asarray(p["lora_scale"])), device)


def _dense(lin: nn.Linear, p: Dict[str, Any]) -> None:
    kern = p["kernel"]
    if _is_int8(kern) != is_int8(lin):
        raise ValueError("the tree's int8 / float storage does not match the model's")
    if _is_int8(kern):
        _copy(lin.weight, kern["q"], transpose=True)
        _copy(lin.scale, kern["scale"], transpose=True)
    else:
        _copy(lin.weight, kern, transpose=True)
    if "lora_a" in p:
        _adapter(lin, p, lin.weight.device)
    if lin.bias is not None:
        _copy(lin.bias, p["bias"])
    elif "bias" in p:
        raise ValueError("the tree has a bias the config does not expect")


def _projections(parent: nn.Module, tree: Dict[str, Any], names) -> None:
    """Fill each dense parent.<name> of `names` from the tree, and attach
    the adapters that a fused projection left behind. Raises where the
    tree lacks a dense the model has, or holds one the model lacks."""
    device = next(iter(parent.state_dict().values())).device
    for name in names:
        lin = getattr(parent, name, None)
        p = tree.get(name, {})
        if ("kernel" in p) != isinstance(lin, nn.Linear):
            raise ValueError(f"the tree's {name!r} does not fit the model's {lin!r}")
        if "kernel" in p:
            _dense(lin, p)
        elif "lora_a" in p:
            ad = Adapter(*np.shape(p["lora_a"])[:1], np.shape(p["lora_b"])[1])
            _adapter(ad, p, device)
            setattr(parent, name, ad)


def _storage(model: nn.Module, tree: Dict[str, Any]) -> None:
    """Quantize and fuse the freshly built `model` where the tree is int8 or
    fused, so that its leaves have somewhere to go."""
    for name in ("decoder", "encoder"):
        sub = tree.get(name, {})
        layers = sub.get("layers")
        if not isinstance(layers, dict):
            continue
        attn = layers["attn"]
        if _is_int8(attn["o"]["kernel"]):
            embed = sub.get("embed", {}).get("embedding")
            quantize_frozen_int8(model, (name,), include_embed=_is_int8(embed))
        if "qkv" in attn:
            fuse_projections(model, (name,))


def _nt_layers(tower: nn.Module, tree: Dict[str, Any], decoder: bool) -> None:
    for i, lm in enumerate(tower.layers):
        lp = _layer(tree["layers"], i)
        _norm(lm.ln1, lp["ln1"])
        _projections(lm.attn, lp["attn"], ("qkv", "q", "k", "v", "o"))
        if decoder:
            _norm(lm.attn.q_norm, lp["attn"]["q_norm"])
            _norm(lm.attn.k_norm, lp["attn"]["k_norm"])
        _norm(lm.ln2, lp["ln2"])
        if isinstance(lm.mlp, MoE):
            _moe(lm.mlp, lp["mlp"])
        else:
            _projections(lm.mlp, lp["mlp"], ("gateup", "gate", "up", "down"))


def _moe(moe: MoE, p: Dict[str, Any]) -> None:
    """A MoE MLP: the router dense and the [E, in, out] banks, whose layout
    the port keeps (no transpose); int8 banks carry q and their
    [E, 1, out] scales."""
    _projections(moe, p, ("router",))
    for name in ("gate", "up", "down"):
        bank, leaf = getattr(moe.experts, name), p["experts"][name]
        if _is_int8(leaf) != is_int8(bank):
            raise ValueError("the tree's int8 / float expert bank does not match the model's")
        if _is_int8(leaf):
            _copy(bank.weight, leaf["q"])
            _copy(bank.scale, leaf["scale"])
        else:
            _copy(bank.weight, leaf)


def _embedding(emb: nn.Module, leaf: Any) -> None:
    if _is_int8(leaf) != is_int8(emb):
        raise ValueError("the tree's int8 / float embedding does not match the model's")
    if _is_int8(leaf):
        _copy(emb.weight, leaf["q"])
        _copy(emb.scale, leaf["scale"])
    else:
        _copy(emb.weight, leaf)


def _norm(norm: nn.Module, p: Dict[str, Any]) -> None:
    _copy(norm.scale, p["scale"])
    if "bias" in p:
        _copy(norm.bias, p["bias"])


def _layer(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer `i` of a stacked [L, ...] subtree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


@torch.no_grad()
def _classifier(tree: Dict[str, Any], cfg: EncoderConfig, device) -> DnaClassifier:
    model = DnaClassifier(cfg, np.shape(tree["classifier"]["fc2"]["bias"])[0], device)
    enc = model.encoder
    _copy(enc.embed.weight, tree["encoder"]["embed"]["embedding"])
    _nt_layers(enc, tree["encoder"], decoder=False)
    _norm(enc.final_norm, tree["encoder"]["final_norm"])
    pool, pt = model.pooler, tree["pooler"]
    _copy(pool.query, pt["query"])
    _projections(pool, pt, ("q", "k", "v", "o"))
    _projections(model.classifier, tree["classifier"], ("fc1", "fc2"))
    return model


def _hyena_blocks(tower: nn.Module, blocks) -> None:
    """The Evo2 tower's blocks: a Python list of per-block subtrees whose
    leaves differ by flavor (evo2.py:init_hyena), not a stacked tree. Dense
    kernels are transposed; filter leaves keep their layout, and an mr
    `decay` that is an [C, L] envelope (imported checkpoints) replaces the
    [C] rate the config builds."""
    if len(blocks) != len(tower.blocks):
        raise ValueError(f"{len(blocks)} blocks do not fit a tower of {len(tower.blocks)}")
    for i, (bm, bp) in enumerate(zip(tower.blocks, blocks)):
        if ("attn" in bp) != (bm.flavor == "attn"):
            raise ValueError(f"block {i}: the tree's operator does not match flavor "
                             f"{bm.flavor!r}")
        _norm(bm.ln1, bp["ln1"])
        _norm(bm.ln2, bp["ln2"])
        for name in ("gate", "up", "down"):
            _dense(getattr(bm.mlp, name), bp["mlp"][name])
        if bm.flavor == "attn":
            for name in ("q", "k", "v", "o"):
                _dense(getattr(bm.attn, name), bp["attn"][name])
            continue
        mix, hp = bm.hyena, bp["hyena"]
        _dense(mix.in_proj, hp["in_proj"])
        _dense(mix.out_proj, hp["out_proj"])
        _copy(mix.short_filter, hp["short_filter"])
        _copy(mix.filter_bias, hp["filter_bias"])
        if sorted(hp["filter"]) != sorted(n for n, _ in mix.filter.named_parameters()):
            raise ValueError(f"block {i}: filter leaves {sorted(hp['filter'])} do not fit "
                             f"flavor {bm.flavor!r}")
        if "decay" in hp["filter"]:
            mix.filter.fit_decay_(np.shape(hp["filter"]["decay"]))
        for name, leaf in hp["filter"].items():
            _copy(getattr(mix.filter, name), leaf)


@torch.no_grad()
def from_jax_params(tree: Dict[str, Any], cfg: FusionConfig,
                    device: Optional[torch.device] = None) -> FusionModel:
    """The JAX fusion parameter tree (numpy leaves) as a `FusionModel` on
    `device` (CUDA unless the caller asks for the CPU); a classifier tree as
    a `DnaClassifier` (module docstring)."""
    if "pooler" in tree:
        return _classifier(tree, cfg, resolve_device(device))
    model = FusionModel(cfg, resolve_device(device))
    _storage(model, tree)

    enc, et = model.encoder, tree["encoder"]
    _copy(enc.embed.weight, et["embed"]["embedding"])
    if cfg.encoder_kind == "evo2":
        _hyena_blocks(enc, et["blocks"])
    else:
        _nt_layers(enc, et, decoder=False)
    _norm(enc.final_norm, et["final_norm"])

    dec, dt = model.decoder, tree["decoder"]
    _embedding(dec.embed, dt["embed"]["embedding"])
    _nt_layers(dec, dt, decoder=True)
    _norm(dec.final_norm, dt["final_norm"])
    if ("lm_head" in dt) != (dec.lm_head is not None):
        raise ValueError("tie_word_embeddings does not match the tree's lm_head")
    if dec.lm_head is not None:
        _dense(dec.lm_head, dt["lm_head"])

    _dense(model.dna_projection, tree["dna_projection"])
    return model

