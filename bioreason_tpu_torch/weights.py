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
  `layers.lm_logits` reads the embedding as the head.

The int8 `{"q", "scale"}` storage and the fused `qkv`/`gateup` leaves are
not converted: unfuse on the JAX side first.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from bioreason_tpu_torch.config import FusionConfig
from bioreason_tpu_torch.models.fusion import FusionModel
from bioreason_tpu_torch.models.layers import add_adapter
from bioreason_tpu_torch.utils.devices import resolve_device


def _copy(dst: torch.Tensor, src: Any, transpose: bool = False) -> None:
    arr = np.asarray(src, dtype=np.float32)
    if transpose:
        arr = arr.T
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(arr.shape)} does not fit {tuple(dst.shape)}")
    dst.copy_(torch.tensor(arr))


def _dense(lin: nn.Linear, p: Dict[str, Any]) -> None:
    if not isinstance(p["kernel"], np.ndarray):
        raise ValueError("only float, unfused dense leaves are converted")
    _copy(lin.weight, p["kernel"], transpose=True)
    if "lora_a" in p:
        add_adapter(lin, torch.tensor(np.asarray(p["lora_a"], np.float32)),
                    torch.tensor(np.asarray(p["lora_b"], np.float32)),
                    float(np.asarray(p["lora_scale"])))
    if lin.bias is not None:
        _copy(lin.bias, p["bias"])
    elif "bias" in p:
        raise ValueError("the tree has a bias the config does not expect")


def _norm(norm: nn.Module, p: Dict[str, Any]) -> None:
    _copy(norm.scale, p["scale"])
    if "bias" in p:
        _copy(norm.bias, p["bias"])


def _layer(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer `i` of a stacked [L, ...] subtree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


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
    `device` (CUDA unless the caller asks for the CPU)."""
    model = FusionModel(cfg, resolve_device(device))

    enc, et = model.encoder, tree["encoder"]
    _copy(enc.embed.weight, et["embed"]["embedding"])
    if cfg.encoder_kind == "evo2":
        _hyena_blocks(enc, et["blocks"])
    else:
        for i, lm in enumerate(enc.layers):
            lp = _layer(et["layers"], i)
            _norm(lm.ln1, lp["ln1"])
            for name in ("q", "k", "v", "o"):
                _dense(getattr(lm.attn, name), lp["attn"][name])
            _norm(lm.ln2, lp["ln2"])
            for name, sub in lp["mlp"].items():
                _dense(getattr(lm.mlp, name), sub)
    _norm(enc.final_norm, et["final_norm"])

    dec, dt = model.decoder, tree["decoder"]
    _copy(dec.embed.weight, dt["embed"]["embedding"])
    for i, lm in enumerate(dec.layers):
        lp = _layer(dt["layers"], i)
        _norm(lm.ln1, lp["ln1"])
        for name in ("q", "k", "v", "o"):
            _dense(getattr(lm.attn, name), lp["attn"][name])
        _norm(lm.attn.q_norm, lp["attn"]["q_norm"])
        _norm(lm.attn.k_norm, lp["attn"]["k_norm"])
        _norm(lm.ln2, lp["ln2"])
        for name in ("gate", "up", "down"):
            _dense(getattr(lm.mlp, name), lp["mlp"][name])
    _norm(dec.final_norm, dt["final_norm"])
    if ("lm_head" in dt) != (dec.lm_head is not None):
        raise ValueError("tie_word_embeddings does not match the tree's lm_head")
    if dec.lm_head is not None:
        _dense(dec.lm_head, dt["lm_head"])

    _dense(model.dna_projection, tree["dna_projection"])
    return model

