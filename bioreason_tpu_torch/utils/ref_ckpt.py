"""Reference-format SFT checkpoints (BioReason torch checkpoints) into the
port's modules (the port of bioreason_tpu/utils/ref_ckpt.py).

The reference GRPO entry accepts three SFT-checkpoint formats
(reason.py:422-540):
  1. a PEFT adapter dir: adapters merged into a loaded base
     (`merge_and_unload`), here `apply_peft_adapter`;
  2. a Lightning or DeepSpeed container (`state_dict` / `module`,
     `_forward_module.` prefixes, `text_model.base_model.model.` PEFT
     wrappers, `...base_layer.weight` and `...lora_A.weight` keys);
  3. a raw `DNALLMModel.state_dict()` file.

`load_reference_sft` reads formats 2 and 3 (a file, or a directory of
weights files) into a `FusionModel`: the `text_model.*` keys into the
decoder (HF Qwen3 names), `dna_model.*` into the NT encoder (HF ESM names)
and `dna_projection.*` into the projection, each where the file has it.
LoRA pairs found in the file are MERGED into their base weights as
W += scale · B @ A in fp32 (numpy, as the JAX package computes it), before
the cast to the parameter's dtype; GRPO then attaches fresh adapters.
`export_reference_sft` is the inverse.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from bioreason_tpu_torch.utils.hf_import import (export_decoder_to_hf, export_encoder_to_hf,
                                                 import_esm, import_qwen3, load_hf_state_dict,
                                                 load_into)

_STRIP_PREFIXES = ("_forward_module.", "=model.")
_COMPONENTS = ("text_model.", "dna_model.", "dna_projection.")
_PEFT_TARGETS = {"self_attn.q_proj": "attn.q", "self_attn.k_proj": "attn.k",
                 "self_attn.v_proj": "attn.v", "self_attn.o_proj": "attn.o",
                 "mlp.gate_proj": "mlp.gate", "mlp.up_proj": "mlp.up",
                 "mlp.down_proj": "mlp.down"}


def _normalize_key(k: str) -> Optional[str]:
    """A reference key as '<component>.<hf-key>' with the wrappers stripped,
    or None for keys of neither tower (optimizer statistics and the like)."""
    for p in _STRIP_PREFIXES:
        if k.startswith(p):
            k = k[len(p):]
    # the Lightning module's attribute (DNALLMFineTuner.model): strip ONE
    # leading 'model.' only before a component name, since Qwen3's own keys
    # also start with 'model.'
    if k.startswith("model.") and k[len("model."):].startswith(_COMPONENTS):
        k = k[len("model."):]
    k = k.replace("text_model.base_model.model.", "text_model.")    # reason.py:492-500
    return k if k.startswith(_COMPONENTS) else None


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _merge_peft_layers(sub: Dict[str, torch.Tensor], scale: float) -> Dict[str, torch.Tensor]:
    """`X.base_layer.weight` -> `X.weight`, and each LoRA pair merged as
    W += scale · (B @ A) (torch layouts: W [out, in], A [r, in], B [out, r])
    in fp32, as `merge_and_unload` does before GRPO (reason.py:446)."""
    out: Dict[str, torch.Tensor] = {}
    lora_a: Dict[str, torch.Tensor] = {}
    lora_b: Dict[str, torch.Tensor] = {}
    pat = re.compile(r"(.+)\.lora_(A|B)(?:\.default)?\.weight$")
    for k, v in sub.items():
        m = pat.match(k)
        if m:
            (lora_a if m.group(2) == "A" else lora_b)[m.group(1)] = v
            continue
        out[k.replace(".base_layer.weight", ".weight").replace(".base_layer.bias", ".bias")] = v
    for mod, a in lora_a.items():
        b = lora_b.get(mod)
        w_key = f"{mod}.weight"
        if b is not None and w_key in out:
            out[w_key] = torch.from_numpy(_f32(out[w_key]) + scale * (_f32(b) @ _f32(a)))
    return out


def _peft_scale(path: str) -> float:
    """lora_alpha / r of the directory's adapter_config.json, else 1.0."""
    cfg_path = os.path.join(path, "adapter_config.json")
    if os.path.isfile(cfg_path):
        with open(cfg_path) as f:
            c = json.load(f)
        r = c.get("r") or c.get("lora_r") or 1
        return float(c.get("lora_alpha", r)) / float(r)
    return 1.0


def split_reference_state(state: Dict[str, torch.Tensor], lora_scale: float = 1.0
                          ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A flat reference state dict -> {'text_model', 'dna_model',
    'dna_projection'} dicts of HF names, wrappers stripped, LoRA merged."""
    comps: Dict[str, Dict[str, torch.Tensor]] = {}
    for k, v in state.items():
        nk = _normalize_key(k)
        if nk is None:
            continue
        comp, sub = nk.split(".", 1)
        comps.setdefault(comp, {})[sub] = v
    if "text_model" in comps:
        comps["text_model"] = _merge_peft_layers(comps["text_model"], lora_scale)
    return comps


def _read(path: str) -> Tuple[Dict[str, torch.Tensor], float]:
    if os.path.isdir(path):
        if os.path.isfile(os.path.join(path, "adapter_config.json")):
            raise ValueError("a bare PEFT adapter directory carries no base weights: merge it "
                             "into a loaded base with apply_peft_adapter(decoder, adapter_dir)")
        return load_hf_state_dict(path), _peft_scale(path)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]            # Lightning container
    elif isinstance(ckpt, dict) and "module" in ckpt:
        ckpt = ckpt["module"]                # DeepSpeed container
    return {k: v for k, v in ckpt.items() if isinstance(v, torch.Tensor)}, 1.0


def is_reference_checkpoint(path: str) -> bool:
    """A file, or a directory of torch / safetensors weights without the
    port's own `state.pt` (reason.py's test of the JAX CLI, cli/reason.py:
    99-106, with the port's checkpoint layout)."""
    if os.path.isfile(path):
        return True
    return (os.path.isdir(path) and not os.path.isfile(os.path.join(path, "state.pt"))
            and any(f.startswith("pytorch_model") or f.endswith((".bin", ".ckpt", ".pt",
                                                                 ".safetensors"))
                    for f in os.listdir(path)))


@torch.no_grad()
def load_reference_sft(path: str, model) -> List[str]:
    """Load a reference SFT checkpoint (a file, or a directory of weights)
    into `model` (a `FusionModel` without adapters) in place, LoRA merged.
    Returns the components the checkpoint held; the others keep their
    weights (the pretrained or seeded base)."""
    state, scale = _read(path)
    comps = split_reference_state(state, lora_scale=scale)
    if "text_model" not in comps:
        raise KeyError(f"no text_model.* keys found; sample keys: {list(state)[:5]}")
    import_qwen3(comps["text_model"], model.decoder)
    if "dna_model" in comps:
        import_esm(comps["dna_model"], model.encoder)
    if "dna_projection" in comps:
        proj = comps["dna_projection"]
        load_into(model.dna_projection, {"weight": proj["weight"], "bias": proj["bias"]},
                  "dna_projection")
    return sorted(comps)


@torch.no_grad()
def apply_peft_adapter(decoder, adapter_dir: str):
    """Reference format 1 (a PEFT dir, reason.py:432-447): merge the saved
    adapter (`adapter_model.safetensors` / `.bin`) into the decoder's
    weights in place, W += scale · B @ A in fp32 before the cast to the
    weight's dtype. Returns the decoder."""
    state = load_hf_state_dict(adapter_dir)
    scale = _peft_scale(adapter_dir)
    pat = re.compile(r"base_model\.model\.model\.layers\.(\d+)\.(.+?)\.lora_(A|B)"
                     r"(?:\.default)?\.weight$")
    pairs: Dict[Tuple[int, str], Dict[str, torch.Tensor]] = {}
    for k, v in state.items():
        m = pat.match(k)
        if m:
            pairs.setdefault((int(m.group(1)), m.group(2)), {})[m.group(3)] = v
    layers = decoder.layers
    for (i, mod), ab in pairs.items():
        if "A" not in ab or "B" not in ab or mod not in _PEFT_TARGETS:
            continue
        grp, leaf = _PEFT_TARGETS[mod].split(".")
        w = getattr(getattr(layers[i], grp), leaf).weight
        w.copy_(torch.from_numpy(_f32(w) + scale * (_f32(ab["B"]) @ _f32(ab["A"]))))
    return decoder


def export_reference_sft(model, lightning: bool = False) -> Dict[str, torch.Tensor]:
    """A `FusionModel` (adapters merged or stripped) in the reference's
    `DNALLMModel.state_dict()` layout: `text_model.*` HF Qwen3 keys,
    `dna_model.*` HF ESM keys (an NT encoder), `dna_projection.*`.
    `lightning=True` adds the `_forward_module.model.` prefix of a
    DeepSpeed-Lightning dump. `load_reference_sft` reads it back bit for
    bit."""
    out = {f"text_model.{k}": v for k, v in export_decoder_to_hf(model.decoder).items()}
    if hasattr(model.encoder, "layers"):
        out.update({f"dna_model.{k}": v for k, v in export_encoder_to_hf(model.encoder).items()})
    out["dna_projection.weight"] = model.dna_projection.weight.detach()
    out["dna_projection.bias"] = model.dna_projection.bias.detach()
    if lightning:
        out = {f"_forward_module.model.{k}": v for k, v in out.items()}
    return out
