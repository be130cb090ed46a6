"""Trainer checkpoints: the trainable parameters, the optimizer state and the
step, in one `torch.save` file (the resumable subset of
bioreason_tpu/train/checkpoint.py; frozen weights are not written, since
they come from the seed or the import that built the model).

A checkpoint of a model drawn from a seed records in its metadata what
draws the same frozen base again (`BASE_KEYS`: the seed, the device type
that drew it, the presets, the attention and embedding tap of the DNA tower
that runs, the vocabulary, the LoRA rank and the frozen weights' storage
dtype): `load_sft_model` rebuilds the SFT model from it and refuses any
mismatch with the caller's configuration, since adapters paired with
another base would load without complaint and mean nothing.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

BASE_KEYS = ("seed", "init_device", "decoder", "encoder", "dna_attention",
             "dna_embedding_layer", "vocab_size", "lora_r", "lora_alpha", "frozen_dtype")

FILE = "state.pt"


def model_keys(fusion_cfg) -> Dict[str, Any]:
    """The `BASE_KEYS` that `fusion_cfg` fixes, read from the DNA tower
    that runs (`FusionConfig.dna_tower`: an Evo2 config also carries an
    unused NT `encoder`); the NT tower has no embedding tap (-1)."""
    evo2 = fusion_cfg.encoder_kind == "evo2"
    return {"dna_attention": fusion_cfg.dna_tower.attention_impl,
            "dna_embedding_layer": fusion_cfg.hyena.embedding_tap_layer if evo2 else -1,
            "vocab_size": fusion_cfg.decoder.vocab_size}


def save_checkpoint(path: str, trainable: Dict[str, torch.Tensor], opt_state: Dict,
                    step: int, metadata: Optional[Dict[str, Any]] = None) -> str:
    """Write `path`/state.pt (written to a temporary name, then renamed)."""
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, FILE)
    tmp = f"{target}.{os.getpid()}.tmp"
    torch.save({"trainable": {k: v.detach().cpu() for k, v in trainable.items()},
                "opt_state": {k: ([t.detach().cpu() for t in v] if isinstance(v, list) else v)
                              for k, v in opt_state.items()},
                "step": int(step), "metadata": dict(metadata or {})}, tmp)
    os.replace(tmp, target)
    return target


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The dict `save_checkpoint` wrote, tensors on the CPU."""
    return torch.load(os.path.join(path, FILE), map_location="cpu", weights_only=True)


@torch.no_grad()
def load_sft_model(path: str, fusion_cfg, seed: int, decoder: str, encoder: str, device=None):
    """The model of the SFT trainer that wrote `path` (an `sft_final` or
    `sft_state` of the port), parameter for parameter: the base drawn again
    from the recorded seed on the recorded device type, the SFT adapters
    attached and every trained parameter loaded (fp32), the other float
    parameters of two or more dimensions stored in the recorded frozen dtype.

    Raises ValueError when the checkpoint does not record `BASE_KEYS`, or
    records another seed, preset (`decoder`, `encoder`: the CLI preset
    names), DNA attention, embedding tap or vocabulary size than
    `fusion_cfg` and the arguments ask for."""
    from bioreason_tpu_torch.config import LoRAConfig
    from bioreason_tpu_torch.models.fusion import init_fusion
    from bioreason_tpu_torch.train.lora import attach_lora
    from bioreason_tpu_torch.utils.devices import resolve_device

    state = load_checkpoint(path)
    meta = state["metadata"]
    missing = [k for k in BASE_KEYS if k not in meta]
    if missing:
        raise ValueError(
            f"{path}: its metadata lacks {missing}, so the frozen base it was trained on "
            f"cannot be drawn again (a checkpoint written before the port recorded them, "
            f"or of a model that was not drawn from a seed); train it again")
    want = {"seed": seed, "decoder": decoder, "encoder": encoder, **model_keys(fusion_cfg)}
    wrong = {k: (meta[k], v) for k, v in want.items() if meta[k] != v}
    if wrong:
        raise ValueError(f"{path} was trained on another base: (checkpoint, asked) {wrong}")
    device = resolve_device(device)
    model = init_fusion(fusion_cfg, seed=meta["seed"], device=meta["init_device"]).to(device)
    if meta["lora_r"] is not None:
        attach_lora(model, LoRAConfig(r=meta["lora_r"], alpha=meta["lora_alpha"]))
    trained = state["trainable"]
    low = getattr(torch, meta["frozen_dtype"]) if meta["frozen_dtype"] else None
    params = dict(model.named_parameters())
    for name in trained:
        if name not in params or params[name].shape != trained[name].shape:
            raise ValueError(f"{path}: {name} {tuple(trained[name].shape)} does not fit "
                             f"the model")
    for name, p in params.items():
        if name in trained:
            p.data = trained[name].to(device)
        elif low is not None and p.is_floating_point() and p.dim() >= 2:
            p.data = p.data.to(low)
    return model


@torch.no_grad()
def load_sft_for_grpo(path: str, fusion_cfg, lora_cfg, seed: int, decoder: str, encoder: str,
                      device=None, generator: Optional[torch.Generator] = None):
    """The SFT model of `path` (`load_sft_model`, which raises on a
    mismatch) ready for GRPO, as JAX `sft_to_grpo_params` makes it: its
    adapters merged (`merge_lora`) and fresh adapters of `lora_cfg` attached,
    drawn from `generator` (none with `lora_cfg` None)."""
    from bioreason_tpu_torch.train.lora import attach_lora, merge_lora
    model = merge_lora(load_sft_model(path, fusion_cfg, seed, decoder, encoder, device))
    if lora_cfg is not None:
        attach_lora(model, lora_cfg, generator)
    return model
