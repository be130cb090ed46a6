"""Trainer checkpoints: the trainable parameters, the optimizer state and the
step, in one `torch.save` file (the resumable subset of
bioreason_tpu/train/checkpoint.py; frozen weights are not written, since
they come from the seed or the checkpoint that built the model), or the
parameters alone (`opt_state=None`: JAX `save(..., params_only=True)`, for
the best-k checkpoints that only feed an eval or a fresh GRPO optimizer);
`AsyncSaver`, the same write off the training thread; `load_metadata`;
`TopKKeeper`, the k best checkpoints by validation loss; and
`load_classifier`, the DNA-only classifier's rebuild.

A checkpoint records in its metadata the frozen base its adapters belong
to, since adapters paired with another base would load without complaint
and mean nothing. A base drawn from a seed is recorded by what draws it
again (`BASE_KEYS`: the seed, the device type that drew it, the presets,
the attention and embedding tap of the DNA tower that runs, the
vocabulary, the compute dtype, the LoRA rank and the frozen weights'
storage dtype); a pretrained base by its directories and a fingerprint of
each weights file (`PRETRAINED_KEYS`, `utils/pretrained.base_record`).
`load_sft_model` rebuilds the SFT model from either and refuses any
mismatch with the caller's configuration, and a pretrained base that is
missing or changed: it never falls back to another base.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import threading
from typing import Any, Dict, Optional

import torch

BASE_KEYS = ("seed", "init_device", "decoder", "encoder", "dna_attention",
             "dna_embedding_layer", "vocab_size", "dtype", "lora_r", "lora_alpha",
             "frozen_dtype")
# a pretrained base: the seed still draws an LLM-only model's unused tiny
# encoder (pretrained.load_pretrained_fusion)
PRETRAINED_KEYS = ("hf_llm_dir", "hf_dna_dir", "evo2_dir", "base_files", "seed",
                   "dna_attention", "dna_embedding_layer", "vocab_size", "dtype", "lora_r",
                   "lora_alpha", "frozen_dtype")

# what a DNA-only classifier's checkpoint records to build its model again
# (the JAX CLI saves `dna_only_final` with stage="classifier" and its labels)
CLASSIFIER_KEYS = ("stage", "encoder", "seed", "init_device", "num_classes", "labels",
                   "train_just_classifier", "dtype")

FILE = "state.pt"


def model_keys(fusion_cfg) -> Dict[str, Any]:
    """The base keys that `fusion_cfg` fixes, read from the DNA tower
    that runs (`FusionConfig.dna_tower`: an Evo2 config also carries an
    unused NT `encoder`); the NT tower has no embedding tap (-1)."""
    evo2 = fusion_cfg.encoder_kind == "evo2"
    return {"dna_attention": fusion_cfg.dna_tower.attention_impl,
            "dna_embedding_layer": fusion_cfg.hyena.embedding_tap_layer if evo2 else -1,
            "vocab_size": fusion_cfg.decoder.vocab_size, "dtype": fusion_cfg.decoder.dtype}


def _map_tensors(fn, opt_state: Dict) -> Dict:
    return {k: ([fn(t) for t in v] if isinstance(v, list) else v) for k, v in opt_state.items()}


def save_checkpoint(path: str, trainable: Dict[str, torch.Tensor], opt_state: Optional[Dict],
                    step: int, metadata: Optional[Dict[str, Any]] = None) -> str:
    """Write `path`/state.pt (written to a temporary name, then renamed);
    `opt_state` None writes the parameters alone (no "opt_state" key)."""
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, FILE)
    tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
    state = {"trainable": {k: v.detach().cpu() for k, v in trainable.items()},
             "step": int(step), "metadata": dict(metadata or {})}
    if opt_state is not None:
        state["opt_state"] = _map_tensors(lambda t: t.detach().cpu(), opt_state)
    torch.save(state, tmp)
    os.replace(tmp, target)
    return target


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The dict `save_checkpoint` wrote, tensors on the CPU ("opt_state"
    only where it was written)."""
    return torch.load(os.path.join(path, FILE), map_location="cpu", weights_only=True)


def load_metadata(path: str) -> Dict[str, Any]:
    """The step and the metadata a checkpoint records (JAX
    checkpoint.py:214 reads its metadata.json), without reading its
    tensors (the file is memory-mapped)."""
    state = torch.load(os.path.join(path, FILE), map_location="cpu", weights_only=True,
                       mmap=True)
    return {"step": state["step"], **state["metadata"]}


class AsyncSaver:
    """`save_checkpoint` off the training thread (JAX checkpoint.py:53-80).

    The trainer's parameters and optimizer state change in place at the
    next `opt.step()` (torch's counterpart of JAX's donated buffers), so
    `save` snapshots them with a device copy, queued on the caller's stream
    before any later step; the copy to the host and the file write run in
    a daemon thread. One save is in flight at a time: a new `save` (or
    `wait`) joins the previous one first. A failed write is re-raised, as
    RuntimeError from the failure, at the next `save` or `wait`, so a
    periodic checkpoint never goes missing unseen."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: str, trainable: Dict[str, torch.Tensor], opt_state: Optional[Dict],
             step: int, metadata: Optional[Dict[str, Any]] = None) -> str:
        self.wait()
        with torch.no_grad():
            snap = {k: v.detach().clone() for k, v in trainable.items()}
            snap_opt = (None if opt_state is None
                        else _map_tensors(lambda t: t.detach().clone(), opt_state))
        meta = dict(metadata or {})

        def run():
            try:
                save_checkpoint(path, snap, snap_opt, step, meta)
            except BaseException as e:        # re-raised by the next save / wait
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return os.path.join(path, FILE)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from err


def is_pretrained(meta: Dict[str, Any]) -> bool:
    return "hf_llm_dir" in meta


def _check_keys(path: str, meta: Dict[str, Any]) -> None:
    keys = PRETRAINED_KEYS if is_pretrained(meta) else BASE_KEYS
    missing = [k for k in keys if k not in meta]
    if missing:
        raise ValueError(
            f"{path}: its metadata lacks {missing}, so the frozen base it was trained on "
            f"cannot be built again (a checkpoint written before the port recorded them); "
            f"train it again")


def _pretrained_base(meta: Dict[str, Any], device, max_length_text: int = 512,
                     max_length_dna: int = 2048):
    """(FusionConfig, base model, text tokenizer, DNA tokenizer) of the
    recorded pretrained base, after `pretrained.check_base` (which raises
    on a missing or changed file), with the recorded DNA attention."""
    import dataclasses

    from bioreason_tpu_torch.utils.pretrained import check_base, load_pretrained_fusion
    check_base(meta)
    cfg, model, tok, dna_tok = load_pretrained_fusion(
        meta["hf_llm_dir"], meta["hf_dna_dir"], max_length_text, max_length_dna,
        seed=meta["seed"], dtype=meta["dtype"], evo2_dir=meta["evo2_dir"],
        dna_embedding_layer=meta["dna_embedding_layer"], device=device)
    impl = meta["dna_attention"]
    if cfg.encoder_kind == "evo2":
        cfg = dataclasses.replace(cfg, hyena=dataclasses.replace(cfg.hyena, attention_impl=impl))
    else:
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder,
                                                                   attention_impl=impl))
    return cfg, model, tok, dna_tok


@torch.no_grad()
def _load_trained(path: str, state: Dict[str, Any], model, device):
    """The SFT adapters attached to the base `model`, every trained
    parameter loaded (fp32) and the frozen ones stored as the trainer
    stored them: a QLoRA base (frozen_dtype "int8") quantized again from
    the same weights (`quant.quantize_frozen_int8`), then
    `trainable.store_frozen`."""
    from bioreason_tpu_torch.config import LoRAConfig
    from bioreason_tpu_torch.train.lora import attach_lora
    from bioreason_tpu_torch.train.quant import quantize_frozen_int8
    from bioreason_tpu_torch.train.trainable import store_frozen
    meta = state["metadata"]
    model = model.to(device)
    if meta["lora_r"] is not None:
        attach_lora(model, LoRAConfig(r=meta["lora_r"], alpha=meta["lora_alpha"]))
    if meta["frozen_dtype"] == "int8":
        quantize_frozen_int8(model)
    trained = state["trainable"]
    params = dict(model.named_parameters())
    for name in trained:
        if name not in params or params[name].shape != trained[name].shape:
            raise ValueError(f"{path}: {name} {tuple(trained[name].shape)} does not fit "
                             f"the model")
    for name in trained:
        params[name].data = trained[name].to(device)
    store_frozen(model, meta["frozen_dtype"] or "", lambda name: name not in trained)
    return model


@torch.no_grad()
def load_sft_model(path: str, fusion_cfg, seed: int, decoder: str, encoder: str, device=None):
    """The model of the SFT trainer that wrote `path` (an `sft_final` or
    `sft_state` of the port), parameter for parameter: the frozen base
    built again (drawn from the recorded seed on the recorded device type,
    or loaded from the recorded pretrained directories), the SFT adapters
    attached and every trained parameter loaded (fp32), the frozen
    parameters stored as the trainer stored them.

    Raises ValueError when the checkpoint does not record its base, or
    records another base than `fusion_cfg` and the arguments ask for: for
    a seeded base another seed or preset (`decoder`, `encoder`: the CLI
    preset names), DNA attention, embedding tap, vocabulary size or dtype;
    for a pretrained one, a `fusion_cfg` of another vocabulary, DNA
    attention, tap or dtype (seed and presets are not asked of it). A
    recorded pretrained directory or file that is gone or changed raises
    too (`pretrained.check_base`)."""
    from bioreason_tpu_torch.models.fusion import init_fusion
    from bioreason_tpu_torch.utils.devices import resolve_device

    state = load_checkpoint(path)
    meta = state["metadata"]
    _check_keys(path, meta)
    device = resolve_device(device)
    want = model_keys(fusion_cfg)
    if not is_pretrained(meta):
        want.update(seed=seed, decoder=decoder, encoder=encoder)
    wrong = {k: (meta[k], v) for k, v in want.items() if meta[k] != v}
    if wrong:
        raise ValueError(f"{path} was trained on another base: (checkpoint, asked) {wrong}")
    if is_pretrained(meta):
        _, model, _, _ = _pretrained_base(meta, device, fusion_cfg.max_length_text,
                                          fusion_cfg.max_length_dna)
    else:
        model = init_fusion(fusion_cfg, seed=meta["seed"], device=meta["init_device"])
    return _load_trained(path, state, model, device)


def rebuild_sft(path: str, device=None, max_length_text: int = 512, max_length_dna: int = 2048):
    """Everything a server needs from an SFT checkpoint alone:
    (FusionConfig, the SFT model, text tokenizer, DNA tokenizer), the base
    built from what the metadata records (a pretrained base from its
    directories, after `pretrained.check_base`; a seeded one from its seed
    and presets with the byte tokenizer)."""
    import dataclasses

    from bioreason_tpu_torch.cli.common import DECODER_PRESETS, build_encoder_config
    from bioreason_tpu_torch.config import FusionConfig
    from bioreason_tpu_torch.data.text_tokenizer import ByteTextTokenizer
    from bioreason_tpu_torch.models.fusion import init_fusion
    from bioreason_tpu_torch.utils.devices import resolve_device

    state = load_checkpoint(path)
    meta = state["metadata"]
    _check_keys(path, meta)
    device = resolve_device(device)
    if is_pretrained(meta):
        cfg, model, tok, dna_tok = _pretrained_base(meta, device, max_length_text,
                                                    max_length_dna)
    else:
        tok = ByteTextTokenizer()
        kind, enc, hyena, dna_tok = build_encoder_config(meta["encoder"],
                                                         meta["dna_embedding_layer"])
        dec = DECODER_PRESETS[meta["decoder"]](vocab_size=meta["vocab_size"])
        # a --dtype run set both towers' dtype
        dt = {} if meta["dtype"] == dec.dtype else {"dtype": meta["dtype"]}
        dec = dataclasses.replace(dec, **dt)
        if kind == "evo2":
            hyena = dataclasses.replace(hyena, attention_impl=meta["dna_attention"], **dt)
        else:
            enc = dataclasses.replace(enc, attention_impl=meta["dna_attention"], **dt)
        cfg = FusionConfig(decoder=dec, encoder=enc, hyena=hyena, encoder_kind=kind,
                           dna_pad_token_id=tok.dna_pad_id, max_length_text=max_length_text,
                           max_length_dna=max_length_dna)
        model = init_fusion(cfg, seed=meta["seed"], device=meta["init_device"])
    return cfg, _load_trained(path, state, model, device), tok, dna_tok


@torch.no_grad()
def load_sft_for_grpo(path: str, fusion_cfg, lora_cfg, seed: int, decoder: str, encoder: str,
                      device=None, generator: Optional[torch.Generator] = None):
    """The SFT model of `path` (`load_sft_model`, which raises on a
    mismatch) ready for GRPO, as JAX `sft_to_grpo_params` makes it: its
    adapters merged (`merge_lora`) and fresh adapters of `lora_cfg` attached,
    drawn from `generator` (none with `lora_cfg` None). A QLoRA checkpoint
    (frozen_dtype "int8") raises ValueError before anything is built:
    `merge_lora` refuses int8 weights."""
    from bioreason_tpu_torch.train.lora import attach_lora, merge_lora
    if load_checkpoint(path)["metadata"].get("frozen_dtype") == "int8":
        raise ValueError(f"{path} is a QLoRA checkpoint: its adapters cannot be merged "
                         f"into int8 weights")
    model = merge_lora(load_sft_model(path, fusion_cfg, seed, decoder, encoder, device))
    if lora_cfg is not None:
        attach_lora(model, lora_cfg, generator)
    return model


class TopKKeeper:
    """The k best checkpoints by a monitored value (the port of JAX
    checkpoint.py:154; reference ModelCheckpoint top-2 on val_loss_epoch,
    train_dna_qwen.py:962-971). `update(value, save_fn, step)` after each
    validation writes `<root>/best-step<N>` when `value` ranks in the top k
    and removes the one it pushes out; `<root>/index.json` records the
    ranking, so `best_path()` finds the winner after a restart."""

    def __init__(self, root: str, k: int = 2, mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode {mode!r}: expected 'min' or 'max'")
        self.root = os.path.abspath(root)
        self.k = k
        self.mode = mode
        self._kept: list = []                  # [(value, step, path)], best first
        os.makedirs(self.root, exist_ok=True)
        idx = os.path.join(self.root, "index.json")
        if os.path.exists(idx):                # resume: adopt the surviving dirs
            with open(idx) as f:
                for value, step, path in json.load(f)["kept"]:
                    if os.path.isdir(path):
                        self._kept.append((value, step, path))

    def _better(self, a: float, b: float) -> bool:
        return a < b if self.mode == "min" else a > b

    def update(self, value: float, save_fn, step: int) -> Optional[str]:
        """`save_fn(path)` writes the checkpoint. Returns the path when
        `value` made the top k, else None (nothing written). A non-finite
        value is never kept."""
        value = float(value)
        if not math.isfinite(value):
            return None
        if len(self._kept) >= self.k and not self._better(value, self._kept[-1][0]):
            return None
        path = os.path.join(self.root, f"best-step{step}")
        save_fn(path)
        self._kept.append((value, step, path))
        self._kept.sort(key=lambda t: t[0], reverse=(self.mode == "max"))
        while len(self._kept) > self.k:
            shutil.rmtree(self._kept.pop()[2], ignore_errors=True)
        with open(os.path.join(self.root, "index.json"), "w") as f:
            json.dump({"monitor_mode": self.mode, "k": self.k, "kept": self._kept}, f)
        return path

    def best_path(self) -> Optional[str]:
        return self._kept[0][2] if self._kept else None


@torch.no_grad()
def load_classifier(path: str, cfg, encoder: Optional[str] = None, device=None):
    """(the classifier, its labels) from a checkpoint `ClassifierTrainer.save`
    wrote: the model drawn again from the recorded seed on a device of the
    recorded type, the trained parameters loaded, the frozen ones stored as
    the trainer stored them. Raises where the checkpoint is not a
    classifier's, lacks a key, names another `encoder` preset or dtype than
    the caller's, was drawn on another device type, or holds other
    parameters than the model's trainable ones."""
    from bioreason_tpu_torch.models.classifier import init_classifier
    from bioreason_tpu_torch.train.classifier import partition
    from bioreason_tpu_torch.utils.devices import resolve_device
    device = resolve_device(device)
    state = load_checkpoint(path)
    meta = state["metadata"]
    missing = [k for k in CLASSIFIER_KEYS if k not in meta]
    if missing or meta["stage"] != "classifier":
        raise ValueError(f"{path}: not a classifier checkpoint of the port (lacks {missing})")
    if encoder is not None and meta["encoder"] != encoder:
        raise ValueError(f"{path} was trained on encoder {meta['encoder']!r}, not {encoder!r}")
    if meta["dtype"] != cfg.dtype:
        raise ValueError(f"{path} was trained in {meta['dtype']}, not {cfg.dtype}")
    if meta["init_device"] != device.type:
        raise ValueError(f"{path}: its frozen weights were drawn on {meta['init_device']}, "
                         f"which {device.type} does not draw again")
    model = init_classifier(cfg, meta["num_classes"], meta["seed"], device)
    names, params = partition(model, cfg, meta["train_just_classifier"])
    trained = state["trainable"]
    if sorted(trained) != sorted(names):
        raise ValueError(f"{path} holds other trained parameters than the classifier's")
    for name, p in zip(names, params):
        if tuple(trained[name].shape) != tuple(p.shape):
            raise ValueError(f"{path}: {name} is {tuple(trained[name].shape)}, the model's "
                             f"{tuple(p.shape)}")
        p.copy_(trained[name])
    return model.requires_grad_(False), list(meta["labels"])
