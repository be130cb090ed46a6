"""SFT trainer: LoRA fine-tuning of the fusion model (the port of
bioreason_tpu/train/sft.py, on one device: no mesh, no sequence or
pipeline parallelism).

One `train_step` is: host batch -> supervised positions gathered
(fused_ce.gather_label_positions) -> device tensors -> `fusion_forward`
with the vocab-chunked CE -> backward (the decoder's attention through
`flash_bwd` on the card) -> `AdamW.step` (clip, AdamW, warmup-cosine,
non-finite guard). As in the reference: LoRA over the text tower (all its
linear layers; embeddings and lm_head excluded), frozen DNA tower, trainable
projection. `freeze_encoder=False` (the CLI's --dna_model_finetune) trains
the DNA tower too (JAX train/sft.py:66-67), NT or Evo2, through `flash_bwd`
or, on NT's `attention_impl="local:<W>"`, the banded `local_bwd`. Trainable
parameters are fp32 masters; frozen fp32 parameters that are two or more
dimensional in the JAX package's tree (`trainable.frozen_cast`: the
per-layer norms and biases JAX stacks [L, ...] among them, and the Evo2
tower's filter leaves) are stored in `cfg.frozen_dtype`, as JAX stores
them (train/sft.py:88-99). `frozen_dtype="int8"` is QLoRA: the frozen
denses of both towers are stored int8 with per-channel scales
(train/quant.py), dequantized on every call (`layers.Int8Linear`, whose
backward keeps the int8 weight), and the other frozen float leaves and the
scales are stored in bf16, as JAX stores them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from bioreason_tpu_torch.config import FusionConfig, SFTConfig
from bioreason_tpu_torch.models.fusion import FusionModel, fusion_forward, init_fusion, \
    validate_splice
from bioreason_tpu_torch.ops.fused_ce import gather_label_positions
from bioreason_tpu_torch.train import trainable as T
from bioreason_tpu_torch.train.checkpoint import AsyncSaver, load_checkpoint, model_keys, \
    save_checkpoint
from bioreason_tpu_torch.train.lora import attach_lora, has_lora
from bioreason_tpu_torch.train.optim import AdamW
from bioreason_tpu_torch.train.quant import quantize_frozen_int8
from bioreason_tpu_torch.utils.devices import resolve_device

BATCH_KEYS = ("input_ids", "attention_mask", "dna_input_ids", "dna_attention_mask",
              "label_positions", "label_targets", "label_valid")


class SFTTrainer:
    def __init__(self, fusion_cfg: FusionConfig, cfg: SFTConfig,
                 model: Optional[FusionModel] = None, device=None,
                 base: Optional[Dict[str, Any]] = None):
        """`model`: weights to fine-tune (e.g. `pretrained.load_pretrained_fusion`
        or `weights.from_jax_params`); default: drawn from `cfg.seed`.
        `base`: the `pretrained.base_record` of the checkpoints `model` was
        loaded from, recorded in every checkpoint. Adapters are attached
        unless the model carries some already. Runs on `device` (CUDA unless
        "cpu")."""
        T.refuse_moe(fusion_cfg.decoder, "SFTTrainer")
        self.fusion_cfg, self.cfg = fusion_cfg, cfg
        self.device = resolve_device(device)
        # what builds the frozen base again (checkpoint.BASE_KEYS, with the
        # presets the caller adds, or checkpoint.PRETRAINED_KEYS); None for a
        # model the trainer cannot name the base of
        self.base_metadata: Optional[Dict[str, Any]] = None
        recorded = {"seed": cfg.seed, **model_keys(fusion_cfg),
                    "lora_r": cfg.lora.r if cfg.lora is not None else None,
                    "lora_alpha": cfg.lora.alpha if cfg.lora is not None else None,
                    "frozen_dtype": cfg.frozen_dtype}
        if model is None:
            model = init_fusion(fusion_cfg, seed=cfg.seed, device=self.device)
            self.base_metadata = {"init_device": self.device.type, **recorded}
        elif base is not None:
            self.base_metadata = {**base, **recorded}
        self.model = model.to(self.device)
        if cfg.lora is not None:
            if not has_lora(model):
                gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
                attach_lora(model, cfg.lora, gen)
            regex = T.LORA_TRAINABLE
        else:
            regex = T.FULL_FINETUNE
        if not cfg.freeze_encoder:
            regex = f"({regex})|{T.ENCODER}"
        if cfg.frozen_dtype == "int8":
            # QLoRA (JAX train/sft.py:69-79): the adapters attached above stay
            # fp32; the frozen towers' denses become int8, and set_trainable
            # stores the other frozen float leaves and the scales in bf16
            if cfg.lora is None or not cfg.freeze_encoder:
                raise ValueError("frozen_dtype='int8' requires LoRA with a frozen encoder "
                                 "(quantized weights don't train)")
            quantize_frozen_int8(model)
        self.params = T.set_trainable(model, regex, cfg.frozen_dtype)
        self.names = T.trainable_names(model)
        self.opt = AdamW(self.params, cfg.optim)
        self.step = 0
        self._saver = AsyncSaver()
        self._dropout_gen = torch.Generator().manual_seed(cfg.seed + 2)   # per-step seeds

    def _loss(self, db: Dict[str, torch.Tensor], train: bool) -> torch.Tensor:
        cfg = self.cfg
        rate = cfg.lora.dropout if (train and cfg.lora is not None) else 0.0
        _, loss = fusion_forward(
            self.model, self.fusion_cfg, db["input_ids"], db["attention_mask"],
            db.get("dna_input_ids"), db.get("dna_attention_mask"),
            label_positions=db["label_positions"], label_targets=db["label_targets"],
            label_valid=db["label_valid"],
            train_encoder=train and not cfg.freeze_encoder,
            train_embeddings=train and cfg.lora is None,
            lora_dropout_gen=self._dropout_gen if rate > 0.0 else None,
            lora_dropout_rate=rate,
            focal_gamma=cfg.focal_gamma if train else 0.0)
        return loss

    def _device_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        validate_splice(batch["input_ids"], batch.get("dna_input_ids"),
                        self.fusion_cfg.dna_pad_token_id)
        if "label_positions" not in batch:
            # the 151936-row head then runs on the supervised span only
            pos, tgt, val = gather_label_positions(batch["labels"])
            batch = {**batch, "label_positions": pos, "label_targets": tgt,
                     "label_valid": val}
        return {k: torch.as_tensor(np.asarray(batch[k]), device=self.device)
                for k in BATCH_KEYS if batch.get(k) is not None}

    def train_step(self, batch: Dict[str, Any]) -> Dict[str, float]:
        """One micro-step; the optimizer applies the mean gradient of every
        `grad_accum_steps` micro-steps. Returns loss, grad_norm (of this
        micro-step's raw gradients) and the schedule's lr at the new step."""
        loss = self._loss(self._device_batch(batch), train=True)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grad_norm = self.opt.accumulate(grads, self.cfg.grad_accum_steps)
        self.step += 1
        return {"loss": float(loss.detach()), "grad_norm": grad_norm,
                "lr": self.opt.schedule(self.step)}

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, Any]) -> float:
        """The plain (not focal) CE of a batch, no dropout."""
        return float(self._loss(self._device_batch(batch), train=False))

    def trainable_state(self) -> Dict[str, torch.Tensor]:
        return dict(zip(self.names, self.params))

    def save(self, path: str, metadata: Optional[Dict] = None, params_only: bool = False,
             block: bool = True) -> str:
        """Trainable parameters, optimizer state and step to `path`, with
        `base_metadata` (when the trainer knows the base) and `metadata` in
        its metadata (JAX train/sft.py:230-242). `params_only` leaves the
        optimizer state out (the best-k checkpoints, which only feed an
        eval or a fresh GRPO optimizer); `block=False` hands the write to
        an `AsyncSaver` after a device copy (`finish_saves` joins it)."""
        meta = {**(self.base_metadata or {}), **(metadata or {})}
        opt_state = None if params_only else self.opt.state_dict()
        if block:
            return save_checkpoint(path, self.trainable_state(), opt_state, self.step, meta)
        return self._saver.save(path, self.trainable_state(), opt_state, self.step, meta)

    def finish_saves(self) -> None:
        """Join the write in flight; re-raises its failure."""
        self._saver.wait()

    @torch.no_grad()
    def restore(self, path: str) -> "SFTTrainer":
        state = load_checkpoint(path)
        if sorted(state["trainable"]) != sorted(self.names):
            raise ValueError(f"checkpoint {path} holds other trainable parameters")
        if "opt_state" not in state:
            raise ValueError(f"checkpoint {path} holds parameters alone (params_only): it "
                             f"does not resume training")
        for name, p in zip(self.names, self.params):
            p.copy_(state["trainable"][name])
        self.opt.load_state_dict(state["opt_state"])
        self.step = int(state["step"])
        return self
