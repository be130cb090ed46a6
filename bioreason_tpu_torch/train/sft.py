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

import contextlib
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
from bioreason_tpu_torch.parallel.trainer import DistAdamW
from bioreason_tpu_torch.train.quant import quantize_frozen_int8
from bioreason_tpu_torch.utils.devices import resolve_device

BATCH_KEYS = ("input_ids", "attention_mask", "dna_input_ids", "dna_attention_mask",
              "label_positions", "label_targets", "label_valid")


class SFTTrainer:
    def __init__(self, fusion_cfg: FusionConfig, cfg: SFTConfig,
                 model: Optional[FusionModel] = None, device=None,
                 base: Optional[Dict[str, Any]] = None, mesh=None):
        """`model`: weights to fine-tune (e.g. `pretrained.load_pretrained_fusion`
        or `weights.from_jax_params`); default: drawn from `cfg.seed`.
        `base`: the `pretrained.base_record` of the checkpoints `model` was
        loaded from, recorded in every checkpoint. Adapters are attached
        unless the model carries some already. Runs on `device` (CUDA unless
        "cpu"). `mesh` (`parallel.mesh.make_mesh`): run as one rank of it
        (parallel/trainer.py): every rank builds the same model from the
        same seed, keeps its shards, and takes the same global batches;
        None is the one-device trainer."""
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
        self.run = None
        if mesh is not None:
            self._mesh_run(mesh)
        self.names = T.trainable_names(model)
        self.opt = AdamW(self.params, cfg.optim)
        if self.run is not None:
            self.params = [p for p in model.parameters() if p.requires_grad]
            self.opt = DistAdamW(self.params, self.names, cfg.optim, self.run)
        self.step = 0
        self._saver = AsyncSaver()
        self._dropout_gen = torch.Generator().manual_seed(cfg.seed + 2)   # per-step seeds

    def _mesh_run(self, mesh) -> None:
        """Shard the model over `mesh` (parallel/partition.py): sequence
        parallelism when a tower's attention asks for it ("sp..."), GPipe
        when `pp_micro` > 0 and the model axis is above 1; tensor
        parallelism over 'model' in the decoder's layers (without GPipe)
        and the NT tower's (without sequence parallelism). QLoRA's int8
        weights stay whole on every rank (JAX's `P()`), each rank computing
        on its heads, rows or experts of them."""
        from bioreason_tpu_torch.parallel.trainer import MeshRun, nt_tower
        fc, cfg = self.fusion_cfg, self.cfg
        if cfg.pp_micro > 0 and cfg.frozen_dtype == "int8":
            raise ValueError("pp_micro with int8 frozen weights is untested; "
                             "use bf16 frozen weights under PP")
        tower = fc.hyena if fc.encoder_kind == "evo2" else fc.encoder
        sp = str(tower.attention_impl).startswith("sp")
        self.run = MeshRun(mesh, self.model, fc.decoder, sp=sp, pp_micro=cfg.pp_micro,
                           encoder_cfg=nt_tower(fc))

    def _scope(self):
        """Under a mesh, `MeshRun.scope`: it holds for the forward and the
        backward (the sequence and pipeline axes). Each layer, table and
        projection gathers its fsdp shards for itself while it runs, in
        the forward, in a remat layer's recompute and for the backward's
        reads, and frees them after (`partition.layer_gathered`)."""
        return contextlib.nullcontext() if self.run is None else self.run.scope()

    def inference_scope(self):
        """The context of a forward of a batch that every rank holds whole
        (the CLI's probe): under a mesh `MeshRun.scope_unsplit`, its layers
        gathered one at a time as in `_scope`."""
        return contextlib.nullcontext() if self.run is None else self.run.scope_unsplit()

    def _loss(self, db: Dict[str, torch.Tensor], train: bool) -> torch.Tensor:
        """The batch's loss; under a mesh this rank's share of the global
        batch's, inside `_scope`."""
        cfg = self.cfg
        rate = cfg.lora.dropout if (train and cfg.lora is not None) else 0.0
        focal = cfg.focal_gamma if train else 0.0
        # under a mesh the focal mean divides by the weights summed over
        # every rank's rows (JAX's global sum): this rank's share is then
        # its own weighted sum over that total, not its token share
        focal_axis = self.run.dp if focal > 0.0 and db.get("split") else None
        _, loss = fusion_forward(
            self.model, self.fusion_cfg, db["input_ids"], db["attention_mask"],
            db.get("dna_input_ids"), db.get("dna_attention_mask"),
            label_positions=db["label_positions"], label_targets=db["label_targets"],
            label_valid=db["label_valid"],
            train_encoder=train and not cfg.freeze_encoder,
            train_embeddings=train and cfg.lora is None,
            lora_dropout_gen=self._dropout_gen if rate > 0.0 else None,
            lora_dropout_rate=rate,
            focal_gamma=focal, focal_axis=focal_axis)
        if self.run is None or focal_axis is not None:
            return loss
        return loss * db["share"]

    def _device_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        validate_splice(batch["input_ids"], batch.get("dna_input_ids"),
                        self.fusion_cfg.dna_pad_token_id)
        if "label_positions" not in batch:
            # the 151936-row head then runs on the supervised span only
            pos, tgt, val = gather_label_positions(batch["labels"])
            batch = {**batch, "label_positions": pos, "label_targets": tgt,
                     "label_valid": val}
        if self.run is None:
            return {k: torch.as_tensor(np.asarray(batch[k]), device=self.device)
                    for k in BATCH_KEYS if batch.get(k) is not None}
        # this rank's rows; its loss weighs by its share of the global
        # supervised tokens (the CE's denominator, at least 1 per rank). A
        # batch whose rows do not split over dp runs whole on every rank
        valid = np.asarray(batch["label_valid"])
        split = valid.shape[0] % self.run.dp.size == 0
        self.run.split_rows(split)
        rows = {k: self.run.rows(np.asarray(batch[k])) if split else np.asarray(batch[k])
                for k in BATCH_KEYS if batch.get(k) is not None}
        share = (max(int(rows["label_valid"].sum()), 1) / max(int(valid.sum()), 1) if split
                 else 1.0 / self.run.dp.size)
        out = {k: torch.as_tensor(v, device=self.device) for k, v in rows.items()}
        out["share"], out["split"] = share, split
        return out

    def train_step(self, batch: Dict[str, Any]) -> Dict[str, float]:
        """One micro-step; the optimizer applies the mean gradient of every
        `grad_accum_steps` micro-steps. Returns loss, grad_norm (of this
        micro-step's raw gradients) and the schedule's lr at the new step."""
        loss, grads = self.loss_and_grads(self._device_batch(batch))
        grad_norm = self.opt.accumulate(grads, self.cfg.grad_accum_steps)
        self.step += 1
        if self.run is not None:
            loss = self.run.sum_dp(loss.detach())
        return {"loss": float(loss.detach()), "grad_norm": grad_norm,
                "lr": self.opt.schedule(self.step)}

    def loss_and_grads(self, db: Dict[str, torch.Tensor]):
        """(loss, gradients of `params`) of a device batch, the training
        loss; under a mesh this rank's share and its unreduced gradients."""
        with self._scope():
            loss = self._loss(db, train=True)
            # under the pipeline every rank holds the loss; the last stage
            # alone differentiates it (parallel/pp.py)
            root = loss if self.run is None or self.run.last_stage else loss * 0.0
            grads = torch.autograd.grad(root, self.params, allow_unused=True)
        return loss, grads

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, Any]) -> float:
        """The plain (not focal) CE of a batch, no dropout."""
        db = self._device_batch(batch)
        with self._scope():
            loss = self._loss(db, train=False)
        return float(loss if self.run is None else self.run.sum_dp(loss))

    def trainable_state(self) -> Dict[str, torch.Tensor]:
        """name -> parameter; under a mesh the whole tensors, gathered from
        every rank's pieces (a collective every rank takes)."""
        if self.run is not None:
            from bioreason_tpu_torch.parallel.trainer import full_named
            return full_named(self.run, dict(zip(self.names, self.params)))
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
        if self.run is not None:
            return self._save_mesh(path, meta, params_only)
        opt_state = None if params_only else self.opt.state_dict()
        if block:
            return save_checkpoint(path, self.trainable_state(), opt_state, self.step, meta)
        return self._saver.save(path, self.trainable_state(), opt_state, self.step, meta)

    def _save_mesh(self, path: str, meta: Dict, params_only: bool) -> str:
        """`save` under a mesh: every rank gathers, rank 0 writes (blocking)."""
        from bioreason_tpu_torch.parallel.trainer import is_writer
        params = self.trainable_state()
        opt_state = None if params_only else self.opt.full_state(list(params))
        if is_writer():
            save_checkpoint(path, params, opt_state, self.step, meta)
        return path

    def finish_saves(self) -> None:
        """Join the write in flight; re-raises its failure."""
        self._saver.wait()

    @torch.no_grad()
    def restore(self, path: str) -> "SFTTrainer":
        state = load_checkpoint(path)
        held = sorted(state["trainable"])
        if (held != sorted(self.names) if self.run is None
                else not set(self.names) <= set(held)):
            raise ValueError(f"checkpoint {path} holds other trainable parameters")
        if "opt_state" not in state:
            raise ValueError(f"checkpoint {path} holds parameters alone (params_only): it "
                             f"does not resume training")
        if self.run is not None:       # every rank takes its pieces
            for name, p in zip(self.names, self.params):
                p.copy_(self.run.plan.shard(name, state["trainable"][name].to(p.device)))
            self.opt.load_full_state({**state["opt_state"], "names": list(state["trainable"])})
            self.step = int(state["step"])
            return self
        for name, p in zip(self.names, self.params):
            p.copy_(state["trainable"][name])
        self.opt.load_state_dict(state["opt_state"])
        self.step = int(state["step"])
        return self
