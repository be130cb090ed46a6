"""DNA-only classifier trainer (the port of bioreason_tpu/train/classifier.py;
reference train_dna_only.py:22-270), on one device.

CE loss over (ref, alt) pairs; `train_step` / `eval_step` return accuracy,
macro precision / recall / F1 and the loss, as the reference logs them.
With `train_just_classifier` (the default) only the pooler and the head
train, fp32 masters, and the frozen encoder is stored in the compute dtype
(its norms stay fp32, which the JAX layer norm reads in fp32). Otherwise
the encoder trains too, from fp32 masters, its updates scaled by
`encoder_lr_scale` after the whole AdamW update, weight decay included,
with the global norm clipped over every parameter first (JAX :68-77,
`optim.AdamW(lr_scales=...)`). No dropout: the JAX trainer passes no
dropout_rng to `classifier_forward` (:84-88).

`save` writes what trains with what rebuilds the rest (the encoder preset,
the seed and the device type that drew it, the classes);
`checkpoint.load_classifier` rebuilds the classifier and raises on any
mismatch.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from bioreason_tpu_torch.config import EncoderConfig, OptimConfig
from bioreason_tpu_torch.models.classifier import (DnaClassifier, classifier_forward,
                                                   init_classifier)
from bioreason_tpu_torch.train import trainable as T
from bioreason_tpu_torch.train.checkpoint import save_checkpoint
from bioreason_tpu_torch.train.optim import AdamW
from bioreason_tpu_torch.utils.devices import resolve_device, torch_dtype

BATCH_KEYS = ("ref_ids", "alt_ids", "ref_attention_mask", "alt_attention_mask", "labels")


def multiclass_prf(preds: np.ndarray, labels: np.ndarray, num_classes: int):
    """Macro precision/recall/F1 + accuracy."""
    precisions, recalls, f1s = [], [], []
    for c in range(num_classes):
        tp = int(((preds == c) & (labels == c)).sum())
        fp = int(((preds == c) & (labels != c)).sum())
        fn = int(((preds != c) & (labels == c)).sum())
        p = tp / max(tp + fp, 1)
        r = tp / max(tp + fn, 1)
        precisions.append(p)
        recalls.append(r)
        f1s.append(2 * p * r / max(p + r, 1e-8))
    acc = float((preds == labels).mean()) if len(labels) else 0.0
    return {"accuracy": acc, "precision": float(np.mean(precisions)),
            "recall": float(np.mean(recalls)), "f1": float(np.mean(f1s))}


def partition(model: DnaClassifier, cfg: EncoderConfig, train_just_classifier: bool):
    """(names, parameters) that train, fp32 with requires_grad; the rest
    frozen, those of two or more dimensions stored in cfg.dtype."""
    regex = re.compile(T.CLASSIFIER_HEAD if train_just_classifier else r".*")
    low = torch_dtype(cfg.dtype)
    names, params = [], []
    for name, p in model.named_parameters():
        if regex.search(name):
            p.data = p.data.float()
            p.requires_grad_(True)
            names.append(name)
            params.append(p)
        else:
            p.requires_grad_(False)
            if p.dim() >= 2:
                p.data = p.data.to(low)
    return names, params


class ClassifierTrainer:
    def __init__(self, cfg: EncoderConfig, num_classes: int,
                 optim: OptimConfig = OptimConfig(learning_rate=1e-3),
                 train_just_classifier: bool = True, encoder_lr_scale: float = 0.1,
                 model: Optional[DnaClassifier] = None, seed: int = 0, device=None):
        """`model`: weights to train (e.g. `weights.from_jax_params` of a JAX
        classifier tree); default: drawn from `seed` on `device` (CUDA
        unless "cpu")."""
        self.cfg = cfg
        self.num_classes = num_classes
        self.train_just_classifier = train_just_classifier
        self.device = resolve_device(device)
        self.seed = seed
        self.init_device = self.device.type if model is None else None
        if model is None:
            model = init_classifier(cfg, num_classes, seed, self.device)
        self.model = model.to(self.device)
        self.names, self.params = partition(self.model, cfg, train_just_classifier)
        scales = None
        if not train_just_classifier:
            scales = [encoder_lr_scale if n.startswith("encoder") else 1.0 for n in self.names]
        self.opt = AdamW(self.params, optim, lr_scales=scales)
        self.step_count = 0

    def _device_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(batch[k]), device=self.device)
                for k in BATCH_KEYS}

    def _loss(self, db: Dict[str, torch.Tensor]):
        logits = classifier_forward(
            self.model, self.cfg, db["ref_ids"], db["alt_ids"], db["ref_attention_mask"],
            db["alt_attention_mask"], train_encoder=not self.train_just_classifier)
        return F.cross_entropy(logits, db["labels"].long()), logits

    def _metrics(self, loss, logits, labels) -> Dict[str, float]:
        preds = logits.argmax(-1).cpu().numpy()
        m = multiclass_prf(preds, np.asarray(labels), self.num_classes)
        m["loss"] = float(loss.detach())
        return m

    def train_step(self, batch: Dict[str, Any]) -> Dict[str, float]:
        db = self._device_batch(batch)
        loss, logits = self._loss(db)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        self.opt.step(grads)
        self.step_count += 1
        return self._metrics(loss, logits, batch["labels"])

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, Any]) -> Dict[str, float]:
        loss, logits = self._loss(self._device_batch(batch))
        return self._metrics(loss, logits, batch["labels"])

    def save(self, path: str, encoder: str, labels: List[str]) -> str:
        """The trained parameters, the optimizer state and the step to
        `path`, with what draws the rest again (`checkpoint.CLASSIFIER_KEYS`;
        `encoder` is the preset name the model was drawn from)."""
        if self.init_device is None:
            raise ValueError("the trainer was given its model: it cannot name what draws "
                             "the frozen weights again")
        meta = {"stage": "classifier", "encoder": encoder, "seed": self.seed,
                "init_device": self.init_device, "num_classes": self.num_classes,
                "labels": list(labels), "train_just_classifier": self.train_just_classifier,
                "dtype": self.cfg.dtype}
        return save_checkpoint(path, dict(zip(self.names, self.params)),
                               self.opt.state_dict(), self.step_count, meta)
