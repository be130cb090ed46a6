"""Generative evaluation (the port of bioreason_tpu/train/eval.py; the
reference's `on_test_epoch_end`, train_dna_qwen.py:645-939, the eval behind
the README's KEGG and variant-effect tables).

* `evaluate_generative` renders the PROMPT of each test example (user turn
  and generation prompt), generates through the port's `GenerationEngine`
  (so every prefill runs `flash_fwd` on the card), decodes with special
  tokens kept, and scores the reference's binary substring scheme with
  labels (negative, positive): a positive example whose generation contains
  the truth is TP, else FN; a negative one that contains it is TN (the
  reference's quirk, kept for parity), else FP; examples of neither label
  count in the total only. The ground truth is the text before ';'. The
  per-example rows go to a CSV in the JAX package's columns.
* `teacher_forced_probe` is the argmax accuracy at the token after named
  marker texts, and over the whole supervised span, with the gold answer
  teacher-forced.
* `multilabel_substring_accuracy` is the plain share of generations that
  contain their truth.

Generation runs in batches, where the reference generates one example at a
time.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bioreason_tpu_torch.config import SamplingConfig
from bioreason_tpu_torch.data.chat_template import render_chat


@dataclass
class EvalResult:
    accuracy: float
    precision: float
    recall: float
    f1: float
    true_positives: int
    false_positives: int
    true_negatives: int
    false_negatives: int
    total: int
    generations: List[Dict[str, Any]] = field(default_factory=list)

    def summary(self) -> Dict[str, float]:
        return {"test_accuracy": self.accuracy, "test_precision": self.precision,
                "test_recall": self.recall, "test_f1": self.f1}


def prompt_messages(example: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The system and user turns (the eval generates the answer)."""
    return [m for m in example["prompt"] if m["role"] != "assistant"]


def evaluate_generative(engine, model, processor, examples: Sequence[Dict[str, Any]],
                        labels: Tuple[str, str], sampling: SamplingConfig = SamplingConfig(),
                        max_new_tokens: int = 800, batch_size: int = 8, greedy: bool = False,
                        generator: Optional[torch.Generator] = None,
                        csv_path: Optional[str] = None, max_length_text: int = 512,
                        max_length_dna: int = 2048) -> EvalResult:
    """Generate for every example in batches of `batch_size` (left-padded
    prompts) and score them (module docstring). Sampled unless `greedy`,
    drawing from `generator`."""
    neg_label, pos_label = labels[0], labels[1]
    tok = processor.text_tokenizer
    tp = tn = fp = fn = total = 0
    generations: List[Dict[str, Any]] = []
    for start in range(0, len(examples), batch_size):
        chunk = list(examples[start:start + batch_size])
        rendered = [render_chat(prompt_messages(ex), add_generation_prompt=True) for ex in chunk]
        out = processor(text=rendered, batch_dna_sequences=[ex["dna_sequences"] for ex in chunk],
                        max_length_text=max_length_text, max_length_dna=max_length_dna,
                        padding_side="left")
        ids, mask = engine.generate(model, out.input_ids, out.attention_mask,
                                    out.dna_input_ids, out.dna_attention_mask, sampling=sampling,
                                    max_new_tokens=max_new_tokens, greedy=greedy,
                                    generator=generator)
        for i, ex in enumerate(chunk):
            gen_text = tok.decode(ids[i][mask[i].astype(bool)], skip_special_tokens=False).strip()
            truth = ex["answer"]
            if ";" in truth:
                truth = truth.split(";")[0]
            is_pos = truth.lower() == pos_label.lower()
            is_neg = truth.lower() == neg_label.lower()
            contains = truth.lower() in gen_text.lower()
            total += 1
            if is_pos and contains:
                tp, cat = tp + 1, "TP"
            elif is_pos:
                fn, cat = fn + 1, "FN"
            elif is_neg and contains:
                tn, cat = tn + 1, "TN"
            elif is_neg:
                fp, cat = fp + 1, "FP"
            else:
                cat = "OTHER"
            generations.append({
                "example_idx": start + i, "user_input": rendered[i], "generation": gen_text,
                "ground_truth": truth, "contains_ground_truth": contains,
                "is_positive_example": is_pos, "prediction_category": cat})

    accuracy = (tp + tn) / max(total, 1)
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-8)
    if csv_path and generations:
        os.makedirs(os.path.dirname(os.path.abspath(csv_path)), exist_ok=True)
        with open(csv_path, "w", newline="", encoding="utf-8") as f:
            writer = csv.DictWriter(f, fieldnames=list(generations[0].keys()))
            writer.writeheader()
            writer.writerows(generations)
    return EvalResult(accuracy, precision, recall, f1, tp, fp, tn, fn, total, generations)


@torch.no_grad()
def teacher_forced_probe(model, fusion_cfg, processor, examples: Sequence[Dict[str, Any]],
                         markers: Dict[str, str], batch_size: int = 8,
                         max_length_text: int = 512, max_length_dna: int = 2048,
                         supervise_eos: bool = False) -> Dict[str, float]:
    """Teacher-forced next-token accuracy at named marker positions: each
    example collated as SFT collates it (gold assistant turn included), one
    fusion forward for the logits, and for each `markers[name] = text` the
    argmax accuracy at the token right AFTER the first occurrence of `text`
    in the row; `span_acc` over the whole supervised span (eval.py:153-230).
    Runs on the model's device."""
    from bioreason_tpu_torch.data.collate import IGNORE_INDEX, _find_subsequence, sft_collate
    from bioreason_tpu_torch.models.fusion import fusion_forward
    dev = next(model.parameters()).device
    tok = processor.text_tokenizer
    marker_ids = {name: np.asarray(tok.encode(text), dtype=np.int32)
                  for name, text in markers.items()}
    hits = {name: 0 for name in markers}
    counts = {name: 0 for name in markers}
    span_hits = span_count = 0
    for start in range(0, len(examples), batch_size):
        batch = sft_collate(list(examples[start:start + batch_size]), processor,
                            max_length_text=max_length_text, max_length_dna=max_length_dna,
                            supervise_eos=supervise_eos)
        t = {k: (None if batch.get(k) is None else torch.as_tensor(np.asarray(batch[k]),
                                                                    device=dev))
             for k in ("input_ids", "attention_mask", "dna_input_ids", "dna_attention_mask")}
        logits, _ = fusion_forward(model, fusion_cfg, t["input_ids"], t["attention_mask"],
                                   t["dna_input_ids"], t["dna_attention_mask"])
        pred = logits.argmax(-1).cpu().numpy()                 # [B, T]
        ids = np.asarray(batch["input_ids"])
        labels = np.asarray(batch["labels"])
        # shifted: pred[:, t] (the logits at t) predicts ids[:, t + 1]
        for i in range(ids.shape[0]):
            row = ids[i]
            t_idx = np.nonzero(labels[i] != IGNORE_INDEX)[0]
            t_idx = t_idx[t_idx > 0]
            span_hits += int((pred[i, t_idx - 1] == row[t_idx]).sum())
            span_count += len(t_idx)
            for name, mids in marker_ids.items():
                pos = _find_subsequence(row, mids)
                if not pos:
                    continue
                q = pos[0] + len(mids)            # the first token after the marker
                if q < len(row):
                    counts[name] += 1
                    hits[name] += int(pred[i, q - 1] == row[q])
    out = {f"{name}_acc": hits[name] / max(counts[name], 1) for name in markers}
    out["span_acc"] = span_hits / max(span_count, 1)
    return out


def multilabel_substring_accuracy(generations: Sequence[Dict[str, Any]]) -> float:
    """The share of generations that contain their ground truth: the plain
    multi-class metric beside the reference's binary scheme."""
    if not generations:
        return 0.0
    return sum(g["contains_ground_truth"] for g in generations) / len(generations)
