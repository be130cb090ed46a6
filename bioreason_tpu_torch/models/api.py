"""User-facing model API: object wrappers over the port's modules (the port
of bioreason_tpu/models/api.py).

`DnaLLM` and `DNAClassifier` mirror the reference's public surface
(`DNALLMModel`, dna_llm.py:18-305; `DNAClassifierModel`, dna_only.py:42-203)
as the JAX package does: tokenize and splice (`prepare_inputs`), the fused
forward (`__call__`: logits, loss), generation through the port's
`GenerationEngine` (`generate`, `generate_text`) and whole-model
checkpoints through `train/checkpoint.py` (`save`, `load`). Where the JAX
wrappers hold a parameter tree, these hold the `nn.Module` (`self.model`);
a `params` argument of the JAX methods is a `model` here. Both run on
`device`, CUDA unless the caller passes "cpu".
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bioreason_tpu_torch.config import EncoderConfig, FusionConfig, SamplingConfig
from bioreason_tpu_torch.data.char_tokenizer import CharDNATokenizer
from bioreason_tpu_torch.data.nt_tokenizer import KmerTokenizer
from bioreason_tpu_torch.data.processor import BioProcessor
from bioreason_tpu_torch.data.text_tokenizer import ByteTextTokenizer
from bioreason_tpu_torch.models.classifier import classifier_forward, init_classifier
from bioreason_tpu_torch.models.fusion import fusion_forward, init_fusion, validate_splice
from bioreason_tpu_torch.utils.devices import resolve_device


def _save_module(model: torch.nn.Module, path: str, step: int, metadata: Dict) -> str:
    """Every parameter and buffer of `model` as `train/checkpoint.py`'s
    file (its "trainable" entry holds them all; no optimizer state)."""
    from bioreason_tpu_torch.train.checkpoint import save_checkpoint
    state = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    return save_checkpoint(path, state, None, step, metadata)


@torch.no_grad()
def _load_module(model: torch.nn.Module, path: str) -> None:
    """The tensors `_save_module` wrote, copied into `model` by name; raises
    on a name or shape that does not fit."""
    from bioreason_tpu_torch.train.checkpoint import load_checkpoint
    saved = load_checkpoint(path)["trainable"]
    mine = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    if sorted(saved) != sorted(mine):
        raise ValueError(f"{path} holds other tensors than this model: "
                         f"{sorted(set(saved) ^ set(mine))[:8]}")
    for name, t in mine.items():
        if tuple(saved[name].shape) != tuple(t.shape):
            raise ValueError(f"{path}: {name} {tuple(saved[name].shape)} does not fit "
                             f"{tuple(t.shape)}")
        t.data = saved[name].to(device=t.device)


class DnaLLM:
    """DNA-encoder + LLM fusion model (reference `DNALLMModel`).

    Usage:
        model = DnaLLM(FusionConfig(...), device="cpu")     # CUDA by default
        batch = model.prepare_inputs(texts, batch_dna_sequences)
        logits, loss = model(**batch, labels=labels)
        completions = model.generate_text(prompts, batch_dna_sequences)
    """

    def __init__(self, cfg: Optional[FusionConfig] = None, text_tokenizer=None,
                 dna_tokenizer=None, model: Optional[torch.nn.Module] = None, seed: int = 0,
                 device=None):
        self.text_tokenizer = text_tokenizer or ByteTextTokenizer()
        if dna_tokenizer is None:
            dna_tokenizer = (CharDNATokenizer() if (cfg and cfg.encoder_kind == "evo2")
                             else KmerTokenizer())
        self.dna_tokenizer = dna_tokenizer
        if cfg is None:
            cfg = FusionConfig(dna_pad_token_id=self.text_tokenizer.dna_pad_id)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.processor = BioProcessor(self.text_tokenizer, self.dna_tokenizer)
        self.model = (model.to(self.device) if model is not None
                      else init_fusion(cfg, seed=seed, device=self.device))
        from bioreason_tpu_torch.generate.engine import GenerationEngine
        self.engine = GenerationEngine(cfg, eos_token_id=self.text_tokenizer.eos_token_id,
                                       device=self.device)

    # -- data ---------------------------------------------------------------

    def prepare_inputs(self, texts: Sequence[str],
                       batch_dna_sequences: Optional[Sequence[Sequence[str]]] = None,
                       **kw) -> Dict[str, Any]:
        """The processor's numpy arrays, the DNA splice checked."""
        out = self.processor(text=list(texts), batch_dna_sequences=batch_dna_sequences,
                             max_length_text=self.cfg.max_length_text,
                             max_length_dna=self.cfg.max_length_dna, **kw)
        validate_splice(out.input_ids, out.dna_input_ids, self.cfg.dna_pad_token_id)
        return {"input_ids": out.input_ids, "attention_mask": out.attention_mask,
                "dna_input_ids": out.dna_input_ids,
                "dna_attention_mask": out.dna_attention_mask}

    def _put(self, x):
        return None if x is None else torch.as_tensor(np.asarray(x), device=self.device)

    # -- compute ------------------------------------------------------------

    def __call__(self, input_ids, attention_mask, dna_input_ids=None, dna_attention_mask=None,
                 labels=None, model=None):
        """(logits [B, T, V] fp32, None) without labels; (None, loss) with
        them (`fusion_forward`: the head then runs vocab-chunked)."""
        return fusion_forward(model if model is not None else self.model, self.cfg,
                              *(self._put(x) for x in (input_ids, attention_mask,
                                                       dna_input_ids, dna_attention_mask)),
                              labels=self._put(labels))

    forward = __call__

    def generate(self, input_ids, attention_mask, dna_input_ids=None, dna_attention_mask=None,
                 sampling: SamplingConfig = SamplingConfig(),
                 max_new_tokens: Optional[int] = None, greedy: bool = False,
                 generator: Optional[torch.Generator] = None,
                 model=None) -> Tuple[np.ndarray, np.ndarray]:
        """Returns COMPLETION ids and their mask only, like the reference
        generate path (dna_llm.py:298-305)."""
        return self.engine.generate(model if model is not None else self.model, input_ids,
                                    attention_mask, dna_input_ids, dna_attention_mask,
                                    sampling=sampling, max_new_tokens=max_new_tokens,
                                    greedy=greedy, generator=generator)

    def generate_text(self, texts: Sequence[str],
                      batch_dna_sequences: Optional[Sequence[Sequence[str]]] = None,
                      skip_special_tokens: bool = True, **kw) -> List[str]:
        batch = self.prepare_inputs(texts, batch_dna_sequences)
        ids, mask = self.generate(**batch, **kw)
        return self.text_tokenizer.batch_decode(
            [row[m.astype(bool)] for row, m in zip(ids, mask)],
            skip_special_tokens=skip_special_tokens)

    # -- persistence --------------------------------------------------------

    def save(self, path: str, step: int = 0, stage: str = "sft") -> str:
        return _save_module(self.model, path, step, {"stage": stage})

    def load(self, path: str) -> "DnaLLM":
        _load_module(self.model, path)
        return self


class DNAClassifier:
    """DNA-only classifier (reference `DNAClassifierModel`)."""

    def __init__(self, cfg: Optional[EncoderConfig] = None, num_classes: int = 2,
                 dna_tokenizer=None, model: Optional[torch.nn.Module] = None, seed: int = 0,
                 device=None):
        self.cfg = cfg or EncoderConfig()
        self.num_classes = num_classes
        self.dna_tokenizer = dna_tokenizer or KmerTokenizer()
        self.device = resolve_device(device)
        self.model = (model.to(self.device) if model is not None
                      else init_classifier(self.cfg, num_classes, seed=seed, device=self.device))

    @torch.no_grad()
    def __call__(self, ref_ids, alt_ids, ref_attention_mask, alt_attention_mask, model=None):
        put = lambda x: torch.as_tensor(np.asarray(x), device=self.device)
        return classifier_forward(model if model is not None else self.model, self.cfg,
                                  put(ref_ids), put(alt_ids), put(ref_attention_mask),
                                  put(alt_attention_mask))

    def predict(self, ref_sequences: Sequence[str], alt_sequences: Sequence[str],
                max_length: int = 2048) -> np.ndarray:
        t_ref = self.dna_tokenizer(list(ref_sequences), max_length=max_length)
        t_alt = self.dna_tokenizer(list(alt_sequences), max_length=max_length,
                                   pad_to=t_ref["input_ids"].shape[1])
        # pad ref to alt width too if alt came out wider
        if t_alt["input_ids"].shape[1] > t_ref["input_ids"].shape[1]:
            t_ref = self.dna_tokenizer(list(ref_sequences), max_length=max_length,
                                       pad_to=t_alt["input_ids"].shape[1])
        logits = self(t_ref["input_ids"], t_alt["input_ids"],
                      t_ref["attention_mask"], t_alt["attention_mask"])
        return logits.argmax(-1).cpu().numpy()
