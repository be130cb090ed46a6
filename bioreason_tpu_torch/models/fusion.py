"""DNA-LLM fusion model: encoder -> projection -> splice -> decoder (the
port of bioreason_tpu/models/fusion.py; reference DNALLMModel,
dna_llm.py:18-305).

The splice replaces each `<|dna_pad|>` placeholder of the text embeddings
with the next valid DNA embedding, both taken in flat row-major order, with
a cumsum-scatter and a gather over static shapes (no host loop): the k-th
valid DNA token overall matches the k-th placeholder overall, because the
processor flattens DNA sequences batch-major.

`fusion_forward` is the training forward: with labels (or their gathered
supervised positions) it returns the vocab-chunked CE (ops/fused_ce.py) on
the final hidden states, and the [B, T, V] logits never exist.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from bioreason_tpu_torch.config import FusionConfig
from bioreason_tpu_torch.models import layers as L
from bioreason_tpu_torch.models.evo2 import HyenaTower, hyena_forward, init_filters_
from bioreason_tpu_torch.models.nt_encoder import NTEncoder, encoder_forward
from bioreason_tpu_torch.models.qwen3 import Qwen3Decoder, decoder_forward
from bioreason_tpu_torch.ops import fused_ce as CE
from bioreason_tpu_torch.utils.devices import resolve_device, torch_dtype


class FusionModel(nn.Module):
    """The DNA tower that `cfg.encoder_kind` names (an `NTEncoder`, or the
    Evo2 `HyenaTower` for 'evo2'), the decoder and the DNA projection
    (nn.Linear with bias, reference dna_llm.py:97) from the tower's width.
    The projection is always trained, so it is stored as an fp32 master and
    cast to the decoder dtype on every call."""

    def __init__(self, cfg: FusionConfig, device=None):
        super().__init__()
        tower = cfg.dna_tower
        kind = HyenaTower if cfg.encoder_kind == "evo2" else NTEncoder
        self.encoder = kind(tower, device, torch_dtype(tower.dtype))
        self.decoder = Qwen3Decoder(cfg.decoder, device, torch_dtype(cfg.decoder.dtype))
        self.dna_projection = L.linear(tower.hidden_size, cfg.decoder.hidden_size,
                                       True, device, torch.float32)


def init_fusion(cfg: FusionConfig, seed: int = 0, device=None) -> FusionModel:
    """Random weights drawn from a `torch.Generator` seeded with `seed`, with
    the distributions of the JAX init (layers.py:17-28,126-127,165-166,
    fusion.py:39-57, evo2.py:146-195), stored in each tower's dtype."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = L.init_normal_(FusionModel(cfg, device), gen)
    if cfg.encoder_kind == "evo2":
        init_filters_(model.encoder, gen)
    return model


def encode_dna(model: FusionModel, cfg: FusionConfig, dna_input_ids,
               dna_attention_mask, train_encoder: bool = False) -> torch.Tensor:
    """DNA tower -> projected embeddings [S, Ld, H_text] (decoder dtype).
    Unless `train_encoder`, the tower runs without autograd (the JAX
    stop_gradient): no activation of it is kept for a backward."""
    with torch.set_grad_enabled(train_encoder and torch.is_grad_enabled()):
        if cfg.encoder_kind == "evo2":
            hidden = hyena_forward(model.encoder, cfg.hyena, dna_input_ids,
                                   dna_attention_mask)
        else:
            hidden = encoder_forward(model.encoder, cfg.encoder, dna_input_ids,
                                     dna_attention_mask)
    return L.dense(model.dna_projection, hidden, torch_dtype(cfg.decoder.dtype))


def splice_embeddings(text_embeds, input_ids, dna_embeds, dna_mask,
                      dna_pad_token_id: int) -> torch.Tensor:
    """Batch-global splice. text_embeds [B,T,H], input_ids [B,T],
    dna_embeds [S,Ld,H], dna_mask [S,Ld]."""
    b, t, h = text_embeds.shape
    s, ld, _ = dna_embeds.shape
    total = s * ld
    flat_mask = dna_mask.reshape(-1).long()
    order = flat_mask.cumsum(0) - 1                               # rank among valid
    scatter_idx = torch.where(flat_mask > 0, order, total)        # invalid -> dump row
    dna_flat = dna_embeds.new_zeros((total + 1, h))
    dna_flat.index_copy_(0, scatter_idx[flat_mask > 0], dna_embeds.reshape(total, h)[flat_mask > 0])
    text_mask = (input_ids == dna_pad_token_id).reshape(-1)
    gather_idx = (text_mask.long().cumsum(0) - 1).clamp(0, total - 1)
    replacement = dna_flat[gather_idx].reshape(b, t, h).to(text_embeds.dtype)
    return torch.where(text_mask.reshape(b, t, 1), replacement, text_embeds)


def splice_embeddings_per_item(text_embeds, input_ids, dna_embeds, dna_mask,
                               dna_pad_token_id: int, per_item: int) -> torch.Tensor:
    """Row-local splice for a fixed number of DNA sequences per batch item
    (2 for KEGG). dna_embeds [B*per_item, Ld, H], batch-major."""
    b, t, h = text_embeds.shape
    ld = dna_embeds.shape[1]
    total = per_item * ld
    dna_b = dna_embeds.reshape(b, total, h)
    mask_b = dna_mask.reshape(b, total).long()
    order = mask_b.cumsum(1) - 1
    scatter_idx = torch.where(mask_b > 0, order, total)           # invalid -> dump row
    flat = dna_b.new_zeros((b, total + 1, h))
    # several invalid entries may land on the dump row; it is dropped below
    flat.scatter_(1, scatter_idx[..., None].expand(b, total, h), dna_b)
    flat = flat[:, :total]
    text_mask = input_ids == dna_pad_token_id
    gather_idx = (text_mask.long().cumsum(1) - 1).clamp(0, total - 1)
    replacement = flat.gather(1, gather_idx[..., None].expand(b, t, h))
    return torch.where(text_mask[..., None], replacement.to(text_embeds.dtype), text_embeds)


def validate_splice(input_ids, dna_input_ids, dna_pad_token_id: int,
                    dna_tokenizer_pad_id: int = 1) -> None:
    """Host-side strict count check (reference dna_llm.py:222-225): as many
    `<|dna_pad|>` placeholders as non-pad DNA tokens."""
    if dna_input_ids is None:
        return
    n_tokens = int((np.asarray(input_ids) == dna_pad_token_id).sum())
    n_features = int((np.asarray(dna_input_ids) != dna_tokenizer_pad_id).sum())
    if n_features != n_tokens:
        raise ValueError(f"DNA features and DNA tokens do not match: features "
                         f"{n_features}, tokens: {n_tokens}")


def fused_input_embeddings(model: FusionModel, cfg: FusionConfig, input_ids,
                           dna_input_ids=None, dna_attention_mask=None,
                           train_encoder: bool = False) -> torch.Tensor:
    """Text embedding lookup + DNA splice (reference dna_llm.py:211-229).
    Uses the row-local splice when the DNA batch is a multiple of the text
    batch, the batch-global one otherwise."""
    embeds = L.embed(model.decoder.embed, input_ids, torch_dtype(cfg.decoder.dtype))
    if dna_input_ids is not None:
        dna = encode_dna(model, cfg, dna_input_ids, dna_attention_mask, train_encoder)
        b, s = input_ids.shape[0], dna_input_ids.shape[0]
        if s % b == 0 and s >= b:
            embeds = splice_embeddings_per_item(embeds, input_ids, dna, dna_attention_mask,
                                                cfg.dna_pad_token_id, s // b)
        else:
            embeds = splice_embeddings(embeds, input_ids, dna, dna_attention_mask,
                                       cfg.dna_pad_token_id)
    return embeds


def fusion_forward(
    model: FusionModel,
    cfg: FusionConfig,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    dna_input_ids: Optional[torch.Tensor] = None,
    dna_attention_mask: Optional[torch.Tensor] = None,
    labels: Optional[torch.Tensor] = None,
    train_encoder: bool = False,
    train_embeddings: bool = False,
    lora_dropout_gen: Optional[torch.Generator] = None,
    lora_dropout_rate: float = 0.0,
    label_positions: Optional[torch.Tensor] = None,
    label_targets: Optional[torch.Tensor] = None,
    label_valid: Optional[torch.Tensor] = None,
    focal_gamma: float = 0.0,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Fused forward. Returns (logits, loss or None).

    With `labels`, the loss is the vocab-chunked CE on the final hidden
    states and `logits` is None. With `label_positions/targets/valid` (from
    fused_ce.gather_label_positions) instead, the head runs only on the
    supervised positions, at the same loss. `focal_gamma` > 0 weighs the CE
    by the detached (1 - p)^gamma. Without either, returns fp32 logits."""
    embeds = fused_input_embeddings(model, cfg, input_ids, dna_input_ids,
                                    dna_attention_mask, train_encoder)
    gathered = label_positions is not None
    if labels is None and not gathered:
        logits, _ = decoder_forward(model.decoder, cfg.decoder, inputs_embeds=embeds,
                                    attention_mask=attention_mask)
        return logits, None

    hidden, _ = decoder_forward(model.decoder, cfg.decoder, inputs_embeds=embeds,
                                attention_mask=attention_mask, return_hidden=True,
                                lora_dropout_gen=lora_dropout_gen,
                                lora_dropout_rate=lora_dropout_rate)
    dec = model.decoder
    head = dec.lm_head.weight if dec.lm_head is not None else dec.embed.weight   # [V, H]
    h = hidden.to(torch.bfloat16) if cfg.decoder.dtype == "bfloat16" else hidden
    if focal_gamma > 0.0:
        if gathered:
            loss = CE.decoder_lm_loss_focal_gathered(
                h, head, label_positions, label_targets, label_valid, focal_gamma,
                need_embedding_grad=train_embeddings)
        else:
            loss = CE.decoder_lm_loss_focal(h, head, labels, focal_gamma,
                                            need_embedding_grad=train_embeddings)
    elif gathered:
        loss = CE.decoder_lm_loss_gathered(h, head, label_positions, label_targets,
                                           label_valid, need_embedding_grad=train_embeddings,
                                           save_logits=cfg.ce_save_logits)
    else:
        loss = CE.decoder_lm_loss(h, head, labels, need_embedding_grad=train_embeddings,
                                  save_logits=cfg.ce_save_logits)
    return None, loss
