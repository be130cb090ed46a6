"""DNA-LLM fusion model: encoder -> projection -> splice -> decoder (the
port of bioreason_tpu/models/fusion.py; reference DNALLMModel,
dna_llm.py:18-305).

The splice replaces each `<|dna_pad|>` placeholder of the text embeddings
with the next valid DNA embedding, both taken in flat row-major order, with
a cumsum-scatter and a gather over static shapes (no host loop): the k-th
valid DNA token overall matches the k-th placeholder overall, because the
processor flattens DNA sequences batch-major.
"""

from __future__ import annotations

import torch
from torch import nn

from bioreason_tpu_torch.config import FusionConfig
from bioreason_tpu_torch.models import layers as L
from bioreason_tpu_torch.models.nt_encoder import NTEncoder, encoder_forward
from bioreason_tpu_torch.models.qwen3 import Qwen3Decoder
from bioreason_tpu_torch.utils.devices import resolve_device, torch_dtype


class FusionModel(nn.Module):
    """Encoder, decoder and the DNA projection (nn.Linear with bias,
    reference dna_llm.py:97)."""

    def __init__(self, cfg: FusionConfig, device=None):
        super().__init__()
        self.encoder = NTEncoder(cfg.encoder, device, torch_dtype(cfg.encoder.dtype))
        self.decoder = Qwen3Decoder(cfg.decoder, device, torch_dtype(cfg.decoder.dtype))
        self.dna_projection = L.linear(cfg.encoder.hidden_size, cfg.decoder.hidden_size,
                                       True, device, torch_dtype(cfg.decoder.dtype))


def init_fusion(cfg: FusionConfig, seed: int = 0, device=None) -> FusionModel:
    """Random weights drawn from a `torch.Generator` seeded with `seed`, with
    the distributions of the JAX init (layers.py:17-28,126-127,165-166,
    fusion.py:39-57), stored in each tower's dtype."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return L.init_normal_(FusionModel(cfg, device), gen)


def encode_dna(model: FusionModel, cfg: FusionConfig, dna_input_ids,
               dna_attention_mask) -> torch.Tensor:
    """DNA tower -> projected embeddings [S, Ld, H_text] (decoder dtype)."""
    hidden = encoder_forward(model.encoder, cfg.encoder, dna_input_ids, dna_attention_mask)
    return L.dense(model.dna_projection, hidden)


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


def fused_input_embeddings(model: FusionModel, cfg: FusionConfig, input_ids,
                           dna_input_ids=None, dna_attention_mask=None) -> torch.Tensor:
    """Text embedding lookup + DNA splice (reference dna_llm.py:211-229).
    Uses the row-local splice when the DNA batch is a multiple of the text
    batch, the batch-global one otherwise."""
    embeds = L.embed(model.decoder.embed, input_ids)
    if dna_input_ids is not None:
        dna = encode_dna(model, cfg, dna_input_ids, dna_attention_mask)
        b, s = input_ids.shape[0], dna_input_ids.shape[0]
        if s % b == 0 and s >= b:
            embeds = splice_embeddings_per_item(embeds, input_ids, dna, dna_attention_mask,
                                                cfg.dna_pad_token_id, s // b)
        else:
            embeds = splice_embeddings(embeds, input_ids, dna, dna_attention_mask,
                                       cfg.dna_pad_token_id)
    return embeds
