"""DNA-only variant classifier (the port of bioreason_tpu/models/classifier.py;
reference bioreason/models/dna_only.py).

Encoder -> learned-query attention pooling -> MLP over concat(ref, alt).
Ref and alt run through the NT encoder as two dense batches, so on the card
each batch launches `flash_fwd` in every encoder layer
(`attention(impl="auto")`); the pool is a one-query attention that the JAX
package computes as XLA einsums, and stays plain torch here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bioreason_tpu_torch.config import EncoderConfig
from bioreason_tpu_torch.models import layers as L
from bioreason_tpu_torch.models.nt_encoder import NTEncoder, encoder_forward
from bioreason_tpu_torch.utils.devices import resolve_device, torch_dtype

_NEG = torch.finfo(torch.float32).min


class Pooler(nn.Module):
    """A learnable query [1, 1, d] and its q / k / v / o projections."""

    def __init__(self, d: int, device=None):
        super().__init__()
        self.query = nn.Parameter(torch.empty((1, 1, d), device=device))
        self.q = L.linear(d, d, False, device)
        self.k = L.linear(d, d, False, device)
        self.v = L.linear(d, d, False, device)
        self.o = L.linear(d, d, False, device)


class Head(nn.Module):
    """fc1 2d -> d with bias, ReLU, fc2 d -> C with bias."""

    def __init__(self, d: int, num_classes: int, device=None):
        super().__init__()
        self.fc1 = L.linear(2 * d, d, True, device)
        self.fc2 = L.linear(d, num_classes, True, device)


class DnaClassifier(nn.Module):
    """Parameters of the classifier (fp32; the trainer stores a frozen
    encoder in the compute dtype); `classifier_forward` runs it."""

    def __init__(self, cfg: EncoderConfig, num_classes: int = 2, device=None):
        super().__init__()
        self.encoder = NTEncoder(cfg, device, torch.float32)
        self.pooler = Pooler(cfg.hidden_size, device)
        self.classifier = Head(cfg.hidden_size, num_classes, device)


def init_classifier(cfg: EncoderConfig, num_classes: int = 2, seed: int = 0,
                    device=None) -> DnaClassifier:
    """Random weights drawn from a `torch.Generator` seeded with `seed`, with
    the distributions of the JAX init (classifier.py:21-38): dense kernels
    N(0, 1/in) and zero biases, embeddings N(0, 0.02^2), the query N(0, 1)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = L.init_normal_(DnaClassifier(cfg, num_classes, device), gen)
    with torch.no_grad():
        L._normal_(model.pooler.query, 1.0, gen)
    return model


def attention_pool(pool: Pooler, h: torch.Tensor, mask: torch.Tensor,
                   num_heads: int = 8) -> torch.Tensor:
    """Learned-query multi-head attention pooling (JAX classifier.py:41-58).
    h [B, T, D], mask [B, T] -> [B, D] in h's dtype. Logits in fp32 scaled by
    hd^-0.5, masked keys at the fp32 minimum, probabilities cast to h's
    dtype for the value product."""
    b, t, d = h.shape
    nh = num_heads if d % num_heads == 0 else 1
    hd = d // nh
    dtype = h.dtype
    q = L.dense(pool.q, pool.query, dtype).reshape(1, 1, nh, hd).expand(b, 1, nh, hd)
    k = L.dense(pool.k, h, dtype).reshape(b, t, nh, hd)
    v = L.dense(pool.v, h, dtype).reshape(b, t, nh, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (hd ** -0.5)
    logits = logits.masked_fill(~mask.bool()[:, None, None, :], _NEG)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, 1, d)
    return L.dense(pool.o, ctx, dtype)[:, 0]


def classifier_forward(model: DnaClassifier, cfg: EncoderConfig, ref_ids, alt_ids,
                       ref_attention_mask, alt_attention_mask,
                       train_encoder: bool = False) -> torch.Tensor:
    """Classification logits [B, num_classes] in fp32. Unless
    `train_encoder`, the encoder runs without autograd (the JAX
    stop_gradient, classifier.py:70-71). No dropout: the JAX function's
    `dropout_rng` (keep 0.9 after the ReLU) is never passed by its trainer
    (ROADMAP 3, note 12), so no caller drops anything."""
    dtype = torch_dtype(cfg.dtype)

    def enc(ids, mask):
        with torch.set_grad_enabled(train_encoder and torch.is_grad_enabled()):
            h = encoder_forward(model.encoder, cfg, ids, mask)
        return attention_pool(model.pooler, h, mask)

    combined = torch.cat([enc(ref_ids, ref_attention_mask),
                          enc(alt_ids, alt_attention_mask)], dim=-1)
    x = F.relu(L.dense(model.classifier.fc1, combined, dtype))
    return L.dense(model.classifier.fc2, x, dtype).float()
