"""Vocab-chunked cross-entropy: the [N, V] logits never exist in memory at
once (the port of bioreason_tpu/ops/fused_ce.py).

The head product and the log-sum-exp run chunk by chunk over the vocabulary
(8192 rows of the head at a time) with an online (max, sum-exp, gold)
accumulator, so peak memory is [N, chunk] instead of [N, V]. The backward
recomputes each chunk's logits from the saved (hidden, lse) and feeds
dlogits = softmax - onehot straight into the two products, so the softmax is
never stored either. Chunk logits come out in fp32 from bf16 operands
(`layers.mm_f32`, the JAX dot with preferred_element_type=float32).

Vocab-parallel (`vocab_axis`, the mesh's 'model' axis when the head's
rows are split over it, parallel/partition.py): `embedding` holds this
rank's V/m rows and the targets are global ids. Each rank runs the chunks
of its own rows; one all-gather of every rank's (max, sum-exp, gold)
combines them into the global LSE (exactly one rank holds each target, the
others add zero), so the [N, V] logits exist on no rank and the forward
reduces once per call. The backward's probabilities use that global LSE,
the head's gradient is local, and the hidden's is a partial sum over the
axis, summed once by the `comm.copy_to` the hidden passes through.

The JAX package computes these products with `jnp.dot` outside any Pallas
kernel, so here they are `torch.mm`; a hand kernel for the CE is queued
(ROADMAP.md, section 2.3).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from bioreason_tpu_torch.models.layers import mm_f32
from bioreason_tpu_torch.parallel import comm

DEFAULT_CHUNK = 8192


def _chunks(v: int, chunk: int):
    return [(c0, min(c0 + chunk, v)) for c0 in range(0, v, chunk)]


def _operands(hidden, embedding):
    """Both operands in one dtype: a bf16 hidden against an fp32 head (a
    trained embedding) promotes to fp32, as the JAX dot does."""
    dt = torch.promote_types(hidden.dtype, embedding.dtype)
    return hidden.to(dt), embedding.to(dt)


def _first_row(emb, axis) -> int:
    """The vocabulary id of this rank's first head row (0 without an axis)."""
    return 0 if axis is None else axis.index * emb.shape[0]


def _lse_and_gold(h, emb, targets, chunk, keep_logits: bool = False, axis=None):
    """h [N,H], emb [V,H] (this rank's V/m rows over `axis`), targets [N]
    -> (lse [N], gold [N] fp32, both over the whole vocabulary, and with
    `keep_logits` the bf16 chunk logits shifted by the running row max at
    that chunk plus those fp32 maxes)."""
    n = h.shape[0]
    targets = targets - _first_row(emb, axis)
    m = torch.full((n,), -torch.inf, dtype=torch.float32, device=h.device)
    s = torch.zeros((n,), dtype=torch.float32, device=h.device)
    gold = torch.zeros((n,), dtype=torch.float32, device=h.device)
    shifted: List[torch.Tensor] = []
    shifts: List[torch.Tensor] = []
    for c0, c1 in _chunks(emb.shape[0], chunk):
        logits = mm_f32(h, emb[c0:c1].t())                         # [N, c]
        m_new = torch.maximum(m, logits.amax(-1))
        s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(-1)
        local = targets - c0
        in_chunk = (local >= 0) & (local < c1 - c0)
        g = logits.gather(1, local.clamp(0, c1 - c0 - 1)[:, None])[:, 0]
        gold = torch.where(in_chunk, g, gold)
        if keep_logits:
            shifted.append((logits - m_new[:, None]).to(torch.bfloat16))
            shifts.append(m_new)
        m = m_new
    if axis is not None:
        m, s, gold = _combine(m, s, gold, axis)
    return m + torch.log(s), gold, shifted, shifts


def _combine(m, s, gold, axis):
    """The whole vocabulary's row max, sum of exp(logit - max) and gold
    logit from every rank's over its own rows: one all-gather."""
    ms, ss, golds = comm.all_gather(torch.stack([m, s, gold])[None], axis, 0).unbind(1)
    mx = ms.amax(0)
    return mx, (ss * torch.exp(ms - mx)).sum(0), golds.sum(0)


def _backward_chunks(h, emb, lse, chunk, dlogits_of, need_embedding_grad,
                     shifted=None, shifts=None, axis=None):
    """Sum over chunks of dlogits @ W (and dlogits^T @ h for the head),
    with dlogits_of(probs, c0, c1) giving the dlogits [N, c] of vocabulary
    ids c0..c1 (this rank's rows over `axis`: dh is then its partial
    sum)."""
    v0 = _first_row(emb, axis)
    dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    demb = (torch.zeros(emb.shape, dtype=torch.float32, device=h.device)
            if need_embedding_grad else None)
    for ci, (c0, c1) in enumerate(_chunks(emb.shape[0], chunk)):
        w = emb[c0:c1]
        if shifted is not None:
            logits = shifted[ci].float() + shifts[ci][:, None]
        else:
            logits = mm_f32(h, w.t())
        probs = torch.exp(logits - lse[:, None])
        dlogits = dlogits_of(probs, v0 + c0, v0 + c1)              # [N, c] fp32
        if need_embedding_grad:
            demb[c0:c1] = dlogits.t() @ h.float()
        dh += dlogits @ w.float()
    return dh, demb


class _FusedSoftmaxXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, embedding, targets, ignore_index, chunk,
                need_embedding_grad, save_logits, axis):
        h, emb = _operands(hidden, embedding)
        valid = targets != ignore_index
        safe_t = torch.where(valid, targets, 0)
        lse, gold, shifted, shifts = _lse_and_gold(h, emb, safe_t, chunk, save_logits, axis)
        denom = valid.sum().clamp(min=1)
        loss = ((lse - gold) * valid).sum() / denom
        ctx.save_for_backward(hidden, embedding, safe_t, valid, lse, denom,
                              *shifted, *shifts)
        ctx.chunk, ctx.need_embedding_grad, ctx.axis = chunk, need_embedding_grad, axis
        ctx.n_saved = len(shifted)
        return loss

    @staticmethod
    def backward(ctx, g):
        hidden, embedding, safe_t, valid, lse, denom, *saved = ctx.saved_tensors
        k = ctx.n_saved
        shifted, shifts = (saved[:k], saved[k:]) if k else (None, None)
        h, emb = _operands(hidden, embedding)
        scale = (g / denom) * valid                                # [N]

        def dlogits_of(probs, c0, c1):
            col = torch.arange(c0, c1, device=probs.device)
            onehot = (col[None, :] == safe_t[:, None]).float()
            return (probs - onehot) * scale[:, None]
        dh, demb = _backward_chunks(h, emb, lse, ctx.chunk, dlogits_of,
                                    ctx.need_embedding_grad, shifted, shifts, ctx.axis)
        demb = None if demb is None else demb.to(embedding.dtype)
        return dh.to(hidden.dtype), demb, None, None, None, None, None, None


def _vocab_split(hidden, vocab_axis):
    """hidden through `comm.copy_to` when the head is split over
    `vocab_axis`: its gradient, a partial sum on each rank, is summed over
    the axis once."""
    return hidden if vocab_axis is None else comm.copy_to(hidden, vocab_axis)


def fused_softmax_xent(hidden, embedding, targets, ignore_index: int = -100,
                       chunk: int = DEFAULT_CHUNK, need_embedding_grad: bool = False,
                       save_logits: bool = False, vocab_axis=None):
    """Mean CE over valid targets. hidden [N,H], embedding [V,H] (the head,
    nn.Linear layout), targets [N] with ignore_index holes. With
    need_embedding_grad=False (a frozen head: LoRA runs) the backward
    returns no head gradient and skips its [V,H] accumulator.
    `save_logits=True` keeps the max-shifted chunk logits in bf16 so the
    backward skips the recompute product. `vocab_axis`: `embedding` holds
    this rank's rows of a head split over that axis (module docstring)."""
    return _FusedSoftmaxXent.apply(_vocab_split(hidden, vocab_axis), embedding, targets,
                                   ignore_index, chunk, need_embedding_grad, save_logits,
                                   vocab_axis)


class _ChunkedTokenLogps(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, embedding, targets, chunk, need_embedding_grad, axis):
        h, emb = _operands(hidden, embedding)
        lse, gold, _, _ = _lse_and_gold(h, emb, targets, chunk, axis=axis)
        ctx.save_for_backward(hidden, embedding, targets, lse)
        ctx.chunk, ctx.need_embedding_grad, ctx.axis = chunk, need_embedding_grad, axis
        return gold - lse

    @staticmethod
    def backward(ctx, g):
        hidden, embedding, targets, lse = ctx.saved_tensors
        h, emb = _operands(hidden, embedding)

        def dlogits_of(probs, c0, c1):
            col = torch.arange(c0, c1, device=probs.device)
            onehot = (col[None, :] == targets[:, None]).float()
            return (onehot - probs) * g[:, None]
        dh, demb = _backward_chunks(h, emb, lse, ctx.chunk, dlogits_of,
                                    ctx.need_embedding_grad, axis=ctx.axis)
        demb = None if demb is None else demb.to(embedding.dtype)
        return dh.to(hidden.dtype), demb, None, None, None, None


def chunked_token_logps(hidden, embedding, targets, chunk: int = DEFAULT_CHUNK,
                        need_embedding_grad: bool = False, vocab_axis=None):
    """Per-token log p(target) [N] without the [N, V] logits (the GRPO
    per-token logp primitive); `vocab_axis` as in `fused_softmax_xent`."""
    return _ChunkedTokenLogps.apply(_vocab_split(hidden, vocab_axis), embedding, targets,
                                    chunk, need_embedding_grad, vocab_axis)


def decoder_lm_loss(hidden, embedding, labels, ignore_index: int = -100,
                    chunk: int = DEFAULT_CHUNK, need_embedding_grad: bool = False,
                    save_logits: bool = False, vocab_axis=None):
    """Shifted causal LM loss on final-norm hidden states [B,T,H]: hidden t
    predicts label t+1 (mean over supervised tokens), without the [B,T,V]
    logits."""
    hdim = hidden.shape[-1]
    h = hidden[:, :-1].reshape(-1, hdim)
    y = labels[:, 1:].reshape(-1)
    return fused_softmax_xent(h, embedding, y, ignore_index, chunk,
                              need_embedding_grad, save_logits, vocab_axis)


def gather_label_positions(labels, bucket: int = 64):
    """Host side: compress [B,T] labels to the supervised positions only.

    Returns (positions [B,K], targets [B,K], valid [B,K]) int32, where a
    position indexes the hidden state PREDICTING its target (t for label
    t+1) and K is the largest row count rounded up to `bucket`. The loss of
    `decoder_lm_loss_gathered` equals `decoder_lm_loss`'s at ~K/T of the
    head's work."""
    labels = np.asarray(labels)
    shifted = labels[:, 1:]
    valid_bt = shifted != -100
    counts = valid_bt.sum(axis=1)
    k = max(int(counts.max()), 1)
    k = ((k + bucket - 1) // bucket) * bucket
    b = labels.shape[0]
    positions = np.zeros((b, k), np.int32)
    targets = np.zeros((b, k), np.int32)
    valid = np.zeros((b, k), np.int32)
    for i in range(b):
        idx = np.nonzero(valid_bt[i])[0]
        positions[i, :len(idx)] = idx
        targets[i, :len(idx)] = shifted[i, idx]
        valid[i, :len(idx)] = 1
    return positions, targets, valid


def _gather_rows(hidden, positions):
    """hidden [B,T,H] at positions [B,K] -> [B*K, H]."""
    hdim = hidden.shape[-1]
    idx = positions.long()[..., None].expand(*positions.shape, hdim)
    return hidden.gather(1, idx).reshape(-1, hdim)


def decoder_lm_loss_gathered(hidden, embedding, positions, targets, valid,
                             chunk: int = DEFAULT_CHUNK, need_embedding_grad: bool = False,
                             save_logits: bool = False, vocab_axis=None):
    """Shifted causal LM loss over pre-gathered supervised positions (see
    gather_label_positions); the same mean over valid targets."""
    y = torch.where(valid.bool(), targets.long(), -100)
    return fused_softmax_xent(_gather_rows(hidden, positions), embedding, y.reshape(-1),
                              -100, chunk, need_embedding_grad, save_logits, vocab_axis)


def _focal_weighted_mean(logps, valid, gamma: float, axis=None):
    """loss = sum(w * CE) / sum(w) with detached weights w = (1 - p)^gamma:
    fitted tokens contribute ~nothing, so the step concentrates on unfit
    ones; gamma = 0 is the mean CE. `axis` (a `parallel.comm.Axis`): the
    rows are this rank's share of a batch split over it, and sum(w) is
    summed over the axis (no gradient, as w has none), so the ranks'
    losses add up to the whole batch's."""
    ce = -logps
    p = torch.exp(torch.clamp(logps, max=0.0))
    w = ((1.0 - p) ** gamma).detach() * valid
    total = w.sum()
    if axis is not None:
        total = comm.all_reduce(total, axis)
    return (w * ce).sum() / torch.clamp(total, min=1e-6)


def decoder_lm_loss_focal(hidden, embedding, labels, gamma: float,
                          ignore_index: int = -100, chunk: int = DEFAULT_CHUNK,
                          need_embedding_grad: bool = False, axis=None, vocab_axis=None):
    """Focal-weighted variant of decoder_lm_loss (same shift semantics);
    `axis` splits the rows (`_focal_weighted_mean`), `vocab_axis` the head."""
    hdim = hidden.shape[-1]
    h = hidden[:, :-1].reshape(-1, hdim)
    y = labels[:, 1:].reshape(-1)
    valid = (y != ignore_index).float()
    logps = chunked_token_logps(h, embedding, torch.where(y == ignore_index, 0, y),
                                chunk, need_embedding_grad, vocab_axis)
    return _focal_weighted_mean(logps, valid, gamma, axis)


def decoder_lm_loss_focal_gathered(hidden, embedding, positions, targets, valid,
                                   gamma: float, chunk: int = DEFAULT_CHUNK,
                                   need_embedding_grad: bool = False, axis=None,
                                   vocab_axis=None):
    """Focal-weighted variant of decoder_lm_loss_gathered."""
    logps = chunked_token_logps(_gather_rows(hidden, positions), embedding,
                                targets.reshape(-1).long(), chunk, need_embedding_grad,
                                vocab_axis)
    return _focal_weighted_mean(logps, valid.reshape(-1).float(), gamma, axis)

