"""Token sampling: temperature / top-k / top-p (the port of
bioreason_tpu/ops/sampling.py).

Reference sampling parameters: temperature 0.6, top_p 0.95, top_k 20
(grpo_config.py:192-209, train_dna_qwen.py:284-289). Draws come from an
explicit `torch.Generator`; they differ from `jax.random`'s, so tests compare
greedy ids and the kept top-k/top-p set, never sampled tokens.
"""

from __future__ import annotations

from typing import Optional

import torch


def top_k_top_p_filter(logits: torch.Tensor, temperature: float = 1.0,
                       top_k: int = 0, top_p: float = 1.0):
    """logits [B, V] -> (vals [B, k] with dropped entries at -inf, idx [B, k]),
    sorted by descending logit.

    The selection is exact `torch.topk` where the JAX package uses
    `jax.lax.approx_max_k` (a TPU-specific partial reduction with recall
    0.99): on the GPU an exact top-k over the vocab costs little."""
    logits = logits.float() / temperature
    v = logits.shape[-1]
    k = min(top_k if (top_k and top_k > 0) else v, v)
    vals, idx = torch.topk(logits, k, dim=-1)                     # sorted desc
    if top_p < 1.0:
        probs = torch.softmax(vals, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens whose cumulative mass before them is < top_p (always
        # keeps the first token)
        keep = (cum - probs) < top_p
        vals = vals.masked_fill(~keep, float("-inf"))
    return vals, idx


def sample_logits(logits: torch.Tensor, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0, greedy: bool = False,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits [B, V] -> sampled token ids [B] (int64)."""
    if greedy or temperature == 0.0:
        return logits.argmax(dim=-1)
    vals, idx = top_k_top_p_filter(logits, temperature, top_k, top_p)
    choice = torch.multinomial(torch.softmax(vals, dim=-1), 1, generator=generator)
    return idx.gather(-1, choice)[:, 0]


def completion_mask_from_eos(tokens: torch.Tensor, eos_token_id: int) -> torch.Tensor:
    """Mask of positions up to and INCLUDING the first EOS (reference EOS
    masking, grpo_trainer.py:605-609); all ones when no EOS. tokens [B, T]."""
    is_eos = tokens == eos_token_id
    any_eos = is_eos.any(dim=-1)
    first = is_eos.int().argmax(dim=-1)
    limit = torch.where(any_eos, first, tokens.shape[1] - 1)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    return (pos[None, :] <= limit[:, None]).to(torch.int32)
