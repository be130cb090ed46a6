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
    """logits [B, V] -> sampled token ids [B] (int64).

    Total on non-finite rows, without a host sync: a row whose kept
    probabilities are not finite (a NaN logit, or every logit -inf) draws
    from a one-hot in place of its softmax, so `torch.multinomial` never
    sees it (it raises on the CPU and may assert on the card), and returns
    the argmax of its logits with NaN read as -inf: id 0 for an all-NaN or
    an all -inf row, the id `jax.random.categorical` gives there. Finite rows
    keep their draws: multinomial draws each row independently."""
    if greedy or temperature == 0.0:
        return logits.argmax(dim=-1)
    vals, idx = top_k_top_p_filter(logits, temperature, top_k, top_p)
    probs = torch.softmax(vals, dim=-1)
    ok = torch.isfinite(probs).all(dim=-1, keepdim=True)                # [B, 1]
    first = torch.zeros_like(probs)
    first[:, 0] = 1.0
    choice = torch.multinomial(torch.where(ok, probs, first), 1, generator=generator)
    fallback = torch.nan_to_num(logits, nan=float("-inf")).argmax(dim=-1, keepdim=True)
    return torch.where(ok, idx.gather(-1, choice), fallback)[:, 0]


def completion_mask_from_eos(tokens: torch.Tensor, eos_token_id: int) -> torch.Tensor:
    """Mask of positions up to and INCLUDING the first EOS (reference EOS
    masking, grpo_trainer.py:605-609); all ones when no EOS. tokens [B, T]."""
    is_eos = tokens == eos_token_id
    any_eos = is_eos.any(dim=-1)
    first = is_eos.int().argmax(dim=-1)
    limit = torch.where(any_eos, first, tokens.shape[1] - 1)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    return (pos[None, :] <= limit[:, None]).to(torch.int32)
