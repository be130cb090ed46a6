"""Attention dispatch: the flash kernel on CUDA, grouped einsums otherwise
(the port of bioreason_tpu/models/attention.py).

`attention(impl="auto")` decides from the tensors it is given, not from the
default platform (`use_kernel`): the flash kernel (`flash_fwd`, and in
training `flash_bwd` in the backward) for a CUDA query of more than one
row whose head dim the kernels take (`HEAD_DIMS`); decode steps (Tq == 1),
CPU tensors and NT-v2-50M's 32-wide heads take `xla_attention`. The JAX
rule likewise sends decode, small shapes and head dims its kernel lacks to
XLA (attention.py:104-109). The dtype is not part of the rule: an fp32
CUDA query reaches the kernel's wrapper, which raises (the kernels are
bf16; the JAX Pallas kernel also runs fp32). `impl="pallas"` always calls
the wrapper, which raises on a CUDA call outside its contract.

`impl="local:<W>"` is the banded route for long DNA (JAX attention.py:92-100,
bidirectional only): `local_attention`, whose wrapper launches `local_fwd`
(and `local_bwd`) on CUDA tensors and computes the plain banded version on
CPU tensors. It never falls back to `xla_attention`, whose fully masked rows
differ.
"""

from __future__ import annotations

import torch

from bioreason_tpu_torch.ops.flash_attention import HEAD_DIMS, flash_attention
from bioreason_tpu_torch.ops.local_attention import local_attention

_NEG = torch.finfo(torch.float32).min


def xla_attention(q, k, v, kv_mask=None, causal=False, q_offset=None,
                  k_scale=None, v_scale=None):
    """q: [B,Tq,Hq,D], k/v: [B,Tk,Hkv,D], kv_mask: [B,Tk] (1=valid).

    GQA with grouped einsums: the expanded [B,Tk,Hq,D] K/V is never built.
    Logits and softmax in fp32, probabilities cast to q's dtype for the
    value product. When `causal`, query i attends to keys j <= i + q_offset
    (q_offset defaults to Tk - Tq). A fully masked row softmaxes a row of
    equal minima and returns the mean of V, as the JAX function does.

    `k_scale` / `v_scale` [B,Tk,Hkv,1]: the int8 KV cache's factors, applied
    to the logits and to the probabilities (JAX attention.py:47-65; exact,
    since a scale is per key token and head): no scaled copy of K or V is
    made."""
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, tq, hkv, group, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * (d ** -0.5)
    if k_scale is not None:
        logits = logits * k_scale[..., 0].transpose(1, 2).float()[:, :, None, None, :]
    if kv_mask is not None:
        logits = logits.masked_fill(~kv_mask.bool()[:, None, None, None, :], _NEG)
    if causal:
        if q_offset is None:
            q_offset = tk - tq
        qi = torch.arange(tq, device=q.device)[:, None] + q_offset
        kj = torch.arange(tk, device=q.device)[None, :]
        logits = logits.masked_fill(kj > qi, _NEG)
    probs = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale[..., 0].transpose(1, 2).float()[:, :, None, None, :]
    probs = probs.to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(q.dtype))
    return out.reshape(b, tq, hq, d)


def kernel_rule(device_type: str, tq: int, head_dim: int) -> bool:
    """The `impl="auto"` rule: the flash kernel for a CUDA tensor of more
    than one query row with a head dim in `HEAD_DIMS`, the plain grouped
    path everywhere else (the counterpart of the JAX rule's head-dim clause,
    attention.py:104-109)."""
    return device_type == "cuda" and tq > 1 and head_dim in HEAD_DIMS


def use_kernel(q: torch.Tensor) -> bool:
    """`kernel_rule` on the query [B, Tq, H, D] it is given."""
    return kernel_rule(q.device.type, q.shape[1], q.shape[-1])


def attention(q, k, v, kv_mask=None, causal=False, q_offset=None, impl="auto",
              k_scale=None, v_scale=None):
    """Multi-head (grouped-query) attention. Shapes as in `xla_attention`.

    impl: 'auto' (see `kernel_rule`), 'pallas' (always the flash kernel's
    wrapper, which raises on a CUDA call outside its contract; the name is
    the JAX config's), 'xla' (always the grouped einsums) or
    'local:<W>' (banded, |i - j| <= W; bidirectional only). An int8 cache
    (`k_scale` / `v_scale`) goes to `xla_attention`, as in the JAX dispatch
    (attention.py:101-103): the flash kernel reads float K/V. Its callers
    are decode steps; an int8 prefill attends over its fresh float K/V
    (`qwen3._layer_forward`) and keeps the kernel."""
    if impl.startswith("local:"):
        if causal:
            raise NotImplementedError("local attention is bidirectional-only")
        return local_attention(q, k, v, int(impl.split(":", 1)[1]), kv_mask=kv_mask)
    if k_scale is not None or v_scale is not None:
        return xla_attention(q, k, v, kv_mask=kv_mask, causal=causal, q_offset=q_offset,
                             k_scale=k_scale, v_scale=v_scale)
    if impl == "auto":
        impl = "pallas" if use_kernel(q) else "xla"
    if impl == "pallas":
        return flash_attention(q, k, v, kv_mask=kv_mask, causal=causal, q_offset=q_offset)
    if impl == "xla":
        return xla_attention(q, k, v, kv_mask=kv_mask, causal=causal, q_offset=q_offset)
    raise ValueError(f"unknown attention impl {impl!r}")
