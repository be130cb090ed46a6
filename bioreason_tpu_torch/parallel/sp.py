"""Sequence (context) parallelism for the long-DNA towers (the port of
bioreason_tpu/parallel/sp.py).

The DNA token axis is split over a mesh axis ('model' by default): each
rank holds a contiguous chunk of every activation, so a tower's activation
memory scales as S/n. Where the JAX package leaves the split to GSPMD and
writes only the attention under `shard_map`, here the towers split and
join the sequence themselves (`shard_sequence` / `unshard_sequence`, called
by `nt_encoder.encoder_forward` and `evo2.hyena_forward` while the scope is
live), and everything in between runs on the local chunk:

  * `sp_attention`: each rank all-gathers K, V and the mask along the
    sequence (the backward reduce-scatters their gradients) and runs its
    local queries through `models.attention.attention`; causal ranks offset
    their queries by rank * chunk. Unlike the JAX package, whose Pallas
    kernel fixes q_offset at compile time and so falls back to XLA here
    (sp.py:134-140), the port's kernels take q_offset at call time, so a
    causal rank runs `flash_fwd` / `flash_bwd` on the card;
  * `sp_local_attention`: the band needs only a halo of `window` keys from
    each neighbour (two `comm.ppermute`s, zeros at the edges): the local
    queries framed at offset `window` go through `local_attention`, so the
    card runs `local_fwd` / `local_bwd` on the frame. When the halo would
    not fit in the chunk (window >= chunk) every rank gathers K / V and
    runs its queries zero-padded into the full frame.

Routing (`models/attention.py`): impl "sp" runs the local attention with
"auto" (the kernel on the card, the grouped einsums on the CPU, which is
JAX's "sp"), "sp_pallas" with the kernel's wrapper, "sp_local:<W>" the
banded halo path. The scope (`sequence_sharding`) holds the axis; trainers
open it around their own steps only.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bioreason_tpu_torch.parallel import comm

_STATE = {"axis": None}


class sequence_sharding:
    """Scoped registration of the sequence axis (a `comm.Axis`) for the
    dynamic extent of a `with` block; restores what was registered before.
    None leaves the registration as it is."""

    def __init__(self, axis: Optional[comm.Axis]):
        self._axis = axis

    def __enter__(self):
        self._prev = _STATE["axis"]
        if self._axis is not None:
            _STATE["axis"] = self._axis
        return self

    def __exit__(self, *exc):
        _STATE["axis"] = self._prev
        return False


def sequence_sharding_enabled() -> bool:
    return _STATE["axis"] is not None


def sp_axis_size() -> int:
    return _STATE["axis"].size if sequence_sharding_enabled() else 1


def _axis() -> comm.Axis:
    if _STATE["axis"] is None:
        raise RuntimeError("sequence-parallel attention needs a live sequence_sharding scope")
    return _STATE["axis"]


def tower_sharded(impl: str) -> bool:
    """Whether a tower with attention `impl` runs sequence-sharded now: the
    impl asks for it ("sp...") and the scope is live (it raises without)."""
    if not str(impl).startswith("sp"):
        return False
    _axis()
    return True


def shard_sequence(x: torch.Tensor, pad_value=0) -> torch.Tensor:
    """This rank's chunk of [B, S, ...] (replicated on every rank) along S,
    padded on the right to a multiple of the axis size with `pad_value`."""
    ax = _axis()
    pad = (-x.shape[1]) % ax.size
    if pad:
        widths = [0, 0] * (x.dim() - 2) + [0, pad]
        x = (F.pad(x.int(), widths, value=int(pad_value)).bool() if x.dtype == torch.bool
             else F.pad(x, widths, value=pad_value))
    return comm.local_slice(x, ax, 1)


def unshard_sequence(x: torch.Tensor, length: int) -> torch.Tensor:
    """The whole [B, length, ...] from every rank's chunk, for code that then
    runs identically on every rank (the gradient keeps this rank's chunk)."""
    return comm.gather_replicated(x, _axis(), 1)[:, :length]


def sp_attention(q, k, v, kv_mask=None, causal=False, impl="auto"):
    """Attention over the sharded sequence: q / k / v [B, C, H, D] and
    kv_mask [B, C] are this rank's chunk; returns this rank's output chunk."""
    from bioreason_tpu_torch.models.attention import attention
    ax = _axis()
    if kv_mask is None:
        kv_mask = torch.ones(q.shape[:2], dtype=torch.int32, device=q.device)
    k_full = comm.all_gather_sum(k, ax, 1)
    v_full = comm.all_gather_sum(v, ax, 1)
    m_full = comm.all_gather(kv_mask, ax, 1)
    q_offset = ax.index * q.shape[1] if causal else None
    return attention(q, k_full, v_full, kv_mask=m_full, causal=causal, q_offset=q_offset,
                     impl=impl)


def sp_local_attention(q, k, v, window: int, kv_mask=None):
    """Banded attention (|i - j| <= window) over the sharded sequence, by a
    halo exchange (or the gather fallback when window >= chunk)."""
    from bioreason_tpu_torch.ops.local_attention import local_attention
    ax = _axis()
    n, c = ax.size, q.shape[1]
    if kv_mask is None:
        kv_mask = torch.ones(q.shape[:2], dtype=torch.int32, device=q.device)
    if window < c:
        hp = window
        fwd = [(i, i + 1) for i in range(n - 1)]
        bwd = [(i + 1, i) for i in range(n - 1)]

        def halo(x):
            left = comm.ppermute(x[:, c - hp:], ax, fwd)       # edge ranks get zeros
            right = comm.ppermute(x[:, :hp], ax, bwd)
            return torch.cat([left, x, right], 1)

        # the local queries framed at offset hp: frame distance = global distance
        qf = F.pad(q, (0, 0, 0, 0, hp, hp))
        out = local_attention(qf, halo(k), halo(v), window, kv_mask=halo(kv_mask))
        return out[:, hp:hp + c]
    k_full = comm.all_gather_sum(k, ax, 1)
    v_full = comm.all_gather_sum(v, ax, 1)
    m_full = comm.all_gather(kv_mask, ax, 1)
    qz = F.pad(q, (0, 0, 0, 0, ax.index * c, (n - 1 - ax.index) * c))
    out = local_attention(qz, k_full, v_full, window, kv_mask=m_full)
    return out[:, ax.index * c:(ax.index + 1) * c]
