"""Pipeline parallelism: a GPipe schedule over the decoder's layers (the
port of bioreason_tpu/parallel/pp.py).

Stage s of S (the 'model' axis) owns the contiguous layers
[s*L/S, (s+1)*L/S) (`partition.ShardPlan` drops the others). M
microbatches run in M+S-1 ticks; at each tick every stage runs its layers
on the microbatch in front of it and the activations hop one stage
forward (`comm.ppermute`, whose backward sends the gradient one stage
back, so the backward pipeline comes from autograd, as JAX's comes from
the transpose of ppermute). The last stage's outputs then reach every rank
(`comm.broadcast`; the gradient passes through unchanged), as JAX's final
psum gives them.

Every rank runs every tick's collective in the same order, forward and
backward: the first stage adds 0 * the received state to its input so that
each tick's ppermute stays in its graph. Bubble fraction (S-1)/(M+S-1).
A stage runs each layer as the plain loop does (`layers.layer_fn`): an
fsdp-sharded parameter is gathered for that layer and tick alone (JAX's
pp rules give the decoder's layers no 'fsdp' entry, so today that is a
no-op; the encoder and an untied head keep theirs).

Held against the plain `decoder_forward` (tests/test_torch_pp.py), not
against JAX pp.py, whose test was red at the seed.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from bioreason_tpu_torch.parallel import comm

_STATE = {"axis": None, "n_micro": None, "dp": 1, "layers": None}


class pipeline_sharding:
    """Scoped registration of (axis, n_micro) for GPipe execution of the
    decoder's layers; `dp` is the data-parallel size (for JAX's batch
    check) and `layers` the range of layers this rank's stage owns (the
    axis' contiguous share by default). None leaves the registration as it
    is."""

    def __init__(self, axis: Optional[comm.Axis], n_micro: int = 4, dp: int = 1,
                 layers: Optional[range] = None):
        self._state = (None if axis is None
                       else {"axis": axis, "n_micro": n_micro, "dp": dp, "layers": layers})

    def __enter__(self):
        self._prev = dict(_STATE)
        if self._state is not None:
            _STATE.update(self._state)
        return self

    def __exit__(self, *exc):
        _STATE.update(self._prev)
        return False


def pipeline_enabled() -> bool:
    return _STATE["axis"] is not None


def pipeline_state():
    return _STATE["axis"], _STATE["n_micro"]


def pp_batch_axes(mesh_shape, axis: str = "model"):
    """Mesh axes the batch splits over under the pipeline: every axis but
    the stage axis whose size is above 1 (JAX pp.py:84-90)."""
    return tuple(a for a in ("data", "fsdp", "model") if a != axis and mesh_shape[a] > 1)


class _FromLastStage(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.last = axis.index == axis.size - 1
        return comm.broadcast(x, axis, axis.size - 1)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None


def pp_decoder_layers(layers: Sequence, h: torch.Tensor, cfg, positions, attention_mask,
                      axis: comm.Axis, n_micro: int = 4, dp: int = 1,
                      seeds: Optional[List] = None, dropout_rate: float = 0.0) -> torch.Tensor:
    """Run this stage's `layers` (its share of the L layers; L % S == 0) as
    stage `axis.index` of an S-stage GPipe pipeline. h [B, T, H] is the
    rank's local batch (B % n_micro == 0; JAX's message names the global
    batch, dp * B). `seeds`: this stage's LoRA dropout seeds, one per layer.
    Returns the last stage's [B, T, H] on every rank."""
    from bioreason_tpu_torch.models import layers as L
    from bioreason_tpu_torch.models.qwen3 import _layer_forward
    s, stage = axis.size, axis.index
    b, t, hid = h.shape
    if cfg.num_layers % s:
        raise ValueError(f"num_layers {cfg.num_layers} not divisible by {s} stages")
    if b % n_micro:
        raise ValueError(f"batch {b * dp} not divisible by dp {dp} x n_micro {n_micro}")
    seeds = seeds if seeds is not None else [None] * len(layers)
    layer = L.layer_fn(_layer_forward, cfg)
    mb = h.reshape(n_micro, b // n_micro, t, hid)
    pos_mb = positions.reshape(n_micro, b // n_micro, t)
    mask_mb = attention_mask.reshape(n_micro, b // n_micro, t)
    hop = [(i, i + 1) for i in range(s - 1)]
    state = torch.zeros_like(mb[0])
    outs: List[Optional[torch.Tensor]] = [None] * n_micro
    for ti in range(n_micro + s - 1):
        cur = min(max(ti - stage, 0), n_micro - 1)
        x = mb[cur] + 0.0 * state if stage == 0 else state
        for lp, seed in zip(layers, seeds):
            x = layer(lp, x, cfg, pos_mb[cur], mask_mb[cur], True, dropout_seed=seed,
                      dropout_rate=dropout_rate)
        emit = ti - (s - 1)
        if 0 <= emit < n_micro:
            outs[emit] = x
        if ti < n_micro + s - 2:
            state = comm.ppermute(x, axis, hop)
    out = torch.stack(outs).reshape(b, t, hid)
    return out if s == 1 else _FromLastStage.apply(out, axis)


def pp_decoder_forward(dec, cfg, input_ids, attention_mask=None, return_hidden: bool = False):
    """The decoder's training forward (no cache) with its layers pipelined
    under the live scope: the plain `decoder_forward` routes here."""
    from bioreason_tpu_torch.models.qwen3 import decoder_forward
    if not pipeline_enabled():
        raise RuntimeError("pp_decoder_forward needs a live pipeline_sharding scope")
    out, _ = decoder_forward(dec, cfg, input_ids, attention_mask=attention_mask,
                             return_hidden=return_hidden)
    return out
