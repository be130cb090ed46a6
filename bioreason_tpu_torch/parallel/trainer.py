"""What a trainer does differently under a mesh: the torch side of the JAX
trainers' sharded steps, written out (GSPMD derives them in JAX).

`MeshRun` holds one rank's view of a mesh for one model:
  * `plan` (`partition.ShardPlan`): fsdp / tensor / expert / stage shards,
    applied to the model when the run is made; with `encoder_cfg` the NT
    tower's layers are tensor-parallel too;
  * `scope()`: the context of a forward and its backward: the sequence
    (`sp.sequence_sharding`) and pipeline (`pp.pipeline_sharding`) scopes
    when the trainer asked for them. The fsdp-sharded parameters stay
    sharded in it: each tower layer, table and projection gathers its own
    while it runs and frees them after, in the forward and in the backward
    (`partition.layer_gathered`), so a rank holds one or two layers
    gathered at a time. `scope(whole=True)` gathers every fsdp slice for
    the extent instead: the generation engine's call alone. The
    tensor-parallel shards stay as they are (the engine runs on them too,
    `generate/engine.py`);
  * `rows(x)`: this rank's rows of a global host batch (the batch splits
    over data x fsdp, JAX's `batch_spec`).

`DistAdamW` is `optim.AdamW` with ZeRO-2: every gradient is summed over
the ranks that computed parts of it, then reduce-scattered over 'data' on
the first dim the data size divides (JAX `zero2_sharding`); the moments
exist only for that shard, each rank updates its shard and the parameter
is all-gathered over 'data'. The clip's global norm sums every shard's
squares once over the whole world, so the clip and the non-finite guard
agree on every rank.

Loss normalization matches the one-device step on the global batch: the
trainers weight each rank's local mean by its share of the global count
(the CE's supervised tokens, GRPO's rows) and sum over dp.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from bioreason_tpu_torch.parallel import comm
from bioreason_tpu_torch.parallel.mesh import topology
from bioreason_tpu_torch.parallel.partition import ShardPlan, layer_gathered, zero2_sharding
from bioreason_tpu_torch.train.optim import AdamW


def nt_tower(fusion_cfg):
    """The config of a fusion model's NT encoder, whose layers a mesh splits
    over 'model' (`MeshRun(encoder_cfg=)`); None for the Evo2 tower, which
    stays replicated, as no JAX rule names its parameters."""
    return None if fusion_cfg.encoder_kind == "evo2" else fusion_cfg.encoder


class MeshRun:
    def __init__(self, mesh, model: torch.nn.Module, decoder_cfg=None, sp: bool = False,
                 pp_micro: int = 0, encoder_cfg=None):
        self.topo = topology(mesh)
        self.pp = pp_micro > 0 and self.topo.model.size > 1
        self.pp_micro = pp_micro
        self.sp = sp
        self.plan = ShardPlan(model, decoder_cfg, self.topo, pp=self.pp,
                              encoder_cfg=encoder_cfg)
        self.plan.apply(model)
        self.model = model

    @property
    def dp(self) -> comm.Axis:
        return self.topo.dp

    @property
    def last_stage(self) -> bool:
        return not self.pp or self.topo.model.index == self.topo.model.size - 1

    def scope(self, model: Optional[torch.nn.Module] = None, whole: bool = False):
        """The context of a forward of `model` (default: the run's own; any
        tree that holds its pieces under the same names, such as GRPO's
        reference policy) and of its backward. Its layers gather their fsdp
        shards one at a time; `whole`: every fsdp-sharded parameter of
        `model` is gathered for the extent (`partition.layer_gathered` over
        the whole tree), which the generation engine alone asks for."""
        from bioreason_tpu_torch.parallel.pp import pipeline_sharding
        from bioreason_tpu_torch.parallel.sp import sequence_sharding
        stack = contextlib.ExitStack()
        if whole:
            stack.enter_context(layer_gathered(self.model if model is None else model))
        stack.enter_context(sequence_sharding(self.topo.model if self.sp else None))
        stack.enter_context(pipeline_sharding(
            self.topo.model if self.pp else None, self.pp_micro, self.dp.size,
            self.plan.stage_layers))
        return stack

    def scope_unsplit(self, model: Optional[torch.nn.Module] = None, whole: bool = False):
        """`scope` for rows that every rank holds whole (a rollout, an eval
        batch), not split over dp: the MoE counts its capacity per rank."""
        self.split_rows(False)
        return self.scope(model, whole)

    def rows(self, x):
        """This rank's contiguous 1/dp of the leading dim (a host array or a
        tensor); raises when it does not divide."""
        n = x.shape[0]
        if n % self.dp.size:
            raise ValueError(f"batch of {n} rows does not split over data x fsdp = "
                             f"{self.dp.size}")
        k = n // self.dp.size
        return x[self.dp.index * k:(self.dp.index + 1) * k]

    def split_rows(self, split: bool) -> None:
        """Whether the batch now running is split over dp (the MoE layers
        then count capacity over every rank's rows) or replicated."""
        for mod in self.model.modules():
            if hasattr(mod, "experts") and hasattr(mod, "router"):
                mod.experts.dp = self.dp if split and self.dp.size > 1 else None

    def sum_dp(self, x: torch.Tensor) -> torch.Tensor:
        return comm.all_reduce(x, self.dp)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of x, in global order (no gradient)."""
        return comm.all_gather(x, self.dp, 0)

    def grad_axes(self, name: str) -> List[comm.Axis]:
        """Axes over which `name`'s gradient is still a partial sum, besides
        'data' (which `DistAdamW` reduces): 'fsdp' unless the fsdp gather's
        backward already reduce-scattered it; 'model' where each model rank
        computed another part (the DNA tower under sequence parallelism;
        under the pipeline, whatever runs outside the layers: the first
        stage alone feeds them, the last stage alone takes the loss; the
        per-head q / k norms of a tensor-parallel attention and the
        biases of colwise linears, each rank's slice of them)."""
        axes = []
        if not any(ax == "fsdp" for ax, _ in self.plan.placements.get(name, [])):
            axes.append(self.topo.fsdp)
        if ((self.sp and name.startswith("encoder."))
                or (self.pp and not name.startswith("decoder.layers."))
                or name in self.plan.partial_over_model):
            axes.append(self.topo.model)
        return axes

    def pieces(self, name: str) -> int:
        """How many distinct pieces of `name` the model and fsdp axes hold
        (1 where it is replicated over both: a colwise bias is stored whole
        on every rank)."""
        n = 1
        for ax, _ in self.plan.placements.get(name, []):
            n *= getattr(self.topo, ax).size
        if self.pp and name.startswith("decoder.layers."):
            n *= self.topo.model.size
        return n


class DistAdamW(AdamW):
    """`AdamW` over the shards of a `MeshRun` (ZeRO-2 over 'data')."""

    def __init__(self, params: Sequence[torch.nn.Parameter], names: Sequence[str], cfg,
                 run: MeshRun, lr_scales: Optional[Sequence[float]] = None):
        super().__init__(params, cfg, lr_scales)
        self.names, self.run = list(names), run
        data = run.topo.data
        self.zdim: List[Optional[int]] = []
        for i, p in enumerate(self.params):
            spec = zero2_sharding(tuple(p.shape), {"data": data.size})
            z = spec.index("data") if "data" in spec else None
            self.zdim.append(z)
            if z is not None:
                self.mu[i] = comm.local_slice(self.mu[i], data, z).clone()
                self.nu[i] = comm.local_slice(self.nu[i], data, z).clone()
        self._axes = [run.grad_axes(n) for n in self.names]
        world = run.topo.world
        self._repl = [world / (run.pieces(n) * (data.size if z is not None else 1))
                      for n, z in zip(self.names, self.zdim)]

    def _views(self) -> List[torch.Tensor]:
        data = self.run.topo.data
        return [p.data if z is None else comm.local_slice(p.data, data, z)
                for p, z in zip(self.params, self.zdim)]

    def reduce(self, grads: Sequence[Optional[torch.Tensor]]) -> List[torch.Tensor]:
        """Every rank's gradients -> this rank's fully summed shards."""
        data = self.run.topo.data
        out = []
        for p, g, axes, z in zip(self.params, grads, self._axes, self.zdim):
            g = torch.zeros_like(p, dtype=torch.float32) if g is None else g.float()
            for ax in axes:           # (an axis of size 1 returns g itself)
                g = comm.all_reduce(g, ax)
            g = comm.all_reduce(g, data) if z is None else comm.reduce_scatter(g, data, z)
            out.append(g)
        return out

    def norm(self, shards: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global norm of the whole gradient from this rank's shards:
        each shard's squares once, divided by the number of ranks that
        hold the same piece, summed over the world."""
        parts = []
        for r in sorted(set(self._repl)):
            norms = torch._foreach_norm([g for g, x in zip(shards, self._repl) if x == r])
            parts.append(torch.stack(norms).float().pow(2).sum() / r)
        sq = torch.stack(parts).sum()
        sq = comm.all_reduce(comm.all_reduce(sq, self.run.topo.dp), self.run.topo.model)
        return sq.sqrt()

    @torch.no_grad()
    def _step_shards(self, shards: List[torch.Tensor]) -> float:
        gnorm = self.norm(shards)
        norm = self._apply(self._views(), shards, gnorm, float(gnorm))
        data = self.run.topo.data
        for p, z in zip(self.params, self.zdim):
            if z is not None:
                p.data.copy_(comm.all_gather(comm.local_slice(p.data, data, z), data, z))
        return norm

    @torch.no_grad()
    def step(self, grads) -> float:
        return self._step_shards(self.reduce(grads))

    @torch.no_grad()
    def accumulate(self, grads, k: int) -> float:
        if k <= 1:
            return self.step(grads)
        shards = self.reduce(grads)
        norm = float(self.norm(shards))
        self._acc = shards if self._acc is None else torch._foreach_add(self._acc, shards)
        self._micro += 1
        if self._micro == k:
            self._step_shards(torch._foreach_div(self._acc, float(k)))
            self._acc, self._micro = None, 0
        return norm

    def full_state(self, order: Sequence[str]) -> Dict:
        """`state_dict` with the whole moments, listed in `order` (the names
        of the whole model's trainable parameters; a collective every rank
        takes)."""
        data = self.run.topo.data
        whole = lambda ts: full_named(self.run, {
            n: t if z is None else comm.all_gather(t, data, z)
            for n, t, z in zip(self.names, ts, self.zdim)})
        mu, nu = whole(self.mu), whole(self.nu)
        state = super().state_dict()
        state["mu"] = [mu[n] for n in order]
        state["nu"] = [nu[n] for n in order]
        return state

    def load_full_state(self, state: Dict) -> None:
        data = self.run.topo.data
        def piece(t, n, z):
            s = self.run.plan.shard(n, t.to(self.mu[0].device))
            return s if z is None else comm.local_slice(s, data, z)
        by_name = dict(zip(state["names"], zip(state["mu"], state["nu"])))
        for i, (n, z) in enumerate(zip(self.names, self.zdim)):
            mu, nu = by_name[n]
            self.mu[i].copy_(piece(mu, n, z))
            self.nu[i].copy_(piece(nu, n, z))
        for key in ("count", "notfinite_count", "total_notfinite", "last_finite"):
            setattr(self, key, state[key])


def full_named(run: MeshRun, named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """name -> whole tensor on every rank, from each rank's pieces (the
    tensor-parallel shards of both towers gathered along their `model`
    dim; the pipeline's stages each contribute their own layers)."""
    out = {n: run.plan.unshard(n, t.detach()).cpu() for n, t in named.items()}
    if run.pp:
        parts: List[Optional[Dict]] = [None] * run.topo.model.size
        dist.all_gather_object(parts, out, group=run.topo.model.group)
        out = {k: v for part in parts for k, v in part.items()}
    return out


def is_writer() -> bool:
    """Rank 0 writes checkpoints and logs."""
    return not dist.is_initialized() or dist.get_rank() == 0
