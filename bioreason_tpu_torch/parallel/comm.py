"""Collectives over one mesh axis, with the autograd rules the parallel
modules need (the torch side of what `shard_map` and GSPMD give the JAX
package for free).

An `Axis` is one named axis of the mesh seen from this rank: its process
group, its size and this rank's index along it. Every function here is
the identity on an axis of size 1, so a world of one runs the same code
with no communication.

Autograd rules (each rank differentiates its own copy of the program):
  * `all_gather_sum`: gather along a dim; the backward reduce-scatters
    (sums) the gradient, because every rank's piece feeds every rank's
    output (sequence-parallel K / V, FSDP's parameter gather).
  * `gather_replicated`: gather along a dim for code that then runs
    identically on every rank of the axis; the backward keeps this rank's
    slice of the (identical) gradient.
  * `copy_to` / `reduce_from`: Megatron's f and g. `copy_to` is the
    identity forward and sums the gradient over the axis; `reduce_from`
    sums the forward and passes the gradient through.
  * `ppermute`: each (src, dst) pair sends src's tensor to dst (zeros where
    nothing arrives); the backward sends the gradient the opposite way.

`regathered_saves` is the other half of FSDP's per-layer gather
(`partition.layer_gathered`): autograd would keep every gathered weight
that a product saves for its backward alive until that backward, so the
whole model would be gathered at the end of a forward. Under these hooks a
saved tensor that views a gathered parameter is kept as a handle on its
shard instead, and all-gathered anew when the backward reads it.

Gloo takes CPU tensors for every op used here, and CUDA tensors for the
collectives (all_reduce, all_gather, reduce_scatter, broadcast: it copies
them through host memory itself). Its point-to-point send of a CUDA tensor
aborts the process (`writev ... Bad address`, torch 2.11 on an H100;
`chip_smoke.gloo_cuda_probe`). So where the group's backend is gloo and the
tensor lies on a card, the ops named in `GLOO_CUDA_STAGED` copy their
tensors to host memory, run there, and copy the result back to the card:
no arithmetic of the program runs on the host. NCCL takes CUDA tensors
directly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# the ops gloo refuses on CUDA tensors, staged through host memory
# (PERF.md §6: the probe of chip_smoke.py phase 21)
GLOO_CUDA_STAGED = frozenset({"p2p"})


@dataclass
class Axis:
    """One mesh axis from this rank: `group` (None when size is 1), `size`,
    `index` (this rank's coordinate), `ranks` (global ranks, by index)."""
    name: str
    group: Optional[object]
    size: int
    index: int
    ranks: Tuple[int, ...]

    def __deepcopy__(self, memo):
        # a handle on the process's groups (which do not copy): a copied
        # module tree (GRPO's reference policy) keeps its tensor-parallel
        # markers on the same axis
        return self


def _staged(axis: Axis, t: torch.Tensor, op: str) -> bool:
    return (t.is_cuda and op in GLOO_CUDA_STAGED
            and dist.get_backend(axis.group) == "gloo")


def all_reduce(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum over the axis (a new, contiguous tensor; x is not changed). The
    sum runs over the buffers elementwise, so every rank's copy is laid
    out row-major first: the ranks' x may hold one shape in different
    strides (a reduce-scattered gradient on one rank, zeros on another)."""
    if axis.size == 1:
        return x
    if _staged(axis, x, "all_reduce"):
        h = x.detach().contiguous().cpu()
        dist.all_reduce(h, group=axis.group)
        return h.to(x.device)
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=axis.group)
    return y


def all_gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """Concatenation along `dim` of every rank's x, in axis order."""
    if axis.size == 1:
        return x
    dev = x.device
    src = x.detach().movedim(dim, 0).contiguous()
    if _staged(axis, x, "all_gather"):
        src = src.cpu()
    out = src.new_empty((axis.size * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=axis.group)
    return out.to(dev).movedim(0, dim)


def reduce_scatter(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """Sum over the axis, then this rank's slice along `dim` (x.shape[dim]
    divisible by the axis size)."""
    if axis.size == 1:
        return x
    dev = x.device
    src = x.detach().movedim(dim, 0).contiguous()
    if _staged(axis, x, "reduce_scatter"):
        src = src.cpu()
    out = src.new_empty((src.shape[0] // axis.size,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=axis.group)
    return out.to(dev).movedim(0, dim)


def broadcast(x: torch.Tensor, axis: Axis, src_index: int) -> torch.Tensor:
    """The tensor of the rank at `src_index` on every rank of the axis."""
    if axis.size == 1:
        return x
    staged = _staged(axis, x, "broadcast")
    y = x.detach().cpu() if staged else x.detach().clone().contiguous()
    dist.broadcast(y, src=axis.ranks[src_index], group=axis.group)
    return y.to(x.device) if staged else y


def local_slice(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """This rank's contiguous 1/size of x along `dim`."""
    if axis.size == 1:
        return x
    n = x.shape[dim] // axis.size
    return x.narrow(dim, axis.index * n, n)


def _p2p(x: torch.Tensor, axis: Axis, pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """What arrives at this rank under `pairs` (zeros if nothing does)."""
    staged = _staged(axis, x, "p2p")
    send = x.detach().contiguous()
    send = send.cpu() if staged else send
    recv = torch.zeros_like(send)
    ops = []
    for s, d in pairs:
        if s == axis.index and d != s:
            ops.append(dist.P2POp(dist.isend, send, axis.ranks[d], axis.group))
        if d == axis.index and d != s:
            ops.append(dist.P2POp(dist.irecv, recv, axis.ranks[s], axis.group))
    for s, d in pairs:
        if s == d == axis.index:
            recv = send.clone()
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv.to(x.device) if staged else recv


class _AllGatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.axis, ctx.dim), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, ctx.axis, ctx.dim).contiguous(), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, pairs):
        ctx.axis, ctx.pairs = axis, pairs
        return _p2p(x, axis, pairs)

    @staticmethod
    def backward(ctx, g):
        return _p2p(g, ctx.axis, [(d, s) for s, d in ctx.pairs]), None, None


def all_gather_sum(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    return x if axis.size == 1 else _AllGatherSum.apply(x, axis, dim)


def gather_replicated(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    return x if axis.size == 1 else _GatherReplicated.apply(x, axis, dim)


def copy_to(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.size == 1 else _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.size == 1 else _ReduceFrom.apply(x, axis)


def ppermute(x: torch.Tensor, axis: Axis, pairs: List[Tuple[int, int]]) -> torch.Tensor:
    """`jax.lax.ppermute` over the axis, differentiable."""
    if axis.size == 1:
        return sum((x for s, d in pairs if s == d == 0), torch.zeros_like(x))
    return _PPermute.apply(x, axis, tuple(pairs))


@dataclass
class Gathered:
    """How to make a gathered parameter again: its shard, the axis and dim
    it was gathered over, and the dtype it was cast to after the gather."""
    shard: torch.Tensor
    axis: Axis
    dim: int
    dtype: torch.dtype

    def again(self) -> torch.Tensor:
        return all_gather(self.shard, self.axis, self.dim).to(self.dtype)


def storage_key(t: torch.Tensor) -> Tuple[str, int]:
    return str(t.device), t.untyped_storage().data_ptr()


class regathered_saves(torch.autograd.graph.saved_tensors_hooks):
    """Saved-tensor hooks over a region whose parameters were all-gathered:
    `registry` maps the storage of each gathered tensor (`storage_key`) to
    its `Gathered`. A tensor that autograd saves in the region and that
    views one of them (the weight itself, its transpose) is packed as that
    `Gathered` and the view's geometry, and unpacked as the same view of a
    new all-gather (`Gathered.again`, which lays the tensor out as the
    forward's gather did); `on_gather(t)` sees each tensor so made. Every
    other saved tensor is kept as it is."""

    def __init__(self, registry: Dict[Tuple[str, int], Gathered], on_gather=None):
        def pack(t):
            g = registry.get(storage_key(t)) if t.numel() else None
            if g is None or t.dtype != g.dtype:
                return t
            return g, tuple(t.shape), t.stride(), t.storage_offset()

        def unpack(x):
            if not isinstance(x, tuple):
                return x
            g, size, stride, offset = x
            full = g.again()
            if on_gather is not None:
                on_gather(full)
            return full.as_strided(size, stride, offset)
        super().__init__(pack, unpack)
