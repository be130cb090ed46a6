"""Device mesh construction (the port of bioreason_tpu/parallel/mesh.py).

One `torch.distributed.device_mesh.DeviceMesh` of shape (data, fsdp,
model) over the default process group, with `mesh_dim_names=MESH_AXES`:

  data  - batch (DP); gradients summed over it, optimizer moments sharded
          over it (ZeRO-2)
  fsdp  - parameters, their gradients and moments sharded over it
  model - tensor parallelism (the decoder's heads and MLP), expert
          parallelism (the MoE banks), sequence parallelism (the DNA
          towers) or the GPipe stages, by what the trainer is asked for

The rank arithmetic lives in `mesh_ranks` / `multislice_ranks`, pure
functions of the ranks and the config, with JAX's rules and assertion
messages: `data=-1` fills with the ranks that remain, and the product must
equal the world size. A multislice mesh orders the data axis slice-major:
a slice is one node (`LOCAL_WORLD_SIZE` ranks, as torchrun numbers them);
one host is one slice, as the JAX mesh degrades to one slice off a pod.

`topology(mesh)` gives the trainers this rank's `comm.Axis` of each mesh
axis, plus `dp` (data x fsdp, the axes the batch splits over).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from bioreason_tpu_torch.config import MeshConfig
from bioreason_tpu_torch.parallel.comm import Axis

MESH_AXES = ("data", "fsdp", "model")


def mesh_ranks(ranks: Sequence[int], cfg: MeshConfig = MeshConfig()) -> np.ndarray:
    """The [data, fsdp, model] array of `ranks` (JAX make_mesh's layout)."""
    n = len(ranks)
    fsdp, model = cfg.fsdp, cfg.model
    data = cfg.data
    if data == -1:
        assert n % (fsdp * model) == 0, f"{n} devices not divisible by fsdp*model={fsdp * model}"
        data = n // (fsdp * model)
    assert data * fsdp * model == n, f"mesh {data}x{fsdp}x{model} != {n} devices"
    return np.asarray(ranks).reshape(data, fsdp, model)


def multislice_ranks(ranks: Sequence[int], cfg: MeshConfig = MeshConfig(),
                     slice_of=None) -> np.ndarray:
    """The slice-major [data, fsdp, model] array (JAX make_multislice_mesh):
    `slice_of(rank)` names a rank's slice (default: all in one)."""
    slice_of = slice_of or (lambda r: 0)
    by_slice: Dict[int, list] = {}
    for r in ranks:
        by_slice.setdefault(slice_of(r), []).append(r)
    slices = [by_slice[k] for k in sorted(by_slice)]
    per = len(slices[0])
    assert all(len(s) == per for s in slices), "uneven slices"
    fsdp, model = cfg.fsdp, cfg.model
    assert per % (fsdp * model) == 0, (
        f"{per} devices/slice not divisible by fsdp*model={fsdp * model}")
    data_inner = per // (fsdp * model)
    arr = np.stack([np.asarray(s).reshape(data_inner, fsdp, model) for s in slices])
    return arr.reshape(len(slices) * data_inner, fsdp, model)


def _device_type(device) -> str:
    from bioreason_tpu_torch.utils.devices import resolve_device
    return resolve_device(device).type


def _world() -> list:
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialized "
                           "(parallel.launch.init_world or a launcher)")
    return list(range(dist.get_world_size()))


def make_mesh(cfg: MeshConfig = MeshConfig(), device=None):
    """DeviceMesh over the default group; `device` picks its device type
    (CUDA unless "cpu")."""
    from torch.distributed.device_mesh import DeviceMesh
    arr = mesh_ranks(_world(), cfg)
    return DeviceMesh(_device_type(device), torch.as_tensor(arr), mesh_dim_names=MESH_AXES)


def make_multislice_mesh(cfg: MeshConfig = MeshConfig(), device=None):
    """The multislice DeviceMesh: slices are nodes of LOCAL_WORLD_SIZE ranks."""
    from torch.distributed.device_mesh import DeviceMesh
    world = _world()
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", len(world)))
    arr = multislice_ranks(world, cfg, slice_of=lambda r: r // per_node)
    return DeviceMesh(_device_type(device), torch.as_tensor(arr), mesh_dim_names=MESH_AXES)


@dataclass
class Topology:
    """This rank's view of a mesh: one `Axis` per mesh axis, and `dp`."""
    data: Axis
    fsdp: Axis
    model: Axis
    dp: Axis

    @property
    def world(self) -> int:
        return self.data.size * self.fsdp.size * self.model.size


_DP_GROUPS: Dict[tuple, object] = {}


def _axis(name: str, ranks: Sequence[int], me: int, group) -> Axis:
    ranks = tuple(int(r) for r in ranks)
    # a group orders its ranks by global rank: the axis order must match
    assert list(ranks) == sorted(ranks), f"axis {name} ranks {ranks} are not ascending"
    return Axis(name, group if len(ranks) > 1 else None, len(ranks), ranks.index(me), ranks)


def topology(mesh) -> Topology:
    """The axes of `mesh` (a DeviceMesh from `make_mesh`) seen from this
    rank. The dp group (data x fsdp) is made once per mesh layout, by every
    rank, in the same order."""
    arr = mesh.mesh.cpu().numpy()
    me = dist.get_rank()
    d, f, m = (int(x) for x in np.argwhere(arr == me)[0])
    key = (tuple(arr.reshape(-1).tolist()), arr.shape)
    if key not in _DP_GROUPS:
        groups = {}
        for mi in range(arr.shape[2]):
            ranks = sorted(int(r) for r in arr[:, :, mi].reshape(-1))
            groups[mi] = dist.new_group(ranks) if len(ranks) > 1 else None
        _DP_GROUPS[key] = groups
    dp_ranks = arr[:, :, m].reshape(-1)
    axes = {}
    for name, ranks in (("data", arr[:, f, m]), ("fsdp", arr[d, :, m]),
                        ("model", arr[d, f, :])):
        axes[name] = _axis(name, ranks, me,
                           mesh.get_group(name) if len(ranks) > 1 else None)
    return Topology(axes["data"], axes["fsdp"], axes["model"],
                    _axis("dp", dp_ranks, me, _DP_GROUPS[key][m]))
