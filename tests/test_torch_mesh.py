"""The port's mesh and partition rules (bioreason_tpu_torch/parallel/mesh.py,
partition.py) against the JAX package: the rank layouts of `make_mesh` /
`make_multislice_mesh` against JAX's device arrays, every parameter's spec
against its JAX leaf's (tiny fusion, tiny MoE, pp=True), `_valid_spec`'s
drop and `zero2_sharding`; the DeviceMesh and each rank's axes in a world of
4 gloo ranks.

Also the spawn helper of the port's multi-rank tests (`spawn_world`): each
file spawns its world once, in a module-scoped fixture that runs every case
and returns the results; each test asserts one case. Ranks set one intra-op
thread and meet at a file store under the test's temporary directory."""

import dataclasses
import os
import re
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

torch.set_num_threads(1)


# -- the spawn helper ------------------------------------------------------------

def _rank_main(rank, world, store, fn, args, queue):
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world)
        out = fn(rank, world, *args)
        dist.barrier()
        queue.put((rank, out, None))
        dist.destroy_process_group()
    except BaseException:                      # reported by the parent
        queue.put((rank, None, traceback.format_exc()))


def spawn_world(fn, world, tmp_dir, *args, timeout=300):
    """fn(rank, world, *args) in `world` gloo ranks on the CPU; returns the
    list of each rank's result (which must pickle: numpy, not tensors)."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    store = os.path.join(str(tmp_dir), f"store_{fn.__name__}_{world}")
    procs = [ctx.Process(target=_rank_main, args=(r, world, store, fn, args, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    results = [None] * world
    try:
        for _ in range(world):
            rank, out, err = queue.get(timeout=timeout)
            if err is not None:
                raise RuntimeError(f"rank {rank} failed:\n{err}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    return results


def to_np(tree):
    """Tensors -> numpy, through dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_np(v) for v in tree)
    return tree


# -- rank layouts against JAX ------------------------------------------------------

MESHES = [(-1, 1, 1), (2, 2, 2), (4, 2, 1), (1, 1, 8), (2, 1, 4), (-1, 2, 2), (1, 4, 2)]


@pytest.mark.parametrize("d,f,m", MESHES)
def test_make_mesh_layout_matches_jax(d, f, m):
    import jax
    from bioreason_tpu import config as JC
    from bioreason_tpu.parallel import make_mesh as jmake
    from bioreason_tpu_torch.config import MeshConfig
    from bioreason_tpu_torch.parallel.mesh import mesh_ranks
    jm = jmake(JC.MeshConfig(data=d, fsdp=f, model=m), devices=jax.devices())
    want = np.vectorize(lambda dev: dev.id)(jm.devices)
    np.testing.assert_array_equal(mesh_ranks(range(8), MeshConfig(d, f, m)), want)


@pytest.mark.parametrize("d,f,m", [(3, 1, 1), (-1, 3, 1), (2, 2, 1), (1, 1, 16)])
def test_make_mesh_bad_product_raises_as_jax(d, f, m):
    import jax
    from bioreason_tpu import config as JC
    from bioreason_tpu.parallel import make_mesh as jmake
    from bioreason_tpu_torch.config import MeshConfig
    from bioreason_tpu_torch.parallel.mesh import mesh_ranks
    with pytest.raises(AssertionError) as jerr:
        jmake(JC.MeshConfig(data=d, fsdp=f, model=m), devices=jax.devices())
    with pytest.raises(AssertionError) as terr:
        mesh_ranks(range(8), MeshConfig(d, f, m))
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("f,m,per", [(1, 1, 8), (2, 1, 4), (1, 2, 4), (2, 2, 4), (1, 1, 2)])
def test_multislice_layout_matches_jax(f, m, per):
    """Slices of `per` ranks (node-major), JAX's slice_key on device ids."""
    import jax
    from bioreason_tpu import config as JC
    from bioreason_tpu.parallel import make_multislice_mesh as jmake
    from bioreason_tpu_torch.config import MeshConfig
    from bioreason_tpu_torch.parallel.mesh import multislice_ranks
    jm = jmake(JC.MeshConfig(fsdp=f, model=m), devices=jax.devices(),
               slice_key=lambda dev: dev.id // per)
    want = np.vectorize(lambda dev: dev.id)(jm.devices)
    got = multislice_ranks(range(8), MeshConfig(fsdp=f, model=m), slice_of=lambda r: r // per)
    np.testing.assert_array_equal(got, want)
    if per == 8:                               # one host: one slice, as make_mesh
        np.testing.assert_array_equal(got, multislice_ranks(range(8), MeshConfig(fsdp=f,
                                                                                 model=m)))


# -- every parameter's spec against JAX's ------------------------------------------

def _port_model(kind):
    from bioreason_tpu_torch import config as TC
    from bioreason_tpu_torch.models.fusion import init_fusion
    from bioreason_tpu_torch.train.lora import attach_lora
    cfg = TC.FusionConfig.tiny()
    if kind == "moe":
        cfg = dataclasses.replace(cfg, decoder=TC.DecoderConfig.tiny_moe())
    model = init_fusion(cfg, seed=0, device="cpu")
    attach_lora(model, TC.LoRAConfig(r=4, alpha=8), torch.Generator().manual_seed(0))
    return model


def _jax_path(name):
    """The JAX leaf path of a port parameter and whether its layout is the
    transposed one (an nn.Linear weight for a JAX kernel)."""
    parts = name.split(".")
    layer = len(parts) > 2 and parts[1] == "layers"
    path = (f"{parts[0]}/layers/{'/'.join(parts[3:-1])}" if layer else "/".join(parts[:-1]))
    leaf = parts[-1]
    if leaf == "weight":
        if path.endswith("embed"):
            return f"{path}/embedding", False, layer
        if re.search(r"experts/(gate|up|down)$", path):
            return path, False, layer
        return f"{path}/kernel", True, layer
    return f"{path}/{leaf}", False, layer


@pytest.mark.parametrize("kind,pp", [("fusion", False), ("moe", False), ("fusion", True)])
def test_param_specs_match_jax(kind, pp):
    """Per parameter: the port's spec (layer entry first for a per-layer
    parameter) equals its JAX leaf's spec padded to the leaf's rank, with
    the kernel's in / out swapped for an nn.Linear weight."""
    from bioreason_tpu.parallel import partition as JP
    from bioreason_tpu_torch.parallel import partition as TP
    model = _port_model(kind)
    jrules, trules = JP.partition_rules_fusion(pp=pp), TP.partition_rules_fusion(pp=pp)
    n = 0
    for name, p in model.named_parameters():
        path, transposed, layer = _jax_path(name)
        ndim = p.dim() + (1 if layer else 0)
        want = list(JP.spec_for_path(path, jrules))
        want += [None] * (ndim - len(want))
        if transposed:
            want[-2], want[-1] = want[-1], want[-2]
        got = list(TP.spec_for_path(name, trules))
        got += [None] * (ndim - len(got))
        assert got == want, (name, path)
        n += 1
    assert n > 40


def _int8_jax_path(name):
    """The JAX path of an int8 buffer's `{q, scale}` leaf (JAX quant.py:
    a quantized kernel, bank or embedding becomes a `{q, scale}` subtree)
    and whether the buffer is per-layer."""
    base = name.rsplit(".", 1)[0] + ".weight"
    path, _, layer = _jax_path(base)
    return f"{path}/{'q' if name.endswith('.weight') else 'scale'}", layer


@pytest.mark.parametrize("kind,embed", [("fusion", False), ("moe", False), ("fusion", True)])
def test_int8_buffer_specs_match_jax(kind, embed):
    """Every int8 buffer (QLoRA's frozen towers; with `embed` the serving /
    rollout tree, the embedding int8 too) gets its JAX leaf's spec: the
    anchored kernel rules match no path ending in `q` or `scale`, so JAX
    places them `P()`; the port's spec is all None at the buffer's rank
    (the layer entry included), while the float weight's rule, which the
    plan's tensor parallelism reads, still names 'model'."""
    from bioreason_tpu.parallel import partition as JP
    from jax.sharding import PartitionSpec
    from bioreason_tpu_torch.parallel import partition as TP
    from bioreason_tpu_torch.train.quant import quantize_frozen_int8
    model = quantize_frozen_int8(_port_model(kind), include_embed=embed)
    jrules, trules = JP.partition_rules_fusion(), TP.partition_rules_fusion()
    specs = TP.param_specs(model, trules, {"data": 1, "fsdp": 2, "model": 2})
    buffers = TP.int8_buffers(model)
    assert len(buffers) > 20 and ("decoder.embed.weight" in buffers) == embed
    split_by_rule = 0
    for name, b in buffers.items():
        path, layer = _int8_jax_path(name)
        assert JP.spec_for_path(path, jrules) == PartitionSpec(), path
        assert specs[name] == (None,) * (b.dim() + (1 if layer else 0)), name
        split_by_rule += "model" in TP.spec_for_path(name, trules)
    assert split_by_rule > 0


def _fake_topology(f, m, index=1):
    """This rank's axes of a (1, f, m) mesh without a process group (no
    collective runs): the plan slices and marks modules only."""
    from bioreason_tpu_torch.parallel.comm import Axis
    from bioreason_tpu_torch.parallel.mesh import Topology
    ax = lambda name, n: Axis(name, None, n, min(index, n - 1), tuple(range(n)))
    return Topology(ax("data", 1), ax("fsdp", f), ax("model", m), ax("dp", f))


@pytest.mark.parametrize("kind", ["fusion", "moe"])
def test_shard_plan_keeps_int8_whole_and_splits_its_compute(kind):
    """`ShardPlan.apply` at fsdp 2, model 2 on a QLoRA tree: every int8
    weight and scale is the same tensor as before (whole: no fsdp or model
    slice); the linears run tensor-parallel and the banks expert-parallel
    exactly where the float twin's are (`tp` kinds, `ep`), so the rank's
    heads (`local_heads`) agree with the q / k / v it computes; the
    adapters and other float leaves keep the float twin's placements."""
    from bioreason_tpu_torch import config as TC
    from bioreason_tpu_torch.parallel.partition import ShardPlan, int8_buffers
    from bioreason_tpu_torch.train.quant import quantize_frozen_int8
    dec = TC.DecoderConfig.tiny_moe() if kind == "moe" else TC.FusionConfig.tiny().decoder
    enc = TC.FusionConfig.tiny().encoder
    marks = {}
    for label in ("float", "int8"):
        model = _port_model(kind)
        if label == "int8":
            quantize_frozen_int8(model)
        before = int8_buffers(model)
        plan = ShardPlan(model, dec, _fake_topology(2, 2), encoder_cfg=enc)
        plan.apply(model)
        after = int8_buffers(model)
        assert set(after) == set(before)
        for name, t in after.items():
            assert t is before[name] and plan.placements[name] == [], name
        marks[label] = ({n: m.tp[0] for n, m in model.named_modules()
                         if getattr(m, "tp", None) is not None},
                        sorted(n for n, m in model.named_modules()
                               if getattr(m, "ep", None) is not None),
                        {n: pl for n, pl in plan.placements.items() if n not in after},
                        plan.partial_over_model)
    assert marks["int8"][0] == marks["float"][0] and len(marks["int8"][0]) > 8
    assert marks["int8"][1] == marks["float"][1] and (kind == "moe") == bool(marks["int8"][1])
    assert {n: marks["float"][2][n] for n in marks["int8"][2]} == marks["int8"][2]
    assert any(pl for pl in marks["int8"][2].values())
    assert marks["int8"][3] == marks["float"][3]


@pytest.mark.parametrize("spec,shape,sizes", [
    (("fsdp", "model"), (6, 8), (1, 2, 4)),
    (("fsdp", "model"), (8, 6), (1, 2, 4)),
    ((None, "model", "fsdp"), (2, 3, 64), (2, 2, 2)),
    ((("data", "fsdp"),), (12,), (2, 2, 2)),
    ((("data", "fsdp"),), (6,), (2, 2, 2)),
    (("model",), (0,), (1, 1, 8)),
])
def test_valid_spec_drops_as_jax(spec, shape, sizes):
    import jax
    from bioreason_tpu import config as JC
    from bioreason_tpu.parallel import make_mesh as jmake
    from bioreason_tpu.parallel.partition import _valid_spec as jvalid
    from jax.sharding import PartitionSpec
    from bioreason_tpu_torch.parallel.partition import _valid_spec
    d, f, m = sizes
    jm = jmake(JC.MeshConfig(data=d, fsdp=f, model=m), devices=jax.devices()[:d * f * m])
    want = tuple(jvalid(PartitionSpec(*spec), shape, jm))
    got = tuple(_valid_spec(spec, shape, {"data": d, "fsdp": f, "model": m}))
    assert got == want + (None,) * (len(got) - len(want))


@pytest.mark.parametrize("shape,data", [((8, 3), 2), ((3, 8), 4), ((3, 5), 2), ((16,), 1),
                                        ((2, 4), 4)])
def test_zero2_sharding_matches_jax(shape, data):
    import jax
    from bioreason_tpu import config as JC
    from bioreason_tpu.parallel import make_mesh as jmake
    from bioreason_tpu.parallel.partition import zero2_sharding as jz
    from bioreason_tpu_torch.parallel.partition import zero2_sharding
    jm = jmake(JC.MeshConfig(data=data), devices=jax.devices()[:data])
    want = tuple(jz(jax.ShapeDtypeStruct(shape, np.float32), jm).spec)
    got = tuple(zero2_sharding(shape, {"data": data}))
    assert got == want + (None,) * (len(got) - len(want))


# -- the DeviceMesh in a world of 4 ------------------------------------------------

def _mesh_world(rank, world, cases):
    from bioreason_tpu_torch.config import MeshConfig
    from bioreason_tpu_torch.parallel.mesh import MESH_AXES, make_mesh, topology
    out = []
    for c in cases:
        mesh = make_mesh(MeshConfig(*c), device="cpu")
        topo = topology(mesh)
        out.append({"mesh": mesh.mesh.numpy(), "names": tuple(mesh.mesh_dim_names),
                    "device": mesh.device_type, "axes": MESH_AXES,
                    "coords": [(getattr(topo, a).size, getattr(topo, a).index,
                                getattr(topo, a).ranks) for a in ("data", "fsdp", "model",
                                                                  "dp")]})
    return out


WORLD_MESHES = [(-1, 1, 1), (2, 2, 1), (1, 2, 2), (2, 1, 2), (1, 1, 4)]


@pytest.fixture(scope="module")
def mesh_world(tmp_path_factory):
    return spawn_world(_mesh_world, 4, tmp_path_factory.mktemp("mesh"), WORLD_MESHES)


@pytest.mark.parametrize("i", range(len(WORLD_MESHES)))
def test_device_mesh_and_axes_in_a_world_of_4(mesh_world, i):
    """The DeviceMesh's layout is `mesh_ranks`'; each rank's axes hold the
    ranks that share its other coordinates, and dp is data x fsdp."""
    from bioreason_tpu_torch.config import MeshConfig
    from bioreason_tpu_torch.parallel.mesh import mesh_ranks
    arr = mesh_ranks(range(4), MeshConfig(*WORLD_MESHES[i]))
    for rank, res in enumerate(mesh_world):
        r = res[i]
        np.testing.assert_array_equal(r["mesh"], arr)
        assert r["names"] == ("data", "fsdp", "model") == r["axes"] and r["device"] == "cpu"
        d, f, m = (int(x) for x in np.argwhere(arr == rank)[0])
        want = {"data": tuple(arr[:, f, m]), "fsdp": tuple(arr[d, :, m]),
                "model": tuple(arr[d, f, :]), "dp": tuple(arr[:, :, m].reshape(-1))}
        for (size, index, ranks), axis in zip(r["coords"], ("data", "fsdp", "model", "dp")):
            assert ranks == want[axis] and size == len(ranks) and ranks[index] == rank


def test_serve_cpu_devices_asks_for_the_cpu():
    """`serve --cpu_devices N` (JAX serve.py:406-408) is taken: the port's
    server is one process, so N > 0 asks for the CPU."""
    from bioreason_tpu_torch import serve
    assert serve.parse_args(["--cpu_devices", "2"]).device == "cpu"
    assert serve.parse_args([]).device == "cuda"


def test_train_sft_under_a_launchers_environment(tmp_path, monkeypatch):
    """RANK / WORLD_SIZE set (as torchrun sets them): the CLI joins that
    world by env:// (gloo on the CPU; NCCL on CUDA) and trains on its mesh;
    a world of one here, on a free localhost port."""
    import socket
    from bioreason_tpu_torch.cli import train_sft
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for key, value in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(key, value)
    out = train_sft.main(["--decoder", "tiny", "--encoder", "tiny", "--device", "cpu",
                          "--max_steps", "1", "--max_length_dna", "64", "--mesh", "1,1,1",
                          "--checkpoint_dir", str(tmp_path)])
    import math
    import torch.distributed as dist
    assert len(out.history) == 1 and math.isfinite(out.history[0]["loss"])
    assert not dist.is_initialized()          # the CLI's own world is torn down
