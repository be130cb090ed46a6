"""Partition rules for the port's parameters, and their execution (the port
of bioreason_tpu/parallel/partition.py).

The rules are (regex, spec) pairs matched against the port's parameter
names (`decoder.layers.3.attn.q.weight`), first match wins. A spec is a
`P` tuple with one entry per dim: a mesh axis name or None. Where the JAX
package stacks a tower's layers [L, ...], a per-layer parameter's spec
carries that layer axis as its first entry, so every rule reads as its JAX
counterpart: an `nn.Linear` weight is [out, in] where JAX's kernel is
[in, out], so colwise (q/k/v/gate/up) is `model` on dim 0 and rowwise
(o/down) `model` on dim 1; adapters and expert banks keep JAX's layout.
`tests/test_torch_mesh.py` holds every parameter's spec to JAX's.

Execution (`ShardPlan`) is explicit, as torch gives no GSPMD:
  * `fsdp` entries: the rank stores its slice of the parameter along that
    dim, and the module that holds it is marked (`mod.fsdp` = (axis,
    {leaf: dim})). `layer_gathered(module)` all-gathers one module's
    slices (a tower layer, a table, the projection) for as long as that
    module runs and puts the shards back after it, as each iteration of
    JAX's layer scan gathers that layer's slice under GSPMD: the towers'
    layer loops, `layers.embed`, `layers.lm_logits`, the CE and logp
    passes' head and `fusion.project_dna` each open one. A trainable
    slice is gathered by `comm.all_gather_sum`, whose backward
    reduce-scatters that use's gradient; what the backward needs of a
    gathered weight is gathered again then (`comm.regathered_saves`), or
    by the layer's remat, which recomputes the gather with the layer. So a
    rank holds one or two layers gathered at a time, never the model.
    `GATHERED` counts the gathered bytes alive on the rank.
    `layer_gathered(model)` over the whole tree gathers every slice at
    once for a whole call: the generation engine's, whose decode steps
    would otherwise gather each layer once per token (generate/engine.py);
  * `model` entries of the decoder's layers, and of the NT encoder's
    (`encoder_cfg`): Megatron tensor parallelism on local shards. Colwise
    linears hold Hq/m, Hkv/m heads or I/m MLP rows, rowwise ones the
    matching input columns; `layers.dense` adds `comm.copy_to` /
    `comm.reduce_from` around them (`tp_dense`), so each rank's attention
    is the unchanged kernel on its own heads. Biases keep JAX's `P()`: a
    colwise bias is stored whole and each rank adds its slice of the
    output rows (its gradient is then a partial sum over `model`,
    `partial_over_model`); a rowwise bias is added once, after the sum. A
    layer whose head counts (or MLP width) do not divide by the axis keeps
    that block replicated, as `_valid_spec` drops an axis that does not
    divide;
  * `model` on an expert bank's E axis: expert parallelism; each rank runs
    its E/m experts on all tokens and the combine sums over `model`
    (`layers.moe_apply`), with JAX's capacity and drops;
  * `model` on the vocabulary rows of the decoder's tables
    (`decoder.embed.weight`, and `decoder.lm_head.weight` where the config
    unties it): each rank holds V/m rows (`tp` = ("vocab", axis));
    `layers.embed` looks up its own rows and sums over the axis,
    `layers.lm_logits` gathers its V/m logit columns, and the chunked CE
    and logp passes (ops/fused_ce.py) combine the ranks' LSE, so no rank
    builds [N, V] logits;
  * `model` on the DNA projection's output rows (either tower): colwise
    (`layers.tp_dense`), its output gathered whole (`fusion.encode_dna`);
    its bias stays `P()`, a colwise bias;
  * the NT tower stays replicated over `model` when sequence parallelism
    shards its sequence over `model` (an `sp*` attention) or GPipe stages
    hold the axis; the Evo2 tower's parameters (`encoder.blocks.*`) match
    no `model` rule, as in JAX. Under GPipe the tables are replicated, as
    JAX's `partition_rules_fusion(pp=True)` gives them, and so is the
    projection, which the first stage alone runs;
  * under pipeline parallelism (`pp=True`) a decoder layer's leading
    `model` entry is its stage: a rank keeps only its stage's layers;
  * int8 storage (train/quant.py: an int8 `weight` buffer and its `scale`
    buffer): JAX's int8 leaves are `{q, scale}` subtrees whose paths end
    in `kernel/q`, `kernel/scale` or `experts/<bank>/q`, which no anchored
    rule matches, so they fall to `P()` and every device holds them whole.
    `param_specs` gives the buffers that `P()` and `ShardPlan` stores them
    whole on every rank, but it decides tensor and expert parallelism by
    the float weight's rule all the same: a colwise int8 linear computes on
    its rank's rows of the replicated weight and scale, a rowwise one on
    its rank's input columns, an int8 bank on its rank's E/m experts, an
    int8 table (the rollout copy's or a server's) on its rank's V/m rows
    (`layers.tp_dense`, `layers.bank_product`, `layers.vocab_rows`).
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.multiprocessing.reductions import StorageWeakRef

from bioreason_tpu_torch.parallel import comm


class P(tuple):
    """A partition spec: one mesh axis name (or a tuple of names, or None)
    per dim, as jax.sharding.PartitionSpec."""

    def __new__(cls, *entries):
        return tuple.__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


Rules = List[Tuple[str, P]]
_LAYER = r"layers\.\d+\."


def partition_rules_decoder(prefix: str = "") -> Rules:
    p = re.escape(prefix) + _LAYER
    return [
        (re.escape(prefix) + r"embed\.weight$", P("model", "fsdp")),
        (re.escape(prefix) + r"lm_head\.weight$", P("model", "fsdp")),
        (p + r"attn\.(q|k|v)\.lora_a$", P(None, "fsdp", None)),
        (p + r"attn\.(q|k|v)\.lora_b$", P(None, None, "model")),
        (p + r"attn\.o\.lora_a$", P(None, "model", None)),
        (p + r"attn\.o\.lora_b$", P(None, None, "fsdp")),
        (p + r"mlp\.(gate|up)\.lora_a$", P(None, "fsdp", None)),
        (p + r"mlp\.(gate|up)\.lora_b$", P(None, None, "model")),
        (p + r"mlp\.down\.lora_a$", P(None, "model", None)),
        (p + r"mlp\.down\.lora_b$", P(None, None, "fsdp")),
        (p + r"attn\.(q|k|v)\.weight$", P(None, "model", "fsdp")),
        (p + r"attn\.o\.weight$", P(None, "fsdp", "model")),
        (p + r"mlp\.(gate|up)\.weight$", P(None, "model", "fsdp")),
        (p + r"mlp\.down\.weight$", P(None, "fsdp", "model")),
        # MoE: expert parallelism, E over 'model', the hidden dim over 'fsdp'
        (p + r"mlp\.experts\.(gate|up)\.weight$", P(None, "model", "fsdp", None)),
        (p + r"mlp\.experts\.down\.weight$", P(None, "model", None, "fsdp")),
        (re.escape(prefix) + r".*(scale|bias)$", P()),
        (re.escape(prefix) + r".*", P()),
    ]


def partition_rules_encoder(prefix: str = "") -> Rules:
    p = re.escape(prefix) + _LAYER
    return [
        (re.escape(prefix) + r"embed\.weight$", P(None, "fsdp")),
        (p + r"attn\.(q|k|v)\.weight$", P(None, "model", "fsdp")),
        (p + r"attn\.o\.weight$", P(None, "fsdp", "model")),
        (p + r"mlp\.(gate|up)\.weight$", P(None, "model", "fsdp")),
        (p + r"mlp\.down\.weight$", P(None, "fsdp", "model")),
        (re.escape(prefix) + r".*(scale|bias)$", P()),
        (re.escape(prefix) + r".*", P()),
    ]


def partition_rules_fusion(pp: bool = False) -> Rules:
    """pp=True: each decoder layer belongs to one GPipe stage on 'model'
    (its leading layer entry), and the embedding table is replicated (JAX
    partition.py:71-97). Without it the tables and the projection are
    split over 'model' (`SPLIT_OUTSIDE_LAYERS`)."""
    decoder_rules = ([(r"^decoder\." + _LAYER + ".*", P("model"))] if pp
                     else partition_rules_decoder("decoder."))
    return (decoder_rules
            + ([(r"^decoder\.embed\.weight$", P()),
                (r"^decoder\.lm_head\.weight$", P(None, "fsdp"))] if pp else [])
            + partition_rules_encoder("encoder.")
            + [(r"dna_projection\.weight$", P("model", "fsdp")),
               (r"dna_projection\.bias$", P()),
               (r".*", P())])


# the parameters outside the towers' layers whose `model` entry `ShardPlan`
# executes (JAX partition.py:32-33,94): the vocabulary tables by rows, the
# DNA projection by its output rows
VOCAB_TABLES = ("decoder.embed.weight", "decoder.lm_head.weight")
SPLIT_OUTSIDE_LAYERS = VOCAB_TABLES + ("dna_projection.weight",)


def spec_for_path(path_str: str, rules: Rules) -> P:
    for pattern, spec in rules:
        if re.search(pattern, path_str):
            return spec
    return P()


def is_layer_param(name: str) -> bool:
    """Whether `name` is a per-layer parameter of a tower JAX stacks."""
    return re.search(r"^(decoder|encoder)\." + _LAYER, name) is not None


def _valid_spec(spec: Sequence, shape: Sequence[int], mesh_shape: Dict[str, int]) -> P:
    """Drop sharding on axes that don't divide evenly (tiny test shapes)."""
    out = []
    for i, names in enumerate(spec):
        if names is None:
            out.append(None)
            continue
        axis_names = names if isinstance(names, tuple) else (names,)
        size = 1
        for a in axis_names:
            size *= mesh_shape[a]
        out.append(names if i < len(shape) and shape[i] % size == 0 and shape[i] > 0 else None)
    return P(*out)


def batch_spec() -> P:
    """Batch arrays: the leading (batch) dim over data + fsdp."""
    return P(("data", "fsdp"))


def zero2_sharding(shape: Sequence[int], mesh_shape: Dict[str, int]) -> P:
    """ZeRO-2: an optimizer-state leaf sharded over 'data' on the first
    dim that the data size divides (JAX partition.py:158-172)."""
    dp = mesh_shape["data"]
    names = [None] * len(shape)
    if dp > 1:
        for i, s in enumerate(shape):
            if s % dp == 0 and s >= dp:
                names[i] = "data"
                break
    return P(*names)


def int8_buffers(model: nn.Module) -> Dict[str, torch.Tensor]:
    """name -> tensor of every int8 storage buffer: the int8 `weight` of a
    linear, an embedding or an expert bank and its `scale`."""
    out = {}
    for mod_name, mod in model.named_modules():
        w = mod._buffers.get("weight")
        if w is not None and w.dtype == torch.int8:
            prefix = f"{mod_name}." if mod_name else ""
            out[prefix + "weight"] = w
            out[prefix + "scale"] = mod._buffers["scale"]
    return out


def _stacked_shape(model: nn.Module, name: str, t: torch.Tensor) -> Tuple[int, ...]:
    """t's shape in the stacked view: the tower's layer count first for a
    per-layer tensor."""
    shape = tuple(t.shape)
    if is_layer_param(name):
        shape = (len(getattr(model, name.split(".")[0]).layers),) + shape
    return shape


def _padded(spec: Sequence, ndim: int) -> P:
    return P(*(tuple(spec) + (None,) * (ndim - len(spec))))


def param_specs(model: nn.Module, rules: Rules, mesh_shape: Dict[str, int]) -> Dict[str, P]:
    """Every parameter's valid spec in the stacked view (layer entry first
    for per-layer parameters; the layer count is the tower's), and every
    int8 buffer's: `P()`, as JAX's `{q, scale}` leaves get (module
    docstring)."""
    out = {}
    for name, p in model.named_parameters():
        shape = _stacked_shape(model, name, p)
        out[name] = _valid_spec(_padded(spec_for_path(name, rules), len(shape)), shape,
                                mesh_shape)
    for name, b in int8_buffers(model).items():
        out[name] = _padded((), len(_stacked_shape(model, name, b)))
    return out


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

def _module(model: nn.Module, name: str) -> Tuple[nn.Module, str]:
    path, leaf = name.rsplit(".", 1)
    return model.get_submodule(path), leaf


def _tp_ok(cfg, name: str, m: int, encoder: bool = False) -> bool:
    """Whether a decoder layer parameter's block divides over m model
    ranks along whole heads, MLP rows or experts; with `encoder`, an NT
    encoder layer's (`cfg` an EncoderConfig: heads and MLP rows)."""
    if encoder:
        if ".attn." in name:
            return cfg.num_heads % m == 0
        return ".mlp." in name and cfg.intermediate_size % m == 0
    if ".attn." in name:
        return cfg.num_heads % m == 0 and cfg.num_kv_heads % m == 0
    if ".experts." in name:
        return cfg.num_experts % m == 0
    if ".mlp." in name:
        return not cfg.num_experts and cfg.intermediate_size % m == 0
    return False


def local_heads(cfg, run=None) -> Tuple[int, int]:
    """(Hq, Hkv) of the decoder's attention on this rank of `run` (a
    `trainer.MeshRun`, or None for one device): Hq/m and Hkv/m under
    tensor parallelism, every head where the heads do not divide over the
    m model ranks (`_tp_ok` leaves the attention replicated) or the model
    axis holds pipeline stages."""
    m = 1 if run is None or run.pp else run.topo.model.size
    if m > 1 and _tp_ok(cfg, ".attn.", m):
        return cfg.num_heads // m, cfg.num_kv_heads // m
    return cfg.num_heads, cfg.num_kv_heads


def encoder_local_heads(cfg, run=None) -> int:
    """The NT encoder's attention heads on this rank of `run` (None: one
    device): cfg.num_heads / m where the run's plan splits the tower over
    its m model ranks (`ShardPlan.tower_tp`), else every head."""
    if run is None or not run.plan.tower_tp:
        return cfg.num_heads
    m = run.topo.model.size
    return cfg.num_heads // m if _tp_ok(cfg, ".attn.", m, encoder=True) else cfg.num_heads


class ShardPlan:
    """How one rank stores and runs a model under a mesh (`topology`);
    `apply` is the counterpart of JAX's `shard_params`.

    `placements[name]` lists (axis, dim) in the order the parameter was
    sliced: `model` first, then `fsdp` (none for an int8 buffer, stored
    whole). `model_dims[name]` is the dim of a weight run tensor, vocab
    or expert parallel that 'model' splits: in storage for a float weight, at use
    for an int8 one, whose float rule decides it. `stage_layers` is the
    range of decoder layers this rank runs under pipeline parallelism
    (None without). `encoder_cfg`: the NT encoder's config, whose layers then
    run tensor-parallel over `model` (`tower_tp`) unless its attention is
    sequence-parallel (`sp*`) or the axis holds GPipe stages; None (an
    Evo2 tower, or no tower) leaves the tower replicated."""

    def __init__(self, model: nn.Module, decoder_cfg, topo, pp: bool = False,
                 encoder_cfg=None):
        self.topo = topo
        self.pp = pp
        sizes = {"data": topo.data.size, "fsdp": topo.fsdp.size, "model": topo.model.size}
        self.mesh_shape = sizes
        rules = partition_rules_fusion(pp)
        self.specs = param_specs(model, rules, sizes)
        int8 = int8_buffers(model)
        m = topo.model.size
        self.placements: Dict[str, List[Tuple[str, int]]] = {}
        self.model_dims: Dict[str, int] = {}
        self.stage_layers: Optional[range] = None
        if pp:
            n = decoder_cfg.num_layers
            if n % m:
                raise ValueError(f"num_layers {n} not divisible by {m} stages")
            s = n // m
            self.stage_layers = range(topo.model.index * s, (topo.model.index + 1) * s)
        self.tower_tp = (encoder_cfg is not None and m > 1 and not pp
                         and not str(encoder_cfg.attention_impl).startswith("sp"))
        for name, spec in self.specs.items():
            if name in int8:           # whole on every rank; TP by the float rule
                shape = _stacked_shape(model, name, int8[name])
                spec = _valid_spec(_padded(spec_for_path(name, rules), len(shape)), shape,
                                   sizes)
            dims = spec[1:] if is_layer_param(name) else spec
            if name.startswith("encoder.layers."):
                tp = self.tower_tp and _tp_ok(encoder_cfg, name, m, encoder=True)
            elif name.startswith("decoder.layers."):
                tp = not pp and _tp_ok(decoder_cfg, name, m)
            else:                       # a dim 'model' does not divide has no entry
                tp = not pp and name in SPLIT_OUTSIDE_LAYERS
            if "model" in dims and m > 1 and tp:
                self.model_dims[name] = dims.index("model")
            place = []
            if name not in int8:
                if name in self.model_dims:
                    place.append(("model", self.model_dims[name]))
                if "fsdp" in dims and topo.fsdp.size > 1:
                    place.append(("fsdp", dims.index("fsdp")))
            self.placements[name] = place
        # replicated parameters that act on a tensor-parallel rank's own heads
        # or rows (the per-head q / k norms, a colwise linear's bias): each
        # rank's gradient covers its own
        self.partial_over_model = {
            n for n in self.placements
            if (re.search(r"\.attn\.(q|k)_norm\.scale$", n)
                and n.rsplit(".attn.", 1)[0] + ".attn.q.weight" in self.model_dims)
            or (n.endswith(".bias") and self.model_dims.get(n[:-len("bias")] + "weight") == 0)}

    def axis(self, name: str) -> comm.Axis:
        return getattr(self.topo, name)

    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's piece of the full tensor of parameter `name`."""
        for ax, dim in self.placements[name]:
            full = comm.local_slice(full, self.axis(ax), dim)
        return full.contiguous()

    def unshard(self, name: str, piece: torch.Tensor) -> torch.Tensor:
        """The full tensor of `name` from every rank's piece (a collective)."""
        for ax, dim in reversed(self.placements[name]):
            piece = comm.all_gather(piece, self.axis(ax), dim)
        return piece

    @torch.no_grad()
    def apply(self, model: nn.Module) -> None:
        """Slice every parameter to this rank's piece, drop the layers of
        other stages, and mark the tensor / expert parallel modules."""
        if self.stage_layers is not None:
            layers = model.decoder.layers
            for i in range(len(layers)):
                if i not in self.stage_layers:
                    layers[i] = nn.Module()          # another stage's layer
        for name, p in list(model.named_parameters()):
            if not self.placements.get(name):
                continue
            mod, leaf = _module(model, name)
            mod._parameters[leaf] = nn.Parameter(self.shard(name, p.data),
                                                 requires_grad=p.requires_grad)
            dims = [d for ax, d in self.placements[name] if ax == "fsdp"]
            if dims:
                axis, marked = getattr(mod, "fsdp", (self.topo.fsdp, {}))
                mod.fsdp = (axis, {**marked, leaf: dims[0]})
        model_axis = self.topo.model
        for name, dim in self.model_dims.items():
            if not name.endswith(".weight"):
                continue
            mod, _ = _module(model, name)
            if ".experts." in name:
                model.get_submodule(name.rsplit(".experts.", 1)[0]).experts.ep = model_axis
            elif name in VOCAB_TABLES:
                mod.tp = ("vocab", model_axis)
            else:
                mod.tp = ("col" if dim == 0 else "row", model_axis)

    def gather_sizes(self, model: nn.Module) -> Dict[str, int]:
        """The bytes each per-layer gather holds on this rank, reckoned from
        the placements in the stored dtypes: a tower layer's fsdp-sharded
        parameters together (keyed by the layer's prefix), every other one
        alone (keyed by its name). Their sum is what a whole gather holds.
        Call it with the shards in place."""
        f = self.topo.fsdp.size
        out: Dict[str, int] = {}
        for name, p in model.named_parameters():
            if not any(ax == "fsdp" for ax, _ in self.placements.get(name, [])):
                continue
            layer = re.match(r"^(decoder|encoder)\." + _LAYER, name)
            key = layer.group(0) if layer else name
            out[key] = out.get(key, 0) + p.numel() * f * p.element_size()
        return out


class GatherMeter:
    """The bytes of fsdp-gathered parameters alive on this rank: every
    tensor a gather puts in a module's place (`layer_gathered`) or makes
    again for a backward
    (`comm.regathered_saves`), counted by storage while it lives. `high`
    is the most alive at once since `reset`."""

    def __init__(self):
        self.live: List[Tuple[StorageWeakRef, int]] = []
        self.high = 0

    def alive(self) -> int:
        self.live = [(r, n) for r, n in self.live if not r.expired()]
        return sum(n for _, n in self.live)

    def add(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        self.live.append((StorageWeakRef(storage), storage.nbytes()))
        self.high = max(self.high, self.alive())

    def reset(self) -> None:
        self.high = self.alive()


GATHERED = GatherMeter()


def fsdp_leaves(module: nn.Module):
    """(module, leaf, axis, dim) of every fsdp-sharded parameter of `module`
    and its submodules that holds its shard now (`ShardPlan.apply` marks
    them; a whole gather's tensor in a shard's place is left alone)."""
    for mod in module.modules():
        axis, dims = getattr(mod, "fsdp", (None, {}))
        for leaf, dim in dims.items():
            if isinstance(mod._parameters.get(leaf), nn.Parameter):
                yield mod, leaf, axis, dim


@contextlib.contextmanager
def layer_gathered(module: nn.Module, dtype: Optional[torch.dtype] = None,
                   regather: bool = True):
    """Context: `module`'s fsdp-sharded parameters all-gathered in place of
    their shards, which are back on exit. A trainable one goes through
    `comm.all_gather_sum`, whose backward reduce-scatters this use's
    gradient. `dtype`: the gathered floats are cast to it (with autograd)
    once, the dtype the module computes in, so a call's `.to(dtype)` makes
    no second full-size copy. `regather`: while autograd records, the
    tensors saved for the backward that view a gathered parameter are
    kept as handles and gathered again by the backward
    (`comm.regathered_saves`); a layer whose remat recomputes it in the
    backward passes False, since its recompute gathers again itself. A
    module with nothing sharded (one device, a whole gather live) runs
    as it is."""
    saved, registry = [], {}
    for mod, leaf, axis, dim in list(fsdp_leaves(module)):
        p = mod._parameters[leaf]
        full = comm.all_gather_sum(p, axis, dim) if p.requires_grad else comm.all_gather(
            p, axis, dim)
        if dtype is not None and full.is_floating_point():
            full = full.to(dtype)
        GATHERED.add(full)
        registry[comm.storage_key(full)] = comm.Gathered(p, axis, dim, full.dtype)
        saved.append((mod, leaf, p))
        mod._parameters[leaf] = full
    hooks = (comm.regathered_saves(registry, GATHERED.add)
             if regather and registry and torch.is_grad_enabled()
             else contextlib.nullcontext())
    try:
        with hooks:
            yield
    finally:
        for mod, leaf, p in saved:
            mod._parameters[leaf] = p

