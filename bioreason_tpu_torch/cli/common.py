"""Shared CLI plumbing: model-size presets, the DNA tower's config and
dataset loading (the port's counterpart of bioreason_tpu/cli/common.py:
KEGG and the two ClinVar variant-effect tasks, with the DNA through the
tower or pasted as text)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from bioreason_tpu_torch.config import DecoderConfig, EncoderConfig, HyenaConfig
from bioreason_tpu_torch.data.char_tokenizer import CharDNATokenizer
from bioreason_tpu_torch.data.kegg import (format_kegg_for_dna_llm, format_kegg_for_llm,
                                           synthetic_kegg_items)
from bioreason_tpu_torch.data.nt_tokenizer import KmerTokenizer
from bioreason_tpu_torch.data.utils import split_dataset, truncate_dna
from bioreason_tpu_torch.data.variant_effect import (
    clean_variant_effect_example, clean_variant_effect_non_snv_example,
    format_variant_effect_for_dna_llm, format_variant_effect_for_llm)

DECODER_PRESETS = {"tiny": DecoderConfig.tiny, "qwen3-0.6b": DecoderConfig.qwen3_0_6b,
                   "qwen3-1.7b": DecoderConfig.qwen3_1_7b, "qwen3-4b": DecoderConfig.qwen3_4b}
ENCODER_PRESETS = {"tiny": EncoderConfig.tiny, "nt-50m": EncoderConfig.nt_v2_50m,
                   "nt-250m": EncoderConfig.nt_v2_250m, "nt-500m": EncoderConfig.nt_v2_500m}
HYENA_PRESETS = {"evo2-tiny": HyenaConfig.tiny, "evo2-1b": HyenaConfig.evo2_1b}
DATASET_TYPES = ("kegg", "variant_effect_coding", "variant_effect_non_snv")


def build_encoder_config(name: str, dna_embedding_layer: int = -1):
    """(encoder_kind, EncoderConfig, HyenaConfig or None, DNA tokenizer) of
    a DNA tower preset (common.py:32-50). An Evo2 preset brings the char
    tokenizer, the named-layer embedding tap `dna_embedding_layer` when it
    is >= 0 (reference --dna_embedding_layer, dna_llm.py:127-146) and an
    unused tiny EncoderConfig, as the JAX package builds it."""
    if name in HYENA_PRESETS:
        hy = HYENA_PRESETS[name]()
        if dna_embedding_layer >= 0:
            hy = dataclasses.replace(hy, embedding_tap_layer=dna_embedding_layer)
        return "evo2", EncoderConfig.tiny(), hy, CharDNATokenizer()
    return "nt", ENCODER_PRESETS[name](), None, KmerTokenizer()


def load_items(dataset_type: str, data_dir: Optional[str], n_synthetic: int,
               truncate_per_side: int, seed: int = 42, llm_only: bool = False,
               synthetic_seq_len: int = 512
               ) -> Tuple[List[Dict], List[Dict], List[Dict]]:
    """Load (a local JSON dir, else the synthetic KEGG corpus), clean,
    truncate, split 80/10/10 and chat-format the items (common.py:53-79):
    KEGG, or the coding / non-SNV variant-effect tasks, whose answers are
    cleaned as the reference cleans them; `llm_only` pastes the sequences
    into the question text."""
    if dataset_type not in DATASET_TYPES:
        raise ValueError(f"dataset_type {dataset_type!r}: expected one of {DATASET_TYPES}")
    if data_dir:
        from bioreason_tpu_torch.data.loaders import load_local_dataset
        raw = load_local_dataset(data_dir)
    else:
        raw = synthetic_kegg_items(n_synthetic, seq_len=synthetic_seq_len, seed=seed)
    if dataset_type == "kegg":
        fmt = format_kegg_for_llm if llm_only else format_kegg_for_dna_llm
    else:
        clean = (clean_variant_effect_example if dataset_type == "variant_effect_coding"
                 else clean_variant_effect_non_snv_example)
        raw = [clean(dict(x)) for x in raw]
        fmt = format_variant_effect_for_llm if llm_only else format_variant_effect_for_dna_llm
    raw = [truncate_dna(dict(x), truncate_per_side) for x in raw]
    train, val, test = split_dataset(raw, seed=seed)
    return [fmt(x) for x in train], [fmt(x) for x in val], [fmt(x) for x in test]


# -- the mesh (parallel/) ------------------------------------------------------

def add_mesh_flags(p) -> None:
    """--mesh and --cpu_devices (JAX cli/common.py:98-128)."""
    p.add_argument("--mesh", default=None,
                   help="'auto' | 'd,f,m' (data,fsdp,model) | 'multislice[:f,m]': train as one "
                        "rank of this mesh (parallel/mesh.py); unset: one device, no mesh")
    p.add_argument("--cpu_devices", type=int, default=0,
                   help="spawn N ranks on the CPU over gloo (an explicit ask for the CPU); "
                        "rank 0 alone writes checkpoints and logs")


def build_mesh(spec: Optional[str], device=None):
    """'auto' | 'd,f,m' | 'multislice[:f,m]' -> a DeviceMesh over the
    default process group."""
    from bioreason_tpu_torch.config import MeshConfig
    from bioreason_tpu_torch.parallel.mesh import make_mesh, make_multislice_mesh
    if spec in (None, "auto"):
        return make_mesh(MeshConfig(), device)
    if spec.startswith("multislice"):
        f, m = (int(x) for x in spec.split(":", 1)[1].split(",")) if ":" in spec else (1, 1)
        return make_multislice_mesh(MeshConfig(fsdp=f, model=m), device)
    d, f, m = (int(x) for x in spec.split(","))
    return make_mesh(MeshConfig(data=d, fsdp=f, model=m), device)


def _quiet(args) -> None:
    """A rank other than 0: no output, no logs, no profile (rank 0 writes)."""
    import os
    import sys
    sys.stdout = open(os.devnull, "w")
    for key in ("log_dir", "profile_dir"):
        if hasattr(args, key):
            setattr(args, key, None)


def _spawned(rank: int, world: int, store: str, fn, args, queue) -> None:
    import os
    import sys

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    if rank:
        _quiet(args)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        out = fn(args, build_mesh(args.mesh, "cpu"))
        if rank == 0:               # what the caller reads of a trainer
            import types
            queue.put(types.SimpleNamespace(**{
                k: getattr(out, k) for k in ("history", "metrics_history", "test_result")
                if hasattr(out, k)}))
    finally:
        dist.destroy_process_group()


def check_cards(local_world: int, local_rank: int, cards: int) -> None:
    """A launcher's ranks on this host against its CUDA cards: NCCL takes
    one rank per card, so more ranks than cards (or a local rank past the
    last card) raises, before any rank picks a card."""
    if local_world > cards or local_rank >= cards:
        raise RuntimeError(
            f"the launcher started {local_world} ranks on this host (local rank {local_rank}) "
            f"for {cards} CUDA card(s): NCCL takes one rank per card; start at most {cards} "
            f"ranks per host, or spawn CPU ranks with --cpu_devices N --device cpu")


def run_with_mesh(args, fn, wanted: bool = False):
    """fn(args, mesh) as the flags ask: `--cpu_devices N` spawns N gloo
    ranks on the CPU (returns rank 0's result, which must pickle); under a
    launcher (RANK / WORLD_SIZE set, e.g. torchrun) this process is one
    rank, over NCCL on CUDA, one rank per card (`check_cards`), or gloo
    on the CPU; `--mesh` alone (or
    `wanted`, e.g. sequence parallelism) makes a world of 1; otherwise
    fn(args, None)."""
    import os
    import tempfile

    import torch.distributed as dist
    if args.cpu_devices:
        import torch.multiprocessing as mp
        args.device = "cpu"
        ctx = mp.get_context("spawn")
        queue = ctx.Queue()
        store = os.path.join(tempfile.mkdtemp(prefix="mesh_store_"), "store")
        procs = [ctx.Process(target=_spawned, args=(r, args.cpu_devices, store, fn, args, queue))
                 for r in range(args.cpu_devices)]
        for proc in procs:
            proc.start()
        out = None
        while out is None:
            try:
                out = queue.get(timeout=1.0)
            except Exception:
                if any(p.exitcode not in (None, 0) for p in procs):
                    for p in procs:
                        p.kill()
                    raise RuntimeError("a spawned rank failed (its traceback is above)")
        for proc in procs:
            proc.join()
        return out
    if not (args.mesh is not None or wanted or "WORLD_SIZE" in os.environ):
        return fn(args, None)
    from bioreason_tpu_torch.utils.devices import resolve_device
    device = resolve_device(args.device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    own = not dist.is_initialized()
    if own and "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            import torch
            local_rank = int(os.environ.get("LOCAL_RANK", 0))
            check_cards(int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"])),
                        local_rank, torch.cuda.device_count())
            torch.cuda.set_device(local_rank)
        dist.init_process_group(backend, init_method="env://")
        if dist.get_rank():
            _quiet(args)
    elif own:
        store = os.path.join(tempfile.mkdtemp(prefix="mesh_store_"), "store")
        dist.init_process_group(backend, init_method=f"file://{store}", rank=0, world_size=1)
    try:
        return fn(args, build_mesh(args.mesh, device))
    finally:
        if own:
            dist.destroy_process_group()
