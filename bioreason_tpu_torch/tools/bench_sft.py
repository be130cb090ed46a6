"""SFT training throughput: the port of bench.py (bench.py:142-304).

bench.py's workload: an NT-v2-500M encoder (frozen) and a Qwen3 decoder
(`--decoder`, 151,936-token head) with weights from seed 0, LoRA r32/a64
over the decoder (no dropout, as bench.py's step draws none), the DNA
projection trained, AdamW at bench.py's settings; B=4 items of T=768 text
tokens, each holding 2 x 128 <|dna_pad|> placeholders after its first token
for 2 DNA sequences of 128 random 6-mer ids, the last 128 positions
supervised (labels gathered to them, ops/fused_ce.py), remat off
(`--remat full` recomputes each layer in the backward, `--remat dots`
keeps its dense products and recomputes the rest, as bench.py's policy).
`--frozen int8` is QLoRA: every dense of both towers stored int8 with
per-channel scales, the other frozen float leaves and the scales in bf16
(SFTConfig.frozen_dtype, train/quant.py); `--frozen bfloat16` stores the
frozen float leaves in bf16.

    python -m bioreason_tpu_torch.tools.bench_sft                     # on the card
    python -m bioreason_tpu_torch.tools.bench_sft --decoder qwen3-4b --frozen int8
    python -m bioreason_tpu_torch.tools.bench_sft --decoder tiny --encoder tiny --device cpu

The weights are drawn on the device (in fp32, stored in the towers' bf16
by `init_fusion`) and quantized there; `init_peak_gib` reports the peak of
that phase. After 2 warm-up steps it times --reps repetitions of
--steps steps (each repetition ends in a host sync) and prints one JSON
line: examples/s (`sft_examples_per_sec_per_chip`, the median repetition)
with every repetition's, ms per step, the device-busy ms and wall ms of one
profiled step (torch.profiler, on the card), the flash_fwd / flash_bwd
launches per timed step, the resident frozen GiB (every frozen parameter
and buffer), the peak device memory of the timed steps, and the card's name
and power limit (nvidia-smi). `main` returns the same numbers as a dict;
`run` also returns the trainer and the batch. It writes no file.

`--frozen int8` with `--encoder evo2-1b` is refused, as bench.py refuses
it. bench.py's `vs_baseline` (a ratio to an A100 figure) is left out.
"""

from __future__ import annotations

import json
import statistics
import time

B, T_TEXT, L_DNA, SUPERVISED = 4, 768, 128, 128


def parse_args(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=B)
    ap.add_argument("--remat", default="off", choices=["off", "full", "dots"])
    ap.add_argument("--grad_accum", type=int, default=1)
    ap.add_argument("--decoder", default="qwen3-0.6b",
                    choices=["qwen3-0.6b", "qwen3-1.7b", "qwen3-4b", "tiny"])
    ap.add_argument("--encoder", default="nt-500m", choices=["nt-500m", "evo2-1b", "tiny"])
    ap.add_argument("--frozen", default="bfloat16", choices=["bfloat16", "int8"])
    ap.add_argument("--ce_save", action="store_true",
                    help="the CE backward reuses stored bf16 chunk logits (ops/fused_ce.py)")
    ap.add_argument("--fuse", action="store_true",
                    help="fused qkv / gateup base weights (train/fuse.py); the adapters "
                         "stay per projection")
    ap.add_argument("--steps", type=int, default=10, help="timed steps per repetition")
    ap.add_argument("--reps", type=int, default=3, help="timed repetitions (the median)")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    if args.frozen == "int8" and args.encoder == "evo2-1b":
        raise SystemExit("--encoder evo2-1b supports bf16 frozen only (int8 tower "
                         "quantization targets the NT/Qwen dense layout)")
    return args


def build(args):
    """(SFTTrainer, batch, init peak bytes or None) of the bench's workload
    on args.device."""
    import dataclasses

    import numpy as np
    import torch

    from bioreason_tpu_torch.cli.common import DECODER_PRESETS, build_encoder_config
    from bioreason_tpu_torch.config import FusionConfig, LoRAConfig, OptimConfig, SFTConfig
    from bioreason_tpu_torch.ops.fused_ce import gather_label_positions
    from bioreason_tpu_torch.train.fuse import fuse_projections
    from bioreason_tpu_torch.train.sft import SFTTrainer
    from bioreason_tpu_torch.utils.devices import resolve_device

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    remat = args.remat != "off"
    policy = "dots" if args.remat == "dots" else "full"
    kind, enc, hyena, _ = build_encoder_config(args.encoder)
    # the published vocabulary, with bench.py's placeholder id past it (the
    # embedding clamps it; the splice overwrites those rows); `tiny` takes
    # the byte tokenizer's
    tiny = args.decoder == "tiny"
    vocab, pad_id, text_hi = (300, 260, 256) if tiny else (151936, 151938, 150000)
    dec = dataclasses.replace(DECODER_PRESETS[args.decoder](vocab_size=vocab), remat=remat,
                              remat_policy=policy)
    if kind == "evo2":
        hyena = dataclasses.replace(hyena, remat=remat)
    else:
        enc = dataclasses.replace(enc, remat=remat, remat_policy=policy)
    cfg = FusionConfig(decoder=dec, encoder=enc, hyena=hyena, encoder_kind=kind,
                       dna_pad_token_id=pad_id,
                       ce_save_logits=args.ce_save)
    lora = LoRAConfig(r=32, alpha=64, dropout=0.0)
    sft = SFTConfig(batch_size=args.batch, grad_accum_steps=args.grad_accum, lora=lora,
                    frozen_dtype=args.frozen, optim=OptimConfig(total_steps=100), seed=0)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    trainer = SFTTrainer(cfg, sft, device=device)
    if args.fuse:
        # after the trainer's set-up; the adapters move to `Adapter`s as
        # they are, the fused base weights are new and frozen
        fuse_projections(trainer.model)
        trained = {id(p) for p in trainer.params}
        for p in trainer.model.parameters():
            p.requires_grad_(id(p) in trained)
    init_peak = torch.cuda.max_memory_allocated() if cuda else None

    b = args.batch
    npr = np.random.default_rng(0)
    input_ids = npr.integers(0, text_hi, (b, T_TEXT)).astype(np.int32)
    for i in range(b):
        input_ids[i, 1:1 + 2 * L_DNA] = cfg.dna_pad_token_id
    hi = 256 if kind == "evo2" else 4102            # char vs 6-mer vocab
    labels = np.where(np.arange(T_TEXT)[None] >= T_TEXT - SUPERVISED, input_ids, -100)
    pos, tgt, val = gather_label_positions(labels)
    batch = {"input_ids": input_ids, "attention_mask": np.ones((b, T_TEXT), np.int32),
             "dna_input_ids": npr.integers(6, hi, (2 * b, L_DNA)).astype(np.int32),
             "dna_attention_mask": np.ones((2 * b, L_DNA), np.int32),
             "label_positions": pos, "label_targets": tgt, "label_valid": val}
    return trainer, batch, init_peak


def run(args):
    """(result dict, trainer, batch): the timed run, printing nothing."""
    import torch

    from bioreason_tpu_torch.ops import flash_attention as fa
    from bioreason_tpu_torch.tools.bench_classifier import busy_ms
    from bioreason_tpu_torch.tools.bench_serve import card_name
    from bioreason_tpu_torch.train.quant import storage_bytes

    trainer, batch, init_peak = build(args)
    cuda = trainer.device.type == "cuda"
    b = args.batch
    for _ in range(2):
        m = trainer.train_step(batch)                # its metrics sync with the host
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    launches0 = (fa.flash_attention.launches, fa.flash_bwd.launches)
    rates = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        for _ in range(args.steps):
            m = trainer.train_step(batch)
        if cuda:
            torch.cuda.synchronize()
        rates.append(b * args.steps / (time.perf_counter() - t0))
    n = args.reps * args.steps
    per_step = {"flash_fwd": (fa.flash_attention.launches - launches0[0]) / n,
                "flash_bwd": (fa.flash_bwd.launches - launches0[1]) / n}
    peak = torch.cuda.max_memory_allocated() if cuda else None
    busy = wall = None
    if cuda:
        busy, wall = busy_ms(torch, lambda: trainer.train_step(batch))
    rate = statistics.median(rates)
    gib = 2 ** 30
    result = {
        "metric": "sft_examples_per_sec_per_chip", "value": rate, "unit": "examples/s",
        "repetitions": rates, "ms_per_step": 1e3 * b / rate, "B": b, "T": T_TEXT,
        "dna": [2 * b, L_DNA], "decoder": args.decoder, "encoder": args.encoder,
        "frozen": args.frozen, "remat": args.remat, "fuse": args.fuse,
        "grad_accum": args.grad_accum, "ce_save": args.ce_save,
        "steps_per_repetition": args.steps, "loss": m["loss"],
        "trainable_params": sum(p.numel() for p in trainer.params),
        "launches_per_step": per_step,
        "profiled_step_busy_ms": busy, "profiled_step_wall_ms": wall,
        "resident_frozen_gib": (storage_bytes(trainer.model) - sum(
            p.numel() * p.element_size() for p in trainer.params)) / gib,
        "peak_gib": peak / gib if cuda else None,
        "init_peak_gib": init_peak / gib if cuda else None,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "card": card_name() if cuda else None}
    return result, trainer, batch


def main(argv=None) -> dict:
    result, _, _ = run(parse_args(argv))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
