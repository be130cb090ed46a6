"""GRPO step throughput (rollout, rewards, ref logps, update): the port of
bench_grpo.py.

bench_grpo.py's workload: an NT-v2-500M encoder (`--encoder nt-50m`: the
rehearsal's NT-v2-50M) and a Qwen3 decoder (`--decoder`) at the byte
tokenizer's vocabulary with weights from seed 0,
LoRA r32/a64, --prompts synthetic KEGG prompts of 2 x 600 bp (DNA cut to
128 tokens) x G = --G completions of --new tokens sampled, beta 0.04 (so
the reference logps run every step), lr 5e-6, the decoder's remat by
--remat (full by default, `dots` keeps the dense products; the
encoder's off). `--frozen int8` is QLoRA
(GRPOConfig.frozen_dtype); `--rollout_int8` rolls out on int8 weights,
embedding and head, sharing the training model's int8 denses where it has
them.

    python -m bioreason_tpu_torch.tools.bench_grpo                      # on the card
    python -m bioreason_tpu_torch.tools.bench_grpo --decoder qwen3-4b --frozen int8 \\
        --rollout_int8 --probe
    python -m bioreason_tpu_torch.tools.bench_grpo --decoder tiny --encoder tiny \\
        --device cpu --new 8

After one warm-up step it times --steps steps and prints one JSON line:
completions/s (`grpo_full_step_completions_per_sec_per_chip`), seconds
per step, the flash_fwd / flash_bwd launches per timed step, with --probe
the trainer's host timers by phase (prep / rollout / logps_dispatch /
rewards / update), the last step's loss, kl and reward, the peak device
memory, and the card's name and power limit (nvidia-smi). `main` returns
the same numbers as a dict; `run` also returns the trainer and its items.
It writes no file.
"""

from __future__ import annotations

import json
import time


def parse_args(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rollout_int8", action="store_true",
                    help="roll out on int8 weights, embedding and head")
    ap.add_argument("--decoder", default="qwen3-0.6b",
                    choices=["qwen3-0.6b", "qwen3-1.7b", "qwen3-4b", "tiny"])
    ap.add_argument("--encoder", default="nt-500m", choices=["nt-500m", "nt-50m", "tiny"])
    ap.add_argument("--accum", type=int, default=1,
                    help="micro-steps per optimizer update (GRPOConfig.grad_accum_steps)")
    ap.add_argument("--frozen", default="bfloat16", choices=["bfloat16", "int8"],
                    help="frozen-tower storage of the training model (GRPOConfig.frozen_dtype)")
    ap.add_argument("--prompts", type=int, default=4)
    ap.add_argument("--G", type=int, default=4)
    ap.add_argument("--new", type=int, default=64, help="completion tokens sampled")
    ap.add_argument("--steps", type=int, default=5, help="timed steps")
    ap.add_argument("--remat", default="full", choices=["off", "full", "dots"],
                    help="the decoder's remat in the update pass")
    ap.add_argument("--probe", action="store_true",
                    help="the trainer's host timers by phase in the line")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    return args


def build(args):
    """(GRPOTrainer, G-repeated items) of the bench's workload."""
    import dataclasses

    from bioreason_tpu_torch.cli.common import DECODER_PRESETS, ENCODER_PRESETS
    from bioreason_tpu_torch.config import (FusionConfig, GRPOConfig, LoRAConfig, OptimConfig,
                                            SamplingConfig)
    from bioreason_tpu_torch.data import BioProcessor, ByteTextTokenizer, KmerTokenizer
    from bioreason_tpu_torch.data.kegg import format_kegg_prompt_only, synthetic_kegg_items
    from bioreason_tpu_torch.train.grpo import GRPOTrainer
    from bioreason_tpu_torch.train.rewards import get_reward_funcs

    tok = ByteTextTokenizer()
    fusion = FusionConfig(
        decoder=dataclasses.replace(DECODER_PRESETS[args.decoder](vocab_size=tok.vocab_size),
                                    remat=args.remat != "off",
                                    remat_policy="dots" if args.remat == "dots" else "full"),
        encoder=dataclasses.replace(ENCODER_PRESETS[args.encoder](), remat=False),
        dna_pad_token_id=tok.dna_pad_id, max_length_text=512, max_length_dna=128)
    cfg = GRPOConfig(
        num_generations=args.G, batch_size=args.prompts * args.G, beta=0.04,
        rollout_int8=args.rollout_int8,
        grad_accum_steps=args.accum, frozen_dtype=args.frozen,
        max_completion_length=args.new, sampling=SamplingConfig(max_new_tokens=args.new),
        optim=OptimConfig(learning_rate=5e-6, total_steps=100),
        lora=LoRAConfig(r=32, alpha=64), seed=0)
    trainer = GRPOTrainer(fusion, cfg, BioProcessor(tok, KmerTokenizer()),
                          get_reward_funcs(["xmlcount", "correctness"]), device=args.device)
    items = [format_kegg_prompt_only(it)
             for it in synthetic_kegg_items(args.prompts, seq_len=600, seed=0)]
    return trainer, [p for p in items for _ in range(args.G)]


def run(args):
    """(result dict, trainer, items): the timed run, printing nothing."""
    import torch

    from bioreason_tpu_torch.ops import flash_attention as fa
    from bioreason_tpu_torch.tools.bench_serve import card_name

    trainer, items = build(args)
    cuda = trainer.device.type == "cuda"
    trainer.step(items)                                   # warm-up
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    if args.probe:
        trainer.timers = {}
    launches0 = (fa.flash_attention.launches, fa.flash_bwd.launches)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        m = trainer.step(items)                           # its metrics sync with the host
    if cuda:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = len(items) * args.steps
    timers, trainer.timers = trainer.timers, None
    result = {
        "metric": "grpo_full_step_completions_per_sec_per_chip", "value": n / dt,
        "unit": "completions/s", "seconds_per_step": dt / args.steps,
        "prompts": args.prompts, "G": args.G, "new_tokens": args.new,
        "decoder": args.decoder, "encoder": args.encoder, "frozen": args.frozen,
        "rollout_int8": args.rollout_int8,
        "accum": args.accum, "remat": args.remat, "steps": args.steps,
        "launches_per_step": {"flash_fwd": (fa.flash_attention.launches - launches0[0])
                              / args.steps,
                              "flash_bwd": (fa.flash_bwd.launches - launches0[1]) / args.steps},
        "timers": timers, "loss": m["loss"], "kl": m["kl"], "reward": m["reward"],
        "prompt_len": trainer.engine.last_stats["prompt_len"],
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "card": card_name() if cuda else None}
    return result, trainer, items


def main(argv=None) -> dict:
    result, _, _ = run(parse_args(argv))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
