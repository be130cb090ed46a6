"""SFT training CLI of the port (the counterpart of bioreason_tpu/cli/train_sft.py;
reference entry point train_dna_qwen.py:1011-1062).

Synthetic smoke run on the CPU:
  python -m bioreason_tpu_torch.cli.train_sft --decoder tiny --encoder tiny \\
      --device cpu --max_steps 2

On the card (the default device), at Qwen3-0.6B + NT-v2-500M width with
weights drawn from --seed:
  python -m bioreason_tpu_torch.cli.train_sft --max_steps 4

With the Evo2 DNA tower (Evo2-1B width, byte tokens; --dna_model_finetune
trains it too, its attention blocks through flash_fwd / flash_bwd):
  python -m bioreason_tpu_torch.cli.train_sft --encoder evo2-1b --max_steps 4

Long DNA with the encoder trained, through the banded kernels (local_fwd
and local_bwd in every encoder layer):
  python -m bioreason_tpu_torch.cli.train_sft --dna_attention local:256 \
      --dna_model_finetune --max_length_dna 2048 --truncate_dna_per_side 0 \
      --data_dir <dir of KEGG .json/.jsonl>

Each step prints one JSON line of metrics; the final trainable parameters,
optimizer state and step go to <checkpoint_dir>/sft_final, with what draws
the frozen base again (--seed, the presets, --dna_attention,
--dna_embedding_layer, the vocabulary, the LoRA rank), so that `reason
--sft_checkpoint` can rebuild the model (train/checkpoint.py:
load_sft_for_grpo). Pretrained
checkpoints, sequence parallelism (`--sp_dna`, `--dna_attention sp`,
`sp_pallas`, `sp_local:<W>`), probes, sampling, generative tests, profiling
and wandb come with later slices: `main` refuses their flags.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os

import numpy as np

# flags of the JAX CLI whose paths are not ported yet
LATER_FLAGS = ("hf_llm_dir", "hf_dna_dir", "evo2_dir", "sp_dna",
               "probe_markers", "sample_every", "test_generative", "profile_dir", "wandb")


def parse_args(argv=None):
    from bioreason_tpu_torch.cli.common import DECODER_PRESETS, ENCODER_PRESETS, HYENA_PRESETS
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--decoder", default="qwen3-0.6b", choices=sorted(DECODER_PRESETS))
    p.add_argument("--encoder", default="nt-500m",
                   choices=sorted(ENCODER_PRESETS) + sorted(HYENA_PRESETS))
    p.add_argument("--dna_embedding_layer", type=int, default=-1,
                   help="Evo2 named-layer embedding tap (block index)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--data_dir", default=None, help="KEGG JSON dir; synthetic corpus if unset")
    p.add_argument("--n_synthetic", type=int, default=64)
    p.add_argument("--truncate_dna_per_side", type=int, default=1024)
    p.add_argument("--max_length_text", type=int, default=512)
    p.add_argument("--max_length_dna", type=int, default=2048)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--learning_rate", type=float, default=2e-5)
    p.add_argument("--num_epochs", type=int, default=1)
    p.add_argument("--max_steps", type=int, default=0, help="0 = epoch-bounded")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--lora_r", type=int, default=32)
    p.add_argument("--lora_alpha", type=int, default=64)
    p.add_argument("--lora_dropout", type=float, default=0.05)
    p.add_argument("--no_lora", action="store_true", help="full finetune of the decoder")
    p.add_argument("--dna_attention", default=None,
                   help="encoder attention override: xla | pallas | local:<W> (banded, "
                        "|i-j| <= W, O(T*W) for long DNA; NT only: the Evo2 tower's "
                        "attention is causal); sp, sp_pallas and sp_local:<W> are not "
                        "ported yet (raise)")
    p.add_argument("--dna_model_finetune", action="store_true",
                   help="train the DNA encoder too")
    p.add_argument("--supervise_eos", action="store_true",
                   help="supervise the final assistant <|im_end|> (data/collate.py)")
    p.add_argument("--focal_gamma", type=float, default=0.0,
                   help="detached focal CE weighting on the train loss (ops/fused_ce.py)")
    p.add_argument("--bucket", type=int, default=128)
    p.add_argument("--grad_accum_steps", type=int, default=1)
    p.add_argument("--eval_every", type=int, default=0, help="val loss every N steps")
    p.add_argument("--save_every", type=int, default=0,
                   help="checkpoint (trainable params + optimizer + step) every N steps")
    p.add_argument("--checkpoint_dir", default="checkpoints")
    p.add_argument("--resume", action="store_true",
                   help="resume from <checkpoint_dir>/sft_state if present")
    for flag in LATER_FLAGS:
        p.add_argument(f"--{flag}", nargs="?", const=True, default=None,
                       help="not ported yet (raises)")
    args = p.parse_args(argv)
    asked = [f"--{f}" for f in LATER_FLAGS if getattr(args, f) is not None]
    if asked:
        raise NotImplementedError(f"{', '.join(asked)}: not ported to bioreason_tpu_torch yet")
    impl = args.dna_attention
    if impl in ("sp", "sp_pallas") or (impl or "").startswith("sp_local:"):
        raise NotImplementedError(f"--dna_attention {impl}: sequence parallelism is not ported "
                                  f"to bioreason_tpu_torch yet")
    if impl is not None and impl not in ("xla", "pallas") and not (
            impl.startswith("local:") and impl[6:].isdigit()):
        p.error(f"--dna_attention {impl!r}: expected xla, pallas or local:<W>")
    if impl is not None and impl.startswith("local") and args.encoder in HYENA_PRESETS:
        p.error("the Evo2 tower's striped attention is causal; banded local kernels "
                "(local:/sp_local:) are bidirectional-only — use xla, pallas, sp or "
                "sp_pallas")
    return args


def main(argv=None):
    """Train; returns the trainer, with `trainer.history` the per-step metrics."""
    args = parse_args(argv)
    from bioreason_tpu_torch.cli.common import (DECODER_PRESETS, build_encoder_config,
                                                load_items)
    from bioreason_tpu_torch.config import FusionConfig, LoRAConfig, OptimConfig, SFTConfig
    from bioreason_tpu_torch.data import BioProcessor, ByteTextTokenizer
    from bioreason_tpu_torch.data.collate import sft_collate
    from bioreason_tpu_torch.train.dataflow import batch_iterator, prefetch
    from bioreason_tpu_torch.train.metrics import StepTimer
    from bioreason_tpu_torch.train.sft import SFTTrainer

    tok = ByteTextTokenizer()
    kind, encoder, hyena, dna_tok = build_encoder_config(args.encoder, args.dna_embedding_layer)
    if args.dna_attention and kind == "evo2":
        hyena = dataclasses.replace(hyena, attention_impl=args.dna_attention)
    elif args.dna_attention:
        encoder = dataclasses.replace(encoder, attention_impl=args.dna_attention)
    fusion_cfg = FusionConfig(
        decoder=DECODER_PRESETS[args.decoder](vocab_size=tok.vocab_size),
        encoder=encoder, hyena=hyena, encoder_kind=kind, dna_pad_token_id=tok.dna_pad_id,
        max_length_text=args.max_length_text, max_length_dna=args.max_length_dna)
    proc = BioProcessor(tok, dna_tok)
    train_items, val_items, _ = load_items(args.data_dir, args.n_synthetic,
                                           args.truncate_dna_per_side, args.seed)

    steps_per_epoch = max(1, len(train_items) // args.batch_size)
    total_steps = args.max_steps or steps_per_epoch * args.num_epochs
    sft_cfg = SFTConfig(
        batch_size=args.batch_size, grad_accum_steps=args.grad_accum_steps,
        max_length_text=args.max_length_text, max_length_dna=args.max_length_dna,
        bucket=args.bucket,
        optim=OptimConfig(learning_rate=args.learning_rate, total_steps=total_steps),
        lora=None if args.no_lora else LoRAConfig(r=args.lora_r, alpha=args.lora_alpha,
                                                  dropout=args.lora_dropout),
        freeze_encoder=not args.dna_model_finetune, focal_gamma=args.focal_gamma,
        seed=args.seed)
    trainer = SFTTrainer(fusion_cfg, sft_cfg, device=args.device)
    trainer.history = []
    presets = {"decoder": args.decoder, "encoder": args.encoder}
    state_path = os.path.join(args.checkpoint_dir, "sft_state")
    if args.resume and os.path.exists(state_path):
        trainer.restore(state_path)
        print(f"resumed from {state_path} at step {trainer.step}", flush=True)

    collate = functools.partial(sft_collate, processor=proc,
                                max_length_text=args.max_length_text,
                                max_length_dna=args.max_length_dna, bucket=args.bucket,
                                supervise_eos=args.supervise_eos)
    step = 0
    timer = StepTimer()
    for batch in prefetch(batch_iterator(train_items, collate, args.batch_size,
                                         seed=args.seed, epochs=args.num_epochs)):
        timer.start()
        metrics = trainer.train_step(batch)
        metrics["step_time"] = timer.stop()
        metrics["examples_per_sec"] = args.batch_size / metrics["step_time"]
        step += 1
        if args.eval_every and step % args.eval_every == 0 and val_items:
            losses = [trainer.eval_step(b) for b in batch_iterator(
                val_items, collate, args.batch_size, shuffle=False, epochs=1,
                drop_last=False)]
            metrics["val_loss"] = float(np.mean(losses))
        trainer.history.append(metrics)
        print(json.dumps({"step": trainer.step, **metrics}), flush=True)
        if args.save_every and step % args.save_every == 0:
            trainer.save(state_path, presets)
        if args.max_steps and step >= args.max_steps:
            break

    final = trainer.save(os.path.join(args.checkpoint_dir, "sft_final"), presets)
    print(f"saved checkpoint to {final}", flush=True)
    return trainer


if __name__ == "__main__":
    main()
