"""GRPO training CLI of the port (the counterpart of bioreason_tpu/cli/reason.py;
reference entry point reason.py:596-610).

Starts from an SFT checkpoint: the port's own `sft_final` (its base built
again from what it records, a seed or pretrained HF directories, its LoRA
merged, fresh adapters attached; train/checkpoint.py:load_sft_for_grpo),
or a REFERENCE BioReason torch checkpoint (a Lightning / DeepSpeed
container or a raw `DNALLMModel.state_dict()`, file or directory; its LoRA
merged into the base it is loaded over, utils/ref_ckpt.py), then runs
group-relative policy optimization with rule-based rewards, each step's
prompts drawn by `repeat_random_indices`.

Synthetic smoke run on the CPU:
  python -m bioreason_tpu_torch.cli.reason --decoder tiny --encoder tiny \\
      --device cpu --num_generations 2 --batch_size 4 --max_steps 2 \\
      --max_completion_length 16 --max_length_dna 128

On the card (the default device), from an SFT run of the same --seed:
  python -m bioreason_tpu_torch.cli.train_sft --max_steps 4 --seed 0
  python -m bioreason_tpu_torch.cli.reason --seed 0 \\
      --sft_checkpoint checkpoints/sft_final --num_generations 4 --batch_size 16 \\
      --max_completion_length 64 --max_steps 2

From local HF checkpoints and a reference checkpoint:
  python -m bioreason_tpu_torch.cli.reason --hf_llm_dir <qwen3> \\
      --hf_dna_dir <nt-v2> --sft_checkpoint <reference .pt or dir>

Metrics go to <log_dir>/metrics.jsonl and stdout; the trainable parameters,
optimizer state and step to <checkpoint_dir>/grpo_state every --save_every
steps (read back by --resume) and to <checkpoint_dir>/grpo_final at the end.
`--use_vllm` is accepted and ignored, as the JAX CLI and the reference do:
rollouts always run through the port's engine. `--guided_decoding_regex`
constrains every rollout to a regex (generate/guided.py); `--rollout_int8`
rolls out with int8 base weights (train/grpo.py), `--rollout_kv_int8` with
an int8 KV cache (under a mesh too: the int8 weights whole on every rank,
as JAX places them, e.g. `--cpu_devices 2 --mesh 1,1,2 --rollout_int8
--rollout_kv_int8`); the --save_every
checkpoint is written off the training thread; --debug_nans raises
FloatingPointError at the first op that makes a NaN (utils/debug_nans.py).
`--mesh d,f,m` / `--cpu_devices N` run GRPO as ranks of a mesh: the prompts
split over data x fsdp, and model > 1 runs the rollouts, the logp passes
and the update tensor-parallel (train/grpo.py), e.g. on the CPU:
  python -m bioreason_tpu_torch.cli.reason --decoder tiny --encoder tiny \
      --device cpu --cpu_devices 2 --mesh 1,1,2 --num_generations 2 \
      --batch_size 4 --max_steps 2 --max_completion_length 16
`--wandb` stays refused.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

# flags of the JAX CLI whose paths are not ported yet
LATER_FLAGS = ("wandb",)


def parse_args(argv=None):
    from bioreason_tpu_torch.cli.common import add_mesh_flags
    from bioreason_tpu_torch.cli.common import DATASET_TYPES, DECODER_PRESETS, ENCODER_PRESETS
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--decoder", default="qwen3-0.6b", choices=sorted(DECODER_PRESETS))
    p.add_argument("--encoder", default="nt-500m", choices=sorted(ENCODER_PRESETS))
    p.add_argument("--hf_llm_dir", default=None,
                   help="local HF Qwen3 directory (weights + tokenizer.json); overrides "
                        "--decoder (reference dna_llm.py:64-74)")
    p.add_argument("--hf_dna_dir", default=None,
                   help="local HF NT-v2 / ESM directory; overrides --encoder")
    p.add_argument("--dtype", default=None,
                   help="compute dtype of both towers; must be the SFT run's")
    p.add_argument("--dna_kmer", type=int, default=6,
                   help="k-mer size of the NT path's DNA tokenizer (the SFT run's)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--dataset_type", default="kegg", choices=DATASET_TYPES)
    p.add_argument("--dna_attention", default=None,
                   help="encoder attention override: xla | pallas | local:<W>; must be the "
                        "SFT run's when continuing from --sft_checkpoint")
    p.add_argument("--data_dir", default=None, help="JSON dir; synthetic KEGG corpus if unset")
    p.add_argument("--n_synthetic", type=int, default=64)
    p.add_argument("--truncate_dna_per_side", type=int, default=1024)
    p.add_argument("--max_length_text", type=int, default=512)
    p.add_argument("--max_length_dna", type=int, default=2048)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--learning_rate", type=float, default=2e-5)
    p.add_argument("--max_steps", type=int, default=0, help="0 = 100 steps")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--checkpoint_dir", default="checkpoints")
    p.add_argument("--log_dir", default="logs")
    p.add_argument("--sft_checkpoint", default=None,
                   help="the port's sft_final (or sft_state) directory, or a reference "
                        "BioReason torch checkpoint (file or directory)")
    p.add_argument("--max_prompt_length", type=int, default=None,
                   help="keep the last N prompt tokens (reference grpo_config.py:174-177)")
    p.add_argument("--reward_funcs", nargs="+",
                   default=["xmlcount", "soft_format", "correctness"])
    p.add_argument("--num_generations", type=int, default=8)
    p.add_argument("--num_iterations", type=int, default=1)
    p.add_argument("--beta", type=float, default=0.04)
    p.add_argument("--epsilon", type=float, default=0.2)
    p.add_argument("--max_completion_length", type=int, default=800)
    p.add_argument("--lora_r", type=int, default=64)
    p.add_argument("--lora_alpha", type=int, default=64)
    p.add_argument("--save_every", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="resume from <checkpoint_dir>/grpo_state if present")
    p.add_argument("--rollout_int8", action="store_true",
                   help="roll out with int8 base weights, the embedding and the head "
                        "included (GRPOConfig.rollout_int8; the training passes stay in "
                        "the compute dtype, so sampling is slightly off-policy)")
    p.add_argument("--rollout_kv_int8", action="store_true",
                   help="roll out with an int8 KV cache (GRPOConfig.rollout_kv_int8; a "
                        "flag of the port: the JAX CLI leaves the cache float)")
    p.add_argument("--guided_decoding_regex", default=None,
                   help="constrain every rollout completion to match this regex "
                        "(vllm_guided_decoding_regex, grpo_config.py:278-280)")
    p.add_argument("--debug_nans", action="store_true",
                   help="raise FloatingPointError at the first op that makes a NaN "
                        "(jax_debug_nans' counterpart; syncs every op)")
    p.add_argument("--use_vllm", default=None,
                   help="accepted for reference-CLI compatibility and ignored "
                        "(sh_reason.sh:53): rollouts run through the port's engine")
    add_mesh_flags(p)
    for flag in LATER_FLAGS:
        p.add_argument(f"--{flag}", nargs="?", const=True, default=None,
                       help="not ported yet (raises)")
    args = p.parse_args(argv)
    asked = [f"--{f}" for f in LATER_FLAGS if getattr(args, f) is not None]
    if asked:
        raise NotImplementedError(f"{', '.join(asked)}: not ported to bioreason_tpu_torch yet")
    if args.hf_llm_dir and not args.hf_dna_dir:
        p.error("--hf_llm_dir requires --hf_dna_dir")
    impl = args.dna_attention
    if impl is not None and impl not in ("xla", "pallas") and not (
            impl.startswith("local:") and impl[6:].isdigit()):
        p.error(f"--dna_attention {impl!r}: expected xla, pallas or local:<W>")
    return args


def main(argv=None):
    """Train; returns the trainer, with `trainer.metrics_history` the
    per-step metrics."""
    args = parse_args(argv)
    from bioreason_tpu_torch.cli.common import run_with_mesh
    return run_with_mesh(args, _run_mesh)


def _run_mesh(args, mesh):
    from bioreason_tpu_torch.utils.debug_nans import nan_checks
    with nan_checks(args.debug_nans):
        return _run(args, mesh)


def _run(args, mesh=None):
    import torch
    from bioreason_tpu_torch.cli.common import DECODER_PRESETS, ENCODER_PRESETS, load_items
    from bioreason_tpu_torch.config import (FusionConfig, GRPOConfig, LoRAConfig, OptimConfig,
                                            SamplingConfig)
    from bioreason_tpu_torch.data import BioProcessor, ByteTextTokenizer, KmerTokenizer
    from bioreason_tpu_torch.data.kegg import format_kegg_prompt_only, synthetic_kegg_items
    from bioreason_tpu_torch.data.utils import split_dataset, truncate_dna
    from bioreason_tpu_torch.models.fusion import init_fusion
    from bioreason_tpu_torch.train.checkpoint import (is_pretrained, load_checkpoint,
                                                      load_sft_for_grpo)
    from bioreason_tpu_torch.train.dataflow import repeat_random_indices
    from bioreason_tpu_torch.train.eval import prompt_messages
    from bioreason_tpu_torch.train.grpo import GRPOTrainer
    from bioreason_tpu_torch.train.lora import attach_lora
    from bioreason_tpu_torch.train.metrics import MetricsLogger
    from bioreason_tpu_torch.train.rewards import get_reward_funcs
    from bioreason_tpu_torch.utils.devices import resolve_device
    from bioreason_tpu_torch.utils.ref_ckpt import is_reference_checkpoint, load_reference_sft

    device = resolve_device(args.device)
    lora_cfg = LoRAConfig(r=args.lora_r, alpha=args.lora_alpha)
    gen = torch.Generator(device=device).manual_seed(args.seed + 2)
    ckpt = args.sft_checkpoint
    reference = bool(ckpt) and is_reference_checkpoint(ckpt)
    base = None
    if args.hf_llm_dir:
        from bioreason_tpu_torch.utils.pretrained import load_pretrained_fusion
        fusion_cfg, base, tok, dna_tok = load_pretrained_fusion(
            args.hf_llm_dir, args.hf_dna_dir, args.max_length_text, args.max_length_dna,
            seed=args.seed, dtype=args.dtype or "bfloat16", device=device)
        proc = BioProcessor(tok, dna_tok)
    else:
        tok = ByteTextTokenizer()
        proc = BioProcessor(tok, KmerTokenizer(kmer=args.dna_kmer))
        decoder = DECODER_PRESETS[args.decoder](vocab_size=tok.vocab_size)
        encoder = ENCODER_PRESETS[args.encoder]()
        if args.dtype:
            decoder = dataclasses.replace(decoder, dtype=args.dtype)
            encoder = dataclasses.replace(encoder, dtype=args.dtype)
        fusion_cfg = FusionConfig(
            decoder=decoder, encoder=encoder, dna_pad_token_id=tok.dna_pad_id,
            max_length_text=args.max_length_text, max_length_dna=args.max_length_dna)
    if args.dna_attention:
        fusion_cfg = dataclasses.replace(fusion_cfg, encoder=dataclasses.replace(
            fusion_cfg.encoder, attention_impl=args.dna_attention))

    model = None
    if reference:
        # a reference checkpoint over the pretrained (or seeded) base: the
        # components it holds replace the base's, its LoRA merged
        model = base if base is not None else init_fusion(fusion_cfg, seed=args.seed,
                                                          device=device)
        comps = load_reference_sft(ckpt, model)
        attach_lora(model, lora_cfg, gen)
        print(f"ingested reference checkpoint {ckpt} (components: {comps}), fresh adapters "
              f"r{args.lora_r}/a{args.lora_alpha} attached", flush=True)
    elif ckpt:
        meta = load_checkpoint(ckpt)["metadata"]
        if is_pretrained(meta) and args.hf_llm_dir:
            asked = {"hf_llm_dir": os.path.abspath(args.hf_llm_dir),
                     "hf_dna_dir": os.path.abspath(args.hf_dna_dir)}
            wrong = {k: (meta[k], v) for k, v in asked.items() if meta[k] != v}
            if wrong:
                raise ValueError(f"{ckpt} was trained on another base: (checkpoint, asked) "
                                 f"{wrong}")
        del base                              # the checkpoint's base is built again
        model = load_sft_for_grpo(ckpt, fusion_cfg, lora_cfg, args.seed, args.decoder,
                                  args.encoder, device=device, generator=gen)
        print(f"loaded {ckpt}: SFT adapters merged, fresh adapters "
              f"r{args.lora_r}/a{args.lora_alpha} attached", flush=True)
    elif base is not None:
        model = base                          # GRPOTrainer attaches fresh adapters

    if args.dataset_type == "kegg":
        if args.data_dir:
            from bioreason_tpu_torch.data.loaders import load_local_dataset
            raw = load_local_dataset(args.data_dir)
        else:
            raw = synthetic_kegg_items(args.n_synthetic, seq_len=512, seed=args.seed)
        raw = [truncate_dna(dict(x), args.truncate_dna_per_side) for x in raw]
        train_items, _, _ = split_dataset(raw, seed=args.seed)
        prompts = [format_kegg_prompt_only(x) for x in train_items]
    else:
        train_items, _, _ = load_items(args.dataset_type, args.data_dir, args.n_synthetic,
                                       args.truncate_dna_per_side, args.seed)
        prompts = [{**ex, "prompt": prompt_messages(ex)} for ex in train_items]

    steps = args.max_steps or 100
    cfg = GRPOConfig(
        num_generations=args.num_generations, batch_size=args.batch_size,
        num_iterations=args.num_iterations, beta=args.beta, epsilon=args.epsilon,
        max_completion_length=args.max_completion_length,
        max_prompt_length=args.max_prompt_length,
        sampling=SamplingConfig(max_new_tokens=args.max_completion_length),
        optim=OptimConfig(learning_rate=args.learning_rate or 5e-6, total_steps=steps),
        lora=lora_cfg, guided_decoding_regex=args.guided_decoding_regex,
        rollout_int8=args.rollout_int8, rollout_kv_int8=args.rollout_kv_int8, seed=args.seed)
    trainer = GRPOTrainer(fusion_cfg, cfg, proc, get_reward_funcs(args.reward_funcs),
                          model=model, device=device, mesh=mesh)
    state_path = os.path.join(args.checkpoint_dir, "grpo_state")
    if args.resume and os.path.exists(state_path):
        trainer.restore(state_path)
        print(f"resumed from {state_path} at step {trainer.step_count}", flush=True)
    logger = MetricsLogger(args.log_dir)

    n_prompts_per_step = args.batch_size // args.num_generations
    if len(prompts) < n_prompts_per_step:
        raise ValueError(f"{len(prompts)} training prompts, fewer than the "
                         f"{n_prompts_per_step} a step takes")
    step, epoch = 0, 0
    try:
        while step < steps:
            for idx in repeat_random_indices(len(prompts), n_prompts_per_step,
                                             args.num_generations, args.seed, epoch):
                metrics = trainer.step([prompts[i] for i in idx])
                logger.log({f"grpo/{k}": v for k, v in metrics.items()}, step=step)
                # log_completions (reference grpo_config.py:344-354, :718-738)
                rows = [[step, pr[-200:], c[:400], r]
                        for pr, c, r in zip(trainer.last_prompts, trainer.last_completions,
                                            trainer.last_rewards)][:4]
                logger.log_table("completions", ["step", "prompt", "completion", "reward"],
                                 rows, step=step)
                step += 1
                if args.save_every and step % args.save_every == 0:
                    trainer.save(state_path, block=False)
                if step >= steps:
                    break
            epoch += 1
    finally:
        logger.close()
    trainer.finish_saves()
    final = trainer.save(os.path.join(args.checkpoint_dir, "grpo_final"))
    print(f"saved checkpoint to {final}", flush=True)
    return trainer


if __name__ == "__main__":
    main()
