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

From local HF checkpoints (a Qwen3 directory with its tokenizer.json and an
NT-v2 directory with its vocab.txt; the reference's constructor,
dna_llm.py:64-90), on a variant-effect task, with a generative test at the
end:
  python -m bioreason_tpu_torch.cli.train_sft --hf_llm_dir <qwen3> \
      --hf_dna_dir <nt-v2> --dataset_type variant_effect_coding \
      --data_dir <dir of .json/.jsonl> --eval_every 50 --keep_top_k 2 \
      --test_generative
(--evo2_dir <vortex dir> in place of --hf_dna_dir for the Evo2 tower;
--llm_only pastes the DNA into the text instead.)

Each step prints one JSON line of metrics; the final trainable parameters,
optimizer state and step go to <checkpoint_dir>/sft_final, with what the
frozen base was (train/checkpoint.py: the pretrained directories and a
fingerprint of each weights file, or what draws a seeded base again:
--seed, the presets, --dna_attention, --dna_embedding_layer, the
vocabulary, the dtype, the LoRA rank), so that `reason --sft_checkpoint`
and `serve --checkpoint` rebuild the model. --eval_every adds the val loss
(and, with --probe_markers, the teacher-forced probe; --keep_top_k keeps
the best checkpoints under <checkpoint_dir>/best, parameters alone, under
the JAX CLI's rule: a save only on a val loss 25% under the last kept one,
and always at the step --stop_probe_acc stops at); --sample_every prints a
sampled generation; --test_generative scores the test split
(train/eval.py) into <checkpoint_dir>/test_generations.csv;
--profile_dir records steps 3-5 with torch.profiler; --save_every writes
<checkpoint_dir>/sft_state off the training thread; --log_dir writes the
JAX CLI's rows (`train/<k>` every step, `val/loss`, `val/probe_<k>`, the
test summary) to <log_dir>/metrics.jsonl; --debug_nans raises
FloatingPointError at the first op that makes a NaN
(utils/debug_nans.py). `--mesh d,f,m` / `--cpu_devices N` train as ranks
of a mesh (parallel/; `--sp_dna` and the `sp*` attentions shard the DNA
sequence over 'model'); there the eval flags run the generation engine and
the probe on the trainer's shards, every rank on the whole eval batch, and
rank 0 alone prints and writes. `--wandb` stays refused.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os

import numpy as np

# flags of the JAX CLI whose paths are not ported yet
LATER_FLAGS = ("wandb",)


def parse_args(argv=None):
    from bioreason_tpu_torch.cli.common import (DECODER_PRESETS, ENCODER_PRESETS, HYENA_PRESETS,
                                                add_mesh_flags)
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--decoder", default="qwen3-0.6b", choices=sorted(DECODER_PRESETS))
    p.add_argument("--encoder", default="nt-500m",
                   choices=sorted(ENCODER_PRESETS) + sorted(HYENA_PRESETS))
    p.add_argument("--dna_embedding_layer", type=int, default=-1,
                   help="Evo2 named-layer embedding tap (block index)")
    p.add_argument("--hf_llm_dir", default=None,
                   help="local HF Qwen3 directory (weights + tokenizer.json); overrides "
                        "--decoder with the pretrained tower (reference dna_llm.py:64-74)")
    p.add_argument("--hf_dna_dir", default=None,
                   help="local HF NT-v2 / ESM directory (weights + vocab.txt); overrides "
                        "--encoder (reference dna_llm.py:79-83)")
    p.add_argument("--evo2_dir", default=None,
                   help="local Evo2 directory (vortex .pt); the Evo2 tower beside "
                        "--hf_llm_dir (reference dna_is_evo2, dna_llm.py:86-90)")
    p.add_argument("--llm_only", action="store_true",
                   help="paste the DNA into the text instead of the tower's embeddings")
    p.add_argument("--dna_kmer", type=int, default=6,
                   help="k-mer size of the NT path's DNA tokenizer (without --hf_dna_dir)")
    p.add_argument("--dtype", default=None,
                   help="compute dtype of both towers (float32 or bfloat16)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    from bioreason_tpu_torch.cli.common import DATASET_TYPES
    p.add_argument("--dataset_type", default="kegg", choices=DATASET_TYPES)
    p.add_argument("--data_dir", default=None, help="JSON dir; synthetic KEGG corpus if unset")
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
    p.add_argument("--keep_top_k", type=int, default=0,
                   help="keep the k best val-loss checkpoints under <checkpoint_dir>/best "
                        "(reference ModelCheckpoint save_top_k on val_loss); needs "
                        "--eval_every")
    p.add_argument("--probe_markers", default=None,
                   help="JSON {name: marker_text}: at every --eval_every, the teacher-forced "
                        "accuracy at the token after each marker on the val split "
                        "(train/eval.py:teacher_forced_probe)")
    p.add_argument("--probe_n", type=int, default=64, help="val examples per probe")
    p.add_argument("--stop_probe_acc", type=float, default=0.0,
                   help="stop once every --probe_markers accuracy reaches this")
    p.add_argument("--sample_every", type=int, default=0,
                   help="print a sampled generation every N steps")
    p.add_argument("--max_new_tokens", type=int, default=800)
    p.add_argument("--test_generative", action="store_true",
                   help="score the test split by generation after training")
    p.add_argument("--test_labels", nargs=2, default=None, metavar=("NEG", "POS"),
                   help="binary labels of the generative test (default: the two first "
                        "sorted answers)")
    p.add_argument("--profile_dir", default=None,
                   help="record steps 3-5 with torch.profiler into <dir>/trace.json")
    p.add_argument("--save_every", type=int, default=0,
                   help="checkpoint (trainable params + optimizer + step) every N steps")
    p.add_argument("--checkpoint_dir", default="checkpoints")
    p.add_argument("--log_dir", default=None,
                   help="write the metric rows to <log_dir>/metrics.jsonl (none if unset)")
    p.add_argument("--resume", action="store_true",
                   help="resume from <checkpoint_dir>/sft_state if present")
    p.add_argument("--debug_nans", action="store_true",
                   help="raise FloatingPointError at the first op that makes a NaN "
                        "(jax_debug_nans' counterpart; syncs every op)")
    add_mesh_flags(p)
    p.add_argument("--sp_dna", action="store_true",
                   help="shard the DNA token axis over the mesh's 'model' axis "
                        "(parallel/sp.py; the same as --dna_attention sp)")
    for flag in LATER_FLAGS:
        p.add_argument(f"--{flag}", nargs="?", const=True, default=None,
                       help="not ported yet (raises)")
    args = p.parse_args(argv)
    asked = [f"--{f}" for f in LATER_FLAGS if getattr(args, f) is not None]
    if asked:
        raise NotImplementedError(f"{', '.join(asked)}: not ported to bioreason_tpu_torch yet")
    if args.sp_dna and args.dna_attention is None:
        args.dna_attention = "sp"
    impl = args.dna_attention
    if impl is not None and impl not in ("xla", "pallas", "sp", "sp_pallas") and not (
            impl.split(":", 1)[0] in ("local", "sp_local") and impl.split(":", 1)[-1].isdigit()):
        p.error(f"--dna_attention {impl!r}: expected xla, pallas, sp, sp_pallas, local:<W> "
                f"or sp_local:<W>")
    if args.hf_llm_dir and not (args.hf_dna_dir or args.evo2_dir or args.llm_only):
        p.error("--hf_llm_dir requires --hf_dna_dir or --evo2_dir (or --llm_only)")
    if (args.hf_dna_dir or args.evo2_dir) and not args.hf_llm_dir:
        p.error("--hf_dna_dir and --evo2_dir are read beside --hf_llm_dir")
    if args.keep_top_k and not args.eval_every:
        p.error("--keep_top_k needs --eval_every")
    evo2 = args.evo2_dir or (args.encoder in HYENA_PRESETS and not args.hf_dna_dir)
    if impl is not None and impl.split(":")[0] in ("local", "sp_local") and evo2:
        p.error("the Evo2 tower's striped attention is causal; banded local kernels "
                "(local:/sp_local:) are bidirectional-only — use xla, pallas, sp or "
                "sp_pallas")
    return args


def main(argv=None):
    """Train; returns the trainer, with `trainer.history` the per-step metrics
    (and `trainer.test_result` the generative test's `EvalResult`)."""
    args = parse_args(argv)
    from bioreason_tpu_torch.cli.common import run_with_mesh
    return run_with_mesh(args, _run_mesh,
                         wanted=(args.dna_attention or "").startswith("sp"))


def _run_mesh(args, mesh):
    from bioreason_tpu_torch.utils.debug_nans import nan_checks
    with nan_checks(args.debug_nans):
        return _run(args, mesh)


def _run(args, mesh=None):
    import contextlib

    import torch
    from bioreason_tpu_torch.cli.common import (DECODER_PRESETS, build_encoder_config,
                                                load_items)
    from bioreason_tpu_torch.config import (FusionConfig, LoRAConfig, OptimConfig, SamplingConfig,
                                            SFTConfig)
    from bioreason_tpu_torch.data import BioProcessor, ByteTextTokenizer, KmerTokenizer
    from bioreason_tpu_torch.data.chat_template import render_chat
    from bioreason_tpu_torch.data.collate import sft_collate
    from bioreason_tpu_torch.generate.engine import GenerationEngine
    from bioreason_tpu_torch.parallel.trainer import is_writer
    from bioreason_tpu_torch.train.checkpoint import TopKKeeper
    from bioreason_tpu_torch.train.dataflow import batch_iterator, prefetch
    from bioreason_tpu_torch.train.eval import (evaluate_generative,
                                                multilabel_substring_accuracy, prompt_messages,
                                                teacher_forced_probe)
    from bioreason_tpu_torch.train.metrics import MetricsLogger, StepTimer
    from bioreason_tpu_torch.train.sft import SFTTrainer
    from bioreason_tpu_torch.utils.devices import resolve_device
    from bioreason_tpu_torch.utils.profiling import trace

    device = resolve_device(args.device)
    model = base = None
    if args.hf_llm_dir:
        from bioreason_tpu_torch.utils.pretrained import base_record, load_pretrained_fusion
        fusion_cfg, model, tok, dna_tok = load_pretrained_fusion(
            args.hf_llm_dir, args.hf_dna_dir, args.max_length_text, args.max_length_dna,
            seed=args.seed, dtype=args.dtype or "bfloat16", evo2_dir=args.evo2_dir,
            dna_embedding_layer=args.dna_embedding_layer, device=device)
        dna_tok = dna_tok or KmerTokenizer()
        base = base_record(args.hf_llm_dir, args.hf_dna_dir, args.evo2_dir)
        presets = {}
        print(f"loaded pretrained towers: llm={args.hf_llm_dir} (vocab "
              f"{fusion_cfg.decoder.vocab_size}), dna={args.evo2_dir or args.hf_dna_dir}",
              flush=True)
    else:
        tok = ByteTextTokenizer()
        kind, encoder, hyena, dna_tok = build_encoder_config(args.encoder,
                                                             args.dna_embedding_layer)
        if args.dna_kmer != 6 and kind == "nt":
            dna_tok = KmerTokenizer(kmer=args.dna_kmer)
        decoder = DECODER_PRESETS[args.decoder](vocab_size=tok.vocab_size)
        if args.dtype:
            decoder = dataclasses.replace(decoder, dtype=args.dtype)
            encoder = dataclasses.replace(encoder, dtype=args.dtype)
            if hyena is not None:
                hyena = dataclasses.replace(hyena, dtype=args.dtype)
        fusion_cfg = FusionConfig(
            decoder=decoder, encoder=encoder, hyena=hyena, encoder_kind=kind,
            dna_pad_token_id=tok.dna_pad_id, max_length_text=args.max_length_text,
            max_length_dna=args.max_length_dna)
        presets = {"decoder": args.decoder, "encoder": args.encoder}
    if args.dna_attention and fusion_cfg.encoder_kind == "evo2":
        fusion_cfg = dataclasses.replace(fusion_cfg, hyena=dataclasses.replace(
            fusion_cfg.hyena, attention_impl=args.dna_attention))
    elif args.dna_attention:
        fusion_cfg = dataclasses.replace(fusion_cfg, encoder=dataclasses.replace(
            fusion_cfg.encoder, attention_impl=args.dna_attention))
    proc = BioProcessor(tok, dna_tok)
    train_items, val_items, test_items = load_items(
        args.dataset_type, args.data_dir, args.n_synthetic, args.truncate_dna_per_side,
        args.seed, llm_only=args.llm_only)

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
    trainer = SFTTrainer(fusion_cfg, sft_cfg, model=model, device=device, base=base, mesh=mesh)
    trainer.history, trainer.test_result = [], None
    state_path = os.path.join(args.checkpoint_dir, "sft_state")
    if args.resume and os.path.exists(state_path):
        trainer.restore(state_path)
        print(f"resumed from {state_path} at step {trainer.step}", flush=True)
    keeper = (TopKKeeper(os.path.join(args.checkpoint_dir, "best"), k=args.keep_top_k)
              if args.keep_top_k else None)
    markers = json.loads(args.probe_markers) if args.probe_markers else None
    # under a mesh the engine runs on the trainer's shards (generate/engine.py)
    engine = GenerationEngine(fusion_cfg, eos_token_id=tok.eos_token_id, device=device,
                              run=trainer.run)

    collate = functools.partial(sft_collate, processor=proc,
                                max_length_text=args.max_length_text,
                                max_length_dna=args.max_length_dna, bucket=args.bucket,
                                supervise_eos=args.supervise_eos)
    logger = MetricsLogger(args.log_dir, quiet=True)

    def save_best(val_loss: float, step: int):
        kept = keeper.update(val_loss, lambda path: trainer.save(path, presets, params_only=True),
                             step)
        if kept:
            print(f"val_loss {val_loss:.4f} in top-{args.keep_top_k}: saved {kept}", flush=True)
        return kept

    step = 0
    last_kept = None
    timer = StepTimer()
    with contextlib.ExitStack() as profiling:
        for batch in prefetch(batch_iterator(train_items, collate, args.batch_size,
                                             seed=args.seed, epochs=args.num_epochs)):
            if args.profile_dir and step == 2:              # steps 3-5 (train_sft.py:283)
                profiling.enter_context(trace(args.profile_dir))
            if args.profile_dir and step == 5:
                profiling.close()
            timer.start()
            metrics = trainer.train_step(batch)
            metrics["step_time"] = timer.stop()
            metrics["examples_per_sec"] = args.batch_size / metrics["step_time"]
            logger.log({f"train/{k}": v for k, v in metrics.items()}, step=step)
            step += 1
            stop = False
            if args.eval_every and step % args.eval_every == 0 and val_items:
                losses = [trainer.eval_step(b) for b in batch_iterator(
                    val_items, collate, args.batch_size, shuffle=False, epochs=1,
                    drop_last=False)]
                if losses:
                    val_loss = metrics["val_loss"] = float(np.mean(losses))
                    logger.log({"val/loss": val_loss}, step=step)
                    # the JAX CLI's rate limit (train_sft.py:280-301): a save
                    # only on a val loss 25% under the last kept one
                    if keeper is not None and (last_kept is None
                                               or val_loss < 0.75 * last_kept):
                        if save_best(val_loss, step):
                            last_kept = val_loss
                if markers:
                    with trainer.inference_scope():
                        probe = teacher_forced_probe(
                            trainer.model, fusion_cfg, proc, val_items[:args.probe_n], markers,
                            batch_size=args.batch_size, max_length_text=args.max_length_text,
                            max_length_dna=args.max_length_dna,
                            supervise_eos=args.supervise_eos)
                    logger.log({f"val/probe_{k}": v for k, v in probe.items()}, step=step)
                    metrics.update({f"probe_{k}": v for k, v in probe.items()})
                    accs = [v for k, v in probe.items() if k != "span_acc"]
                    stop = bool(args.stop_probe_acc) and min(accs) >= args.stop_probe_acc
                    if stop and keeper is not None and losses:
                        # the step the probe stops at is the model the run
                        # ends on: saved past the rate limit (JAX :313-323)
                        save_best(val_loss, step)
            if args.sample_every and step % args.sample_every == 0:
                ex = train_items[0]
                rendered = render_chat(prompt_messages(ex), add_generation_prompt=True)
                out = proc(text=[rendered], batch_dna_sequences=[ex["dna_sequences"]],
                           max_length_text=args.max_length_text,
                           max_length_dna=args.max_length_dna, padding_side="left")
                ids, mask = engine.generate(
                    trainer.model, out.input_ids, out.attention_mask, out.dna_input_ids,
                    out.dna_attention_mask, max_new_tokens=args.max_new_tokens,
                    generator=torch.Generator(device=device).manual_seed(args.seed + step))
                metrics["sample"] = tok.decode(ids[0][mask[0].astype(bool)],
                                               skip_special_tokens=False)
            trainer.history.append(metrics)
            print(json.dumps({"step": trainer.step, **metrics}), flush=True)
            if args.save_every and step % args.save_every == 0:
                trainer.save(state_path, presets, block=False)
            if stop:
                print(f"probe accuracies all >= {args.stop_probe_acc}: stopping at step "
                      f"{step}", flush=True)
                break
            if args.max_steps and step >= args.max_steps:
                break

    trainer.finish_saves()
    final = trainer.save(os.path.join(args.checkpoint_dir, "sft_final"), presets)
    print(f"saved checkpoint to {final}", flush=True)

    if args.test_generative and test_items:
        if args.test_labels:
            labels = tuple(args.test_labels)
        else:
            # the reference's derivation: sorted unique answers, the first
            # negative, the second positive (train_dna_qwen.py:422-425)
            uniq = sorted({ex["answer"].strip() for ex in train_items + val_items + test_items})
            labels = tuple(uniq[:2]) if len(uniq) >= 2 else (uniq[0], uniq[0])
        res = evaluate_generative(
            engine, trainer.model, proc, test_items, labels=labels,
            sampling=SamplingConfig(max_new_tokens=args.max_new_tokens),
            max_new_tokens=args.max_new_tokens, batch_size=args.batch_size,
            generator=torch.Generator(device=device).manual_seed(args.seed),
            csv_path=(os.path.join(args.checkpoint_dir, "test_generations.csv")
                      if is_writer() else None),
            max_length_text=args.max_length_text, max_length_dna=args.max_length_dna)
        trainer.test_result = res
        summary = {**res.summary(),
                   "test_substring_accuracy": multilabel_substring_accuracy(res.generations)}
        logger.log(summary)
        print(json.dumps({"labels": labels, **summary}), flush=True)
    logger.close()
    return trainer


if __name__ == "__main__":
    main()
