"""Quality-failure diagnosis (the port of tools/diagnose_quality.py).

Trains a fusion model from scratch on the LEARNABLE synthetic KEGG corpus
(data/kegg.synthetic_kegg_items, 1-mer DNA, fixed loci) with a held-out
split and tracks the teacher-forced accuracies of the informative tokens
(train/eval.py:teacher_forced_probe) as it trains:

  base_acc    argmax accuracy at the alt base after 'substitutes '  (4-way)
  half_acc    at the f/s of '{first|second} half' after ' in the '  (2-way)
  answer_acc  at the first character after 'Answer: '               (8-way)
  span_acc    over the whole supervised span

on a train subsample AND on the held-out split, which localizes a failure:
low train accuracies mean the model cannot fit the DNA-dependent tokens
(optimization or architecture); high train and low held-out accuracies
mean memorization (more data); high both with a low generative accuracy
mean a fault of the generation path.

Presets: tiny (the tiny towers, fp32), small (a d256/L4 decoder and a
d128/L4 encoder, fp32, plain attention), bench (Qwen3-0.6B + NT-v2-50M,
bf16; the decoder through flash_fwd / flash_bwd on the card).

    python -m bioreason_tpu_torch.tools.diagnose_quality --preset tiny --device cpu \\
        --items 512 --seq_len 32 --steps 1500
    python -m bioreason_tpu_torch.tools.diagnose_quality --preset bench --items 4096 \\
        --steps 3000 --out bioreason_tpu_torch/artifacts/diagnose_bench.json
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time

MARKERS = {"base": "substitutes ", "half": " in the ", "answer": "Answer: "}


def build_corpus(n: int, seq_len: int, seed: int, holdout: int = 128):
    """(train, held-out) formatted items, as the JAX tool draws them."""
    from bioreason_tpu_torch.data.kegg import format_kegg_for_dna_llm, synthetic_kegg_items
    items = [format_kegg_for_dna_llm(it) for it in synthetic_kegg_items(
        n + holdout, seq_len=seq_len, seed=seed, learnable=True, fixed_positions=True)]
    return items[:n], items[n:]


def fusion_config(preset: str, seq_len: int, vocab: int, dna_pad_id: int,
                  dtype=None, attention=None):
    from bioreason_tpu_torch.config import DecoderConfig, EncoderConfig, FusionConfig
    if preset == "tiny":
        dec, enc = DecoderConfig.tiny(vocab), EncoderConfig.tiny()
    elif preset == "small":
        dec = DecoderConfig(vocab_size=vocab, hidden_size=256, intermediate_size=512,
                            num_layers=4, num_heads=4, num_kv_heads=2, head_dim=64,
                            remat=False, attention_impl="xla", dtype="float32")
        enc = EncoderConfig(hidden_size=128, intermediate_size=256, num_layers=4,
                            num_heads=4, remat=False, attention_impl="xla", dtype="float32")
    else:
        dec, enc = DecoderConfig.qwen3_0_6b(vocab_size=vocab), EncoderConfig.nt_v2_50m()
    over = {k: v for k, v in (("dtype", dtype), ("attention_impl", attention)) if v}
    if over:
        dec, enc = dataclasses.replace(dec, **over), dataclasses.replace(enc, **over)
    return FusionConfig(decoder=dec, encoder=enc, dna_pad_token_id=dna_pad_id,
                        max_length_text=512, max_length_dna=seq_len + 8)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="tiny", choices=["tiny", "small", "bench"])
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--items", type=int, default=512)
    ap.add_argument("--holdout", type=int, default=128)
    ap.add_argument("--seq_len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--learning_rate", type=float, default=1e-3)
    ap.add_argument("--focal_gamma", type=float, default=0.0)
    ap.add_argument("--attention", default=None,
                    help="both towers' attention_impl (xla | pallas): 'xla' isolates "
                         "whether the kernel, not the optimization, blocks the DNA-"
                         "dependent tokens")
    ap.add_argument("--dtype", default=None,
                    help="both towers' compute dtype (float32 at bench isolates bf16 "
                         "rounding; on the card with --attention xla, since the flash "
                         "kernels take bfloat16 only)")
    ap.add_argument("--probe_every", type=int, default=100)
    ap.add_argument("--probe_n", type=int, default=64)
    ap.add_argument("--supervise_eos", action="store_true", default=True)
    ap.add_argument("--no_supervise_eos", dest="supervise_eos", action="store_false")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--gen_eval_n", type=int, default=32,
                    help="greedy generative test size at the end (0 skips it)")
    ap.add_argument("--out", default=None, help="JSON artifact path")
    return ap.parse_args(argv)


def main(argv=None):
    """Train and probe; returns the result (a dict, also written to --out)."""
    args = parse_args(argv)
    from bioreason_tpu_torch.config import OptimConfig, SamplingConfig, SFTConfig
    from bioreason_tpu_torch.data import BioProcessor, ByteTextTokenizer, KmerTokenizer
    from bioreason_tpu_torch.data.collate import sft_collate
    from bioreason_tpu_torch.generate.engine import GenerationEngine
    from bioreason_tpu_torch.train.dataflow import batch_iterator
    from bioreason_tpu_torch.train.eval import (evaluate_generative,
                                                multilabel_substring_accuracy,
                                                teacher_forced_probe)
    from bioreason_tpu_torch.train.sft import SFTTrainer
    from bioreason_tpu_torch.utils.devices import resolve_device

    device = resolve_device(args.device)
    tok = ByteTextTokenizer()
    proc = BioProcessor(tok, KmerTokenizer(kmer=1))
    fusion = fusion_config(args.preset, args.seq_len, tok.vocab_size, tok.dna_pad_id,
                           args.dtype, args.attention)
    max_len_dna = fusion.max_length_dna
    train_items, test_items = build_corpus(args.items, args.seq_len, args.seed, args.holdout)
    print(f"[diagnose] {len(train_items)} train / {len(test_items)} test, "
          f"seq_len={args.seq_len}, preset={args.preset}, "
          f"supervise_eos={args.supervise_eos}, device={device}", flush=True)

    cfg = SFTConfig(batch_size=args.batch_size, max_length_dna=max_len_dna, bucket=None,
                    optim=OptimConfig(learning_rate=args.learning_rate,
                                      total_steps=args.steps, warmup_ratio=0.03),
                    lora=None, freeze_encoder=False, focal_gamma=args.focal_gamma,
                    seed=args.seed)
    trainer = SFTTrainer(fusion, cfg, device=device)
    collate = functools.partial(sft_collate, processor=proc, max_length_text=512,
                                max_length_dna=max_len_dna, supervise_eos=args.supervise_eos)
    probe = functools.partial(teacher_forced_probe, fusion_cfg=fusion, processor=proc,
                              markers=MARKERS, batch_size=args.batch_size,
                              max_length_text=512, max_length_dna=max_len_dna,
                              supervise_eos=args.supervise_eos)

    history = []
    step = 0
    t0 = time.time()
    for batch in batch_iterator(train_items, collate, args.batch_size, seed=args.seed,
                                epochs=None):
        m = trainer.train_step(batch)
        step += 1
        if step % args.probe_every == 0 or step == args.steps:
            tr = probe(trainer.model, examples=train_items[:args.probe_n])
            te = probe(trainer.model, examples=test_items[:args.probe_n])
            row = {"step": step, "loss": float(m["loss"]), "train": tr, "test": te,
                   "wall_s": round(time.time() - t0, 1)}
            history.append(row)
            print(f"[diagnose] step {step} loss {row['loss']:.4f} | "
                  f"train base {tr['base_acc']:.2f} half {tr['half_acc']:.2f} "
                  f"ans {tr['answer_acc']:.2f} span {tr['span_acc']:.3f} | "
                  f"test base {te['base_acc']:.2f} half {te['half_acc']:.2f} "
                  f"ans {te['answer_acc']:.2f} span {te['span_acc']:.3f}", flush=True)
        if step >= args.steps:
            break

    result = {"args": vars(args), "platform": device.type, "card": None, "history": history}
    if device.type == "cuda":
        from bioreason_tpu_torch.tools.bench_serve import card_name
        result["card"] = card_name()

    if args.gen_eval_n:
        engine = GenerationEngine(fusion, eos_token_id=tok.eos_token_id, device=device)
        res = evaluate_generative(
            engine, trainer.model, proc, test_items[:args.gen_eval_n], labels=("x", "y"),
            sampling=SamplingConfig(max_new_tokens=288), max_new_tokens=288,
            batch_size=args.batch_size, greedy=True, max_length_text=512,
            max_length_dna=max_len_dna)
        acc = multilabel_substring_accuracy(res.generations)
        print(f"[diagnose] generative substring accuracy: {acc:.3f}", flush=True)
        for g in res.generations[:3]:
            print(f"  truth={g['ground_truth']!r}\n  gen  ={g['generation'][:300]!r}")
        result["generative_accuracy"] = acc
        result["samples"] = [{"truth": g["ground_truth"], "gen": g["generation"]}
                             for g in res.generations[:8]]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(result, f, indent=2)
        print(f"[diagnose] -> {args.out}", flush=True)
    return result


if __name__ == "__main__":
    main()
