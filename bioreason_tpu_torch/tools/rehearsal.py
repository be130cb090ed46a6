"""End-to-end quality rehearsal of the port: curate -> SFT -> best-k select ->
generative test -> GRPO -> test again (the port of tools/rehearsal.py).

No real checkpoints or datasets are needed: the rehearsal trains the
towers FROM SCRATCH on a LEARNABLE synthetic KEGG corpus (the answer is a
function of the variant base and the half of the sequence it sits in,
`data/kegg.synthetic_kegg_items(learnable=True)`) with held-out val and
test splits, through the port's own entry points:

  corpus JSON dir -> cli.train_sft (--no_lora --dna_model_finetune, the
  val loop, the teacher-forced probe's stop and best-k retention) ->
  generative substring test of the BEST checkpoint -> cli.reason (GRPO,
  LoRA r32/a64 over the SFT weights, correctness + soft_format rewards) ->
  the generative test again.

The argv of both stages is the JAX tool's. bench is Qwen3-0.6B + NT-v2-50M
(its 32-wide heads take the plain attention path, models/attention.py; the
decoder runs flash_fwd / flash_bwd in every layer on the card), 1,280 items,
40 SFT epochs at most, 80 GRPO steps; tiny is the tiny presets, 64 items, 2
epochs, 2 steps.

It writes one artifact with the JAX artifact's keys (the val-loss, probe
and train-loss curves of the SFT run, the GRPO reward curve, the test
accuracy after each stage, the wall time of each stage), `platform` the
device type and `card` the card's name and power limit (nvidia-smi; None on
the CPU), by default to bioreason_tpu_torch/artifacts/rehearsal_<scale>.json
(`default_out`): never the repository's artifacts/, which holds the JAX
package's TPU result.

    python -m bioreason_tpu_torch.tools.rehearsal --scale bench --seq_len 32   # on the card
    python -m bioreason_tpu_torch.tools.rehearsal --scale tiny --device cpu

Working files (corpus, checkpoints, logs, generations) go to --work_dir,
by default bioreason_tpu_torch/build/rehearsal_<scale> (ignored by git).
The artifact is written once the SFT stage's test is done (the GRPO fields
None) and again at the end, so a run cut by a time limit in the GRPO stage
keeps its SFT record. --resume_sft reuses the
SFT stage of an earlier run in the same work dir. --eval_every and
--max_new cut a run for time (a smoke run); 0 keeps the scale's recipe.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE_MARKERS = '{"base": "substitutes ", "half": " in the ", "answer": "Answer: "}'
GRPO_LORA = (32, 64)


def default_out(scale: str) -> str:
    """The artifact's default path, inside the port's package."""
    return os.path.join(PACKAGE, "artifacts", f"rehearsal_{scale}.json")


def write_corpus(dir_path: str, n: int, seq_len: int, seed: int,
                 fixed_positions: bool = True) -> int:
    """A corpus directory in the KEGG per-variant JSON format
    (question / answer / reasoning.reasoning_steps / sequences), one file
    per item, the same files as the JAX tool's from the same seed."""
    from bioreason_tpu_torch.data.kegg import synthetic_kegg_items
    if os.path.isdir(dir_path):
        shutil.rmtree(dir_path)
    os.makedirs(dir_path)
    items = synthetic_kegg_items(n, seq_len=seq_len, seed=seed, learnable=True,
                                 fixed_positions=fixed_positions)
    for i, it in enumerate(items):
        rec = {
            "question": it["question"],
            "answer": it["answer"],
            "reasoning": {"reasoning_steps": it["reasoning"].split("\n")},
            "reference_sequence": it["reference_sequence"],
            "variant_sequence": it["variant_sequence"],
        }
        with open(os.path.join(dir_path, f"variant_{i:05d}_item.json"), "w",
                  encoding="utf-8") as f:
            json.dump(rec, f)
    return len(items)


def load_curve(log_dir: str, key: str):
    """[[step, value], ...] of `key` in <log_dir>/metrics.jsonl."""
    path = os.path.join(log_dir, "metrics.jsonl")
    curve = []
    if not os.path.exists(path):
        return curve
    with open(path, encoding="utf-8") as f:
        for line in f:
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            if key in row:
                curve.append([row.get("step", len(curve)), row[key]])
    return curve


def recipe(args) -> dict:
    """The scale's recipe: the numbers both stages and the tests run with
    (the JAX tool's; --items, --sft_epochs, --grpo_steps, --eval_every and
    --max_new override them)."""
    tiny = args.scale == "tiny"
    return {
        "items": args.items or (64 if tiny else 1280),
        # bench: a 40-epoch CAP; the SFT stage stops on the teacher-forced
        # probe (--stop_probe_acc), since the val loss converges on the ~250
        # template tokens while the two DNA-dependent ones may sit at chance
        "sft_epochs": args.sft_epochs or (2 if tiny else 40),
        "grpo_steps": args.grpo_steps or (2 if tiny else 80),
        "decoder": "tiny" if tiny else "qwen3-0.6b",
        # NT-v2-50M, not 500M: both towers are trained in full from scratch
        "encoder": "tiny" if tiny else "nt-50m",
        "batch": 4 if tiny else 8,
        "lr": 3e-3 if tiny else 3e-4,
        # byte-level tokens: the assistant span (<think> reasoning + "Answer:
        # <pathway>") is ~230-280 characters; fewer tokens cut it before the
        # answer
        "max_new": args.max_new or 288,
        "eval_every": args.eval_every or (4 if tiny else 96),
    }


def make_record(args, card, split, best, sft_logs, grpo_logs, acc_sft=None, acc_grpo=None,
                sft_wall=None, grpo_wall=None, eval_wall=None) -> dict:
    """The artifact, with the JAX artifact's keys and `card`; what a run has
    not measured (yet) is None, and its curves hold what its logs hold."""
    r = recipe(args)
    return {
        "scale": args.scale,
        "decoder": r["decoder"], "encoder": r["encoder"],
        "platform": "cuda" if card else "cpu",
        "card": card,
        "corpus": {"items": r["items"], "seq_len": args.seq_len,
                   "dna_kmer": args.dna_kmer,
                   "learnable": True,
                   "fixed_positions": not args.free_positions,
                   "seed": args.seed,
                   "split": split},
        "sft": {"epochs_cap": r["sft_epochs"], "batch_size": r["batch"],
                "learning_rate": r["lr"], "supervise_eos": True,
                "stop_probe_acc": 0.95,
                "full_finetune": True, "train_encoder": True,
                # relative to the checkout when the work dir is inside it
                "best_checkpoint": (os.path.relpath(best, os.path.dirname(PACKAGE))
                                    if best and best.startswith(os.path.dirname(PACKAGE) + os.sep)
                                    else best),
                "val_loss_curve": load_curve(sft_logs, "val/loss"),
                "probe_curves": {
                    k: load_curve(sft_logs, f"val/probe_{k}")
                    for k in ("base_acc", "half_acc", "answer_acc", "span_acc")},
                "train_loss_tail": load_curve(sft_logs, "train/loss")[-10:],
                "wall_s": sft_wall,
                "resumed": bool(args.resume_sft)},
        "test_accuracy_after_sft": acc_sft,
        "grpo": {"steps": r["grpo_steps"], "num_generations": 8,
                 "reward_funcs": ["correctness", "soft_format"],
                 "reward_curve": load_curve(grpo_logs, "grpo/reward"),
                 "wall_s": grpo_wall},
        "test_accuracy_after_grpo": acc_grpo,
        "accuracy_delta": (None if acc_grpo is None or acc_sft is None
                           else round(acc_grpo - acc_sft, 4)),
        "eval_wall_s": eval_wall,
    }


def write_record(record: dict, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(record, f, indent=2)
    print(f"[rehearsal] artifact -> {path}", flush=True)


def load_grpo_model(grpo_final: str, sft_checkpoint: str, fusion_cfg, seed: int,
                    decoder: str, encoder: str, device):
    """The model `reason` trained: the SFT model of `sft_checkpoint` as
    `reason --sft_checkpoint` builds it (adapters merged, fresh r32/a64
    adapters), the trained parameters of `grpo_final` loaded and the frozen
    ones stored as the GRPO trainer stores them (bf16)."""
    import torch

    from bioreason_tpu_torch.config import GRPOConfig, LoRAConfig
    from bioreason_tpu_torch.train.checkpoint import load_checkpoint, load_sft_for_grpo
    from bioreason_tpu_torch.train.trainable import store_frozen
    model = load_sft_for_grpo(sft_checkpoint, fusion_cfg, LoRAConfig(*GRPO_LORA), seed,
                              decoder, encoder, device=device)
    trained = load_checkpoint(grpo_final)["trainable"]
    params = dict(model.named_parameters())
    missing = sorted(set(trained) - set(params))
    if missing:
        raise ValueError(f"{grpo_final} holds parameters the model lacks: {missing[:4]}")
    with torch.no_grad():
        for name, t in trained.items():
            params[name].data = t.to(params[name].device)
    store_frozen(model, GRPOConfig().frozen_dtype, lambda name: name not in trained)
    return model.requires_grad_(False)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scale", default="bench", choices=["tiny", "bench"],
                    help="tiny = the rehearsal's mechanics at the tiny presets; bench = "
                         "Qwen3-0.6B + NT-v2-50M")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--items", type=int, default=0, help="0 = scale default")
    ap.add_argument("--seq_len", type=int, default=96)
    ap.add_argument("--free_positions", action="store_true",
                    help="the mismatch anywhere in the sequence instead of the default "
                         "two fixed loci (synthetic_kegg_items)")
    ap.add_argument("--dna_kmer", type=int, default=1,
                    help="base-level DNA tokens by default: the task is a single-base "
                         "substitution, which 6-mer tokens turn into memorization")
    ap.add_argument("--sft_epochs", type=int, default=0, help="0 = scale default")
    ap.add_argument("--dtype", default=None,
                    help="compute dtype of both towers in both stages and the tests; "
                         "on the card float32 runs the fp32 flash kernels "
                         "(csrc/flash_f32.cu), bfloat16 the tensor-core ones")
    ap.add_argument("--grpo_steps", type=int, default=0, help="0 = scale default")
    ap.add_argument("--eval_every", type=int, default=0,
                    help="SFT validation period; 0 = scale default (a cut for time)")
    ap.add_argument("--max_new", type=int, default=0,
                    help="tokens generated in the tests and rollouts; 0 = 288 (a cut for "
                         "time: the answer comes after ~230-280 bytes)")
    ap.add_argument("--work_dir", default=None,
                    help="default bioreason_tpu_torch/build/rehearsal_<scale>")
    ap.add_argument("--resume_sft", action="store_true",
                    help="skip the SFT stage and reuse the checkpoints and logs already in "
                         "--work_dir (the best-k keeper's best)")
    ap.add_argument("--out", default=None,
                    help="artifact path (default bioreason_tpu_torch/artifacts/"
                         "rehearsal_<scale>.json)")
    ap.add_argument("--seed", type=int, default=7)
    return ap.parse_args(argv)


def main(argv=None):
    """Run the rehearsal; returns the artifact (a dict)."""
    args = parse_args(argv)
    import torch

    from bioreason_tpu_torch.cli import reason as reason_cli
    from bioreason_tpu_torch.cli import train_sft as train_sft_cli
    from bioreason_tpu_torch.cli.common import DECODER_PRESETS, ENCODER_PRESETS, load_items
    from bioreason_tpu_torch.config import FusionConfig, SamplingConfig
    from bioreason_tpu_torch.data import BioProcessor, ByteTextTokenizer, KmerTokenizer
    from bioreason_tpu_torch.generate.engine import GenerationEngine
    from bioreason_tpu_torch.train.checkpoint import TopKKeeper, load_sft_model
    from bioreason_tpu_torch.train.eval import evaluate_generative, \
        multilabel_substring_accuracy
    from bioreason_tpu_torch.utils.devices import resolve_device

    device = resolve_device(args.device)
    card = None
    if device.type == "cuda":
        from bioreason_tpu_torch.tools.bench_serve import card_name
        card = card_name()
        print(f"[rehearsal] card: {card}", flush=True)
    r = recipe(args)
    tiny = args.scale == "tiny"
    n_items, sft_epochs, grpo_steps = r["items"], r["sft_epochs"], r["grpo_steps"]
    decoder, encoder, batch, lr = r["decoder"], r["encoder"], r["batch"], r["lr"]
    max_new, eval_every = r["max_new"], r["eval_every"]
    max_len_dna = args.seq_len + 8       # base-level tokens + CLS + slack
    max_len_text = 512

    work = os.path.abspath(args.work_dir or os.path.join(PACKAGE, "build",
                                                         f"rehearsal_{args.scale}"))
    os.makedirs(work, exist_ok=True)
    corpus_dir = os.path.join(work, "corpus")
    sft_ckpt_dir = os.path.join(work, "sft_ckpt")
    grpo_ckpt_dir = os.path.join(work, "grpo_ckpt")
    sft_logs = os.path.join(work, "sft_logs")
    grpo_logs = os.path.join(work, "grpo_logs")
    clean = ((grpo_ckpt_dir, grpo_logs) if args.resume_sft
             else (sft_ckpt_dir, grpo_ckpt_dir, sft_logs, grpo_logs))
    for d in clean:
        if os.path.isdir(d):
            shutil.rmtree(d)
    out_path = args.out or default_out(args.scale)

    if not (args.resume_sft and os.path.isdir(corpus_dir)):
        print(f"[rehearsal] curating {n_items} learnable items -> {corpus_dir}", flush=True)
        write_corpus(corpus_dir, n_items, args.seq_len, args.seed,
                     fixed_positions=not args.free_positions)

    t_start = time.time()
    common = ["--data_dir", corpus_dir, "--dataset_type", "kegg",
              "--truncate_dna_per_side", "0",
              "--max_length_text", str(max_len_text),
              "--max_length_dna", str(max_len_dna),
              "--dna_kmer", str(args.dna_kmer),
              "--seed", str(args.seed), "--batch_size", str(batch),
              "--device", device.type]
    if args.dtype:
        common += ["--dtype", args.dtype]

    # ---- stage 1: SFT with the val loop, the probe's stop and best-k ----------
    # --supervise_eos: a model trained from scratch must learn to stop.
    # --stop_probe_acc 0.95: converged enough to answer free-running, with
    # headroom left for GRPO to improve on
    sft_argv = common + [
        "--decoder", decoder, "--encoder", encoder,
        "--no_lora", "--dna_model_finetune", "--supervise_eos",
        "--probe_markers", PROBE_MARKERS, "--stop_probe_acc", "0.95",
        "--learning_rate", str(lr), "--num_epochs", str(sft_epochs),
        "--eval_every", str(eval_every), "--keep_top_k", "2",
        "--checkpoint_dir", sft_ckpt_dir, "--log_dir", sft_logs]
    if args.resume_sft:
        print(f"[rehearsal] --resume_sft: skipping stage 1, reusing {sft_ckpt_dir}",
              flush=True)
    else:
        print(f"[rehearsal] SFT: {' '.join(sft_argv)}", flush=True)
        train_sft_cli.main(sft_argv)
    t_sft = time.time()

    # ---- best-k select --------------------------------------------------------
    keeper = TopKKeeper(os.path.join(sft_ckpt_dir, "best"), k=2)
    best = keeper.best_path() or os.path.join(sft_ckpt_dir, "sft_final")
    print(f"[rehearsal] best SFT checkpoint: {best}", flush=True)

    # ---- the test harness -----------------------------------------------------
    tok = ByteTextTokenizer()
    proc = BioProcessor(tok, KmerTokenizer(kmer=args.dna_kmer))
    dec_cfg = DECODER_PRESETS[decoder](vocab_size=tok.vocab_size)
    enc_cfg = ENCODER_PRESETS[encoder]()
    if args.dtype:
        import dataclasses
        dec_cfg = dataclasses.replace(dec_cfg, dtype=args.dtype)
        enc_cfg = dataclasses.replace(enc_cfg, dtype=args.dtype)
    fusion_cfg = FusionConfig(decoder=dec_cfg, encoder=enc_cfg,
                              dna_pad_token_id=tok.dna_pad_id,
                              max_length_text=max_len_text, max_length_dna=max_len_dna)
    # the split both CLIs make (load_items -> split_dataset(seed))
    train_items, val_items, test_items = load_items("kegg", corpus_dir, 0, 0, args.seed)
    print(f"[rehearsal] split: {len(train_items)} train / {len(val_items)} val / "
          f"{len(test_items)} test", flush=True)
    engine = GenerationEngine(fusion_cfg, eos_token_id=tok.eos_token_id, device=device)
    uniq = sorted({ex["answer"].strip() for ex in test_items})
    labels = tuple(uniq[:2]) if len(uniq) >= 2 else (uniq[0], uniq[0])

    def test_accuracy(model, tag):
        t0 = time.time()
        res = evaluate_generative(
            engine, model, proc, test_items, labels=labels,
            sampling=SamplingConfig(max_new_tokens=max_new), max_new_tokens=max_new,
            batch_size=max(batch, 8), greedy=True,
            csv_path=os.path.join(work, f"generations_{tag}.csv"),
            max_length_text=max_len_text, max_length_dna=max_len_dna)
        acc = multilabel_substring_accuracy(res.generations)
        print(f"[rehearsal] {tag}: substring accuracy {acc:.4f} "
              f"({sum(g['contains_ground_truth'] for g in res.generations)}/"
              f"{len(res.generations)}) in {time.time() - t0:.1f} s", flush=True)
        return acc

    sft_model = load_sft_model(best, fusion_cfg, args.seed, decoder, encoder, device)
    acc_sft = test_accuracy(sft_model, "sft")
    del sft_model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_eval1 = time.time()
    split = [len(train_items), len(val_items), len(test_items)]
    sft_wall = None if args.resume_sft else round(t_sft - t_start, 1)
    # the record so far: a run cut by a time limit keeps its SFT stage's
    write_record(make_record(args, card, split, best, sft_logs, grpo_logs, acc_sft,
                             sft_wall=sft_wall, eval_wall=round(t_eval1 - t_sft, 1)), out_path)

    # ---- stage 2: GRPO on the best SFT checkpoint -----------------------------
    grpo_argv = common + [
        "--decoder", decoder, "--encoder", encoder,
        "--sft_checkpoint", best,
        "--reward_funcs", "correctness", "soft_format",
        "--num_generations", "8", "--max_steps", str(grpo_steps),
        # LoRA-only training: 3e-5
        "--learning_rate", "2e-5" if tiny else "3e-5",
        "--max_completion_length", str(max_new),
        "--lora_r", str(GRPO_LORA[0]), "--lora_alpha", str(GRPO_LORA[1]),
        "--checkpoint_dir", grpo_ckpt_dir, "--log_dir", grpo_logs]
    # the GRPO batch is prompts x G: 2 prompts of G = 8 (1 at tiny)
    grpo_argv[grpo_argv.index("--batch_size") + 1] = str(8 * (1 if tiny else 2))
    print(f"[rehearsal] GRPO: {' '.join(grpo_argv)}", flush=True)
    reason_cli.main(grpo_argv)
    t_grpo = time.time()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    grpo_model = load_grpo_model(os.path.join(grpo_ckpt_dir, "grpo_final"), best, fusion_cfg,
                                 args.seed, decoder, encoder, device)
    acc_grpo = test_accuracy(grpo_model, "grpo")
    del grpo_model
    t_eval2 = time.time()

    artifact = make_record(args, card, split, best, sft_logs, grpo_logs, acc_sft, acc_grpo,
                           sft_wall, round(t_grpo - t_eval1, 1),
                           round((t_eval1 - t_sft) + (t_eval2 - t_grpo), 1))
    write_record(artifact, out_path)
    print(json.dumps({k: artifact[k] for k in
                      ("test_accuracy_after_sft", "test_accuracy_after_grpo",
                       "accuracy_delta")}), flush=True)
    return artifact


if __name__ == "__main__":
    main()
