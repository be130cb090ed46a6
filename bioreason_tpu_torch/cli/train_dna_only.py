"""DNA-only classifier training CLI of the port (the counterpart of
bioreason_tpu/cli/train_dna_only.py; reference train_dna_only.py:457-501).

Synthetic smoke run on the CPU:
  python -m bioreason_tpu_torch.cli.train_dna_only --encoder tiny --device cpu \\
      --batch_size 4 --num_epochs 2 --max_length_dna 128

On the card (the default device), NT-v2-500M with weights drawn from
--seed, the encoder frozen (--finetune_encoder trains it too, at
--encoder_lr_scale times the head's updates, through flash_bwd):
  python -m bioreason_tpu_torch.cli.train_dna_only --max_steps 8

Classes are the sorted answers of the items (a local KEGG --data_dir, or
the synthetic corpus). Each step logs one line of metrics; a test pass
follows training, then the trained parameters go to
<checkpoint_dir>/dna_only_final with what draws the rest again
(`train.checkpoint.load_classifier` rebuilds it). As in the JAX CLI, the
learning rate is --learning_rate (its common default 2e-5), not the
trainer's own 1e-3 default. --debug_nans raises FloatingPointError at the
first op that makes a NaN (utils/debug_nans.py). The device mesh and wandb
come with later slices: `main` refuses their flags.
"""

from __future__ import annotations

import argparse
import functools
import os

import numpy as np

# flags of the JAX CLI whose paths are not ported yet
LATER_FLAGS = ("wandb", "mesh", "cpu_devices")


def parse_args(argv=None):
    from bioreason_tpu_torch.cli.common import DATASET_TYPES, ENCODER_PRESETS
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--encoder", default="nt-500m", choices=sorted(ENCODER_PRESETS))
    p.add_argument("--train_just_classifier", action="store_true", default=True)
    p.add_argument("--finetune_encoder", dest="train_just_classifier", action="store_false")
    p.add_argument("--encoder_lr_scale", type=float, default=0.1)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    # the JAX CLI's common flags (bioreason_tpu/cli/common.py:84-108)
    p.add_argument("--dataset_type", default="kegg", choices=DATASET_TYPES)
    p.add_argument("--data_dir", default=None, help="JSON dir; synthetic corpus if unset")
    p.add_argument("--n_synthetic", type=int, default=64)
    p.add_argument("--truncate_dna_per_side", type=int, default=1024)
    p.add_argument("--max_length_text", type=int, default=512)
    p.add_argument("--max_length_dna", type=int, default=2048)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--learning_rate", type=float, default=2e-5)
    p.add_argument("--num_epochs", type=int, default=1)
    p.add_argument("--max_steps", type=int, default=0, help="0 = epoch-bounded")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--checkpoint_dir", default="checkpoints")
    p.add_argument("--log_dir", default="logs")
    p.add_argument("--debug_nans", action="store_true",
                   help="raise FloatingPointError at the first op that makes a NaN "
                        "(jax_debug_nans' counterpart; syncs every op)")
    for flag in LATER_FLAGS:
        p.add_argument(f"--{flag}", nargs="?", const=True, default=None,
                       help="not ported yet (raises)")
    args = p.parse_args(argv)
    asked = [f"--{f}" for f in LATER_FLAGS if getattr(args, f) is not None]
    if asked:
        raise NotImplementedError(f"{', '.join(asked)}: not ported to bioreason_tpu_torch yet")
    return args


def main(argv=None):
    args = parse_args(argv)
    from bioreason_tpu_torch.utils.debug_nans import nan_checks
    with nan_checks(args.debug_nans):
        return _run(args)


def _run(args):
    from bioreason_tpu_torch.cli.common import ENCODER_PRESETS
    from bioreason_tpu_torch.config import OptimConfig
    from bioreason_tpu_torch.data.collate import classifier_collate
    from bioreason_tpu_torch.data.kegg import synthetic_kegg_items
    from bioreason_tpu_torch.data.loaders import load_local_dataset
    from bioreason_tpu_torch.data.nt_tokenizer import KmerTokenizer
    from bioreason_tpu_torch.data.utils import split_dataset, truncate_dna
    from bioreason_tpu_torch.train.classifier import ClassifierTrainer
    from bioreason_tpu_torch.train.dataflow import batch_iterator, prefetch
    from bioreason_tpu_torch.train.metrics import MetricsLogger

    raw = (load_local_dataset(args.data_dir) if args.data_dir
           else synthetic_kegg_items(args.n_synthetic, seq_len=512, seed=args.seed))
    raw = [truncate_dna(dict(x), args.truncate_dna_per_side) for x in raw]
    train_items, _, test_items = split_dataset(raw, seed=args.seed)

    labels = sorted({it["answer"] for it in raw})
    label2id = {lab: i for i, lab in enumerate(labels)}
    print(f"{len(labels)} classes: {labels[:8]}{'...' if len(labels) > 8 else ''}")

    tok = KmerTokenizer()
    cfg = ENCODER_PRESETS[args.encoder]()
    steps = max(1, len(train_items) // args.batch_size) * args.num_epochs
    trainer = ClassifierTrainer(
        cfg, num_classes=len(labels),
        optim=OptimConfig(learning_rate=args.learning_rate or 1e-3, total_steps=steps),
        train_just_classifier=args.train_just_classifier,
        encoder_lr_scale=args.encoder_lr_scale, seed=args.seed, device=args.device)

    collate = functools.partial(classifier_collate, dna_tokenizer=tok, label2id=label2id,
                                max_length=args.max_length_dna, bucket=128)
    logger = MetricsLogger(args.log_dir)

    step = 0
    for batch in prefetch(batch_iterator(train_items, collate, args.batch_size,
                                         seed=args.seed, epochs=args.num_epochs)):
        m = trainer.train_step(batch)
        logger.log({f"train/{k}": v for k, v in m.items()}, step=step)
        step += 1
        if args.max_steps and step >= args.max_steps:
            break

    if test_items:
        agg = [trainer.eval_step(batch)
               for batch in batch_iterator(test_items, collate, args.batch_size,
                                           shuffle=False, epochs=1, drop_last=False)]
        mean = {k: float(np.mean([a[k] for a in agg])) for k in agg[0]} if agg else {}
        logger.log({f"test/{k}": v for k, v in mean.items()}, step=step)

    ckpt = os.path.join(args.checkpoint_dir, "dna_only_final")
    trainer.save(ckpt, args.encoder, labels)
    print(f"saved checkpoint to {ckpt}")
    logger.close()
    return trainer


if __name__ == "__main__":
    main()
