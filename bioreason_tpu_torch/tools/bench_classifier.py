"""DNA-only classifier training throughput: the port of bench_classifier.py.

The NT-v2-500M encoder (29 layers, hidden 1024, 16 heads of 64, remat off)
frozen in bf16 with weights from seed 0, the attention pool and the MLP
head over (ref, alt) pairs, 8 classes, B = 16 pairs of L = 512 random
6-mer ids from numpy seed 0, all valid, AdamW at lr 1e-3: bench_classifier.py's
shape. Each step runs the encoder twice, `flash_fwd` in each of its 29
layers per batch.

    python -m bioreason_tpu_torch.tools.bench_classifier            # on the card

It takes no flag, as the JAX bench takes none; `main(device="cpu",
encoder="tiny")` runs it at a tiny width on the CPU.

After two warm-up steps it times 5 repetitions of 10 steps (each step ends
in the host sync of its metrics, as the JAX bench's does) and prints one
JSON line: examples/s (`classifier_examples_per_sec_per_chip`, the median
repetition) with every repetition's, ms per step, the device-busy ms and
the wall ms of one profiled step (torch.profiler, on the card), the peak
device memory, and the card's name and power limit (nvidia-smi). `main`
returns the same numbers as a dict. It writes no file.
"""

from __future__ import annotations

import json
import statistics
import time

B, L, CLASSES, STEPS, REPS = 16, 512, 8, 10, 5


def busy_ms(torch, step) -> tuple:
    """(device-busy ms, wall ms) of one step under torch.profiler: the sum of
    the device events' durations, read from the raw events."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e.duration_ns() for e in prof.profiler.kineto_results.events()
           if e.device_type() != torch.autograd.DeviceType.CPU and not e.is_user_annotation()]
    return sum(dev) / 1e6, wall


def main(argv=None, device=None, encoder: str = "nt-500m") -> dict:
    import argparse
    import dataclasses

    import numpy as np
    import torch

    from bioreason_tpu_torch.cli.common import ENCODER_PRESETS
    from bioreason_tpu_torch.config import OptimConfig
    from bioreason_tpu_torch.tools.bench_serve import card_name
    from bioreason_tpu_torch.train.classifier import ClassifierTrainer
    from bioreason_tpu_torch.utils.devices import resolve_device

    argparse.ArgumentParser(description=__doc__,
                            formatter_class=argparse.RawDescriptionHelpFormatter
                            ).parse_args(argv)
    device = resolve_device(device)
    cuda = device.type == "cuda"

    cfg = dataclasses.replace(ENCODER_PRESETS[encoder](), remat=False)
    trainer = ClassifierTrainer(cfg, num_classes=CLASSES, device=device,
                                optim=OptimConfig(learning_rate=1e-3, total_steps=100))
    npr = np.random.default_rng(0)
    batch = {
        "ref_ids": npr.integers(6, 4102, (B, L)).astype(np.int32),
        "alt_ids": npr.integers(6, 4102, (B, L)).astype(np.int32),
        "ref_attention_mask": np.ones((B, L), np.int32),
        "alt_attention_mask": np.ones((B, L), np.int32),
        "labels": npr.integers(0, CLASSES, B).astype(np.int32),
    }
    for _ in range(2):
        trainer.train_step(batch)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rates = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        for _ in range(STEPS):
            m = trainer.train_step(batch)      # its metrics sync with the host
        rates.append(B * STEPS / (time.perf_counter() - t0))
    busy = wall = None
    if cuda:
        busy, wall = busy_ms(torch, lambda: trainer.train_step(batch))
    rate = statistics.median(rates)
    result = {
        "metric": "classifier_examples_per_sec_per_chip", "value": rate, "unit": "examples/s",
        "repetitions": rates, "ms_per_step": 1e3 * B / rate, "B": B, "L": L,
        "classes": CLASSES, "steps_per_repetition": STEPS, "loss": m["loss"],
        "profiled_step_busy_ms": busy, "profiled_step_wall_ms": wall,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "card": card_name() if cuda else None}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
