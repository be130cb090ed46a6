"""GRPO rollout throughput: the port of bench_rollout.py.

bench_rollout.py's workload: an NT-v2-500M encoder and a Qwen3 decoder
(`--decoder`, Qwen3-0.6B by default, 151,936-token head) with weights from
seed 0 and no adapter, --prompts prompts of 256 text tokens, each holding
2 x 128 <|dna_pad|> placeholders after its first token for 2 DNA sequences
of 128 random 6-mer ids, x G = --g completions each (16 x 8 = 128 rows):
one prefill per prompt and G completions decoding against its shared
prompt cache (`GenerationEngine.generate(group_size=G)`), sampled at
temperature 0.6, top-p 0.95, top-k 20 with no EOS (-1), so every row
decodes --new tokens. `--frozen int8` stores every dense of both towers,
the embedding and the head int8 (`quantize_frozen_int8(include_embed=True)`,
the serving configuration); `--kv int8` stores the prompt and decode KV
caches int8 (the grouped int8 decode); `--fuse` fuses q/k/v and gate/up
(train/fuse.py).

    python -m bioreason_tpu_torch.tools.bench_rollout                   # on the card
    python -m bioreason_tpu_torch.tools.bench_rollout --frozen int8 --kv int8
    python -m bioreason_tpu_torch.tools.bench_rollout --decoder tiny --encoder tiny \\
        --device cpu --new 8

After one warm-up call it times --reps calls and prints one JSON line:
decoded tokens/s (`grpo_rollout_tokens_per_sec_per_chip`, the median
call) with every call's, the prefill and decode seconds of the last call,
the flash_fwd launches per call, the resident weight GiB, the peak device
memory, and the card's name and power limit (nvidia-smi). `main` returns
the same numbers as a dict; `run` also returns the model, the engine and
its inputs. It writes no file. bench_rollout.py's
`vs_baseline` (a ratio to a fixed tokens/s target) is left out.
"""

from __future__ import annotations

import json
import statistics
import time

P_TEXT, L_DNA = 256, 128


def parse_args(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frozen", default="bfloat16", choices=["bfloat16", "int8"],
                    help="int8: every dense, the embedding and the head int8")
    ap.add_argument("--kv", default="bfloat16", choices=["bfloat16", "int8"],
                    help="KV cache storage (int8: the grouped int8 decode)")
    ap.add_argument("--fuse", action="store_true",
                    help="fused qkv / gateup projections (train/fuse.py)")
    ap.add_argument("--prompts", type=int, default=16)
    ap.add_argument("--g", type=int, default=8, help="completions per prompt")
    ap.add_argument("--new", type=int, default=128, help="tokens decoded per row")
    ap.add_argument("--reps", type=int, default=3, help="timed calls (the median)")
    ap.add_argument("--decoder", default="qwen3-0.6b",
                    choices=["qwen3-0.6b", "qwen3-1.7b", "qwen3-4b", "tiny"])
    ap.add_argument("--encoder", default="nt-500m", choices=["nt-500m", "tiny"])
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def build(args):
    """(model, engine, the engine's inputs) of the bench."""
    import dataclasses

    import numpy as np

    from bioreason_tpu_torch.cli.common import DECODER_PRESETS, ENCODER_PRESETS
    from bioreason_tpu_torch.config import FusionConfig
    from bioreason_tpu_torch.generate.engine import GenerationEngine
    from bioreason_tpu_torch.models.fusion import init_fusion
    from bioreason_tpu_torch.train.fuse import fuse_projections
    from bioreason_tpu_torch.train.quant import quantize_frozen_int8
    from bioreason_tpu_torch.utils.devices import resolve_device

    device = resolve_device(args.device)
    tiny = args.decoder == "tiny"
    vocab, pad_id, text_hi = (300, 260, 256) if tiny else (151936, 151938, 150000)
    cfg = FusionConfig(
        decoder=dataclasses.replace(DECODER_PRESETS[args.decoder](vocab_size=vocab),
                                    remat=False),
        encoder=dataclasses.replace(ENCODER_PRESETS[args.encoder](), remat=False),
        dna_pad_token_id=pad_id)
    model = init_fusion(cfg, seed=0, device=device).requires_grad_(False)
    if args.frozen == "int8":
        quantize_frozen_int8(model, include_embed=True)
    if args.fuse:
        fuse_projections(model)
    engine = GenerationEngine(cfg, eos_token_id=-1, device=device, kv_int8=args.kv == "int8")
    n, s_dna = args.prompts, 2 * args.prompts
    npr = np.random.default_rng(0)
    input_ids = npr.integers(0, text_hi, (n, P_TEXT)).astype(np.int32)
    for b in range(n):
        input_ids[b, 1:1 + 2 * L_DNA] = pad_id
    inputs = (input_ids, np.ones((n, P_TEXT), np.int32),
              npr.integers(6, 4102, (s_dna, L_DNA)).astype(np.int32),
              np.ones((s_dna, L_DNA), np.int32))
    return model, engine, inputs


def run(args):
    """(result dict, model, engine, inputs): the timed run, printing nothing."""
    import torch

    from bioreason_tpu_torch.config import SamplingConfig
    from bioreason_tpu_torch.ops import flash_attention as fa
    from bioreason_tpu_torch.tools.bench_serve import card_name
    from bioreason_tpu_torch.train.quant import storage_bytes

    model, engine, inputs = build(args)
    cuda = engine.device.type == "cuda"
    sampling = SamplingConfig(temperature=0.6, top_p=0.95, top_k=20)

    def call(seed):
        gen = torch.Generator(device=engine.device).manual_seed(seed)
        _, mask = engine.generate(model, *inputs, sampling=sampling, max_new_tokens=args.new,
                                  generator=gen, group_size=args.g)
        return int(mask.sum())

    call(0)                                               # warm-up
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rates, launches0 = [], fa.flash_attention.launches
    for i in range(args.reps):
        t0 = time.perf_counter()
        tokens = call(i + 1)                              # ends in a host copy
        rates.append(tokens / (time.perf_counter() - t0))
    st = engine.last_stats
    result = {
        "metric": "grpo_rollout_tokens_per_sec_per_chip", "value": statistics.median(rates),
        "unit": "tokens/s", "calls": rates, "rows": args.prompts * args.g,
        "prompts": args.prompts, "G": args.g, "new_tokens": args.new,
        "prompt_len": st["prompt_len"], "decoder": args.decoder, "encoder": args.encoder,
        "frozen": args.frozen, "kv": args.kv, "fuse": args.fuse,
        "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
        "flash_fwd_per_call": (fa.flash_attention.launches - launches0) / args.reps,
        "weights_gib": storage_bytes(model) / 2 ** 30,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "card": card_name() if cuda else None}
    return result, model, engine, inputs


def main(argv=None) -> dict:
    result = run(parse_args(argv))[0]
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
