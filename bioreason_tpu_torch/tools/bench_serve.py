"""Serving throughput under request churn: the port of bench_serve.py.

Drives the continuous batcher (generate/continuous.py) at the serving
shape: an NT-v2-500M encoder and a Qwen3-0.6B decoder (151,936-token head)
with weights from seed 0, stored int8 by default as the JAX bench stores
them (`--frozen int8`: every dense, the embedding and the head, per-channel
scales, train/quant.py; `--frozen bfloat16` for bf16), and a queue of
DNA-spliced requests
(prompts of 256 text tokens holding 128 <|dna_pad|> placeholders, one DNA
sequence of 128 k-mer tokens each) with completion lengths of max_new,
max_new / 2 and max_new / 4 in rotation, admitted as slots free up, sampled
at temperature 0.6, top-p 0.95, top-k 20 with no EOS (-1), decode windows
of 16 tokens per host round trip and one window in flight
(`run_pipelined`) unless --no_pipeline. `--kv int8` stores the pools int8,
`--fuse` fuses q/k/v and gate/up (train/fuse.py), `--w8a8` (with
`--frozen int8`) quantizes the admission prefill's activations per token.

    python -m bioreason_tpu_torch.tools.bench_serve            # on the card
    python -m bioreason_tpu_torch.tools.bench_serve --tiers 96x640,40x2048
    python -m bioreason_tpu_torch.tools.bench_serve --kv int8 --fuse --w8a8
    python -m bioreason_tpu_torch.tools.bench_serve --decoder tiny --encoder tiny \\
        --device cpu --capacity 4 --max_new 8 --max_len 64 --prompt_len 64 --dna_len 16

After a warmup (one admission and one window, discarded) it times ONE run
of --requests requests (default 3 x capacity: the pool stays full with a
real admission queue) and prints one JSON line: decoded tokens/s
(`serving_tokens_per_sec_per_chip`, or `..._tiered`), the admit / decode
split of the host's time, the windows and the mean slot occupancy, the
prefill calls and the flash_fwd launches they made, the pools' GiB, the
resident weights' GiB, the peak device memory, and the card's name and
power limit (nvidia-smi).
`main` returns the same numbers as a dict. It writes no file. `drive` runs
the same bench on a model the caller built (a configuration no preset
names, e.g. a Qwen3-MoE decoder) with these options' shape.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

def card_name() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0].strip()


def parse_args(argv=None):
    import argparse
    from bioreason_tpu_torch.cli.common import DECODER_PRESETS, ENCODER_PRESETS
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--decoder", default="qwen3-0.6b", choices=sorted(DECODER_PRESETS))
    ap.add_argument("--encoder", default="nt-500m", choices=sorted(ENCODER_PRESETS))
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--frozen", default="int8", choices=["bfloat16", "int8"],
                    help="weight storage (int8: train/quant.py with the embedding and head)")
    ap.add_argument("--capacity", type=int, default=64)
    ap.add_argument("--requests", type=int, default=0,
                    help="0 = 3 x capacity (a real admission queue; fewer requests than "
                         "capacity measure a draining pool)")
    ap.add_argument("--window", type=int, default=16,
                    help="decode steps per host round trip (step_window)")
    ap.add_argument("--max_new", type=int, default=128)
    ap.add_argument("--max_len", type=int, default=256, help="prompt-pool width")
    ap.add_argument("--prompt_len", type=int, default=256,
                    help="text tokens per prompt (also the admission's width bucket)")
    ap.add_argument("--dna_len", type=int, default=128,
                    help="DNA tokens per prompt (as many <|dna_pad|> placeholders)")
    ap.add_argument("--kv", default="bfloat16", choices=["bfloat16", "int8"],
                    help="pool KV storage; int8 halves the pools' bytes")
    ap.add_argument("--fuse", action="store_true",
                    help="fused qkv / gateup projections (train/fuse.py)")
    ap.add_argument("--w8a8", action="store_true",
                    help="int8 activations too (cfg.act_int8) in the admission prefill")
    ap.add_argument("--shared", type=int, default=1,
                    help="requests per unique prompt (> 1: same-batch dedupe and the "
                         "prefix cache, GRPO-style G-completion serving)")
    ap.add_argument("--probe", action="store_true",
                    help="print the host phase timers (upload / admit / dispatch / "
                         "toks_wait / replay / pack) to stderr")
    ap.add_argument("--no_pipeline", action="store_true",
                    help="the serial admit / step_window loop instead of run_pipelined")
    ap.add_argument("--tiers", default=None,
                    help="KV depth classes 'CAPxLEN,CAPxLEN' (serve --tiers): one pool per "
                         "class and length-routed mixed-prompt churn")
    args = ap.parse_args(argv)
    if args.w8a8 and args.frozen != "int8":
        ap.error("--w8a8 requires --frozen int8 (act_int8 needs int8 kernels)")
    if not args.requests:
        args.requests = 3 * args.capacity
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    import dataclasses

    from bioreason_tpu_torch.cli.common import DECODER_PRESETS, ENCODER_PRESETS
    from bioreason_tpu_torch.config import FusionConfig
    from bioreason_tpu_torch.models.fusion import init_fusion
    from bioreason_tpu_torch.serve import serving_storage
    from bioreason_tpu_torch.utils.devices import resolve_device

    device = resolve_device(args.device)
    dec = dataclasses.replace(DECODER_PRESETS[args.decoder](), remat=False,
                              act_int8=args.w8a8)
    cfg = FusionConfig(decoder=dec, encoder=dataclasses.replace(
        ENCODER_PRESETS[args.encoder](), remat=False, act_int8=args.w8a8),
        dna_pad_token_id=dec.vocab_size + 2)
    model = init_fusion(cfg, seed=0, device=device).requires_grad_(False)
    serving_storage(model, int8=args.frozen == "int8", fuse=args.fuse)
    return drive(model, cfg, args)


def drive(model, cfg, args) -> dict:
    """The bench on a built `model` of `cfg`: what `main` times once it has
    drawn the presets' weights. `args` (`parse_args`) gives the bench's
    shape; its --decoder, --encoder, --frozen, --fuse and --w8a8 are not
    read: the result reports the storage read off `model` and `cfg`.
    Returns the result dict and prints it as one JSON line."""
    import numpy as np
    import torch

    from bioreason_tpu_torch.config import SamplingConfig
    from bioreason_tpu_torch.generate.continuous import ContinuousBatcher, Request
    from bioreason_tpu_torch.ops import flash_attention as fa
    from bioreason_tpu_torch.serve import _parse_tiers
    from bioreason_tpu_torch.train.quant import storage_bytes

    device = next(model.parameters()).device
    int8 = any(t.dtype == torch.int8 for t in model.buffers())
    fuse = any(name.rsplit(".", 1)[-1] in ("qkv", "gateup") for name, _ in model.named_modules())
    cuda = device.type == "cuda"
    dec = cfg.decoder
    sampling = SamplingConfig(temperature=0.6, top_p=0.95, top_k=20)
    l_dna = args.dna_len
    npr = np.random.default_rng(0)
    prompts = {}

    def make_request(rid, max_new, p_text=args.prompt_len):
        uid = (rid // args.shared, p_text)      # --shared N: N requests per prompt
        if uid not in prompts:
            ids = npr.integers(0, min(150000, dec.vocab_size), (1, p_text)).astype(np.int32)
            ids[0, 1:1 + l_dna] = cfg.dna_pad_token_id
            dna = npr.integers(6, 4102, (1, l_dna)).astype(np.int32)
            prompts[uid] = (ids, dna)
        ids, dna = prompts[uid]
        return Request(rid, ids, np.ones((1, p_text), np.int32), dna,
                       np.ones((1, l_dna), np.int32), max_new_tokens=max_new)

    # mixed completion lengths: the churn static batching cannot fill
    lengths = [args.max_new, args.max_new // 2, args.max_new // 4]

    def batcher(cap, mlen, bucket, prefix_cache=False):
        return ContinuousBatcher(model, cfg, eos_token_id=-1, capacity=cap, max_len=mlen,
                                 max_new=args.max_new, prompt_bucket=bucket, sampling=sampling,
                                 kv_int8=args.kv == "int8", prefix_cache=prefix_cache,
                                 device=device)

    def pool_gib(cbs):
        return sum(x.numel() * x.element_size() for cb in cbs
                   for entry in cb.prompt_pool + cb.dec_pool for x in entry.values()) / 2 ** 30

    if args.tiers:
        tiers = _parse_tiers(args.tiers)
        cbs = [batcher(cap, mlen, 128) for cap, mlen in tiers]
        total_cap = sum(c for c, _ in tiers)
        # per-tier prompt widths: fill each class's pool proportionally
        p_widths = [max(128, (mlen // 128) * 128 - 128) for _, mlen in tiers]
        for cb, pw in zip(cbs, p_widths):
            cb.warmup([pw], dna_shapes=((1, l_dna),), windows=(args.window,))
        reqs, i = [], 0
        for t, (cap, _) in enumerate(tiers):
            for _ in range(args.requests * cap // total_cap):
                reqs.append((t, make_request(i, lengths[i % len(lengths)], p_widths[t])))
                i += 1
        pending = {t: [r for tt, r in reqs if tt == t] for t in range(len(tiers))}

        def run():
            done = []
            while any(pending.values()) or any(cb.active.any() for cb in cbs):
                for t, cb in enumerate(cbs):
                    t0 = time.perf_counter()
                    done.extend(r for r in cb.admit_many(pending[t]) if r.done)
                    cb.timers["admit"] = cb.timers.get("admit", 0.0) + time.perf_counter() - t0
                    if cb.active.any():
                        done.extend(cb.step_window(args.window))
            return done
        metric, capacity = "serving_tokens_per_sec_per_chip_tiered", total_cap
        extra = {"tiers": tiers}
    else:
        cbs = [batcher(args.capacity, args.max_len, args.prompt_len, args.shared > 1)]
        cb = cbs[0]
        cb.warmup([args.prompt_len], dna_shapes=((1, l_dna),), windows=(args.window,))
        reqs = [make_request(i, lengths[i % len(lengths)]) for i in range(args.requests)]

        def run():
            if not args.no_pipeline:
                return cb.run_pipelined([r for r in reqs], window=args.window)
            pending, done = list(reqs), []
            while pending or cb.active.any():
                t = time.perf_counter()
                done.extend(r for r in cb.admit_many(pending) if r.done)
                cb.timers["admit"] = cb.timers.get("admit", 0.0) + time.perf_counter() - t
                done.extend(cb.step_window(args.window))
            return done
        metric, capacity = "serving_tokens_per_sec_per_chip", args.capacity
        extra = {"pipelined": not args.no_pipeline, "shared": args.shared}

    for cb in cbs:
        cb.timers = {}
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    launches0, prefills0 = fa.flash_attention.launches, sum(cb.prefill_calls for cb in cbs)
    t0 = time.perf_counter()
    done = run()
    if cuda:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if len(done) != len(reqs):
        raise RuntimeError(f"{len(done)} of {len(reqs)} requests finished")
    tokens = sum(len(r.tokens) for r in done)
    prefills = sum(cb.prefill_calls for cb in cbs) - prefills0
    launches = fa.flash_attention.launches - launches0
    tm = {k: sum(cb.timers.get(k, 0) for cb in cbs)
          for k in ("upload", "admit", "dispatch", "toks_wait", "replay", "pack", "windows",
                    "rows")}
    admit_s = tm["admit"]
    windows = tm["windows"]
    result = {
        "metric": metric, "value": tokens / dt, "unit": "tokens/s",
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "card": card_name() if cuda else None,
        "frozen": "int8" if int8 else "bfloat16", "kv": args.kv, "fuse": fuse,
        "w8a8": cfg.decoder.act_int8,
        "capacity": capacity, "requests": len(reqs), "window": args.window,
        "decoded_tokens": tokens, "seconds": dt,
        "admit_s": admit_s, "decode_s": dt - admit_s,
        "windows": windows,
        "mean_occupancy": tm["rows"] / (windows * capacity) if windows else 0.0,
        "prefill_calls": prefills, "flash_fwd_launches": launches,
        "flash_fwd_per_prefill": launches / prefills if prefills else 0.0,
        "pool_gib": pool_gib(cbs), "weights_gib": storage_bytes(model) / 2 ** 30,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None,
        **extra}
    if args.probe:
        print("window probe: " + " ".join(f"{k}={tm[k]:.3f}s" for k in
                                          ("upload", "admit", "dispatch", "toks_wait", "replay",
                                           "pack") if tm[k])
              + f" windows={windows} mean_occupancy={result['mean_occupancy']:.3f}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
