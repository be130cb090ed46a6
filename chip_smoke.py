#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (`bioreason_tpu_torch`) on one
NVIDIA H100: the quickest proof that the port builds and serves on the card.

    python3 chip_smoke.py            # needs one CUDA card

Phases, in order (any failure exits non-zero; nothing is caught and ignored):
  1. device   the card's name and power limit (nvidia-smi); TF32 off for the
              reference computations.
  2. build    compile csrc/flash_fwd.cu with nvcc for sm_90a (ptxas report).
  3. kernels  flash_fwd against its plain version (`flash_attention_ref`,
              fp32 math) in bf16 on the card at the encoder, prefill and
              q_offset shapes, with kernel, plain, bound and library
              (torch's scaled_dot_product_attention, a yardstick the port
              never calls) times.
  4. serve    the port's InferenceServer at Qwen3-0.6B + NT-v2-500M width,
              bf16, weights from a fixed seed: the kernel route against the
              plain route on one request, then 8 concurrent greedy requests
              of 2 x 2048 bp, the same 8 again, and one over HTTP. Checks that
              every request is answered, greedy repeats agree, logits are
              finite and the kernel ran in every encoder and prefill layer.
  5. profile  torch.profiler over one prefill and one short engine call of
              the same batch: device time by kernel, the device's busy share.

Before its last line it prints one JSON object {"kernels": [...]}; its last
line is {"ok": true, "device": {...}}. It exits non-zero without a result
where torch.cuda.is_available() is false or the port's package is missing.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published dense peaks (NVIDIA data sheet), for the bound
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# kernel vs plain: the kernel rounds P to bf16 before the P @ V product (as
# the Pallas kernel does) and writes bf16, the plain version keeps fp32 and
# rounds once at the end; |out| <~ 4 here, where one bf16 ulp is 2^-6
OUT_ATOL, OUT_RTOL = 2e-2, 2e-2
# the LSE is fp32 in both: same bf16 products, other summation order, __expf
LSE_ATOL = 1e-3

ENCODER_LAYERS, DECODER_LAYERS = 29, 28


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 1 -----------------------------------------------------------------

def phase_device(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return card


# -- phase 2 -----------------------------------------------------------------

def phase_build():
    from bioreason_tpu_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    report = fa.build()
    log(f"build: flash_fwd in {time.perf_counter() - t0:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")


# -- phase 3 -----------------------------------------------------------------

def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_case(torch, name, b, tq, tk, hq, hkv, d, causal, q_offset, mask, seed):
    """Kernel against plain on one shape; returns the row of numbers."""
    import torch.nn.functional as F
    from bioreason_tpu_torch.ops import flash_attention as fa
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, tq, hq, d), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((b, tk, hkv, d), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((b, tk, hkv, d), generator=g, device=dev).to(torch.bfloat16)
    qo = q_offset if q_offset is not None else (tk - tq if causal else 0)

    out, lse = fa.flash_attention(q, k, v, mask, causal=causal, q_offset=q_offset,
                                  return_lse=True)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_ref(q, k, v, mask, causal, qo)
    vis = mask.bool()[:, None, :].expand(b, tq, tk)
    if causal:
        vis = vis & (torch.arange(tk, device=dev)[None, :]
                     <= torch.arange(tq, device=dev)[:, None] + qo)
    rows = vis.any(-1)                                             # [B, Tq]
    o, r = out.float()[rows], ref_out.float()[rows]
    err = float((o - r).abs().max())
    if not torch.allclose(o, r, atol=OUT_ATOL, rtol=OUT_RTOL):
        fail(f"kernel {name}: out differs from the plain version, max abs err {err:.4g}")
    lrows = rows[:, None, :].expand(b, hq, tq)
    lse_err = float((lse[lrows] - ref_lse[lrows]).abs().max())
    if lse_err > LSE_ATOL:
        fail(f"kernel {name}: lse differs from the plain version by {lse_err:.4g}")
    empty = ~rows
    if bool(empty.any()):
        if bool(out[empty].ne(0).any()) or bool(lse.transpose(1, 2)[empty].ne(fa.NEG_INF).any()):
            fail(f"kernel {name}: fully masked rows are not (0, -1e30)")

    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, mask, causal=causal, q_offset=q_offset),
                 iters=20)
    plain_ms = cuda_ms(lambda: fa.flash_attention_ref(q, k, v, mask, causal, qo), iters=3,
                       warmup=1)
    # library yardstick: one SDPA call on the same work (layout copies and
    # the boolean mask are made before timing)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    amask = vis[:, None]
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=amask, enable_gqa=hkv != hq), iters=10)

    # the work this data needs: (query, key) pairs with a visible key; QK^T
    # and PV take 2 flops per multiply-add each
    flops = 4.0 * d * hq * float(vis.sum())
    # the bytes it needs: q rows that see a key, k/v rows that some query
    # sees (keys past the causal reach or padded out need not be read), all
    # of out and lse, and the mask
    q_rows, kv_rows = float(rows.sum()), float(vis.any(1).sum())
    nbytes = (2 * (q_rows * hq * d + 2 * kv_rows * hkv * d + out.numel())
              + 4 * lse.numel() + 4 * mask.numel())
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    row = {"shape": name, "B": b, "Tq": tq, "Tk": tk, "Hq": hq, "Hkv": hkv, "D": d,
           "causal": causal, "q_offset": qo, "max_abs_err": err, "lse_max_abs_err": lse_err,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "tflops": flops / (ms * 1e-3) / 1e12}
    log(f"kernel {name}: B={b} Tq={tq} Tk={tk} Hq={hq} Hkv={hkv} D={d} causal={causal} "
        f"q_offset={qo}: max_abs_err {err:.3g} (lse {lse_err:.3g}); ms {ms:.4f} "
        f"plain_ms {plain_ms:.3f} library_ms {library_ms:.4f} bound_ms {row['bound_ms']:.4f} "
        f"({row['bound_by']}), {row['tflops']:.1f} TFLOP/s")
    return row


def right_padded(torch, b, t, lo, gen):
    lens = torch.randint(lo, t + 1, (b,), generator=gen, device="cuda")
    return (torch.arange(t, device="cuda")[None, :] < lens[:, None]).to(torch.int32)


def left_padded(torch, b, p, extra, max_pad, gen):
    """Prompt mask [B, p + extra]: left pads, `extra` empty decode slots."""
    pads = torch.randint(0, max_pad + 1, (b,), generator=gen, device="cuda")
    pos = torch.arange(p + extra, device="cuda")[None, :]
    return ((pos >= pads[:, None]) & (pos < p)).to(torch.int32)


def served_inputs(n: int = 8):
    """The 8-request batch phase 4 serves, as `prepare_batch` hands it to
    the engine: KEGG-shaped items of 2 x 2048 bp."""
    from bioreason_tpu_torch.data.kegg import synthetic_kegg_items
    from bioreason_tpu_torch.serve import build_config, prepare_batch
    items = synthetic_kegg_items(n=n, seq_len=2048, seed=0)
    cfg, processor = build_config("qwen3-0.6b", "nt-500m", max_length_dna=2048)
    return items, prepare_batch(processor, cfg, items)


def phase_kernels(torch, max_new):
    g = torch.Generator(device="cuda").manual_seed(1)
    rows = [
        # (a) encoder, single-block regime: 16 x T=128, bidirectional, key mask
        kernel_case(torch, "encoder_T128", 16, 128, 128, 16, 16, 64, False, None,
                    right_padded(torch, 16, 128, 64, g), 11),
        # (b) encoder, tiled regime, as served: 16 x T=344 (2 kb per side), ragged
        kernel_case(torch, "encoder_T344", 16, 344, 344, 16, 16, 64, False, None,
                    right_padded(torch, 16, 344, 200, g), 12),
        # (c) decoder prefill into a cache of P + 64: causal, q_offset 0,
        # left-padded (pad queries are fully masked rows)
        kernel_case(torch, "prefill_1024", 8, 1024, 1088, 16, 8, 128, True, 0,
                    left_padded(torch, 8, 1024, 64, 300, g), 13),
        # (d) causal with q_offset > 0
        kernel_case(torch, "q_offset_960", 8, 128, 1088, 16, 8, 128, True, 960,
                    left_padded(torch, 8, 1088, 0, 200, g), 14),
    ]
    # (e) the prefill and encoder shapes and masks the serve phase gives the kernel
    _, (ids, mask, dna_ids, dna_mask) = served_inputs()
    b, p = ids.shape
    log(f"kernels: the served batch is B={b} P={p} text tokens, DNA {list(dna_ids.shape)}")
    cmask = torch.as_tensor(np.pad(mask, ((0, 0), (0, max_new))), device="cuda")
    rows.append(kernel_case(torch, f"prefill_served_P{p}", b, p, p + max_new, 16, 8, 128,
                            True, 0, cmask, 15))
    s_, t_ = dna_ids.shape
    rows.append(kernel_case(torch, f"encoder_served_T{t_}", s_, t_, t_, 16, 16, 64, False,
                            None, torch.as_tensor(dna_mask, device="cuda"), 16))
    return rows


# -- phase 4 -----------------------------------------------------------------

def phase_serve(torch, card, max_new):
    from bioreason_tpu_torch.generate.engine import GenerationEngine
    from bioreason_tpu_torch.ops import flash_attention as fa
    from bioreason_tpu_torch.serve import build_server, make_http_server, prepare_batch

    t0 = time.perf_counter()
    server = build_server("qwen3-0.6b", "nt-500m", max_length_dna=2048, seed=0,
                          max_batch=8, max_new_tokens=max_new, greedy_default=True)
    cfg = server.cfg
    dec, enc = cfg.decoder, cfg.encoder
    if (dec.num_layers, dec.hidden_size, dec.num_heads, dec.num_kv_heads, dec.head_dim,
            dec.vocab_size) != (28, 1024, 16, 8, 128, 151936):
        fail(f"decoder is not at Qwen3-0.6B width: {dec}")
    if (enc.num_layers, enc.hidden_size, enc.num_heads, enc.head_dim) != (29, 1024, 16, 64):
        fail(f"encoder is not at NT-v2-500M width: {enc}")
    n_params = sum(p.numel() for p in server.model.parameters())
    log(f"serve: model of {n_params / 1e6:.1f} M parameters (bf16, seed 0) built in "
        f"{time.perf_counter() - t0:.2f} s")
    items, _ = served_inputs()

    # the kernel route against the plain route on one request at full width
    ids, mask, dna, dmask = (torch.as_tensor(a, device="cuda")
                             for a in prepare_batch(server.processor, cfg, items[:1]))
    plain_cfg = dataclasses.replace(
        cfg, encoder=dataclasses.replace(enc, attention_impl="xla"),
        decoder=dataclasses.replace(dec, attention_impl="xla"))
    eos = server.processor.text_tokenizer.eos_token_id
    before = fa.flash_attention.launches
    k_logits = server.engine.prefill(server.model, ids, mask, dna, dmask, max_new)[0]
    if fa.flash_attention.launches - before != ENCODER_LAYERS + DECODER_LAYERS:
        fail("the kernel route did not launch flash_fwd once per encoder and prefill layer")
    p_logits = GenerationEngine(plain_cfg, eos).prefill(server.model, ids, mask, dna, dmask,
                                                        max_new)[0]
    if not (bool(torch.isfinite(k_logits).all()) and bool(torch.isfinite(p_logits).all())):
        fail("non-finite prefill logits")
    cos = float(torch.nn.functional.cosine_similarity(k_logits, p_logits, dim=-1).min())
    diff = float((k_logits - p_logits).abs().max())
    same_top = bool((k_logits.argmax(-1) == p_logits.argmax(-1)).all())
    log(f"serve: kernel vs plain route, last-column prefill logits [{k_logits.shape[0]}, "
        f"{k_logits.shape[1]}]: min cosine {cos:.6f}, max abs diff {diff:.4g} "
        f"(|logit| max {float(p_logits.abs().max()):.3g}), same argmax {same_top}")
    if cos < 0.99:
        fail(f"kernel and plain routes disagree at full width (cosine {cos:.4f})")

    server.start()
    # record what each engine call returns: with random weights most greedy
    # ids lie past the byte tokenizer's 266 ids and decode to "", so the
    # repeat check compares token ids, not only texts
    calls_out = []
    engine_generate = server.engine.generate

    def recording_generate(*args, **kw):
        ids_mask = engine_generate(*args, **kw)
        calls_out.append((ids_mask, dict(server.engine.last_stats)))
        return ids_mask
    server.engine.generate = recording_generate

    def burst(reqs):
        results = [None] * len(reqs)

        def one(i):
            results[i] = server.generate(reqs[i], max_new_tokens=max_new, greedy=True)
        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(reqs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        return results

    def rows_of(calls):
        """Completion rows of a burst as a sorted multiset (the batch order
        follows the requests' arrival, which threads do not fix)."""
        return sorted(tuple(ids[i][mask[i].astype(bool)].tolist())
                      for (ids, mask), _ in calls for i in range(ids.shape[0]))

    # --- the main path: counts from 0 just before, read just after ---------
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = 0
    calls0 = server.engine_calls
    first = burst(items)
    n_first = len(calls_out)
    second = burst(items)
    httpd = make_http_server(server, port=0, host="127.0.0.1")
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    port = httpd.server_address[1]
    body = json.dumps({"question": items[0]["question"],
                       "reference_sequence": items[0]["reference_sequence"],
                       "variant_sequence": items[0]["variant_sequence"],
                       "max_new_tokens": max_new, "greedy": True}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        http_result = json.loads(r.read())
        http_status = r.status
    launches = fa.flash_attention.launches
    calls = server.engine_calls - calls0
    peak = torch.cuda.max_memory_allocated()
    httpd.shutdown()
    httpd.server_close()
    server.stop()
    server.engine.generate = engine_generate
    # -----------------------------------------------------------------------

    answered = [r for r in first + second if r and set(r) == {"completion", "answer"}]
    if len(answered) != 16 or http_status != 200 or set(http_result) != {"completion", "answer"}:
        fail(f"not every request was answered: {first} {second} {http_result}")
    first_rows = rows_of(calls_out[:n_first])
    if len(first_rows) != 8 or first_rows != rows_of(calls_out[n_first:-1]) or first != second:
        fail("greedy repeats of the same 8 requests differ")
    if server.engine.nonfinite_rows:
        fail(f"{server.engine.nonfinite_rows} logit rows were not finite")
    if launches != (ENCODER_LAYERS + DECODER_LAYERS) * calls:
        fail(f"flash_fwd launched {launches} times in {calls} engine calls, "
             f"expected {ENCODER_LAYERS + DECODER_LAYERS} per call")
    log(f"serve: {len(answered)} + 1 requests answered in {calls} engine calls "
        f"({n_first} for the first 8); flash_fwd launches {launches} "
        f"= {launches // max(calls, 1)} per call; {sum(map(len, first_rows))} greedy "
        f"tokens per burst, identical in the repeat")
    for name, (_, st) in (("first 8", calls_out[n_first - 1]), ("same 8 again", calls_out[-2]),
                          ("http 1", calls_out[-1])):
        tps = st["decode_tokens"] / st["decode_s"] if st["decode_s"] else 0.0
        log(f"serve [{card}] {name}: B={st['batch']} P={st['prompt_len']}: prefill "
            f"(encoder + splice + prefill + first token) {st['prefill_s'] * 1e3:.1f} ms; "
            f"decode {tps:.1f} tokens/s over {st['steps'] - 1} steps "
            f"({st['decode_s'] / max(st['steps'] - 1, 1) * 1e3:.2f} ms per step)")
    log(f"serve [{card}]: torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB")
    return launches, server, items


def phase_profile(torch, card, server, items, max_new):
    """torch.profiler over one prefill and over one engine call of
    `max_new` tokens of the 8-request batch: device time by kernel and the
    device's busy share."""
    from torch.profiler import ProfilerActivity, profile
    from bioreason_tpu_torch.serve import prepare_batch
    args = [torch.as_tensor(a, device="cuda")
            for a in prepare_batch(server.processor, server.cfg, items)]
    eng = server.engine
    for name, fn in (("prefill", lambda: eng.prefill(server.model, *args, max_new)),
                     ("generate", lambda: eng.generate(server.model, *args,
                                                       max_new_tokens=max_new, greedy=True))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        n_launch = sum(e.count for e in kernels)
        log(f"profile [{card}] {name}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
            f"({100 * busy_ms / wall_ms:.1f}%), {n_launch} kernel launches")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
            log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")


# -- main ---------------------------------------------------------------------

def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs one CUDA card")
    if not os.path.isdir(os.path.join(REPO, "bioreason_tpu_torch")):
        fail(f"the port's package bioreason_tpu_torch is not beside {__file__}")
    sys.path.insert(0, REPO)

    t_start = time.perf_counter()
    max_new = 64
    card = phase_device(torch)
    phase_build()
    rows = phase_kernels(torch, max_new)
    launches, server, items = phase_serve(torch, card, max_new)
    phase_profile(torch, card, server, items, max_new=8)
    log(f"chip_smoke: all phases done in {time.perf_counter() - t_start:.1f} s")

    served = rows[-2]                  # the served prefill: the kernel's largest call
    entry = {"name": "flash_fwd", "route": "cuda",
             "source": "bioreason_tpu_torch/csrc/flash_fwd.cu",
             "replaces": "bioreason_tpu/ops/flash_attention.py:60",
             "also_replaces": "bioreason_tpu/ops/flash_attention.py:239",
             "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rows),
             "ms": served["ms"], "plain_ms": served["plain_ms"],
             "bound_ms": served["bound_ms"], "bound_by": served["bound_by"],
             "library_ms": served["library_ms"], "at_shape": served["shape"],
             "shapes": rows}
    log(json.dumps({"kernels": [entry]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
