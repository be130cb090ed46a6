#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (`bioreason_tpu_torch`) on one
NVIDIA H100: the quickest proof that the port builds, serves and trains on
the card.

    python3 chip_smoke.py          # needs one CUDA card

Phases, in order (any failure exits non-zero; nothing is caught and ignored):
  1. device   the card's name and power limit (nvidia-smi); TF32 off for the
              reference computations.
  2. build    compile csrc/flash_fwd.cu and csrc/flash_bwd.cu (the flash
              kernels and the banded local_* kernels, both including
              csrc/sm90.cuh) with nvcc for sm_90a, one nvcc each, started
              together; print each kernel's ptxas report (registers,
              spills) and, from `cuobjdump -sass`, its count of wgmma
              (HGMMA) and TMA (UTMALDG, UBLKCP, UBLKRED, ...) instructions.
              Fails on a spill, or where flash_fwd_kernel or flash_bwd_kernel
              lacks either kind of instruction.
  3. kernels  flash_fwd against its plain version (`flash_attention_ref`,
              fp32 math) in bf16 on the card at the encoder, prefill and
              q_offset shapes and the training encoder's shape, and flash_bwd
              against `flash_attention_bwd_ref` at the SFT shapes (T=768,
              and T=1000 with left pads), the encoder shape and one causal
              q_offset shape with Tq < Tk (the forward it differentiates is
              held to `flash_attention_ref` there too), with kernel, plain,
              bound and library (torch's scaled_dot_product_attention and
              its backward, a yardstick the port never calls; is_causal
              without a mask where the case is causal, all valid and
              Tq == Tk) times, the kernel (and the forward's library call)
              also replayed from a CUDA graph (event times include the host
              where it is slower than the card); then flash_fwd and flash_bwd at the long-DNA
              decoder's shape (causal, B=2, the collate's T=4480 with its
              left pads, and T=4608), and local_fwd
              / local_bwd against `local_attention_ref` /
              `local_attention_bwd_ref` at five banded shapes (bench.py's
              smoke shape, the long-DNA encoder, T=8192, rows with no valid
              key, a band wider than T), with flash_fwd / flash_bwd at the
              long-DNA encoder's shape without the band beside them.
  4. serve    the port's InferenceServer at Qwen3-0.6B + NT-v2-500M width,
              bf16, weights from a fixed seed: the kernel route against the
              plain route on one request, then 8 concurrent greedy requests
              of 2 x 2048 bp, the same 8 again, and one over HTTP. Checks that
              every request is answered, greedy repeats agree, logits are
              finite and the kernel ran in every encoder and prefill layer.
  5. profile  torch.profiler over one prefill and one short engine call of
              the same batch: device time by kernel, the device's busy share.
  6. train    LoRA SFT at Qwen3-0.6B + NT-v2-500M width, bf16 frozen weights
              from seed 0: the `train_sft` CLI for 4 steps on synthetic KEGG
              items; the SFTTrainer at bench.py's shape (B=4, 768 text
              tokens, 2 x 128 DNA tokens per item, the last 128 positions
              supervised, remat off) for 2 + 10 timed steps, with flash_fwd
              and flash_bwd counted per step; one loss + gradient of the
              kernel route against the plain ('xla') route; the LoRA B leaves
              checked to have moved; one step profiled.
  7. train-long  long-DNA SFT with the encoder trained through the banded
              kernels: the `train_sft` CLI for 4 steps with --dna_attention
              local:256 --dna_model_finetune on 16 synthetic KEGG items of
              2 x 12,288 bp (encoder 4 x 2048 tokens, decoder B=2, T=4480),
              with the launches of local_fwd, local_bwd, flash_fwd and
              flash_bwd counted per step and the encoder's leaves checked to
              have moved; the same trainer for 2 + 5 timed steps; one loss +
              gradient of the kernel route against the plain route (the
              band through `local_attention_ref`, patched into this process's
              dispatch); one step profiled.

Before its last line it prints one JSON object {"kernels": [...]}; its last
line is {"ok": true, "device": {...}}. It exits non-zero without a result
where torch.cuda.is_available() is false or the port's package is missing.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
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

# flash_bwd vs its plain version: the kernel rounds P and dS to bf16 before
# their products (as the Pallas kernels do) and writes bf16 gradients; the
# plain version keeps fp32 throughout. Each gradient element is a sum of up
# to ~1000 such terms whose rounding errors (2^-9 relative) mostly cancel, so
# the error stays well under 2% of the gradient's largest element
BWD_RTOL_OF_MAX = 2e-2

# the redesigned kernels (wgmma + TMA) and the SASS opcodes counted as TMA
REDESIGNED = ("flash_fwd_kernel", "flash_bwd_kernel")
TMA_OPS = ("UTMALDG", "UTMASTG", "UTMAREDG", "UTMAPF", "UBLKCP", "UBLKRED")

ENCODER_LAYERS, DECODER_LAYERS = 29, 28
LONG_DNA_BP, LONG_WINDOW = 12288, 256     # 2048 encoder tokens per sequence


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 1 -----------------------------------------------------------------

def smi_clocks() -> str:
    """The card's SM clock, power draw and temperature, for the record."""
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()


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

def ptxas_report(log_text: str) -> dict:
    """function -> {"registers", "spill_stores", "spill_loads", "smem"} from
    nvcc's -Xptxas -v output."""
    out, fn = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = {"registers": None, "spill_stores": 0, "spill_loads": 0, "smem": 0}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[fn]["spill_stores"], out[fn]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[fn]["smem"] = int(m.group(1)) if m else 0
    return out


def sass_counts(path) -> dict:
    """function -> {"HGMMA": n, "TMA": n} from `cuobjdump -sass` of a library."""
    from bioreason_tpu_torch.ops.cuda_build import cuda_tool
    res = subprocess.run([cuda_tool("cuobjdump"), "-sass", str(path)], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        fail(f"cuobjdump -sass {path} failed: {res.stderr.strip()[-500:]}")
    out, fn = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = {"HGMMA": 0, "TMA": 0}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)", line)
        if m and fn is not None:
            op = m.group(1)
            if op == "HGMMA":
                out[fn]["HGMMA"] += 1
            elif op in TMA_OPS:
                out[fn]["TMA"] += 1
    return out


def phase_build():
    """Both kernels, one nvcc per source, started together; their ptxas
    reports and SASS instruction counts. Returns kernel -> numbers."""
    from bioreason_tpu_torch.ops import flash_attention as fa
    from bioreason_tpu_torch.ops.cuda_build import library_path
    t0 = time.perf_counter()
    reports = fa.build(*fa.LIBRARIES)
    log(f"build: {', '.join(reports)} in {time.perf_counter() - t0:.2f} s")
    kernels = {}
    for name, report in reports.items():
        ptx = ptxas_report(report)
        sass = sass_counts(library_path(name))
        log(f"build: {name} ({library_path(name).name})")
        for fn in sorted(set(ptx) | set(sass)):
            row = {**ptx.get(fn, {}), **sass.get(fn, {})}
            kernels[fn] = row
            log(f"  {fn[:96]}: {row}")
            if row.get("spill_stores") or row.get("spill_loads"):
                fail(f"ptxas spills in {fn}: {row}")
    if not all(reports.values()):
        log("build: a library was already built in this checkout: no ptxas report for it")
    for want in REDESIGNED:
        mine = {fn: row for fn, row in kernels.items() if want in fn}
        if not mine or any(not row.get("HGMMA") or not row.get("TMA") for row in mine.values()):
            fail(f"{want}: every build needs HGMMA and TMA instructions, got {mine}")
    return kernels


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


def graph_ms(fn, iters: int = 20) -> float:
    """Device time per call: `iters` calls captured in one CUDA graph and
    replayed, so no host time between launches enters (`cuda_ms` includes
    it where the host is slower than the card, as at the small shapes)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):            # capture wants a warm-up off the default stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
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

    def kernel():
        return fa.flash_attention(q, k, v, mask, causal=causal, q_offset=q_offset)
    ms = cuda_ms(kernel, iters=20)
    dev_ms = graph_ms(kernel)
    plain_ms = cuda_ms(lambda: fa.flash_attention_ref(q, k, v, mask, causal, qo), iters=3,
                       warmup=1)
    # library yardstick: one SDPA call on the same work (layout copies and
    # the boolean mask are made before timing)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if causal and tq == tk and qo == 0 and bool(mask.bool().all()):
        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=hkv != hq)
    else:
        amask = vis[:, None]

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask,
                                                  enable_gqa=hkv != hq)
    library_ms = cuda_ms(library, iters=10)
    library_dev_ms = graph_ms(library)

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
           "ms": ms, "graph_ms": dev_ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "library_graph_ms": library_dev_ms,
           "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "tflops": flops / (ms * 1e-3) / 1e12}
    log(f"kernel {name}: B={b} Tq={tq} Tk={tk} Hq={hq} Hkv={hkv} D={d} causal={causal} "
        f"q_offset={qo}: max_abs_err {err:.3g} (lse {lse_err:.3g}); ms {ms:.4f} (graph "
        f"{dev_ms:.4f}) plain_ms {plain_ms:.3f} library_ms {library_ms:.4f} (graph "
        f"{library_dev_ms:.4f}) bound_ms {row['bound_ms']:.4f} "
        f"({row['bound_by']}), {row['tflops']:.1f} TFLOP/s")
    return row


def bwd_case(torch, name, b, tq, tk, hq, hkv, d, causal, q_offset, mask, seed):
    """flash_bwd against flash_attention_bwd_ref on one shape: the same bf16
    q, k, v, dO, and the kernel forward's out and lse, on the card. That
    forward is first held to flash_attention_ref, so an error of flash_fwd
    at this shape cannot hide in the backward's inputs."""
    import torch.nn.functional as F
    from bioreason_tpu_torch.ops import flash_attention as fa
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dout = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                     for shape in ((b, tq, hq, d), (b, tk, hkv, d), (b, tk, hkv, d),
                                   (b, tq, hq, d)))
    out, lse = fa.flash_attention(q, k, v, mask, causal=causal, q_offset=q_offset,
                                  return_lse=True)
    grads = fa.flash_bwd(q, k, v, mask, causal, q_offset, out, lse, dout)
    torch.cuda.synchronize()
    vis = mask.bool()[:, None, :].expand(b, tq, tk)
    if causal:
        vis = vis & (torch.arange(tk, device=dev)[None, :]
                     <= torch.arange(tq, device=dev)[:, None] + q_offset)
    rows = vis.any(-1)                                             # [B, Tq]
    ref_out, ref_lse = fa.flash_attention_ref(q, k, v, mask, causal, q_offset)
    o, r = out.float()[rows], ref_out.float()[rows]
    fwd_err = float((o - r).abs().max())
    if not torch.allclose(o, r, atol=OUT_ATOL, rtol=OUT_RTOL):
        fail(f"kernel {name}: the forward's out differs from the plain version, "
             f"max abs err {fwd_err:.4g}")
    lrows = rows[:, None, :].expand(b, hq, tq)
    lse_err = float((lse[lrows] - ref_lse[lrows]).abs().max())
    if lse_err > LSE_ATOL:
        fail(f"kernel {name}: the forward's lse differs from the plain version by {lse_err:.4g}")
    del ref_out, ref_lse, o, r
    refs = fa.flash_attention_bwd_ref(q, k, v, mask, causal, q_offset, out, lse, dout)
    errs = {}
    for gname, got, ref, sel in (("dq", grads[0], refs[0], rows), ("dk", grads[1], refs[1], None),
                                 ("dv", grads[2], refs[2], None)):
        a, r = got.float(), ref.float()
        if sel is not None:
            a, r = a[sel], r[sel]
        if not bool(torch.isfinite(a).all()):
            fail(f"kernel {name}: {gname} is not finite")
        errs[gname] = float((a - r).abs().max())
        ref_max = float(r.abs().max())
        if errs[gname] > BWD_RTOL_OF_MAX * ref_max:
            fail(f"kernel {name}: {gname} differs from the plain version by {errs[gname]:.4g} "
                 f"(max |ref| {ref_max:.4g}, tolerance {BWD_RTOL_OF_MAX} of it)")
        errs[gname + "_ref_max"] = ref_max
    empty = ~rows
    if bool(empty.any()) and bool(grads[0][empty].ne(0).any()):
        fail(f"kernel {name}: fully masked rows have dq != 0")

    def kernel():
        return fa.flash_bwd(q, k, v, mask, causal, q_offset, out, lse, dout)
    ms = cuda_ms(kernel, iters=20)
    dev_ms = graph_ms(kernel)
    plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_ref(q, k, v, mask, causal, q_offset, out,
                                                          lse, dout), iters=3, warmup=1)
    # library yardstick: the backward of one SDPA call on the same work, on
    # a retained graph (layout copies and the mask made before timing)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    if causal and tq == tk and bool(mask.bool().all()):
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=hkv != hq)
    else:
        o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=vis[:, None],
                                           enable_gqa=hkv != hq)
    do_t = dout.transpose(1, 2).contiguous()
    def library():
        return torch.autograd.grad(o, (qt, kt, vt), do_t, retain_graph=True)
    library_ms = cuda_ms(library, iters=10)

    # the work this data needs: 10*D flops per visible (query, key) pair and
    # head (Q K^T, dO V^T, P^T dO, dS K, dS^T Q); q, out, dO and lse read for
    # the query rows that see a key, k and v for the keys some query sees,
    # the mask read once; all of dq, dk, dv written once
    flops = 10.0 * d * hq * float(vis.sum())
    q_rows, kv_rows = float(rows.sum()), float(vis.any(1).sum())
    nbytes = (2 * (3 * q_rows * hq * d + 2 * kv_rows * hkv * d)   # q out dO, k v
              + 4 * q_rows * hq + 4 * mask.numel()                # lse, mask
              + 2 * (q.numel() + 2 * k.numel()))                  # dq, dk dv
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    err = max(errs["dq"], errs["dk"], errs["dv"])
    row = {"shape": name, "B": b, "Tq": tq, "Tk": tk, "Hq": hq, "Hkv": hkv, "D": d,
           "causal": causal, "q_offset": q_offset, "fwd_max_abs_err": fwd_err,
           "fwd_lse_max_abs_err": lse_err, "max_abs_err": err, **errs, "ms": ms,
           "graph_ms": dev_ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "tflops": flops / (ms * 1e-3) / 1e12}
    log(f"kernel {name} (bwd): B={b} Tq={tq} Tk={tk} Hq={hq} Hkv={hkv} D={d} causal={causal} "
        f"q_offset={q_offset}: forward max abs err {fwd_err:.3g} (lse {lse_err:.3g}); max abs err "
        f"dq {errs['dq']:.3g} dk {errs['dk']:.3g} dv {errs['dv']:.3g} (max |ref| "
        f"{errs['dq_ref_max']:.3g} {errs['dk_ref_max']:.3g} {errs['dv_ref_max']:.3g}, tolerance "
        f"{BWD_RTOL_OF_MAX} of each); ms {ms:.4f} (graph {dev_ms:.4f}) plain_ms "
        f"{plain_ms:.3f} library_ms {library_ms:.4f} bound_ms "
        f"{row['bound_ms']:.4f} ({row['bound_by']}), "
        f"{row['tflops']:.1f} TFLOP/s")
    return row


def right_padded(torch, b, t, lo, gen):
    lens = torch.randint(lo, t + 1, (b,), generator=gen, device="cuda")
    return (torch.arange(t, device="cuda")[None, :] < lens[:, None]).to(torch.int32)


def left_padded(torch, b, p, extra, max_pad, gen):
    """Prompt mask [B, p + extra]: left pads, `extra` empty decode slots."""
    pads = torch.randint(0, max_pad + 1, (b,), generator=gen, device="cuda")
    pos = torch.arange(p + extra, device="cuda")[None, :]
    return ((pos >= pads[:, None]) & (pos < p)).to(torch.int32)


def band_visible(torch, t, window, mask):
    """[B, T, T] bool: key j visible to query i, |i - j| <= window and mask[j]."""
    i = torch.arange(t, device="cuda")
    return ((i[:, None] - i[None, :]).abs() <= window)[None] & mask.bool()[:, None, :]


def local_case(torch, name, b, t, hq, hkv, d, window, mask, seed):
    """local_fwd and local_bwd against their plain versions on one shape, in
    bf16: out on every row (pad queries are computed, as on the TPU), the
    LSE on rows that see a key, rows that see none exactly (0, -1e30) with
    dq = 0; dq, dk, dv within BWD_RTOL_OF_MAX of the largest |ref|. Returns
    the forward's and the backward's rows of numbers."""
    import torch.nn.functional as F
    from bioreason_tpu_torch.ops import local_attention as la
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dout = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                     for shape in ((b, t, hq, d), (b, t, hkv, d), (b, t, hkv, d),
                                   (b, t, hq, d)))
    out, lse = la.local_attention(q, k, v, window, mask, return_lse=True)
    grads = la.local_bwd(q, k, v, window, mask, out, lse, dout)
    torch.cuda.synchronize()
    vis = band_visible(torch, t, window, mask)
    rows = vis.any(-1)                                             # [B, T]
    ref_out, ref_lse = la.local_attention_ref(q, k, v, window, mask)
    err = float((out.float() - ref_out.float()).abs().max())
    if not torch.allclose(out.float(), ref_out.float(), atol=OUT_ATOL, rtol=OUT_RTOL):
        fail(f"kernel {name}: local_fwd out differs from the plain version, max abs err {err:.4g}")
    lrows = rows[:, None, :].expand(b, hq, t)
    lse_err = float((lse[lrows] - ref_lse[lrows]).abs().max())
    if lse_err > LSE_ATOL:
        fail(f"kernel {name}: local_fwd lse differs from the plain version by {lse_err:.4g}")
    empty = ~rows
    n_empty = int(empty.sum())
    if n_empty and (bool(out[empty].ne(0).any())
                    or bool(lse.transpose(1, 2)[empty].ne(la.NEG_INF).any())
                    or bool(grads[0][empty].ne(0).any())):
        fail(f"kernel {name}: rows with no visible key are not (0, -1e30) with dq = 0")
    del ref_out, ref_lse
    refs = la.local_attention_bwd_ref(q, k, v, window, mask, out, lse, dout)
    errs = {}
    for gname, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        a, r = got.float(), ref.float()
        if not bool(torch.isfinite(a).all()):
            fail(f"kernel {name}: local_bwd {gname} is not finite")
        errs[gname] = float((a - r).abs().max())
        ref_max = float(r.abs().max())
        if errs[gname] > BWD_RTOL_OF_MAX * ref_max:
            fail(f"kernel {name}: local_bwd {gname} differs from the plain version by "
                 f"{errs[gname]:.4g} (max |ref| {ref_max:.4g}, tolerance {BWD_RTOL_OF_MAX} of it)")
        errs[gname + "_ref_max"] = ref_max
    del refs

    ms = cuda_ms(lambda: la.local_attention(q, k, v, window, mask), iters=20)
    bwd_ms = cuda_ms(lambda: la.local_bwd(q, k, v, window, mask, out, lse, dout), iters=20)
    plain_ms = cuda_ms(lambda: la.local_attention_ref(q, k, v, window, mask), iters=3, warmup=1)
    plain_bwd_ms = cuda_ms(lambda: la.local_attention_bwd_ref(q, k, v, window, mask, out, lse,
                                                              dout), iters=3, warmup=1)
    # library yardstick: SDPA with the dense band mask, forward and the
    # backward of one call on a retained graph (copies and mask made first)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    amask = vis[:, None]
    with torch.no_grad():
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=amask, enable_gqa=hkv != hq), iters=10)
    o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask, enable_gqa=hkv != hq)
    do_t = dout.transpose(1, 2).contiguous()
    library_bwd_ms = cuda_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), do_t,
                                                         retain_graph=True), iters=10)
    del o, qt, kt, vt, amask

    # the work this data needs: the band's visible (query, key) pairs; the
    # bytes it needs: q (out, dO, lse) of the rows that see a key, k and v of
    # the keys some query sees, the mask, and every output written once
    pairs = float(vis.sum())
    q_rows, kv_rows = float(rows.sum()), float(vis.any(1).sum())
    del vis
    fwd_bytes = (2 * (q_rows * hq * d + 2 * kv_rows * hkv * d + out.numel())
                 + 4 * lse.numel() + 4 * mask.numel())
    bwd_bytes = (2 * (3 * q_rows * hq * d + 2 * kv_rows * hkv * d)
                 + 4 * q_rows * hq + 4 * mask.numel()
                 + 2 * (q.numel() + 2 * k.numel()))
    shape = {"B": b, "T": t, "Hq": hq, "Hkv": hkv, "D": d, "window": window,
             "visible_pairs": pairs, "rows_without_key": n_empty}
    out_rows = []
    for kind, flops, nbytes, kms, pms, lms, e in (
            ("fwd", 4.0 * d * hq * pairs, fwd_bytes, ms, plain_ms, library_ms,
             {"max_abs_err": err, "lse_max_abs_err": lse_err}),
            ("bwd", 10.0 * d * hq * pairs, bwd_bytes, bwd_ms, plain_bwd_ms, library_bwd_ms,
             {"max_abs_err": max(errs["dq"], errs["dk"], errs["dv"]), **errs})):
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
        out_rows.append({"shape": name, "kernel": f"local_{kind}", **shape, **e, "ms": kms,
                         "plain_ms": pms, "library_ms": lms, "bound_ms": max(t_ops, t_bytes),
                         "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                         "tflops": flops / (kms * 1e-3) / 1e12})
    f_, b_ = out_rows
    log(f"kernel {name} (band): B={b} T={t} Hq={hq} Hkv={hkv} D={d} W={window}: "
        f"{pairs:.4g} visible pairs, {n_empty} rows without a key; local_fwd max abs err "
        f"{err:.3g} (lse {lse_err:.3g}), ms {ms:.4f} plain_ms {plain_ms:.3f} library_ms "
        f"{library_ms:.4f} bound_ms {f_['bound_ms']:.4f} ({f_['bound_by']}), "
        f"{f_['tflops']:.1f} TFLOP/s; local_bwd max abs err dq {errs['dq']:.3g} dk "
        f"{errs['dk']:.3g} dv {errs['dv']:.3g} (max |ref| {errs['dq_ref_max']:.3g} "
        f"{errs['dk_ref_max']:.3g} {errs['dv_ref_max']:.3g}), ms {bwd_ms:.4f} plain_ms "
        f"{plain_bwd_ms:.3f} library_ms {library_bwd_ms:.4f} bound_ms {b_['bound_ms']:.4f} "
        f"({b_['bound_by']}), {b_['tflops']:.1f} TFLOP/s")
    return out_rows


def long_items():
    """The long-DNA corpus of phase 7: 16 KEGG-shaped items of 2 x 12,288 bp."""
    from bioreason_tpu_torch.data.kegg import synthetic_kegg_items
    return synthetic_kegg_items(n=16, seq_len=LONG_DNA_BP, seed=0)


def long_batch(items):
    """Two items collated as the CLI collates them in phase 7 (B=2, text 512,
    DNA 2048 tokens per sequence, bucket 128)."""
    from bioreason_tpu_torch.data import BioProcessor, ByteTextTokenizer, KmerTokenizer
    from bioreason_tpu_torch.data.collate import sft_collate
    from bioreason_tpu_torch.data.kegg import format_kegg_for_dna_llm
    proc = BioProcessor(ByteTextTokenizer(), KmerTokenizer())
    return sft_collate([format_kegg_for_dna_llm(x) for x in items[:2]], proc,
                       max_length_text=512, max_length_dna=2048, bucket=128)


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
    # (f) the encoder as the train phase's bench-shape batch gives it: 2 x 4
    # DNA sequences of 128 tokens, all valid (the decoder's training shapes
    # are held in the backward cases below, forward first)
    rows.append(kernel_case(torch, "encoder_sft_T128", 8, 128, 128, 16, 16, 64, False, None,
                            torch.ones((8, 128), dtype=torch.int32, device="cuda"), 17))

    bwd_rows = [
        # bench.py's SFT shape, the single-block regime on the TPU: all valid
        bwd_case(torch, "sft_T768", 4, 768, 768, 16, 8, 128, True, 0,
                 torch.ones((4, 768), dtype=torch.int32, device="cuda"), 21),
        # the tiled regime on the TPU: ragged edge, left pads (fully masked rows)
        bwd_case(torch, "sft_T1000_leftpad", 4, 1000, 1000, 16, 8, 128, True, 0,
                 left_padded(torch, 4, 1000, 0, 300, g), 22),
        # the encoder under --dna_model_finetune: bidirectional, right pads
        bwd_case(torch, "encoder_T128_bwd", 16, 128, 128, 16, 16, 64, False, 0,
                 right_padded(torch, 16, 128, 64, g), 23),
        # the rest of the kernel's contract, off the SFT path: Tq < Tk with
        # a causal q_offset > 0 and a ragged key edge
        bwd_case(torch, "q_offset_194_bwd", 2, 136, 330, 16, 8, 128, True, 194,
                 left_padded(torch, 2, 330, 0, 40, g), 24),
    ]
    # the long-DNA decoder (phase 7): causal over the DNA placeholders of
    # 2 x 2048 tokens per item, with the left pads the collate gives
    am = torch.as_tensor(long_batch(long_items())["attention_mask"], device="cuda")
    rows.append(kernel_case(torch, f"dec_long_T{am.shape[1]}_collate", 2, am.shape[1],
                            am.shape[1], 16, 8, 128, True, 0, am, 25))
    rows.append(kernel_case(torch, "dec_long_T4608", 2, 4608, 4608, 16, 8, 128, True, 0,
                            torch.ones((2, 4608), dtype=torch.int32, device="cuda"), 26))
    bwd_rows.append(bwd_case(torch, f"dec_long_T{am.shape[1]}_collate", 2, am.shape[1],
                             am.shape[1], 16, 8, 128, True, 0, am, 25))
    bwd_rows.append(bwd_case(torch, "dec_long_T4608", 2, 4608, 4608, 16, 8, 128, True, 0,
                             torch.ones((2, 4608), dtype=torch.int32, device="cuda"), 26))

    # the banded kernels: local_fwd and local_bwd against their plain versions
    enc_mask = right_padded(torch, 4, 2048, 1024, g)
    band_rows = [
        # (a) bench.py's smoke shape (bench.py:38-41, 67): GQA, D=128
        *local_case(torch, "bench_smoke_T512_W96", 2, 512, 16, 8, 128, 96,
                    torch.ones((2, 512), dtype=torch.int32, device="cuda"), 31),
        # (b) the long-DNA encoder: 2 x 2 sequences of 2048 tokens, right pads
        *local_case(torch, "encoder_long_T2048_W256", 4, 2048, 16, 16, 64, LONG_WINDOW,
                    enc_mask, 32),
        # (c) 4x the length: time should grow about linearly in T
        *local_case(torch, "encoder_T8192_W256", 1, 8192, 16, 16, 64, LONG_WINDOW,
                    torch.ones((1, 8192), dtype=torch.int32, device="cuda"), 33),
        # (d) left pads longer than the band: rows that see no valid key
        *local_case(torch, "leftpad_T1000_W300", 2, 1000, 16, 16, 64, 300,
                    (torch.arange(1000, device="cuda")[None, :]
                     >= torch.tensor([[620], [40]], device="cuda")).to(torch.int32), 34),
        # (e) a band wider than the sequence: full bidirectional attention
        *local_case(torch, "encoder_T344_W4096", 16, 344, 16, 16, 64, 4096,
                    right_padded(torch, 16, 344, 200, g), 35),
    ]
    # the long-DNA encoder's shape without the band, for the O(T * W) saving
    rows.append(kernel_case(torch, "encoder_long_T2048_full", 4, 2048, 2048, 16, 16, 64, False,
                            None, enc_mask, 32))
    bwd_rows.append(bwd_case(torch, "encoder_long_T2048_full_bwd", 4, 2048, 2048, 16, 16, 64,
                             False, 0, enc_mask, 32))
    return rows, bwd_rows, band_rows


# -- phase 4 -----------------------------------------------------------------

def phase_serve(torch, card, max_new):
    from bioreason_tpu_torch.generate.engine import GenerationEngine
    from bioreason_tpu_torch.ops import flash_attention as fa
    from bioreason_tpu_torch.serve import build_server, make_http_server, prepare_batch

    t0 = time.perf_counter()
    # a batch window long enough that each burst of 8 threads is one batch
    # on a slow host too: greedy tokens are compared across bursts, and
    # another split of the same requests pads them differently
    server = build_server("qwen3-0.6b", "nt-500m", max_length_dna=2048, seed=0,
                          max_batch=8, batch_window_ms=500.0, max_new_tokens=max_new,
                          greedy_default=True)
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
        fail(f"greedy repeats of the same 8 requests differ (engine call batch sizes "
             f"{[ids.shape[0] for (ids, _), _ in calls_out]})")
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


# -- phase 6 -----------------------------------------------------------------

def bench_batch(cfg, b=4, t_text=768, l_dna=128):
    """bench.py's SFT batch (bench.py:253-268): random text ids, 2 DNA
    sequences of l_dna tokens per item spliced after the first token, the
    last 128 positions supervised, labels gathered to those positions."""
    from bioreason_tpu_torch.ops.fused_ce import gather_label_positions
    npr = np.random.default_rng(0)
    input_ids = npr.integers(0, 150000, (b, t_text)).astype(np.int32)
    for i in range(b):
        input_ids[i, 1:1 + 2 * l_dna] = cfg.dna_pad_token_id
    labels = np.where(np.arange(t_text)[None] >= t_text - 128, input_ids, -100)
    pos, tgt, val = gather_label_positions(labels)
    return {"input_ids": input_ids, "attention_mask": np.ones((b, t_text), np.int32),
            "dna_input_ids": npr.integers(6, 4102, (2 * b, l_dna)).astype(np.int32),
            "dna_attention_mask": np.ones((2 * b, l_dna), np.int32),
            "label_positions": pos, "label_targets": tgt, "label_valid": val}


def _wrappers():
    """Each kernel's wrapper, which counts its launches."""
    from bioreason_tpu_torch.ops import flash_attention as fa
    from bioreason_tpu_torch.ops import local_attention as la
    return {"flash_fwd": fa.flash_attention, "flash_bwd": fa.flash_bwd,
            "local_fwd": la.local_attention, "local_bwd": la.local_bwd}


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def profile_step(torch, card, label, step, names):
    """One training step under torch.profiler: device busy share and the
    share of device time of the kernels whose names hold each of `names`."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    share = {name: sum(e.self_device_time_total for e in kernels if name in e.key) / 1e3
             for name in names}
    log(f"profile [{card}] {label}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {sum(e.count for e in kernels)} kernel launches; "
        + ", ".join(f"{k} {v:.3f} ms ({100 * v / max(busy_ms, 1e-9):.1f}% of device time)"
                    for k, v in share.items()))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")


def phase_train(torch, card):
    import torch.nn.functional as F
    from bioreason_tpu_torch.cli import train_sft
    from bioreason_tpu_torch.config import (DecoderConfig, EncoderConfig, FusionConfig,
                                            LoRAConfig, OptimConfig, SFTConfig)
    from bioreason_tpu_torch.models.fusion import fusion_forward
    from bioreason_tpu_torch.ops import flash_attention as fa
    from bioreason_tpu_torch.train.sft import SFTTrainer
    per_step_fwd = ENCODER_LAYERS + DECODER_LAYERS

    # (a) the CLI, end to end: collate, labels, gathered CE, optimizer. Its
    # presets keep remat on, so each decoder layer's forward runs twice.
    build_dir = os.path.join(REPO, "bioreason_tpu_torch", "build")
    os.makedirs(build_dir, exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="smoke_sft_", dir=build_dir)
    try:
        reset_counts()
        t0 = time.perf_counter()
        trainer = train_sft.main(["--max_steps", "4", "--seed", "0", "--checkpoint_dir", ckpt])
        secs = time.perf_counter() - t0
        fwd, bwd = fa.flash_attention.launches, fa.flash_bwd.launches
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    losses = [m["loss"] for m in trainer.history]
    log(f"train (cli) [{card}]: 4 steps in {secs:.1f} s (build and data included), losses "
        f"{[round(x, 4) for x in losses]}, step ms "
        f"{[round(m['step_time'] * 1e3, 1) for m in trainer.history]}; flash_fwd {fwd}, "
        f"flash_bwd {bwd} launches")
    if len(losses) != 4 or not all(math.isfinite(x) for x in losses):
        fail(f"train_sft.main did not run 4 finite steps: {losses}")
    if bwd != 4 * DECODER_LAYERS or fwd != 4 * (per_step_fwd + DECODER_LAYERS):
        fail(f"train_sft.main launched flash_fwd {fwd} and flash_bwd {bwd} times in 4 steps")
    del trainer
    torch.cuda.empty_cache()

    # (b) the SFTTrainer at bench.py's shape, remat off
    dec = dataclasses.replace(DecoderConfig.qwen3_0_6b(), remat=False)
    enc = dataclasses.replace(EncoderConfig.nt_v2_500m(), remat=False)
    cfg = FusionConfig(decoder=dec, encoder=enc, dna_pad_token_id=151938)
    sft = SFTConfig(batch_size=4, lora=LoRAConfig(r=32, alpha=64),
                    optim=OptimConfig(total_steps=100), seed=0)
    trainer = SFTTrainer(cfg, sft)
    batch = bench_batch(cfg)
    n_train = sum(p.numel() for p in trainer.params)
    b_leaves = {n: p.detach().clone() for n, p in trainer.trainable_state().items()
                if n.endswith("lora_b")}
    for _ in range(2):                                   # warm-up
        trainer.train_step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # --- the main path: counts from 0 just before, read just after ---------
    reset_counts()
    t0 = time.perf_counter()
    metrics = [trainer.train_step(batch) for _ in range(10)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fwd, bwd = fa.flash_attention.launches, fa.flash_bwd.launches
    # -----------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in metrics]
    log(f"train (bench shape) [{card}]: B=4 T=768 DNA 8x128, LoRA r32/a64 over "
        f"{n_train / 1e6:.2f} M trainable parameters, remat off: {40 / dt:.3f} examples/s, "
        f"{dt / 10 * 1e3:.1f} ms per step over 10 steps, torch.cuda.max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; losses {[round(x, 4) for x in losses]}")
    # (d) kernels per step, finite losses
    log(f"train (bench shape): flash_fwd {fwd} launches ({fwd / 10:g} per step), flash_bwd "
        f"{bwd} ({bwd / 10:g} per step)")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite training loss: {losses}")
    if bwd != 10 * DECODER_LAYERS or fwd != 10 * per_step_fwd:
        fail(f"expected {DECODER_LAYERS} flash_bwd and {per_step_fwd} flash_fwd launches per "
             f"step, got {bwd / 10:g} and {fwd / 10:g}")
    # (e) the adapters' B leaves have moved
    state = trainer.trainable_state()
    still = [n for n, b0 in b_leaves.items() if torch.equal(state[n].detach(), b0)]
    log(f"train (bench shape): {len(b_leaves) - len(still)} of {len(b_leaves)} LoRA B "
        f"leaves moved")
    if still:
        fail(f"LoRA B leaves did not move: {still[:4]}")

    # (c) one loss + gradient through the kernels against the plain route
    db = trainer._device_batch(batch)

    def loss_and_grad(c):
        _, loss = fusion_forward(trainer.model, c, db["input_ids"], db["attention_mask"],
                                 db["dna_input_ids"], db["dna_attention_mask"],
                                 label_positions=db["label_positions"],
                                 label_targets=db["label_targets"],
                                 label_valid=db["label_valid"])
        grads = torch.autograd.grad(loss, trainer.params)
        return float(loss.detach()), torch.cat([g.float().flatten() for g in grads])
    lk, gk = loss_and_grad(cfg)
    plain = dataclasses.replace(cfg, decoder=dataclasses.replace(dec, attention_impl="xla"),
                                encoder=dataclasses.replace(enc, attention_impl="xla"))
    lp, gp = loss_and_grad(plain)
    cos = float(F.cosine_similarity(gk, gp, dim=0))
    log(f"train: kernel vs plain route, one loss + gradient: loss {lk:.6f} vs {lp:.6f} "
        f"(diff {abs(lk - lp):.3g}), cosine of the {gk.numel()} trainable gradients {cos:.6f}, "
        f"norms {float(gk.norm()):.4g} vs {float(gp.norm()):.4g}")
    if not (math.isfinite(lk) and math.isfinite(lp)) or cos < 0.99:
        fail(f"kernel and plain routes disagree in training (cosine {cos:.4f})")
    del gk, gp

    # (f) one step under the profiler
    profile_step(torch, card, "train step", lambda: trainer.train_step(batch),
                 ("flash_fwd", "flash_bwd"))
    return {"fwd_launches": fwd, "bwd_launches": bwd}


# -- phase 7 -----------------------------------------------------------------

def phase_train_long(torch, card):
    """Long-DNA SFT with the encoder trained through the banded kernels."""
    import torch.nn.functional as F
    from bioreason_tpu_torch.cli import train_sft
    from bioreason_tpu_torch.models import attention as attn_mod
    from bioreason_tpu_torch.models.fusion import fusion_forward, init_fusion
    from bioreason_tpu_torch.ops import local_attention as la
    per_step = {"local_fwd": 2 * ENCODER_LAYERS, "local_bwd": ENCODER_LAYERS,
                "flash_fwd": 2 * DECODER_LAYERS, "flash_bwd": DECODER_LAYERS}

    # (a) the CLI on a .jsonl of long items: both towers keep remat on, so
    # each layer's forward runs twice a step
    items = long_items()
    build_dir = os.path.join(REPO, "bioreason_tpu_torch", "build")
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="smoke_long_", dir=build_dir)
    try:
        data_dir = os.path.join(tmp, "data")
        os.makedirs(data_dir)
        with open(os.path.join(data_dir, "kegg_long.jsonl"), "w", encoding="utf-8") as fh:
            fh.write("\n".join(json.dumps(x) for x in items))
        reset_counts()
        t0 = time.perf_counter()
        trainer = train_sft.main([
            "--max_steps", "4", "--seed", "0", "--checkpoint_dir", os.path.join(tmp, "ckpt"),
            "--dna_attention", f"local:{LONG_WINDOW}", "--dna_model_finetune",
            "--max_length_dna", "2048", "--truncate_dna_per_side", "0", "--data_dir", data_dir])
        secs = time.perf_counter() - t0
        got = counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    losses = [m["loss"] for m in trainer.history]
    log(f"train-long (cli) [{card}]: 4 steps in {secs:.1f} s (data included), losses "
        f"{[round(x, 4) for x in losses]}, step ms "
        f"{[round(m['step_time'] * 1e3, 1) for m in trainer.history]}; launches {got}")
    if len(losses) != 4 or not all(math.isfinite(x) for x in losses):
        fail(f"train_sft.main --dna_attention local:{LONG_WINDOW} did not run 4 finite "
             f"steps: {losses}")
    if got != {k: 4 * n for k, n in per_step.items()}:
        fail(f"train_sft.main launched {got} in 4 steps, expected {per_step} per step "
             f"(no flash_* launch in the encoder)")
    init = init_fusion(trainer.fusion_cfg, seed=0, device="cuda")
    state = trainer.trainable_state()
    enc = [(n, p) for n, p in init.encoder.named_parameters()]
    still = [n for n, p in enc if torch.equal(state[f"encoder.{n}"].detach(), p.float())]
    log(f"train-long (cli): {len(enc) - len(still)} of {len(enc)} encoder leaves moved")
    if still:
        fail(f"encoder leaves did not move: {still[:4]}")
    del init, enc, state

    # (b) the same SFTTrainer on one batch of the corpus: 2 + 5 timed steps
    # (its schedule ended with the CLI's 4 steps: lr 0, the update still runs)
    batch = long_batch(items)
    n_train = sum(p.numel() for p in trainer.params)
    for _ in range(2):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clocks_before = smi_clocks()
    # --- the main path: counts from 0 just before, read just after ---------
    reset_counts()
    t0 = time.perf_counter()
    metrics, step_ms = [], []
    for _ in range(5):                   # each step ends in a host sync (loss, norm)
        ts = time.perf_counter()
        metrics.append(trainer.train_step(batch))
        step_ms.append((time.perf_counter() - ts) * 1e3)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = counts()
    # -----------------------------------------------------------------------
    log(f"train-long (trainer): step ms {[round(x, 1) for x in step_ms]}; card clocks.sm, "
        f"power.draw, temperature before [{clocks_before}] after [{smi_clocks()}]")
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in metrics]
    b, t = np.asarray(batch["input_ids"]).shape
    s_, t_dna = np.asarray(batch["dna_input_ids"]).shape
    log(f"train-long (trainer) [{card}]: B={b} T={t}, encoder {s_} x {t_dna} DNA tokens on "
        f"local:{LONG_WINDOW}, {n_train / 1e6:.2f} M trainable parameters (LoRA r32 + "
        f"projection + encoder), remat on: {5 * b / dt:.3f} examples/s, {dt / 5 * 1e3:.1f} ms "
        f"per step over 5 steps, torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB; "
        f"losses {[round(x, 4) for x in losses]}; launches {got} "
        f"({', '.join(f'{k} {v / 5:g}' for k, v in got.items())} per step)")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite long-DNA training loss: {losses}")
    if got != {k: 5 * n for k, n in per_step.items()}:
        fail(f"the long-DNA trainer launched {got} in 5 steps, expected {per_step} per step")

    # (c) one loss + gradient through the kernels against the plain versions:
    # the decoder on 'xla', the encoder's band through local_attention_ref
    # (patched into this process's dispatch; autograd runs through it)
    db = trainer._device_batch(batch)
    cfg = trainer.fusion_cfg

    def loss_and_grad(c):
        _, loss = fusion_forward(trainer.model, c, db["input_ids"], db["attention_mask"],
                                 db["dna_input_ids"], db["dna_attention_mask"],
                                 label_positions=db["label_positions"],
                                 label_targets=db["label_targets"],
                                 label_valid=db["label_valid"], train_encoder=True)
        grads = torch.autograd.grad(loss, trainer.params)
        return float(loss.detach()), torch.cat([g.float().flatten() for g in grads])
    lk, gk = loss_and_grad(cfg)
    plain = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder,
                                                                 attention_impl="xla"))
    kernel_route = attn_mod.local_attention
    attn_mod.local_attention = lambda q, k, v, w, kv_mask=None: la.local_attention_ref(
        q, k, v, w, kv_mask)[0]
    try:
        reset_counts()
        lp, gp = loss_and_grad(plain)
        if any(counts().values()):
            fail(f"the plain route launched kernels: {counts()}")
    finally:
        attn_mod.local_attention = kernel_route
    cos = float(F.cosine_similarity(gk, gp, dim=0))
    log(f"train-long: kernel vs plain route, one loss + gradient: loss {lk:.6f} vs {lp:.6f} "
        f"(diff {abs(lk - lp):.3g}), cosine of the {gk.numel()} trainable gradients {cos:.6f}, "
        f"norms {float(gk.norm()):.4g} vs {float(gp.norm()):.4g}")
    if not (math.isfinite(lk) and math.isfinite(lp)) or cos < 0.99:
        fail(f"kernel and plain routes disagree in long-DNA training (cosine {cos:.4f})")
    del gk, gp

    # (d) one step under the profiler
    profile_step(torch, card, "train-long step", lambda: trainer.train_step(batch),
                 ("local_fwd", "local_bwd", "flash_fwd", "flash_bwd"))
    return got


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
    built = phase_build()
    rows, bwd_rows, band_rows = phase_kernels(torch, max_new)
    launches, server, items = phase_serve(torch, card, max_new)
    phase_profile(torch, card, server, items, max_new=8)
    del server
    torch.cuda.empty_cache()
    train = phase_train(torch, card)
    torch.cuda.empty_cache()
    long = phase_train_long(torch, card)
    log(f"chip_smoke: all phases done in {time.perf_counter() - t_start:.1f} s")

    # the served prefill: the kernel's largest call
    served = next(r for r in rows if r["shape"].startswith("prefill_served"))
    fwd_entry = {"name": "flash_fwd", "route": "cuda",
                 "source": "bioreason_tpu_torch/csrc/flash_fwd.cu",
                 "replaces": "bioreason_tpu/ops/flash_attention.py:60",
                 "also_replaces": ["bioreason_tpu/ops/flash_attention.py:239"],
                 "launches": launches, "train_launches": train["fwd_launches"],
                 "long_launches": long["flash_fwd"],
                 "max_abs_err": max(r["max_abs_err"] for r in rows),
                 "ms": served["ms"], "plain_ms": served["plain_ms"],
                 "bound_ms": served["bound_ms"], "bound_by": served["bound_by"],
                 "library_ms": served["library_ms"], "at_shape": served["shape"],
                 "build": {fn: r for fn, r in built.items() if "flash_fwd_kernel" in fn},
                 "shapes": rows}
    sft = bwd_rows[0]                  # sft_T768: bench.py's training shape
    bwd_entry = {"name": "flash_bwd", "route": "cuda",
                 "source": "bioreason_tpu_torch/csrc/flash_bwd.cu",
                 "replaces": "bioreason_tpu/ops/flash_attention.py:118",
                 "also_replaces": ["bioreason_tpu/ops/flash_attention.py:160",
                                   "bioreason_tpu/ops/flash_attention.py:271"],
                 "launches": train["bwd_launches"], "long_launches": long["flash_bwd"],
                 "max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
                 "ms": sft["ms"], "plain_ms": sft["plain_ms"], "bound_ms": sft["bound_ms"],
                 "bound_by": sft["bound_by"], "library_ms": sft["library_ms"],
                 "at_shape": sft["shape"],
                 "build": {fn: r for fn, r in built.items()
                           if any(f"flash_bwd_{k}kernel" in fn for k in ("", "prep_", "convert_"))},
                 "shapes": bwd_rows}
    # the banded kernels at the long-DNA encoder's shape, launches from the
    # long-DNA trainer's timed steps
    local_entries = []
    for kind, replaces, also in (("fwd", "bioreason_tpu/ops/local_attention.py:46", []),
                                 ("bwd", "bioreason_tpu/ops/local_attention.py:95",
                                  ["bioreason_tpu/ops/local_attention.py:133"])):
        mine = [r for r in band_rows if r["kernel"] == f"local_{kind}"]
        at = next(r for r in mine if r["shape"].startswith("encoder_long"))
        local_entries.append({
            "name": f"local_{kind}", "route": "cuda",
            "source": f"bioreason_tpu_torch/csrc/flash_{kind}.cu", "replaces": replaces,
            "also_replaces": also, "launches": long[f"local_{kind}"],
            "max_abs_err": max(r["max_abs_err"] for r in mine), "ms": at["ms"],
            "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": at["library_ms"], "at_shape": at["shape"], "shapes": mine})
    log(json.dumps({"kernels": [fwd_entry, bwd_entry, *local_entries]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
