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
              Fails on a spill, or where flash_fwd_kernel, flash_bwd_kernel,
              local_fwd_kernel or local_bwd_kernel lacks either kind of
              instruction.
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
              Tq == Tk; the lowest of three timed repetitions) times, the
              kernel (and the forward's library call) also replayed from a
              CUDA graph (event times include the host where it is slower
              than the card); then flash_fwd and flash_bwd at the long-DNA
              decoder's shape (causal, B=2, the collate's T=4480 with its
              left pads, and T=4608), and local_fwd / local_bwd against
              `local_attention_ref` / `local_attention_bwd_ref` at seven
              banded shapes (bench.py's smoke shape, the long-DNA encoder,
              T=8192, rows with no valid key, a band wider than T, a band
              edge on the 128-key tile boundary with GQA at D=128 and left
              pads, the diagonal alone), event and CUDA-graph times, with
              flash_fwd / flash_bwd at the long-DNA encoder's shape without
              the band beside them.
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
  8. grpo     GRPO at bench_grpo.py's shape (Qwen3-0.6B widths at the byte
              tokenizer's vocabulary, remat full; NT-v2-500M; 4 synthetic
              KEGG prompts of 2 x 600 bp x G = 4, 16 new tokens sampled
              (64 in bench_grpo.py; 64 before phase 11 came, 32 before
              phases 13-14 came),
              max_length_dna 128, beta 0.04, LoRA r32/a64, bf16 frozen
              weights from seed 0): the GRPOTrainer for 1 + 3 timed steps
              with phase timers, rewarded by xmlcount, correctness and the
              share of ACGT characters (which random weights vary on),
              (completions/s, seconds per phase, flash_fwd
              and flash_bwd launches per step, checked exactly, peak
              memory), one step profiled (busy share, top kernels, device
              time of the rollout, its grouped decode attention, the ref
              logps and the update), finite losses, kl and rewards, the
              LoRA B leaves moved, greedy grouped rollouts identical within
              each group, one update loss + gradient through the kernels
              against the plain route on the same rollout buffer, the
              sampler on a NaN and an all -inf row on the card, flash_fwd
              and flash_bwd against their plain versions at the step's own
              shapes and masks (the grouped prefill's P-slot prompt cache,
              the encoder, the logp passes' forward and the update's
              backward, with completions that end early as at an EOS); then
              `python -m bioreason_tpu_torch.cli.reason` for 2 steps from the
              sft_final that phase 6's train_sft CLI wrote.
  9. evo2     the committed vortex fixtures (tests/assets) through the port's
              importer on the card, fp32, held to their goldens with cuDNN's
              TF32 off and on; Evo2-1B + Qwen3-0.6B served at full width
              (bf16, weights from seed 0): the kernel vs plain route on one
              request, 8 concurrent greedy requests of 2 x 2048 bp twice
              (identical repeats), exact flash_fwd launches per engine call
              (3 tower attention blocks + 28 prefill layers), prefill latency,
              decode tokens/s, peak memory, one profiled prefill split into
              hyena convolutions / FFT, filter materialization, tower
              attention, decoder attention, GEMMs and the rest, and the
              tower's output with its filter leaves stored in bf16 (as a
              frozen SFT tower stores them) against fp32; then flash_fwd and
              flash_bwd against their plain versions at the path's own shapes
              and masks (the tower [16, 2048, 15/15, 128] causal with mixed
              left pads, the served Evo2 prefill, the finetune step's tower
              backward [4, 2048, 15/15, 128]).
 10. evo2-train  `train_sft --encoder evo2-1b` for 3 steps with the tower
              frozen and 3 with --dna_model_finetune (B=2, 16 synthetic KEGG
              items of 2 x 2048 bp in a .jsonl), exact flash_fwd / flash_bwd
              launches per step, the frozen filter leaves stored in bf16, every
              trained tower leaf moved; the finetune trainer for 1 + 3 timed
              steps (ms, memory held between steps and peak), one profiled
              step, one loss + gradient through the kernels against the plain
              route (all trainable gradients, and the tower's alone).
 11. pretrained  the port on HF-layout checkpoints at full width: a
              Qwen3-0.6B directory (config.json with the published values,
              bf16 safetensors from seed 0 with non-unit norm scales, a
              Qwen2-style byte-level tokenizer.json of 151,643 BPE tokens
              with Qwen's Split regex and the added tokens at Qwen3's ids)
              and an NT-v2-500M one (ESM config.json, vocab.txt, fp32
              safetensors with non-zero biases), written by the port's
              own writer (~3.2 GB; write and load times and GB/s);
              `load_pretrained_fusion` on the card with every imported
              leaf held bit for bit to what was written after its dtype
              cast; `train_sft --hf_llm_dir --hf_dna_dir --dataset_type
              variant_effect_coding` for 4 steps on 16 items of 2 x 2048 bp
              with --eval_every 2 --keep_top_k 1 --test_generative (exact
              flash_fwd / flash_bwd launches: per step, per eval batch, per
              test call; LoRA B moved; step ms, peak memory); `reason
              --hf_llm_dir --hf_dna_dir --sft_checkpoint <.pt>` for 2 GRPO
              steps from a reference-format file that `export_reference_sft`
              wrote from that SFT model (the first GRPO at the 151,936
              vocabulary on the card: completions/s, peak memory, finite
              loss, kl, rewards); `serve --checkpoint <sft_final>`: its
              merged prefill logits held to the unmerged SFT model's, 8
              concurrent greedy requests of 2 x 2048 bp twice, identical,
              exactly 57 flash_fwd per engine call; `train_sft
              --hf_llm_dir --evo2_dir` for 2 steps over the committed
              25-block Evo2 fixture (its head_dim of 8 takes the plain
              route; the decoder's launches counted).
 12. continuous  continuous serving at Qwen3-0.6B + NT-v2-500M width (bf16,
              weights from seed 0): (a) `tools/bench_serve.py --frozen
              bfloat16` (phase 14 runs its int8 default; 64 slots,
              128 requests here, 2 x capacity in place of its 3 x so the
              phase keeps its budget: 256 text + 128 DNA tokens each,
              128/64/32 new tokens sampled, windows of 16, pipelined):
              decoded tokens/s, the admit / decode split, windows and mean
              occupancy, prefill calls, pool GiB, peak memory, exactly 57
              flash_fwd per prefill chunk and none in a decode window; (b)
              the batcher against GenerationEngine on phase 4's 8 requests
              (admitted 4, one window of 16, then 4; slot_len 1024): every
              decode step's logits teacher-forced on the batcher's own
              tokens (cosine >= 0.999 per row and step; the first token's
              >= 0.9999), greedy repeats identical, greedy agreement with
              the free-running engine and of a preempted, re-admitted
              request reported (not gated: bf16 near-ties), one sampled
              window with no host sync (torch's sync debug mode, against a
              control that syncs) and no attention kernel launched; (c) a
              continuous server with tiers 8x512,8x1024, decode window 8 and
              --guided_regex over HTTP: 12 sampled requests of two prompt
              lengths routed 6 and 6, every completion matching; the guided
              spec over phase 11's BPE tokenizer (151,672 ids) under the
              151,936-row head, its host time, the columns past the
              tokenizer dead, 4 sampled engine requests matching; (d)
              flash_fwd against its plain version at the admission prefill
              [64,256,16/8,128] causal, the encoder [64,128,16,64] and (c)'s
              mixed-width tier chunk with its left pads. At most 75 s.
 13. classifier  the DNA-only classifier at NT-v2-500M width (seed 0, B=16
              pairs of L=512 random 6-mer ids, 8 classes): (a)
              `tools/bench_classifier.py` as it runs alone, the encoder
              frozen (examples/s, the median of 5 repetitions of 10 steps,
              ms per step, device-busy and wall ms of one profiled step,
              peak memory), exactly 2 x 29 = 58 flash_fwd a step and no
              flash_bwd, a finite loss; (b) `--finetune_encoder`'s trainer at
              the same shape with remat off as the bench runs it (fp32
              masters and AdamW moments of 500 M parameters): 58 flash_fwd
              and 58 flash_bwd a step over 3 timed steps, the loss falling on
              one fixed batch, peak memory, then one step with remat on (116
              flash_fwd, 58 flash_bwd); (c) flash_fwd and flash_bwd against
              their plain versions at [16,512,16,64], all valid and with the
              collate's right pads; (d) `python -m
              bioreason_tpu_torch.cli.train_dna_only` for 3 steps on
              synthetic items: its test metrics, its dna_only_final rebuilt
              by `load_classifier` to the same logits. At most 60 s.
 14. int8     int8 serving at Qwen3-0.6B + NT-v2-500M width (seed 0): (a)
              the resident weight bytes of the bf16 model and of `--int8`
              (every dense of both towers, the embedding and the tied head
              int8 with per-channel scales), counted from the modules'
              storage: about half; (b) the --int8 engine against a bf16
              engine holding its dequantized weights, teacher-forced logits
              on phase 4's 8 requests (cosine >= 0.9999 per row and step:
              only the head's scale sits elsewhere); (c) --int8 and --int8
              --w8a8 against the bf16 weights: the quantization error
              (cosine floors 0.98 and 0.95, the argmax agreement); (d) the
              server with --int8 --kv_int8 --fuse --w8a8, 8 greedy requests
              twice, identical, exactly 57 flash_fwd per engine call (the
              int8 prefill attends over its fresh bf16 K/V); (e) W8A8's
              int8 x int8 -> int32 product (torch._int_mm) exact, and against
              the dequantized product at the prefill's own shapes (relative
              error, times); flash_fwd at the int8 prefill's Tk = P; (f)
              `tools/bench_serve.py` at the JAX bench's default (--frozen
              int8) and with --kv int8 --fuse --w8a8 (128 requests each):
              tokens/s, occupancy, pool and weight GiB, peak memory, 57
              flash_fwd per prefill chunk. At most 120 s.
 15. qlora    QLoRA and int8 rollouts at NT-v2-500M + Qwen3-4B width (36
              layers, hidden 2560, 32/8 heads of 128; seed 0, bf16
              compute): (a) `tools/bench_sft.py --decoder qwen3-4b --frozen
              int8` (bench.py's shape, 2 warm-up steps, 3 repetitions of 4
              timed steps, one profiled step): examples/s, ms per step,
              device-busy ms, resident frozen and peak GiB, every dense of
              both towers int8 with bf16 scales, exactly 29 + 36 flash_fwd
              and 36 flash_bwd a step; (b) the same at --frozen bfloat16:
              int8's resident bytes as a share of bf16's, int8's peak under
              bf16's (the int8 dense's backward keeps no float weight); (c)
              one QLoRA loss and its trainable gradients against a bf16 model
              holding the dequantized weights, on the plain attention route
              (expected bitwise; held to 1e-6 relative on the loss and
              gradient cosine >= 0.999999) and through the kernels, where
              flash_bwd's dq sums in no fixed order: the int8 step run twice
              gives the noise floor, and the twin is held to the loss and a
              gradient cosine between that floor's reading and a planted
              fault's; (d) `tools/bench_grpo.py --decoder
              qwen3-4b --frozen int8 --rollout_int8` (4 prompts x G=4, 16 new
              tokens, 1 + 2 steps): completions/s, the phase timers, peak
              GiB, a finite loss and kl, exactly 3 x 29 + 4 x 36 flash_fwd
              and 36 flash_bwd a step, the reference and the rollout policy
              holding the training model's int8 weights and scales (the same
              data_ptr) and the rollout its live adapters; (e)
              `tools/bench_rollout.py` at 16 prompts x G=8 with 32 new tokens
              (1 + 3 calls), --frozen bfloat16 --kv bfloat16 and --frozen
              int8 --kv int8, at Qwen3-0.6B and at Qwen3-4B: tokens/s, weight
              and peak GiB, exactly 29 + layers flash_fwd per call, and the
              grouped int8-KV decode's first-step logits against the
              ungrouped int8-KV step on the same caches, held to a cosine
              that two planted faults (the decode slot's scales dropped,
              the prompt's key and value scales swapped) fall under;
              (f) flash_fwd and flash_bwd against their plain versions at the
              4B shapes: the SFT step [4,768,32/8,128] causal, the GRPO
              prefill, encoder, logp forward and update backward. At most
              240 s.
 16. rehearsal  the quality rehearsal and the training-loop pieces that came
              with it: (a) `tools/rehearsal.py --scale bench` at its widths
              (Qwen3-0.6B + NT-v2-50M, 1-mer DNA of 32 bp), cut for time to
              128 items, 2 SFT epochs of 12 steps with a validation every 8,
              64 tokens generated in the tests and rollouts and 2 GRPO steps
              (the bench run: 1,280 items, 40 epochs at most with the probe's
              stop, every 96, 288 tokens, 80 steps): exactly 56 flash_fwd +
              28 flash_bwd per SFT step (remat full), 28 flash_fwd per eval
              batch, per probe batch and per engine call, 112 + 28 per GRPO
              step and none from the encoder, whose 32-wide heads take the
              plain path (the counts printed are those measured per call);
              the GRPO trainer's seconds by phase (rollout, update, ...);
              the val-loss, probe and reward curves in the
              metrics files, the val loss under its first reading, best-k's
              kept steps those of the JAX CLI's rule on that curve, params
              only; the artifact under the package; attention(impl=
              "pallas") at D = 32 raising; (b) the best SFT checkpoint's test
              answers under serve's --int8 storage and with W8A8: accuracy
              and the share equal to bf16's, printed only (phase 14 holds
              both paths to teacher-forced cosine floors); (f) flash_fwd and flash_bwd
              against their plain versions at the rehearsal's decoder shape
              (B=8, the collate's bucketed T, 16/8 heads of 128, causal, its
              pads); (c) `tools/bench_sft.py` at bench.py's shape with
              --remat off, full and dots (examples/s, peak GiB, launches per
              step, one step's device-busy and wall ms, the dots step's top
              kernels), one step's loss and gradients of dots against off (the
              loss equal, the gradients' cosine beside off's against
              itself); (d) an async save between two steps: the step's time
              around it, then around a blocking save at the same point, and
              the async file equal to the snapshot, not to the stepped
              parameters; (e) --debug_nans raising FloatingPointError
              at a NaN out of flash_fwd and out of an aten op. At most 150 s.
 17. moe      Qwen3-MoE serving at Qwen3-30B-A3B + NT-v2-500M, full width
              and depth (48 layers, hidden 2048, 32/4 heads of 128, 128
              experts of 768 with 8 active, capacity factor 1.25, untied
              head, vocab 151,936): (a) every earlier phase's memory freed
              first (fails above 2 GiB still allocated), then the model
              drawn from seed 0 in bf16 directly on the card (an fp32 stage
              would need 114 GiB): parameters, resident GiB, build seconds;
              (b) `InferenceServer` in micro-batch mode, phase 4's 8
              requests of 2 x 2 kb twice, 64 greedy tokens, equal tokens,
              exactly 29 + 48 = 77 flash_fwd per engine call, all of them
              in its prefill (one prefill alone counts 77): prefill ms,
              decode tokens/s; (c) the served prefill's drops per layer (the
              tokens that lose a choice, the left pads among them), every
              layer's slots and keep flags held equal to the JAX form's (a
              cumsum over the [N, E] one-hot), the experts' loads and the
              mean cosine between the router's input rows, one
              request's prefill logits through the kernels against the
              plain route, one MoE layer in bf16 against the port's fp32
              `moe_apply` on the served prefill's own input (the share of
              tokens routed alike, their cosine) and the largest tensor that
              bf16 call allocates against N * E * C; (d) the grouped decode,
              2 prompts x G = 4, greedy, twice: a prompt's completions equal,
              the runs equal; (e) `tools/bench_serve.drive` on this
              model at 16 slots, 32 requests of 256 text + 128 DNA tokens,
              64/32/16 new tokens:
              tokens/s, pool GiB, 77 flash_fwd per prefill chunk and none in
              a window, the rows that lost a choice in each decode window;
              (g) one prefill and one decode step profiled, device ms by
              part (router and top-k, slots, dispatch gather, expert bmm,
              combine, attention, the rest), busy share, launches; the
              expert products' bound (FLOPs / 989e12 against bytes /
              3.35e12) as the capacity form computes them and as this run's
              data needs them; (f) the bf16 teacher-forced logits, then
              `serving_storage(int8=True)` in place (both copies would need
              86 GiB): resident GiB, the cosine against bf16 held to
              phase 14's floor, under which a planted fault (one scale per
              bank) must fall, one engine call's tokens/s, the int8
              profile; (h)
              flash_fwd at [8,896,32/4,128] causal with the served left pads
              against its plain version (GQA ratio 8). At most 180 s.

Before its last line it prints one JSON object {"kernels": [...]}; its last
line is {"ok": true, "device": {...}}. It exits non-zero without a result
where torch.cuda.is_available() is false or the port's package is missing.
"""

from __future__ import annotations

import contextlib
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
# ... of the larger of max |ref| and this floor: at W = 0 every query sees
# only itself, P = 1 and dS = P * (dP - delta) cancels, so the exact dq and dk
# are 0 and both versions give fp32 rounding noise (~1e-6) of the dP and
# delta they subtract; every other case's max |ref| is above 1 and unchanged
BWD_SCALE_FLOOR = 1e-2

# the redesigned kernels (wgmma + TMA) and the SASS opcodes counted as TMA
REDESIGNED = ("flash_fwd_kernel", "flash_bwd_kernel", "local_fwd_kernel", "local_bwd_kernel")
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


def library_min_ms(fn, iters: int = 10) -> float:
    """A library yardstick's time: the lowest of three repetitions of
    `cuda_ms`, so that its noise counts against the kernel, not for it."""
    return min(cuda_ms(fn, iters=iters) for _ in range(3))


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
    library_ms = library_min_ms(library)
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
    library_ms = library_min_ms(library)

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
        if errs[gname] > BWD_RTOL_OF_MAX * max(ref_max, BWD_SCALE_FLOOR):
            fail(f"kernel {name}: local_bwd {gname} differs from the plain version by "
                 f"{errs[gname]:.4g} (max |ref| {ref_max:.4g}, tolerance {BWD_RTOL_OF_MAX} of "
                 f"it, or of {BWD_SCALE_FLOOR} if larger)")
        errs[gname + "_ref_max"] = ref_max
    del refs

    def fwd():
        return la.local_attention(q, k, v, window, mask)

    def bwd():
        return la.local_bwd(q, k, v, window, mask, out, lse, dout)
    ms, bwd_ms = cuda_ms(fwd, iters=20), cuda_ms(bwd, iters=20)
    dev_ms, bwd_dev_ms = graph_ms(fwd), graph_ms(bwd)
    plain_ms = cuda_ms(lambda: la.local_attention_ref(q, k, v, window, mask), iters=3, warmup=1)
    plain_bwd_ms = cuda_ms(lambda: la.local_attention_bwd_ref(q, k, v, window, mask, out, lse,
                                                              dout), iters=3, warmup=1)
    # library yardstick: SDPA with the dense band mask, forward and the
    # backward of one call on a retained graph (copies and mask made first)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    amask = vis[:, None]
    def library():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask,
                                                  enable_gqa=hkv != hq)
    library_ms, library_dev_ms = library_min_ms(library), graph_ms(library)
    o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask, enable_gqa=hkv != hq)
    do_t = dout.transpose(1, 2).contiguous()
    library_bwd_ms = library_min_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), do_t,
                                                                retain_graph=True))
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
    for kind, flops, nbytes, kms, gms, pms, lms, e in (
            ("fwd", 4.0 * d * hq * pairs, fwd_bytes, ms, dev_ms, plain_ms, library_ms,
             {"max_abs_err": err, "lse_max_abs_err": lse_err,
              "library_graph_ms": library_dev_ms}),
            ("bwd", 10.0 * d * hq * pairs, bwd_bytes, bwd_ms, bwd_dev_ms, plain_bwd_ms,
             library_bwd_ms, {"max_abs_err": max(errs["dq"], errs["dk"], errs["dv"]), **errs})):
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
        out_rows.append({"shape": name, "kernel": f"local_{kind}", **shape, **e, "ms": kms,
                         "graph_ms": gms, "plain_ms": pms, "library_ms": lms,
                         "bound_ms": max(t_ops, t_bytes),
                         "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                         "tflops": flops / (kms * 1e-3) / 1e12})
    f_, b_ = out_rows
    log(f"kernel {name} (band): B={b} T={t} Hq={hq} Hkv={hkv} D={d} W={window}: "
        f"{pairs:.4g} visible pairs, {n_empty} rows without a key; local_fwd max abs err "
        f"{err:.3g} (lse {lse_err:.3g}), ms {ms:.4f} (graph {dev_ms:.4f}) plain_ms "
        f"{plain_ms:.3f} library_ms {library_ms:.4f} (graph {library_dev_ms:.4f}) bound_ms "
        f"{f_['bound_ms']:.4f} ({f_['bound_by']}), "
        f"{f_['tflops']:.1f} TFLOP/s; local_bwd max abs err dq {errs['dq']:.3g} dk "
        f"{errs['dk']:.3g} dv {errs['dv']:.3g} (max |ref| {errs['dq_ref_max']:.3g} "
        f"{errs['dk_ref_max']:.3g} {errs['dv_ref_max']:.3g}), ms {bwd_ms:.4f} (graph "
        f"{bwd_dev_ms:.4f}) plain_ms "
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
        # a band edge on the 128-key tile boundary, GQA at D=128, ragged T,
        # left pads as the collate gives them (rows that see no valid key)
        *local_case(torch, "band_edge_T1000_W128", 2, 1000, 16, 8, 128, 128,
                    left_padded(torch, 2, 1000, 0, 300,
                                torch.Generator(device="cuda").manual_seed(36)), 36),
        # the diagonal alone: every query sees only itself
        *local_case(torch, "band_diag_T777_W0", 2, 777, 16, 16, 64, 0,
                    torch.ones((2, 777), dtype=torch.int32, device="cuda"), 37),
    ]
    # the long-DNA encoder's shape without the band, for the O(T * W) saving
    rows.append(kernel_case(torch, "encoder_long_T2048_full", 4, 2048, 2048, 16, 16, 64, False,
                            None, enc_mask, 32))
    bwd_rows.append(bwd_case(torch, "encoder_long_T2048_full_bwd", 4, 2048, 2048, 16, 16, 64,
                             False, 0, enc_mask, 32))
    return rows, bwd_rows, band_rows


# -- phase 4 -----------------------------------------------------------------

def burst(server, reqs, max_new):
    """Send `reqs` to `server` at once, one thread each, greedy; the
    results in request order."""
    results = [None] * len(reqs)

    def one(i):
        results[i] = server.generate(reqs[i], max_new_tokens=max_new, greedy=True)
    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(reqs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return results


def record_engine_calls(server):
    """Wrap `server.engine.generate` so each call appends ((ids, mask),
    its last_stats) to the returned list; `restore` undoes the wrap. With
    random weights most greedy ids lie past the byte tokenizer's 266 ids
    and decode to "", so repeats are compared on ids, not only on texts."""
    calls, engine_generate = [], server.engine.generate

    def recording_generate(*args, **kw):
        out = engine_generate(*args, **kw)
        calls.append((out, dict(server.engine.last_stats)))
        return out
    server.engine.generate = recording_generate

    def restore():
        server.engine.generate = engine_generate
    return calls, restore


def completion_rows(calls):
    """Completion rows of recorded engine calls as a sorted multiset (the
    batch order follows the requests' arrival, which threads do not fix)."""
    return sorted(tuple(ids[i][mask[i].astype(bool)].tolist())
                  for (ids, mask), _ in calls for i in range(ids.shape[0]))


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
    calls_out, restore = record_engine_calls(server)

    # --- the main path: counts from 0 just before, read just after ---------
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = 0
    calls0 = server.engine_calls
    first = burst(server, items, max_new)
    n_first = len(calls_out)
    second = burst(server, items, max_new)
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
    restore()
    # -----------------------------------------------------------------------

    answered = [r for r in first + second if r and set(r) == {"completion", "answer"}]
    if len(answered) != 16 or http_status != 200 or set(http_result) != {"completion", "answer"}:
        fail(f"not every request was answered: {first} {second} {http_result}")
    first_rows = completion_rows(calls_out[:n_first])
    if (len(first_rows) != 8 or first_rows != completion_rows(calls_out[n_first:-1])
            or first != second):
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
    `max_new` tokens of the 8-request batch (`profile_step`): device time
    by kernel and the device's busy share."""
    from bioreason_tpu_torch.serve import prepare_batch
    args = [torch.as_tensor(a, device="cuda")
            for a in prepare_batch(server.processor, server.cfg, items)]
    eng = server.engine
    profile_step(torch, card, "prefill", lambda: eng.prefill(server.model, *args, max_new),
                 ("flash_fwd",))
    profile_step(torch, card, "generate",
                 lambda: eng.generate(server.model, *args, max_new_tokens=max_new, greedy=True),
                 ("flash_fwd",))


def profile_step(torch, card, label, step, names, ranges=()):
    """One step under torch.profiler, read from its raw events (a GRPO step
    makes ~300k launches, and building the profiler's per-op tables for them
    takes minutes). Prints the wall, the device busy time and share (every
    device event that is not a user range), the launches, the top kernels,
    the share of the kernels whose names hold each of `names`, and the
    device time of the kernels launched inside each `record_function` range
    named in `ranges` (a kernel belongs to a range when the host op that
    launched it started inside it). Returns the busy and wall ms, the parts
    and each kernel as (name, duration ns, the ranges it belongs to, device
    start ns)."""
    import bisect
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = {r: [] for r in ranges}
    op_start, kernels = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if e.is_user_annotation():
                if e.name() in spans:
                    spans[e.name()].append((e.start_ns(), e.end_ns()))
            else:
                op_start[e.correlation_id()] = e.start_ns()
        elif not e.is_user_annotation():
            kernels.append((e.name(), e.duration_ns(), e.linked_correlation_id(),
                            e.start_ns()))
    busy_ms = sum(k[1] for k in kernels) / 1e6
    by_name = {}
    for name, dur, *_ in kernels:
        n, t = by_name.get(name, (0, 0))
        by_name[name] = (n + 1, t + dur)
    share = {n: sum(t for k, (_, t) in by_name.items() if n in k) / 1e6 for n in names}
    log(f"profile [{card}] {label}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {len(kernels)} kernel launches; "
        + ", ".join(f"{k} {v:.3f} ms ({100 * v / max(busy_ms, 1e-9):.1f}% of device time)"
                    for k, v in share.items()))
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        log(f"  {t / 1e6:9.3f} ms {n:6d}x  {name[:90]}")
    parts, in_ranges = {}, [set() for _ in kernels]
    for r, iv in spans.items():
        iv.sort()
        starts = [a for a, _ in iv]
        total = 0
        for k, (_, dur, corr, _) in enumerate(kernels):
            t = op_start.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t < iv[i][1]:
                total += dur
                in_ranges[k].add(r)
        parts[r] = (len(iv), total / 1e6)
    by_kernel = [(name, dur, frozenset(rs), start)
                 for (name, dur, _, start), rs in zip(kernels, in_ranges)]
    if not ranges:
        return busy_ms, wall_ms, parts, by_kernel
    linked = sum(1 for k in kernels if k[2] in op_start)
    log(f"profile [{card}] {label} parts (device ms of the kernels launched inside each "
        f"range, share of busy; {linked} of {len(kernels)} kernels linked to a host op): "
        + ", ".join(f"{r} x{n} {ms:.3f} ({100 * ms / max(busy_ms, 1e-9):.1f}%)"
                    for r, (n, ms) in parts.items()))
    return busy_ms, wall_ms, parts, by_kernel


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


def phase_train(torch, card, ckpt):
    import torch.nn.functional as F
    from bioreason_tpu_torch.cli import train_sft
    from bioreason_tpu_torch.config import (DecoderConfig, EncoderConfig, FusionConfig,
                                            LoRAConfig, OptimConfig, SFTConfig)
    from bioreason_tpu_torch.models.fusion import fusion_forward
    from bioreason_tpu_torch.ops import flash_attention as fa
    from bioreason_tpu_torch.train.sft import SFTTrainer
    per_step_fwd = ENCODER_LAYERS + DECODER_LAYERS

    # (a) the CLI, end to end: collate, labels, gathered CE, optimizer. Its
    # presets keep remat on, so each decoder layer's forward runs twice. Its
    # sft_final stays for phase 8's reason CLI; main removes `ckpt`.
    reset_counts()
    t0 = time.perf_counter()
    trainer = train_sft.main(["--max_steps", "4", "--seed", "0", "--checkpoint_dir", ckpt])
    secs = time.perf_counter() - t0
    fwd, bwd = fa.flash_attention.launches, fa.flash_bwd.launches
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
    # flash_bwd's prep and convert passes also run around every local_bwd
    profile_step(torch, card, "train-long step", lambda: trainer.train_step(batch),
                 ("local_fwd", "local_bwd", "flash_fwd", "flash_bwd", "flash_bwd_prep",
                  "flash_bwd_convert"))
    return got


# -- phase 8 -----------------------------------------------------------------

# bench_grpo.py samples 64 new tokens; this phase samples 32, half the
# decode depth, so that the script with phase 11 keeps the time it took
# before it: the rollout's decode loop is host-bound (~60 ms a step) and its
# profiled step alone took 31.8 s at 64. The towers keep their full depth:
# at a quarter of it the update's kernel vs plain cosine fell to 0.81 on
# gradients 1000x smaller (norm 1.2e-3 against 1.28), a check the cut made
# meaningless, not a kernel fault
GRPO_PROMPTS, GRPO_G, GRPO_NEW = 4, 4, 16


def grpo_setup():
    """bench_grpo.py's configuration (bench_grpo.py:54-84): the fusion
    config, the GRPOConfig, the processor and the G-repeated items."""
    from bioreason_tpu_torch.config import (DecoderConfig, EncoderConfig, FusionConfig,
                                            GRPOConfig, LoRAConfig, OptimConfig, SamplingConfig)
    from bioreason_tpu_torch.data import BioProcessor, ByteTextTokenizer, KmerTokenizer
    from bioreason_tpu_torch.data.kegg import format_kegg_prompt_only, synthetic_kegg_items
    tok = ByteTextTokenizer()
    cfg = FusionConfig(
        decoder=dataclasses.replace(DecoderConfig.qwen3_0_6b(vocab_size=tok.vocab_size),
                                    remat=True, remat_policy="full"),
        encoder=dataclasses.replace(EncoderConfig.nt_v2_500m(), remat=False),
        dna_pad_token_id=tok.dna_pad_id, max_length_text=512, max_length_dna=128)
    gcfg = GRPOConfig(num_generations=GRPO_G, batch_size=GRPO_PROMPTS * GRPO_G, beta=0.04,
                      max_completion_length=GRPO_NEW,
                      sampling=SamplingConfig(max_new_tokens=GRPO_NEW),
                      optim=OptimConfig(learning_rate=5e-6, total_steps=100),
                      lora=LoRAConfig(r=32, alpha=64), seed=0)
    items = [format_kegg_prompt_only(it)
             for it in synthetic_kegg_items(GRPO_PROMPTS, seq_len=600, seed=0)]
    return cfg, gcfg, BioProcessor(tok, KmerTokenizer()), [x for x in items for _ in range(GRPO_G)]


def acgt_share_reward(prompts, completions, **kw):
    """The share of A, C, G and T among a completion's characters. With
    random weights the registry's rewards are 0 for every completion, so the
    advantages, the gradient and the update would be 0: this one varies."""
    return [sum(c in "ACGT" for c in x) / max(len(x), 1) for x in completions]


def grpo_kernel_cases(torch, trainer, items, prefix="grpo"):
    """flash_fwd and flash_bwd at the shapes and masks one GRPO step of
    `trainer` gives them, from its own prompts and last rollout buffer: the
    grouped prefill (causal, Tq = Tk = P: the prompt cache has no decode
    slots, the prompts' left pads), the encoder as the rollout runs it (the
    unique prompts' DNA rows) and as the logp passes run it (the G-repeated
    rows), the logp passes' forward and the update's
    backward (causal over the prompt and its completion). Random weights
    never stop a completion at EOS, so half the rows get the completion
    mask an EOS gives (ones up to it, zeros after) at drawn lengths, the
    shortest 1."""
    dec, enc = trainer.fusion_cfg.decoder, trainer.fusion_cfg.encoder
    hq, hkv, d = dec.num_heads, dec.num_kv_heads, dec.head_dim
    out, _ = trainer._prepare_prompts(items[::GRPO_G])
    pmask = torch.as_tensor(np.asarray(out.attention_mask), dtype=torch.int32, device="cuda")
    bu, p = pmask.shape
    buf = trainer._buffers[0]["batch"]
    full = buf["full_mask"].to(torch.int32).clone()
    b, t = full.shape
    ends = np.random.default_rng(41).integers(1, t - p, b // 2)
    ends[0] = 1
    for i, e in zip(range(0, b, 2), ends):
        full[i, p + int(e):] = 0
    dna_u = torch.as_tensor(np.asarray(out.dna_attention_mask), dtype=torch.int32,
                            device="cuda")
    dna = buf["dna_attention_mask"].to(torch.int32)
    log(f"grpo kernels: prefill B={bu} P={p}; logps and update B={b} T={t}, completion "
        f"lengths {full[:, p:].sum(-1).tolist()}; encoder {list(dna_u.shape)} (rollout), "
        f"{list(dna.shape)} (logps)")
    rows = [kernel_case(torch, f"{prefix}_prefill_P{p}", bu, p, p, hq, hkv, d, True, 0, pmask,
                        41),
            *(kernel_case(torch, f"{prefix}_{part}_encoder_T{m.shape[1]}", m.shape[0],
                          m.shape[1], m.shape[1], enc.num_heads, enc.num_heads, enc.head_dim,
                          False, None, m, seed)
              for part, m, seed in (("rollout", dna_u, 45), ("logps", dna, 42))),
            kernel_case(torch, f"{prefix}_logps_T{t}_eos", b, t, t, hq, hkv, d, True, None,
                        full, 43)]
    bwd_rows = [bwd_case(torch, f"{prefix}_update_T{t}_eos", b, t, t, hq, hkv, d, True, 0,
                         full, 44)]
    return rows, bwd_rows


def phase_grpo(torch, card, sft_final):
    """GRPO through the port's trainer and CLI (module docstring, phase 8)."""
    import torch.nn.functional as F
    from torch.profiler import record_function
    from bioreason_tpu_torch.cli import reason
    from bioreason_tpu_torch.models import qwen3
    from bioreason_tpu_torch.ops.sampling import sample_logits
    from bioreason_tpu_torch.train import grpo as grpo_mod
    from bioreason_tpu_torch.train.grpo import GRPOTrainer
    from bioreason_tpu_torch.train.rewards import get_reward_funcs
    t_phase = time.perf_counter()
    cfg, gcfg, proc, items = grpo_setup()
    n = len(items)
    trainer = GRPOTrainer(cfg, gcfg, proc,
                          get_reward_funcs(["xmlcount", "correctness"]) + [acgt_share_reward])
    b_leaves = {k: p.detach().clone() for k, p in trainer.trainable_state().items()
                if k.endswith("lora_b")}
    # per step: the rollout's encoder and prefill, the ref pass's encoder and
    # decoder, the update's encoder and its decoder twice (remat), one
    # backward per decoder layer; decode steps (Tq = 1) take the plain
    # grouped attention
    per_step = {"flash_fwd": 3 * ENCODER_LAYERS + 4 * DECODER_LAYERS,
                "flash_bwd": DECODER_LAYERS}
    log(f"grpo: trainer built in {time.perf_counter() - t_phase:.1f} s")
    t_sub = time.perf_counter()
    history = [trainer.step(items)]                      # warm-up
    torch.cuda.synchronize()
    log(f"grpo: warm-up step {time.perf_counter() - t_sub:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    trainer.timers = {}
    steps = 3
    # --- the main path: counts from 0 just before, read just after ---------
    reset_counts()
    t0 = time.perf_counter()
    history += [trainer.step(items) for _ in range(steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = counts()
    # -----------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    tm = trainer.timers
    trainer.timers = None
    stats = trainer.engine.last_stats
    log(f"grpo [{card}]: {GRPO_PROMPTS} prompts x G={GRPO_G}, P={stats['prompt_len']}, "
        f"{GRPO_NEW} new tokens, LoRA r32/a64, beta 0.04, remat full: "
        f"{n * steps / dt:.3f} completions/s, {dt / steps * 1e3:.1f} ms per step over {steps} "
        f"steps; seconds per phase {', '.join(f'{k} {tm[k]:.3f}' for k in ('prep', 'rollout', 'logps_dispatch', 'rewards', 'update'))} "
        f"({tm['steps']} steps); torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB")
    log(f"grpo: launches {got} ({', '.join(f'{k} {v / steps:g}' for k, v in got.items())} "
        f"per step); last rollout decode {stats['steps'] - 1} steps in "
        f"{stats['decode_s'] * 1e3:.1f} ms, prefill {stats['prefill_s'] * 1e3:.1f} ms; "
        f"nonfinite_rows {[m['nonfinite_rows'] for m in history]}")
    log("grpo: per step " + "; ".join(
        f"loss {m['loss']:.5g} kl {m['kl']:.4g} clip {m['clip_ratio']:.3g} grad_norm "
        f"{m['grad_norm']:.4g} reward {m['reward']:.3g} length {m['completion_length']:.1f}"
        for m in history))
    if any(not math.isfinite(m[k]) for m in history for k in ("loss", "kl", "reward")):
        fail(f"non-finite GRPO loss, kl or reward: {history}")
    want = {k: steps * per_step.get(k, 0) for k in got}
    if got != want:
        fail(f"GRPO launched {got} in {steps} steps, expected {want}")
    state = trainer.trainable_state()
    still = [k for k, b0 in b_leaves.items() if torch.equal(state[k].detach(), b0)]
    log(f"grpo: {len(b_leaves) - len(still)} of {len(b_leaves)} LoRA B leaves moved")
    if still:
        fail(f"GRPO LoRA B leaves did not move: {still[:4]}")

    # one step profiled, with the device time of its parts
    t_sub = time.perf_counter()
    ranges = {"rollout": (trainer.engine, "generate"),
              "update": (trainer, "_update"),
              "grouped_decode_attention": (qwen3, "_grouped_decode_attention")}
    saved = {name: getattr(obj, attr) for name, (obj, attr) in ranges.items()}
    real_logps = grpo_mod.per_token_logps

    def labelled(name, fn):
        def run(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return run

    def logps(model, *a, **kw):
        with record_function("ref_logps" if model is trainer.ref_model else "policy_logps"):
            return real_logps(model, *a, **kw)
    try:
        for name, (obj, attr) in ranges.items():
            setattr(obj, attr, labelled(name, saved[name]))
        grpo_mod.per_token_logps = logps
        profile_step(torch, card, "grpo step", lambda: trainer.step(items),
                     ("flash_fwd", "flash_bwd"), (*ranges, "ref_logps", "policy_logps"))
    finally:
        for name, (obj, attr) in ranges.items():
            setattr(obj, attr, saved[name])
        grpo_mod.per_token_logps = real_logps
    log(f"grpo: profiled step and its reading took {time.perf_counter() - t_sub:.1f} s")
    t_sub = time.perf_counter()

    # greedy grouped rollouts: identical within each group
    out, _ = trainer._prepare_prompts(items[::GRPO_G])
    ids, _ = trainer.engine.generate(trainer.model, out.input_ids, out.attention_mask,
                                     out.dna_input_ids, out.dna_attention_mask, greedy=True,
                                     max_new_tokens=16, group_size=GRPO_G)
    groups = ids.reshape(GRPO_PROMPTS, GRPO_G, -1)
    if not (groups == groups[:, :1]).all():
        fail("greedy grouped rollouts differ within a group")
    log(f"grpo: greedy grouped rollouts [{ids.shape[0]}, {ids.shape[1]}] identical within "
        f"each of {GRPO_PROMPTS} groups ({time.perf_counter() - t_sub:.1f} s)")
    t_sub = time.perf_counter()

    # one update loss + gradient through the kernels against the plain route
    buf = trainer._buffers[0]

    def loss_and_grad(c):
        trainer.fusion_cfg = c
        try:
            loss, kl, _ = trainer._loss(buf["batch"], buf["completion_len"])
            grads = torch.autograd.grad(loss, trainer.params, allow_unused=True)
        finally:
            trainer.fusion_cfg = cfg
        flat = torch.cat([(torch.zeros_like(p) if g is None else g).float().flatten()
                          for p, g in zip(trainer.params, grads)])
        return float(loss.detach()), float(kl.detach()), flat
    reset_counts()
    lk, kk, gk = loss_and_grad(cfg)
    kernel_counts = counts()
    plain = dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, attention_impl="xla"),
        encoder=dataclasses.replace(cfg.encoder, attention_impl="xla"))
    reset_counts()
    lp, kp, gp = loss_and_grad(plain)
    if any(counts().values()) or not kernel_counts["flash_bwd"]:
        fail(f"the routes launched {kernel_counts} (kernel) and {counts()} (plain)")
    cos = float(F.cosine_similarity(gk, gp, dim=0))
    log(f"grpo: kernel vs plain route, one update loss + gradient on the last rollout buffer: "
        f"loss {lk:.6g} vs {lp:.6g}, kl {kk:.6g} vs {kp:.6g}, cosine of the {gk.numel()} "
        f"trainable gradients {cos:.6f}, norms {float(gk.norm()):.4g} vs "
        f"{float(gp.norm()):.4g} ({time.perf_counter() - t_sub:.1f} s)")
    if not (math.isfinite(lk) and math.isfinite(lp)) or cos < 0.99:
        fail(f"kernel and plain routes disagree in the GRPO update (cosine {cos:.4f})")
    del gk, gp

    # the sampler on non-finite rows, on the card
    bad = torch.randn((4, cfg.decoder.vocab_size), device="cuda")
    bad[1] = float("nan")
    bad[2] = float("-inf")
    ids_bad = sample_logits(bad, 0.6, 20, 0.95,
                            generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    if ids_bad[1:3].tolist() != [0, 0] or not bool(((ids_bad >= 0) & (
            ids_bad < cfg.decoder.vocab_size)).all()):
        fail(f"sample_logits on a NaN and an all -inf row gave {ids_bad.tolist()}")
    log(f"grpo: sample_logits on the card, rows finite / NaN / all -inf / finite: "
        f"{ids_bad.tolist()}")
    t_sub = time.perf_counter()
    rows, bwd_rows = grpo_kernel_cases(torch, trainer, items)
    log(f"grpo: kernels at the step's shapes checked in {time.perf_counter() - t_sub:.1f} s")
    secs_trainer = time.perf_counter() - t_phase
    del trainer, buf
    torch.cuda.empty_cache()

    # the reason CLI from phase 6's sft_final
    run_dir = os.path.dirname(sft_final)
    reset_counts()
    t0 = time.perf_counter()
    cli = reason.main(["--sft_checkpoint", sft_final, "--seed", "0", "--max_steps", "2",
                       "--num_generations", str(GRPO_G), "--batch_size",
                       str(GRPO_PROMPTS * GRPO_G), "--max_completion_length", str(GRPO_NEW),
                       "--max_length_dna", "128", "--checkpoint_dir", run_dir,
                       "--log_dir", os.path.join(run_dir, "logs")])
    secs = time.perf_counter() - t0
    cli_counts = counts()
    hist = cli.metrics_history
    log(f"grpo (reason cli) [{card}]: 2 steps from {os.path.basename(sft_final)} in "
        f"{secs:.1f} s (model rebuild included): losses {[round(m['loss'], 6) for m in hist]}, "
        f"kl {[round(m['kl'], 6) for m in hist]}, rewards {[m['reward'] for m in hist]}; "
        f"launches {cli_counts}")
    if len(hist) != 2 or not all(math.isfinite(m["loss"]) and math.isfinite(m["reward"])
                                 for m in hist):
        fail(f"reason.main did not run 2 finite steps: {hist}")
    if not os.path.isfile(os.path.join(run_dir, "grpo_final", "state.pt")):
        fail("reason.main wrote no grpo_final")
    del cli
    torch.cuda.empty_cache()
    log(f"grpo: phase done in {time.perf_counter() - t_phase:.1f} s (trainer part "
        f"{secs_trainer:.1f} s)")
    return got, rows, bwd_rows


# -- phase 9 -----------------------------------------------------------------

EVO2_BLOCKS, EVO2_ATTN = 25, (6, 13, 20)     # Evo2-1B: attention in 3 of 25 blocks
EVO2_BP = 2048                               # 2 x 2 kb per KEGG item, one byte token per bp
# the committed fixtures (tests/assets) and their goldens' tolerance: 2e-5
# for the 4-block tower; the 25-block one's goldens carry fp32 rounding of
# their own beyond 2e-5 (an fp64 evaluation misses them by up to 3.50e-5,
# tests/test_torch_evo2.py), so 1e-4 there
EVO2_FIXTURES = (("evo2_tiny", 1, (2, 12), ((None, "evo2_tiny_out"), (2, "evo2_tiny_tap")),
                  2e-5),
                 ("evo2_1b_depth_tiny", 5, (2, 24),
                  ((None, "evo2_1b_depth_out"), (20, "evo2_1b_depth_tap20")), 1e-4))


def evo2_served_inputs(n: int = 8):
    """The 8-request batch phase 9 serves, as `prepare_batch` hands it to
    the engine: KEGG-shaped items of 2 x 2048 bp, byte-tokenized."""
    from bioreason_tpu_torch.data.kegg import synthetic_kegg_items
    from bioreason_tpu_torch.serve import build_config, prepare_batch
    items = synthetic_kegg_items(n=n, seq_len=EVO2_BP, seed=0)
    cfg, processor = build_config("qwen3-0.6b", "evo2-1b", max_length_dna=EVO2_BP)
    return items, prepare_batch(processor, cfg, items)


def phase_evo2_goldens(torch):
    """The committed vortex fixtures through the port's importer on the
    card, fp32, the plain attention of their own configs: held to their
    goldens with cuDNN's TF32 off (this script's setting) and on (PyTorch's
    default), so the depthwise convolutions' precision is measured."""
    from bioreason_tpu_torch.models.evo2 import hyena_forward
    from bioreason_tpu_torch.utils.pretrained import load_pretrained_evo2
    assets = os.path.join(REPO, "tests", "assets")
    build_dir = os.path.join(REPO, "bioreason_tpu_torch", "build")
    os.makedirs(build_dir, exist_ok=True)
    worst = 0.0
    for name, seed, shape, outs, tol in EVO2_FIXTURES:
        tmp = tempfile.mkdtemp(prefix="smoke_evo2_", dir=build_dir)
        try:
            shutil.copy(os.path.join(assets, f"{name}.pt"), tmp)
            cfg, tower = load_pretrained_evo2(tmp, device="cuda", dtype="float32",
                                              attention_impl="xla", remat=False)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        ids = torch.as_tensor(np.random.default_rng(seed).integers(0, 32, shape),
                              dtype=torch.int32, device="cuda")
        for tap, golden in outs:
            want = np.load(os.path.join(assets, f"{golden}.npy"))
            errs = {}
            for tf32 in (False, True):
                torch.backends.cudnn.allow_tf32 = tf32
                try:
                    with torch.no_grad():
                        got = hyena_forward(tower, cfg, ids, tap_layer=tap).cpu().numpy()
                finally:
                    torch.backends.cudnn.allow_tf32 = False
                err = np.abs(got - want)
                errs[tf32] = (float(err.max()), float((err / (tol + tol * np.abs(want))).max()))
            log(f"evo2 goldens: {name} {golden} on the card, fp32: max abs err {errs[False][0]:.3g} "
                f"({errs[False][1]:.3f} of the tolerance {tol:g} abs + rel) with cuDNN TF32 off, "
                f"{errs[True][0]:.3g} ({errs[True][1]:.3f}) with it on")
            if max(errs[False][1], errs[True][1]) > 1.0:
                fail(f"the {name} fixture misses its golden {golden} on the card: {errs}")
            worst = max(worst, errs[False][0], errs[True][0])
    return worst


def phase_evo2_serve(torch, card, max_new):
    """Evo2-1B + Qwen3-0.6B served at full width (module docstring, phase 9)."""
    from bioreason_tpu_torch.generate.engine import GenerationEngine
    from bioreason_tpu_torch.models.evo2 import hyena_forward
    from bioreason_tpu_torch.ops import flash_attention as fa
    from bioreason_tpu_torch.serve import build_server, prepare_batch

    t_phase = time.perf_counter()
    server = build_server("qwen3-0.6b", "evo2-1b", max_length_dna=EVO2_BP, seed=0,
                          max_batch=8, batch_window_ms=500.0, max_new_tokens=max_new,
                          greedy_default=True)
    cfg = server.cfg
    hy, dec = cfg.hyena, cfg.decoder
    attn_blocks = tuple(i for i in range(hy.num_layers) if hy.flavor(i) == "attn")
    if (cfg.encoder_kind, hy.num_layers, hy.hidden_size, hy.num_heads, hy.head_dim,
            hy.intermediate_size, attn_blocks) != ("evo2", EVO2_BLOCKS, 1920, 15, 128, 5120,
                                                   EVO2_ATTN):
        fail(f"the DNA tower is not Evo2-1B: {cfg.encoder_kind} {hy}")
    if (dec.num_layers, dec.hidden_size, dec.num_heads, dec.num_kv_heads, dec.vocab_size) != (
            DECODER_LAYERS, 1024, 16, 8, 151936):
        fail(f"decoder is not at Qwen3-0.6B width: {dec}")
    n_tower = sum(p.numel() for p in server.model.encoder.parameters())
    n_all = sum(p.numel() for p in server.model.parameters())
    items, (ids, mask, dna, dmask) = evo2_served_inputs()
    flavors = "".join(hy.flavor(i)[0] for i in range(hy.num_layers))
    log(f"evo2 serve: model of {n_all / 1e6:.1f} M parameters ({n_tower / 1e6:.1f} M in the "
        f"Evo2 tower, flavors {flavors}), seed 0, built in {time.perf_counter() - t_phase:.2f} s; the served batch: B="
        f"{ids.shape[0]} P={ids.shape[1]} text tokens, DNA {list(dna.shape)} "
        f"({int(dmask.sum())} valid)")

    # the kernel route against the plain route on one request at full width
    one = [torch.as_tensor(a, device="cuda")
           for a in prepare_batch(server.processor, cfg, items[:1])]
    plain_cfg = dataclasses.replace(cfg, hyena=dataclasses.replace(hy, attention_impl="xla"),
                                    decoder=dataclasses.replace(dec, attention_impl="xla"))
    eos = server.processor.text_tokenizer.eos_token_id
    before = fa.flash_attention.launches
    k_logits = server.engine.prefill(server.model, *one, max_new)[0]
    if fa.flash_attention.launches - before != len(EVO2_ATTN) + DECODER_LAYERS:
        fail("the kernel route did not launch flash_fwd once per tower attention block and "
             "prefill layer")
    p_logits = GenerationEngine(plain_cfg, eos).prefill(server.model, *one, max_new)[0]
    if not (bool(torch.isfinite(k_logits).all()) and bool(torch.isfinite(p_logits).all())):
        fail("non-finite Evo2 prefill logits")
    cos = float(torch.nn.functional.cosine_similarity(k_logits, p_logits, dim=-1).min())
    log(f"evo2 serve: kernel vs plain route, last-column prefill logits of one request "
        f"(P={one[0].shape[1]}): min cosine {cos:.6f}, max abs diff "
        f"{float((k_logits - p_logits).abs().max()):.4g}, same argmax "
        f"{bool((k_logits.argmax(-1) == p_logits.argmax(-1)).all())}")
    if cos < 0.99:
        fail(f"kernel and plain routes disagree on the Evo2 path (cosine {cos:.4f})")
    del k_logits, p_logits

    server.start()
    calls_out, restore = record_engine_calls(server)

    # --- the main path: counts from 0 just before, read just after ---------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    calls0 = server.engine_calls
    first = burst(server, items, max_new)
    n_first = len(calls_out)
    second = burst(server, items, max_new)
    got = counts()
    calls = server.engine_calls - calls0
    peak = torch.cuda.max_memory_allocated()
    server.stop()
    restore()
    # -----------------------------------------------------------------------

    answered = [r for r in first + second if r and set(r) == {"completion", "answer"}]
    if len(answered) != 16:
        fail(f"not every Evo2 request was answered: {first} {second}")
    rows = [completion_rows(calls_out[:n_first]), completion_rows(calls_out[n_first:])]
    if len(rows[0]) != 8 or rows[0] != rows[1] or first != second:
        fail("greedy repeats of the same 8 Evo2 requests differ")
    per_call = len(EVO2_ATTN) + DECODER_LAYERS
    if got["flash_fwd"] != per_call * calls or any(v for k, v in got.items() if k != "flash_fwd"):
        fail(f"the Evo2 server launched {got} in {calls} engine calls, expected "
             f"{per_call} flash_fwd per call ({len(EVO2_ATTN)} tower attention blocks + "
             f"{DECODER_LAYERS} prefill layers)")
    log(f"evo2 serve: 16 requests answered in {calls} engine calls ({n_first} for the first "
        f"8); flash_fwd launches {got['flash_fwd']} = {got['flash_fwd'] // max(calls, 1)} per "
        f"call; greedy repeats identical")
    for name, (_, st) in (("first 8", calls_out[n_first - 1]), ("same 8 again", calls_out[-1])):
        tps = st["decode_tokens"] / st["decode_s"] if st["decode_s"] else 0.0
        log(f"evo2 serve [{card}] {name}: B={st['batch']} P={st['prompt_len']}: prefill "
            f"(tower + splice + prefill + first token) {st['prefill_s'] * 1e3:.1f} ms; decode "
            f"{tps:.1f} tokens/s over {st['steps'] - 1} steps "
            f"({st['decode_s'] / max(st['steps'] - 1, 1) * 1e3:.2f} ms per step)")
    log(f"evo2 serve [{card}]: torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB")

    # one profiled prefill, its device time split by part
    args = [torch.as_tensor(a, device="cuda") for a in (ids, mask, dna, dmask)]
    evo2_profile(torch, card, "evo2 prefill",
                 lambda: server.engine.prefill(server.model, *args, max_new),
                 tower_attention_first=len(EVO2_ATTN))

    # the frozen-dtype question (ROADMAP 3): the tower's output with its
    # filter leaves stored in bf16, as a frozen SFT tower stores them,
    # against fp32 storage, same seed, on the served DNA
    tower = server.model.encoder
    d_ids, d_mask = args[2], args[3]
    with torch.no_grad():
        ref = hyena_forward(tower, hy, d_ids, d_mask)
        saved = {n: p.detach().clone() for n, p in tower.named_parameters()
                 if ".hyena." in n and p.dtype == torch.float32 and p.dim() >= 2}
        for which in ("poles", "all"):
            for n, p in tower.named_parameters():
                if n in saved and (which == "all" or n.endswith("filter.poles")):
                    p.copy_(saved[n].to(torch.bfloat16))
            out = hyena_forward(tower, hy, d_ids, d_mask)
            v = d_mask.bool()
            diff = (out.float() - ref.float())[v]
            rel = float(diff.norm() / ref.float()[v].norm())
            cosr = float(torch.nn.functional.cosine_similarity(out.float()[v], ref.float()[v],
                                                               dim=-1).min())
            log(f"evo2 frozen storage [{card}]: tower output [{list(ref.shape)}] with "
                f"{'the li poles' if which == 'poles' else 'every filter leaf of ndim >= 2'} "
                f"stored in bf16 against fp32: max abs diff {float(diff.abs().max()):.4g} "
                f"(max |out| {float(ref.float()[v].abs().max()):.4g}), relative norm "
                f"{rel:.4g}, min row cosine {cosr:.6f}")
            for n, p in tower.named_parameters():
                if n in saved:
                    p.copy_(saved[n])
    del saved, ref
    log(f"evo2 serve: phase done in {time.perf_counter() - t_phase:.1f} s")
    return got, (ids, mask, dna, dmask)


EVO2_PARTS = ("hyena_conv", "hyena_filters", "evo2_tower")


def evo2_profile(torch, card, label, step, tower_attention_first=0):
    """`profile_step` over `step` with the tower and its hyena parts in
    `record_function` ranges; prints the device time of the tower and of
    the rest, each split into hyena convolutions / FFT (with their fp32
    casts and copies), filter materialization, attention, GEMMs and the
    rest (elementwise and copy kernels). A flash kernel, launched from its
    C entry, may link to no host op: with `tower_attention_first` = n, the
    first n flash kernels on the device are the tower's (a prefill runs the
    tower before the decoder). Kernels of a backward run outside the ranges
    (autograd launches them after the forward), so in a training step the
    tower's parts count its forward and none of its backward."""
    from torch.profiler import record_function
    from bioreason_tpu_torch.models import evo2 as evo2_mod
    from bioreason_tpu_torch.models import fusion as fusion_mod
    targets = {"hyena_conv": [(evo2_mod, "depthwise_causal_conv"), (evo2_mod, "fft_causal_conv")],
               "hyena_filters": [(evo2_mod, "materialize_mr_filter"),
                                 (evo2_mod, "materialize_li_filter")],
               "evo2_tower": [(fusion_mod, "hyena_forward")]}
    saved = {(m, a): getattr(m, a) for pairs in targets.values() for m, a in pairs}

    def labelled(name, fn):
        def run(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return run
    try:
        for name, pairs in targets.items():
            for m, a in pairs:
                setattr(m, a, labelled(name, saved[(m, a)]))
        busy, wall, _, kernels = profile_step(torch, card, label, step,
                                              ("flash_fwd", "flash_bwd"), EVO2_PARTS)
    finally:
        for (m, a), fn in saved.items():
            setattr(m, a, fn)
    kinds = ("hyena convolutions / FFT", "hyena filter materialization", "attention", "GEMMs",
             "rest")
    split = {part: dict.fromkeys(kinds, 0.0) for part in ("tower", "outside the tower")}
    gemm = ("gemm", "nvjet", "xmma", "cutlass", "sm90_", "splitk")
    flash = sorted((start, k) for k, (name, _, _, start) in enumerate(kernels)
                   if "flash_" in name)
    tower_flash = {k for _, k in flash[:tower_attention_first]}
    for k, (name, dur, rs, _) in enumerate(kernels):
        low = name.lower()
        part = "tower" if "evo2_tower" in rs or k in tower_flash else "outside the tower"
        if "hyena_conv" in rs:
            kind = "hyena convolutions / FFT"
        elif "hyena_filters" in rs:
            kind = "hyena filter materialization"
        elif "flash_" in low:
            kind = "attention"
        elif any(g in low for g in gemm):
            kind = "GEMMs"
        else:
            kind = "rest"
        split[part][kind] += dur / 1e6
    for part, row in split.items():
        total = sum(row.values())
        log(f"profile [{card}] {label} split, {part}: {total:.3f} device ms "
            f"({100 * total / max(busy, 1e-9):.1f}% of busy {busy:.2f} ms): "
            + ", ".join(f"{k} {v:.3f} ({100 * v / max(busy, 1e-9):.1f}%)"
                        for k, v in row.items()))
    return split


# -- phase 10 ----------------------------------------------------------------

def evo2_kernel_cases(torch, served):
    """flash_fwd and flash_bwd at the Evo2 path's own shapes and masks: the
    tower's attention [16, 2048, 15/15, 128] causal as served (2 kb
    sequences: all valid) and with left pads of mixed lengths, the decoder
    prefill of the served batch (causal, a cache of P +
    64 slots, its left pads), and the finetune step's tower backward
    [4, 2048, 15/15, 128] causal with mixed left pads."""
    g = torch.Generator(device="cuda").manual_seed(51)
    ids, mask, dna, _ = served
    b, p = ids.shape
    cmask = torch.as_tensor(np.pad(mask, ((0, 0), (0, 64))), device="cuda")
    rows = [kernel_case(torch, "evo2_tower_T2048", 16, EVO2_BP, EVO2_BP, 15, 15, 128, True, 0,
                        torch.as_tensor(served[3], device="cuda"), 50),
            kernel_case(torch, "evo2_tower_T2048_leftpad", 16, EVO2_BP, EVO2_BP, 15, 15, 128,
                        True, 0, left_padded(torch, 16, EVO2_BP, 0, 1500, g), 51),
            kernel_case(torch, f"evo2_prefill_P{p}", b, p, p + 64, 16, 8, 128, True, 0,
                        cmask, 52)]
    bwd_rows = [bwd_case(torch, "evo2_tower_T2048_leftpad_bwd", 4, EVO2_BP, EVO2_BP, 15, 15,
                         128, True, 0, left_padded(torch, 4, EVO2_BP, 0, 1500, g), 53)]
    return rows, bwd_rows


def evo2_train_items():
    """16 KEGG-shaped items of 2 x 2048 bp for the Evo2 SFT phase."""
    from bioreason_tpu_torch.data.kegg import synthetic_kegg_items
    return synthetic_kegg_items(n=16, seq_len=EVO2_BP, seed=1)


def phase_evo2_train(torch, card):
    """Evo2 SFT at full width through the CLI, frozen and finetuned (module
    docstring, phase 10)."""
    import torch.nn.functional as F
    from bioreason_tpu_torch.cli import train_sft
    from bioreason_tpu_torch.data import BioProcessor, ByteTextTokenizer
    from bioreason_tpu_torch.data.char_tokenizer import CharDNATokenizer
    from bioreason_tpu_torch.data.collate import sft_collate
    from bioreason_tpu_torch.data.kegg import format_kegg_for_dna_llm
    from bioreason_tpu_torch.models.fusion import fusion_forward, init_fusion
    t_phase = time.perf_counter()
    n_attn = len(EVO2_ATTN)
    # the decoder keeps remat on (its preset): each of its layers runs its
    # forward twice a step; the frozen tower runs without autograd (no
    # remat), the trained one with remat (its preset): forward twice, and
    # one backward per attention block
    per_step = {"frozen": {"flash_fwd": n_attn + 2 * DECODER_LAYERS,
                           "flash_bwd": DECODER_LAYERS},
                "finetune": {"flash_fwd": 2 * n_attn + 2 * DECODER_LAYERS,
                             "flash_bwd": n_attn + DECODER_LAYERS}}
    items = evo2_train_items()
    build_dir = os.path.join(REPO, "bioreason_tpu_torch", "build")
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="smoke_evo2_", dir=build_dir)
    steps = 3
    out = {}
    try:
        data_dir = os.path.join(tmp, "data")
        os.makedirs(data_dir)
        with open(os.path.join(data_dir, "kegg_2kb.jsonl"), "w", encoding="utf-8") as fh:
            fh.write("\n".join(json.dumps(x) for x in items))
        for mode in ("frozen", "finetune"):
            argv = ["--decoder", "qwen3-0.6b", "--encoder", "evo2-1b", "--max_steps", str(steps),
                    "--seed", "0",
                    "--checkpoint_dir", os.path.join(tmp, mode), "--max_length_dna",
                    str(EVO2_BP), "--truncate_dna_per_side", "0", "--data_dir", data_dir]
            if mode == "finetune":
                argv.append("--dna_model_finetune")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # --- the main path: counts from 0 just before, read just after ---
            reset_counts()
            t0 = time.perf_counter()
            trainer = train_sft.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = counts()
            # -----------------------------------------------------------------
            peak = torch.cuda.max_memory_allocated()
            losses = [m["loss"] for m in trainer.history]
            want = {k: steps * per_step[mode].get(k, 0) for k in got}
            log(f"evo2 train (cli, {mode}) [{card}]: {steps} steps in {secs:.1f} s (model, data "
                f"and checkpoint included), losses {[round(x, 4) for x in losses]}, step ms "
                f"{[round(m['step_time'] * 1e3, 1) for m in trainer.history]}, "
                f"torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB; launches {got}")
            if len(losses) != steps or not all(math.isfinite(x) for x in losses):
                fail(f"train_sft --encoder evo2-1b ({mode}) did not run {steps} finite steps")
            if got != want:
                fail(f"train_sft --encoder evo2-1b ({mode}) launched {got}, expected {want}")
            tower = trainer.model.encoder
            poles = tower.blocks[2].hyena.filter.poles
            if poles.dtype != (torch.bfloat16 if mode == "frozen" else torch.float32):
                fail(f"{mode}: the li poles are stored in {poles.dtype}")
            out[mode] = {"launches": got, "step_ms": [m["step_time"] * 1e3
                                                      for m in trainer.history],
                         "peak_gib": peak / 2**30}
            if mode == "frozen":
                del trainer, tower, poles
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # every leaf of the trained tower moved from its seeded init
    init = init_fusion(trainer.fusion_cfg, seed=0, device="cuda")
    state = trainer.trainable_state()
    enc = list(init.encoder.named_parameters())
    still = [n for n, p in enc if torch.equal(state[f"encoder.{n}"].detach(), p.float())]
    log(f"evo2 train (cli, finetune): {len(enc) - len(still)} of {len(enc)} tower leaves "
        f"moved")
    if still:
        fail(f"Evo2 tower leaves did not move: {still[:4]}")
    del init, enc, state

    # the finetune trainer on one batch: timed steps, memory, profile, cosine
    proc = BioProcessor(ByteTextTokenizer(), CharDNATokenizer())
    batch = sft_collate([format_kegg_for_dna_llm(x) for x in items[:2]], proc,
                        max_length_text=512, max_length_dna=EVO2_BP, bucket=128)
    b, t = np.asarray(batch["input_ids"]).shape
    s_, t_dna = np.asarray(batch["dna_input_ids"]).shape
    n_train = sum(p.numel() for p in trainer.params)
    trainer.train_step(batch)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # --- the main path: counts from 0 just before, read just after ---------
    reset_counts()
    step_ms = []
    for _ in range(steps):
        ts = time.perf_counter()
        trainer.train_step(batch)                # ends in a host sync (loss, norm)
        step_ms.append((time.perf_counter() - ts) * 1e3)
    got = counts()
    # -----------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    log(f"evo2 train (trainer, finetune) [{card}]: B={b} T={t}, tower {s_} x {t_dna} byte "
        f"tokens, {n_train / 1e6:.1f} M trainable parameters (LoRA r32 + projection + the "
        f"tower, fp32 masters), remat on: step ms {[round(x, 1) for x in step_ms]} "
        f"({b * steps / (sum(step_ms) / 1e3):.3f} examples/s); held between steps "
        f"{held / 2**30:.2f} GiB (weights, masters, AdamW moments), "
        f"torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB; launches {got}")
    if got != {k: steps * per_step["finetune"].get(k, 0) for k in got}:
        fail(f"the Evo2 finetune trainer launched {got} in {steps} steps")
    out["trainer"] = {"step_ms": step_ms, "peak_gib": peak / 2**30, "held_gib": held / 2**30,
                      "launches": got}
    evo2_profile(torch, card, "evo2 finetune step", lambda: trainer.train_step(batch))

    # one loss + gradient through the kernels against the plain route
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lk, gk = loss_and_grad(cfg)
    log(f"evo2 train: forward + backward alone (the gradients returned, no optimizer) "
        f"peaks at {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    plain = dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, attention_impl="xla"),
        hyena=dataclasses.replace(cfg.hyena, attention_impl="xla"))
    reset_counts()
    lp, gp = loss_and_grad(plain)
    if any(counts().values()):
        fail(f"the plain route launched kernels: {counts()}")
    cos = float(F.cosine_similarity(gk, gp, dim=0))
    # the tower's parameters come first in the trainable list
    n_tower = sum(p.numel() for n, p in zip(trainer.names, trainer.params)
                  if n.startswith("encoder."))
    cos_tower = float(F.cosine_similarity(gk[:n_tower], gp[:n_tower], dim=0))
    log(f"evo2 train: kernel vs plain route, one loss + gradient (tower trained): loss "
        f"{lk:.6f} vs {lp:.6f} (diff {abs(lk - lp):.3g}), cosine of the {gk.numel()} trainable "
        f"gradients {cos:.6f}, of the tower's {n_tower} {cos_tower:.6f}; norms "
        f"{float(gk.norm()):.4g} vs {float(gp.norm()):.4g}")
    if not (math.isfinite(lk) and math.isfinite(lp)) or min(cos, cos_tower) < 0.99:
        fail(f"kernel and plain routes disagree in Evo2 training (cosine {cos:.4f})")
    del gk, gp, trainer
    torch.cuda.empty_cache()
    log(f"evo2 train: phase done in {time.perf_counter() - t_phase:.1f} s")
    return out


# -- phase 11 ----------------------------------------------------------------

# the published configurations (Qwen3-0.6B config.json; NT-v2-500M's ESM
# config), written as HF directories with weights drawn from a seed
QWEN3_0_6B_HF = {"architectures": ["Qwen3ForCausalLM"], "model_type": "qwen3",
                 "vocab_size": 151936, "hidden_size": 1024, "intermediate_size": 3072,
                 "num_hidden_layers": 28, "num_attention_heads": 16, "num_key_value_heads": 8,
                 "head_dim": 128, "rope_theta": 1000000.0, "rms_norm_eps": 1e-6,
                 "tie_word_embeddings": True, "torch_dtype": "bfloat16"}
NT_V2_500M_HF = {"architectures": ["EsmForMaskedLM"], "model_type": "esm", "vocab_size": 4107,
                 "hidden_size": 1024, "intermediate_size": 4096, "num_hidden_layers": 29,
                 "num_attention_heads": 16, "position_embedding_type": "rotary",
                 "layer_norm_eps": 1e-12, "add_bias_fnn": False, "token_dropout": False,
                 "mask_token_id": 2, "pad_token_id": 1, "max_position_embeddings": 2050}
QWEN_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
              r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
QWEN_BPE_TOKENS = 151643                   # ids 0..151642; the added tokens follow
PRETRAINED_BP = 2048                       # 2 x 2 kb per variant-effect item
# serve --checkpoint against the SFT model in memory with LoRA unmerged: the
# merge folds the fp32 delta into bf16 weights (one rounding of W + delta
# where the unmerged path adds x @ A @ B in bf16), so the two prefills
# differ by bf16 rounding: min cosine and max |diff| / max |logit|
MERGED_COS, MERGED_REL = 0.999, 2e-2


def write_qwen_tokenizer(path):
    """A Qwen2-style byte-level `tokenizer.json` with Qwen's Split regex,
    NFC, 151,643 BPE tokens (the byte alphabet, every pair of it, then
    pairs with a third byte; one merge per token) and the added tokens at
    Qwen3's ids: <|endoftext|> 151643, <|im_start|> 151644, <|im_end|>
    151645, placeholders to 151666, <think> / </think> 151667-151668, so
    the DNA tokens land at 151669-151671 as they do with the real file."""
    from bioreason_tpu_torch.data.bpe import byte_encoder
    alphabet = sorted(byte_encoder().values())
    vocab = {c: i for i, c in enumerate(alphabet)}
    merges = []
    for a in alphabet:
        for b in alphabet:
            vocab[a + b] = len(vocab)
            merges.append([a, b])
    pairs = list(merges)
    for a, b in pairs:
        for c in alphabet:
            if len(vocab) == QWEN_BPE_TOKENS:
                break
            vocab[a + b + c] = len(vocab)
            merges.append([a + b, c])
        if len(vocab) == QWEN_BPE_TOKENS:
            break
    added = (["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
             + [f"<|placeholder_{i}|>" for i in range(21)] + ["<think>", "</think>"])
    added_tokens = [{"id": QWEN_BPE_TOKENS + i, "content": t, "single_word": False,
                     "lstrip": False, "rstrip": False, "normalized": False,
                     "special": t not in ("<think>", "</think>")} for i, t in enumerate(added)]
    spec = {"version": "1.0", "truncation": None, "padding": None, "added_tokens": added_tokens,
            "normalizer": {"type": "NFC"},
            "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
                {"type": "Split", "pattern": {"Regex": QWEN_SPLIT}, "behavior": "Isolated",
                 "invert": False},
                {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False,
                 "use_regex": False}]},
            "post_processor": None,
            "decoder": {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False,
                        "use_regex": False},
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": "", "end_of_word_suffix": "",
                      "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                      "vocab": vocab, "merges": merges}}
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"eos_token": "<|im_end|>", "pad_token": "<|endoftext|>"}, f)


def pretrained_states(torch, seed=0):
    """HF-named weights drawn on the card from `seed`: Qwen3-0.6B in bf16
    (dense N(0, 1/in), embedding N(0, 0.02^2), norm scales 1 + N(0, 0.1^2):
    non-unit), NT-v2-500M in fp32 (the fused gated `intermediate.dense`
    [8192, 1024] without bias, q/k/v/o biases and layer-norm shifts
    N(0, 0.02^2): non-zero, scales non-unit)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(shape, std, dtype, mean=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std + mean).to(dtype)
    q, n = QWEN3_0_6B_HF, NT_V2_500M_HF
    bf, hd = torch.bfloat16, q["head_dim"]
    h, hq, hkv = q["hidden_size"], q["num_attention_heads"] * hd, q["num_key_value_heads"] * hd
    qwen = {"model.embed_tokens.weight": rand((q["vocab_size"], h), 0.02, bf),
            "model.norm.weight": rand((h,), 0.1, bf, 1.0)}
    for i in range(q["num_hidden_layers"]):
        p = f"model.layers.{i}."
        for name, (o, k) in (("self_attn.q_proj", (hq, h)), ("self_attn.k_proj", (hkv, h)),
                             ("self_attn.v_proj", (hkv, h)), ("self_attn.o_proj", (h, hq)),
                             ("mlp.gate_proj", (q["intermediate_size"], h)),
                             ("mlp.up_proj", (q["intermediate_size"], h)),
                             ("mlp.down_proj", (h, q["intermediate_size"]))):
            qwen[p + name + ".weight"] = rand((o, k), k ** -0.5, bf)
        for name, d in (("self_attn.q_norm", hd), ("self_attn.k_norm", hd),
                        ("input_layernorm", h), ("post_attention_layernorm", h)):
            qwen[p + name + ".weight"] = rand((d,), 0.1, bf, 1.0)
    f32, d, inter = torch.float32, n["hidden_size"], n["intermediate_size"]
    nt = {"esm.embeddings.word_embeddings.weight": rand((n["vocab_size"], d), 0.02, f32),
          "esm.encoder.emb_layer_norm_after.weight": rand((d,), 0.1, f32, 1.0),
          "esm.encoder.emb_layer_norm_after.bias": rand((d,), 0.02, f32)}
    for i in range(n["num_hidden_layers"]):
        p = f"esm.encoder.layer.{i}."
        for name in ("attention.self.query", "attention.self.key", "attention.self.value",
                     "attention.output.dense"):
            nt[p + name + ".weight"] = rand((d, d), d ** -0.5, f32)
            nt[p + name + ".bias"] = rand((d,), 0.02, f32)
        for name in ("attention.LayerNorm", "LayerNorm"):
            nt[p + name + ".weight"] = rand((d,), 0.1, f32, 1.0)
            nt[p + name + ".bias"] = rand((d,), 0.02, f32)
        nt[p + "intermediate.dense.weight"] = rand((2 * inter, d), d ** -0.5, f32)
        nt[p + "output.dense.weight"] = rand((d, inter), inter ** -0.5, f32)
        ehd = d // n["num_attention_heads"]
        nt[p + "attention.self.rotary_embeddings.inv_freq"] = 1.0 / (
            10000.0 ** (torch.arange(0, ehd, 2, device="cuda", dtype=f32) / ehd))
    return qwen, nt


def variant_items(n, bp, seed=0):
    """Coding variant-effect records as data/variant_effect.py reads them."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        ref = "".join(rng.choice(list("ACGT"), bp))
        pos = int(rng.integers(0, bp))
        alt = "ACGT"[("ACGT".index(ref[pos]) + 1 + int(rng.integers(0, 3))) % 4]
        out.append({"question": f"Variant at position {pos} of this coding sequence: is it "
                                f"benign or pathogenic?",
                    "answer": "Pathogenic; ClinVar" if k % 2 else "Benign",
                    "reference_sequence": ref,
                    "variant_sequence": ref[:pos] + alt + ref[pos + 1:]})
    return out


def phase_pretrained(torch, card, max_new):
    """The port on HF-layout checkpoints at full width (module docstring,
    phase 11)."""
    import copy

    from bioreason_tpu_torch.cli import reason, train_sft
    from bioreason_tpu_torch.data import BioProcessor
    from bioreason_tpu_torch.data.nt_tokenizer import KmerTokenizer
    from bioreason_tpu_torch.generate.engine import GenerationEngine
    from bioreason_tpu_torch.serve import build_server, prepare_batch
    from bioreason_tpu_torch.train import grpo as grpo_mod
    from bioreason_tpu_torch.train.lora import merge_lora
    from bioreason_tpu_torch.utils import pretrained as P
    from bioreason_tpu_torch.utils.hf_import import export_decoder_to_hf, export_encoder_to_hf
    from bioreason_tpu_torch.utils.ref_ckpt import export_reference_sft
    from bioreason_tpu_torch.utils.safetensors_io import save_file
    t_phase = time.perf_counter()
    build_dir = os.path.join(REPO, "bioreason_tpu_torch", "build")
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="smoke_pretrained_", dir=build_dir)
    out = {}
    try:
        qwen_dir, nt_dir = os.path.join(tmp, "qwen3-0.6b"), os.path.join(tmp, "nt-v2-500m")
        os.makedirs(qwen_dir)
        os.makedirs(nt_dir)
        # (1) the two directories, written by the port's own writer
        t0 = time.perf_counter()
        write_qwen_tokenizer(qwen_dir)
        t_tok = time.perf_counter() - t0
        qwen, nt = pretrained_states(torch)
        written = {}
        for path, state, cfg in ((qwen_dir, qwen, QWEN3_0_6B_HF), (nt_dir, nt, NT_V2_500M_HF)):
            with open(os.path.join(path, "config.json"), "w") as f:
                json.dump(cfg, f)
            t0 = time.perf_counter()
            save_file(state, os.path.join(path, "model.safetensors"), {"format": "pt"})
            written[path] = (os.path.getsize(os.path.join(path, "model.safetensors")),
                             time.perf_counter() - t0)
        with open(os.path.join(nt_dir, "vocab.txt"), "w") as f:
            f.write("\n".join(KmerTokenizer().vocab))
        log(f"pretrained: wrote tokenizer.json (151,643 BPE tokens + 26 added) in {t_tok:.2f} s; "
            f"Qwen3-0.6B bf16 {written[qwen_dir][0] / 1e9:.3f} GB in {written[qwen_dir][1]:.2f} s, "
            f"NT-v2-500M fp32 {written[nt_dir][0] / 1e9:.3f} GB in {written[nt_dir][1]:.2f} s")

        # load times and rates, then (2) the whole fusion, held leaf by leaf
        # to what was written after the cast to each parameter's dtype
        for name, loader, path in (("Qwen3-0.6B", P.load_pretrained_decoder, qwen_dir),
                                   ("NT-v2-500M", P.load_pretrained_encoder, nt_dir)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, module = loader(path, "cuda")
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            size = written[path][0]
            log(f"pretrained [{card}]: load_pretrained_{'decoder' if 'Qwen' in name else 'encoder'}"
                f"({name}) onto the card in {dt:.2f} s, {size / dt / 1e9:.2f} GB/s of "
                f"safetensors (the file just written: page cache warm)")
            out[f"load_{name}_GBps"] = size / dt / 1e9
            del module
        t0 = time.perf_counter()
        cfg, model, tok, dna_tok = P.load_pretrained_fusion(qwen_dir, nt_dir, device="cuda")
        torch.cuda.synchronize()
        log(f"pretrained: load_pretrained_fusion in {time.perf_counter() - t0:.2f} s "
            f"(tokenizer included); DNA ids {tok.dna_start_id}, {tok.dna_pad_id}, "
            f"{tok.dna_end_id}; vocab {cfg.decoder.vocab_size}; encoder swiglu "
            f"{cfg.encoder.use_swiglu}, mlp_bias {cfg.encoder.mlp_bias}")
        if (tok.dna_start_id, tok.dna_pad_id, tok.dna_end_id) != (151669, 151670, 151671):
            fail(f"the DNA tokens landed at {tok.dna_start_id}..{tok.dna_end_id}")
        d, e, qc, nc = cfg.decoder, cfg.encoder, QWEN3_0_6B_HF, NT_V2_500M_HF
        if ((d.num_layers, d.hidden_size, d.num_heads, d.num_kv_heads, d.head_dim,
             d.vocab_size, d.rope_theta) != tuple(qc[k] for k in (
                 "num_hidden_layers", "hidden_size", "num_attention_heads",
                 "num_key_value_heads", "head_dim", "vocab_size", "rope_theta"))
                or (e.num_layers, e.hidden_size, e.num_heads, e.intermediate_size,
                    e.vocab_size) != tuple(nc[k] for k in (
                        "num_hidden_layers", "hidden_size", "num_attention_heads",
                        "intermediate_size", "vocab_size"))
                or not e.use_swiglu or e.mlp_bias or not e.attn_bias):
            fail(f"configs from config.json: {cfg}")
        checked, wrong = 0, []
        for exported, state in ((export_decoder_to_hf(model.decoder), qwen),
                                (export_encoder_to_hf(model.encoder), nt)):
            for k, v in exported.items():
                checked += 1
                if k not in state or not torch.equal(v, state[k].to(v.dtype)):
                    wrong.append(k)
        ignored = sorted(set(nt) - set(export_encoder_to_hf(model.encoder)))
        log(f"pretrained: {checked} leaves equal to the written tensors after the cast to "
            f"their parameter's dtype (bf16 weights, fp32 norms) bit for bit: "
            f"{checked - len(wrong)}; not imported: {len(ignored)} rotary buffers")
        if wrong or any("rotary" not in k for k in ignored):
            fail(f"imported leaves differ from the written ones: {wrong[:6]} {ignored[:6]}")
        # the BPE on the served prompts (host time)
        items = variant_items(8, PRETRAINED_BP, seed=1)
        t0 = time.perf_counter()
        prepare_batch(BioProcessor(tok, dna_tok), cfg, items)
        tok_ms = (time.perf_counter() - t0) * 1e3
        log(f"pretrained: prepare_batch of 8 requests (chat render, BPE on 151,643 tokens, "
            f"6-mers of 2 x {PRETRAINED_BP} bp) {tok_ms:.1f} ms of host time (cold BPE cache)")
        out["tokenize_8_ms"] = tok_ms
        del model, qwen, nt
        torch.cuda.empty_cache()

        # (3) train_sft from the two directories on the coding variant-effect
        # task: 4 steps, eval every 2 with top-1 kept, the generative test
        data_dir = os.path.join(tmp, "data")
        os.makedirs(data_dir)
        with open(os.path.join(data_dir, "variant_effect_coding.jsonl"), "w") as f:
            f.write("\n".join(json.dumps(x) for x in variant_items(16, PRETRAINED_BP)))
        from bioreason_tpu_torch.cli.common import load_items
        train_items, val_items, test_items = load_items("variant_effect_coding", data_dir, 0, 0,
                                                        0)
        steps, bs = 4, 2
        evals = steps // 2
        val_batches = -(-len(val_items) // bs)
        test_calls = -(-len(test_items) // bs)
        # a training step: the frozen encoder once (no autograd), each
        # decoder layer's forward twice (remat) and its backward once; an
        # eval batch: encoder and decoder once; a test batch: one prefill
        # (encoder + decoder; decode steps are plain)
        per_step = {"flash_fwd": ENCODER_LAYERS + 2 * DECODER_LAYERS, "flash_bwd": DECODER_LAYERS}
        per_eval = ENCODER_LAYERS + DECODER_LAYERS
        want = {"flash_fwd": steps * per_step["flash_fwd"]
                + (evals * val_batches + test_calls) * per_eval,
                "flash_bwd": steps * per_step["flash_bwd"]}
        ck = os.path.join(tmp, "ck")
        argv = ["--hf_llm_dir", qwen_dir, "--hf_dna_dir", nt_dir, "--dataset_type",
                "variant_effect_coding", "--data_dir", data_dir, "--max_steps", str(steps),
                "--batch_size", str(bs), "--eval_every", "2", "--keep_top_k", "1",
                "--test_generative", "--max_new_tokens", "16", "--truncate_dna_per_side", "0",
                "--seed", "0", "--checkpoint_dir", ck]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # --- the main path: counts from 0 just before, read just after -------
        reset_counts()
        t0 = time.perf_counter()
        trainer = train_sft.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = counts()
        # ---------------------------------------------------------------------
        peak = torch.cuda.max_memory_allocated()
        hist = trainer.history
        res = trainer.test_result
        log(f"pretrained train_sft [{card}]: {steps} steps (variant_effect_coding, "
            f"{len(train_items)}/{len(val_items)}/{len(test_items)} items, B={bs}, vocab "
            f"151,936) in {secs:.1f} s (load, data, eval, test and checkpoints included): losses "
            f"{[round(m['loss'], 4) for m in hist]}, val_loss "
            f"{[round(m['val_loss'], 4) for m in hist if 'val_loss' in m]}, step ms "
            f"{[round(m['step_time'] * 1e3, 1) for m in hist]}, "
            f"torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB; test {res.total} items "
            f"{res.summary()}; launches {got} (expected {want}: {per_step} a step, "
            f"{per_eval} per eval batch x {evals * val_batches} and per test call x "
            f"{test_calls})")
        if len(hist) != steps or not all(math.isfinite(m["loss"]) for m in hist):
            fail(f"train_sft from HF dirs did not run {steps} finite steps")
        if got != {k: want.get(k, 0) for k in got}:
            fail(f"train_sft from HF dirs launched {got}, expected {want}")
        if res is None or res.total != len(test_items):
            fail("the generative test did not score the test split")
        best = os.listdir(os.path.join(ck, "best"))
        if sorted(best)[-1] != "index.json" or len(best) != 2:
            fail(f"--keep_top_k 1 kept {best}")
        b_leaves = [p for n, p in trainer.trainable_state().items() if n.endswith("lora_b")]
        moved = sum(bool(p.detach().any()) for p in b_leaves)
        log(f"pretrained train_sft: {moved} of {len(b_leaves)} LoRA B leaves moved; "
            f"per-layer norm scales stored in "
            f"{trainer.model.decoder.layers[0].ln1.scale.dtype}, final norm in "
            f"{trainer.model.decoder.final_norm.scale.dtype}")
        if moved != len(b_leaves):
            fail("LoRA B leaves did not move")
        if trainer.model.decoder.layers[0].ln1.scale.dtype != torch.bfloat16:
            fail("frozen per-layer norm scales are not stored in bf16")
        out["sft"] = {"step_ms": [m["step_time"] * 1e3 for m in hist], "peak_gib": peak / 2**30,
                      "launches": got}
        sft_model = trainer.model

        # (4) reason from a reference-format .pt exported from that model
        ref = os.path.join(tmp, "reference_sft.pt")
        t0 = time.perf_counter()
        torch.save(export_reference_sft(merge_lora(copy.deepcopy(sft_model))), ref)
        log(f"pretrained: export_reference_sft of the merged SFT model, "
            f"{os.path.getsize(ref) / 1e9:.3f} GB in {time.perf_counter() - t0:.1f} s")
        del trainer
        torch.cuda.empty_cache()
        step_s = []
        real_step = grpo_mod.GRPOTrainer.step

        def timed_step(self, *a, **kw):
            t = time.perf_counter()
            m = real_step(self, *a, **kw)
            step_s.append(time.perf_counter() - t)
            return m
        g, n_gen, new = 4, 8, 32
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        grpo_mod.GRPOTrainer.step = timed_step
        try:
            t0 = time.perf_counter()
            cli = reason.main(["--hf_llm_dir", qwen_dir, "--hf_dna_dir", nt_dir,
                               "--sft_checkpoint", ref, "--dataset_type",
                               "variant_effect_coding", "--data_dir", data_dir,
                               "--truncate_dna_per_side", "0", "--num_generations", str(g),
                               "--batch_size", str(n_gen), "--max_completion_length", str(new),
                               "--max_steps", "2", "--seed", "0", "--checkpoint_dir",
                               os.path.join(tmp, "grpo"), "--log_dir",
                               os.path.join(tmp, "grpo_logs")])
            secs = time.perf_counter() - t0
        finally:
            grpo_mod.GRPOTrainer.step = real_step
        peak = torch.cuda.max_memory_allocated()
        hist = cli.metrics_history
        stats = cli.engine.last_stats
        log(f"pretrained reason [{card}]: 2 GRPO steps from the reference .pt at the 151,936 "
            f"vocabulary ({n_gen // g} prompts x G={g}, P={stats['prompt_len']}, {new} new "
            f"tokens) in {secs:.1f} s (load included): step s "
            f"{[round(x, 2) for x in step_s]}, {n_gen / min(step_s):.3f} completions/s "
            f"(fastest step), torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB; losses "
            f"{[m['loss'] for m in hist]}, kl {[m['kl'] for m in hist]}, rewards "
            f"{[m['reward'] for m in hist]}; launches {counts()}")
        if len(hist) != 2 or any(not math.isfinite(m[k]) for m in hist
                                 for k in ("loss", "kl", "reward")):
            fail(f"reason from a reference checkpoint: {hist}")
        # a GRPO step: the rollout's encoder and prefill, the reference
        # pass's encoder and decoder, the update's encoder and its decoder
        # twice (remat), one backward per decoder layer (as phase 8)
        want = {"flash_fwd": 2 * (3 * ENCODER_LAYERS + 4 * DECODER_LAYERS),
                "flash_bwd": 2 * DECODER_LAYERS}
        if counts() != {k: want.get(k, 0) for k in counts()}:
            fail(f"reason launched {counts()} in 2 steps, expected {want}")
        out["grpo"] = {"step_s": step_s, "completions_per_s": n_gen / min(step_s),
                       "peak_gib": peak / 2**30, "launches": counts()}
        del cli
        torch.cuda.empty_cache()

        # (5) serve --checkpoint <sft_final>: 8 concurrent greedy requests twice
        t0 = time.perf_counter()
        server = build_server(checkpoint=os.path.join(ck, "sft_final"), max_length_dna=2048,
                              max_batch=8, batch_window_ms=500.0, max_new_tokens=max_new,
                              greedy_default=True)
        log(f"pretrained serve: the sft_final's base rebuilt and its LoRA merged in "
            f"{time.perf_counter() - t0:.1f} s")
        reqs = variant_items(8, PRETRAINED_BP, seed=2)
        batch = [torch.as_tensor(a, device="cuda")
                 for a in prepare_batch(server.processor, server.cfg, reqs[:1])]
        served = server.engine.prefill(server.model, *batch, max_new)[0]
        unmerged = GenerationEngine(server.cfg, tok.eos_token_id).prefill(sft_model, *batch,
                                                                          max_new)[0]
        cos = float(torch.nn.functional.cosine_similarity(served, unmerged, dim=-1).min())
        rel = float((served - unmerged).abs().max() / unmerged.abs().max())
        log(f"pretrained serve: merged (served) vs unmerged (the SFT model) last-column prefill "
            f"logits [1, {served.shape[-1]}]: cosine {cos:.6f}, max |diff| / max |logit| "
            f"{rel:.3g} (tolerance: cosine >= {MERGED_COS}, relative <= {MERGED_REL}: bf16 "
            f"merge rounding)")
        if not bool(torch.isfinite(served).all()) or cos < MERGED_COS or rel > MERGED_REL:
            fail("served merged model and the SFT model disagree")
        del sft_model, unmerged
        torch.cuda.empty_cache()
        server.start()
        calls_out, restore = record_engine_calls(server)
        torch.cuda.reset_peak_memory_stats()
        # --- the main path: counts from 0 just before, read just after -------
        reset_counts()
        calls0 = server.engine_calls
        first = burst(server, reqs, max_new)
        n_first = len(calls_out)
        second = burst(server, reqs, max_new)
        got = counts()
        calls = server.engine_calls - calls0
        # ---------------------------------------------------------------------
        peak = torch.cuda.max_memory_allocated()
        server.stop()
        restore()
        if (len(completion_rows(calls_out[:n_first])) != 8 or first != second
                or completion_rows(calls_out[:n_first]) != completion_rows(calls_out[n_first:])):
            fail("serve --checkpoint: greedy repeats differ")
        per_call = ENCODER_LAYERS + DECODER_LAYERS
        st = calls_out[-1][1]
        tps = st["decode_tokens"] / st["decode_s"] if st["decode_s"] else 0.0
        log(f"pretrained serve [{card}]: 16 requests in {calls} engine calls, flash_fwd "
            f"{got['flash_fwd']} = {got['flash_fwd'] / max(calls, 1):g} per call (expected "
            f"{per_call}); B={st['batch']} P={st['prompt_len']}: prefill "
            f"{st['prefill_s'] * 1e3:.1f} ms, decode {tps:.1f} tokens/s; "
            f"torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB; e.g. "
            f"{first[0]['completion'][:60]!r}")
        if got != {k: (per_call * calls if k == "flash_fwd" else 0) for k in got}:
            fail(f"serve --checkpoint launched {got} in {calls} engine calls")
        out["serve"] = {"launches": got["flash_fwd"], "calls": calls,
                        "prefill_ms": st["prefill_s"] * 1e3, "decode_tps": tps,
                        "peak_gib": peak / 2**30}
        del server
        torch.cuda.empty_cache()

        # (6) train_sft --hf_llm_dir with --evo2_dir over the committed
        # 25-block fixture (head_dim 8: its attention takes the plain route)
        evo2_dir = os.path.join(tmp, "evo2")
        os.makedirs(evo2_dir)
        shutil.copy(os.path.join(REPO, "tests", "assets", "evo2_1b_depth_tiny.pt"), evo2_dir)
        reset_counts()
        t0 = time.perf_counter()
        trainer = train_sft.main(["--hf_llm_dir", qwen_dir, "--evo2_dir", evo2_dir,
                                  "--dna_attention", "xla", "--max_steps", "2", "--seed", "0",
                                  "--max_length_dna", "256", "--n_synthetic", "16",
                                  "--checkpoint_dir", os.path.join(tmp, "evo2_ck")])
        got = counts()
        hist = trainer.history
        want = {"flash_fwd": 2 * 2 * DECODER_LAYERS, "flash_bwd": 2 * DECODER_LAYERS}
        log(f"pretrained train_sft --evo2_dir [{card}]: 2 steps in "
            f"{time.perf_counter() - t0:.1f} s, losses {[round(m['loss'], 4) for m in hist]}, "
            f"launches {got} (expected {want})")
        if len(hist) != 2 or not all(math.isfinite(m["loss"]) for m in hist):
            fail("train_sft --evo2_dir did not run 2 finite steps")
        if got != {k: want.get(k, 0) for k in got}:
            fail(f"train_sft --evo2_dir launched {got}, expected {want}")
        del trainer
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"pretrained: phase done in {time.perf_counter() - t_phase:.1f} s")
    return out


# -- phase 12 -----------------------------------------------------------------

GUIDED = r"<answer>(yes|no)</answer>"
# teacher-forced batcher vs engine logits (bf16, two cache layouts and
# attention routes): per row and step, and at the first token (one prefill
# each, the flash kernel in both)
CONT_STEP_COS, CONT_FIRST_COS = 0.999, 0.9999
CONT_BUDGET_S = 75.0
CONT_NEW, CONT_WINDOW = 24, 16
# (a)'s requests: 2 x capacity, not the bench's 3 x, so that the phase keeps
# its budget on a slower host (the queue stays: 128 requests over 64 slots)
CONT_REQUESTS = 128


def teacher_forced(torch, engine, model, batch, streams):
    """The engine's logits [B, n, V] on given token streams [B, n]: its
    prefill's last column, then one decode step of engine.generate's loop
    per token, the token forced."""
    from bioreason_tpu_torch.models.qwen3 import decoder_forward
    ids, mask, dna, dmask = batch
    b, p = ids.shape
    n = streams.shape[1]
    lens = mask.sum(-1)
    ones = torch.ones((b, 1), dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        first, cache, cmask = engine.prefill(model, ids, mask, dna, dmask, n)
        out = [first]
        for j in range(1, n):
            cmask[:, p + j - 1] = 1
            lg, cache = decoder_forward(model.decoder, engine.cfg.decoder,
                                        input_ids=streams[:, j - 1:j], attention_mask=ones,
                                        positions=(lens + j - 1)[:, None], cache=cache,
                                        cache_index=p + j - 1, cache_mask=cmask)
            out.append(lg[:, 0])
    return torch.stack(out, 1)


def batcher_run(torch, cb, reqs, preempt=None):
    """Phase 12(b)'s schedule on `cb`: the first 4 requests admitted, one
    window, the other 4 (and, with `preempt`, that request evicted after
    the first window and re-admitted with them), windows until all finish.
    Returns {rid: {token index: fp32 logits [V]}} of every decode step,
    recorded by patching `layers.lm_logits` during each window."""
    from bioreason_tpu_torch.models import layers as L
    orig, captured, logits = L.lm_logits, [], {}

    def recording(dec, h):
        out = orig(dec, h)
        captured.append(out)
        return out

    def window():
        pend = {id(r) for rec in cb._pending_first for r, _ in rec.req_src}
        snap = [(s, r, len(r.tokens) + (id(r) in pend)) for s, r in enumerate(cb._by_slot)
                if r is not None and cb.active[s]]
        captured.clear()
        L.lm_logits = recording
        try:
            cb.step_window(CONT_WINDOW)
        finally:
            L.lm_logits = orig
        for s, r, base in snap:
            for j, lg in enumerate(captured):
                if base + j < r.max_new_tokens:          # the overrun is discarded
                    logits.setdefault(r.rid, {})[base + j] = lg[s].flatten()
    cb.admit_many(list(reqs[:4]))
    window()
    late = list(reqs[4:])
    if preempt is not None:
        late.append(cb.preempt(reqs[preempt].slot))
    cb.admit_many(late)
    while cb.active.any() or cb._pending_first:
        window()
    return logits


def sync_warnings(torch, fn):
    """The host syncs torch's sync debug mode ("warn") reports while fn()
    runs, as their messages."""
    import warnings
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [str(w.message) for w in got if "called a synchronizing" in str(w.message)]


def count_syncs(torch, cb, k):
    """The host syncs that one k-step decode window's dispatch makes
    (`_multi_step` alone), and those of a control that syncs once."""
    real, seen = cb._multi_step, []

    def counted(*a, **kw):
        out = []
        seen.extend(sync_warnings(torch, lambda: out.append(real(*a, **kw))))
        return out[0]
    cb._multi_step = counted
    try:
        cb.step_window(k)
    finally:
        del cb._multi_step
    return seen, sync_warnings(torch, lambda: torch.ones(1, device="cuda").item())


def phase_continuous(torch, card):
    """Continuous serving at full width (module docstring, phase 12)."""
    import torch.nn.functional as F
    from bioreason_tpu_torch.config import SamplingConfig
    from bioreason_tpu_torch.data.kegg import synthetic_kegg_items
    from bioreason_tpu_torch.data.text_tokenizer import load_hf_tokenizer
    from bioreason_tpu_torch.generate import continuous as C
    from bioreason_tpu_torch.generate.engine import GenerationEngine
    from bioreason_tpu_torch.generate.guided import guided_spec_for
    from bioreason_tpu_torch.models.fusion import init_fusion
    from bioreason_tpu_torch.serve import (InferenceServer, build_config, make_http_server,
                                           prepare_request)
    from bioreason_tpu_torch.tools import bench_serve
    t_phase = time.perf_counter()
    per_chunk = ENCODER_LAYERS + DECODER_LAYERS
    out = {}

    # (a) the serving bench, at its defaults but CONT_REQUESTS: the main
    # path, counts from 0 just before and read just after (its warmup's one
    # prefill included)
    reset_counts()
    res = bench_serve.main(["--probe", "--requests", str(CONT_REQUESTS), "--frozen", "bfloat16"])
    got = counts()
    torch.cuda.empty_cache()
    log(f"continuous bench [{card}]: {res['value']:.1f} decoded tokens/s ({res['decoded_tokens']} "
        f"tokens, {res['requests']} requests over {res['capacity']} slots in "
        f"{res['seconds']:.2f} s; host: admit {res['admit_s']:.2f} s, decode "
        f"{res['decode_s']:.2f} s); {res['windows']} windows of {res['window']}, mean "
        f"occupancy {res['mean_occupancy']:.3f}; {res['prefill_calls']} prefill calls, "
        f"flash_fwd {res['flash_fwd_launches']} = {res['flash_fwd_per_prefill']:g} per prefill "
        f"chunk; pools {res['pool_gib']:.3f} GiB, torch.cuda.max_memory_allocated "
        f"{res['peak_gib']:.2f} GiB; launches with the warmup {got}")
    if res["flash_fwd_launches"] != per_chunk * res["prefill_calls"]:
        fail(f"the bench's {res['prefill_calls']} prefill chunks launched flash_fwd "
             f"{res['flash_fwd_launches']} times, expected {per_chunk} each and none in a "
             f"decode window")
    if got != {k: (per_chunk * (res["prefill_calls"] + 1) if k == "flash_fwd" else 0)
               for k in got}:
        fail(f"the bench launched {got}: expected {per_chunk} flash_fwd per prefill chunk "
             f"(and its warmup's one) and nothing else")
    out["bench"] = {**res, "launches": got["flash_fwd"]}

    # (b) the batcher against the engine at full width: phase 4's requests
    cfg, processor = build_config("qwen3-0.6b", "nt-500m", max_length_dna=2048)
    model = init_fusion(cfg, seed=0, device="cuda").requires_grad_(False)
    items, padded = served_inputs()
    arrays = [prepare_request(processor, cfg, it) for it in items]

    def batcher(**kw):
        return C.ContinuousBatcher(model, cfg, eos_token_id=-1, capacity=8, max_len=1024,
                                   max_new=CONT_NEW, prompt_bucket=128, **kw)

    def requests(greedy=True):
        return [C.Request(i, *a, max_new_tokens=CONT_NEW, greedy=greedy)
                for i, a in enumerate(arrays)]
    batch = [torch.as_tensor(a, device="cuda") for a in padded]
    engine = GenerationEngine(cfg, eos_token_id=-1)
    cb = batcher()
    first_b = cb._prefill(*batch)[1]           # the admission prefill, all 8 in one chunk
    t0 = time.perf_counter()
    runs, logits = [], []
    for preempt in (None, None, 1):
        reqs = requests()
        logits.append(batcher_run(torch, batcher(), reqs, preempt))
        runs.append([list(r.tokens) for r in reqs])
    t_runs = time.perf_counter() - t0
    if runs[1] != runs[0]:
        fail("greedy repeats of the batcher differ")
    if any(len(toks) != CONT_NEW for run in runs for toks in run):
        fail(f"a request did not get its {CONT_NEW} tokens")
    # teacher-forced on each run's own streams (run 3's preempted request
    # follows its own after the re-admission)
    cos_steps, refs = [], []
    for run, lg in zip(runs[1:], logits[1:]):
        refs.append(teacher_forced(torch, engine, model, batch, torch.tensor(run, device="cuda")))
        for rid, steps in lg.items():
            for j, row in steps.items():
                cos_steps.append(float(F.cosine_similarity(row, refs[-1][rid, j], dim=0)))
    cos_first = F.cosine_similarity(first_b, refs[0][:, 0], dim=-1)
    n_steps = len(cos_steps)
    ids, mask = engine.generate(model, *batch, greedy=True, max_new_tokens=CONT_NEW)
    agree = [next((j for j, (a, b) in enumerate(zip(row, ref_row)) if a != b), CONT_NEW)
             for row, ref_row in zip(runs[0], ids.tolist())]
    cont_agree = next((j for j, (a, b) in enumerate(zip(runs[2][1], runs[0][1])) if a != b),
                      CONT_NEW)
    log(f"continuous vs engine [{card}]: 8 requests (P = {batch[0].shape[1]} in the engine's "
        f"batch, slot_len 1024, window {CONT_WINDOW}), admitted 4 + 4; 3 batcher runs in "
        f"{t_runs:.2f} s; teacher-forced logits cosine min {min(cos_steps):.6f} over "
        f"{n_steps} (row, step) pairs (>= {CONT_STEP_COS}), first token min "
        f"{float(cos_first.min()):.6f} (>= {CONT_FIRST_COS}); greedy repeats identical; "
        f"free-running greedy tokens equal to the engine's for the first {agree} of "
        f"{CONT_NEW} (not gated: bf16 near-ties at random weights); the request preempted "
        f"after one window and re-admitted matches its uninterrupted tokens for "
        f"{cont_agree} of {CONT_NEW}")
    # every decode step of both runs, but the preempted request's token 17:
    # its re-admission's prefill draws it
    if n_steps != 2 * 8 * (CONT_NEW - 1) - 1 or min(cos_steps) < CONT_STEP_COS:
        fail(f"batcher vs engine logits: {n_steps} steps, min cosine {min(cos_steps):.6f}")
    if float(cos_first.min()) < CONT_FIRST_COS:
        fail(f"batcher vs engine first-token logits: cosine {float(cos_first.min()):.6f}")
    # no host sync inside a window: 4 sampled rows, their second window
    cb = batcher(sampling=SamplingConfig(temperature=0.6, top_p=0.95, top_k=20))
    cb.admit_many(requests(greedy=False)[:4])
    cb.step_window(CONT_WINDOW)
    reset_counts()
    syncs, control = count_syncs(torch, cb, CONT_WINDOW)
    window_launches = counts()
    log(f"continuous: one sampled window of {CONT_WINDOW} steps: {len(syncs)} host syncs "
        f"{syncs[:3]} (a control's .item(): {len(control)}); launches in one window "
        f"{window_launches}")
    if syncs or not control or any(window_launches.values()):
        fail("a decode window synced with the host (or the check saw no sync in its "
             "control), or launched an attention kernel")
    out["engine"] = {"cos_min": min(cos_steps), "first_cos_min": float(cos_first.min()),
                     "greedy_agree": agree, "preempt_agree": cont_agree}
    del cb
    torch.cuda.empty_cache()

    # (c) tiers and guided decoding over HTTP, then the BPE tokenizer
    prefills, orig_prefill = [], C.ContinuousBatcher._prefill

    def recording_prefill(self, ids, mask, dna, dmask):
        prefills.append((self.max_len, mask.clone()))
        return orig_prefill(self, ids, mask, dna, dmask)
    server = InferenceServer(model, cfg, processor, max_new_tokens=32, continuous=True,
                             tiers="8x512,8x1024", decode_window=8, guided_regex=GUIDED)
    C.ContinuousBatcher._prefill = recording_prefill
    server.start()
    httpd = make_http_server(server, port=0, host="127.0.0.1")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    http_items = [{**it, "question": it["question"] + " Explain briefly." * i}
                  for bp, seed in ((2048, 3), (600, 4))
                  for i, it in enumerate(synthetic_kegg_items(n=6, seq_len=bp, seed=seed))]
    answers = [None] * len(http_items)

    def post(i):
        it = http_items[i]
        body = json.dumps({k: it[k] for k in ("question", "reference_sequence",
                                              "variant_sequence")}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            answers[i] = (r.status, json.loads(r.read()))
    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(http_items))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        C.ContinuousBatcher._prefill = orig_prefill
        httpd.shutdown()
        httpd.server_close()
        server.stop()
    t_http = time.perf_counter() - t0
    if any(a is None or a[0] != 200 for a in answers):
        fail(f"not every request was answered: {answers}")
    bad = [a[1]["completion"] for a in answers if not re.fullmatch(GUIDED, a[1]["completion"])]
    tiers = [(cb.capacity, cb.max_len) for cb in server.batchers]
    log(f"continuous serve [{card}]: tiers {tiers}, requests routed {server.routed}, "
        f"{len(answers)} answered over HTTP in {t_http:.2f} s (sampled, decode window 8), "
        f"{len(answers) - len(bad)} fullmatch {GUIDED!r}; e.g. {answers[0][1]['completion']!r}; "
        f"{len(prefills)} prefill chunks {[tuple(m.shape) for _, m in prefills]}")
    if bad or server.routed != [6, 6]:
        fail(f"tiers or guided decoding: routed {server.routed}, not matching {bad}")
    # the BPE tokenizer of phase 11 under the 151,936-row head
    build_dir = os.path.join(REPO, "bioreason_tpu_torch", "build")
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="smoke_guided_", dir=build_dir)
    try:
        write_qwen_tokenizer(tmp)
        tok = load_hf_tokenizer(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    spec = guided_spec_for(tok, GUIDED, vocab_size=cfg.decoder.vocab_size, device="cuda")
    torch.cuda.synchronize()
    t_spec = time.perf_counter() - t0
    enc = tok([f"Question {i}: is this variant pathogenic?" * (i + 1) for i in range(4)],
              padding_side="left")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids, mask = GenerationEngine(cfg, eos_token_id=tok.eos_token_id).generate(
        model, enc["input_ids"], enc["attention_mask"], sampling=SamplingConfig(
            temperature=0.6, top_p=0.95, top_k=20), max_new_tokens=32, generator=gen,
        guided=spec)
    texts = tok.batch_decode([r[m.astype(bool)] for r, m in zip(ids, mask)])
    dead_tail = bool((spec.next_state[:, tok.vocab_size:] == spec.dead).all())
    log(f"continuous guided BPE: the spec [{spec.next_state.shape[0]}, "
        f"{spec.next_state.shape[1]}] over {tok.vocab_size} tokenizer ids built in "
        f"{t_spec:.3f} s of host time, the columns past them dead: {dead_tail}; 4 sampled "
        f"engine requests: {texts}")
    if not dead_tail or not all(re.fullmatch(GUIDED, t) for t in texts):
        fail(f"guided decoding over the BPE tokenizer: {texts}")
    out["guided"] = {"spec_s": t_spec, "routed": server.routed, "http_s": t_http}
    del server, spec

    # (d) flash_fwd at this path's shapes
    long_chunks = [m for mlen, m in prefills if mlen == 1024]
    mixed = max(long_chunks, key=lambda m: (m.shape[0], len(set(m.sum(-1).tolist()))))
    ones = lambda b, t: torch.ones((b, t), dtype=torch.int32, device="cuda")
    rows = [kernel_case(torch, "continuous_prefill_K64_W256", 64, 256, 256, 16, 8, 128, True,
                        0, ones(64, 256), 41),
            kernel_case(torch, "continuous_encoder_K64_T128", 64, 128, 128, 16, 16, 64, False,
                        None, ones(64, 128), 42),
            kernel_case(torch, f"continuous_tier_K{mixed.shape[0]}_W{mixed.shape[1]}_leftpad",
                        mixed.shape[0], mixed.shape[1], mixed.shape[1], 16, 8, 128, True, 0,
                        mixed.to(torch.int32), 43)]
    del model
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"continuous: phase done in {out['seconds']:.1f} s (budget {CONT_BUDGET_S:g})")
    if out["seconds"] > CONT_BUDGET_S:
        fail(f"the continuous phase took {out['seconds']:.1f} s, over {CONT_BUDGET_S:g}")
    return out, rows


# -- phase 13 -----------------------------------------------------------------

CLS_B, CLS_L, CLS_CLASSES = 16, 512, 8          # bench_classifier.py's shape
CLS_FT_STEPS = 4                                 # finetune steps on one fixed batch
CLS_BUDGET_S = 60.0


def classifier_batch(b=CLS_B, t=CLS_L, classes=CLS_CLASSES, seed=0):
    """bench_classifier.py's batch: random 6-mer ids, all valid."""
    npr = np.random.default_rng(seed)
    return {"ref_ids": npr.integers(6, 4102, (b, t)).astype(np.int32),
            "alt_ids": npr.integers(6, 4102, (b, t)).astype(np.int32),
            "ref_attention_mask": np.ones((b, t), np.int32),
            "alt_attention_mask": np.ones((b, t), np.int32),
            "labels": npr.integers(0, classes, b).astype(np.int32)}


def phase_classifier(torch, card):
    """The DNA-only classifier at NT-v2-500M width (module docstring, phase
    13)."""
    from bioreason_tpu_torch.cli import train_dna_only
    from bioreason_tpu_torch.config import EncoderConfig, OptimConfig
    from bioreason_tpu_torch.models.classifier import classifier_forward
    from bioreason_tpu_torch.tools import bench_classifier
    from bioreason_tpu_torch.train.checkpoint import load_classifier
    from bioreason_tpu_torch.train.classifier import ClassifierTrainer
    t_phase = time.perf_counter()
    per_step = 2 * ENCODER_LAYERS                    # ref and alt through the encoder
    out = {}

    # (a) frozen: bench_classifier.py's run, the main path (counts from 0
    # just before and read just after: 2 warm-up + 5 x 10 timed + 1 profiled)
    reset_counts()
    res = bench_classifier.main([])
    got = counts()
    steps = 2 + bench_classifier.REPS * bench_classifier.STEPS + 1
    log(f"classifier bench [{card}]: {res['value']:.2f} examples/s (median of "
        f"{[round(r, 2) for r in res['repetitions']]}), {res['ms_per_step']:.2f} ms a step; "
        f"profiled step busy {res['profiled_step_busy_ms']:.2f} of "
        f"{res['profiled_step_wall_ms']:.2f} ms; loss {res['loss']:.4f}; "
        f"torch.cuda.max_memory_allocated {res['peak_gib']:.2f} GiB; launches {got} over "
        f"{steps} steps")
    if got != {k: per_step * steps if k == "flash_fwd" else 0 for k in got}:
        fail(f"the frozen classifier launched {got} in {steps} steps, expected "
             f"{per_step} flash_fwd a step and no flash_bwd")
    if not math.isfinite(res["loss"]):
        fail(f"the frozen classifier's loss is {res['loss']}")
    out["frozen"] = {**res, "launches": got["flash_fwd"], "steps": steps}
    torch.cuda.empty_cache()

    # (b) --finetune_encoder at the bench's shape, remat off as the bench
    # runs it: fp32 masters and AdamW moments for the whole encoder
    cfg = dataclasses.replace(EncoderConfig.nt_v2_500m(), remat=False)
    if (cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.head_dim) != (29, 1024, 16, 64):
        fail(f"the classifier's encoder is not at NT-v2-500M width: {cfg}")
    torch.cuda.reset_peak_memory_stats()
    trainer = ClassifierTrainer(cfg, CLS_CLASSES, optim=OptimConfig(
        learning_rate=1e-3, total_steps=100, warmup_ratio=0.0),
        train_just_classifier=False, device="cuda")
    batch = classifier_batch()
    losses = [trainer.train_step(batch)["loss"]]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(CLS_FT_STEPS - 1):
        losses.append(trainer.train_step(batch)["loss"])
    ms = (time.perf_counter() - t0) * 1e3 / (CLS_FT_STEPS - 1)
    got = counts()
    n_train = sum(p.numel() for p in trainer.params)
    log(f"classifier finetune [{card}]: remat off, {n_train / 1e6:.1f} M trainable parameters; "
        f"{ms:.1f} ms a step ({CLS_B * 1e3 / ms:.2f} examples/s) over {CLS_FT_STEPS - 1} "
        f"timed steps; losses {[round(x, 4) for x in losses]} on one fixed batch; launches "
        f"{got}; torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB")
    n = CLS_FT_STEPS - 1
    if got != {"flash_fwd": per_step * n, "flash_bwd": per_step * n, "local_fwd": 0,
               "local_bwd": 0}:
        fail(f"the finetuned classifier launched {got} in {n} steps, expected {per_step} "
             f"flash_fwd and {per_step} flash_bwd a step")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"the finetuned classifier's loss did not fall on a fixed batch: {losses}")
    # one step with the preset's remat on: each layer's forward runs again
    trainer.cfg = dataclasses.replace(cfg, remat=True)
    reset_counts()
    trainer.train_step(batch)
    got_remat = counts()
    log(f"classifier finetune, one step with remat on: launches {got_remat}")
    if got_remat["flash_fwd"] != 2 * per_step or got_remat["flash_bwd"] != per_step:
        fail(f"with remat on a finetune step launched {got_remat}, expected "
             f"{2 * per_step} flash_fwd and {per_step} flash_bwd")
    out["finetune"] = {"ms": ms, "losses": losses, "launches": got,
                       "remat_launches": got_remat,
                       "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del trainer
    torch.cuda.empty_cache()

    # (c) the kernels at the classifier's shapes: all valid, and the
    # collate's right pads (reads of 60-512 tokens)
    g = torch.Generator(device="cuda").manual_seed(13)
    ones = torch.ones((CLS_B, CLS_L), dtype=torch.int32, device="cuda")
    padded = right_padded(torch, CLS_B, CLS_L, 60, g)
    rows = [kernel_case(torch, "classifier_encoder_B16_T512", CLS_B, CLS_L, CLS_L, 16, 16, 64,
                        False, None, ones, 131),
            kernel_case(torch, "classifier_encoder_B16_T512_rightpad", CLS_B, CLS_L, CLS_L, 16,
                        16, 64, False, None, padded, 132)]
    bwd_rows = [bwd_case(torch, "classifier_finetune_B16_T512", CLS_B, CLS_L, CLS_L, 16, 16, 64,
                         False, 0, ones, 133),
                bwd_case(torch, "classifier_finetune_B16_T512_rightpad", CLS_B, CLS_L, CLS_L,
                         16, 16, 64, False, 0, padded, 134)]

    # (d) the CLI on synthetic items: it trains, tests and writes
    # dna_only_final, which the loader rebuilds to the same logits
    build_dir = os.path.join(REPO, "bioreason_tpu_torch", "build")
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="smoke_cls_", dir=build_dir)
    try:
        reset_counts()
        t0 = time.perf_counter()
        cli = train_dna_only.main(["--max_steps", "3", "--batch_size", "4", "--n_synthetic",
                                   "32", "--max_length_dna", "512", "--checkpoint_dir", tmp,
                                   "--log_dir", os.path.join(tmp, "logs")])
        secs = time.perf_counter() - t0
        got = counts()
        model, labels = load_classifier(os.path.join(tmp, "dna_only_final"), cli.cfg,
                                        encoder="nt-500m", device="cuda")
        small = {k: torch.as_tensor(v, device="cuda")
                 for k, v in classifier_batch(b=4, t=128).items()}
        keys = ("ref_ids", "alt_ids", "ref_attention_mask", "alt_attention_mask")
        with torch.no_grad():
            want = classifier_forward(cli.model, cli.cfg, *(small[k] for k in keys))
            rebuilt = classifier_forward(model, cli.cfg, *(small[k] for k in keys))
        diff = float((rebuilt - want).abs().max())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"classifier CLI: train_dna_only --max_steps 3 on 32 synthetic items "
        f"({len(labels)} classes) in {secs:.1f} s, launches {got}; dna_only_final rebuilt "
        f"by load_classifier: logits max abs diff {diff:.3g}")
    if got["flash_fwd"] % per_step or got["flash_bwd"] or diff > 1e-3:
        fail(f"the classifier CLI: launches {got} (expected a multiple of {per_step} "
             f"flash_fwd, no flash_bwd), rebuilt logits off by {diff}")
    out["cli"] = {"seconds": secs, "launches": got}
    del cli, model
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"classifier: phase done in {out['seconds']:.1f} s (budget {CLS_BUDGET_S:g})")
    if out["seconds"] > CLS_BUDGET_S:
        fail(f"the classifier phase took {out['seconds']:.1f} s, over {CLS_BUDGET_S:g}")
    return out, rows, bwd_rows


# -- phase 14 -----------------------------------------------------------------

INT8_NEW = 16                  # teacher-forced steps per request in (b) and (c)
# (b) the int8 engine against a bf16 engine holding the dequantized weights:
# the same products but the head's, whose per-row scale the int8 path puts
# on the fp32 logits where the bf16 one rounds it into the weights
INT8_EXACT_COS = 0.9999
# (c) against the bf16 weights: the quantization error itself (per-channel
# int8 steps of ~0.8% of a Gaussian row's spread in every dense, the
# embedding and the head; per-token activations too under W8A8), compounded
# over 57 layers of random weights
INT8_COS_FLOOR, W8A8_COS_FLOOR = 0.98, 0.95
INT8_BUDGET_S = 120.0


def dequantized_copy(torch, q8, template):
    """`template` (a bf16 model of the same config) with every weight that
    is int8 in `q8` replaced by its dequantized bf16 value, as `dense`
    computes it."""
    from bioreason_tpu_torch.models import layers as L
    mods = dict(q8.named_modules())
    with torch.no_grad():
        for name, mod in template.named_modules():
            src = mods.get(name)
            if src is not None and hasattr(src, "weight") and L.is_int8(src):
                mod.weight.copy_(L.int8_weight(src, mod.weight.dtype))
    return template


def w8a8_case(torch, name, m, k, n, seed):
    """`_w8a8_dot` against the product with the dequantized weight at one
    prefill shape [m, k] x [k, n]: the int32 product exact, the relative
    error, and the times of the two."""
    with torch.no_grad():
        return _w8a8_case(torch, name, m, k, n, seed)


def _w8a8_case(torch, name, m, k, n, seed):
    import torch.nn.functional as F
    from bioreason_tpu_torch.models import layers as L
    from bioreason_tpu_torch.train.quant import store_int8, quantize_kernel_int8
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
    lin = L.linear(k, n, False, "cuda", torch.bfloat16)
    lin.weight.data = (torch.randn((n, k), generator=g, device="cuda") * k ** -0.5).to(
        torch.bfloat16)
    store_int8(lin, *quantize_kernel_int8(lin.weight))
    xq = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
    exact = bool(torch.equal(L.int8_mm(xq, lin.weight).long(),
                             (xq.double() @ lin.weight.double().t()).long()))
    y8 = L.dense(lin, x, torch.bfloat16, act8=True)
    ref = L.dense(lin, x, torch.bfloat16)
    rel = float((y8.float() - ref.float()).norm() / ref.float().norm())
    w = L.int8_weight(lin, torch.bfloat16)
    ms8 = cuda_ms(lambda: L.dense(lin, x, torch.bfloat16, act8=True), iters=20)
    ms_dq = cuda_ms(lambda: L.dense(lin, x, torch.bfloat16), iters=20)
    ms_bf = cuda_ms(lambda: F.linear(x, w), iters=20)
    flops = 2.0 * m * k * n
    log(f"w8a8 {name} [{m}, {k}] x [{k}, {n}]: int32 product exact {exact}; relative error "
        f"against the dequantized product {rel:.4g}; ms: W8A8 {ms8:.4f} (int8 x int8 -> int32 "
        f"through torch._int_mm, with the activation quantization), weight-only int8 "
        f"{ms_dq:.4f} (dequantize + bf16 GEMM), bf16 GEMM alone {ms_bf:.4f}; "
        f"{flops / (ms8 * 1e-3) / 1e12:.1f} TOP/s")
    if not exact or rel > 0.05:
        fail(f"w8a8 {name}: int32 product exact {exact}, relative error {rel:.4g}")
    return {"shape": name, "M": m, "K": k, "N": n, "exact": exact, "rel_err": rel,
            "w8a8_ms": ms8, "weight_only_ms": ms_dq, "bf16_ms": ms_bf}


def phase_int8(torch, card):
    """int8 weights, W8A8, int8 KV and fused projections at full width
    (module docstring, phase 14)."""
    import torch.nn.functional as F
    from bioreason_tpu_torch.generate.engine import GenerationEngine
    from bioreason_tpu_torch.models.fusion import init_fusion
    from bioreason_tpu_torch.serve import build_config, build_server, serving_storage
    from bioreason_tpu_torch.tools import bench_serve
    from bioreason_tpu_torch.train.quant import storage_bytes
    t_phase = time.perf_counter()
    per_call = ENCODER_LAYERS + DECODER_LAYERS
    out = {}
    cfg, _ = build_config("qwen3-0.6b", "nt-500m", max_length_dna=2048)
    items, padded = served_inputs()
    batch = [torch.as_tensor(a, device="cuda") for a in padded]

    # (a) resident weight bytes, counted from the modules' storage
    bf = init_fusion(cfg, seed=0, device="cuda").requires_grad_(False)
    q8 = serving_storage(init_fusion(cfg, seed=0, device="cuda").requires_grad_(False),
                         int8=True)
    sizes = {name: (storage_bytes(getattr(bf, name)), storage_bytes(getattr(q8, name)))
             for name in ("encoder", "decoder", "dna_projection")}
    total_bf, total_q8 = storage_bytes(bf), storage_bytes(q8)
    log(f"int8 [{card}]: resident weights {total_bf / 2**30:.3f} GiB bf16 -> "
        f"{total_q8 / 2**30:.3f} GiB --int8 ({total_q8 / total_bf:.3f}); by tower "
        + ", ".join(f"{k} {a / 2**20:.1f} -> {b / 2**20:.1f} MiB" for k, (a, b) in sizes.items()))
    if not 0.45 < total_q8 / total_bf < 0.55:
        fail(f"--int8 holds {total_q8 / total_bf:.3f} of the bf16 bytes, expected about half")
    out["bytes"] = {"bf16": total_bf, "int8": total_q8, "by_tower": sizes}

    # (b) exactness: the int8 engine against a bf16 engine holding the
    # dequantized weights, teacher-forced on the int8 engine's greedy tokens
    engine = GenerationEngine(cfg, eos_token_id=-1)
    ids, _ = engine.generate(q8, *batch, greedy=True, max_new_tokens=INT8_NEW)
    streams = torch.as_tensor(ids, device="cuda")
    lg8 = teacher_forced(torch, engine, q8, batch, streams)
    dq = dequantized_copy(torch, q8, init_fusion(cfg, seed=0, device="cuda"))
    lg_dq = teacher_forced(torch, engine, dq, batch, streams)
    del dq
    cos_exact = F.cosine_similarity(lg8, lg_dq, dim=-1)
    log(f"int8 vs dequantized bf16 weights [{card}]: teacher-forced logits cosine min "
        f"{float(cos_exact.min()):.6f} over {cos_exact.numel()} (row, step) pairs "
        f"(>= {INT8_EXACT_COS}), max abs diff {float((lg8 - lg_dq).abs().max()):.4g}")
    if float(cos_exact.min()) < INT8_EXACT_COS or not bool(torch.isfinite(lg8).all()):
        fail(f"--int8 differs from its own dequantized weights: cosine "
             f"{float(cos_exact.min()):.6f}")

    # (c) the quantization error: --int8 and --int8 --w8a8 against bf16
    ids_bf, _ = engine.generate(bf, *batch, greedy=True, max_new_tokens=INT8_NEW)
    streams_bf = torch.as_tensor(ids_bf, device="cuda")
    lg_bf = teacher_forced(torch, engine, bf, batch, streams_bf)
    cfg8 = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, act_int8=True),
                               encoder=dataclasses.replace(cfg.encoder, act_int8=True))
    e8a8 = GenerationEngine(cfg8, eos_token_id=-1)
    quant = {}
    for label, eng in (("int8", engine), ("w8a8", e8a8)):
        lg = teacher_forced(torch, eng, q8, batch, streams_bf)
        cos = F.cosine_similarity(lg, lg_bf, dim=-1)
        top = float((lg.argmax(-1) == lg_bf.argmax(-1)).float().mean())
        quant[label] = {"cos_min": float(cos.min()), "cos_median": float(cos.median()),
                        "argmax_agree": top}
        log(f"{label} vs bf16 weights [{card}]: teacher-forced logits cosine min "
            f"{quant[label]['cos_min']:.6f}, median {quant[label]['cos_median']:.6f} over "
            f"{cos.numel()} (row, step) pairs; argmax agreement {top:.3f}")
    if (quant["int8"]["cos_min"] < INT8_COS_FLOOR or quant["w8a8"]["cos_min"] < W8A8_COS_FLOOR):
        fail(f"quantization error past its floor ({INT8_COS_FLOOR}, {W8A8_COS_FLOOR}): {quant}")
    out["logits"] = {"exact_cos_min": float(cos_exact.min()), **quant}
    del lg8, lg_dq, lg_bf, bf
    torch.cuda.empty_cache()

    # (d) the server with every flag, the main path: counts from 0 just
    # before, read just after; 57 flash_fwd per engine call with the int8
    # KV cache (its prefill attends over its fresh bf16 K/V)
    server = build_server("qwen3-0.6b", "nt-500m", max_length_dna=2048, seed=0, int8=True,
                          fuse=True, w8a8=True, kv_int8=True, max_batch=8,
                          batch_window_ms=500.0, max_new_tokens=INT8_NEW, greedy_default=True)
    server.start()
    calls_out, restore = record_engine_calls(server)
    reset_counts()
    calls0 = server.engine_calls
    try:
        first = burst(server, items, INT8_NEW)
        second = burst(server, items, INT8_NEW)
    finally:
        server.stop()
        restore()
    got = counts()
    calls = server.engine_calls - calls0
    answered = [r for r in first + second if r and set(r) == {"completion", "answer"}]
    st = calls_out[-1][1]
    log(f"int8 serve [{card}] --int8 --kv_int8 --fuse --w8a8: {len(answered)} requests answered "
        f"in {calls} engine calls, launches {got} = {got['flash_fwd'] / max(calls, 1):g} "
        f"flash_fwd per call; last call B={st['batch']} P={st['prompt_len']}: prefill "
        f"{st['prefill_s'] * 1e3:.1f} ms, decode "
        f"{st['decode_tokens'] / max(st['decode_s'], 1e-9):.1f} tokens/s")
    if (len(answered) != 16 or first != second
            or got != {k: per_call * calls if k == "flash_fwd" else 0 for k in got}):
        fail(f"int8 serving: {len(answered)} answered, repeats equal {first == second}, "
             f"launches {got} in {calls} calls (expected {per_call} flash_fwd each)")
    out["serve"] = {"launches": got["flash_fwd"], "calls": calls,
                    "prefill_s": st["prefill_s"], "decode_s": st["decode_s"]}
    del server
    torch.cuda.empty_cache()

    # (e) W8A8's products at the prefill's shapes (served: 8 x 896 decoder
    # tokens, 16 x 344 encoder tokens; fused projections)
    m_dec, m_enc = 8 * batch[0].shape[1], batch[2].shape[0] * batch[2].shape[1]
    w8 = [w8a8_case(torch, "decoder_qkv", m_dec, 1024, 4096, 141),
          w8a8_case(torch, "decoder_o", m_dec, 2048, 1024, 142),
          w8a8_case(torch, "decoder_gateup", m_dec, 1024, 6144, 143),
          w8a8_case(torch, "decoder_down", m_dec, 3072, 1024, 144),
          w8a8_case(torch, "encoder_qkv", m_enc, 1024, 3072, 145),
          w8a8_case(torch, "encoder_gateup", m_enc, 1024, 8192, 146),
          w8a8_case(torch, "encoder_down", m_enc, 4096, 1024, 147)]
    out["w8a8"] = w8
    # the int8 prefill's flash_fwd: Tk = P, not P + max_new
    rows = [kernel_case(torch, f"int8_prefill_B8_P{batch[0].shape[1]}", 8, batch[0].shape[1],
                        batch[0].shape[1], 16, 8, 128, True, 0, batch[1].to(torch.int32), 148)]

    # (f) the serving bench at the JAX bench's default (--frozen int8), and
    # with --kv int8 --fuse --w8a8
    benches = {}
    for label, extra in (("int8", []), ("all", ["--kv", "int8", "--fuse", "--w8a8"])):
        reset_counts()
        res = bench_serve.main(["--requests", str(CONT_REQUESTS)] + extra)
        got = counts()
        torch.cuda.empty_cache()
        log(f"int8 bench [{card}] --frozen int8 {' '.join(extra)}: {res['value']:.1f} decoded "
            f"tokens/s ({res['decoded_tokens']} tokens, {res['requests']} requests over "
            f"{res['capacity']} slots in {res['seconds']:.2f} s; admit {res['admit_s']:.2f} s); "
            f"mean occupancy {res['mean_occupancy']:.3f}; {res['prefill_calls']} prefill "
            f"calls, {res['flash_fwd_per_prefill']:g} flash_fwd each; pools "
            f"{res['pool_gib']:.3f} GiB, weights {res['weights_gib']:.3f} GiB, "
            f"torch.cuda.max_memory_allocated {res['peak_gib']:.2f} GiB")
        if got != {k: (per_call * (res["prefill_calls"] + 1) if k == "flash_fwd" else 0)
                   for k in got}:
            fail(f"the int8 bench launched {got}: expected {per_call} flash_fwd per prefill "
                 f"chunk (and its warmup's one) and nothing else")
        benches[label] = {**res, "launches": got["flash_fwd"]}
    out["bench"] = benches
    out["seconds"] = time.perf_counter() - t_phase
    log(f"int8: phase done in {out['seconds']:.1f} s (budget {INT8_BUDGET_S:g})")
    if out["seconds"] > INT8_BUDGET_S:
        fail(f"the int8 phase took {out['seconds']:.1f} s, over {INT8_BUDGET_S:g}")
    return out, rows


# -- phase 15 ----------------------------------------------------------------

QWEN4B_LAYERS = 36                     # Qwen3-4B: 36 layers, 32/8 heads of 128
QLORA_STEPS, QLORA_REPS = 4, 3         # bench_sft: 2 warm-up + 3 x 4 timed + 1 profiled
QLORA_GRPO_STEPS = 2                   # bench_grpo: 1 warm-up + 2 timed
QLORA_ROLLOUT_NEW, QLORA_ROLLOUT_REPS = 32, 3   # bench_rollout: 1 warm-up + 3 timed calls
# (c) a QLoRA step against a bf16 model holding its dequantized weights: the
# int8 dense dequantizes in bf16 and calls the same GEMM on the same values,
# forward and backward, so on a deterministic route (the plain attention,
# remat on to bound its fp32 logits) the two are expected bitwise equal.
# Through the kernels flash_bwd's dq is reduce-added in no fixed order
# (ROADMAP 2): the int8 step against itself gives that route's noise floor,
# and the twin there is held to a cosine under the floor's readings and
# over the planted fault's (one decoder layer's dequantizing scale dropped
# from its down projection's backward)
QLORA_TWIN_LOSS_RTOL, QLORA_TWIN_COS, QLORA_KERNEL_COS = 1e-6, 0.999999, 0.999
# (e) the grouped int8-KV decode step against the ungrouped one on the same
# int8 caches: the same products summed in another order (bf16 operands
# with fp32 accumulation against fp32 einsums), whose bf16 outputs round
# apart through 28 layers. Held under the sound readings and over those of
# two planted faults of the grouped step's scales (`grouped_kv8_check`)
GROUPED_KV8_COS = 0.999
QLORA_BUDGET_S = 240.0


def dequantized_twin(torch, model, cfg):
    """A module tree holding `model`'s tensors except its int8 weights,
    which it holds dequantized in their tower's compute dtype as frozen
    parameters (the value `dense` computes from them): the adapters and the
    projection are the model's own."""
    from bioreason_tpu_torch.models import layers as L
    from bioreason_tpu_torch.train.trainable import shared_copy
    from bioreason_tpu_torch.utils.devices import torch_dtype
    twin = shared_copy(model)
    with torch.no_grad():
        for tower, tcfg in ((twin.decoder, cfg.decoder), (twin.encoder, cfg.dna_tower)):
            for mod in tower.modules():
                if isinstance(mod, torch.nn.Linear) and L.is_int8(mod):
                    w = L.int8_weight(mod, torch_dtype(tcfg.dtype))
                    del mod.weight, mod.scale
                    mod.weight = torch.nn.Parameter(w, requires_grad=False)
    return twin


def per_tensor_scale_backward(ctx, g):
    """A planted fault of `Int8Linear.backward`: dx dequantizes with one
    scale per weight (its channels' mean) in place of one per channel."""
    q, scale = ctx.saved_tensors
    dx = g.matmul(q.to(g.dtype) * scale.float().mean().to(g.dtype))
    db = g.reshape(-1, g.shape[-1]).sum(0) if ctx.needs_input_grad[3] else None
    return dx, None, None, db


def qlora_twin_check(torch, trainer, batch):
    """(c): one QLoRA loss and its trainable gradients against the
    dequantized twin's, on the plain route (held bitwise-tight) and through
    the kernels (held to QLORA_KERNEL_COS, which the int8 step against
    itself must pass and a planted fault, `per_tensor_scale_backward`, must
    fail)."""
    import torch.nn.functional as F
    from bioreason_tpu_torch.models import layers as L
    db = trainer._device_batch(batch)
    cfg = trainer.fusion_cfg
    plain = dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, attention_impl="xla", remat=True),
        encoder=dataclasses.replace(cfg.encoder, attention_impl="xla"))
    real = trainer.model
    twin = dequantized_twin(torch, real, cfg)

    def loss_and_grad(model, c):
        trainer.model, trainer.fusion_cfg = model, c
        try:
            loss = trainer._loss(db, train=True)
            grads = torch.autograd.grad(loss, trainer.params, allow_unused=True)
        finally:
            trainer.model, trainer.fusion_cfg = real, cfg
        return float(loss.detach()), torch.cat([
            (torch.zeros_like(p) if g is None else g).float().flatten()
            for p, g in zip(trainer.params, grads)])

    def compare(a, b):
        (la, ga), (lb, gb) = a, b
        return {"loss": la, "other_loss": lb, "loss_rel": abs(la - lb) / abs(lb),
                "grad_cos": float(F.cosine_similarity(ga, gb, dim=0)),
                "grad_max_abs_diff": float((ga - gb).abs().max()),
                "grad_max": float(gb.abs().max()), "bitwise": bool(torch.equal(ga, gb))}

    def show(what, r, n):
        log(f"qlora (c) {what}: loss {r['loss']:.7f} vs {r['other_loss']:.7f} (relative "
            f"{r['loss_rel']:.3g}); cosine of the {n} trainable gradients "
            f"{r['grad_cos']:.7f}, max abs diff {r['grad_max_abs_diff']:.3g} (max |g| "
            f"{r['grad_max']:.3g}); bitwise equal {r['bitwise']}")
    out = {}
    for route, c in (("plain", plain), ("kernels", cfg)):
        first = loss_and_grad(real, c)
        n = first[1].numel()
        out[route] = compare(first, loss_and_grad(twin, c))
        show(f"{route} route, the int8 step against a bf16 model holding its dequantized "
             f"weights", out[route], n)
        if route == "kernels":
            out["kernels_noise"] = compare(first, loss_and_grad(real, c))
            show("kernel route, the int8 step against itself (the noise floor)",
                 out["kernels_noise"], n)
            sound = L.Int8Linear.backward
            L.Int8Linear.backward = staticmethod(per_tensor_scale_backward)
            try:
                out["kernels_fault"] = compare(loss_and_grad(real, c), first)
            finally:
                L.Int8Linear.backward = sound
            show("kernel route, a planted fault (per-tensor scale in the int8 dense's "
                 "backward) against the int8 step", out["kernels_fault"], n)
        del first
    r, k = out["plain"], out["kernels"]
    noise, fault = out["kernels_noise"], out["kernels_fault"]
    log(f"qlora (c): held: the plain route's loss within {QLORA_TWIN_LOSS_RTOL} relative "
        f"and cosine >= {QLORA_TWIN_COS}; the kernel route's loss as tight and cosine >= "
        f"{QLORA_KERNEL_COS}, which its noise floor {noise['grad_cos']:.7f} must pass and "
        f"the fault {fault['grad_cos']:.7f} must fail")
    if (r["loss_rel"] > QLORA_TWIN_LOSS_RTOL or r["grad_cos"] < QLORA_TWIN_COS
            or not math.isfinite(r["loss"])):
        fail(f"QLoRA and its dequantized twin disagree on the plain route: {r}")
    if k["loss_rel"] > QLORA_TWIN_LOSS_RTOL or k["grad_cos"] < QLORA_KERNEL_COS:
        fail(f"QLoRA and its dequantized twin disagree through the kernels: {k}")
    if noise["grad_cos"] < QLORA_KERNEL_COS or fault["grad_cos"] >= QLORA_KERNEL_COS:
        fail(f"the kernel route's limit {QLORA_KERNEL_COS} does not part the noise floor "
             f"{noise['grad_cos']} from the planted fault {fault['grad_cos']}")
    del twin
    return out


GROUPED_KV8_FAULTS = {
    "the decode slot's scales dropped": lambda pk_s, pv_s, dk_s, dv_s: (pk_s, pv_s, None,
                                                                         None),
    "the prompt's key and value scales swapped": lambda pk_s, pv_s, dk_s, dv_s: (
        pv_s, pk_s, dk_s, dv_s)}


def grouped_kv8_check(torch, model, engine, inputs, group):
    """(e): the first decode step's fp32 logits of the grouped int8-KV
    decode (`decoder_decode_step_grouped`: the shared int8 prompt cache and
    an int8 decode slot) against the ungrouped int8-KV step
    (`decoder_forward` over the same prompt cache repeated G-fold plus the
    slot), on the engine's own prefill; then the grouped step again with
    each of GROUPED_KV8_FAULTS planted in `_grouped_decode_attention`'s
    scales, which the limit must catch."""
    import torch.nn.functional as F
    from bioreason_tpu_torch.models import qwen3
    cfg = engine.cfg.decoder
    ids, mask, dna, dna_mask = (torch.as_tensor(a, device="cuda") for a in inputs)
    sound = qwen3._grouped_decode_attention
    with torch.inference_mode():
        last, pcache, _ = engine.prefill(model, ids, mask, dna, dna_mask, 0)
        b, p = ids.shape
        bg = b * group
        tok = last.argmax(-1).repeat_interleave(group)[:, None]
        pos = mask.sum(-1).repeat_interleave(group)[:, None]
        ones = torch.ones((bg, 1), dtype=torch.int32, device="cuda")

        def grouped():
            dcache = qwen3.init_cache(cfg, bg, 1, torch.bfloat16, "cuda", quantize=True)
            return qwen3.decoder_decode_step_grouped(model.decoder, cfg, tok, pos, pcache,
                                                     mask, dcache, 0, ones, group)[0][:, 0]
        lg = grouped()
        faulty = {}
        for name, fault in GROUPED_KV8_FAULTS.items():
            qwen3._grouped_decode_attention = (
                lambda *a, fault=fault: sound(*a[:8], *fault(*a[8:])))
            try:
                faulty[name] = grouped()
            finally:
                qwen3._grouped_decode_attention = sound
        ucache = [{k: torch.cat([v.repeat_interleave(group, 0),
                                 v.new_zeros((bg, 1) + tuple(v.shape[2:]))], 1)
                   for k, v in e.items()} for e in pcache]
        umask = torch.cat([mask.to(torch.int32).repeat_interleave(group, 0), ones], 1)
        lu, _ = qwen3.decoder_forward(model.decoder, cfg, input_ids=tok, attention_mask=ones,
                                      positions=pos, cache=ucache, cache_index=p,
                                      cache_mask=umask)
    lu = lu[:, 0]
    cos = float(F.cosine_similarity(lg, lu, dim=-1).min())
    agree = float((lg.argmax(-1) == lu.argmax(-1)).float().mean())
    err = float((lg - lu).abs().max())
    fault_cos = {name: float(F.cosine_similarity(f, lu, dim=-1).min())
                 for name, f in faulty.items()}
    log(f"qlora (e): grouped int8-KV decode vs the ungrouped int8-KV step, first step's "
        f"logits over {bg} rows (B={b} x G={group}, P={p}, {pcache[0]['k'].dtype} caches): "
        f"cosine min {cos:.7f} (>= {GROUPED_KV8_COS}), max abs diff {err:.4g} "
        f"(max |logit| {float(lu.abs().max()):.4g}), argmax agreement {agree:.3f}; planted "
        f"faults (must fall under {GROUPED_KV8_COS}): "
        + "; ".join(f"{name} {c:.7f}" for name, c in fault_cos.items()))
    if (cos < GROUPED_KV8_COS or not bool(torch.isfinite(lg).all())
            or pcache[0]["k"].dtype != torch.int8):
        fail(f"the grouped int8-KV decode differs from the ungrouped one: cosine {cos}")
    if max(fault_cos.values()) >= GROUPED_KV8_COS:
        fail(f"the limit {GROUPED_KV8_COS} misses a planted fault of the grouped int8-KV "
             f"decode: {fault_cos}")
    return {"cos_min": cos, "max_abs_diff": err, "argmax_agree": agree,
            "fault_cos_min": fault_cos}


def phase_qlora(torch, card):
    """QLoRA SFT and GRPO at NT-v2-500M + Qwen3-4B, the int8 rollouts and
    the grouped int8-KV decode (module docstring, phase 15)."""
    from bioreason_tpu_torch.models import layers as L
    from bioreason_tpu_torch.tools import bench_grpo, bench_rollout, bench_sft
    t_phase = time.perf_counter()
    out, rows, bwd_rows = {"sft": {}, "rollout": {}}, [], []

    # (a)-(c) bench_sft at Qwen3-4B, int8 then bf16, each a main path:
    # counts from 0 just before, read just after
    per_step = {"flash_fwd": ENCODER_LAYERS + QWEN4B_LAYERS, "flash_bwd": QWEN4B_LAYERS}
    n_steps = 2 + QLORA_REPS * QLORA_STEPS + 1
    for frozen in ("int8", "bfloat16"):
        t_sub = time.perf_counter()
        reset_counts()
        res, trainer, batch = bench_sft.run(bench_sft.parse_args(
            ["--decoder", "qwen3-4b", "--frozen", frozen, "--steps", str(QLORA_STEPS),
             "--reps", str(QLORA_REPS)]))
        got = counts()
        log(f"qlora (a/b) bench_sft [{card}] --decoder qwen3-4b --frozen {frozen}: "
            f"{res['value']:.3f} examples/s (median of {res['repetitions']}), "
            f"{res['ms_per_step']:.1f} ms per step; profiled step busy "
            f"{res['profiled_step_busy_ms']:.2f} of {res['profiled_step_wall_ms']:.2f} ms; "
            f"resident frozen {res['resident_frozen_gib']:.3f} GiB, peak "
            f"{res['peak_gib']:.2f} GiB (init {res['init_peak_gib']:.2f}); "
            f"{res['trainable_params'] / 1e6:.2f} M trainable; loss {res['loss']:.4f}; "
            f"launches {got} over {n_steps} steps ({time.perf_counter() - t_sub:.1f} s)")
        want = {k: n_steps * per_step.get(k, 0) for k in got}
        if got != want or res["launches_per_step"] != per_step:
            fail(f"bench_sft --frozen {frozen} launched {got}, expected {want}")
        if not math.isfinite(res["loss"]):
            fail(f"bench_sft --frozen {frozen}: loss {res['loss']}")
        out["sft"][frozen] = {**res, "launches": got}
        if frozen == "int8":
            n8 = sum(1 for m in trainer.model.modules()
                     if isinstance(m, torch.nn.Linear) and L.is_int8(m))
            scales = {str(m.scale.dtype) for m in trainer.model.modules()
                      if isinstance(m, torch.nn.Linear) and L.is_int8(m)}
            log(f"qlora (a): {n8} int8 denses, scales {scales}")
            if n8 != 7 * (QWEN4B_LAYERS + ENCODER_LAYERS) or scales != {"torch.bfloat16"}:
                fail(f"QLoRA model: {n8} int8 denses, scales {scales}")
            out["twin"] = qlora_twin_check(torch, trainer, batch)
        del trainer, batch
        torch.cuda.empty_cache()
    i8, bf = out["sft"]["int8"], out["sft"]["bfloat16"]
    share = i8["resident_frozen_gib"] / bf["resident_frozen_gib"]
    log(f"qlora (b) [{card}]: int8's resident frozen bytes {share:.3f} of bf16's "
        f"({i8['resident_frozen_gib']:.3f} / {bf['resident_frozen_gib']:.3f} GiB); peaks "
        f"{i8['peak_gib']:.2f} (int8) vs {bf['peak_gib']:.2f} GiB (bf16); examples/s "
        f"{i8['value']:.3f} vs {bf['value']:.3f} ({i8['value'] / bf['value']:.3f}x)")
    if not i8["peak_gib"] < bf["peak_gib"] or not share < 0.6:
        fail(f"QLoRA's peak {i8['peak_gib']:.2f} GiB is not under bf16's "
             f"{bf['peak_gib']:.2f}, or its resident share is {share:.3f}")
    rows.append(kernel_case(torch, "qlora_sft_T768_4b", 4, 768, 768, 32, 8, 128, True, 0,
                            torch.ones((4, 768), dtype=torch.int32, device="cuda"), 151))
    bwd_rows.append(bwd_case(torch, "qlora_sft_T768_4b", 4, 768, 768, 32, 8, 128, True, 0,
                             torch.ones((4, 768), dtype=torch.int32, device="cuda"), 152))

    # (d) bench_grpo at Qwen3-4B, int8 frozen towers and int8 rollouts
    t_sub = time.perf_counter()
    reset_counts()
    res, trainer, items = bench_grpo.run(bench_grpo.parse_args(
        ["--decoder", "qwen3-4b", "--frozen", "int8", "--rollout_int8", "--new", str(GRPO_NEW),
         "--steps", str(QLORA_GRPO_STEPS), "--probe"]))
    got = counts()
    per_grpo = {"flash_fwd": 3 * ENCODER_LAYERS + 4 * QWEN4B_LAYERS, "flash_bwd": QWEN4B_LAYERS}
    want = {k: (1 + QLORA_GRPO_STEPS) * per_grpo.get(k, 0) for k in got}
    tm = res["timers"]
    log(f"qlora (d) bench_grpo [{card}] --decoder qwen3-4b --frozen int8 --rollout_int8: "
        f"{res['value']:.3f} completions/s, {res['seconds_per_step'] * 1e3:.1f} ms per step "
        f"({res['prompts']} prompts x G={res['G']}, P={res['prompt_len']}, {GRPO_NEW} new "
        f"tokens); seconds per phase "
        f"{', '.join(f'{k} {tm[k]:.3f}' for k in ('prep', 'rollout', 'logps_dispatch', 'rewards', 'update'))}; "
        f"peak {res['peak_gib']:.2f} GiB; loss {res['loss']:.6g} kl {res['kl']:.4g}; "
        f"launches {got} over {1 + QLORA_GRPO_STEPS} steps ({time.perf_counter() - t_sub:.1f} s)")
    if got != want:
        fail(f"bench_grpo launched {got}, expected {want}")
    if not (math.isfinite(res["loss"]) and math.isfinite(res["kl"])):
        fail(f"bench_grpo: loss {res['loss']}, kl {res['kl']}")
    model, ref, roll = trainer.model, trainer.ref_model, trainer.rollout_model()
    mods = {n: m for n, m in model.named_modules()
            if isinstance(m, torch.nn.Linear) and L.is_int8(m)}
    shared = {}
    for label, other in (("reference", ref), ("rollout", roll)):
        theirs = dict(other.named_modules())
        shared[label] = sum(theirs[n].weight.data_ptr() == m.weight.data_ptr()
                            and theirs[n].scale.data_ptr() == m.scale.data_ptr()
                            for n, m in mods.items())
    live = dict(model.named_parameters())
    adapters_live = all(p is live[n] for n, p in roll.named_parameters())
    log(f"qlora (d): the reference and the rollout policy share {shared['reference']} and "
        f"{shared['rollout']} of the training model's {len(mods)} int8 denses (weight and "
        f"scale data_ptr); the rollout's parameters are the model's own: {adapters_live}; its "
        f"embedding {roll.decoder.embed.weight.dtype} (the training model's "
        f"{model.decoder.embed.weight.dtype})")
    if (set(shared.values()) != {len(mods)} or not mods or not adapters_live
            or not L.is_int8(roll.decoder.embed)):
        fail(f"the GRPO models do not share the int8 storage: {shared} of {len(mods)}, "
             f"adapters live {adapters_live}")
    out["grpo"] = {**res, "launches": got, "shared": shared}
    r, b = grpo_kernel_cases(torch, trainer, items, prefix="qlora_grpo")
    rows += r
    bwd_rows += b
    del trainer, model, ref, roll, mods, live, items
    torch.cuda.empty_cache()

    # (e) bench_rollout at 16 x G=8, bf16 then int8 weights and KV, at the
    # bench's Qwen3-0.6B and at Qwen3-4B
    for decoder, layers in (("qwen3-0.6b", DECODER_LAYERS), ("qwen3-4b", QWEN4B_LAYERS)):
        for frozen in ("bfloat16", "int8"):
            t_sub = time.perf_counter()
            reset_counts()
            res, model, engine, inputs = bench_rollout.run(bench_rollout.parse_args(
                ["--decoder", decoder, "--frozen", frozen, "--kv", frozen, "--new",
                 str(QLORA_ROLLOUT_NEW), "--reps", str(QLORA_ROLLOUT_REPS)]))
            got = counts()
            want = {k: (1 + QLORA_ROLLOUT_REPS) * (ENCODER_LAYERS + layers)
                    if k == "flash_fwd" else 0 for k in got}
            log(f"qlora (e) bench_rollout [{card}] --decoder {decoder} --frozen {frozen} --kv "
                f"{frozen}: {res['value']:.1f} decoded tokens/s (median of "
                f"{[round(x, 1) for x in res['calls']]}), {res['rows']} rows x "
                f"{res['new_tokens']} tokens, P={res['prompt_len']}; last call prefill "
                f"{res['prefill_s'] * 1e3:.1f} ms, decode {res['decode_s'] * 1e3:.1f} ms; "
                f"weights {res['weights_gib']:.3f} GiB, peak {res['peak_gib']:.2f} GiB; "
                f"launches {got} ({time.perf_counter() - t_sub:.1f} s)")
            if got != want:
                fail(f"bench_rollout launched {got}, expected {want}")
            out["rollout"][f"{decoder}_{frozen}"] = {**res, "launches": got["flash_fwd"]}
            if decoder == "qwen3-0.6b" and frozen == "int8":
                out["grouped_kv8"] = grouped_kv8_check(torch, model, engine, inputs, res["G"])
            del model, engine
            torch.cuda.empty_cache()
        a, b = (out["rollout"][f"{decoder}_{f}"]["value"] for f in ("int8", "bfloat16"))
        log(f"qlora (e) [{card}] {decoder}: int8 weights + int8 KV {a:.1f} vs bf16 {b:.1f} "
            f"tokens/s ({a / b:.3f}x)")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"qlora: phase done in {out['seconds']:.1f} s (budget {QLORA_BUDGET_S:g})")
    if out["seconds"] > QLORA_BUDGET_S:
        fail(f"the qlora phase took {out['seconds']:.1f} s, over {QLORA_BUDGET_S:g}")
    return out, rows, bwd_rows


# -- phase 16 -------------------------------------------------------------------

# the rehearsal's bench widths (Qwen3-0.6B + NT-v2-50M, 1-mer DNA of 32 bp),
# cut for time: 128 items (1,280 in the bench run), 2 SFT epochs of 12 steps
# (40 at most, with the probe's stop), a validation every 8 steps (96), 64
# tokens generated in the tests and rollouts (288), 2 GRPO steps (80)
REH_ITEMS, REH_EPOCHS, REH_EVAL, REH_NEW, REH_GRPO = 128, 2, 8, 64, 2
REH_SEQ_LEN, REH_BATCH, REH_SEED = 32, 8, 7
REH_BUDGET_S = 150.0
# one SFT step: remat full runs every decoder layer's forward twice; the
# encoder's 32-wide heads take the plain path (models/attention.py)
REH_PER = {"train_step": {"flash_fwd": 2 * DECODER_LAYERS, "flash_bwd": DECODER_LAYERS},
           "eval_step": {"flash_fwd": DECODER_LAYERS},
           "generate": {"flash_fwd": DECODER_LAYERS},
           # the rollout's prefill, the reference logps, the update's forward
           # and its recompute
           "grpo_step": {"flash_fwd": 4 * DECODER_LAYERS, "flash_bwd": DECODER_LAYERS}}
REH_DOTS_COS = 0.999                    # remat dots vs off through the kernels


class LaunchLog:
    """Each call of the wrapped functions with the kernel launches it made
    and its nesting depth (a rollout's engine call inside a GRPO step)."""

    def __init__(self):
        self.calls, self.depth, self._undo = [], 0, []

    def wrap(self, owner, attr, name):
        real = getattr(owner, attr)

        def wrapped(*a, **kw):
            before = counts()
            self.depth += 1
            try:
                return real(*a, **kw)
            finally:
                self.depth -= 1
                after = counts()
                self.calls.append((name, self.depth,
                                   {k: after[k] - before[k] for k in after if after[k] - before[k]}))
        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, real))

    def close(self):
        for owner, attr, real in reversed(self._undo):
            setattr(owner, attr, real)
        self._undo = []


def jax_rule_kept(val_curve, k, stop_step):
    """The steps the JAX CLI's best-k keeps (cli/train_sft.py:280-323): a
    save only on a val loss 25% under the last kept one, and at the step the
    probe stops at; the k best of those saves."""
    kept, last = [], None

    def update(value, step):
        if len(kept) >= k and not value < kept[-1][0]:
            return False
        kept.append((value, step))
        kept.sort(key=lambda t: t[0])
        del kept[k:]
        return True
    for step, value in val_curve:
        if (last is None or value < 0.75 * last) and update(value, step):
            last = value
        if step == stop_step:
            update(value, step)
    return sorted(step for _, step in kept)


def rehearsal_fusion(torch, act_int8=False):
    """The rehearsal's FusionConfig and processor (tools/rehearsal.py)."""
    from bioreason_tpu_torch.cli.common import DECODER_PRESETS, ENCODER_PRESETS
    from bioreason_tpu_torch.config import FusionConfig
    from bioreason_tpu_torch.data import BioProcessor, ByteTextTokenizer, KmerTokenizer
    tok = ByteTextTokenizer()
    dec = dataclasses.replace(DECODER_PRESETS["qwen3-0.6b"](vocab_size=tok.vocab_size),
                              act_int8=act_int8)
    enc = dataclasses.replace(ENCODER_PRESETS["nt-50m"](), act_int8=act_int8)
    cfg = FusionConfig(decoder=dec, encoder=enc, dna_pad_token_id=tok.dna_pad_id,
                       max_length_text=512, max_length_dna=REH_SEQ_LEN + 8)
    return cfg, tok, BioProcessor(tok, KmerTokenizer(kmer=1))


def phase_rehearsal(torch, card):
    """The quality rehearsal at its bench widths, cut for time (REH_*), and
    the training-loop pieces that came with it (module docstring, phase 16).
    Returns (numbers, forward rows, backward rows)."""
    import csv

    import torch.nn.functional as F
    from bioreason_tpu_torch.cli.common import load_items
    from bioreason_tpu_torch.data.collate import sft_collate
    from bioreason_tpu_torch.config import SamplingConfig
    from bioreason_tpu_torch.generate.engine import GenerationEngine
    from bioreason_tpu_torch.models.attention import attention
    from bioreason_tpu_torch.ops import flash_attention as fa
    from bioreason_tpu_torch.serve import serving_storage
    from bioreason_tpu_torch.tools import bench_sft, rehearsal
    from bioreason_tpu_torch.train import eval as TE
    from bioreason_tpu_torch.train.checkpoint import TopKKeeper, load_checkpoint, load_sft_model
    from bioreason_tpu_torch.train.eval import evaluate_generative, multilabel_substring_accuracy
    from bioreason_tpu_torch.train.grpo import GRPOTrainer
    from bioreason_tpu_torch.train.sft import SFTTrainer
    from bioreason_tpu_torch.utils.debug_nans import nan_checks
    t_phase = time.perf_counter()
    out, rows, bwd_rows = {}, [], []
    build_dir = os.path.join(REPO, "bioreason_tpu_torch", "build")
    os.makedirs(build_dir, exist_ok=True)
    work = tempfile.mkdtemp(prefix="smoke_rehearsal_", dir=build_dir)
    try:
        # (a) the rehearsal tool, its launches counted per call of each kind
        art_path = os.path.join(work, "rehearsal_smoke.json")
        calls = LaunchLog()
        calls.wrap(SFTTrainer, "train_step", "train_step")
        calls.wrap(SFTTrainer, "eval_step", "eval_step")
        calls.wrap(TE, "teacher_forced_probe", "probe")
        calls.wrap(GenerationEngine, "generate", "generate")
        calls.wrap(GRPOTrainer, "step", "grpo_step")
        grpo_timers = []                      # the trainer's host timers by phase
        real_init = GRPOTrainer.__init__

        def init_with_timers(self, *a, **kw):
            real_init(self, *a, **kw)
            self.timers = {}
            grpo_timers.append(self.timers)
        GRPOTrainer.__init__ = init_with_timers
        t_sub = time.perf_counter()
        reset_counts()
        try:
            art = rehearsal.main(
                ["--scale", "bench", "--seq_len", str(REH_SEQ_LEN), "--items", str(REH_ITEMS),
                 "--sft_epochs", str(REH_EPOCHS), "--eval_every", str(REH_EVAL),
                 "--max_new", str(REH_NEW), "--grpo_steps", str(REH_GRPO),
                 "--seed", str(REH_SEED), "--work_dir", work, "--out", art_path])
        finally:
            calls.close()
            GRPOTrainer.__init__ = real_init
        total = counts()
        wall = time.perf_counter() - t_sub
        n_val = art["corpus"]["split"][1]
        probe_batches = -(-min(64, n_val) // REH_BATCH)
        want_per = {**REH_PER, "probe": {"flash_fwd": probe_batches * DECODER_LAYERS}}
        by_kind = {}
        for name, depth, delta in calls.calls:
            by_kind.setdefault(name, []).append(delta)
            if delta != want_per[name]:
                fail(f"rehearsal: a {name} call launched {delta}, expected {want_per[name]}")
        want_total = {}
        for name, depth, delta in calls.calls:
            if depth == 0:
                for k, v in delta.items():
                    want_total[k] = want_total.get(k, 0) + v
        got_total = {k: v for k, v in total.items() if v}
        n_calls = {k: len(v) for k, v in by_kind.items()}
        # the distinct launch counts measured per call of each kind
        per_call = {name: [dict(t) for t in sorted({tuple(sorted(d.items())) for d in ds})]
                    for name, ds in by_kind.items()}
        log(f"rehearsal (a) [{card}] tools/rehearsal.py --scale bench at {REH_ITEMS} items, "
            f"{REH_EPOCHS} epochs, eval every {REH_EVAL}, {REH_NEW} new tokens, {REH_GRPO} GRPO "
            f"steps: {wall:.1f} s (SFT {art['sft']['wall_s']} s, GRPO {art['grpo']['wall_s']} "
            f"s, tests {art['eval_wall_s']} s); calls {n_calls}; launches {got_total}, "
            f"per call {per_call} (reckoned {want_per}); GRPO seconds per phase over "
            f"{REH_GRPO} steps { {k: round(v, 3) for k, v in grpo_timers[0].items()} }; "
            f"test accuracy {art['test_accuracy_after_sft']:.4f} after "
            f"SFT, {art['test_accuracy_after_grpo']:.4f} after GRPO")
        if got_total != want_total or n_calls.get("train_step") != REH_EPOCHS * (
                art["corpus"]["split"][0] // REH_BATCH) or n_calls.get("grpo_step") != REH_GRPO:
            fail(f"rehearsal launched {got_total}, its calls {want_total} ({n_calls})")
        sft_logs = os.path.join(work, "sft_logs")
        val = rehearsal.load_curve(sft_logs, "val/loss")
        probes = {k: rehearsal.load_curve(sft_logs, f"val/probe_{k}")
                  for k in ("base_acc", "half_acc", "answer_acc", "span_acc")}
        reward = rehearsal.load_curve(os.path.join(work, "grpo_logs"), "grpo/reward")
        n_evals = n_calls["train_step"] // REH_EVAL
        log(f"rehearsal (a): val loss {[round(v, 4) for _, v in val]}, probe "
            f"{ {k: [round(x, 3) for _, x in c] for k, c in probes.items()} }, reward "
            f"{[round(x, 3) for _, x in reward]}")
        if (len(val) != n_evals or any(len(c) != n_evals for c in probes.values())
                or len(reward) != REH_GRPO or art["sft"]["val_loss_curve"] != val):
            fail(f"rehearsal: the metrics files lack curves ({len(val)} val, "
                 f"{ {k: len(c) for k, c in probes.items()} } probe, {len(reward)} reward)")
        if not min(v for _, v in val[1:]) < val[0][1]:
            fail(f"rehearsal: the val loss never fell below its first reading {val}")
        keeper = TopKKeeper(os.path.join(work, "sft_ckpt", "best"), k=2)
        kept = sorted(step for _, step, _ in keeper._kept)
        stop = n_calls["train_step"] if n_calls["train_step"] < REH_EPOCHS * (
            art["corpus"]["split"][0] // REH_BATCH) else None
        want_kept = jax_rule_kept(val, 2, stop)
        lean = [("opt_state" not in torch.load(os.path.join(path, "state.pt"), mmap=True,
                                               map_location="cpu", weights_only=True))
                for _, _, path in keeper._kept]
        log(f"rehearsal (a): best-k kept steps {kept} (the JAX rule on this val curve: "
            f"{want_kept}), params only {lean}; artifact {art_path} (default "
            f"{rehearsal.default_out('bench')})")
        if kept != want_kept or not all(lean) or not lean:
            fail(f"rehearsal: best-k kept {kept} (params only {lean}), the JAX rule {want_kept}")
        pkg = os.path.join(REPO, "bioreason_tpu_torch")
        default = rehearsal.default_out("bench")
        if (not os.path.isfile(art_path) or not art_path.startswith(pkg + os.sep)
                or os.path.dirname(default) != os.path.join(pkg, "artifacts")):
            fail(f"rehearsal: artifact {art_path}, default {default}: not under {pkg}")
        g = torch.Generator(device="cuda").manual_seed(5)
        q32 = torch.randn((2, 64, 16, 32), generator=g, device="cuda").to(torch.bfloat16)
        try:
            attention(q32, q32, q32, impl="pallas")
            fail("attention(impl='pallas') at D = 32 on the card did not raise")
        except ValueError as e:
            log(f"rehearsal (a): attention(impl='pallas') at D = 32 raises: {e}")
        out["a"] = {"wall_s": wall, "launches": got_total, "calls": n_calls,
                    "per_call": per_call, "grpo_timers": grpo_timers[0], "val_loss": val, "kept": kept,
                    "acc_sft": art["test_accuracy_after_sft"],
                    "acc_grpo": art["test_accuracy_after_grpo"]}

        # (b) the best SFT checkpoint under serve's int8 storage and W8A8
        t_sub = time.perf_counter()
        with open(os.path.join(work, "generations_sft.csv"), newline="") as f:
            bf16_rows = list(csv.DictReader(f))
        _, _, test_items = load_items("kegg", os.path.join(work, "corpus"), 0, 0, REH_SEED)
        uniq = sorted({ex["answer"].strip() for ex in test_items})
        out["b"] = {"bf16": {"accuracy": art["test_accuracy_after_sft"], "equal": 1.0}}
        for mode in ("int8", "w8a8"):
            cfg, tok, proc = rehearsal_fusion(torch, act_int8=mode == "w8a8")
            model = load_sft_model(keeper.best_path(), rehearsal_fusion(torch)[0], REH_SEED,
                                   "qwen3-0.6b", "nt-50m", "cuda")
            serving_storage(model, int8=True)
            engine = GenerationEngine(cfg, eos_token_id=tok.eos_token_id, device="cuda")
            res = evaluate_generative(engine, model, proc, test_items, labels=tuple(uniq[:2]),
                                      sampling=SamplingConfig(max_new_tokens=REH_NEW),
                                      max_new_tokens=REH_NEW, batch_size=REH_BATCH, greedy=True,
                                      max_length_text=512, max_length_dna=REH_SEQ_LEN + 8)
            equal = sum(g["generation"] == r["generation"]
                        for g, r in zip(res.generations, bf16_rows)) / len(bf16_rows)
            out["b"][mode] = {"accuracy": multilabel_substring_accuracy(res.generations),
                              "equal": equal}
            del model, engine
            torch.cuda.empty_cache()
        log(f"rehearsal (b) [{card}] (print-only: phases 14-15 hold the int8 and W8A8 paths "
            f"to limits): the best SFT checkpoint's {len(bf16_rows)} test answers, "
            f"{REH_NEW} tokens greedy: accuracy and share of answers equal to bf16's "
            f"{out['b']} ({time.perf_counter() - t_sub:.1f} s)")

        # (f) the kernels at the rehearsal's decoder shape: a training batch
        items = load_items("kegg", os.path.join(work, "corpus"), 0, 0, REH_SEED)[0][:REH_BATCH]
        cfg, tok, proc = rehearsal_fusion(torch)
        batch = sft_collate(items, proc, 512, REH_SEQ_LEN + 8, bucket=128, supervise_eos=True)
        mask = torch.as_tensor(np.asarray(batch["attention_mask"]), device="cuda").to(torch.int32)
        t_dec = mask.shape[1]
        rows.append(kernel_case(torch, f"rehearsal_sft_T{t_dec}", REH_BATCH, t_dec, t_dec, 16, 8,
                                128, True, 0, mask, 161))
        bwd_rows.append(bwd_case(torch, f"rehearsal_sft_T{t_dec}", REH_BATCH, t_dec, t_dec, 16, 8,
                                 128, True, 0, mask, 162))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # (c) bench_sft at bench.py's shape, remat off, full and dots
    t_sub = time.perf_counter()
    out["c"] = {}
    per_off = {"flash_fwd": ENCODER_LAYERS + DECODER_LAYERS, "flash_bwd": DECODER_LAYERS}
    per_on = {"flash_fwd": ENCODER_LAYERS + 2 * DECODER_LAYERS, "flash_bwd": DECODER_LAYERS}
    for remat in ("off", "full", "dots"):
        reset_counts()
        res, trainer, batch = bench_sft.run(bench_sft.parse_args(
            ["--remat", remat, "--steps", "2", "--reps", "1"]))
        want = per_off if remat == "off" else per_on
        if res["launches_per_step"] != want:
            fail(f"bench_sft --remat {remat} launched {res['launches_per_step']} a step, "
                 f"expected {want}")
        out["c"][remat] = {"examples_per_sec": res["value"], "peak_gib": res["peak_gib"],
                           "ms_per_step": res["ms_per_step"],
                           "busy_ms": res["profiled_step_busy_ms"],
                           "wall_ms": res["profiled_step_wall_ms"]}
        if remat == "dots":
            profile_step(torch, card, "bench_sft --remat dots, one step",
                         lambda: trainer.train_step(batch), ("flash", "gemm"))
        if remat != "off":
            del trainer, batch
            torch.cuda.empty_cache()
            continue
        db = trainer._device_batch(batch)
        cfg0 = trainer.fusion_cfg

        def loss_and_grad(remat_on, policy="full"):
            trainer.fusion_cfg = dataclasses.replace(
                cfg0, decoder=dataclasses.replace(cfg0.decoder, remat=remat_on,
                                                  remat_policy=policy))
            try:
                loss = trainer._loss(db, train=True)
                grads = torch.autograd.grad(loss, trainer.params, allow_unused=True)
            finally:
                trainer.fusion_cfg = cfg0
            return float(loss.detach()), torch.cat([
                (torch.zeros_like(p) if g is None else g).float().flatten()
                for p, g in zip(trainer.params, grads)])
        l_off, g_off = loss_and_grad(False)
        l_again, g_again = loss_and_grad(False)
        l_dots, g_dots = loss_and_grad(True, "dots")
        floor = float(F.cosine_similarity(g_off, g_again, dim=0))
        cos = float(F.cosine_similarity(g_off, g_dots, dim=0))
        out["c"]["dots_vs_off"] = {"loss": [l_off, l_dots], "cos": cos, "off_vs_off_cos": floor}
        log(f"rehearsal (c): one step at bench.py's shape, remat dots vs off: loss {l_dots!r} vs "
            f"{l_off!r}, cosine of the {g_off.numel()} trainable gradients {cos:.7f} (off "
            f"against itself {floor:.7f}: flash_bwd's dq sums in no fixed order)")
        if l_dots != l_off or cos < REH_DOTS_COS:
            fail(f"remat dots against off: loss {l_dots} vs {l_off}, cosine {cos:.6f}")
        del g_off, g_again, g_dots

        # (d) an async save during training
        ckdir = tempfile.mkdtemp(prefix="smoke_async_", dir=build_dir)
        try:
            plain = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.train_step(batch)
                torch.cuda.synchronize()
                plain.append(time.perf_counter() - t0)
            snap = {k: v.detach().clone() for k, v in trainer.trainable_state().items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.save(os.path.join(ckdir, "s"), block=False)
            trainer.train_step(batch)
            torch.cuda.synchronize()
            around = time.perf_counter() - t0
            t0 = time.perf_counter()
            trainer.finish_saves()
            wait = time.perf_counter() - t0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.save(os.path.join(ckdir, "b"), block=True)
            blocking_call = time.perf_counter() - t0
            trainer.train_step(batch)
            torch.cuda.synchronize()
            around_blocking = time.perf_counter() - t0
            state = load_checkpoint(os.path.join(ckdir, "s"))
            same = all(torch.equal(state["trainable"][k], v.cpu()) for k, v in snap.items())
            moved = sum(not torch.equal(trainer.trainable_state()[k].detach(), v)
                        for k, v in snap.items())
        finally:
            shutil.rmtree(ckdir, ignore_errors=True)
        out["d"] = {"plain_step_s": plain, "step_around_save_s": around,
                    "wait_after_s": wait, "blocking_save_s": blocking_call,
                    "step_around_blocking_save_s": around_blocking}
        log(f"rehearsal (d) [{card}]: a step around save(block=False) {around * 1e3:.1f} ms "
            f"(then {wait * 1e3:.1f} ms waiting for the write), around a blocking save "
            f"{around_blocking * 1e3:.1f} ms (the save {blocking_call * 1e3:.1f} ms), "
            f"plain steps {[round(x * 1e3, 1) for x in plain]} ms; the file holds the "
            f"snapshot's {len(snap)} tensors: {same}; {moved} moved since")
        if not same or not moved:
            fail(f"the async save holds other values than its snapshot ({same}, {moved})")
        del trainer, batch, db, snap, state
        torch.cuda.empty_cache()
    log(f"rehearsal (c) [{card}] bench_sft at bench.py's shape: "
        f"{ {k: v for k, v in out['c'].items() if k != 'dots_vs_off'} } "
        f"({time.perf_counter() - t_sub:.1f} s)")

    # (e) --debug_nans: a NaN out of the flash kernel and out of an aten op
    g = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn((1, 128, 2, 64), generator=g, device="cuda").to(torch.bfloat16)
    bad = q.clone()
    bad[0, 3, 1, 5] = float("nan")
    raised = []
    with nan_checks():
        fa.flash_attention(q, q, q, causal=True)               # sound: no raise
        for fn in (lambda: fa.flash_attention(bad, q, q, causal=True),
                   lambda: q.float() * float("nan")):
            try:
                fn()
                fail("--debug_nans: a planted NaN did not raise")
            except FloatingPointError as e:
                raised.append(str(e))
    log(f"rehearsal (e): --debug_nans raised {raised}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"rehearsal: phase done in {out['seconds']:.1f} s (budget {REH_BUDGET_S:g})")
    if out["seconds"] > REH_BUDGET_S:
        fail(f"the rehearsal phase took {out['seconds']:.1f} s, over {REH_BUDGET_S:g}")
    return out, rows, bwd_rows


# -- phase 17 -------------------------------------------------------------------

# Qwen3-30B-A3B (config.py:qwen3_30b_a3b) with NT-v2-500M, at full width and
# depth, bf16 weights drawn from seed 0 on the card
MOE_LAYERS = 48
MOE_BUDGET_S = 180.0
MOE_NEW = 64                            # served new tokens, as phase 4
MOE_GROUP_NEW = 16                      # (d)'s grouped completions
MOE_BENCH_NEW = 64                      # (e)'s longest completion (bench: 128)
# (c) kernel vs plain route, last-column prefill logits of one request: the
# two attention routes round apart (bf16 P against fp32), which can move a
# near-tie of the router in some layer and send a token to another expert
MOE_ROUTE_COS = 0.99
# (c) one MoE layer in bf16 against fp32 on the served prefill's input: the
# tokens routed alike (the same k experts, the same drops) must share at
# least this share, and agree to this cosine (bf16 products, fp32 sums)
MOE_ALIKE_SHARE, MOE_LAYER_COS = 0.8, 0.99
# (f) --int8 against bf16, teacher-forced: phase 14's floor. On an NVIDIA
# H100 80GB HBM3 at 700.00 W the sound int8 banks read a minimum of
# 0.993968, one scale per bank (the mean) 0.990700 and one scale per bank
# (the largest) 0.234760: a mild fault of the scale layout moves random
# weights' logits too little for a cosine to see, so the banks are also
# held to their own bound: the largest error of the dequantized bank
# against the bf16 one it was quantized from, in quantization steps
# (absmax over the input axis / 127), is half a step for a per-(expert,
# out-channel) store, plus fp32 rounding (read 0.500002; the faults 59.8
# and 210.2). Every planted fault must break that bound, and one must read
# under the floor
MOE_INT8_COS_FLOOR, MOE_BANK_STEPS = 0.98, 0.501
MOE_BANK_LAYERS = (0, MOE_LAYERS - 1)    # the banks kept in bf16 for the bound
MOE_BANK_FAULTS = {
    "one scale per bank, its scales' mean":
        lambda sc: sc.float().mean().to(sc.dtype).expand_as(sc),
    "one scale per bank, its largest (a per-tensor absmax)": lambda sc: sc.amax().expand_as(sc)}
MOE_INT8_NEW = 16


def moe_config():
    """(FusionConfig, BioProcessor) of Qwen3-30B-A3B + NT-v2-500M with the
    byte tokenizer, as `serve.build_config` makes the presets' pairs (no CLI
    preset names a MoE decoder, as in the JAX package)."""
    from bioreason_tpu_torch.config import DecoderConfig, EncoderConfig, FusionConfig
    from bioreason_tpu_torch.data import BioProcessor, ByteTextTokenizer, KmerTokenizer
    tok = ByteTextTokenizer()
    cfg = FusionConfig(decoder=DecoderConfig.qwen3_30b_a3b(), encoder=EncoderConfig.nt_v2_500m(),
                       dna_pad_token_id=tok.dna_pad_id, max_length_dna=2048)
    return cfg, BioProcessor(tok, KmerTokenizer())


class MoeRecorder:
    """Wraps `layers.moe_slots` (and, with `keep_input`, `moe_apply`) to
    record each MoE call's rows `n`, capacity `cap` and its experts `idx`,
    slots `slot` and keep flags `keep` [N, k] on the device (no host sync),
    and with `keep_input` the first call's module and input; `close`
    restores them."""

    def __init__(self, keep_input=False):
        from bioreason_tpu_torch.models import layers as L
        self.L, self.calls, self.inputs = L, [], []
        self.real_slots, self.real_apply = L.moe_slots, L.moe_apply

        def slots(idx, e, cap):
            slot, keep = self.real_slots(idx, e, cap)
            self.calls.append({"n": idx.shape[0], "cap": cap, "idx": idx, "slot": slot,
                               "keep": keep})
            return slot, keep
        L.moe_slots = slots
        if keep_input:
            def apply(moe, x, *a, **kw):
                if not self.inputs:
                    self.inputs.append((moe, x.detach().clone(), a, kw))
                return self.real_apply(moe, x, *a, **kw)
            L.moe_apply = apply

    def close(self):
        self.L.moe_slots, self.L.moe_apply = self.real_slots, self.real_apply


def moe_kept_numel(torch, fn):
    """fn() under a dispatch mode that records the largest tensor any op
    allocates (outputs that share an input's storage, as views do, are not
    allocations): the index form allocates nothing of N * E * C elements."""
    from torch.utils._python_dispatch import TorchDispatchMode

    def storages(xs):
        return {t.untyped_storage().data_ptr() for t in xs if isinstance(t, torch.Tensor)}

    class MaxNumel(TorchDispatchMode):
        biggest = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            given = storages([*args, *(kwargs or {}).values()])
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr() not in given:
                    MaxNumel.biggest = max(MaxNumel.biggest, t.numel())
            return out
    with MaxNumel():
        out = fn()
    return out, MaxNumel.biggest


def moe_layer_check(torch, card, moe, x, cfg):
    """(c): one MoE layer's output in bf16 against the port's fp32
    `moe_apply` on the same input (the served prefill's first layer), and
    the largest tensor the bf16 call allocates."""
    import torch.nn.functional as F
    from bioreason_tpu_torch.models import layers as L
    dec = cfg.decoder
    k, e = dec.num_experts_per_tok, dec.num_experts
    n = x.shape[0] * x.shape[1]
    cap = L.moe_capacity(n, e, k, dec.moe_capacity_factor)
    with torch.inference_mode():
        y16, biggest = moe_kept_numel(torch, lambda: L.moe_apply(
            moe, x, k, dec.norm_topk_prob, torch.bfloat16, dec.moe_capacity_factor))
        y32 = L.moe_apply(moe, x.float(), k, dec.norm_topk_prob, torch.float32,
                          dec.moe_capacity_factor)
        routes = []
        for dtype, xx in ((torch.bfloat16, x), (torch.float32, x.float())):
            xf = xx.reshape(n, -1).to(dtype)
            _, idx = L.moe_route(moe, xf, k, dec.norm_topk_prob, dtype)
            _, keep = L.moe_slots(idx, e, cap)
            routes.append(torch.where(keep, idx, -1).sort(-1).values)
    alike = (routes[0] == routes[1]).all(-1)
    a, b = y16.reshape(n, -1).float(), y32.reshape(n, -1)
    zero = (b.abs().sum(-1) == 0)
    live = alike & ~zero
    cos = F.cosine_similarity(a[live], b[live], dim=-1)
    share = float(alike.float().mean())
    log(f"moe layer [{card}] bf16 vs fp32 moe_apply at the served prefill's N = {n} "
        f"(C = {cap}): {share:.4f} of tokens routed alike (>= {MOE_ALIKE_SHARE}); on those "
        f"cosine min {float(cos.min()):.6f}, median {float(cos.median()):.6f} (>= "
        f"{MOE_LAYER_COS}); rows dropped whole alike in both "
        f"{bool((zero[alike] == (a.abs().sum(-1) == 0)[alike]).all())}; largest tensor of the "
        f"bf16 call {biggest:,} elements (the [E * C, H] buffer is {e * cap * x.shape[-1]:,}) "
        f"against N * E * C = {n * e * cap:,}")
    if share < MOE_ALIKE_SHARE or float(cos.min()) < MOE_LAYER_COS:
        fail(f"the bf16 MoE layer disagrees with fp32: share {share:.4f}, cosine "
             f"{float(cos.min()):.6f}")
    if biggest >= n * e * cap // 2:
        fail(f"moe_apply allocated {biggest:,} elements, not the index form")
    return {"alike_share": share, "cos_min": float(cos.min()), "largest_numel": biggest,
            "n_e_c": n * e * cap}


def moe_drops(torch, calls, pad_rows=None):
    """Per recorded MoE call: (token, choice) pairs dropped, tokens with a
    drop, and of those the pads (rows where `pad_rows` [N] is True)."""
    out = []
    for c in calls:
        lost = ~c["keep"]
        tok = lost.any(-1)
        pads = int((tok & pad_rows).sum()) if pad_rows is not None else None
        out.append({"n": c["n"], "cap": c["cap"], "pairs": int(lost.sum()),
                    "tokens": int(tok.sum()), "pad_tokens": pads})
    return out


def moe_slots_check(torch, card, calls, num_experts, pad_rows, x):
    """(c): each recorded call's slots and keep flags recomputed as the JAX
    package computes them (layers.py:258-264: a cumulative sum down the
    tokens of the [N, E] one-hot in fp32) and held equal to `moe_slots`'s;
    the experts' loads (tokens routed to each, before the capacity), the
    experts the left pads picked, and the mean cosine between the first
    layer's input rows `x` (the router's input), real tokens and all."""
    import torch.nn.functional as F
    loads, bad = [], []
    for li, c in enumerate(calls):
        assign = F.one_hot(c["idx"], num_experts).sum(1).float()        # [N, E]
        pos = assign.cumsum(0) - 1.0
        keep = assign * (pos < c["cap"])
        mine = torch.zeros_like(assign).scatter_(1, c["idx"], c["keep"].float())
        if not (torch.equal(keep, mine)
                and torch.equal(pos.gather(1, c["idx"]).to(torch.int32), c["slot"])):
            bad.append(li)
        loads.append(assign.sum(0))
    loads = torch.stack(loads).to(torch.int64).cpu()                    # [layers, E]
    cap = calls[0]["cap"]
    top = loads.sort(-1, descending=True).values
    pad_experts = sorted(int(e) for e in torch.unique(calls[0]["idx"][pad_rows]))
    xn = F.normalize(x.reshape(-1, x.shape[-1]).float(), dim=-1)

    def mean_cos(rows):
        m = rows.shape[0]
        return float((rows.sum(0).square().sum() - m) / (m * (m - 1)))
    cos_all, cos_real = mean_cos(xn), mean_cos(xn[~pad_rows])
    over = (loads > cap).sum(-1)
    log(f"moe slots [{card}]: keep and slot of {len(calls)} served-prefill layers against the "
        f"JAX form (cumsum over the [N, E] one-hot): equal in {len(calls) - len(bad)} "
        f"(unequal in layers {bad})")
    log(f"moe loads [{card}] served prefill, tokens routed per expert before the capacity "
        f"(C = {cap}, N * k / E = {calls[0]['n'] * calls[0]['idx'].shape[1] / num_experts:g}): "
        f"layer 0's 16 largest {top[0, :16].tolist()}, its median {int(top[0].median())}, "
        f"experts with no token {int((loads[0] == 0).sum())}; the largest per layer "
        f"{top[:, 0].tolist()}; experts over C per layer {over.tolist()}; the pads' experts in "
        f"layer 0 {pad_experts} with loads {[int(loads[0, e]) for e in pad_experts]}; mean "
        f"cosine between layer 0's router inputs: all rows {cos_all:.4f}, real tokens "
        f"{cos_real:.4f}")
    if bad:
        fail(f"moe_slots disagrees with the JAX form in layers {bad}")
    return {"layers_equal": len(calls) - len(bad), "loads_max": top[:, 0].tolist(),
            "experts_over_cap": over.tolist(), "load_layer0": loads[0].tolist(),
            "pad_experts": pad_experts, "router_input_mean_cos": {"all": cos_all,
                                                                  "real": cos_real}}


def moe_profile(torch, card, model, cfg, batch, label):
    """One prefill and one decode step of the served batch under the
    profiler, the MoE split by part: router and top-k, slots, dispatch
    gather, expert bmm, combine; attention; the rest (busy minus those)."""
    from torch.profiler import record_function
    from bioreason_tpu_torch.generate.engine import GenerationEngine
    from bioreason_tpu_torch.models import layers as L
    from bioreason_tpu_torch.models import qwen3 as Q
    parts = {"moe_route": "router + top-k", "moe_slots": "slots",
             "moe_dispatch": "dispatch gather", "moe_experts": "expert bmm",
             "moe_combine": "combine"}
    real = {name: getattr(L, name) for name in parts}
    real_attn = Q.attention

    def labelled(name, fn):
        def run(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return run
    for name, fn in real.items():
        setattr(L, name, labelled(name, fn))
    Q.attention = labelled("attention", real_attn)
    engine = GenerationEngine(cfg, eos_token_id=-1)
    ids, mask, dna, dmask = batch
    b, p = ids.shape
    out = {}
    try:
        with torch.inference_mode():
            engine.prefill(model, *batch, 2)
            busy, wall, got, kern = profile_step(
                torch, card, f"{label} prefill", lambda: engine.prefill(model, *batch, 2),
                ("flash_fwd", "nvjet", "gemm"), ranges=(*parts, "attention"))
            # the flash kernel is launched through ctypes, outside any torch
            # op, so its time joins the attention range by name
            flash = sum(d for name, d, *_ in kern if "flash_fwd" in name) / 1e6
            out["prefill"] = {"busy_ms": busy, "wall_ms": wall, "launches": len(kern),
                              "parts": {k: v[1] + (flash if k == "attention" else 0.0)
                                        for k, v in got.items()}}
            _, cache, cmask = engine.prefill(model, *batch, 2)
            cmask[:, p] = 1
            tok = torch.zeros((b, 1), dtype=torch.int64, device="cuda")
            pos = mask.sum(-1)[:, None]
            ones = torch.ones((b, 1), dtype=torch.int32, device="cuda")

            def step():
                return Q.decoder_forward(model.decoder, cfg.decoder, input_ids=tok,
                                         attention_mask=ones, positions=pos, cache=cache,
                                         cache_index=p, cache_mask=cmask)
            step()
            busy, wall, got, kern = profile_step(torch, card, f"{label} decode step", step,
                                                 ("nvjet", "gemm"),
                                                 ranges=(*parts, "attention"))
            out["decode"] = {"busy_ms": busy, "wall_ms": wall, "launches": len(kern),
                             "parts": {k: v[1] for k, v in got.items()}}
    finally:
        for name, fn in real.items():
            setattr(L, name, fn)
        Q.attention = real_attn
    for what, r in out.items():
        rest = r["busy_ms"] - sum(r["parts"].values())
        log(f"moe profile [{card}] {label} {what}: device busy {r['busy_ms']:.3f} of "
            f"{r['wall_ms']:.3f} ms wall ({100 * r['busy_ms'] / max(r['wall_ms'], 1e-9):.1f}%), "
            f"{r['launches']} launches; "
            + ", ".join(f"{parts.get(k, k)} {v:.3f} ms ({100 * v / max(r['busy_ms'], 1e-9):.1f}%)"
                        for k, v in r["parts"].items())
            + f", the rest {rest:.3f} ms ({100 * rest / max(r['busy_ms'], 1e-9):.1f}%)")
        r["rest_ms"] = rest
    return out


@contextlib.contextmanager
def moe_bank_scale_fault(torch, model, fault):
    """A planted fault of the int8 expert banks (f): every bank of the
    decoder dequantizes with `fault`(its [E, 1, out] scales) in their
    place; restored on exit."""
    from bioreason_tpu_torch.models import layers as L
    banks = [m for m in model.decoder.modules() if isinstance(m, L.ExpertBank)]
    saved = [m.scale for m in banks]
    try:
        for m, sc in zip(banks, saved):
            m.scale = fault(sc)
        yield
    finally:
        for m, sc in zip(banks, saved):
            m.scale = sc


def moe_bank_steps(torch, model, kept):
    """(f): the largest error of the int8 banks of the layers in `kept`
    ({layer: {name: its bf16 bank, kept before quantizing}}), dequantized
    as `moe_experts` dequantizes them (`layers.expert_bank`, here in fp32),
    against those bf16 banks, in quantization steps (absmax over the input
    axis / 127, from the bf16 bank)."""
    from bioreason_tpu_torch.models import layers as L
    worst = 0.0
    for li, banks in kept.items():
        experts = model.decoder.layers[li].mlp.experts
        for name, w in banks.items():
            w = w.float()
            step = (w.abs().amax(-2, keepdim=True) / 127.0).clamp(min=1e-12)
            err = (L.expert_bank(getattr(experts, name), torch.float32) - w).abs_().div_(step)
            worst = max(worst, float(err.amax()))
            del w, step, err
    return worst


def moe_expert_bound(cfg, n_rows, kept_pairs, label):
    """The expert products' bound over the decoder: FLOPs / 989e12 against
    bytes / 3.35e12, for the capacity form as it computes (E * C rows, every
    bank read) and for what this run's data needs (the kept (token, expert)
    pairs, the banks of the experts some token picked: `kept_pairs` and
    `picked` per layer)."""
    from bioreason_tpu_torch.models import layers as L
    dec = cfg.decoder
    h, i, e, k = dec.hidden_size, dec.moe_intermediate_size, dec.num_experts, \
        dec.num_experts_per_tok
    cap = L.moe_capacity(n_rows, e, k, dec.moe_capacity_factor)
    flops_form = 6.0 * e * cap * h * i * dec.num_layers
    bytes_form = (3 * e * h * i * 2 + 2 * 2 * e * cap * h) * dec.num_layers
    pairs, picked = kept_pairs
    flops_need = 6.0 * h * i * sum(pairs)
    bytes_need = sum(3 * pk * h * i * 2 + 2 * 2 * pr * h for pr, pk in zip(pairs, picked))
    res = {}
    for what, f, nb in (("capacity form", flops_form, bytes_form), ("needed", flops_need,
                                                                     bytes_need)):
        t_ops, t_bytes = f / PEAK_BF16_FLOPS * 1e3, nb / PEAK_HBM_BYTES * 1e3
        res[what] = {"tflop": f / 1e12, "gib": nb / 2 ** 30, "ops_ms": t_ops,
                     "bytes_ms": t_bytes, "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    log(f"moe expert products {label} (N = {n_rows}, C = {cap}, 48 layers): "
        + "; ".join(f"{w}: {r['tflop']:.3f} TFLOP / 989e12 = {r['ops_ms']:.3f} ms against "
                    f"{r['gib']:.2f} GiB / 3.35e12 = {r['bytes_ms']:.3f} ms, bound "
                    f"{r['bound_ms']:.3f} ms ({r['bound_by']})" for w, r in res.items()))
    return res


def phase_moe(torch, card):
    """Qwen3-MoE serving at Qwen3-30B-A3B + NT-v2-500M (module docstring,
    phase 17)."""
    import gc

    import torch.nn.functional as F
    from bioreason_tpu_torch.generate.engine import GenerationEngine
    from bioreason_tpu_torch.models.fusion import init_fusion
    from bioreason_tpu_torch.models.qwen3 import decoder_forward
    from bioreason_tpu_torch.serve import InferenceServer, prepare_batch, serving_storage
    from bioreason_tpu_torch.tools import bench_serve
    from bioreason_tpu_torch.train.quant import storage_bytes
    t_phase = time.perf_counter()
    per_call = ENCODER_LAYERS + MOE_LAYERS
    out = {}

    # (a) build: nothing of the earlier phases left, then the model in bf16
    # directly on the card (an fp32 stage would need 114 GiB)
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    log(f"moe: {left / 2**30:.3f} GiB allocated before the build")
    if left > 2 * 2**30:
        live = sorted(((o.numel() * o.element_size(), tuple(o.shape), str(o.dtype))
                       for o in gc.get_objects()
                       if isinstance(o, torch.Tensor) and o.is_cuda), reverse=True)
        fail(f"{left / 2**30:.2f} GiB of earlier phases is still allocated; the largest live "
             f"CUDA tensors {live[:10]}")
    cfg, processor = moe_config()
    dec = cfg.decoder
    if (dec.num_layers, dec.hidden_size, dec.num_heads, dec.num_kv_heads, dec.head_dim,
            dec.num_experts, dec.num_experts_per_tok, dec.moe_intermediate_size,
            dec.tie_word_embeddings, dec.vocab_size) != (MOE_LAYERS, 2048, 32, 4, 128, 128, 8,
                                                         768, False, 151936):
        fail(f"the decoder is not at Qwen3-30B-A3B width: {dec}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = init_fusion(cfg, seed=0, device="cuda").requires_grad_(False)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_dec = sum(p.numel() for p in model.decoder.parameters())
    n_all = sum(p.numel() for p in model.parameters())
    resident = storage_bytes(model)
    log(f"moe [{card}]: Qwen3-30B-A3B ({n_dec / 1e9:.3f} B parameters: {dec.num_layers} layers, "
        f"hidden {dec.hidden_size}, {dec.num_heads}/{dec.num_kv_heads} heads of {dec.head_dim}, "
        f"{dec.num_experts} experts of {dec.moe_intermediate_size}, {dec.num_experts_per_tok} "
        f"active, tied head {dec.tie_word_embeddings}, vocab {dec.vocab_size:,}) + NT-v2-500M, "
        f"{n_all / 1e9:.3f} B in all, {dec.dtype} on the card: {resident / 2**30:.2f} GiB "
        f"resident, built in {t_build:.2f} s; torch.cuda.memory_allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    out["build"] = {"params": n_all, "decoder_params": n_dec, "gib": resident / 2**30,
                    "s": t_build}

    items, padded = served_inputs()
    batch = [torch.as_tensor(a, device="cuda") for a in padded]
    b, p = batch[0].shape

    # (b) serve: the micro-batch server, 8 concurrent 2 kb requests twice;
    # the main path, counts from 0 just before and read just after
    server = InferenceServer(model, cfg, processor, max_batch=8, batch_window_ms=500.0,
                             max_new_tokens=MOE_NEW, greedy_default=True)
    server.start()
    calls_out, restore = record_engine_calls(server)
    reset_counts()
    calls0 = server.engine_calls
    try:
        first = burst(server, items, MOE_NEW)
        second = burst(server, items, MOE_NEW)
    finally:
        server.stop()
        restore()
    got = counts()
    calls = server.engine_calls - calls0
    answered = [r for r in first + second if r and set(r) == {"completion", "answer"}]
    # the prefill alone: all of an engine call's launches, so its decode
    # steps launched none
    reset_counts()
    recorder = MoeRecorder(keep_input=True)
    try:
        with torch.inference_mode():
            server.engine.prefill(model, *batch, MOE_NEW)
        torch.cuda.synchronize()
    finally:
        recorder.close()
    prefill_launches = counts()
    st = [s for _, s in calls_out]
    log(f"moe serve [{card}]: {len(answered)} requests answered in {calls} engine calls "
        f"(batches {[s['batch'] for s in st]}), launches {got} = "
        f"{got['flash_fwd'] / max(calls, 1):g} flash_fwd per engine call; one prefill alone "
        f"{prefill_launches}, so 0 in each call's {st[-1]['steps'] - 1} decode steps")
    for name, s in (("first 8", st[0]), ("same 8 again", st[-1])):
        log(f"moe serve [{card}] {name}: B={s['batch']} P={s['prompt_len']}: prefill "
            f"{s['prefill_s'] * 1e3:.1f} ms; decode "
            f"{s['decode_tokens'] / max(s['decode_s'], 1e-9):.1f} tokens/s over "
            f"{s['steps'] - 1} steps ({s['decode_s'] / max(s['steps'] - 1, 1) * 1e3:.2f} ms "
            f"per step)")
    if (len(answered) != 16 or first != second or calls != 2
            or got != {k: per_call * calls if k == "flash_fwd" else 0 for k in got}
            or prefill_launches["flash_fwd"] != per_call):
        fail(f"moe serving: {len(answered)} answered, repeats equal {first == second}, "
             f"launches {got} in {calls} calls, {prefill_launches} in one prefill (expected "
             f"{per_call} flash_fwd per call, all in its prefill)")
    if server.engine.nonfinite_rows:
        fail(f"moe serving: {server.engine.nonfinite_rows} logit rows were not finite")
    per_engine_call = got["flash_fwd"] / calls
    out["serve"] = {"launches": got["flash_fwd"], "calls": calls,
                    "per_engine_call": per_engine_call,
                    "prefill_alone": prefill_launches["flash_fwd"],
                    "per_decode_step": ((per_engine_call - prefill_launches["flash_fwd"])
                                        / (st[-1]["steps"] - 1)),
                    "prefill_ms": [s["prefill_s"] * 1e3 for s in st],
                    "decode_tps": [s["decode_tokens"] / s["decode_s"] for s in st]}

    # (c) drops in the served prefill, by layer; the kernel route against
    # the plain one; one layer in bf16 against fp32
    pad_rows = ~batch[1].bool().reshape(-1)
    drops = moe_drops(torch, recorder.calls, pad_rows)
    if len(drops) != MOE_LAYERS or any(d["n"] != b * p for d in drops):
        fail(f"the served prefill made {len(drops)} MoE calls, not one per layer at N = {b * p}")
    log(f"moe drops [{card}] served prefill (N = {b * p} rows, {int(pad_rows.sum())} of them "
        f"left pads; C = {drops[0]['cap']}): tokens with a dropped choice per layer "
        f"{[d['tokens'] for d in drops]}, of them pads {[d['pad_tokens'] for d in drops]}; "
        f"(token, expert) pairs dropped {sum(d['pairs'] for d in drops)} of "
        f"{MOE_LAYERS * b * p * dec.num_experts_per_tok}")
    out["drops_prefill"] = drops
    out["slots"] = moe_slots_check(torch, card, recorder.calls, dec.num_experts, pad_rows,
                                   recorder.inputs[0][1])
    one = [torch.as_tensor(a, device="cuda")
           for a in prepare_batch(processor, cfg, items[:1])]
    plain_cfg = dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, attention_impl="xla"),
        decoder=dataclasses.replace(dec, attention_impl="xla"))
    reset_counts()
    k_logits = server.engine.prefill(model, *one, MOE_NEW)[0]
    k_launches = counts()["flash_fwd"]
    p_logits = GenerationEngine(plain_cfg, -1).prefill(model, *one, MOE_NEW)[0]
    cos = float(F.cosine_similarity(k_logits, p_logits, dim=-1).min())
    log(f"moe [{card}] kernel vs plain route, one request's last-column prefill logits: "
        f"cosine {cos:.6f} (>= {MOE_ROUTE_COS}), max abs diff "
        f"{float((k_logits - p_logits).abs().max()):.4g} (|logit| max "
        f"{float(p_logits.abs().max()):.3g}), same argmax "
        f"{bool((k_logits.argmax(-1) == p_logits.argmax(-1)).all())}; {k_launches} flash_fwd")
    if cos < MOE_ROUTE_COS or k_launches != per_call or not bool(torch.isfinite(k_logits).all()):
        fail(f"kernel and plain routes disagree on the MoE model (cosine {cos:.4f}, "
             f"{k_launches} launches)")
    moe0, x0, _, _ = recorder.inputs[0]
    out["layer"] = moe_layer_check(torch, card, moe0, x0, cfg)
    del recorder, x0
    torch.cuda.empty_cache()

    # (d) grouped decode: 2 prompts x G = 4, greedy, twice
    engine = GenerationEngine(cfg, eos_token_id=-1)
    two = [torch.as_tensor(a, device="cuda") for a in prepare_batch(processor, cfg, items[:2])]
    reset_counts()
    g1, _ = engine.generate(model, *two, greedy=True, max_new_tokens=MOE_GROUP_NEW, group_size=4)
    g_launches = counts()["flash_fwd"]
    gst = dict(engine.last_stats)
    g2, _ = engine.generate(model, *two, greedy=True, max_new_tokens=MOE_GROUP_NEW, group_size=4)
    same_in_group = all((g1[4 * i: 4 * i + 4] == g1[4 * i]).all() for i in range(2))
    log(f"moe grouped [{card}]: 2 prompts x G=4, {MOE_GROUP_NEW} greedy tokens: completions of "
        f"a prompt equal {same_in_group}, two runs equal {bool((g1 == g2).all())}; "
        f"{g_launches} flash_fwd; prefill {gst['prefill_s'] * 1e3:.1f} ms, decode "
        f"{gst['decode_tokens'] / gst['decode_s']:.1f} tokens/s")
    if not same_in_group or not (g1 == g2).all() or g_launches != per_call:
        fail("the grouped MoE decode's completions differ within a group or between runs")
    out["grouped"] = {"tps": gst["decode_tokens"] / gst["decode_s"]}

    # (e) continuous: the serving bench (`bench_serve.drive`) at 16 slots, 32 requests;
    # each decode window's MoE calls (k steps x 48 layers at its cb rows)
    # marked by wrapping the batcher's window
    from bioreason_tpu_torch.generate import continuous as C
    args = bench_serve.parse_args(["--capacity", "16", "--requests", "32", "--max_new",
                                   str(MOE_BENCH_NEW), "--probe"])
    recorder, marks = MoeRecorder(), []
    real_multi = C.ContinuousBatcher._multi_step

    def multi_step(self, st, k, w, cb, *a, **kw):
        start = len(recorder.calls)
        toks = real_multi(self, st, k, w, cb, *a, **kw)
        marks.append((cb, recorder.calls[start:]))
        return toks
    C.ContinuousBatcher._multi_step = multi_step
    reset_counts()
    try:
        res = bench_serve.drive(model, cfg, args)
    finally:
        recorder.close()
        C.ContinuousBatcher._multi_step = real_multi
    got = counts()
    per_window = [(cb, sum(d["tokens"] for d in moe_drops(torch, calls_)))
                  for cb, calls_ in marks]
    log(f"moe continuous [{card}]: {res['value']:.1f} decoded tokens/s ({res['decoded_tokens']} "
        f"tokens, {res['requests']} requests over {res['capacity']} slots in "
        f"{res['seconds']:.2f} s; admit {res['admit_s']:.2f} s); {res['windows']} windows, "
        f"mean occupancy {res['mean_occupancy']:.3f}; pools {res['pool_gib']:.3f} GiB; "
        f"{res['prefill_calls']} prefill calls, {res['flash_fwd_per_prefill']:g} flash_fwd "
        f"each; rows with a dropped choice per decode window (cb rows: rows dropped, summed "
        f"over its steps and 48 layers) {per_window}; launches with the warmup {got}")
    if got != {k: (per_call * (res["prefill_calls"] + 1) if k == "flash_fwd" else 0)
               for k in got}:
        fail(f"the MoE bench launched {got}: expected {per_call} flash_fwd per prefill chunk "
             f"(and its warmup's one) and nothing else")
    out["continuous"] = {**res, "launches": got["flash_fwd"], "drops_per_window": per_window}
    del recorder
    torch.cuda.empty_cache()

    # (g) the profile of one prefill and one decode step, with the expert
    # products' bound (bf16 storage) from the kept pairs and the experts
    # picked in that prefill and step
    recorder = MoeRecorder()
    try:
        with torch.inference_mode():
            _, cache, cmask = engine.prefill(model, *batch, 2)
            cmask[:, p] = 1
            decoder_forward(model.decoder, dec, input_ids=torch.zeros((b, 1), dtype=torch.int64,
                                                                      device="cuda"),
                            attention_mask=torch.ones((b, 1), dtype=torch.int32,
                                                      device="cuda"),
                            positions=batch[1].sum(-1)[:, None], cache=cache, cache_index=p,
                            cache_mask=cmask)
        torch.cuda.synchronize()
    finally:
        recorder.close()
    del cache
    kept = {}
    for what, calls_ in (("prefill", recorder.calls[:MOE_LAYERS]),
                         ("decode", recorder.calls[MOE_LAYERS:])):
        kept[what] = ([int(c["keep"].sum()) for c in calls_],
                      [int(torch.unique(c["idx"][c["keep"]]).numel()) for c in calls_])
    out["profile_bf16"] = moe_profile(torch, card, model, cfg, batch, "bf16")
    out["bound"] = {"prefill": moe_expert_bound(cfg, b * p, kept["prefill"], "prefill"),
                    "decode": moe_expert_bound(cfg, b, kept["decode"], "decode step")}

    # (f) int8: the bf16 teacher-forced logits first, then the storage
    # quantized in place (both copies at once would need 86 GiB)
    ids_bf, _ = engine.generate(model, *batch, greedy=True, max_new_tokens=MOE_INT8_NEW)
    streams = torch.as_tensor(ids_bf, device="cuda")
    lg_bf = teacher_forced(torch, engine, model, batch, streams)
    kept_banks = {li: {name: getattr(model.decoder.layers[li].mlp.experts, name).weight.clone()
                       for name in ("gate", "up", "down")} for li in MOE_BANK_LAYERS}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serving_storage(model, int8=True)
    torch.cuda.synchronize()
    t_q = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    resident8 = storage_bytes(model)
    lg8 = teacher_forced(torch, engine, model, batch, streams)
    cos = F.cosine_similarity(lg8, lg_bf, dim=-1)
    top = float((lg8.argmax(-1) == lg_bf.argmax(-1)).float().mean())
    steps = moe_bank_steps(torch, model, kept_banks)
    faults = {}
    for name, fault in MOE_BANK_FAULTS.items():
        with moe_bank_scale_fault(torch, model, fault):
            c = F.cosine_similarity(teacher_forced(torch, engine, model, batch, streams), lg_bf,
                                    dim=-1)
            faults[name] = {"cos_min": float(c.min()), "cos_median": float(c.median()),
                            "bank_steps": moe_bank_steps(torch, model, kept_banks)}
    del kept_banks
    reset_counts()
    ids8, _ = engine.generate(model, *batch, greedy=True, max_new_tokens=MOE_INT8_NEW)
    got8 = counts()
    st8 = dict(engine.last_stats)
    log(f"moe int8 [{card}]: quantized in place in {t_q:.2f} s (banks [E, 1, out] scales, "
        f"the router too); resident {resident8 / 2**30:.2f} GiB ({resident8 / resident:.3f} of "
        f"bf16's {resident / 2**30:.2f}); teacher-forced logits against bf16: cosine min "
        f"{float(cos.min()):.6f}, median {float(cos.median()):.6f} over {cos.numel()} (row, "
        f"step) pairs (>= {MOE_INT8_COS_FLOOR}); argmax agreement {top:.3f}; layers "
        f"{list(MOE_BANK_LAYERS)}' banks against their bf16: largest error {steps:.6f} steps "
        f"(<= {MOE_BANK_STEPS}); planted faults of the banks' scales: "
        + "; ".join(f"{k}: cosine min {v['cos_min']:.6f}, median {v['cos_median']:.6f}, "
                    f"largest bank error {v['bank_steps']:.3f} steps (must be over "
                    f"{MOE_BANK_STEPS})" for k, v in faults.items())
        + f"; one engine call "
        f"of {MOE_INT8_NEW} tokens: prefill {st8['prefill_s'] * 1e3:.1f} ms, decode "
        f"{st8['decode_tokens'] / st8['decode_s']:.1f} tokens/s; launches {got8}")
    if (float(cos.min()) < MOE_INT8_COS_FLOOR or not bool(torch.isfinite(lg8).all())
            or got8["flash_fwd"] != per_call or not 0.45 < resident8 / resident < 0.55):
        fail(f"moe int8: cosine {float(cos.min()):.6f}, launches {got8}, resident share "
             f"{resident8 / resident:.3f}")
    if steps > MOE_BANK_STEPS:
        fail(f"the int8 banks are {steps:.6f} quantization steps off their bf16, over "
             f"{MOE_BANK_STEPS}")
    missed = [k for k, v in faults.items() if v["bank_steps"] <= MOE_BANK_STEPS]
    if missed:
        fail(f"the bound of {MOE_BANK_STEPS} steps misses the planted faults {missed}")
    if all(v["cos_min"] >= MOE_INT8_COS_FLOOR for v in faults.values()):
        fail(f"no planted fault of the int8 banks reads under the floor {MOE_INT8_COS_FLOOR}")
    out["int8"] = {"gib": resident8 / 2**30, "cos_min": float(cos.min()),
                   "cos_median": float(cos.median()), "argmax_agree": top,
                   "bank_steps": steps, "faults": faults,
                   "decode_tps": st8["decode_tokens"] / st8["decode_s"],
                   "prefill_ms": st8["prefill_s"] * 1e3}
    del lg8, lg_bf
    out["profile_int8"] = moe_profile(torch, card, model, cfg, batch, "int8")

    # (h) flash_fwd at the MoE prefill's shape: 32 q heads over 4 KV heads,
    # the served left pads, a cache of P + 64
    del model, server, engine
    gc.collect()
    torch.cuda.empty_cache()
    cmask = F.pad(batch[1].to(torch.int32), (0, MOE_NEW))
    rows = [kernel_case(torch, f"moe_prefill_P{p}", b, p, p + MOE_NEW, 32, 4, 128, True, 0,
                        cmask, 171)]
    out["seconds"] = time.perf_counter() - t_phase
    log(f"moe: phase done in {out['seconds']:.1f} s (budget {MOE_BUDGET_S:g})")
    if out["seconds"] > MOE_BUDGET_S:
        fail(f"the moe phase took {out['seconds']:.1f} s, over {MOE_BUDGET_S:g}")
    return out, rows


# -- main ---------------------------------------------------------------------

def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs one CUDA card")
    if not os.path.isdir(os.path.join(REPO, "bioreason_tpu_torch")):
        fail(f"the port's package bioreason_tpu_torch is not beside {__file__}")
    sys.path.insert(0, REPO)

    t_start = time.perf_counter()
    seconds, last = {}, [t_start]

    def mark(name):
        """The script's clock since the previous mark, under `name`."""
        now = time.perf_counter()
        seconds[name] = round(now - last[0], 1)
        last[0] = now
    max_new = 64
    card = phase_device(torch)
    built = phase_build()
    mark("device, build")
    rows, bwd_rows, band_rows = phase_kernels(torch, max_new)
    mark("kernels")
    launches, server, items = phase_serve(torch, card, max_new)
    phase_profile(torch, card, server, items, max_new=8)
    del server
    torch.cuda.empty_cache()
    mark("serve, profile")
    build_dir = os.path.join(REPO, "bioreason_tpu_torch", "build")
    os.makedirs(build_dir, exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="smoke_sft_", dir=build_dir)
    try:
        train = phase_train(torch, card, ckpt)
        torch.cuda.empty_cache()
        mark("train")
        long = phase_train_long(torch, card)
        torch.cuda.empty_cache()
        mark("train-long")
        grpo, grpo_rows, grpo_bwd_rows = phase_grpo(torch, card,
                                                    os.path.join(ckpt, "sft_final"))
        mark("grpo")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    golden_err = phase_evo2_goldens(torch)
    evo2_serve, evo2_batch = phase_evo2_serve(torch, card, max_new)
    torch.cuda.empty_cache()
    evo2_rows, evo2_bwd_rows = evo2_kernel_cases(torch, evo2_batch)
    mark("evo2")
    evo2_train = phase_evo2_train(torch, card)
    torch.cuda.empty_cache()
    mark("evo2-train")
    pretrained = phase_pretrained(torch, card, max_new)
    torch.cuda.empty_cache()
    mark("pretrained")
    continuous, cont_rows = phase_continuous(torch, card)
    mark("continuous")
    classifier, cls_rows, cls_bwd_rows = phase_classifier(torch, card)
    torch.cuda.empty_cache()
    mark("classifier")
    int8, int8_rows = phase_int8(torch, card)
    torch.cuda.empty_cache()
    mark("int8")
    qlora, qlora_rows, qlora_bwd_rows = phase_qlora(torch, card)
    torch.cuda.empty_cache()
    mark("qlora")
    reh, reh_rows, reh_bwd_rows = phase_rehearsal(torch, card)
    mark("rehearsal")
    moe, moe_rows = phase_moe(torch, card)
    mark("moe")
    log(f"chip_smoke: seconds of the script's clock by phase {seconds}")
    log(f"chip_smoke: all phases done in {time.perf_counter() - t_start:.1f} s")

    rows += (grpo_rows + evo2_rows + cont_rows + cls_rows + int8_rows + qlora_rows + reh_rows
             + moe_rows)
    bwd_rows += grpo_bwd_rows + evo2_bwd_rows + cls_bwd_rows + qlora_bwd_rows + reh_bwd_rows
    qlora_launches = {"sft_int8": qlora["sft"]["int8"]["launches"],
                      "sft_bfloat16": qlora["sft"]["bfloat16"]["launches"],
                      "grpo_int8": qlora["grpo"]["launches"],
                      "rollout": {k: v["launches"] for k, v in qlora["rollout"].items()}}
    evo2_launches = {"serve": evo2_serve["flash_fwd"],
                     **{mode: evo2_train[mode]["launches"]
                        for mode in ("frozen", "finetune", "trainer")}}
    # the served prefill: the kernel's largest call
    served = next(r for r in rows if r["shape"].startswith("prefill_served"))
    fwd_entry = {"name": "flash_fwd", "route": "cuda",
                 "source": "bioreason_tpu_torch/csrc/flash_fwd.cu",
                 "replaces": "bioreason_tpu/ops/flash_attention.py:60",
                 "also_replaces": ["bioreason_tpu/ops/flash_attention.py:239"],
                 "launches": launches, "train_launches": train["fwd_launches"],
                 "long_launches": long["flash_fwd"], "grpo_launches": grpo["flash_fwd"],
                 "evo2_launches": {k: v if isinstance(v, int) else v["flash_fwd"]
                                   for k, v in evo2_launches.items()},
                 "pretrained_launches": {"sft": pretrained["sft"]["launches"]["flash_fwd"],
                                         "reason": pretrained["grpo"]["launches"]["flash_fwd"],
                                         "serve": pretrained["serve"]["launches"]},
                 "continuous_launches": {
                     "bench": continuous["bench"]["launches"],
                     "bench_prefill_chunks": continuous["bench"]["prefill_calls"] + 1,
                     "per_prefill_chunk": ENCODER_LAYERS + DECODER_LAYERS,
                     "per_decode_window": 0},
                 "classifier_launches": {
                     "frozen_bench": classifier["frozen"]["launches"],
                     "frozen_bench_steps": classifier["frozen"]["steps"],
                     "finetune": classifier["finetune"]["launches"]["flash_fwd"],
                     "finetune_remat_step": classifier["finetune"]["remat_launches"]["flash_fwd"],
                     "cli": classifier["cli"]["launches"]["flash_fwd"]},
                 "int8_launches": {
                     "serve_all_flags": int8["serve"]["launches"],
                     "serve_engine_calls": int8["serve"]["calls"],
                     "bench_int8": int8["bench"]["int8"]["launches"],
                     "bench_all_flags": int8["bench"]["all"]["launches"]},
                 "qlora_launches": {
                     "sft_int8": qlora_launches["sft_int8"]["flash_fwd"],
                     "sft_bfloat16": qlora_launches["sft_bfloat16"]["flash_fwd"],
                     "grpo_int8": qlora_launches["grpo_int8"]["flash_fwd"],
                     "rollout": qlora_launches["rollout"]},
                 "rehearsal_launches": {"total": reh["a"]["launches"].get("flash_fwd", 0),
                                        "calls": reh["a"]["calls"],
                                        "per_call": {k: sorted({d.get("flash_fwd", 0) for d in v})
                                                     for k, v in reh["a"]["per_call"].items()}},
                 "moe_launches": {"serve": moe["serve"]["launches"],
                                  "serve_engine_calls": moe["serve"]["calls"],
                                  "per_engine_call": moe["serve"]["per_engine_call"],
                                  "prefill_alone": moe["serve"]["prefill_alone"],
                                  "per_decode_step": moe["serve"]["per_decode_step"],
                                  "bench": moe["continuous"]["launches"]},
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
                 "grpo_launches": grpo["flash_bwd"],
                 "evo2_launches": {k: v["flash_bwd"] for k, v in evo2_launches.items()
                                   if not isinstance(v, int)},
                 "pretrained_launches": {"sft": pretrained["sft"]["launches"]["flash_bwd"],
                                         "reason": pretrained["grpo"]["launches"]["flash_bwd"]},
                 "classifier_launches": {
                     "finetune": classifier["finetune"]["launches"]["flash_bwd"],
                     "finetune_remat_step": classifier["finetune"]["remat_launches"]["flash_bwd"]},
                 "qlora_launches": {
                     "sft_int8": qlora_launches["sft_int8"]["flash_bwd"],
                     "sft_bfloat16": qlora_launches["sft_bfloat16"]["flash_bwd"],
                     "grpo_int8": qlora_launches["grpo_int8"]["flash_bwd"]},
                 "rehearsal_launches": {"total": reh["a"]["launches"].get("flash_bwd", 0),
                                        "per_call": {k: sorted({d.get("flash_bwd", 0) for d in v})
                                                     for k, v in reh["a"]["per_call"].items()}},
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
            "library_ms": at["library_ms"], "at_shape": at["shape"],
            "build": {fn: r for fn, r in built.items() if f"local_{kind}_kernel" in fn},
            "shapes": mine})
    log(f"evo2 goldens: largest error on the card {golden_err:.3g}")
    log(json.dumps({"kernels": [fwd_entry, bwd_entry, *local_entries]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
