"""Inference serving: HTTP server over the generation engine (the port of
bioreason_tpu/serve.py).

Two modes:
  * window micro-batching (the default): concurrent requests arriving
    within `batch_window_ms` are padded into one batch (prompt width
    bucketed to 128) and generated in one engine call per guided pattern;
  * continuous batching (`--continuous`): the slot scheduler of
    generate/continuous.py; requests join the running decode at token
    boundaries and short completions free their slot at once. `--tiers
    CAPxLEN,...` builds one batcher per KV depth class and routes each
    request to the shallowest class its prompt fits; `--decode_window k`
    decodes k tokens per host round trip.

`--guided_regex` constrains every completion to a regex
(generate/guided.py); micro-batch mode also takes a per-request
"guided_regex" (requests are grouped by pattern per batch), continuous mode
only the server's own.

Endpoints:
  POST /generate  {"question": str, "reference_sequence": str,
                   "variant_sequence": str, "max_new_tokens"?: int,
                   "greedy"?: bool, "guided_regex"?: str}
              ->  {"completion": str, "answer": str}
  GET  /healthz ->  {"status": "ok"}

Run (on the card; `--device cpu` for the CPU):
  python -m bioreason_tpu_torch.serve --decoder tiny --encoder tiny --port 8787
With the Evo2 DNA tower (byte tokens, 2048 per sequence at 2 kb):
  python -m bioreason_tpu_torch.serve --encoder evo2-1b
A trained model (the port's `sft_final` of `train_sft`: its base built
again from what it records, seeded or pretrained HF directories with
their tokenizers, and its LoRA merged into the frozen weights):
  python -m bioreason_tpu_torch.serve --checkpoint checkpoints/sft_final
Continuous batching over two depth classes, every answer constrained:
  python -m bioreason_tpu_torch.serve --continuous --tiers 8x512,8x1024 \
      --decode_window 8 --guided_regex '<answer>(yes|no)</answer>'

Serving storage, applied in the JAX server's order (serve.py:430-441): a
checkpoint's LoRA merged, then `--int8` (every dense of both towers, the
embedding and the head int8 with per-channel scales, train/quant.py), then
`--fuse` (q/k/v and gate/up fused, train/fuse.py); `--w8a8` (needs
`--int8`) quantizes the activations of the denses per token too (the
continuous batcher's decode windows stay weight-only, as in the JAX
package), and `--kv_int8` stores the KV cache and the continuous pools int8:
  python -m bioreason_tpu_torch.serve --int8 --kv_int8 --fuse --w8a8
"""

from __future__ import annotations

import dataclasses
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from bioreason_tpu_torch.cli.common import (DECODER_PRESETS, ENCODER_PRESETS, HYENA_PRESETS,
                                            build_encoder_config)
from bioreason_tpu_torch.config import FusionConfig, SamplingConfig
from bioreason_tpu_torch.data.chat_template import render_chat
from bioreason_tpu_torch.data.kegg import format_kegg_prompt_only
from bioreason_tpu_torch.data.processor import BioProcessor
from bioreason_tpu_torch.data.text_tokenizer import ByteTextTokenizer
from bioreason_tpu_torch.generate.engine import GenerationEngine
from bioreason_tpu_torch.models.fusion import FusionModel, init_fusion
from bioreason_tpu_torch.train.rewards import extract_answer

def _bucket(n: int, multiple: int = 128) -> int:
    return ((max(n, 1) + multiple - 1) // multiple) * multiple


def _parse_tiers(spec: Optional[str]):
    """'96x640,40x2048' -> [(96, 640), (40, 2048)], sorted by depth.

    KV depth classes for continuous serving: each class is a
    ContinuousBatcher pool of `cap` slots x `len` prompt tokens; requests
    route to the shallowest class that fits. Pool memory scales with
    sum(cap_i * (len_i + max_new)) instead of C * (P_max + max_new)."""
    if not spec:
        return None
    tiers = []
    for part in spec.split(","):
        cap, _, mlen = part.strip().partition("x")
        tiers.append((int(cap), int(mlen)))
    if not tiers:
        return None
    return sorted(tiers, key=lambda t: t[1])


def prepare_batch(processor: BioProcessor, cfg: FusionConfig, items: List[Dict[str, Any]]):
    """KEGG items -> the engine's numpy inputs (input_ids, attention_mask,
    dna_input_ids, dna_attention_mask): prompt-only chat rendering, the
    bi-modal processor with left padding, and the width bucketed to 128 so
    prompt shapes repeat (serve.py:263-281)."""
    examples = [format_kegg_prompt_only(it) for it in items]
    out = processor(
        text=[render_chat(ex["prompt"], add_generation_prompt=True) for ex in examples],
        batch_dna_sequences=[ex["dna_sequences"] for ex in examples],
        max_length_text=cfg.max_length_text, max_length_dna=cfg.max_length_dna,
        padding_side="left")
    input_ids, attention_mask = out.input_ids, out.attention_mask
    pad = _bucket(input_ids.shape[1]) - input_ids.shape[1]
    if pad:
        input_ids = np.pad(input_ids, ((0, 0), (pad, 0)),
                           constant_values=processor.text_tokenizer.pad_token_id)
        attention_mask = np.pad(attention_mask, ((0, 0), (pad, 0)))
    return input_ids, attention_mask, out.dna_input_ids, out.dna_attention_mask


def prepare_request(processor: BioProcessor, cfg: FusionConfig, item: Dict[str, Any]):
    """One KEGG item -> the continuous batcher's numpy inputs (input_ids,
    attention_mask [1, n], dna_input_ids, dna_attention_mask): the
    prompt-only chat rendering through the bi-modal processor, unpadded
    (the batcher buckets and left-pads at admission; serve.py:183-214)."""
    ex = format_kegg_prompt_only(item)
    out = processor(text=[render_chat(ex["prompt"], add_generation_prompt=True)],
                    batch_dna_sequences=[ex["dna_sequences"]],
                    max_length_text=cfg.max_length_text, max_length_dna=cfg.max_length_dna,
                    padding_side="left")
    return out.input_ids, out.attention_mask, out.dna_input_ids, out.dna_attention_mask


class InferenceServer:
    def __init__(self, model: FusionModel, fusion_cfg: FusionConfig,
                 processor: BioProcessor,
                 sampling: SamplingConfig = SamplingConfig(),
                 max_batch: int = 8, batch_window_ms: float = 20.0,
                 max_new_tokens: int = 256, greedy_default: bool = False,
                 device=None, seed: int = 0, continuous: bool = False,
                 slot_len: int = 2048, guided_regex: Optional[str] = None,
                 kv_int8: bool = False, decode_window: int = 1,
                 tiers: Optional[str] = None):
        """`device`: CUDA unless the caller passes "cpu"; `model` must live
        there. Sampled (non-greedy) batches draw from a generator seeded with
        `seed` plus the batch count.

        `continuous=True` serves through the slot scheduler
        (generate/continuous.py): `max_batch` slots of `slot_len` prompt
        tokens and `max_new_tokens` decode columns, or one pool per class of
        `tiers` ("CAPxLEN,CAPxLEN,..."), `decode_window` tokens per host
        round trip. `guided_regex`: a pattern every completion must match
        (generate/guided.py). `kv_int8`: the engine's KV cache and every
        tier's pools int8 with per-(token, head) scales."""
        self.model = model
        self.kv_int8 = kv_int8
        self.cfg = fusion_cfg
        self.processor = processor
        self.sampling = sampling
        self.max_batch = max_batch
        self.batch_window_s = batch_window_ms / 1000.0
        self.max_new_tokens = max_new_tokens
        self.greedy_default = greedy_default
        self.seed = seed
        self.continuous = continuous
        self.slot_len = slot_len
        self.tiers = _parse_tiers(tiers)
        # decode steps per host round trip in continuous mode: > 1 spreads
        # the host's scheduling over k tokens, at up to k - 1 steps of
        # admission latency for queued requests
        self.decode_window = max(1, decode_window)
        self.engine = GenerationEngine(
            fusion_cfg, eos_token_id=processor.text_tokenizer.eos_token_id,
            device=device, kv_int8=kv_int8)
        self.engine_calls = 0
        self.guided_regex = guided_regex
        self._guided_cache: Dict[str, Any] = {}
        # continuous mode: the batchers (one per depth class, built by the
        # worker) and the requests routed to each
        self.batchers: List[Any] = []
        self.routed: List[int] = []
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(
            target=self._continuous_loop if continuous else self._batch_loop, daemon=True)

    # -- batching worker ------------------------------------------------

    def start(self):
        self._worker.start()
        return self

    def stop(self):
        self._stop.set()
        self._worker.join(timeout=5)

    def _batch_loop(self):
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.batch_window_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                self._run_batch(batch)
            except Exception as e:      # fail this batch's requests, keep serving
                for req in batch:
                    req["error"] = f"{type(e).__name__}: {e}"
                    req["event"].set()

    def _continuous_loop(self):
        from bioreason_tpu_torch.generate.continuous import ContinuousBatcher, Request
        tok = self.processor.text_tokenizer
        cbs = [ContinuousBatcher(self.model, self.cfg, eos_token_id=tok.eos_token_id,
                                 capacity=cap, max_len=mlen, max_new=self.max_new_tokens,
                                 sampling=self.sampling, guided=self._spec_for(self.guided_regex),
                                 kv_int8=self.kv_int8, device=self.engine.device,
                                 seed=self.seed + i)
               for i, (cap, mlen) in enumerate(self.tiers or [(self.max_batch, self.slot_len)])]
        # the decode window is hit at once and shared by every request;
        # admission shapes depend on the prompts and warm up on first use
        for cb in cbs:
            cb.warmup([], windows=(self.decode_window,))
        self.batchers = cbs
        self.routed = [0] * len(cbs)
        pending: Dict[int, List[Any]] = {i: [] for i in range(len(cbs))}
        rid = 0
        by_rid: Dict[int, Dict[str, Any]] = {}

        def route(r) -> int:
            """Shallowest depth class whose prompt pool fits this prompt's
            bucketed width."""
            plen = r.input_ids.shape[1]
            for i, cb in enumerate(cbs):
                if cb._bucketed(plen) <= cb.max_len:
                    return i
            raise ValueError(f"prompt length {plen} exceeds every tier "
                             f"({[cb.max_len for cb in cbs]})")

        def to_request(req: Dict[str, Any]):
            """(the tier's index, the batcher's Request) of a queued request."""
            nonlocal rid
            if req.get("guided_regex") and req["guided_regex"] != self.guided_regex:
                raise ValueError(
                    "continuous mode supports a server-level --guided_regex only (the "
                    "slots share one table); use micro-batch mode for per-request patterns")
            r = Request(rid + 1, *prepare_request(self.processor, self.cfg, req["item"]),
                        max_new_tokens=min(req.get("max_new_tokens") or self.max_new_tokens,
                                           self.max_new_tokens),
                        greedy=req.get("greedy", self.greedy_default))
            i = route(r)
            rid += 1
            by_rid[rid] = req
            return i, r

        def deliver(r):
            req = by_rid.pop(r.rid)
            text = tok.decode(list(r.tokens), skip_special_tokens=True)
            req["result"] = {"completion": text, "answer": extract_answer(text)}
            req["event"].set()

        while not self._stop.is_set():
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                try:
                    i, r = to_request(req)
                except Exception as e:       # a bad request: fail it, keep serving
                    req["error"] = f"{type(e).__name__}: {e}"
                    req["event"].set()
                    continue
                pending[i].append(r)
                self.routed[i] += 1
            try:
                for i, cb in enumerate(cbs):
                    for r in cb.admit_many(pending[i]):   # shape-grouped prefill
                        if r.done:
                            deliver(r)
                    if cb.active.any():
                        for r in cb.step_window(self.decode_window):
                            deliver(r)
            except Exception as e:       # fail every request in flight, keep serving
                for req in by_rid.values():
                    req["error"] = f"{type(e).__name__}: {e}"
                    req["event"].set()
                by_rid.clear()
                for lst in pending.values():
                    lst.clear()
            if not any(cb.active.any() for cb in cbs) and not any(pending.values()):
                time.sleep(0.005)

    def _spec_for(self, pattern: Optional[str]):
        """The guided spec of `pattern` on the serving device, as wide as the
        decoder's head; compiled once per pattern."""
        if not pattern:
            return None
        if pattern not in self._guided_cache:
            from bioreason_tpu_torch.generate.guided import guided_spec_for
            self._guided_cache[pattern] = guided_spec_for(
                self.processor.text_tokenizer, pattern,
                vocab_size=self.cfg.decoder.vocab_size, device=self.engine.device)
        return self._guided_cache[pattern]

    def _run_batch(self, reqs: List[Dict[str, Any]]):
        # one engine call per distinct constraint pattern (usually one group)
        by_regex: Dict[Optional[str], List[Dict[str, Any]]] = {}
        for r in reqs:
            by_regex.setdefault(r.get("guided_regex") or self.guided_regex, []).append(r)
        for pattern, group in by_regex.items():
            self._run_group(group, self._spec_for(pattern))

    def _run_group(self, reqs: List[Dict[str, Any]], guided=None):
        input_ids, attention_mask, dna_ids, dna_mask = prepare_batch(
            self.processor, self.cfg, [r["item"] for r in reqs])
        mnt = max(r.get("max_new_tokens") or self.max_new_tokens for r in reqs)
        greedy = all(r.get("greedy", self.greedy_default) for r in reqs)
        self.engine_calls += 1
        gen = torch.Generator(device=self.engine.device).manual_seed(
            self.seed + self.engine_calls)
        ids, mask = self.engine.generate(
            self.model, input_ids, attention_mask, dna_ids, dna_mask,
            sampling=self.sampling, max_new_tokens=mnt, greedy=greedy, generator=gen,
            guided=guided)
        tok = self.processor.text_tokenizer
        for i, req in enumerate(reqs):
            text = tok.decode(ids[i][mask[i].astype(bool)], skip_special_tokens=True)
            req["result"] = {"completion": text, "answer": extract_answer(text)}
            req["event"].set()

    # -- public sync API (used by the HTTP handler and tests) ------------

    def generate(self, item: Dict[str, Any], max_new_tokens: Optional[int] = None,
                 greedy: Optional[bool] = None, timeout: float = 600.0,
                 guided_regex: Optional[str] = None) -> Dict[str, str]:
        req = {"item": item, "max_new_tokens": max_new_tokens,
               "greedy": self.greedy_default if greedy is None else greedy,
               "guided_regex": guided_regex, "event": threading.Event()}
        self._queue.put(req)
        if not req["event"].wait(timeout):
            raise TimeoutError("generation timed out")
        if "error" in req:
            raise RuntimeError(req["error"])
        return req["result"]


def make_http_server(server: InferenceServer, port: int = 8787,
                     host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """`port=0` binds an ephemeral port (read it from `server_address`)."""
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):                       # quiet
            pass

        def _send(self, code: int, payload: Dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok"})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length))
                item = {
                    "question": payload["question"],
                    "reference_sequence": payload.get("reference_sequence", ""),
                    "variant_sequence": payload.get("variant_sequence", ""),
                    "answer": "",
                }
                result = server.generate(item,
                                         max_new_tokens=payload.get("max_new_tokens"),
                                         greedy=payload.get("greedy"),
                                         guided_regex=payload.get("guided_regex"))
                self._send(200, result)
            except Exception as e:
                self._send(400, {"error": str(e)})

    return ThreadingHTTPServer((host, port), Handler)


def build_config(decoder: str = "qwen3-0.6b", encoder: str = "nt-500m",
                 max_length_dna: int = 2048):
    """(FusionConfig, BioProcessor) of a preset pair, with the byte text
    tokenizer and the DNA tower's tokenizer (k-mers for NT, bytes for Evo2;
    `cli.common.build_encoder_config`)."""
    tok = ByteTextTokenizer()
    kind, enc, hyena, dna_tok = build_encoder_config(encoder)
    cfg = FusionConfig(decoder=DECODER_PRESETS[decoder](), encoder=enc, hyena=hyena,
                       encoder_kind=kind, dna_pad_token_id=tok.dna_pad_id,
                       max_length_dna=max_length_dna)
    return cfg, BioProcessor(tok, dna_tok)


def serving_storage(model: FusionModel, int8: bool = False, fuse: bool = False) -> FusionModel:
    """The JAX server's order (serve.py:437-441): `int8` quantizes every
    dense of both towers with the embedding and the head
    (`quantize_frozen_int8(include_embed=True)`), then `fuse` fuses q/k/v
    and gate/up. In place; returns the model."""
    if int8:
        from bioreason_tpu_torch.train.quant import quantize_frozen_int8
        quantize_frozen_int8(model, include_embed=True)
    if fuse:
        from bioreason_tpu_torch.train.fuse import fuse_projections
        fuse_projections(model)
    return model


def build_server(decoder: str = "qwen3-0.6b", encoder: str = "nt-500m",
                 max_length_dna: int = 2048, seed: int = 0, device=None,
                 checkpoint: Optional[str] = None, int8: bool = False, fuse: bool = False,
                 w8a8: bool = False, **server_kw) -> InferenceServer:
    """Server over the SFT model of `checkpoint` (the port's `sft_final`:
    `train.checkpoint.rebuild_sft` builds its recorded base with its
    tokenizers, and its LoRA is merged into the frozen weights, or kept
    beside them over a QLoRA base's int8 weights; the presets are not read
    then), else over the presets' weights drawn from `seed`;
    then `serving_storage` (`int8`, `fuse`). `w8a8` (act_int8 on both
    towers) needs `int8`."""
    if w8a8 and not int8:
        raise ValueError("--w8a8 requires --int8 (act_int8 needs int8 kernels)")
    if checkpoint:
        from bioreason_tpu_torch.train.checkpoint import rebuild_sft
        from bioreason_tpu_torch.train.lora import merge_lora
        cfg, model, tok, dna_tok = rebuild_sft(checkpoint, device, max_length_dna=max_length_dna)
        if not any(b.dtype == torch.int8 for b in model.buffers()):
            model = merge_lora(model)
        model.requires_grad_(False)
        processor = BioProcessor(tok, dna_tok)
    else:
        cfg, processor = build_config(decoder, encoder, max_length_dna)
        model = init_fusion(cfg, seed=seed, device=device)
    if w8a8:
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, act_int8=True),
                                  encoder=dataclasses.replace(cfg.encoder, act_int8=True))
    serving_storage(model, int8, fuse)
    return InferenceServer(model, cfg, processor, device=device, seed=seed, **server_kw)


def parse_args(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--decoder", default="qwen3-0.6b", choices=sorted(DECODER_PRESETS))
    p.add_argument("--encoder", default="nt-500m",
                   choices=sorted(ENCODER_PRESETS) + sorted(HYENA_PRESETS))
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--max_new_tokens", type=int, default=256)
    p.add_argument("--max_length_dna", type=int, default=2048)
    p.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    p.add_argument("--checkpoint", default=None,
                   help="the port's sft_final (or sft_state) directory to serve")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--continuous", action="store_true",
                   help="vLLM-style continuous batching (slot scheduler) instead of "
                        "window micro-batching")
    p.add_argument("--slot_len", type=int, default=2048,
                   help="per-slot prompt KV length (continuous mode)")
    p.add_argument("--tiers", default=None,
                   help="continuous-mode KV depth classes 'CAPxLEN,CAPxLEN' (e.g. "
                        "'96x640,40x2048'): one slot pool per class, each request routed "
                        "to the shallowest that fits")
    p.add_argument("--decode_window", type=int, default=1,
                   help="continuous mode: decode steps per host round trip")
    p.add_argument("--guided_regex", default=None,
                   help="constrain every completion to match this regex (per-request "
                        "'guided_regex' also accepted in micro-batch mode)")
    p.add_argument("--int8", action="store_true",
                   help="int8 weights with per-channel scales for both towers, the "
                        "embedding and the head (train/quant.py)")
    p.add_argument("--kv_int8", action="store_true",
                   help="int8 KV cache and continuous pools, per-(token, head) scales")
    p.add_argument("--fuse", action="store_true",
                   help="fused qkv / gateup projections (train/fuse.py)")
    p.add_argument("--w8a8", action="store_true",
                   help="int8 activations on top of --int8 weights (cfg.act_int8): prefill "
                        "denses take an int8 x int8 product; continuous decode windows stay "
                        "weight-only int8")
    args = p.parse_args(argv)
    if args.w8a8 and not args.int8:
        p.error("--w8a8 requires --int8 (act_int8 needs int8 kernels)")
    return args


def server_from_args(args) -> InferenceServer:
    """The `InferenceServer` that `main` serves for `parse_args`' args,
    unstarted."""
    return build_server(args.decoder, args.encoder, args.max_length_dna, args.seed,
                        args.device, args.checkpoint, int8=args.int8, fuse=args.fuse,
                        w8a8=args.w8a8, max_batch=args.max_batch,
                        max_new_tokens=args.max_new_tokens, continuous=args.continuous,
                        slot_len=args.slot_len, tiers=args.tiers,
                        guided_regex=args.guided_regex, kv_int8=args.kv_int8,
                        decode_window=args.decode_window)


def main(argv=None):
    args = parse_args(argv)
    server = server_from_args(args).start()
    httpd = make_http_server(server, args.port)
    print(f"serving on :{args.port} (POST /generate, GET /healthz)")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
