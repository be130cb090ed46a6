"""KV-cached generation engine: prefill + a decode loop of one token per step
(the port of bioreason_tpu/generate/engine.py).

* prefill embeds the left-padded prompt, DNA splice included, and fills a
  per-layer KV cache of P + max_new slots in one batched pass (the flash
  kernel on the card: causal, q_offset 0, over the whole cache width);
* decode runs one token per step through the grouped plain attention over
  the cache, samples, writes the cache in place, and stops early once every
  row has emitted EOS;
* like the reference path, it returns COMPLETION ids only;
* with `group_size` G > 1 (GRPO rollouts) each prompt is prefilled ONCE
  into a cache of P slots, and its G completions decode against that shared
  prompt cache plus a per-completion cache of decode slots
  (`qwen3.decoder_decode_step_grouped`); output rows are group-contiguous.

The JAX engine jits prefill and a `lax.while_loop`; here PyTorch runs
eagerly and the loop is a Python loop whose exit test is the one host sync
per step. With `guided` (generate/guided.py) each row carries a DFA state on
the device: its logits are masked before sampling and the state advances
after, frozen once the row has finished. With `kv_int8` the cache is int8
with per-(token, head) scales: the prefill writes it and attends over its
own float K/V (flash_fwd on the card), decode steps read it with the scales
on the logits and probabilities; grouped, both the shared prompt cache and
the per-completion decode cache are int8.

Under a mesh (`run`, a `parallel.trainer.MeshRun`) the engine is one rank
of it and runs on the model as the run shards it: the fsdp pieces are
gathered whole once for the call (`MeshRun.scope(whole=True)`), and freed
when it returns. This is the one place the port gathers the whole model:
the trainers gather one layer at a time (`partition.layer_gathered`), as
JAX's layer scan does, but here that would be one all-gather of every
layer per decoded token (a jitted JAX scan pays it; this engine does not
copy it). The decoder's tensor-parallel
layers stay on this rank's heads, so the prefill, the ungrouped and the
grouped decode all run on Hq/m and Hkv/m heads with caches of Hkv/m heads
(`partition.local_heads`; every head where they do not divide); the NT
encoder's layers run on num_heads / m heads and I / m MLP rows where the
run splits the tower (`partition.encoder_local_heads`), and the
projection, the embedding and the head stay replicated. The
rows are the caller's: a trainer gives each rank its rows of data x fsdp,
and the model ranks of one data index give the same rows. Every model rank
samples from its own generator (the model ranks of one data index seed
theirs alike, so they stay in step), then takes model rank 0's ids, one
broadcast of [B] ids over 'model' per step: the ranks' tokens are equal
without relying on bitwise-equal logits after the all-reduce.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bioreason_tpu_torch.config import FusionConfig, SamplingConfig
from bioreason_tpu_torch.generate import guided as G
from bioreason_tpu_torch.models import layers as L
from bioreason_tpu_torch.models.fusion import FusionModel, fused_input_embeddings
from bioreason_tpu_torch.models.qwen3 import (decoder_decode_step_grouped, decoder_forward,
                                              init_cache)
from bioreason_tpu_torch.ops.sampling import completion_mask_from_eos, sample_logits
from bioreason_tpu_torch.parallel import comm
from bioreason_tpu_torch.parallel.partition import local_heads
from bioreason_tpu_torch.utils.devices import resolve_device, torch_dtype


class GenerationEngine:
    def __init__(self, fusion_cfg: FusionConfig, eos_token_id: int,
                 pad_token_id: Optional[int] = None, device=None, kv_int8: bool = False,
                 run=None):
        """Runs on `device`: CUDA unless the caller passes "cpu". `kv_int8`:
        store the KV cache int8 with per-(token, head) scales (JAX
        engine.py:37-50). `run`: generate as one rank of its mesh, on the
        model's shards (module docstring); None: one device."""
        if run is not None and run.pp:
            raise ValueError("the engine does not run on GPipe stages: a rank holds only "
                             "its stage's layers")
        self.run = run
        self.kv_heads = local_heads(fusion_cfg.decoder, run)[1]
        self.cfg = fusion_cfg
        self.kv_int8 = kv_int8
        self.eos_token_id = eos_token_id
        self.pad_token_id = pad_token_id if pad_token_id is not None else eos_token_id
        self.device = resolve_device(device)
        # per-call host timings and counts of the last `generate`, and the
        # number of logit rows that were not finite over all calls
        self.last_stats: Dict[str, float] = {}
        self.nonfinite_rows = 0

    def _put(self, arr) -> Optional[torch.Tensor]:
        if arr is None:
            return None
        return torch.as_tensor(arr, device=self.device)

    def _scope(self, model: FusionModel):
        """Under a run, `MeshRun.scope_unsplit` over `model`, its fsdp shards
        gathered whole for the call (module docstring): each rank's rows
        are its own."""
        return (contextlib.nullcontext() if self.run is None
                else self.run.scope_unsplit(model, whole=True))

    @torch.inference_mode()
    def prefill(self, model: FusionModel, input_ids, attention_mask,
                dna_input_ids=None, dna_attention_mask=None, max_new_tokens: int = 0
                ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]], torch.Tensor]:
        """Embed, splice and prefill a cache of P + max_new_tokens slots.

        Returns (fp32 logits [B, V] at the last prompt column, the cache,
        the cache mask [B, P + max_new_tokens] with the prompt's slots set).
        Prompts are LEFT-padded, so the last column is every row's last real
        token (engine.py:96-97)."""
        with self._scope(model):
            return self._prefill(model, input_ids, attention_mask, dna_input_ids,
                                 dna_attention_mask, max_new_tokens)

    def _prefill(self, model, input_ids, attention_mask, dna_input_ids, dna_attention_mask,
                 max_new_tokens):
        cfg = self.cfg.decoder
        b, p = input_ids.shape
        embeds = fused_input_embeddings(model, self.cfg, input_ids,
                                        dna_input_ids, dna_attention_mask)
        cache = init_cache(cfg, b, p + max_new_tokens, torch_dtype(cfg.dtype), self.device,
                           quantize=self.kv_int8, num_kv_heads=self.kv_heads)
        cache_mask = F.pad(attention_mask.to(torch.int32), (0, max_new_tokens))
        hidden, cache = decoder_forward(
            model.decoder, cfg, inputs_embeds=embeds, attention_mask=attention_mask,
            positions=L.positions_from_mask(attention_mask), cache=cache,
            cache_index=0, cache_mask=cache_mask, return_hidden=True)
        # the head runs on the last column only: [B, P, V] fp32 logits would
        # be gigabytes at a 151936-token vocab
        return L.lm_logits(model.decoder, hidden[:, -1]), cache, cache_mask

    @torch.inference_mode()
    def generate(self, model: FusionModel, input_ids, attention_mask,
                 dna_input_ids=None, dna_attention_mask=None,
                 sampling: SamplingConfig = SamplingConfig(),
                 max_new_tokens: Optional[int] = None, greedy: bool = False,
                 generator: Optional[torch.Generator] = None, group_size: int = 1,
                 guided: Optional[G.GuidedSpec] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (completion_ids [B*G, max_new], completion_mask [B*G,
        max_new]) as numpy int arrays, G = `group_size`; ids after the first
        EOS are the pad id. With G > 1 each input row is one GRPO prompt,
        prefilled once, whose G completions fill rows g*G .. g*G + G - 1.

        `guided`: regex-constrained decoding (engine.py:123-146); every
        completion matches the pattern, or is a prefix of a match where
        max_new_tokens ends it first. Its tables must be on this device.

        Under a run every model rank returns model rank 0's ids (module
        docstring)."""
        with self._scope(model):
            return self._generate(model, input_ids, attention_mask, dna_input_ids,
                                  dna_attention_mask, sampling, max_new_tokens, greedy,
                                  generator, group_size, guided)

    def _generate(self, model, input_ids, attention_mask, dna_input_ids, dna_attention_mask,
                  sampling, max_new_tokens, greedy, generator, group_size, guided):
        mnt = max_new_tokens if max_new_tokens is not None else sampling.max_new_tokens
        cfg = self.cfg.decoder
        input_ids, attention_mask = self._put(input_ids), self._put(attention_mask)
        dna_input_ids, dna_attention_mask = self._put(dna_input_ids), self._put(dna_attention_mask)
        b, p = input_ids.shape
        grouped = group_size > 1
        bg = b * group_size

        bad = torch.zeros((), dtype=torch.int64, device=self.device)

        gstate = torch.zeros((bg,), dtype=torch.int32, device=self.device)

        def sample(logits):
            bad.add_((~torch.isfinite(logits).all(-1)).sum())
            if guided is not None:
                logits = G.mask_logits(logits, gstate, guided)
            tok = sample_logits(logits, sampling.temperature, sampling.top_k,
                                sampling.top_p, greedy, generator)
            return tok if self.run is None else comm.broadcast(tok, self.run.topo.model, 0)

        def advance(tok, done_prev=None):
            """The rows' next DFA states; frozen where `done_prev`."""
            if guided is None:
                return gstate
            nxt = G.advance(gstate, tok, guided)
            return nxt if done_prev is None else torch.where(done_prev, gstate, nxt)

        t0 = time.perf_counter()
        # grouped: the prompt cache holds the P prompt slots only; the decode
        # slots live per completion in `dec_cache`
        last_logits, cache, cache_mask = self._prefill(
            model, input_ids, attention_mask, dna_input_ids, dna_attention_mask,
            0 if grouped else mnt)
        prompt_lens = attention_mask.sum(-1)
        if grouped:
            last_logits = last_logits.repeat_interleave(group_size, dim=0)
            prompt_lens = prompt_lens.repeat_interleave(group_size)
            dec_cache = init_cache(cfg, bg, mnt, torch_dtype(cfg.dtype), self.device,
                                   quantize=self.kv_int8, num_kv_heads=self.kv_heads)
            dec_mask = torch.zeros((bg, mnt), dtype=torch.int32, device=self.device)
        out = torch.full((bg, mnt), self.pad_token_id, dtype=torch.int64, device=self.device)
        tok = sample(last_logits)
        out[:, 0] = tok
        gstate = advance(tok)
        done = tok == self.eos_token_id
        all_done = bool(done.all())             # host sync: prefill has finished
        t1 = time.perf_counter()
        ones = torch.ones((bg, 1), dtype=torch.int32, device=self.device)

        step = 1
        while step < mnt and not all_done:
            positions = (prompt_lens + step - 1)[:, None]
            if grouped:
                dec_mask[:, step - 1] = 1
                logits, dec_cache = decoder_decode_step_grouped(
                    model.decoder, cfg, out[:, step - 1:step], positions, cache,
                    attention_mask, dec_cache, step - 1, dec_mask, group_size)
            else:
                slot = p + step - 1
                cache_mask[:, slot] = 1
                logits, cache = decoder_forward(
                    model.decoder, cfg, input_ids=out[:, step - 1:step], attention_mask=ones,
                    positions=positions, cache=cache, cache_index=slot, cache_mask=cache_mask)
            tok = sample(logits[:, 0])
            gstate = advance(tok, done)
            tok = torch.where(done, self.pad_token_id, tok)
            out[:, step] = tok
            done |= tok == self.eos_token_id
            step += 1
            all_done = bool(done.all())         # host sync: one per step

        mask = completion_mask_from_eos(out, self.eos_token_id)
        out = torch.where(mask.bool(), out, self.pad_token_id)
        ids, mask = out.cpu().numpy(), mask.cpu().numpy()
        t2 = time.perf_counter()
        bad = int(bad)
        self.nonfinite_rows += bad
        self.last_stats = {"batch": bg, "group_size": group_size, "prompt_len": p,
                           "steps": step, "prefill_s": t1 - t0, "decode_s": t2 - t1,
                           "decode_tokens": bg * (step - 1), "nonfinite_rows": bad}
        return ids, mask
