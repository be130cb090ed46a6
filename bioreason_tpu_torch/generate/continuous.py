"""Continuous batching: the vLLM-style slot scheduler (the port of
bioreason_tpu/generate/continuous.py).

Requests join a fixed pool of C slots at token boundaries and leave it as
they finish, so short completions free their slot for the queue at once:

  * the KV state is split by write frequency into
      - a PROMPT pool [C, Hkv, P_max, D] per layer: written once at
        admission, read by every decode step;
      - a DECODE pool [C, Hkv, N_max + 1, D] per layer: each decode step
        writes its token's K/V straight into its row's next column.
    The JAX package keeps this window's tokens in a third buffer, the only
    KV its decode scan carries; PyTorch has no scan carry, so here each
    step writes the decode pool in place. The merged softmax is the same
    function. Column N_max is a spare that takes the writes of inactive
    rows and of rows past their depth, where the JAX package scatters with
    mode="drop" (an index out of range is a device assert on CUDA).
  * the pools are head-major ([C, Hkv, S, D]), so each step's grouped
    products read the keys and values in the cache's own dtype through
    strided views: nothing is repeated to Hq heads, copied or upcast;
  * decode attention is one softmax merged over the two tiers (fp32
    logits from products in the cache's dtype); per-row depths are masks;
  * `step_window(k)` runs k decode steps with no host sync inside: each
    row has its own RoPE position, a row that samples EOS goes inactive on
    the device, and the host reads the [k, C] token matrix once, then
    replays the steps on its mirrors of the slot state;
  * admission prefills requests grouped by (bucketed prompt width, DNA
    shape) in exact power-of-two chunks, through the encoder and the
    decoder's prefill into a cache of exactly the prompt width (flash_fwd
    on the card), with the head on the last position only; identical
    prompts in a group prefill once and fan out to their slots;
  * first tokens resolve lazily: a slot goes live with a placeholder and
    the next window patches its first token in on the device, while the
    host's copy of it arrives behind the window's work;
  * prefix caching (`prefix_cache=True`): finished slots keep their prompt
    KV under the prompt's content key (LRU eviction); an exact-match
    admission skips the prefill and draws its first token from the stored
    last hidden state;
  * recompute preemption: `preempt(slot)` returns a continuation request
    whose prompt is the original prompt plus the tokens generated so far;
  * `run_pipelined` keeps one window in flight: the host resolves window N
    while window N+1 runs on the card;
  * guided decoding (generate/guided.py): each slot threads its DFA state
    through the window on the device;
  * int8 pools (`kv_int8=True`): K/V int8 beside fp32 scales per (token,
    head), [C, Hkv, S, 1]; admission quantizes the prefill's K/V on the way
    in, and, as in the JAX package, a window keeps its own tokens' K/V in a
    float window buffer (a third softmax tier) and writes them into the
    decode pool, quantized, when it ends. The scales apply to the logits
    and the probabilities; decode denses stay weight-only (cfg.act_int8 is
    a prefill setting, JAX continuous.py:324-327).

CUDA launches are asynchronous, so "no host sync" is literal: every host
read of a device value goes through a copy into pinned memory enqueued at
the point it is known, and a wait on that copy's event only.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from bioreason_tpu_torch.config import FusionConfig, SamplingConfig
from bioreason_tpu_torch.generate import guided as G
from bioreason_tpu_torch.models import layers as L
from bioreason_tpu_torch.models.fusion import FusionModel, fused_input_embeddings
from bioreason_tpu_torch.models.qwen3 import _kv_quantize, _mlp, decoder_forward, init_cache
from bioreason_tpu_torch.ops.sampling import sample_logits
from bioreason_tpu_torch.utils.devices import resolve_device, torch_dtype


class Request:
    __slots__ = ("rid", "input_ids", "attention_mask", "dna_input_ids",
                 "dna_attention_mask", "max_new_tokens", "greedy", "tokens",
                 "done", "slot", "prompt_len")

    def __init__(self, rid, input_ids, attention_mask, dna_input_ids=None,
                 dna_attention_mask=None, max_new_tokens=256, greedy=False):
        self.rid = rid
        self.input_ids = np.asarray(input_ids)
        self.attention_mask = np.asarray(attention_mask)
        self.dna_input_ids = dna_input_ids
        self.dna_attention_mask = dna_attention_mask
        self.max_new_tokens = max_new_tokens
        self.greedy = greedy
        self.tokens: List[int] = []
        self.done = False
        self.slot = -1
        self.prompt_len = int(self.attention_mask.sum())

    def cache_key(self) -> bytes:
        """Prompt-content key for prefix caching (ids + mask + DNA)."""
        parts = [self.input_ids.tobytes(), self.attention_mask.tobytes()]
        if self.dna_input_ids is not None:
            parts.append(np.asarray(self.dna_input_ids).tobytes())
            parts.append(np.asarray(self.dna_attention_mask).tobytes())
        return b"|".join(parts)


class _HostCopy:
    """A device tensor's copy to the host, enqueued when made (into pinned
    memory, behind the work already queued) and waited for, by its event
    alone, at `numpy()`."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.is_cuda:
            self._buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._buf.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._buf = t

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._buf.numpy()


class _Chunk:
    """One dispatched admission chunk, until its first tokens are resolved."""
    __slots__ = ("req_src", "slots", "slots_d", "mask", "width", "greedy", "sampled", "host")

    def __init__(self, req_src, slots, slots_d, mask, width, greedy, sampled):
        self.req_src, self.slots, self.slots_d = req_src, slots, slots_d
        self.mask, self.width = mask, width
        self.greedy, self.sampled = greedy, sampled
        self.host = _HostCopy(torch.stack([greedy, greedy if sampled is None else sampled]))

    def tokens(self) -> List[int]:
        """The chosen first token of each request (greedy or sampled)."""
        greedy, sampled = self.host.numpy()
        return [int(greedy[i] if r.greedy else sampled[i])
                for i, (r, _) in enumerate(self.req_src)]


def slot_attention(q, pk, pv, pmask, dk, dv, dmask, p_scales=None, d_scales=None,
                   window=None):
    """One decode step's attention for C rows at mixed depths: one softmax
    merged over the prompt pool and the decode pool (and `window`).

    q [C, 1, Hq, D]; pk/pv [C, Hkv, P, D] and dk/dv [C, Hkv, N, D] in the
    cache's dtype (strided views of the head-major pools are fine);
    pmask [C, P], dmask [C, N] bool. Returns [C, 1, Hq, D] in q's dtype.
    `p_scales` / `d_scales`: (k_scale, v_scale) [C, Hkv, S, 1] of an int8
    pool, applied to its logits and probabilities (JAX continuous.py:
    253-291). `window`: (wk, wv, wmask) [C, Hkv, k, D] and [C, k], a third
    tier in q's dtype (the int8 batcher's window buffer).

    Logits are fp32 from products in q's dtype (the JAX einsums'
    preferred_element_type=float32); the probabilities are cast to q's
    dtype for the value products. K/V are never repeated to Hq heads."""
    c, _, hq, d = q.shape
    hkv = pk.shape[1]
    r = hq // hkv
    scale = d ** -0.5
    neg = torch.finfo(torch.float32).min
    qg = q.reshape(c * hkv, r, d)
    tiers = [(pk, pv, pmask, p_scales), (dk, dv, dmask, d_scales)]
    if window is not None:
        tiers.append((*window, None))
    logits = []
    for k, _, mask, scales in tiers:
        lg = (L.bmm_f32(qg, k.flatten(0, 1).to(q.dtype).transpose(1, 2)) * scale)
        lg = lg.view(c, hkv, r, -1)
        if scales is not None:
            lg = lg * scales[0][..., 0][:, :, None, :]
        logits.append(lg.masked_fill(~mask[:, None, None, :], neg))
    probs = torch.softmax(torch.cat(logits, dim=-1), dim=-1)
    out = 0
    for (_, v, _, scales), p in zip(tiers, probs.split([x.shape[-1] for x in logits], -1)):
        if scales is not None:
            p = p * scales[1][..., 0][:, :, None, :]
        out = out + torch.bmm(p.to(q.dtype).flatten(0, 1), v.flatten(0, 1).to(q.dtype))
    return out.reshape(c, 1, hq, d)


class ContinuousBatcher:
    """Slot-scheduled generation over split static KV pools."""

    def __init__(self, model: FusionModel, fusion_cfg: FusionConfig, eos_token_id: int,
                 capacity: int = 8, max_len: int = 2048,
                 sampling: SamplingConfig = SamplingConfig(),
                 prompt_bucket: int = 128, guided: Optional[G.GuidedSpec] = None,
                 kv_int8: bool = False, max_new: int = 256, prefix_cache: bool = False,
                 device=None, seed: int = 0):
        """`max_len`: prompt-pool width P_max (longest admissible prompt).
        `max_new`: decode-pool depth N_max (longest admissible completion).
        `guided`: optional GuidedSpec applied to EVERY request (batcher-level,
        like vLLM's engine-level guided decoding); each slot tracks its own
        DFA state, reset on admission. `prefix_cache`: retain finished
        slots' prompt KV keyed by prompt content; identical re-admissions
        skip the prefill. `device`: CUDA unless the caller passes "cpu";
        `model` must live there. Sampled rows draw from a generator on the
        device seeded with `seed`. `kv_int8`: int8 prompt and decode pools
        with per-(token, head) scales, half the pool bytes."""
        self.model = model
        self.kv_int8 = kv_int8
        self.cfg = fusion_cfg
        self.eos = eos_token_id
        self.capacity = capacity
        self.max_len = max_len
        self.max_new = max_new
        self.sampling = sampling
        self.prompt_bucket = prompt_bucket
        self.device = resolve_device(device)
        self.guided = None if guided is None else guided.to(self.device)
        self.gstate = np.zeros((capacity,), np.int32)      # per-slot DFA state
        if guided is not None:
            self._g_next_np = guided.next_state.cpu().numpy()
            self._g_acc_np = guided.accepting.cpu().numpy()
        dec = fusion_cfg.decoder
        self.dtype = torch_dtype(dec.dtype)
        shape = (capacity, dec.num_kv_heads, max_len, dec.head_dim)
        dshape = (capacity, dec.num_kv_heads, max_new + 1, dec.head_dim)   # + the spare

        def pool(s):
            kv = torch.int8 if kv_int8 else self.dtype
            entries = [{"k": torch.zeros(s, dtype=kv, device=self.device),
                        "v": torch.zeros(s, dtype=kv, device=self.device)}
                       for _ in range(dec.num_layers)]
            if kv_int8:
                for e in entries:
                    for n in ("k_scale", "v_scale"):
                        e[n] = torch.zeros(s[:-1] + (1,), dtype=torch.float32,
                                           device=self.device)
            return entries
        self.prompt_pool, self.dec_pool = pool(shape), pool(dshape)
        # host-visible slot state (the device copies are authoritative
        # between windows; the mirrors advance by replaying the tokens)
        self.prompt_mask = np.zeros((capacity, max_len), np.int32)
        self.positions = np.zeros((capacity,), np.int32)   # next RoPE position
        self.dec_len = np.zeros((capacity,), np.int32)     # decode-pool depth
        self.last_token = np.zeros((capacity,), np.int32)
        self.active = np.zeros((capacity,), bool)
        self.greedy_row = np.zeros((capacity,), bool)
        self._by_slot: List[Optional[Request]] = [None] * capacity
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

        self.prefix_cache = prefix_cache
        self._retained: "OrderedDict[bytes, tuple]" = OrderedDict()
        self._slot_key: List[Optional[bytes]] = [None] * capacity
        if prefix_cache:
            self._last_hidden = torch.zeros((capacity, dec.hidden_size), dtype=self.dtype,
                                            device=self.device)
        self.prefill_calls = 0                 # observability + cache tests

        # pipelined mode: installs/retires patch device rows in place of
        # full mirror uploads (run_pipelined)
        self.pipelined = False
        self._patch_slots: set = set()
        # row buckets (cb): decode windows read and compute only pool rows
        # [:cb], cb covering the highest active slot; admission fills
        # lowest-free-first and the drain phase packs live rows to the
        # front (_pack_front). Pool shapes never change.
        self.row_buckets = sorted({capacity, max(1, capacity // 2), max(1, capacity // 4)})
        self._pending_first: List[_Chunk] = []   # deferred install records
        self._finished_backlog: List[Request] = []
        # device-resident decode state (see _upload_state / step_window)
        self._dev: Optional[Dict[str, torch.Tensor]] = None
        self._dev_dirty = True
        # optional host-side phase timers (set to a dict to enable):
        # upload / dispatch / toks_wait / replay / admit / pack seconds plus
        # window and row counts, for locating scheduling overhead
        self.timers = None

    # -- device pieces ------------------------------------------------------

    def _upload(self, arr) -> torch.Tensor:
        """A host array on the device: from pinned memory, without waiting."""
        t = torch.as_tensor(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def _prefill(self, ids, mask, dna, dmask):
        """A batch of prompts -> (per-layer prompt KV [K, W, Hkv, D], last
        logits [K, V] fp32, last hidden [K, H]). The head runs on the last
        position only: [K, W, V] fp32 logits would be gigabytes at K = 64,
        W = 256 and a 151,936-token vocabulary (continuous.py:184-192)."""
        cfg = self.cfg.decoder
        embeds = fused_input_embeddings(self.model, self.cfg, ids, dna, dmask)
        b, p = ids.shape
        cache = init_cache(cfg, b, p, self.dtype, self.device)
        hidden, cache = decoder_forward(
            self.model.decoder, cfg, inputs_embeds=embeds, attention_mask=mask,
            positions=L.positions_from_mask(mask), cache=cache, cache_index=0,
            cache_mask=mask, return_hidden=True)
        last_h = hidden[:, -1]
        return cache, L.lm_logits(self.model.decoder, last_h), last_h

    def _first_tokens(self, logits, allow=None, gather=None, need_sample=True):
        """First token after prefill, per row: (greedy, sampled or None);
        the host picks per request. `gather` maps fan-out rows to prefill
        rows (dedupe)."""
        if gather is not None:
            logits = logits[gather]
        if allow is not None:
            logits = logits.masked_fill(~allow, -1e9)
        greedy = logits.argmax(-1)
        if not need_sample:
            return greedy, None
        s = self.sampling
        return greedy, sample_logits(logits, s.temperature, s.top_k, s.top_p, False, self._gen)

    def _first_allow(self) -> Optional[torch.Tensor]:
        """[1, V] tokens the DFA's start state allows (guided batchers)."""
        if self.guided is None:
            return None
        return G.allowed(torch.zeros((1,), dtype=torch.int32, device=self.device), self.guided)

    def _write_slot(self, kv, slots_d, gather_d):
        """Copy a prefilled [K, W] KV batch into rows `slots_d` of the prompt
        pool at offset 0, row gather_d[j] of the prefill to slots_d[j]
        (same-batch dedupe), quantized on the way into int8 pools. The rows
        are exactly the requests': no padded row and no out-of-range slot."""
        for dst, src in zip(self.prompt_pool, kv):
            w = src["k"].shape[1]
            for n in ("k", "v"):
                x = src[n][gather_d]
                if self.kv_int8:
                    x, sc = _kv_quantize(x)
                    dst[f"{n}_scale"][slots_d, :, :w] = sc.transpose(1, 2)
                dst[n][slots_d, :, :w] = x.transpose(1, 2)

    # -- the decode window (the hot loop) ------------------------------------

    def _multi_step(self, st: Dict[str, torch.Tensor], k: int, w: int, cb: int,
                    need_sample: bool) -> torch.Tensor:
        """`k` decode steps of rows [:cb] on the device, with no host sync:
        `st` (the device slot state) advances in place, the decode pool is
        written in place. Returns the [k, cb] token matrix.

        Rows that sample EOS go inactive on the device; rows past their
        max_new_tokens keep decoding to the window's end and the host
        discards the overrun. `w`: the decode-pool columns read, which cover
        every active row's history plus this window (the host knows each
        row's depth between windows). `cb`: the rows computed, which cover
        the highest active slot. `need_sample`: some active row samples
        (else every row takes the argmax and the sampler does not run)."""
        cfg = self.cfg.decoder
        dec = self.model.decoder
        dtype = self.dtype
        spare = self.max_new
        hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        s = self.sampling
        rows = torch.arange(cb, device=self.device)
        cols_w = torch.arange(w, device=self.device)
        pmask = st["pmask"][:cb]
        last, pos, act, gst = (st[n][:cb].clone() for n in ("last", "pos", "act", "gst"))
        dlen0 = st["dlen"][:cb]
        greedy_row = st["greedy"][:cb]
        steps = torch.zeros_like(dlen0)
        toks = torch.empty((k, cb), dtype=torch.int64, device=self.device)
        int8 = self.kv_int8
        if int8:
            # this window's K/V stay float in a window buffer, the decode
            # pool's history (int8) is fixed for the window
            win = [tuple(torch.zeros((cb, hkv, k, d), dtype=dtype, device=self.device)
                         for _ in range(2)) for _ in dec.layers]
            wmask = torch.zeros((cb, k), dtype=torch.bool, device=self.device)
            dmask = cols_w[None, :] < dlen0[:, None]
        for step in range(k):
            was = act
            depth = dlen0 + step                      # this step's column
            if int8:
                wmask[:, step] = was
            else:
                cols = torch.where(was, depth.clamp(max=spare), spare)
                dmask = cols_w[None, :] <= depth[:, None]
            h = L.embed(dec.embed, last[:, None], dtype)
            positions = pos[:, None]
            for i, (lp, pe, de) in enumerate(zip(dec.layers, self.prompt_pool, self.dec_pool)):
                x = L.rmsnorm(lp.ln1, h, cfg.rms_norm_eps)
                q, kk, vv = L.qkv_proj(lp.attn, x, dtype)
                q = L.rmsnorm(lp.attn.q_norm, q.reshape(cb, 1, hq, d), cfg.rms_norm_eps)
                kk = L.rmsnorm(lp.attn.k_norm, kk.reshape(cb, 1, hkv, d), cfg.rms_norm_eps)
                q = L.apply_rope(q, positions, cfg.rope_theta)
                kk = L.apply_rope(kk, positions, cfg.rope_theta)
                if int8:
                    wk, wv = win[i]
                    wk[:, :, step] = kk[:, 0]
                    wv[:, :, step] = vv.reshape(cb, hkv, d)
                    a = slot_attention(
                        q, pe["k"][:cb], pe["v"][:cb], pmask, de["k"][:cb, :, :w],
                        de["v"][:cb, :, :w], dmask,
                        (pe["k_scale"][:cb], pe["v_scale"][:cb]),
                        (de["k_scale"][:cb, :, :w], de["v_scale"][:cb, :, :w]),
                        (wk, wv, wmask))
                else:
                    de["k"][rows, :, cols] = kk[:, 0]
                    de["v"][rows, :, cols] = vv.reshape(cb, hkv, d)
                    a = slot_attention(q, pe["k"][:cb], pe["v"][:cb], pmask,
                                       de["k"][:cb, :, :w], de["v"][:cb, :, :w], dmask)
                h = h + L.dense(lp.attn.o, a.reshape(cb, 1, -1), dtype)
                x = L.rmsnorm(lp.ln2, h, cfg.rms_norm_eps)
                h = h + _mlp(lp, cfg, x, dtype)
            h = L.rmsnorm(dec.final_norm, h, cfg.rms_norm_eps)
            logits = L.lm_logits(dec, h)[:, 0]
            if self.guided is not None:
                logits = G.mask_logits(logits, gst, self.guided)
            tok = logits.argmax(-1)
            if need_sample:
                sampled = sample_logits(logits, s.temperature, s.top_k, s.top_p, False, self._gen)
                tok = torch.where(greedy_row, tok, sampled)
            tok = torch.where(was, tok, 0)
            if self.guided is not None:
                gst = torch.where(was, G.advance(gst, tok, self.guided), gst)
            pos = pos + was
            last = torch.where(was, tok, last)
            act = was & (tok != self.eos)
            steps += was
            toks[step] = tok
        if int8:
            # fold the window into the decode pool, quantized: each active
            # step's column at the row's depth, the rest into the spare
            j = torch.arange(k, device=self.device)
            cols = torch.where(wmask, (dlen0[:, None] + j).clamp(max=spare), spare)
            for (wk, wv), de in zip(win, self.dec_pool):
                for n, x in (("k", wk), ("v", wv)):
                    xq, sc = _kv_quantize(x)
                    de[n][rows[:, None], :, cols] = xq.transpose(1, 2)
                    de[f"{n}_scale"][rows[:, None], :, cols] = sc.transpose(1, 2)
        st["last"][:cb], st["pos"][:cb], st["act"][:cb], st["gst"][:cb] = last, pos, act, gst
        st["dlen"][:cb] += steps
        return toks

    # -- host scheduling ------------------------------------------------------

    def _bucketed(self, n: int) -> int:
        b = self.prompt_bucket
        return ((max(n, 1) + b - 1) // b) * b

    def admit(self, req: Request) -> bool:
        """Prefill `req` and install it in a free slot. False if full."""
        return bool(self.admit_many([req]))

    @staticmethod
    def _pow2_bucket(k: int) -> int:
        p = 1
        while p < k:
            p *= 2
        return p

    def _free_slots(self) -> List[int]:
        """Free slots ordered so prefix-cache retained rows are used LAST
        (and evicted LRU-first when they must be)."""
        free = [int(i) for i in np.nonzero(~self.active)[0]]
        if not self.prefix_cache:
            return free
        plain = [i for i in free if self._slot_key[i] is None]
        lru = [s for key, (s, _w) in self._retained.items() if s in free]
        return plain + lru

    def _evict_retained(self, slot: int):
        key = self._slot_key[slot]
        if key is not None:
            self._retained.pop(key, None)
            self._slot_key[slot] = None

    def _bind(self, req: Request, slot: int, mask_row: np.ndarray, width: int, first_tok: int):
        """Slot bookkeeping of an install; `first_tok` 0 is a placeholder
        where the device patches the real one in (deferred installs)."""
        req.slot = slot
        self._by_slot[slot] = req
        self.prompt_mask[slot] = 0
        self.prompt_mask[slot, :width] = mask_row
        self.positions[slot] = req.prompt_len      # next RoPE position
        self.dec_len[slot] = 0
        self.last_token[slot] = first_tok
        self.active[slot] = True
        self.greedy_row[slot] = req.greedy
        if self.prefix_cache:
            self._evict_retained(slot)
        if self.pipelined:
            self._patch_slots.add(int(slot))

    def _install(self, req: Request, slot: int, first_tok: int,
                 mask_row: np.ndarray, width: int):
        """An install whose first token is known."""
        if self.guided is not None:
            self.gstate[slot] = self._g_next_np[0, first_tok]
        req.tokens.append(first_tok)
        self._bind(req, slot, mask_row, width, first_tok)
        if first_tok == self.eos or len(req.tokens) >= req.max_new_tokens:
            self._finish(slot)

    @torch.no_grad()
    def admit_many(self, pending: List[Request]) -> List[Request]:
        """Admit from the FRONT of `pending` (popping admitted requests)
        until capacity is full. Requests with the same (prompt bucket, DNA
        shape) prefill together in exact power-of-two chunks, one prefill,
        one pool write and one first-token draw each; IDENTICAL prompts in a
        group prefill once and fan out. Prefix-cache hits skip the prefill.
        Returns the admitted requests (those already done among them)."""
        if self._pending_first:
            # slot accounting below needs exact state (EOS first tokens
            # free slots); normally step_window already resolved these
            self._finished_backlog.extend(self._resolve_pending())
        free = self._free_slots()
        take = pending[:len(free)]
        if not take:
            return []
        del pending[:len(take)]

        to_prefill = []
        for r in take:
            if r.max_new_tokens > self.max_new:
                raise ValueError(f"max_new_tokens {r.max_new_tokens} exceeds "
                                 f"decode-pool depth {self.max_new}")
            if self.prefix_cache and self._try_reuse(r, free):
                continue
            to_prefill.append(r)

        groups: dict = {}
        for r in to_prefill:
            width = self._bucketed(self.input_width(r))
            if width > self.max_len:
                raise ValueError(f"prompt {width} exceeds prompt-pool width {self.max_len}")
            dshape = (None if r.dna_input_ids is None
                      else tuple(np.asarray(r.dna_input_ids).shape))
            groups.setdefault((width, dshape), []).append(r)

        for (width, dshape), reqs in groups.items():
            # same-batch prompt dedupe over the whole group: src[j] maps
            # request j to its unique prefill row
            uniq: "OrderedDict[bytes, int]" = OrderedDict()
            src = []
            for r in reqs:
                src.append(uniq.setdefault(r.cache_key(), len(uniq)))
            uniq_reqs = [None] * len(uniq)
            for r, j in zip(reqs, src):
                if uniq_reqs[j] is None:
                    uniq_reqs[j] = r
            # chunk the unique prompts into decreasing exact powers of two
            # (96 -> 64 + 32): no padded prefill row
            start = 0
            while start < len(uniq_reqs):
                rem = len(uniq_reqs) - start
                kp = self._pow2_bucket(rem)
                if kp > rem:
                    kp //= 2
                req_src = [(reqs[j], src[j] - start) for j in range(len(reqs))
                           if start <= src[j] < start + kp]
                rec = self._dispatch_chunk(uniq_reqs[start:start + kp], req_src, width,
                                           dshape, free)
                # guided and <= 1-token requests resolve now (their install
                # bookkeeping depends on the token); the rest defer to the
                # next window, which patches the token in on the device
                if self.guided is not None or any(r.max_new_tokens <= 1 for r, _ in req_src):
                    for (r, s), tok, slot in zip(req_src, rec.tokens(), rec.slots):
                        self._install(r, int(slot), tok, rec.mask[s, :width], width)
                else:
                    for (r, s), slot in zip(req_src, rec.slots):
                        self._bind(r, int(slot), rec.mask[s, :width], width, 0)
                    self._pending_first.append(rec)
                start += kp
        if not self.pipelined:
            self._dev_dirty = True
        return take

    def _dispatch_chunk(self, uniq_reqs, req_src, width, dshape, free: List[int]) -> _Chunk:
        """Prefill one chunk (its unique prompts, left-padded to `width`),
        write its KV to the slots popped from `free` and draw its first
        tokens, without waiting on the device."""
        kp = len(uniq_reqs)
        ids = np.zeros((kp, width), np.int32)
        mask = np.zeros((kp, width), np.int32)
        for i, r in enumerate(uniq_reqs):
            n = r.input_ids.shape[-1]
            ids[i, width - n:] = r.input_ids.reshape(-1)      # left pad
            mask[i, width - n:] = r.attention_mask.reshape(-1)
        dna = dmask = None
        if dshape is not None:
            rows, ldna = dshape
            dna = np.concatenate([np.asarray(r.dna_input_ids) for r in uniq_reqs]).reshape(
                kp * rows, ldna)
            dmask = np.concatenate([np.asarray(r.dna_attention_mask) for r in uniq_reqs]
                                   ).reshape(kp * rows, ldna)
        n_req = len(req_src)
        slots = np.asarray(free[:n_req], np.int64)
        del free[:n_req]
        gather = np.asarray([s for _, s in req_src], np.int64)
        up = self._upload
        kv, last_logits, last_h = self._prefill(
            up(ids), up(mask), None if dna is None else up(dna),
            None if dmask is None else up(dmask))
        self.prefill_calls += 1
        slots_d, gather_d = up(slots), up(gather)
        self._write_slot(kv, slots_d, gather_d)
        if self.prefix_cache:
            self._last_hidden[slots_d] = last_h[gather_d]
        greedy, sampled = self._first_tokens(
            last_logits, self._first_allow(), gather_d,
            need_sample=not all(r.greedy for r, _ in req_src))
        return _Chunk(req_src, slots, slots_d, mask, width, greedy, sampled)

    def _fix_first(self, st: Dict[str, torch.Tensor], rec: _Chunk):
        """Patch one pending chunk's first tokens into the device slot state
        (device to device): greedy or sampled per row, last_token set,
        first-token-EOS rows deactivated, as _resolve_pending replays on
        the host mirrors."""
        tok = rec.greedy
        if rec.sampled is not None:
            tok = torch.where(st["greedy"][rec.slots_d], rec.greedy, rec.sampled)
        st["last"][rec.slots_d] = tok
        st["act"][rec.slots_d] = tok != self.eos

    def _resolve_pending(self) -> List[Request]:
        """Host-side completion of deferred installs: append first tokens,
        sync mirrors, finish EOS/quota rows. Called from step_window AFTER
        the window dispatch (the copy was queued before the window, so the
        wait is for the prefill only) or from admit_many/preempt when the
        state must be exact now."""
        finished = []
        for rec in self._pending_first:
            for (r, _), tok, slot in zip(rec.req_src, rec.tokens(), rec.slots):
                slot = int(slot)
                r.tokens.append(tok)
                self.last_token[slot] = tok
                if tok == self.eos or len(r.tokens) >= r.max_new_tokens:
                    self._finish(slot)
                    finished.append(r)
                    self._dev_dirty = True
        self._pending_first.clear()
        return finished

    def _try_reuse(self, req: Request, free: List[int]) -> bool:
        """Prefix-cache hit: an exact-prompt match against a retained slot
        skips the prefill; the first token comes from the stored last
        hidden state, all KV already in the prompt pool."""
        key = req.cache_key()
        hit = self._retained.get(key)
        if hit is None:
            return False
        slot, width = hit
        if slot not in free:                     # row was reused meanwhile
            return False
        free.remove(slot)
        self._retained.pop(key)
        self._slot_key[slot] = None
        logits = L.lm_logits(self.model.decoder, self._last_hidden[slot:slot + 1])
        g_tok, s_tok = self._first_tokens(logits, self._first_allow(), need_sample=not req.greedy)
        tok = int((g_tok if req.greedy else s_tok).cpu()[0])
        n = req.input_ids.shape[-1]
        mask_row = np.zeros((width,), np.int32)
        mask_row[width - n:] = req.attention_mask.reshape(-1)
        self._install(req, slot, tok, mask_row, width)
        # the row STILL holds this prompt's KV and hidden: re-retained on finish
        return True

    @staticmethod
    def input_width(req: Request) -> int:
        return req.input_ids.shape[-1]

    def _finish(self, slot: int):
        req = self._by_slot[slot]
        req.done = True
        self.active[slot] = False
        self._by_slot[slot] = None
        if self.prefix_cache:
            key = req.cache_key()
            old = self._retained.pop(key, None)
            if old is not None:
                self._slot_key[old[0]] = None
            self._retained[key] = (slot, self._bucketed(self.input_width(req)))
            self._slot_key[slot] = key

    def preempt(self, slot: int) -> Request:
        """Recompute preemption (vLLM's eviction story for full pools):
        evict the running request in `slot`, returning a CONTINUATION
        request whose prompt is the original prompt plus everything
        generated so far. Re-admitting it re-prefills that extended prompt
        and continues the same trajectory (exact for greedy rows). The slot
        frees immediately."""
        if self.guided is not None:
            raise NotImplementedError("preemption with guided decoding needs DFA-state replay")
        if self._pending_first:
            # the continuation prompt needs the slot's first token
            self._finished_backlog.extend(self._resolve_pending())
        req = self._by_slot[slot]
        if req is None:
            raise ValueError(f"slot {slot} is not active")
        ids = req.input_ids.reshape(-1)
        msk = req.attention_mask.reshape(-1)
        ext = np.concatenate([ids[msk.astype(bool)], np.asarray(req.tokens, ids.dtype)])
        cont = Request(req.rid, ext[None, :], np.ones((1, len(ext)), np.int32),
                       req.dna_input_ids, req.dna_attention_mask,
                       max_new_tokens=req.max_new_tokens, greedy=req.greedy)
        cont.tokens = req.tokens            # shared: totals keep accumulating
        self.active[slot] = False
        self._by_slot[slot] = None
        self._dev_dirty = True
        return cont

    def step(self) -> List[Request]:
        """Advance every active slot one token; returns requests finished
        this step. The newly decoded token is appended to each request."""
        return self.step_window(1)

    def _row_bucket(self, n: int) -> int:
        """Smallest row bucket covering the first `n` slots."""
        for b in self.row_buckets:
            if b >= n:
                return b
        return self.capacity

    def _hwm(self) -> int:
        """1 + highest active slot per the host mirrors: a safe upper bound
        on device-active rows for the next window (mirrors can lag
        active-high after device-side EOS, never active-low)."""
        nz = np.nonzero(self.active)[0]
        return int(nz[-1]) + 1 if len(nz) else 0

    def _window_shape(self, k: int, lag: int = 0):
        """(w, cb) of the next k-step window: `w` the decode-pool columns it
        reads, in multiples of 32 up to N_max, covering every active row's
        history (`lag` steps more where the mirrors trail an in-flight
        window) and the window's own tokens; `cb` the row bucket."""
        cb = self._row_bucket(max(1, self._hwm()))
        depth = int(self.dec_len[self.active].max(initial=0)) + lag + k
        return min(self.max_new, ((depth + 31) // 32) * 32), cb

    def _upload_state(self):
        """Push the host mirrors to the device. Needed only when they
        diverged from the device copies (after admissions and finishes);
        in the steady state windows chain device to device."""
        up = self._upload
        self._dev = {"pmask": up(self.prompt_mask != 0), "last": up(self.last_token.astype(np.int64)),
                     "pos": up(self.positions.astype(np.int64)),
                     "dlen": up(self.dec_len.astype(np.int64)), "act": up(self.active),
                     "gst": up(self.gstate), "greedy": up(self.greedy_row)}
        self._dev_dirty = False

    def _need_sample(self, cb: int) -> bool:
        return bool((self.active[:cb] & ~self.greedy_row[:cb]).any())

    @torch.no_grad()
    def step_window(self, k: int) -> List[Request]:
        """Advance every active slot up to `k` tokens with one dispatch of
        device work, ONE device-to-host copy (the [k, C] token matrix) and
        no other sync: the decode state lives on the device between windows
        and the host mirrors advance by replaying the tokens.

        Deferred admissions resolve here: their first tokens are patched
        into the device state before the window, and the host-side resolve
        runs while the window computes."""
        tm = self.timers
        t0 = time.perf_counter() if tm is not None else 0.0
        finished: List[Request] = list(self._finished_backlog)
        self._finished_backlog.clear()
        if not self.active.any():
            finished.extend(self._resolve_pending())
            return finished
        w, cb = self._window_shape(k)
        if self._dev is None or self._dev_dirty:
            self._upload_state()
        if tm is not None:
            t1 = time.perf_counter()
            tm["upload"] = tm.get("upload", 0.0) + (t1 - t0)
            t0 = t1
        for rec in self._pending_first:
            self._fix_first(self._dev, rec)
        toks = _HostCopy(self._multi_step(self._dev, k, w, cb, self._need_sample(cb)))
        if tm is not None:
            t1 = time.perf_counter()
            tm["dispatch"] = tm.get("dispatch", 0.0) + (t1 - t0)
            tm["windows"] = tm.get("windows", 0) + 1
            tm["rows"] = tm.get("rows", 0) + int(self.active.sum())
            t0 = t1
        if self._pending_first:
            # host mirror patch-up overlaps the dispatched window
            finished.extend(self._resolve_pending())
        toks = toks.numpy()                     # the ONE transfer
        if tm is not None:
            t1 = time.perf_counter()
            tm["toks_wait"] = tm.get("toks_wait", 0.0) + (t1 - t0)
            t0 = t1
        for step in range(k):
            act_slots = np.nonzero(self.active)[0]
            if len(act_slots) == 0:
                break
            for slot in act_slots:
                req = self._by_slot[slot]
                t = int(toks[step, slot])
                # replay the device-side per-step advance on the mirrors
                self.dec_len[slot] += 1
                self.positions[slot] += 1
                self.last_token[slot] = t
                if self.guided is not None:
                    self.gstate[slot] = self._g_next_np[self.gstate[slot], t]
                req.tokens.append(t)
                if t == self.eos or len(req.tokens) >= req.max_new_tokens:
                    finished.append(req)
                    self._finish(slot)          # mirrors diverge from device
        if finished:
            self._dev_dirty = True
        if tm is not None:
            tm["replay"] = tm.get("replay", 0.0) + (time.perf_counter() - t0)
        return finished

    @torch.no_grad()
    def warmup(self, prompt_widths, dna_shapes=(None,), windows=(1,)):
        """Run, and discard, one admission prefill per (prompt width, DNA
        shape) at the largest chunk (capacity, rounded down to a power of
        two) and one decode window per window length, so that the kernels'
        build and the allocator's first allocations happen before traffic.
        State-neutral: nothing is written to the pools but the decode
        pool's spare column, and the sampler's generator is restored."""
        kp = self._pow2_bucket(self.capacity)
        if kp > self.capacity:
            kp //= 2
        for width in prompt_widths:
            width = self._bucketed(width)
            for dshape in dna_shapes:
                z = torch.zeros((kp, width), dtype=torch.int32, device=self.device)
                dna = None
                if dshape is not None:
                    rows, ldna = dshape
                    dna = torch.zeros((kp * rows, ldna), dtype=torch.int32, device=self.device)
                self._prefill(z, z, dna, dna)
        gen_state = self._gen.get_state()
        c = self.capacity
        idle = {"pmask": torch.zeros((c, self.max_len), dtype=torch.bool, device=self.device),
                **{n: torch.zeros((c,), dtype=torch.int64, device=self.device)
                   for n in ("last", "pos", "dlen")},
                "act": torch.zeros((c,), dtype=torch.bool, device=self.device),
                "gst": torch.zeros((c,), dtype=torch.int32, device=self.device),
                "greedy": torch.zeros((c,), dtype=torch.bool, device=self.device)}
        for win in windows:
            self._multi_step(idle, max(1, win), self.max_new, c, need_sample=True)
        self._gen.set_state(gen_state)

    def run(self, requests: List[Request], window: int = 1) -> List[Request]:
        """Convenience loop: admit as capacity allows until all finish.
        `window`: decode steps per host round trip (step_window)."""
        pending = list(requests)
        done: List[Request] = []
        while pending or self.active.any() or self._pending_first:
            done.extend(r for r in self.admit_many(pending) if r.done)
            done.extend(self.step_window(window))
        done.extend(self._finished_backlog)
        self._finished_backlog.clear()
        return done

    # -- pipelined mode -------------------------------------------------------

    def _apply_patches(self):
        """Push every slot touched since the last window (installs, retires)
        onto the device state with one row write per field: the pipelined
        replacement for _upload_state, whose full mirrors lag the in-flight
        window."""
        if not self._patch_slots:
            return
        slots = np.fromiter(sorted(self._patch_slots), np.int64, len(self._patch_slots))
        self._patch_slots.clear()
        up, st = self._upload, self._dev
        sl = up(slots)
        st["pmask"][sl] = up(self.prompt_mask[slots] != 0)
        st["last"][sl] = up(self.last_token[slots].astype(np.int64))
        st["pos"][sl] = up(self.positions[slots].astype(np.int64))
        st["dlen"][sl] = up(self.dec_len[slots].astype(np.int64))
        st["act"][sl] = up(self.active[slots])
        st["gst"][sl] = up(self.gstate[slots])
        st["greedy"][sl] = up(self.greedy_row[slots])

    def _dispatch_window(self, k: int, lag: int):
        """Dispatch one decode window WITHOUT waiting on the device. `lag`:
        steps the host mirrors trail the device by (the in-flight window's
        length)."""
        self._apply_patches()
        for rec in self._pending_first:
            self._fix_first(self._dev, rec)
        w, cb = self._window_shape(k, lag)
        toks = _HostCopy(self._multi_step(self._dev, k, w, cb, self._need_sample(cb)))
        snap = [(int(s), self._by_slot[s]) for s in np.nonzero(self.active)[0]]
        return (toks, snap, k)

    def _replay_window(self, inflight) -> List[Request]:
        """Host-side resolution of a window dispatched one iteration ago:
        its tokens go to the requests bound to each slot AT DISPATCH TIME
        (the slot may have been rebound to a successor since; then the old
        request's tokens still land on the old request and the mirrors,
        already reset by the install, are left alone)."""
        toks, snap, k = inflight
        toks = toks.numpy()                              # the ONE transfer
        finished: List[Request] = []
        for slot, req in snap:
            if req is None or req.done:
                continue
            cur = self._by_slot[slot] is req
            adv = cur and self.active[slot]
            for step in range(k):
                t = int(toks[step, slot])
                req.tokens.append(t)
                if adv:
                    self.dec_len[slot] += 1
                    self.positions[slot] += 1
                    self.last_token[slot] = t
                if t == self.eos or len(req.tokens) >= req.max_new_tokens:
                    finished.append(req)
                    if cur:
                        self._finish(slot)   # retention + slot bookkeeping
                    else:
                        req.done = True      # slot already rebound
                    break
        return finished

    def _pack_front(self):
        """Drain-phase slot packing: gather the live rows to the FRONT of
        the (same-size) pools so the next windows' row bucket steps down
        the ladder; the decode step's cost grows with the rows it reads.
        Mirrors must be authoritative (no window in flight, no pending
        first token); prefix retention is incompatible with moving rows,
        so run_pipelined skips packing when prefix_cache is on."""
        live = np.nonzero(self.active)[0]
        n = len(live)
        b = self._row_bucket(max(1, n))
        rows = np.arange(b)
        rows[:n] = live                    # rows[i >= n] = i: identity write
        rows_d = self._upload(rows)
        for entry in self.prompt_pool + self.dec_pool:
            for x in entry.values():
                x[:b] = x[rows_d]
        for name in ("prompt_mask", "positions", "dec_len", "last_token", "gstate",
                     "greedy_row", "active"):
            arr = getattr(self, name)
            packed = arr[live]
            arr[:] = 0
            arr[:n] = packed
        self._by_slot = [self._by_slot[i] for i in live] + [None] * (self.capacity - n)
        self._patch_slots.clear()          # superseded by the fresh upload
        self._upload_state()

    @torch.no_grad()
    def run_pipelined(self, requests: List[Request], window: int = 8) -> List[Request]:
        """run() with one decode window always IN FLIGHT: the host resolves
        window N's tokens, admits replacements and queues the state patches
        while window N+1 computes.

        Admission keeps full occupancy across the pipeline bubble because
        quota finishes are PREDICTED: a slot whose request has fewer than
        `window` tokens of budget left is free after the in-flight window
        (EOS could only free it earlier), so its successor is installed
        before that window has resolved; the install's writes queue behind
        the in-flight window on the device's stream.

        Greedy rows give the same completions as run() (each slot's decode
        depends only on its own prompt and KV); sampled rows see another
        sequence of draws. Guided decoding needs per-token host resolution
        and falls back to run()."""
        if self.guided is not None:
            return self.run(requests, window=window)
        tm = self.timers
        clk = time.perf_counter
        pending = list(requests)
        done: List[Request] = list(self._finished_backlog)
        self._finished_backlog.clear()
        self.pipelined = True
        try:
            if self._dev is None or self._dev_dirty:
                self._upload_state()
            inflight = None
            while pending or self.active.any() or self._pending_first or inflight:
                if inflight is not None:
                    # retire rows that deterministically finish in flight
                    _, snap, kk = inflight
                    for slot, req in snap:
                        if (req is not None and not req.done and self._by_slot[slot] is req
                                and self.active[slot]
                                and len(req.tokens) + kk >= req.max_new_tokens):
                            self.active[slot] = False
                            self._patch_slots.add(slot)
                if (inflight is not None and not pending and not self._pending_first
                        and not self.prefix_cache):
                    live = int(self.active.sum())
                    if live and self._row_bucket(live) < self._row_bucket(self._hwm()):
                        # drain: resolve the in-flight window (one pipeline
                        # bubble), pack live rows to the front, and step
                        # the row bucket down for the remaining windows
                        t0 = clk() if tm is not None else 0.0
                        done.extend(self._replay_window(inflight))
                        inflight = None
                        if self.active.any():
                            self._pack_front()
                        if tm is not None:
                            tm["pack"] = tm.get("pack", 0.0) + clk() - t0
                        continue
                t0 = clk() if tm is not None else 0.0
                done.extend(r for r in self.admit_many(pending) if r.done)
                if tm is not None:
                    t1 = clk()
                    tm["admit"] = tm.get("admit", 0.0) + t1 - t0
                    t0 = t1
                nxt = None
                if self.active.any() or self._pending_first:
                    nxt = self._dispatch_window(window, inflight[2] if inflight else 0)
                    if tm is not None:
                        tm["windows"] = tm.get("windows", 0) + 1
                        tm["rows"] = tm.get("rows", 0) + int(self.active.sum())
                if tm is not None:
                    t1 = clk()
                    tm["dispatch"] = tm.get("dispatch", 0.0) + t1 - t0
                    t0 = t1
                if inflight is not None:
                    done.extend(self._replay_window(inflight))
                done.extend(self._resolve_pending())
                if tm is not None:
                    tm["replay"] = tm.get("replay", 0.0) + clk() - t0
                inflight = nxt
            done.extend(self._finished_backlog)
            self._finished_backlog.clear()
        finally:
            self.pipelined = False
            self._patch_slots.clear()
            self._dev_dirty = True     # mirrors are authoritative again
        return done
