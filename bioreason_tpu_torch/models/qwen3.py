"""Qwen3-style causal decoder (the port of bioreason_tpu/models/qwen3.py):
pre-norm RMSNorm transformer with grouped-query attention, per-head q/k
RMSNorm before RoPE, SwiGLU MLP and tied embeddings; with
`cfg.num_experts` every layer's MLP is a capacity-routed mixture of experts
(`layers.moe_apply`, Qwen3-MoE).

The KV cache is a list of per-layer {k, v} [B, S, Hkv, D] buffers written in
place (`cache[i]["k"][:, idx:idx+t] = k`), never reallocated per step; the
JAX package gets the same effect from donated buffers and
dynamic_update_slice. `init_cache(quantize=True)` stores K/V int8 with an
fp32 scale per (token, head) (`_kv_quantize`); decode steps read it with
the scales on the logits and probabilities (`attention.xla_attention`),
while a multi-token block written into it attends over its own fresh float
K/V, so prefills keep the flash kernel (JAX qwen3.py:168-176).

GRPO's grouped decode (`decoder_decode_step_grouped`): G completions share
one prompt KV cache [B_u, P] written by a prefill of the unique prompts;
only the decode slots live per completion, [B_u*G, N]. The prompt cache is
never repeated G-fold: each decode step reads it once per group.

Training runs the same layers with autograd: each layer may be recomputed in
backward (`cfg.remat`, `layers.remat`) and draws its LoRA dropout masks from
its own generator, seeded per layer and step, so a recomputed layer draws
the same masks (the JAX package's per-layer dropout keys, qwen3.py:251-260).

Under a mesh's 'fsdp' axis every layer runs with its own parameters
gathered for it alone (`layers.layer_fn`, `partition.layer_gathered`;
inside the function remat wraps, so a recompute gathers again), as each
iteration of JAX's layer scan gathers that layer's slice (qwen3.py:259-266).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from bioreason_tpu_torch.config import DecoderConfig
from bioreason_tpu_torch.models import layers as L
from bioreason_tpu_torch.models.attention import attention
from bioreason_tpu_torch.utils.devices import torch_dtype


class DecoderAttention(nn.Module):
    def __init__(self, cfg: DecoderConfig, device=None, dtype=torch.float32):
        super().__init__()
        h, qd, kvd = cfg.hidden_size, cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        self.q = L.linear(h, qd, False, device, dtype)
        self.k = L.linear(h, kvd, False, device, dtype)
        self.v = L.linear(h, kvd, False, device, dtype)
        self.o = L.linear(qd, h, False, device, dtype)
        self.q_norm = L.RMSNorm(cfg.head_dim, device)
        self.k_norm = L.RMSNorm(cfg.head_dim, device)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DecoderConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.hidden_size, device)
        self.attn = DecoderAttention(cfg, device, dtype)
        self.ln2 = L.RMSNorm(cfg.hidden_size, device)
        self.mlp = (L.MoE(cfg.hidden_size, cfg.num_experts, cfg.moe_intermediate_size,
                          device, dtype)
                    if cfg.num_experts
                    else L.SwiGLU(cfg.hidden_size, cfg.intermediate_size, False, device, dtype))


class Qwen3Decoder(nn.Module):
    """Parameters of the decoder; `decoder_forward` runs it."""

    def __init__(self, cfg: DecoderConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.embed = L.Embedding(cfg.vocab_size, cfg.hidden_size, device, dtype)
        self.layers = nn.ModuleList(DecoderLayer(cfg, device, dtype)
                                    for _ in range(cfg.num_layers))
        self.final_norm = L.RMSNorm(cfg.hidden_size, device)
        self.lm_head = (None if cfg.tie_word_embeddings
                        else L.linear(cfg.hidden_size, cfg.vocab_size, False, device, dtype))


def init_cache(cfg: DecoderConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None, quantize: bool = False,
               num_kv_heads: Optional[int] = None) -> List[Dict[str, torch.Tensor]]:
    """Per-layer KV cache: a list of {k, v} [B, S, Hkv, D] zero buffers;
    `quantize` stores them int8 beside fp32 `k_scale` / `v_scale`
    [B, S, Hkv, 1] (JAX qwen3.py:66-88). `num_kv_heads`: the heads this
    rank holds (Hkv/m on a tensor-parallel rank, `partition.local_heads`);
    default all of cfg's."""
    hkv = cfg.num_kv_heads if num_kv_heads is None else num_kv_heads
    shape = (batch, max_len, hkv, cfg.head_dim)
    if quantize:
        sshape = shape[:-1] + (1,)
        return [{"k": torch.zeros(shape, dtype=torch.int8, device=device),
                 "v": torch.zeros(shape, dtype=torch.int8, device=device),
                 "k_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
                 "v_scale": torch.zeros(sshape, dtype=torch.float32, device=device)}
                for _ in range(cfg.num_layers)]
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.num_layers)]


def _kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., D] float -> (int8 [..., D], fp32 scale [..., 1]): absmax per
    row, clamped at 1e-8 BEFORE the division by 127 (JAX qwen3.py:91-96;
    the weights clamp after it)."""
    xf = x.float()
    scale = xf.abs().amax(-1, keepdim=True).clamp(min=1e-8) / 127.0
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def cache_entry_update(entry: Dict[str, torch.Tensor], k: torch.Tensor,
                       v: torch.Tensor, index: int) -> Dict[str, torch.Tensor]:
    """Write new K/V [B, T, Hkv, D] at `index`, in place, quantizing when
    the entry carries scales. Returns the entry."""
    t = k.shape[1]
    if "k_scale" in entry:
        (qk, sk), (qv, sv) = _kv_quantize(k), _kv_quantize(v)
        entry["k_scale"][:, index:index + t] = sk
        entry["v_scale"][:, index:index + t] = sv
        k, v = qk, qv
    entry["k"][:, index:index + t] = k
    entry["v"][:, index:index + t] = v
    return entry


def _mlp(lp: DecoderLayer, cfg: DecoderConfig, x, dtype, drop=None, a8: bool = False):
    """Dense SwiGLU or Mixture-of-Experts FFN per cfg.num_experts (JAX
    qwen3.py:130-135): the MoE takes neither LoRA dropout nor act_int8, and
    its router runs weight-only."""
    if cfg.num_experts:
        return L.moe_apply(lp.mlp, x, cfg.num_experts_per_tok, cfg.norm_topk_prob, dtype,
                           cfg.moe_capacity_factor)
    return L.swiglu(lp.mlp, x, dtype, drop, a8)


def _layer_forward(lp: DecoderLayer, h, cfg: DecoderConfig, positions, kv_mask,
                   causal, cache_entry=None, cache_index=None, dropout_seed=None,
                   dropout_rate: float = 0.0):
    """One decoder block. h: [B, T, H] in the compute dtype. With a
    `dropout_seed`, the LoRA adapters' inputs take inverted dropout drawn
    from a generator seeded with it (q, k, v, o, gate, up, down in turn)."""
    b, t, _ = h.shape
    dtype = h.dtype
    drop = None
    if dropout_seed is not None:
        drop = (torch.Generator(device=h.device).manual_seed(dropout_seed), dropout_rate)
    a8 = cfg.act_int8
    x = L.rmsnorm(lp.ln1, h, cfg.rms_norm_eps)
    q, k, v = L.qkv_proj(lp.attn, x, dtype, (drop, drop, drop), a8)
    # heads from the widths: a tensor-parallel rank holds Hq/m and Hkv/m
    q = q.reshape(b, t, -1, cfg.head_dim)
    k = k.reshape(b, t, -1, cfg.head_dim)
    v = v.reshape(b, t, -1, cfg.head_dim)
    q = L.rmsnorm(lp.attn.q_norm, q, cfg.rms_norm_eps)
    k = L.rmsnorm(lp.attn.k_norm, k, cfg.rms_norm_eps)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)

    ks = vs = None
    if cache_entry is not None:
        cache_entry_update(cache_entry, k, v, cache_index)
        if "k_scale" in cache_entry and t > 1:
            # an int8 cache's prefill: the block just written is all its
            # callers have in it (they prefill fresh caches), so it attends
            # over its own float K/V, through the flash kernel, with the
            # mask of its slots (JAX qwen3.py:168-176)
            k_all, v_all = k, v
            kv_mask = kv_mask[:, cache_index:cache_index + t]
        else:
            k_all, v_all = cache_entry["k"], cache_entry["v"]
            ks, vs = cache_entry.get("k_scale"), cache_entry.get("v_scale")
    else:
        k_all, v_all = k, v
    # with a cache the queries sit at absolute positions cache_index.. among
    # the keys: q_offset is passed explicitly (0 for a prefill), never
    # left to the Tk - Tq default
    a = attention(q, k_all, v_all, kv_mask=kv_mask, causal=causal,
                  q_offset=cache_index if cache_entry is not None else None,
                  impl=cfg.attention_impl, k_scale=ks, v_scale=vs)
    h = h + L.dense(lp.attn.o, a.reshape(b, t, -1), dtype, drop, a8)
    x = L.rmsnorm(lp.ln2, h, cfg.rms_norm_eps)
    return h + _mlp(lp, cfg, x, dtype, drop, a8)


def decoder_forward(
    dec: Qwen3Decoder,
    cfg: DecoderConfig,
    input_ids: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[List[Dict[str, torch.Tensor]]] = None,
    cache_index: int = 0,
    cache_mask: Optional[torch.Tensor] = None,
    return_hidden: bool = False,
    lora_dropout_gen: Optional[torch.Generator] = None,
    lora_dropout_rate: float = 0.0,
) -> Tuple[torch.Tensor, Optional[List[Dict[str, torch.Tensor]]]]:
    """Run the decoder. Returns (fp32 logits [B,T,V] or the final hidden
    state with `return_hidden`, the cache or None).

    Without cache: causal self-attention over the block (`attention_mask`
    [B,T] marks valid tokens; left padding supported). With cache: the
    block's K/V are written at `cache_index` and attention runs over the
    whole cache with `cache_mask` [B,S] marking valid slots (causal within
    a multi-token block, q_offset = cache_index).

    Training (no cache): `lora_dropout_gen` (a CPU generator) draws one
    dropout seed per layer when `lora_dropout_rate` > 0; layers are
    recomputed in backward when `cfg.remat`."""
    dtype = torch_dtype(cfg.dtype)
    if inputs_embeds is None:
        inputs_embeds = L.embed(dec.embed, input_ids, dtype)
    h = inputs_embeds.to(dtype)
    b, t, _ = h.shape
    if attention_mask is None:
        attention_mask = torch.ones((b, t), dtype=torch.int32, device=h.device)
    if positions is None:
        positions = L.positions_from_mask(attention_mask)

    if cache is not None:
        kv_mask, causal = cache_mask, t > 1
        for i, lp in enumerate(dec.layers):
            h = _layer_forward(lp, h, cfg, positions, kv_mask, causal, cache[i], cache_index)
    else:
        seeds = [None] * len(dec.layers)
        if lora_dropout_gen is not None and lora_dropout_rate > 0.0:
            seeds = torch.randint(0, 2 ** 62, (len(dec.layers),),
                                  generator=lora_dropout_gen).tolist()
        from bioreason_tpu_torch.parallel import pp
        if pp.pipeline_enabled():
            # GPipe over this rank's stage (parallel/pp.py, JAX qwen3.py:235-246)
            axis, n_micro = pp.pipeline_state()
            own = pp._STATE["layers"] or range(len(dec.layers))
            h = pp.pp_decoder_layers([dec.layers[i] for i in own], h, cfg, positions,
                                     attention_mask, axis, n_micro, pp._STATE["dp"],
                                     [seeds[i] for i in own], lora_dropout_rate)
        else:
            layer = L.layer_fn(_layer_forward, cfg)
            for lp, seed in zip(dec.layers, seeds):
                h = layer(lp, h, cfg, positions, attention_mask, True,
                          dropout_seed=seed, dropout_rate=lora_dropout_rate)
    h = L.rmsnorm(dec.final_norm, h, cfg.rms_norm_eps)
    out = h if return_hidden else L.lm_logits(dec, h)
    return out, cache


def _grouped_decode_attention(q, pk, pv, prompt_mask, dk, dv, dec_mask, group: int,
                              pk_scale=None, pv_scale=None, dk_scale=None, dv_scale=None):
    """q [B_u*G, 1, Hq, D]; pk/pv [B_u, P, Hkv, D] (shared by each group's
    G rows); dk/dv [B_u*G, N, Hkv, D]; prompt_mask [B_u, P]; dec_mask
    [B_u*G, N]. Returns [B_u*G, 1, Hq, D] in q's dtype.

    Logits come out fp32 from q-dtype operands (the JAX einsums'
    preferred_element_type=float32) and both blocks share ONE softmax; the
    probabilities are cast to q's dtype for the value products, as the JAX
    function does. The prompt block is one product per (prompt, kv head)
    over the group's G * r query rows (r = Hq / Hkv), so each prompt key is
    read once per group; K/V are never repeated and never upcast to fp32
    (the batched products take a transposed copy of the cache in its own
    dtype).

    `*_scale` [.., T, Hkv, 1]: an int8 cache's scales (JAX
    qwen3.py:301-347). The int8 values go into the products cast to q's
    dtype, as they are (exact: |q| <= 127); the key scales multiply the
    fp32 logits and the value scales the fp32 probabilities before their
    cast, so K/V are never dequantized into a float temporary."""
    bg, _, hq, d = q.shape
    bu, p_len, hkv, _ = pk.shape
    n = dk.shape[1]
    r = hq // hkv
    dtype = q.dtype
    scale = d ** -0.5
    neg = torch.finfo(torch.float32).min

    def per_key(s):                         # [B, T, Hkv, 1] -> [B, Hkv, 1, T]
        return s[..., 0].transpose(1, 2)[:, :, None, :].float()

    # prompt block: [B_u*Hkv, G*r, D] @ [B_u*Hkv, D, P]
    qp = q.reshape(bu, group, hkv, r, d).permute(0, 2, 1, 3, 4).reshape(bu * hkv, group * r, d)
    kp = pk.to(dtype).permute(0, 2, 3, 1).reshape(bu * hkv, d, p_len)
    lp = L.bmm_f32(qp, kp).reshape(bu, hkv, group * r, p_len) * scale
    if pk_scale is not None:
        lp = lp * per_key(pk_scale)
    lp = lp.reshape(bu, hkv, group, r, p_len)
    lp = lp.masked_fill(~prompt_mask.bool()[:, None, None, None, :], neg)
    lp = lp.permute(0, 2, 1, 3, 4).reshape(bg, hkv, r, p_len)
    # decode block: [B_u*G*Hkv, r, D] @ [B_u*G*Hkv, D, N]
    qd = q.reshape(bg * hkv, r, d)
    kd = dk.to(dtype).permute(0, 2, 3, 1).reshape(bg * hkv, d, n)
    ld = L.bmm_f32(qd, kd).reshape(bg, hkv, r, n) * scale
    if dk_scale is not None:
        ld = ld * per_key(dk_scale)
    ld = ld.masked_fill(~dec_mask.bool()[:, None, None, :], neg)

    probs = torch.softmax(torch.cat([lp, ld], dim=-1), dim=-1)
    pp = probs[..., :p_len].reshape(bu, group, hkv, r, p_len).permute(0, 2, 1, 3, 4)
    if pv_scale is not None:
        pp = pp * per_key(pv_scale)[:, :, None]
    pp = pp.to(dtype).reshape(bu * hkv, group * r, p_len)
    vp = pv.to(dtype).permute(0, 2, 1, 3).reshape(bu * hkv, p_len, d)
    op = (torch.bmm(pp, vp).reshape(bu, hkv, group, r, d).permute(0, 2, 1, 3, 4)
          .reshape(bg, hkv, r, d))
    pd = probs[..., p_len:]
    if dv_scale is not None:
        pd = pd * per_key(dv_scale)
    pd = pd.to(dtype).reshape(bg * hkv, r, n)
    vd = dv.to(dtype).permute(0, 2, 1, 3).reshape(bg * hkv, n, d)
    od = torch.bmm(pd, vd).reshape(bg, hkv, r, d)
    return (op + od).reshape(bg, 1, hq, d)


def decoder_decode_step_grouped(dec: Qwen3Decoder, cfg: DecoderConfig,
                                input_ids: torch.Tensor, positions: torch.Tensor,
                                prompt_cache: List[Dict[str, torch.Tensor]],
                                prompt_mask: torch.Tensor,
                                dec_cache: List[Dict[str, torch.Tensor]], dec_index: int,
                                dec_mask: torch.Tensor, group: int):
    """One decode step for B_u*G rows sharing B_u prompt caches.

    input_ids [B_u*G, 1]; positions [B_u*G, 1]; prompt_cache: per-layer
    {k, v} [B_u, P, Hkv, D] (read, never written); dec_cache: per-layer
    {k, v} [B_u*G, N, Hkv, D], written in place at `dec_index`; dec_mask
    [B_u*G, N] marks the valid decode slots INCLUDING the one being written.
    Returns (fp32 logits [B_u*G, 1, V], dec_cache).

    Denses stay weight-only when cfg.act_int8 asks for W8A8: the JAX step
    turns it off here (qwen3.py:362-369). Int8 caches (`init_cache(quantize=
    True)`, prompt and decode alike) are read with their scales."""
    dtype = torch_dtype(cfg.dtype)
    h = L.embed(dec.embed, input_ids, dtype)
    bg, t, _ = h.shape
    for lp, pe, de in zip(dec.layers, prompt_cache, dec_cache):
        x = L.rmsnorm(lp.ln1, h, cfg.rms_norm_eps)
        q, k, v = L.qkv_proj(lp.attn, x, dtype)
        # heads from the widths, as `_layer_forward` reads them
        q = q.reshape(bg, t, -1, cfg.head_dim)
        k = k.reshape(bg, t, -1, cfg.head_dim)
        v = v.reshape(bg, t, -1, cfg.head_dim)
        q = L.rmsnorm(lp.attn.q_norm, q, cfg.rms_norm_eps)
        k = L.rmsnorm(lp.attn.k_norm, k, cfg.rms_norm_eps)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        cache_entry_update(de, k, v, dec_index)
        a = _grouped_decode_attention(q, pe["k"], pe["v"], prompt_mask, de["k"], de["v"],
                                      dec_mask, group, pe.get("k_scale"), pe.get("v_scale"),
                                      de.get("k_scale"), de.get("v_scale"))
        h = h + L.dense(lp.attn.o, a.reshape(bg, t, -1), dtype)
        x = L.rmsnorm(lp.ln2, h, cfg.rms_norm_eps)
        h = h + _mlp(lp, cfg, x, dtype)
    h = L.rmsnorm(dec.final_norm, h, cfg.rms_norm_eps)
    return L.lm_logits(dec, h), dec_cache


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -100) -> torch.Tensor:
    """Shifted causal LM loss, mean over supervised tokens (HF semantics:
    logits[:, :-1] predict labels[:, 1:])."""
    logits = logits[:, :-1].float()
    targets = labels[:, 1:]
    valid = targets != ignore_index
    safe = torch.where(valid, targets, 0).long()
    logz = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, safe[..., None])[..., 0]
    return ((logz - gold) * valid).sum() / valid.sum().clamp(min=1)
