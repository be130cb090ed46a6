"""NT-v2-style bidirectional DNA encoder (the port of
bioreason_tpu/models/nt_encoder.py; ESM-family pre-norm transformer with
rotary embeddings, SwiGLU MLPs and LayerNorm). The fusion model consumes its
last hidden state (reference dna_llm.py:156); no MLM head. Its denses may
be int8 or fused for serving (train/quant.py, train/fuse.py) and take
cfg.act_int8 (JAX nt_encoder.py:73-89). Under a mesh's 'model' axis a rank
holds num_heads / m heads and I / m MLP rows of every layer
(parallel/partition.py), and runs the same code on them. Under its 'fsdp'
axis each layer's parameters are gathered for that layer alone
(`layers.layer_fn`), as JAX's layer scan gathers them (nt_encoder.py:92-93).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from bioreason_tpu_torch.config import EncoderConfig
from bioreason_tpu_torch.models import layers as L
from bioreason_tpu_torch.models.attention import attention
from bioreason_tpu_torch.parallel.sp import shard_sequence, tower_sharded, unshard_sequence
from bioreason_tpu_torch.utils.devices import torch_dtype


class EncoderAttention(nn.Module):
    def __init__(self, d: int, bias: bool, device=None, dtype=torch.float32):
        super().__init__()
        self.q = L.linear(d, d, bias, device, dtype)
        self.k = L.linear(d, d, bias, device, dtype)
        self.v = L.linear(d, d, bias, device, dtype)
        self.o = L.linear(d, d, bias, device, dtype)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig, device=None, dtype=torch.float32):
        super().__init__()
        d = cfg.hidden_size
        self.ln1 = L.LayerNorm(d, device)
        self.attn = EncoderAttention(d, cfg.attn_bias, device, dtype)
        self.ln2 = L.LayerNorm(d, device)
        mlp = L.SwiGLU if cfg.use_swiglu else L.GeluMLP
        self.mlp = mlp(d, cfg.intermediate_size, cfg.mlp_bias, device, dtype)


class NTEncoder(nn.Module):
    """Parameters of the encoder; `encoder_forward` runs it."""

    def __init__(self, cfg: EncoderConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.embed = L.Embedding(cfg.vocab_size, cfg.hidden_size, device, dtype)
        self.layers = nn.ModuleList(EncoderLayer(cfg, device, dtype)
                                    for _ in range(cfg.num_layers))
        self.final_norm = L.LayerNorm(cfg.hidden_size, device)


def _layer_forward(lp: EncoderLayer, h, cfg: EncoderConfig, positions, attention_mask):
    b, t, _ = h.shape
    dtype = h.dtype
    hd = cfg.head_dim
    a8 = cfg.act_int8
    x = L.layernorm(lp.ln1, h, cfg.norm_eps)
    q, k, v = L.qkv_proj(lp.attn, x, dtype, act8=a8)
    # heads from the widths: a tensor-parallel rank holds num_heads / m
    # (parallel/partition.encoder_local_heads)
    q = L.apply_rope(q.reshape(b, t, -1, hd), positions, cfg.rope_theta)
    k = L.apply_rope(k.reshape(b, t, -1, hd), positions, cfg.rope_theta)
    v = v.reshape(b, t, -1, hd)
    a = attention(q, k, v, kv_mask=attention_mask, causal=False, impl=cfg.attention_impl)
    h = h + L.dense(lp.attn.o, a.reshape(b, t, -1), dtype, None, a8)
    x = L.layernorm(lp.ln2, h, cfg.norm_eps)
    mlp = L.swiglu if cfg.use_swiglu else L.gelu_mlp
    return h + mlp(lp.mlp, x, dtype, None, a8)


def encoder_forward(enc: NTEncoder, cfg: EncoderConfig, input_ids: torch.Tensor,
                    attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Returns the last hidden state [B, T, H] in the compute dtype. Layers
    are recomputed in backward when `cfg.remat` and autograd records."""
    b, t = input_ids.shape
    if attention_mask is None:
        attention_mask = torch.ones((b, t), dtype=torch.int32, device=input_ids.device)
    # HF EsmEmbeddings fidelity: ESM token dropout rescales embeddings by
    # (1-0.12)/(1-observed mask ratio) with <mask> embeds zeroed, and pad
    # positions are zeroed
    is_mask = input_ids == cfg.mask_token_id
    src_len = attention_mask.sum(-1).clamp(min=1).float()
    observed = is_mask.sum(-1).float() / src_len
    positions = L.positions_from_mask(attention_mask)
    sp = tower_sharded(cfg.attention_impl)
    if sp:
        # sequence parallelism (parallel/sp.py): from here on this rank
        # holds its chunk of the (right-padded) sequence; the row sums and
        # positions above are the whole sequence's
        input_ids, is_mask, attention_mask, positions = (
            shard_sequence(x) for x in (input_ids, is_mask, attention_mask, positions))
    h = L.embed(enc.embed, input_ids, torch_dtype(cfg.dtype))
    if cfg.token_dropout:
        h = h.masked_fill(is_mask[..., None], 0.0)
        h = h * ((1.0 - 0.15 * 0.8) / (1.0 - observed))[:, None, None].to(h.dtype)
    h = h * attention_mask[..., None].to(h.dtype)

    layer = L.layer_fn(_layer_forward, cfg)
    for lp in enc.layers:
        h = layer(lp, h, cfg, positions, attention_mask)
    h = L.layernorm(enc.final_norm, h, cfg.norm_eps)
    return unshard_sequence(h, t) if sp else h
