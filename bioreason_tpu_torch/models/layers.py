"""Neural-net building blocks (the port of bioreason_tpu/models/layers.py).

Parameters live in small `nn.Module`s; the functions below take the module
the way the JAX functions take their param subtree, so each counterpart
reads the same. Weights are stored in the compute dtype (the JAX package
keeps fp32 masters and casts them to bf16 on every call, which gives the
same values), except norm scales and biases of norms, which stay fp32.

Dense layers are `nn.Linear`, so kernels are stored `[out, in]`: the JAX
package's `[in, out]` kernels are transposed once by `weights.py`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def linear(in_dim: int, out_dim: int, bias: bool, device=None,
           dtype=torch.float32) -> nn.Linear:
    """An `nn.Linear` with uninitialized storage (filled by init or import)."""
    return nn.utils.skip_init(nn.Linear, in_dim, out_dim, bias=bias,
                              device="cpu" if device is None else device, dtype=dtype)


class Embedding(nn.Module):
    def __init__(self, vocab: int, dim: int, device=None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(vocab, dim, device=device, dtype=dtype))


class RMSNorm(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=torch.float32))


class LayerNorm(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=torch.float32))


class SwiGLU(nn.Module):
    def __init__(self, dim: int, hidden: int, bias: bool = False, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.gate = linear(dim, hidden, bias, device, dtype)
        self.up = linear(dim, hidden, bias, device, dtype)
        self.down = linear(hidden, dim, bias, device, dtype)


class GeluMLP(nn.Module):
    def __init__(self, dim: int, hidden: int, bias: bool = False, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.up = linear(dim, hidden, bias, device, dtype)
        self.down = linear(hidden, dim, bias, device, dtype)


def dense(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """x @ W (+ b) in the weight's dtype."""
    return F.linear(x.to(lin.weight.dtype), lin.weight, lin.bias)


def qkv_proj(attn: nn.Module, x: torch.Tensor):
    """Attention input projections -> (q, k, v) [..., q_dim/kv_dim/kv_dim]."""
    return dense(attn.q, x), dense(attn.k, x), dense(attn.v, x)


def embed(emb: Embedding, ids: torch.Tensor) -> torch.Tensor:
    """Row lookup. Ids outside the vocab are clamped for the lookup: the DNA
    placeholder id may lie past the vocab (e.g. 151938 with a 151936 vocab),
    and the splice overwrites those rows anyway. `jnp.take` fills them
    instead; an out-of-range `torch.embedding` on CUDA is a device assert."""
    w = emb.weight
    return F.embedding(ids.clamp(0, w.shape[0] - 1), w)


def lm_logits(dec: nn.Module, h: torch.Tensor) -> torch.Tensor:
    """Vocabulary logits [..., H] -> [..., V] in fp32 (tied embedding or a
    separate `lm_head`). Operands stay in the weight dtype and the products
    accumulate AND come out in fp32, as the JAX einsum with
    preferred_element_type=float32 does: a bf16-output GEMM would round the
    logits and can flip greedy near-ties."""
    w = dec.lm_head.weight if dec.lm_head is not None else dec.embed.weight   # [V, H]
    h2 = h.reshape(-1, h.shape[-1]).to(w.dtype)
    if h2.is_cuda and w.dtype != torch.float32:
        out = torch.mm(h2, w.t(), out_dtype=torch.float32)
    else:
        # products of the stored values are exact in fp32, so upcasting
        # first computes the same function
        out = h2.float() @ w.float().t()
    return out.reshape(*h.shape[:-1], w.shape[0])


def rmsnorm(norm: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in fp32, returned in the input dtype."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * norm.scale).to(x.dtype)


def layernorm(norm: LayerNorm, x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * norm.scale + norm.bias).to(x.dtype)


def swiglu(mlp: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    return dense(mlp.down, F.silu(dense(mlp.gate, x)) * dense(mlp.up, x))


def gelu_mlp(mlp: GeluMLP, x: torch.Tensor) -> torch.Tensor:
    # exact (erf) gelu: HF ESM uses F.gelu's default, not the tanh approximation
    return dense(mlp.down, F.gelu(dense(mlp.up, x), approximate="none"))


# ---------------------------------------------------------------------------
# Rotary position embeddings (NeoX rotate-half convention, used by both Qwen3
# and the NT/ESM rotary variant).
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, T, n_heads, head_dim]; positions: [B, T] int. Angles in fp32."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)            # [hd/2]
    angles = positions[..., None].float() * freqs                     # [B, T, hd/2]
    cos = angles.cos()[:, :, None, :]
    sin = angles.sin()[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def positions_from_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """Position ids robust to LEFT padding: cumsum of the mask minus one,
    clipped at zero (pads get position 0 but are masked out anyway)."""
    return (attention_mask.long().cumsum(-1) - 1).clamp(min=0)


def _normal_(param: torch.Tensor, std: float, generator: Optional[torch.Generator]):
    draw = torch.randn(param.shape, generator=generator, device=param.device,
                       dtype=torch.float32)
    param.copy_(draw.mul_(std))


@torch.no_grad()
def init_normal_(module: nn.Module, generator: Optional[torch.Generator]) -> nn.Module:
    """Random weights with the JAX init's distributions (layers.py:17-28,
    126-127,165-166): dense kernels N(0, 1/in) with zero biases, embeddings
    N(0, 0.02^2), drawn in fp32 from `generator`; norms keep their ones and
    zeros. `jax.random` draws other numbers from the same seed."""
    for mod in module.modules():
        if isinstance(mod, Embedding):
            _normal_(mod.weight, 0.02, generator)
        elif isinstance(mod, nn.Linear):
            _normal_(mod.weight, mod.in_features ** -0.5, generator)
            if mod.bias is not None:
                mod.bias.zero_()
    return module
