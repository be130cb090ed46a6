"""Neural-net building blocks (the port of bioreason_tpu/models/layers.py).

Parameters live in small `nn.Module`s; the functions below take the module
the way the JAX functions take their param subtree, so each counterpart
reads the same. Every function computes in the dtype it is given (the
tower's compute dtype, `cfg.dtype`), whatever dtype a weight is stored in:
frozen weights are stored in the compute dtype, trainable ones (LoRA
adapters, the DNA projection, a fully fine-tuned tower) as fp32 masters that
are cast on every call, as the JAX package does. Norm scales and biases of
norms stay fp32.

Dense layers are `nn.Linear`, so kernels are stored `[out, in]`: the JAX
package's `[in, out]` kernels are transposed once by `weights.py`. A LoRA
adapter rides on its `nn.Linear` as `lora_a` [in, r], `lora_b` [r, out] (the
JAX layouts) and a `lora_scale` buffer; `dense` adds it when present.

Int8 storage (train/quant.py, train/fuse.py; serving, and QLoRA training
with its scales in bf16): an `nn.Linear` or an `Embedding` may hold an int8
`weight` buffer with a float `scale` buffer, one scale per output channel
([out, 1]) or per vocabulary row ([V, 1]);
`dense`, `embed` and `lm_logits` read either storage. An attention module
may hold one fused `qkv` linear in place of `q`, `k` and `v`, and an MLP
one `gateup` in place of `gate` and `up`; an adapter of a fused projection
stays on its own `Adapter` module, added to the split outputs. A `MoE`'s
expert banks are `ExpertBank`s, [E, in, out] as in the JAX package, int8
with [E, 1, out] scales the same way.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, \
    create_selective_checkpoint_contexts

# (generator, rate) of inverted dropout on a LoRA adapter's input
Dropout = Optional[Tuple[torch.Generator, float]]


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


class ExpertBank(nn.Module):
    """One projection of every expert, `weight` [E, in, out] in the JAX
    layout (so `torch.bmm` takes it as it is); int8 storage replaces it by
    an int8 buffer and a `scale` [E, 1, out] (train/quant.py)."""

    def __init__(self, num_experts: int, in_dim: int, out_dim: int, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_experts, in_dim, out_dim, device=device,
                                               dtype=dtype))


class Experts(nn.Module):
    def __init__(self, num_experts: int, dim: int, hidden: int, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.gate = ExpertBank(num_experts, dim, hidden, device, dtype)
        self.up = ExpertBank(num_experts, dim, hidden, device, dtype)
        self.down = ExpertBank(num_experts, hidden, dim, device, dtype)


class MoE(nn.Module):
    """Mixture-of-Experts FFN (Qwen3-MoE family, JAX layers.py:219-232): a
    linear router H -> E without bias and a bank of SwiGLU experts."""

    def __init__(self, dim: int, num_experts: int, hidden: int, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.router = linear(dim, num_experts, False, device, dtype)
        self.experts = Experts(num_experts, dim, hidden, device, dtype)


class GeluMLP(nn.Module):
    def __init__(self, dim: int, hidden: int, bias: bool = False, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.up = linear(dim, hidden, bias, device, dtype)
        self.down = linear(hidden, dim, bias, device, dtype)


class Adapter(nn.Module):
    """The LoRA adapter of a projection whose base weight lives in a fused
    linear (train/fuse.py): `lora_a`, `lora_b` and `lora_scale` alone."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features


def is_int8(mod: nn.Module) -> bool:
    """Whether `mod` (an nn.Linear or an Embedding) stores its weight int8."""
    return mod.weight.dtype == torch.int8


def int8_weight(mod: nn.Module, dtype: torch.dtype) -> torch.Tensor:
    """An int8 weight dequantized in `dtype`: q.to(dtype) * scale.to(dtype),
    the JAX package's order (layers.py:87-88); the product in fp32 cast to
    bf16 afterwards would round differently."""
    return mod.weight.to(dtype) * mod.scale.to(dtype)


class Int8Linear(torch.autograd.Function):
    """y = x @ dequant(q, scale)^T (+ b) whose backward keeps the int8 weight
    and its scale, not the dequantized copy: a frozen int8 dense in training
    (QLoRA) would otherwise hold a float weight per call until the backward,
    more than its int8 storage saves. The backward dequantizes again, in the
    gradient's dtype, to form dx; q and scale take no gradient. The values
    are those of `F.linear` on `int8_weight`, forward and backward."""

    @staticmethod
    def forward(ctx, x, q, scale, bias):
        ctx.save_for_backward(q, scale)
        return F.linear(x, q.to(x.dtype) * scale.to(x.dtype), bias)

    @staticmethod
    def backward(ctx, g):
        q, scale = ctx.saved_tensors
        dx = db = None
        if ctx.needs_input_grad[0]:
            dx = g.matmul(q.to(g.dtype) * scale.to(g.dtype))
        if ctx.needs_input_grad[3]:
            db = g.reshape(-1, g.shape[-1]).sum(0)
        return dx, None, None, db


class Int8Bank(torch.autograd.Function):
    """The expert product x [E, C, in] @ dequant(q, scale) [E, in, out] of an
    int8 bank whose backward keeps the int8 bank and its [E, 1, out] scale,
    not the dequantized copy: under QLoRA `torch.bmm` on `expert_bank` would
    hold a float copy of every bank it read (1.2 GB a layer at
    Qwen3-30B-A3B) until the backward. The backward dequantizes again, in
    the gradient's dtype, for d(input) alone; q and scale take no gradient.
    The values are those of `torch.bmm` on `expert_bank`, forward and
    backward (the counterpart of `Int8Linear` for the banks)."""

    @staticmethod
    def forward(ctx, x, q, scale):
        ctx.save_for_backward(q, scale)
        return torch.bmm(x, q.to(x.dtype) * scale.to(x.dtype))

    @staticmethod
    def backward(ctx, g):
        q, scale = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            dx = torch.bmm(g, (q.to(g.dtype) * scale.to(g.dtype)).transpose(1, 2))
        return dx, None, None


def int8_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq [M, K] int8 @ wq [N, K]^T int8 -> int32 [M, N], exact, through
    `torch._int_mm` (cuBLASLt on the card). CUDA takes M > 16 only: fewer
    rows are padded with zero rows to 17 and sliced off, never sent down
    another path."""
    m = xq.shape[0]
    if m <= 16:
        xq = F.pad(xq, (0, 0, 0, 17 - m))
    return torch._int_mm(xq, wq.t())[:m]


def _w8a8_dot(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """W8A8 product (JAX layers.py:31-53): each token's activations are
    quantized to int8 against their absmax (fp32, clamped at 1e-12), the
    int8 x int8 product accumulates exactly in int32, and the fp32 scales
    of the token and of the output channel apply to it before the cast:
    y = (yi * sx) * sw."""
    sx = (x.abs().amax(-1, keepdim=True).float() / 127.0).clamp(min=1e-12)
    xq = torch.clamp(torch.round(x.float() / sx), -127, 127).to(torch.int8)
    yi = int8_mm(xq.reshape(-1, xq.shape[-1]), lin.weight)
    y = yi.reshape(*x.shape[:-1], -1).float() * sx * lin.scale.reshape(-1)
    return y.to(dtype)


def dense(lin: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype] = None,
          dropout: Dropout = None, act8: bool = False) -> torch.Tensor:
    """x @ W (+ b) (+ the LoRA adapter) in `dtype` (default: x's dtype),
    whatever dtype the weights are stored in. An int8 weight is dequantized
    in `dtype` (`Int8Linear`, whose backward saves the int8 weight), or
    with `act8` (W8A8, cfg.act_int8) runs `_w8a8_dot`; `act8` does nothing
    to a float weight, as in the JAX package."""
    dtype = x.dtype if dtype is None else dtype
    x = x.to(dtype)
    if getattr(lin, "tp", None) is not None:
        if act8 and is_int8(lin):
            raise ValueError("W8A8 (act_int8) under tensor parallelism is not ported: a "
                             "rowwise rank's activation absmax covers its own columns only")
        return tp_dense(lin, x, dtype, dropout)
    bias = None if lin.bias is None else lin.bias.to(dtype)
    if not is_int8(lin):
        y = F.linear(x, lin.weight.to(dtype), bias)
    elif act8:
        y = _w8a8_dot(x, lin, dtype)
        y = y if bias is None else y + bias
    else:
        y = Int8Linear.apply(x, lin.weight, lin.scale, bias)
    d = lora_delta(lin, x, dtype, dropout)
    return y if d is None else y + d


def tp_shared_dense(lins, x: torch.Tensor, dtype: Optional[torch.dtype],
                    drops: Sequence[Dropout]) -> Optional[Tuple[torch.Tensor, ...]]:
    """`dense` of colwise tensor-parallel linears that read one input (q, k
    and v; gate and up) through one Megatron f: `comm.copy_to(x)` once,
    whose backward sums the weight paths' gradients of x over the axis in
    one all-reduce, not one a linear. None unless every linear is colwise
    on one axis (the caller then calls `dense` on each)."""
    from bioreason_tpu_torch.parallel import comm
    tps = [getattr(lin, "tp", None) for lin in lins]
    if tps[0] is None or tps[0][0] != "col" or any(t != tps[0] for t in tps[1:]):
        return None
    dtype = x.dtype if dtype is None else dtype
    x = x.to(dtype)
    xc = comm.copy_to(x, tps[0][1])
    return tuple(tp_dense(lin, x, dtype, dr, xc) for lin, dr in zip(lins, drops))


def tp_dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype,
             dropout: Dropout = None, xc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`dense` of a tensor-parallel linear (parallel/partition.py), `lin.tp`
    = (kind, axis). Colwise: x is replicated over the axis and the weight
    holds this rank's output rows; x's gradient is summed over the axis
    (`comm.copy_to`, or `xc` where `tp_shared_dense` made it for several
    linears) on the weight's path and on the adapter's, whose [.., r]
    intermediate is replicated. Rowwise: x holds this rank's input
    columns; the partial product and the adapter's partial intermediate
    come out of the products in fp32 and are summed over the axis in one
    `comm.reduce_from` before their one rounding to `dtype`, as one
    device's product accumulates in fp32 and rounds once; then the
    replicated `lora_b`. A bias stays whole on every rank (JAX's `P()`):
    a colwise rank adds its slice of the output rows inside its product,
    a rowwise one adds it once to the summed product before the rounding,
    as `F.linear(x, W, b)` adds it on one device.

    An int8 weight and its scale are whole on every rank (JAX places its
    `{q, scale}` leaves `P()`, parallel/partition.py); each rank computes
    on its own part of them. Colwise: its output rows of the weight and of
    the scale, through `Int8Linear`. Rowwise: its input columns of the int8
    weight (`Int8MmF32`: the fp32 partial product of x and the int8 values,
    its backward keeping the int8 slice); the per-output-channel scale
    factors out of the sum over the columns, so it is applied once, in
    fp32, to the product summed over the axis, before the one rounding;
    then the bias."""
    from bioreason_tpu_torch.parallel import comm
    kind, axis = lin.tp
    int8 = is_int8(lin)
    xl = _adapter_input(x, dropout) if has_adapter(lin) else x
    if kind == "col":
        bias = None if lin.bias is None else comm.local_slice(lin.bias, axis, 0).to(dtype)
        xin = comm.copy_to(x, axis) if xc is None else xc
        if int8:
            y = Int8Linear.apply(xin, comm.local_slice(lin.weight, axis, 0),
                                 comm.local_slice(lin.scale, axis, 0), bias)
        else:
            y = F.linear(xin, lin.weight.to(dtype), bias)
        if has_adapter(lin):
            u = comm.copy_to(xl @ lin.lora_a.to(dtype), axis)
            y = y + (u @ lin.lora_b.to(dtype)) * lin.lora_scale.to(dtype)
        return y
    lead, n = x.shape[:-1], lin.out_features
    x2 = x.reshape(-1, x.shape[-1])
    parts = [Int8MmF32.apply(x2, comm.local_slice(lin.weight, axis, 1)) if int8
             else MmF32.apply(x2, lin.weight.to(dtype).t())]
    if has_adapter(lin):
        parts.append(MmF32.apply(xl.reshape(-1, xl.shape[-1]), lin.lora_a.to(dtype)))
    summed = comm.reduce_from(torch.cat(parts, -1) if len(parts) > 1 else parts[0], axis)
    y = summed[:, :n]
    if int8:
        y = y * lin.scale.reshape(-1).float()
    if lin.bias is not None:
        y = y + lin.bias.to(dtype).float()
    y = y.to(dtype).reshape(*lead, n)
    if has_adapter(lin):
        u = summed[:, n:].to(dtype).reshape(*lead, -1)
        y = y + (u @ lin.lora_b.to(dtype)) * lin.lora_scale.to(dtype)
    return y


class MmF32(torch.autograd.Function):
    """`mm_f32` (a @ b accumulated and returned in fp32), differentiable:
    the gradient is cast to the operands' dtype for its two products, as it
    reaches a product whose output is in that dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return (g @ b.t() if ctx.needs_input_grad[0] else None,
                a.t() @ g if ctx.needs_input_grad[1] else None)


class Int8MmF32(torch.autograd.Function):
    """x [M, K] @ q^T of an int8 weight q [N, K] (a rowwise rank's input
    columns), accumulated and returned in fp32 without its scale: the int8
    values are exact in x's dtype. The backward keeps the int8 q, not a
    float copy (as `Int8Linear`), and forms dx in x's dtype; q takes no
    gradient."""

    @staticmethod
    def forward(ctx, x, q):
        ctx.save_for_backward(q)
        ctx.dtype = x.dtype
        return mm_f32(x, q.to(x.dtype).t())

    @staticmethod
    def backward(ctx, g):
        q, = ctx.saved_tensors
        dx = g.to(ctx.dtype) @ q.to(ctx.dtype) if ctx.needs_input_grad[0] else None
        return dx, None


def add_adapter(lin: nn.Module, a: torch.Tensor, b: torch.Tensor, scale: float,
                device=None) -> None:
    """Attach a LoRA adapter to `lin` (an nn.Linear, or an `Adapter`, which
    then needs `device`): fp32 parameters `lora_a` [in, r] and `lora_b`
    [r, out], and the fp32 scalar buffer `lora_scale` (alpha / r)."""
    if (a.shape[0], b.shape[1], a.shape[1]) != (lin.in_features, lin.out_features, b.shape[0]):
        raise ValueError(f"adapter {tuple(a.shape)} x {tuple(b.shape)} does not fit "
                         f"{lin.in_features} -> {lin.out_features}")
    device = lin.weight.device if device is None else device
    lin.lora_a = nn.Parameter(a.detach().to(device=device, dtype=torch.float32))
    lin.lora_b = nn.Parameter(b.detach().to(device=device, dtype=torch.float32))
    lin.register_buffer("lora_scale", torch.tensor(float(scale), dtype=torch.float32,
                                                   device=device))


def has_adapter(lin: nn.Module) -> bool:
    # a Tensor, not only a Parameter: under FSDP the forward reads the
    # gathered adapter in its place (parallel/partition.py)
    return isinstance(getattr(lin, "lora_a", None), torch.Tensor)


def lora_delta(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype,
               dropout: Dropout = None) -> Optional[torch.Tensor]:
    """The adapter's contribution ((x @ A) @ B) * scale in `dtype`, or None
    when `lin` carries no adapter. `dropout` = (generator, rate) applies
    inverted dropout to the adapter input only (PEFT lora_dropout)."""
    if not has_adapter(lin):
        return None
    xl = _adapter_input(x.to(dtype), dropout)
    return ((xl @ lin.lora_a.to(dtype)) @ lin.lora_b.to(dtype)) * lin.lora_scale.to(dtype)


def _adapter_input(x: torch.Tensor, dropout: Dropout) -> torch.Tensor:
    """x with the adapter's inverted dropout applied (`dropout` = (generator,
    rate), or None)."""
    if dropout is None:
        return x
    gen, rate = dropout
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _split_delta(parent: nn.Module, name: str, base: torch.Tensor, x: torch.Tensor,
                 dtype: torch.dtype, dropout: Dropout) -> torch.Tensor:
    """A fused projection's split output plus the adapter left on
    `parent.<name>`, if any."""
    d = lora_delta(getattr(parent, name, None), x, dtype, dropout)
    return base if d is None else base + d


def qkv_proj(attn: nn.Module, x: torch.Tensor, dtype: Optional[torch.dtype] = None,
             drops: Tuple[Dropout, Dropout, Dropout] = (None, None, None),
             act8: bool = False):
    """Attention input projections -> (q, k, v) [..., q_dim/kv_dim/kv_dim].
    With a fused `qkv` (train/fuse.py) one product gives all three, split by
    the widths `o` reads (q) and the rest halved (k, v); the per-projection
    adapters are added to the splits (JAX layers.py:100-123)."""
    if hasattr(attn, "qkv"):
        dtype = x.dtype if dtype is None else dtype
        y = dense(attn.qkv, x, dtype, None, act8)
        q_dim = attn.o.in_features
        kv_dim = (attn.qkv.out_features - q_dim) // 2
        q, k, v = y.split((q_dim, kv_dim, kv_dim), dim=-1)
        return tuple(_split_delta(attn, n, base, x, dtype, dr)
                     for n, base, dr in zip("qkv", (q, k, v), drops))
    shared = None if act8 else tp_shared_dense((attn.q, attn.k, attn.v), x, dtype, drops)
    if shared is not None:
        return shared
    return (dense(attn.q, x, dtype, drops[0], act8), dense(attn.k, x, dtype, drops[1], act8),
            dense(attn.v, x, dtype, drops[2], act8))


def embed(emb: Embedding, ids: torch.Tensor,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Row lookup, cast to `dtype` (default: the table's). Ids outside the
    vocab are clamped for the lookup: the DNA placeholder id may lie past
    the vocab (e.g. 151938 with a 151936 vocab), and the splice overwrites
    those rows anyway. `jnp.take` fills them instead; an out-of-range
    `torch.embedding` on CUDA is a device assert. An int8 table gathers its
    int8 rows and their scales, then multiplies in `dtype` (JAX
    layers.py:130-138).

    A table split over the 'model' axis (`vocab_axis`): the ids are clamped
    to the whole vocabulary first, so the last rank serves an id past it;
    each rank looks up the ids in its own rows, zeros elsewhere, and one
    `comm.reduce_from` sums the ranks' rows (exact: one is nonzero).

    A table sharded over 'fsdp' is gathered for the lookup alone
    (`partition.layer_gathered`)."""
    from bioreason_tpu_torch.parallel.partition import layer_gathered
    with layer_gathered(emb):
        return _embed(emb, ids, dtype)


def _embed(emb: Embedding, ids: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    axis = vocab_axis(emb)
    w, scale, v0, v = vocab_rows(emb, axis)
    ids = ids.clamp(0, v - 1)
    if axis is not None:
        ids = ids - v0
        own = (ids >= 0) & (ids < w.shape[0])
        ids = torch.where(own, ids, 0)
    if scale is not None:
        dtype = torch.float32 if dtype is None else dtype
        out = w[ids].to(dtype) * scale[ids].to(dtype)
    else:
        out = F.embedding(ids, w)
        out = out if dtype is None else out.to(dtype)
    if axis is None:
        return out
    from bioreason_tpu_torch.parallel import comm
    return comm.reduce_from(out.masked_fill(~own[..., None], 0), axis)


def lm_logits(dec: nn.Module, h: torch.Tensor) -> torch.Tensor:
    """Vocabulary logits [..., H] -> [..., V] in fp32 (tied embedding or a
    separate `lm_head`). Operands are in h's dtype and the products
    accumulate AND come out in fp32, as the JAX einsum with
    preferred_element_type=float32 does: a bf16-output GEMM would round the
    logits and can flip greedy near-ties. An int8 head streams its int8
    values as operands and scales the fp32 logits per vocabulary row after
    the product (JAX layers.py:141-160).

    A head split over the 'model' axis (`vocab_axis`): each rank computes
    the logits of its V/m rows (h through `comm.copy_to`), and one
    `comm.gather_replicated` puts them together in vocabulary order, so
    every caller sees [..., V] as on one device. A head sharded over
    'fsdp' is gathered for the product alone (`partition.layer_gathered`)."""
    from bioreason_tpu_torch.parallel.partition import layer_gathered
    head = dec.lm_head if dec.lm_head is not None else dec.embed
    with layer_gathered(head, h.dtype):
        return _lm_logits(head, h)


def _lm_logits(head: nn.Module, h: torch.Tensor) -> torch.Tensor:
    axis = vocab_axis(head)
    w, scale, _, _ = vocab_rows(head, axis)                            # [V(/m), H]
    if axis is not None:
        from bioreason_tpu_torch.parallel import comm
        h = comm.copy_to(h, axis)
    h2 = h.reshape(-1, h.shape[-1])
    logits = mm_f32(h2, w.to(h.dtype).t())
    if scale is not None:
        logits = logits * scale.reshape(-1)
    logits = logits.reshape(*h.shape[:-1], w.shape[0])
    return logits if axis is None else comm.gather_replicated(logits, axis, -1)


def vocab_axis(table: nn.Module):
    """The 'model' axis whose ranks each hold V/m rows of a vocabulary table
    (an `Embedding`, or the `lm_head` linear) under a mesh: `table.tp` =
    ("vocab", axis), set by parallel/partition.py; None on one device."""
    tp = getattr(table, "tp", None)
    return tp[1] if tp is not None and tp[0] == "vocab" else None


def vocab_rows(table: nn.Module, axis=None):
    """(weight rows, their int8 scales or None, the first row's id, the
    whole vocabulary V) that this rank of `axis` computes on: the whole
    table without an axis; with one a float table's stored V/m rows, or
    this rank's V/m rows of an int8 table and its scale, which every rank
    holds whole (JAX places its `{q, scale}` leaves `P()`)."""
    w = table.weight
    scale = table.scale if is_int8(table) else None
    if axis is None:
        return w, scale, 0, w.shape[0]
    if scale is None:
        return w, None, axis.index * w.shape[0], w.shape[0] * axis.size
    from bioreason_tpu_torch.parallel import comm
    n = w.shape[0] // axis.size
    return (comm.local_slice(w, axis, 0), comm.local_slice(scale, axis, 0), axis.index * n,
            w.shape[0])


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of two matrices of one dtype, accumulated and returned in fp32
    (preferred_element_type=float32): cuBLAS with an fp32 output on the
    card; on the CPU the products of the stored values are exact in fp32,
    so upcasting first computes the same function."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The batched `mm_f32`: [N, m, k] @ [N, k, n] -> fp32 [N, m, n]."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


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


def swiglu(mlp: SwiGLU, x: torch.Tensor, dtype: Optional[torch.dtype] = None,
           dropout: Dropout = None, act8: bool = False) -> torch.Tensor:
    """down(silu(gate(x)) * up(x)); with a fused `gateup` (train/fuse.py) one
    product gives gate and up, halved, each plus its own adapter."""
    if hasattr(mlp, "gateup"):
        dtype = x.dtype if dtype is None else dtype
        g, u = dense(mlp.gateup, x, dtype, None, act8).chunk(2, dim=-1)
        g = _split_delta(mlp, "gate", g, x, dtype, dropout)
        u = _split_delta(mlp, "up", u, x, dtype, dropout)
    else:
        shared = None if act8 else tp_shared_dense((mlp.gate, mlp.up), x, dtype,
                                                   (dropout, dropout))
        g, u = shared if shared is not None else (dense(mlp.gate, x, dtype, dropout, act8),
                                                  dense(mlp.up, x, dtype, dropout, act8))
    return dense(mlp.down, F.silu(g) * u, dtype, dropout, act8)


def moe_capacity(n: int, num_experts: int, top_k: int, capacity_factor: float) -> int:
    """Slots per expert for a call of `n` rows: max(k, ceil(cf * k * n / E)),
    the JAX package's float expression (layers.py:262)."""
    return max(top_k, int(math.ceil(capacity_factor * top_k * n / num_experts)))


def moe_route(moe: MoE, xf: torch.Tensor, top_k: int, norm_topk_prob: bool,
              dtype: torch.dtype):
    """Router of `moe_apply` on rows xf [N, H]: logits in `dtype`, softmax
    in fp32, top-k by a STABLE descending sort, so that equal
    probabilities keep the lower expert first, as `jax.lax.top_k` does
    (`torch.topk` does not promise it, and bf16 logits tie often).
    Returns (gates [N, k] fp32, experts [N, k] int64)."""
    probs = torch.softmax(dense(moe.router, xf, dtype).float(), dim=-1)
    vals, idx = probs.sort(dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    if norm_topk_prob:
        vals = vals / vals.sum(-1, keepdim=True).clamp(min=1e-9)
    return vals, idx


def moe_slots(idx: torch.Tensor, num_experts: int, cap: int):
    """Each (token, choice)'s slot in its expert: the count of earlier
    tokens, in flattened (b, t) order, routed to that expert (JAX
    layers.py:263-264); kept where the slot is below `cap`. The count runs
    along the tokens of an [E, N] one-hot, its contiguous axis (a scan
    over the outer axis of [N, E] took 1.3 ms a layer at N = 7168, E = 128
    on an H100). Returns (slot [N, k] int32, keep [N, k] bool)."""
    assign = torch.zeros((num_experts, idx.shape[0]), dtype=torch.int32, device=idx.device)
    assign.scatter_(0, idx.t(), 1)
    slot = (assign.cumsum(1, dtype=torch.int32) - 1).gather(0, idx.t()).t()
    return slot, slot < cap


def expert_bank(bank: ExpertBank, dtype: torch.dtype) -> torch.Tensor:
    """A bank in `dtype`: an int8 one as q.to(dtype) * scale.to(dtype)
    (JAX layers.py:268-273)."""
    return int8_weight(bank, dtype) if is_int8(bank) else bank.weight.to(dtype)


def moe_dispatch(xf: torch.Tensor, idx: torch.Tensor, slot: torch.Tensor,
                 keep: torch.Tensor, num_experts: int, cap: int):
    """Rows xf [N, H] gathered into the experts' buffer [E, C, H] (empty
    slots zero). Returns it and each choice's flat row `dest` [N, k] in
    the buffer; a dropped choice aims at the spare row E * C, which is
    never read."""
    n, h = xf.shape
    dest = torch.where(keep, idx * cap + slot, num_experts * cap)
    token = torch.arange(n, device=xf.device).repeat_interleave(idx.shape[1])
    src = torch.full((num_experts * cap + 1,), n, dtype=torch.int64, device=xf.device)
    src.scatter_(0, dest.reshape(-1), token)
    xpad = torch.cat([xf, xf.new_zeros(1, h)])              # row n: empty slots
    return xpad[src[:-1]].view(num_experts, cap, h), dest


def bank_product(x: torch.Tensor, bank: ExpertBank, dtype: torch.dtype,
                 ep=None) -> torch.Tensor:
    """x [E, C, in] @ the bank [E, in, out] in `dtype`: `torch.bmm` on a
    float bank, `Int8Bank` on an int8 one. Under expert parallelism (`ep`,
    the 'model' axis) x holds this rank's E/m experts: a float bank holds
    only those, an int8 bank and its scale are whole on every rank (JAX's
    `P()`) and this rank's experts are sliced out of them."""
    if is_int8(bank):
        q, scale = bank.weight, bank.scale
        if ep is not None:
            from bioreason_tpu_torch.parallel import comm
            q, scale = comm.local_slice(q, ep, 0), comm.local_slice(scale, ep, 0)
        return Int8Bank.apply(x.to(dtype), q, scale)
    return torch.bmm(x, bank.weight.to(dtype))


def num_experts(moe: MoE) -> int:
    """E of the layer: a float bank under expert parallelism holds E/m."""
    bank, ep = moe.experts.gate, getattr(moe.experts, "ep", None)
    return bank.weight.shape[0] * (1 if ep is None or is_int8(bank) else ep.size)


def moe_experts(moe: MoE, ein: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """silu(x @ gate) * (x @ up) @ down of every expert on its buffer
    [E, C, H] (this rank's experts under expert parallelism): three batched
    products over E in `dtype` (`bank_product`). Returns [E * C, H]."""
    ep = getattr(moe.experts, "ep", None)
    g = bank_product(ein, moe.experts.gate, dtype, ep)
    u = bank_product(ein, moe.experts.up, dtype, ep)
    out = bank_product(F.silu(g) * u, moe.experts.down, dtype, ep)
    return out.view(-1, ein.shape[-1])


def moe_combine(oe: torch.Tensor, vals: torch.Tensor, dest: torch.Tensor,
                keep: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Each token's k expert rows of oe [E * C, H], weighted by its gates
    rounded to `dtype` first, as JAX's `comb` is; a dropped choice weighs
    0. Returns [N, H]."""
    w = torch.where(keep, vals, 0.0).to(dtype)                # [N, k]
    rows = oe[torch.where(keep, dest, 0)]                     # [N, k, H]
    return torch.bmm(w[:, None, :], rows)[:, 0]


def moe_apply(moe: MoE, x: torch.Tensor, top_k: int, norm_topk_prob: bool = True,
              dtype: Optional[torch.dtype] = None,
              capacity_factor: float = 1.25) -> torch.Tensor:
    """The JAX package's capacity MoE (layers.py:235-283) in index form.

    Routing as `moe_route`; every row of x [B, T, H] counts in N, left pads
    and empty slots included, and a token past its expert's capacity C
    (`moe_capacity`) contributes zero. Where JAX builds the one-hot
    dispatch [N, E, C] for its einsums, this gathers the kept rows into an
    [E, C, H] buffer (`moe_dispatch`), runs the experts on it
    (`moe_experts`) and gathers each token's k rows back (`moe_combine`).
    Nothing of N * E * C elements is allocated."""
    b, t, h = x.shape
    n = b * t
    dtype = x.dtype if dtype is None else dtype
    xf = x.reshape(n, h).to(dtype)
    ep, dp = getattr(moe.experts, "ep", None), getattr(moe.experts, "dp", None)
    e = num_experts(moe)
    vals, idx = moe_route(moe, xf, top_k, norm_topk_prob, dtype)
    if dp is None:
        cap = moe_capacity(n, e, top_k, capacity_factor)
        slot, keep = moe_slots(idx, e, cap)
    else:
        slot, keep, cap = _moe_slots_dp(idx, e, n, top_k, capacity_factor, dp)
    if ep is not None:
        return _moe_ep(moe, xf, vals, idx, slot, keep, e, cap, dtype, ep).view(b, t, h)
    ein, dest = moe_dispatch(xf, idx, slot, keep, e, cap)
    oe = moe_experts(moe, ein, dtype)
    return moe_combine(oe, vals, dest, keep, dtype).view(b, t, h)


def _moe_slots_dp(idx, e: int, n: int, top_k: int, capacity_factor: float, dp):
    """`moe_slots` over the global batch when its rows are split over the
    data-parallel axis `dp` (parallel/partition.py): the capacity counts
    every rank's rows, and a token's slot counts the tokens of the ranks
    before this one too (the global row order is rank-major), so the drops
    are the one-device call's. Returns (slot, keep, cap)."""
    from bioreason_tpu_torch.parallel import comm
    cap = moe_capacity(n * dp.size, e, top_k, capacity_factor)
    slot, _ = moe_slots(idx, e, cap)
    counts = torch.bincount(idx.reshape(-1), minlength=e).to(torch.int32)
    before = comm.all_gather(counts[None], dp, 0)[:dp.index].sum(0).to(torch.int32)
    slot = slot + before[idx]
    return slot, slot < cap, cap


def _moe_ep(moe: MoE, xf, vals, idx, slot, keep, e: int, cap: int, dtype, ep):
    """Expert parallelism (parallel/partition.py): the routing, capacity and
    drops are `moe_apply`'s on every rank; this rank runs its E/m experts
    on their slots, the other experts' rows stay zero, and the combine is
    summed over the axis. The expert inputs and the gates sum their
    gradients over the axis (`comm.copy_to`): each rank's path covers only
    its own experts."""
    from bioreason_tpu_torch.parallel import comm
    el = e // ep.size
    ein, dest = moe_dispatch(comm.copy_to(xf, ep), idx, slot, keep, e, cap)
    own = moe_experts(moe, ein[ep.index * el:(ep.index + 1) * el], dtype)
    oe = torch.cat([own.new_zeros(ep.index * el * cap, own.shape[1]), own,
                    own.new_zeros((e - (ep.index + 1) * el) * cap, own.shape[1])])
    return comm.reduce_from(moe_combine(oe, comm.copy_to(vals, ep), dest, keep, dtype), ep)


def gelu_mlp(mlp: GeluMLP, x: torch.Tensor, dtype: Optional[torch.dtype] = None,
             dropout: Dropout = None, act8: bool = False) -> torch.Tensor:
    # exact (erf) gelu: HF ESM uses F.gelu's default, not the tanh approximation
    up = dense(mlp.up, x, dtype, dropout, act8)
    return dense(mlp.down, F.gelu(up, approximate="none"), dtype, dropout, act8)


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


# the matmuls without batch dims (JAX `dots_with_no_batch_dims_saveable`):
# every dense and LoRA product, as F.linear dispatches them; the batched
# attention einsums (bmm) are recomputed, as JAX recomputes them
_SAVED_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn: Callable, cfg) -> Callable:
    """Per-layer rematerialization honoring cfg.remat/remat_policy (JAX
    layers.py:326-336), only while autograd records (`torch.utils.
    checkpoint`, non-reentrant): 'full' recomputes the layer in backward;
    'dots' keeps the outputs of the matmuls without batch dims (`aten.mm` /
    `addmm`: the dense and adapter products) and recomputes the rest, the
    elementwise ops and the attention (torch's selective activation
    checkpointing)."""
    if not cfg.remat:
        return fn
    if cfg.remat_policy not in ("full", "dots"):
        raise ValueError(f"remat_policy={cfg.remat_policy!r}: expected 'full' or 'dots'")
    kw_ckpt = {"use_reentrant": False}
    if cfg.remat_policy == "dots":
        kw_ckpt["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                  _save_dots)

    def wrapped(*args, **kw):
        if not torch.is_grad_enabled():
            return fn(*args, **kw)
        return checkpoint(fn, *args, **kw_ckpt, **kw)
    return wrapped


def layer_fn(fn: Callable, cfg) -> Callable:
    """`remat(fn, cfg)` of a tower layer's fn(lp, h, ...) whose fsdp-sharded
    parameters are all-gathered for the call, cast to h's dtype, inside
    the function that remat wraps (`partition.layer_gathered`): a layer's
    recompute in the backward gathers them again, as JAX's scan AD does,
    and without remat the backward gathers again what it reads of them
    (`regather`). One device, or a whole gather live: fn as it is."""
    from bioreason_tpu_torch.parallel.partition import layer_gathered

    def gathered(lp, h, *args, **kw):
        with layer_gathered(lp, h.dtype, regather=not cfg.remat):
            return fn(lp, h, *args, **kw)
    return remat(gathered, cfg)


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
    126-127,165-166,219-232): dense kernels N(0, 1/in) with zero biases,
    expert banks [E, in, out] N(0, 1/in), embeddings N(0, 0.02^2), drawn
    in fp32 from `generator`; norms keep their ones and zeros.
    `jax.random` draws other numbers from the same seed."""
    for mod in module.modules():
        if isinstance(mod, Embedding):
            _normal_(mod.weight, 0.02, generator)
        elif isinstance(mod, nn.Linear):
            _normal_(mod.weight, mod.in_features ** -0.5, generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, ExpertBank):
            _normal_(mod.weight, mod.weight.shape[1] ** -0.5, generator)
    return module
