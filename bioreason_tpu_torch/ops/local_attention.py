"""Banded (sliding-window) bidirectional attention for long DNA: the
hand-written Hopper kernels and their plain versions (the port of
bioreason_tpu/ops/local_attention.py).

Query i sees key j iff |i - j| <= window and kv_mask[j], on array indices,
so the work is O(T * window) instead of O(T^2). Self-attention only
(Tq == Tk). `local_attention` launches `local_fwd` (the C entry
`local_fwd_bf16` of csrc/flash_fwd.cu: `local_fwd_kernel`, the TMA + wgmma
body of flash_fwd with the band's tile range and predicate) on CUDA tensors,
for the Pallas `_fwd_kernel`. When autograd records, it runs through
`LocalAttention`, a `torch.autograd.Function` whose backward is `local_bwd`
(`local_bwd_bf16` of csrc/flash_bwd.cu: flash_bwd's prep pass,
`local_bwd_kernel` and its convert pass) for the Pallas `_dq_kernel` and
`_dkv_kernel`.

The kernels read the [B, T, H, D] layout through strides and the [B, T]
key mask as it is and mask ragged edges themselves, so the TPU wrapper's
head-major transposes, block padding and per-head mask repeat have no
counterpart, nor its `block` argument (a TPU tiling choice that changes no
result). On CPU tensors the wrappers compute `local_attention_ref` /
`local_attention_bwd_ref` at any head dim, as the JAX kernel does in
interpret mode; on a CUDA tensor they launch the kernel (bf16, D in
{64, 128}) or raise, never anything else. Each wrapper counts its launches
(`local_attention.launches`, `local_bwd.launches`).
"""

from __future__ import annotations

import ctypes

import torch

from bioreason_tpu_torch.ops import flash_attention as FA
from bioreason_tpu_torch.utils.debug_nans import check_outputs

NEG_INF = FA.NEG_INF
Q_CHUNK = 1024          # query rows per step of the plain versions


def _band(c0, c1, k0, k1, window, kv_mask, device):
    """Visibility [B|1, 1, 1, c1-c0, k1-k0] of keys k0..k1 to queries c0..c1."""
    qi = torch.arange(c0, c1, device=device)[:, None]
    kj = torch.arange(k0, k1, device=device)[None, :]
    valid = ((qi - kj).abs() <= window)[None, None, None]
    if kv_mask is not None:
        valid = valid & kv_mask[:, k0:k1].bool()[:, None, None, None, :]
    return valid


def _chunks(t, window):
    """(query rows c0..c1, the keys k0..k1 their band reaches)."""
    for c0 in range(0, t, Q_CHUNK):
        c1 = min(t, c0 + Q_CHUNK)
        yield c0, c1, max(0, c0 - window), min(t, c1 + window)


def local_attention_ref(q, k, v, window, kv_mask=None):
    """Plain version: fp32 math, grouped einsums, the band on array indices,
    over `Q_CHUNK` query rows at a time (each with the keys its band
    reaches, so memory is O(T * window) too). Returns (out [B,T,Hq,D] in
    q's dtype, lse [B,Hq,T] fp32); a query row with no visible key gives
    out 0 and lse -1e30, as the kernels do."""
    t = q.shape[1]
    outs, lses = [], []
    for c0, c1, k0, k1 in _chunks(t, window):
        o, lse = FA.attention_ref(q[:, c0:c1], k[:, k0:k1], v[:, k0:k1],
                                  _band(c0, c1, k0, k1, window, kv_mask, q.device))
        outs.append(o)
        lses.append(lse)
    return torch.cat(outs, 1), torch.cat(lses, 2)


def local_attention_bwd_ref(q, k, v, window, kv_mask, out, lse, dout):
    """Plain backward of `local_attention_ref`: fp32, P from the saved LSE
    (selected to 0 off the band and on masked keys, so a fully masked row
    gives dq = 0), delta = rowsum(dO * O), dk and dv summed over the query
    chunks in fp32. Returns (dq, dk, dv) in the dtypes of q, k, v."""
    t = q.shape[1]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for c0, c1, k0, k1 in _chunks(t, window):
        a, b, c = FA.attention_bwd_ref(q[:, c0:c1], k[:, k0:k1], v[:, k0:k1],
                                       _band(c0, c1, k0, k1, window, kv_mask, q.device),
                                       out[:, c0:c1], lse[:, :, c0:c1], dout[:, c0:c1])
        dq[:, c0:c1] = a
        dk[:, k0:k1] += b
        dv[:, k0:k1] += c
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, window, kv_mask):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, T, H, D]")
    if q.shape[1] != k.shape[1]:
        raise ValueError("local_attention is for self-attention (Tq == Tk)")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.is_cuda:
        FA._check(q, k, v, kv_mask)       # the kernels' dtype, head dims, layout


def _forward(q, k, v, kv_mask, window):
    """(out, lse): the kernel on a CUDA tensor, the plain version on a CPU one."""
    if not q.is_cuda:
        return local_attention_ref(q, k, v, window, kv_mask)
    b, t, hq, d = q.shape
    out = torch.empty((b, t, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    if b == 0 or t == 0:
        return out, lse
    mask = FA._mask_i32(kv_mask)
    rc = FA.kernel_fn("local_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(),
        out.data_ptr(), lse.data_ptr(),
        b, t, hq, k.shape[2], d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        min(window, t), float(d ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"local_fwd launch failed: cudaError {rc}")
    local_attention.launches += 1
    check_outputs("local_fwd", out, lse)
    return out, lse


def local_bwd(q, k, v, window, kv_mask, out, lse, dout):
    """Gradients (dq, dk, dv) of `local_attention` given the forward's out
    and lse and the output gradient dout. Launches `local_bwd_bf16` of
    csrc/flash_bwd.cu on CUDA tensors (a prep pass for delta = rowsum(dO *
    O), the banded kernel with the GQA group summed in registers and dq added
    into an fp32 scratch, a convert pass for dq; one launch to the count) and
    computes `local_attention_bwd_ref` on CPU tensors. On the card dq is
    summed by the TMA unit's fp32 reduce-adds in no fixed order, so it is
    not bitwise reproducible."""
    _check(q, k, v, window, kv_mask)
    if not q.is_cuda:
        return local_attention_bwd_ref(q, k, v, window, kv_mask, out, lse, dout)
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    for name, x, shape in (("out", out, q.shape), ("dout", dout, q.shape),
                           ("lse", lse, (b, hq, t))):
        if tuple(x.shape) != tuple(shape) or x.device != q.device:
            raise ValueError(f"{name} must be {tuple(shape)} on {q.device}, "
                             f"got {tuple(x.shape)} on {x.device}")
    if out.dtype != torch.bfloat16 or lse.dtype != torch.float32:
        raise ValueError(f"local_bwd takes bf16 out and fp32 lse, got {out.dtype}, {lse.dtype}")
    dout = dout.to(torch.bfloat16)
    if not FA._aligned(dout):
        # autograd may hand a strided grad; the kernel reads rows of 16 bytes
        dout = dout.contiguous()
    if not FA._aligned(out):
        raise ValueError(f"out needs a unit last stride and 16-byte aligned rows, "
                         f"got strides {out.stride()}")
    lse = lse.contiguous()
    dq = torch.empty((b, t, hq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, t, hkv, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, t, hkv, d), dtype=v.dtype, device=q.device)
    if b == 0 or t == 0:
        return dq, dk, dv
    dq_accum, lse_log2, delta = FA.bwd_workspace(b, hq, t, d, q.device)
    mask = FA._mask_i32(kv_mask)
    strides = (ctypes.c_longlong * 24)(*(s for x in (q, k, v, out, dout, dq, dk, dv)
                                         for s in x.stride()[:3]))
    rc = FA.kernel_fn("local_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(),
        out.data_ptr(), lse.data_ptr(), dout.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        lse_log2.data_ptr(), delta.data_ptr(), dq_accum.data_ptr(),
        b, t, hq, hkv, d, strides, min(window, t), float(d ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"local_bwd launch failed: cudaError {rc}")
    local_bwd.launches += 1
    check_outputs("local_bwd", dq, dk, dv)
    return dq, dk, dv


class LocalAttention(torch.autograd.Function):
    """`local_attention` with its gradient: forward `local_fwd` (out and the
    fp32 LSE, which is not differentiable), backward `local_bwd`. Saves q,
    k, v, the mask, out and lse; nothing of the band's scores."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, window):
        out, lse = _forward(q, k, v, kv_mask, window)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.window = window
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = local_bwd(q, k, v, ctx.window, kv_mask, out, lse, dout)
        return dq, dk, dv, None, None


def local_attention(q, k, v, window: int, kv_mask=None, return_lse: bool = False):
    """Banded bidirectional attention: query i attends keys |i - j| <= window.

    q [B,T,Hq,D], k/v [B,T,Hkv,D] (GQA: kv head h // (Hq/Hkv)), kv_mask
    [B,T] (nonzero = valid) -> out [B,T,Hq,D] (and, with `return_lse`, lse
    [B,Hq,T] fp32). Differentiable in q, k and v. Raises ValueError when
    Tq != Tk, and on a CUDA tensor the kernels do not take."""
    window = int(window)
    _check(q, k, v, window, kv_mask)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out, lse = LocalAttention.apply(q, k, v, kv_mask, window)
    else:
        out, lse = _forward(q, k, v, kv_mask, window)
    return (out, lse) if return_lse else out


local_attention.launches = 0      # local_fwd launches since the last reset
local_bwd.launches = 0            # local_bwd launches since the last reset
