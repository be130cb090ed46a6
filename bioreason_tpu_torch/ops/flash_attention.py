"""Flash-attention forward: the hand-written Hopper kernel and its plain
version (the port of the forward half of bioreason_tpu/ops/flash_attention.py).

`flash_attention` launches `csrc/flash_fwd.cu` on CUDA tensors: one kernel
for both Pallas forwards (`_fwd_kernel`, `_fwd_single_kernel`). It reads the
[B, T, H, D] layout through strides and the [B, Tk] key mask as it is, so
none of the TPU wrapper's head-major transposes, block padding or per-head
mask repeat exists here. On CPU tensors it computes `flash_attention_ref`;
on a CUDA tensor it launches the kernel or raises, never anything else.

The backward kernels come with the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from bioreason_tpu_torch.ops.cuda_build import load_library

NEG_INF = -1e30
HEAD_DIMS = (64, 128)

_fwd = None
_build_log = ""


def _fwd_fn():
    global _fwd, _build_log
    if _fwd is None:
        lib, _build_log = load_library("flash_fwd", "flash_fwd.cu")
        fn = lib.flash_fwd_bf16
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p,                 # q k v mask o lse
                       i, i, i, i, i, i,                 # B Tq Tk Hq Hkv D
                       ll, ll, ll, ll, ll, ll,           # q, k strides (b, t, h)
                       ll, ll, ll, ll, ll, ll,           # v, o strides
                       i, i, ctypes.c_float, p]          # causal q_offset scale stream
        fn.restype = ctypes.c_int
        _fwd = fn
    return _fwd


def build() -> str:
    """Compile (if needed) and load the kernel library; returns nvcc's
    output (the ptxas report) if this process built it, else ""."""
    _fwd_fn()
    return _build_log


def flash_attention_ref(q, k, v, kv_mask=None, causal=False, q_offset=None):
    """Plain version: fp32 math, grouped einsums (K/V never repeated).

    Same contract and fully-masked-row semantics as the kernel: returns
    (out [B,Tq,Hq,D] in q's dtype, lse [B,Hq,Tq] fp32); a query row with no
    visible key gives out 0 and lse -1e30."""
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    if q_offset is None:
        q_offset = tk - tq if causal else 0
    qg = q.float().reshape(b, tq, hkv, group, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (d ** -0.5)
    valid = torch.ones((b, 1, 1, 1, tk), dtype=torch.bool, device=q.device)
    if kv_mask is not None:
        valid = kv_mask.bool().reshape(b, 1, 1, 1, tk)
    if causal:
        qi = torch.arange(tq, device=q.device)[:, None] + q_offset
        kj = torch.arange(tk, device=q.device)[None, :]
        valid = valid & (kj <= qi)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p / l_safe, v.float())
    lse = torch.where(l == 0.0, NEG_INF, m + torch.log(l_safe))
    return (out.reshape(b, tq, hq, d).to(q.dtype),
            lse.reshape(b, hq, tq))


def _check(q, k, v, kv_mask):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, T, H, D]")
    b, _, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported (kernel has {HEAD_DIMS})")
    if hq % k.shape[2]:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={k.shape[2]}")
    if kv_mask is not None and tuple(kv_mask.shape) != (b, k.shape[1]):
        raise ValueError(f"kv_mask must be [B, Tk], got {tuple(kv_mask.shape)}")
    if not q.is_cuda:
        return
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"flash_fwd takes bfloat16, {name} is {x.dtype}")
        if (x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:3])
                or x.data_ptr() % 16):
            raise ValueError(f"{name} needs a unit last stride and 16-byte "
                             f"aligned rows, got strides {x.stride()}")
    if kv_mask is not None and kv_mask.device != q.device:
        raise ValueError(f"kv_mask is on {kv_mask.device}, q on {q.device}")


def flash_attention(q, k, v, kv_mask=None, causal=False, q_offset=None,
                    return_lse: bool = False):
    """Drop-in for models.attention.xla_attention on the kernel's contract.

    q [B,Tq,Hq,D], k/v [B,Tk,Hkv,D] bf16 (D in {64, 128}), kv_mask [B,Tk]
    (nonzero = valid), causal means key j <= query i + q_offset, with
    q_offset defaulting to Tk - Tq. Returns out [B,Tq,Hq,D] (and, with
    `return_lse`, lse [B,Hq,Tq] fp32)."""
    _check(q, k, v, kv_mask)
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if q_offset is None:
        q_offset = tk - tq if causal else 0
    if not q.is_cuda:
        out, lse = flash_attention_ref(q, k, v, kv_mask, causal, q_offset)
        return (out, lse) if return_lse else out

    out = torch.empty((b, tq, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, tq), dtype=torch.float32, device=q.device)
    if b == 0 or tq == 0:
        return (out, lse) if return_lse else out
    mask = None
    if kv_mask is not None:
        mask = kv_mask.to(torch.int32).contiguous()
    fn = _fwd_fn()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            b, tq, tk, hq, hkv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            int(bool(causal)), int(q_offset), float(d ** -0.5),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {rc}")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0      # kernel launches since the last reset
