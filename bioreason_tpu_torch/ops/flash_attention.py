"""Flash attention: the hand-written Hopper kernels and their plain
versions (the port of bioreason_tpu/ops/flash_attention.py).

`flash_attention` launches `csrc/flash_fwd.cu` on CUDA tensors: one kernel
(TMA, wgmma, a producer warp and two consumer warpgroups) for both Pallas
forwards (`_fwd_kernel`, `_fwd_single_kernel`). When autograd records (a
training step), it runs through `FlashAttention`, a
`torch.autograd.Function` (the JAX `custom_vjp`) whose backward is
`flash_bwd`: `csrc/flash_bwd.cu`, one pass per key tile for the three Pallas
backward kernels (`_dq_kernel`, `_dkv_kernel`, `_bwd_single_kernel`), with a
prep pass before it (delta, and the fp32 dq scratch zeroed) and a convert
pass after it (dq to bf16). Without autograd (serving) it launches the
forward alone.

The kernels read the [B, T, H, D] layout through strides and the [B, Tk]
key mask as it is, so none of the TPU wrapper's head-major transposes,
block padding or per-head mask repeat exists here. On CPU tensors the
wrappers compute `flash_attention_ref` / `flash_attention_bwd_ref`; on a
CUDA tensor they launch the kernel or raise, never anything else. Each
wrapper counts its launches (`flash_attention.launches`,
`flash_bwd.launches`).

The two sources also hold the banded kernels of ops/local_attention.py
(C entries `local_fwd_bf16`, `local_bwd_bf16`): one library per source,
`kernel_fn(entry)` finds an entry in its library.
"""

from __future__ import annotations

import ctypes

import torch

from bioreason_tpu_torch.ops.cuda_build import load_libraries

NEG_INF = -1e30
HEAD_DIMS = (64, 128)

LIBRARIES = ("flash_fwd", "flash_bwd")            # csrc/<name>.cu
# C entry `<entry>_bf16` -> the library that holds it
_LIBRARY_OF = {"flash_fwd": "flash_fwd", "flash_bwd": "flash_bwd",
               "local_fwd": "flash_fwd", "local_bwd": "flash_bwd"}
_libs = {}
_fns = {}
_build_logs = {}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "flash_fwd": [_P, _P, _P, _P, _P, _P,                 # q k v mask o lse
                  _I, _I, _I, _I, _I, _I,                 # B Tq Tk Hq Hkv D
                  _LL, _LL, _LL, _LL, _LL, _LL,           # q, k strides (b, t, h)
                  _LL, _LL, _LL, _LL, _LL, _LL,           # v, o strides
                  _I, _I, ctypes.c_float, _P],            # causal q_offset scale stream
    "flash_bwd": [_P, _P, _P, _P, _P, _P, _P,             # q k v mask o lse do
                  _P, _P, _P, _P, _P, _P,                 # dq dk dv lse_log2 delta dq_accum
                  _I, _I, _I, _I, _I, _I,                 # B Tq Tk Hq Hkv D
                  ctypes.POINTER(_LL),                    # 24 strides
                  _I, _I, ctypes.c_float, _P],            # causal q_offset scale stream
    "local_fwd": [_P, _P, _P, _P, _P, _P,                 # q k v mask o lse
                  _I, _I, _I, _I, _I,                     # B T Hq Hkv D
                  _LL, _LL, _LL, _LL, _LL, _LL,           # q, k strides (b, t, h)
                  _LL, _LL, _LL, _LL, _LL, _LL,           # v, o strides
                  _I, ctypes.c_float, _P],                # window scale stream
    "local_bwd": [_P, _P, _P, _P, _P, _P, _P,             # q k v mask o lse do
                  _P, _P, _P, _P,                         # dq dk dv delta
                  _I, _I, _I, _I, _I,                     # B T Hq Hkv D
                  ctypes.POINTER(_LL),                    # 24 strides
                  _I, ctypes.c_float, _P],                # window scale stream
}


def _load(*names: str) -> None:
    """Build (one nvcc per source, run together) and load the libraries
    csrc/<name>.cu that are not loaded yet."""
    missing = [n for n in names if n not in _libs]
    if not missing:
        return
    for name, (lib, log) in load_libraries({n: f"{n}.cu" for n in missing}).items():
        _build_logs[name] = log
        _libs[name] = lib


def kernel_fn(entry: str):
    """The C entry `<entry>_bf16` ("flash_fwd", "flash_bwd", "local_fwd",
    "local_bwd"), its library built at first use."""
    if entry not in _fns:
        _load(_LIBRARY_OF[entry])
        fn = getattr(_libs[_LIBRARY_OF[entry]], f"{entry}_bf16")
        fn.argtypes = _ARGTYPES[entry]
        fn.restype = ctypes.c_int
        _fns[entry] = fn
    return _fns[entry]


def build(*names: str) -> dict:
    """Compile (if needed) and load kernel libraries (`LIBRARIES` by
    default), their builds run together. Returns name -> nvcc's output (the
    ptxas report) if this process built it, else ""."""
    names = names or LIBRARIES
    _load(*names)
    return {n: _build_logs.get(n, "") for n in names}


def _visible(q, k, kv_mask, causal, q_offset):
    """[B|1, 1, 1, Tq|1, Tk] bool: key j visible to query i."""
    b, tq = q.shape[:2]
    tk = k.shape[1]
    valid = torch.ones((b, 1, 1, 1, tk), dtype=torch.bool, device=q.device)
    if kv_mask is not None:
        valid = kv_mask.bool().reshape(b, 1, 1, 1, tk)
    if causal:
        qi = torch.arange(tq, device=q.device)[:, None] + q_offset
        kj = torch.arange(tk, device=q.device)[None, :]
        valid = valid & (kj <= qi)
    return valid


def flash_attention_ref(q, k, v, kv_mask=None, causal=False, q_offset=None):
    """Plain version: fp32 math, grouped einsums (K/V never repeated).

    Same contract and fully-masked-row semantics as the kernel: returns
    (out [B,Tq,Hq,D] in q's dtype, lse [B,Hq,Tq] fp32); a query row with no
    visible key gives out 0 and lse -1e30."""
    if q_offset is None:
        q_offset = k.shape[1] - q.shape[1] if causal else 0
    return attention_ref(q, k, v, _visible(q, k, kv_mask, causal, q_offset))


def attention_ref(q, k, v, valid):
    """`flash_attention_ref` over any visibility mask `valid`, a bool
    tensor that broadcasts to [B, Hkv, group, Tq, Tk]."""
    b, tq, hq, d = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    qg = q.float().reshape(b, tq, hkv, group, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (d ** -0.5)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p / l_safe, v.float())
    lse = torch.where(l == 0.0, NEG_INF, m + torch.log(l_safe))
    return (out.reshape(b, tq, hq, d).to(q.dtype),
            lse.reshape(b, hq, tq))


def flash_attention_bwd_ref(q, k, v, kv_mask, causal, q_offset, out, lse, dout):
    """Plain backward of `flash_attention_ref`: fp32 math, grouped einsums,
    P recomputed from the saved LSE (selected to 0 on invalid pairs, so a
    fully masked row gives dq = 0), delta = rowsum(dO * O). Returns
    (dq, dk, dv) in the dtypes of q, k, v."""
    dq, dk, dv = attention_bwd_ref(q, k, v, _visible(q, k, kv_mask, causal, q_offset), out,
                                   lse, dout)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_bwd_ref(q, k, v, valid, out, lse, dout):
    """`flash_attention_bwd_ref` over any visibility mask `valid` (as in
    `attention_ref`); returns fp32 (dq, dk, dv)."""
    b, tq, hq, d = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    scale = d ** -0.5
    qg = q.float().reshape(b, tq, hkv, group, d)
    dog = dout.float().reshape(b, tq, hkv, group, d)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
    lse_g = lse.float().reshape(b, hkv, group, tq, 1)
    p = torch.exp(torch.where(valid, s - lse_g, -torch.inf))
    delta = (dout.float() * out.float()).sum(-1)                       # [B, Tq, Hq]
    delta = delta.reshape(b, tq, hkv, group).permute(0, 2, 3, 1)[..., None]
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vf)
    ds = p * (dp - delta)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    return dq.reshape(b, tq, hq, d), dk, dv


def _strides_ok(x) -> bool:
    """The kernels' stride rule (TMA's): a unit last stride and the other
    strides multiples of 16 bytes (8 bf16 elements)."""
    return x.stride(-1) == 1 and not any(s % 8 for s in x.stride()[:3])


def _aligned(x) -> bool:
    """The kernels' layout rule: the stride rule and a 16-byte aligned base."""
    return _strides_ok(x) and not x.data_ptr() % 16


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
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not _strides_ok(x):
            raise ValueError(f"{name} needs a unit last stride and strides that are "
                             f"multiples of 8 elements, got {x.stride()}")
    if not q.is_cuda:
        return
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"the flash kernels take bfloat16, {name} is {x.dtype}")
        if not _aligned(x):
            raise ValueError(f"{name} needs a unit last stride and 16-byte "
                             f"aligned rows, got strides {x.stride()}")
    if kv_mask is not None and kv_mask.device != q.device:
        raise ValueError(f"kv_mask is on {kv_mask.device}, q on {q.device}")


def _mask_i32(kv_mask):
    return None if kv_mask is None else kv_mask.to(torch.int32).contiguous()


def _forward(q, k, v, kv_mask, causal, q_offset):
    """(out, lse): the kernel on a CUDA tensor, the plain version on a CPU one."""
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, kv_mask, causal, q_offset)
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, tq, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, tq), dtype=torch.float32, device=q.device)
    if b == 0 or tq == 0:
        return out, lse
    if tk == 0:                       # no key: every row is fully masked
        return out.zero_(), lse.fill_(NEG_INF)
    mask = _mask_i32(kv_mask)
    rc = kernel_fn("flash_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(),
        out.data_ptr(), lse.data_ptr(),
        b, tq, tk, hq, hkv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(bool(causal)), int(q_offset), float(d ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {rc}")
    flash_attention.launches += 1
    return out, lse


def flash_bwd(q, k, v, kv_mask, causal, q_offset, out, lse, dout):
    """Gradients (dq, dk, dv) of `flash_attention` given the forward's out
    and lse and the output gradient dout. Launches `csrc/flash_bwd.cu` on
    CUDA tensors (a prep pass for delta = rowsum(dO * O), the backward
    kernel, a convert pass for dq; one launch to the count) and computes
    `flash_attention_bwd_ref` on CPU tensors. On the card dq is summed by
    the TMA unit's fp32 reduce-adds in no fixed order, so it is not bitwise
    reproducible."""
    if not q.is_cuda:
        return flash_attention_bwd_ref(q, k, v, kv_mask, causal, q_offset, out, lse, dout)
    _check(q, k, v, kv_mask)
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    for name, x, shape in (("out", out, q.shape), ("dout", dout, q.shape),
                           ("lse", lse, (b, hq, tq))):
        if tuple(x.shape) != tuple(shape) or x.device != q.device:
            raise ValueError(f"{name} must be {tuple(shape)} on {q.device}, "
                             f"got {tuple(x.shape)} on {x.device}")
    if out.dtype != torch.bfloat16 or lse.dtype != torch.float32:
        raise ValueError(f"flash_bwd takes bf16 out and fp32 lse, got {out.dtype}, {lse.dtype}")
    dout = dout.to(torch.bfloat16)
    if not _aligned(dout):
        # autograd may hand a strided grad; the kernel reads rows of 16 bytes
        dout = dout.contiguous()
    if not _aligned(out):
        raise ValueError(f"out needs a unit last stride and 16-byte aligned rows, "
                         f"got strides {out.stride()}")
    lse = lse.contiguous()
    dq = torch.empty((b, tq, hq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, tk, hkv, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, tk, hkv, d), dtype=v.dtype, device=q.device)
    if b == 0 or tq == 0 or tk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # fp32 scratch, filled by the prep pass: dq_accum [B, Hq, Tq_pad, D],
    # lse * log2(e) and delta [B*Hq, Tq_pad] (Tq_pad = Tq rounded up to 64)
    rows = b * hq * (-(-tq // 64) * 64)
    ws = torch.empty(rows * (d + 2), dtype=torch.float32, device=q.device)
    dq_accum, lse_log2, delta = ws[:rows * d], ws[rows * d:rows * (d + 1)], ws[rows * (d + 1):]
    mask = _mask_i32(kv_mask)
    strides = (ctypes.c_longlong * 24)(*(s for x in (q, k, v, out, dout, dq, dk, dv)
                                         for s in x.stride()[:3]))
    rc = kernel_fn("flash_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(),
        out.data_ptr(), lse.data_ptr(), dout.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        lse_log2.data_ptr(), delta.data_ptr(), dq_accum.data_ptr(),
        b, tq, tk, hq, hkv, d, strides,
        int(bool(causal)), int(q_offset), float(d ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd launch failed: cudaError {rc}")
    flash_bwd.launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """`flash_attention` with its gradient: forward `flash_fwd` (out and
    the fp32 LSE, which is not differentiable), backward `flash_bwd`. Saves
    q, k, v, the mask, out and lse; nothing of the [Tq, Tk] scores."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, q_offset):
        out, lse = _forward(q, k, v, kv_mask, causal, q_offset)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, kv_mask, ctx.causal, ctx.q_offset, out, lse, dout)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, kv_mask=None, causal=False, q_offset=None,
                    return_lse: bool = False):
    """Drop-in for models.attention.xla_attention on the kernel's contract.

    q [B,Tq,Hq,D], k/v [B,Tk,Hkv,D] bf16 (D in {64, 128}), kv_mask [B,Tk]
    (nonzero = valid), causal means key j <= query i + q_offset, with
    q_offset defaulting to Tk - Tq. Returns out [B,Tq,Hq,D] (and, with
    `return_lse`, lse [B,Hq,Tq] fp32). Differentiable in q, k and v."""
    _check(q, k, v, kv_mask)
    tq, tk = q.shape[1], k.shape[1]
    if q_offset is None:
        q_offset = tk - tq if causal else 0
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out, lse = FlashAttention.apply(q, k, v, kv_mask, causal, q_offset)
    else:
        out, lse = _forward(q, k, v, kv_mask, causal, q_offset)
    return (out, lse) if return_lse else out


flash_attention.launches = 0      # flash_fwd launches since the last reset
flash_bwd.launches = 0            # flash_bwd launches since the last reset
