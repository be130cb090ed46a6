"""The port's flash attention, forward and backward, against the JAX
package's Pallas kernels, run as the JAX tests run them on the CPU
(interpret mode).

`flash_attention_ref` and `flash_attention_bwd_ref` are the plain versions
the port's wrappers compute on CPU tensors, and the functions the CUDA
kernels are held to on the card by `chip_smoke.py` (the kernel itself cannot run here: there is no nvcc and no
card). fp32 inputs, atol 1e-5: both sides compute in fp32 and differ only
in summation order and the online-softmax rescaling.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioreason_tpu.ops import flash_attention as jfa
from bioreason_tpu_torch.models.attention import attention, use_kernel, xla_attention
from bioreason_tpu_torch.ops import flash_attention as tfa

ATOL = 1e-5


def inputs(b, tq, tk, hq, hkv, d, seed):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, tq, hq, d), np.float32)
    k = r.standard_normal((b, tk, hkv, d), np.float32)
    v = r.standard_normal((b, tk, hkv, d), np.float32)
    return q, k, v


def jax_lse(q, k, v, mask, causal, q_offset, block_q, block_k):
    """The Pallas forward's fp32 LSE [B, Hq, Tq] (shapes divide the blocks)."""
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    qf = jnp.asarray(q).transpose(0, 2, 1, 3).reshape(b * hq, tq, d)
    kf = jnp.asarray(k).transpose(0, 2, 1, 3).reshape(b * hkv, tk, d)
    vf = jnp.asarray(v).transpose(0, 2, 1, 3).reshape(b * hkv, tk, d)
    maskf = jnp.repeat(jnp.asarray(mask, jnp.int32), hq, axis=0)[:, None, :]
    _, lse = jfa._flash_fwd_impl(qf, kf, vf, maskf, causal, q_offset, block_q,
                                 block_k, True)
    return np.asarray(lse).reshape(b, hq, tq)


# (name, B, Tq, Tk, Hq, Hkv, D, causal, q_offset, block_q, block_k, mask kind)
CASES = [
    # bidirectional encoder with a key-padding mask, single-block kernel
    ("bidir_mask_single", 2, 128, 128, 4, 4, 16, False, None, 128, 128, "right"),
    # causal tq == tk: the JAX default picks the single-block kernel with
    # causal row groups (_row_groups)
    ("causal_single_rowgroups", 1, 256, 256, 4, 2, 16, True, None, 256, 256, "none"),
    # the tiled kernel, forced by small blocks, bidirectional with a mask
    ("tiled_bidir_mask", 2, 64, 96, 4, 2, 16, False, None, 32, 32, "right"),
    # prefill into a larger cache: causal, q_offset 0, left-padded prompt
    # with fully masked (pad) query rows
    ("prefill_q_offset0", 2, 64, 96, 4, 2, 16, True, 0, 32, 32, "left"),
    # causal with q_offset > 0 (queries past a cached prefix)
    ("causal_q_offset_pos", 1, 32, 96, 4, 1, 16, True, 48, 32, 32, "none"),
    # every key of one batch row masked: out 0, lse -1e30
    ("fully_masked_row", 2, 32, 64, 2, 2, 16, False, None, 32, 32, "empty"),
]


def make_mask(kind, b, tk, seed):
    mask = np.ones((b, tk), np.int32)
    r = np.random.default_rng(seed)
    if kind == "right":
        for i in range(b):
            mask[i, r.integers(tk // 3, tk):] = 0
    elif kind == "left":
        for i in range(b):
            mask[i, :r.integers(1, tk // 3)] = 0
            mask[i, tk - tk // 3:] = 0        # decode slots not yet written
    elif kind == "empty":
        mask[0] = 0
    return mask


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_ref_matches_pallas(case):
    _, b, tq, tk, hq, hkv, d, causal, q_offset, bq, bk, mkind = case
    q, k, v = inputs(b, tq, tk, hq, hkv, d, seed=len(mkind) + tq)
    mask = make_mask(mkind, b, tk, seed=tk)
    out, lse = tfa.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), torch.from_numpy(mask),
                                       causal, q_offset)
    ref = jfa.flash_attention(q, k, v, kv_mask=mask, causal=causal, q_offset=q_offset,
                              block_q=bq, block_k=bk, interpret=True)
    qo = q_offset if q_offset is not None else (tk - tq if causal else 0)
    ref_lse = jax_lse(q, k, v, mask, causal, qo, bq, bk)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=ATOL, rtol=1e-6)
    # rows with no visible key: out exactly 0, lse -1e30, in both
    visible = np.broadcast_to(mask[:, None, :], (b, tq, tk)).astype(bool)
    if causal:
        visible = visible & (np.arange(tk)[None, None, :]
                             <= np.arange(tq)[None, :, None] + qo)
    empty = ~visible.any(-1)                                   # [B, Tq]
    if mkind in ("left", "empty"):
        assert empty.any()
    assert np.all(out.numpy()[empty] == 0.0)
    assert np.all(lse.numpy().transpose(0, 2, 1)[empty] == tfa.NEG_INF)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    q, k, v = (torch.from_numpy(x) for x in inputs(2, 40, 72, 4, 2, 64, seed=3))
    mask = torch.from_numpy(make_mask("left", 2, 72, seed=4))
    before = tfa.flash_attention.launches
    out, lse = tfa.flash_attention(q, k, v, mask, causal=True, q_offset=0, return_lse=True)
    ref_out, ref_lse = tfa.flash_attention_ref(q, k, v, mask, True, 0)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert tfa.flash_attention.launches == before


def test_wrapper_default_q_offset_is_tk_minus_tq():
    q, k, v = (torch.from_numpy(x) for x in inputs(1, 16, 48, 2, 2, 64, seed=5))
    a = tfa.flash_attention(q, k, v, causal=True)
    b = tfa.flash_attention(q, k, v, causal=True, q_offset=32)
    c = tfa.flash_attention(q, k, v, causal=True, q_offset=0)
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("bad", ["head_dim", "gqa", "mask_shape", "stride"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    d = 32 if bad == "head_dim" else 64
    hkv = 3 if bad == "gqa" else 2
    q, k, v = (torch.from_numpy(x) for x in inputs(2, 8, 8, 4, hkv, d, seed=6))
    if bad == "stride":
        # rows 68 elements apart: TMA takes strides in 16-byte multiples only
        q = torch.zeros((2, 8, 4, 68), dtype=q.dtype)[..., :64].copy_(q)
    mask = torch.ones((2, 9 if bad == "mask_shape" else 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k, v, mask)


def test_plain_attention_matches_jax_xla_attention_on_valid_rows():
    """The decode path (grouped einsums) against xla_attention; the two
    differ on fully masked rows (mean of V here and there, 0 in the kernel),
    so the rows compared are the ones with a visible key."""
    q, k, v = inputs(2, 1, 40, 4, 2, 16, seed=7)
    mask = make_mask("right", 2, 40, seed=8)
    from bioreason_tpu.models.attention import xla_attention as jax_xla
    out = xla_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_xla(q, k, v, mask)),
                               atol=ATOL, rtol=0)


def test_dispatch_rule():
    """`auto` takes the kernel for a CUDA tensor with Tq > 1, whatever its
    head dim (the wrapper raises on one it does not take); decode (Tq == 1)
    and CPU tensors take the grouped einsums."""
    q = torch.zeros((1, 4, 2, 64), dtype=torch.bfloat16)
    assert not use_kernel(q)                       # on the CPU
    q, k, v = (torch.from_numpy(x) for x in inputs(1, 6, 6, 2, 2, 64, seed=9))
    assert torch.equal(attention(q, k, v, causal=True),
                       xla_attention(q, k, v, causal=True))
    with pytest.raises(ValueError):
        attention(q, k, v, impl="splash")


# -- backward ----------------------------------------------------------------------
# (name, B, Tq, Tk, Hq, Hkv, D, causal, q_offset, block_q, block_k, mask kind)
BWD_CASES = [
    # single-block regime (Tq == Tk == 128): the JAX default takes the fused
    # one-pass _bwd_single_kernel
    ("single_causal_gqa", 2, 128, 128, 4, 2, 64, True, None, None, None, "none"),
    ("single_bidir_mask_gqa", 2, 128, 128, 4, 2, 64, False, None, None, None, "right"),
    # tiled regime (_dq_kernel + _dkv_kernel), forced by 32-row blocks:
    # causal, left pads (fully masked query rows), q_offset 0 and > 0
    ("tiled_causal_leftpad", 2, 96, 96, 4, 2, 64, True, 0, 32, 32, "left"),
    ("tiled_causal_q_offset", 2, 64, 96, 4, 1, 64, True, None, 32, 32, "none"),
    # every key of one batch row masked: zero gradients there
    ("tiled_fully_masked_row", 2, 64, 64, 2, 2, 64, False, None, 32, 32, "empty"),
]


def jax_grads(q, k, v, mask, cot, causal, q_offset, bq, bk):
    bq, bk = bq or jfa.DEFAULT_BLOCK_Q, bk or jfa.DEFAULT_BLOCK_K
    def f(q, k, v):
        out = jfa.flash_attention(q, k, v, kv_mask=mask, causal=causal, q_offset=q_offset,
                                  block_q=bq, block_k=bk, interpret=True)
        return jnp.sum(out * cot)
    return jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)


@pytest.mark.parametrize("case", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_backward_matches_pallas(case):
    """`flash_attention(...).backward` on CPU tensors (FlashAttention ->
    flash_attention_bwd_ref) against jax.grad of the Pallas kernels in
    interpret mode; dq on the rows with a visible key (both are exactly 0
    elsewhere), dk and dv everywhere; fp32, atol 1e-5."""
    _, b, tq, tk, hq, hkv, d, causal, q_offset, bq, bk, mkind = case
    q, k, v = inputs(b, tq, tk, hq, hkv, d, seed=tq + hq)
    cot = np.random.default_rng(tk).standard_normal((b, tq, hq, d)).astype(np.float32)
    mask = make_mask(mkind, b, tk, seed=tk + 1)
    if mkind == "left":
        mask[:, tk - tk // 3:] = 1               # self-attention: no empty cache slots
    jdq, jdk, jdv = jax_grads(q, k, v, mask, cot, causal, q_offset, bq, bk)
    tq_, tk_, tv_ = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    before = tfa.flash_bwd.launches
    out = tfa.flash_attention(tq_, tk_, tv_, torch.from_numpy(mask), causal=causal,
                              q_offset=q_offset)
    (out * torch.from_numpy(cot)).sum().backward()
    assert tfa.flash_bwd.launches == before          # the CPU runs the plain version
    qo = q_offset if q_offset is not None else (tk - tq if causal else 0)
    visible = np.broadcast_to(mask[:, None, :], (b, tq, tk)).astype(bool)
    if causal:
        visible = visible & (np.arange(tk)[None, None, :] <= np.arange(tq)[None, :, None] + qo)
    rows = visible.any(-1)                                     # [B, Tq]
    np.testing.assert_allclose(tq_.grad.numpy()[rows], np.asarray(jdq)[rows], atol=ATOL, rtol=0)
    np.testing.assert_allclose(tk_.grad.numpy(), np.asarray(jdk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv_.grad.numpy(), np.asarray(jdv), atol=ATOL, rtol=0)
    if mkind in ("left", "empty"):
        assert (~rows).any()
        assert np.all(tq_.grad.numpy()[~rows] == 0.0)
    if mkind == "empty":                                       # batch row 0 sees no key
        assert not tk_.grad[0].any() and not tv_.grad[0].any() and not tq_.grad[0].any()


@pytest.mark.parametrize("causal,q_offset,mkind", [(True, 0, "left"), (False, None, "right"),
                                                   (True, 16, "none")])
def test_bwd_ref_matches_autograd_of_the_plain_forward(causal, q_offset, mkind):
    """flash_attention_bwd_ref (P from the saved LSE, delta = rowsum(dO*O))
    against torch autograd through flash_attention_ref, fp32, atol 1e-5."""
    q, k, v = (torch.tensor(x, requires_grad=True)
               for x in inputs(2, 40, 56, 4, 2, 64, seed=21))
    mask = torch.from_numpy(make_mask(mkind, 2, 56, seed=22))
    dout = torch.randn(2, 40, 4, 64, generator=torch.Generator().manual_seed(23))
    qo = q_offset if q_offset is not None else (56 - 40 if causal else 0)
    out, lse = tfa.flash_attention_ref(q, k, v, mask, causal, qo)
    out.backward(dout)
    dq, dk, dv = tfa.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), mask, causal,
                                             qo, out.detach(), lse, dout)
    for port, ref in ((dq, q.grad), (dk, k.grad), (dv, v.grad)):
        torch.testing.assert_close(port, ref, atol=ATOL, rtol=0)


def test_serving_without_autograd_launches_no_backward_path():
    """Without autograd the wrapper runs the forward alone (no
    FlashAttention node); with it, the output carries the Function."""
    q, k, v = (torch.from_numpy(x) for x in inputs(1, 8, 8, 2, 2, 64, seed=24))
    with torch.no_grad():
        assert tfa.flash_attention(q.requires_grad_(), k, v).grad_fn is None
    out = tfa.flash_attention(q, k, v, causal=True)
    assert type(out.grad_fn).__name__.startswith("FlashAttention")
