"""The port's flash-attention forward against the JAX package's Pallas
kernels, run as the JAX tests run them on the CPU (interpret mode).

`flash_attention_ref` is the plain version the port's wrapper computes on
CPU tensors, and the function the CUDA kernel is held to on the card by
`chip_smoke.py` (the kernel itself cannot run here: there is no nvcc and no
card). fp32 inputs, atol 1e-5: both sides compute in fp32 and differ only
in summation order and the online-softmax rescaling.
"""

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


@pytest.mark.parametrize("bad", ["head_dim", "gqa", "mask_shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    d = 32 if bad == "head_dim" else 64
    hkv = 3 if bad == "gqa" else 2
    q, k, v = (torch.from_numpy(x) for x in inputs(2, 8, 8, 4, hkv, d, seed=6))
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
