"""The precision contract of the fp32 flash kernels (csrc/flash_f32.cu),
pinned on the CPU: split TF32 (3xTF32) meets the fp32 tolerances that
`chip_smoke.py` holds the kernels to, and one TF32 pass does not.

The kernels run every product of fp32 operands as three TF32 passes,
hi_a hi_b + hi_a lo_b + lo_a hi_b with hi = tf32(x), lo = tf32(x - hi)
(`cvt.rna.tf32.f32`), into fp32 sums. Here that arithmetic is emulated:
`tf32` rounds on the int32 view of the bits (nearest, ties away from
zero, the low 13 mantissa bits dropped), and a TF32 product of two tf32
values is exact in fp32, so the sums are fp32 matrix products of the split
parts. The attention around the products is the plain versions'
(`attention_ref`, `attention_bwd_ref`, which `flash_attention_ref` and the
band's plain versions call), checked here against the same formulas with
fp32 products. Against fp64: out and the LSE within
1e-5, dq, dk and dv within 1e-4, of their largest magnitude.
"""

import numpy as np
import pytest
import torch

from bioreason_tpu_torch.ops import flash_attention as tfa

# one intra-op thread: pytest-xdist runs several workers on the host's cores
torch.set_num_threads(1)

OUT_RTOL_OF_MAX, LSE_RTOL_OF_MAX, BWD_RTOL_OF_MAX = 1e-5, 1e-5, 1e-4


def tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: round to the nearest value with a 10-bit mantissa,
    ties away from zero (the magnitude's bits rounded; finite inputs)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.int32)
    return ((bits + 0x1000) & np.int32(-0x2000)).view(np.float32)


def mm_exact(spec, a, b):
    return np.einsum(spec, a.astype(np.float64), b.astype(np.float64))


def mm_split(spec, a, b):
    """Three TF32 passes into fp32 sums."""
    a, b = a.astype(np.float32), b.astype(np.float32)
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    f = lambda x, y: np.einsum(spec, x, y, optimize=True).astype(np.float32)
    return (f(al, bh) + f(ah, bl)) + f(ah, bh)


def mm_one(spec, a, b):
    """One TF32 pass into fp32 sums."""
    a, b = a.astype(np.float32), b.astype(np.float32)
    return np.einsum(spec, tf32(a), tf32(b), optimize=True).astype(np.float32)


def attention(q, k, v, dout, valid, mm, dtype):
    """out, lse and (dq, dk, dv) as the plain versions compute them, every
    product through `mm`, everything else in `dtype`. q [B,Tq,Hq,D], k/v
    [B,Tk,Hkv,D], valid [B,1,1,Tq,Tk] (broadcast over the GQA group)."""
    b, tq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = d ** -0.5
    qg = q.reshape(b, tq, hkv, g, d)
    dog = dout.reshape(b, tq, hkv, g, d)
    s = mm("bqhgd,bkhd->bhgqk", qg, k).astype(dtype) * dtype(scale)
    s = np.where(valid, s, dtype(tfa.NEG_INF))
    m = s.max(-1, keepdims=True)
    p = np.where(valid, np.exp(s - m), dtype(0))
    l = p.sum(-1, keepdims=True)
    has = l > 0
    lse = np.where(has, m + np.log(np.where(has, l, 1)), dtype(tfa.NEG_INF))
    pn = p / np.where(has, l, 1)
    out = mm("bhgqk,bkhd->bqhgd", pn, v).astype(dtype).reshape(b, tq, hq, d)
    # the backward: P again from the LSE, delta = rowsum(dO * O)
    p = np.where(valid, np.exp(s - lse), dtype(0))
    delta = (dout * out).sum(-1).reshape(b, tq, hkv, g).transpose(0, 2, 3, 1)[..., None]
    dp = mm("bqhgd,bkhd->bhgqk", dog, v).astype(dtype)
    ds = p * (dp - delta)
    dq = mm("bhgqk,bkhd->bqhgd", ds, k).astype(dtype) * dtype(scale)
    dk = mm("bhgqk,bqhgd->bkhd", ds, qg).astype(dtype) * dtype(scale)
    dv = mm("bhgqk,bqhgd->bkhd", p, dog).astype(dtype)
    lse = lse[..., 0].reshape(b, hq, tq)
    return out, lse, (dq.reshape(b, tq, hq, d), dk, dv)


def case(kind):
    """(q, k, v, dout, valid [B,1,1,Tq,Tk]) from a seed: a causal flash call
    at [2,512,4/2,128] with left pads, or a D = 64 band (W = 48) at
    [2,384,4/2,64] with right pads."""
    r = np.random.default_rng(0 if kind == "causal" else 1)
    if kind == "causal":
        b, t, hq, hkv, d = 2, 512, 4, 2, 128
        pads = np.array([0, 97])
        mask = np.arange(t)[None] >= pads[:, None]
        vis = np.arange(t)[None, :] <= np.arange(t)[:, None]
    else:
        b, t, hq, hkv, d, w = 2, 384, 4, 2, 64, 48
        lens = np.array([384, 301])
        mask = np.arange(t)[None] < lens[:, None]
        vis = np.abs(np.arange(t)[:, None] - np.arange(t)[None, :]) <= w
    q = r.standard_normal((b, t, hq, d), np.float32)
    k = r.standard_normal((b, t, hkv, d), np.float32)
    v = r.standard_normal((b, t, hkv, d), np.float32)
    dout = r.standard_normal((b, t, hq, d), np.float32)
    valid = (mask[:, None, :] & vis[None])[:, None, None]
    return q, k, v, dout, valid


def rel_errors(got, want, rows):
    """Max |got - want| over the rows that see a key, each over max |want|:
    (out, lse, dq, dk, dv)."""
    out, lse, grads = got
    w_out, w_lse, w_grads = want
    lrows = rows.transpose(0, 2, 1)                                   # [B, Hq, Tq]
    errs = [np.abs(out - w_out)[rows].max() / np.abs(w_out[rows]).max(),
            np.abs(lse - w_lse)[lrows].max() / np.abs(w_lse[lrows]).max()]
    errs += [np.abs(g - w).max() / np.abs(w).max() for g, w in zip(grads, w_grads)]
    return errs


@pytest.fixture(scope="module", params=["causal", "band"])
def problem(request):
    q, k, v, dout, valid = case(request.param)
    exact = attention(q, k, v, dout, valid, mm_exact, np.float64)
    b, tq, hq = q.shape[:3]
    rows = np.broadcast_to(valid.any(-1)[:, 0], (b, hq, tq)).transpose(0, 2, 1)  # [B, Tq, Hq]
    return q, k, v, dout, valid, exact, rows


def test_the_math_is_the_plain_versions(problem):
    """`attention` with plain fp32 products is `attention_ref` /
    `attention_bwd_ref` (the plain versions over a visibility mask)."""
    q, k, v, dout, valid, _, rows = problem
    mine = attention(q, k, v, dout, valid, lambda s, a, b: np.einsum(s, a, b), np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    out, lse = tfa.attention_ref(t(q), t(k), t(v), t(valid))
    grads = tfa.attention_bwd_ref(t(q), t(k), t(v), t(valid), out, lse, t(dout))
    np.testing.assert_allclose(out.numpy()[rows], mine[0][rows], atol=2e-6, rtol=0)
    lrows = rows.transpose(0, 2, 1)
    np.testing.assert_allclose(lse.numpy()[lrows], mine[1][lrows], atol=4e-6, rtol=0)
    # both in fp32, the sums in other orders: ~1e-6 of the largest gradient
    for g, w in zip(grads, mine[2]):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max(), rtol=0)


def test_split_tf32_meets_the_fp32_tolerances(problem):
    q, k, v, dout, valid, exact, rows = problem
    errs = rel_errors(attention(q, k, v, dout, valid, mm_split, np.float32), exact, rows)
    limits = [OUT_RTOL_OF_MAX, LSE_RTOL_OF_MAX] + [BWD_RTOL_OF_MAX] * 3
    assert all(e <= lim for e, lim in zip(errs, limits)), errs


def test_one_tf32_pass_does_not(problem):
    q, k, v, dout, valid, exact, rows = problem
    errs = rel_errors(attention(q, k, v, dout, valid, mm_one, np.float32), exact, rows)
    assert errs[0] > OUT_RTOL_OF_MAX and errs[1] > LSE_RTOL_OF_MAX, errs
    assert all(e > BWD_RTOL_OF_MAX for e in errs[2:]), errs


def test_tf32_rounds_to_nearest_ties_away():
    """The emulation of cvt.rna.tf32.f32 on hand-picked bit patterns."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)                    # tf32's spacing at 1
    x = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp * 0.49, 1 + ulp * 1.5, 3.14159265],
                 np.float32)
    got = tf32(x)
    np.testing.assert_array_equal(got[:4], np.array([1 + ulp, -(1 + ulp), one, 1 + 2 * ulp],
                                                    np.float32))
    assert not (got.view(np.int32) & 0x1fff).any()
    assert abs(got[4] - x[4]) <= 2.0 ** -11 * 2
