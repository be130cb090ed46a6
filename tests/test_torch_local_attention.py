"""The port's banded attention (`bioreason_tpu_torch.ops.local_attention`)
against the JAX package's Pallas kernels, run as
tests/test_local_attention.py runs them on the CPU (interpret mode).

`local_attention_ref` and `local_attention_bwd_ref` are the plain versions
the port's wrappers compute on CPU tensors, and the functions the CUDA
kernels (`local_fwd`, `local_bwd`) are held to on the card by
`chip_smoke.py`. fp32 inputs from a numpy seed. The forward is compared on
ALL rows at 2e-5 (as the JAX tests compare the kernel with their oracle):
the JAX kernel computes pad queries too, and a pad query next to valid
tokens sees them. The backward at 1e-4: both sides are fp32 but the JAX
side sums dk/dv over per-q-head temporaries and blocks in another order.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioreason_tpu import config as JC
from bioreason_tpu.models import fusion as JF
from bioreason_tpu.models import nt_encoder as JE
from bioreason_tpu.ops import local_attention as jla
from bioreason_tpu_torch import config as TC
from bioreason_tpu_torch.models import nt_encoder as TE
from bioreason_tpu_torch.models.attention import attention
from bioreason_tpu_torch.ops import flash_attention as FA
from bioreason_tpu_torch.ops import local_attention as tla
from bioreason_tpu_torch.weights import from_jax_params

# one intra-op thread: the tensors here are tiny, and pytest-xdist runs
# several workers on the host's cores, which torch's default of a thread
# per core oversubscribes many times over
torch.set_num_threads(1)

FWD_TOL = 2e-5
BWD_TOL = 1e-4


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def tt(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


def jax_forward(q, k, v, window, mask, block):
    """The Pallas forward's (out [B,T,Hq,D], lse [B,Hq,T]), through the JAX
    wrapper's own transposes and block padding."""
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    pad = (block - t % block) % block
    padt = lambda x: np.pad(x, ((0, 0), (0, pad), (0, 0), (0, 0)))
    qf = jnp.asarray(padt(q)).transpose(0, 2, 1, 3).reshape(b * hq, t + pad, d)
    kf = jnp.asarray(padt(k)).transpose(0, 2, 1, 3).reshape(b * hkv, t + pad, d)
    vf = jnp.asarray(padt(v)).transpose(0, 2, 1, 3).reshape(b * hkv, t + pad, d)
    m = np.ones((b, t), np.int32) if mask is None else mask
    maskf = jnp.repeat(jnp.asarray(np.pad(m, ((0, 0), (0, pad)))), hq, axis=0)[:, None, :]
    out, lse = jax.jit(jla._local_fwd_impl, static_argnums=(4, 5, 6))(
        qf, kf, vf, maskf, window, block, True)
    out = np.asarray(out).reshape(b, hq, t + pad, d).transpose(0, 2, 1, 3)[:, :t]
    return out, np.asarray(lse).reshape(b, hq, t + pad)[:, :, :t]


# (name, B, T, Hq, Hkv, D, window, block, mask kind): the cases of
# tests/test_local_attention.py:51-88, then the band predicate at its edges
FWD_CASES = [
    ("band_narrower_than_block", 2, 64, 4, 4, 8, 8, 16, "none"),
    ("band_equals_block", 2, 64, 4, 4, 8, 16, 16, "none"),
    ("radius_above_1", 2, 96, 4, 4, 8, 40, 16, "none"),
    ("ragged_t", 2, 50, 4, 4, 8, 12, 16, "none"),
    ("window_covers_all", 2, 32, 4, 4, 8, 100, 16, "none"),
    ("gqa_left_right_pads", 2, 64, 8, 2, 8, 10, 16, "pads"),
    ("fully_masked", 1, 32, 2, 2, 8, 4, 16, "empty"),
    # the diagonal alone
    ("window_0", 2, 64, 4, 4, 8, 0, 16, "none"),
    # the band's edge on a block boundary
    ("edge_on_block_T200_W64", 1, 200, 2, 2, 8, 64, 64, "none"),
    # every pair but the two corners visible
    ("window_t_minus_1", 2, 50, 4, 4, 8, 49, 16, "none"),
    # GQA, left pads longer than the band: rows that see no valid key
    ("gqa_left_pads_w63", 2, 200, 8, 2, 8, 63, 64, "left"),
]


def make_mask(kind, b, t):
    if kind == "none":
        return None
    mask = np.ones((b, t), np.int32)
    if kind == "pads":
        mask[0, :9] = 0                        # left padding
        mask[1, -5:] = 0                       # right padding
    elif kind == "left":
        mask[0, :70] = 0                       # rows 0-6 see no valid key at W=63
        mask[1, :5] = 0
    else:
        mask[:] = 0
    return mask


def visible(b, t, window, mask):
    vis = np.broadcast_to(np.abs(np.arange(t)[:, None] - np.arange(t)[None, :]) <= window,
                          (b, t, t))
    if mask is not None:
        vis = vis & mask[:, None, :].astype(bool)
    return vis


@pytest.mark.parametrize("case", FWD_CASES, ids=[c[0] for c in FWD_CASES])
def test_ref_matches_pallas_forward(case):
    _, b, t, hq, hkv, d, window, block, mkind = case
    q, k, v = rand((b, t, hq, d), 0), rand((b, t, hkv, d), 1), rand((b, t, hkv, d), 2)
    mask = make_mask(mkind, b, t)
    out, lse = tla.local_attention_ref(*tt(q, k, v), window,
                                       None if mask is None else torch.from_numpy(mask))
    ref_out, ref_lse = jax_forward(q, k, v, window, mask, block)
    # the JAX wrapper's own output, as tests/test_local_attention.py reads it
    ref_wrapped = jla.local_attention(q, k, v, window, kv_mask=mask, block=block,
                                      interpret=True)
    np.testing.assert_allclose(ref_out, np.asarray(ref_wrapped), atol=0, rtol=0)
    np.testing.assert_allclose(out.numpy(), ref_out, atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=FWD_TOL, rtol=FWD_TOL)
    empty = ~visible(b, t, window, mask).any(-1)                   # [B, T]
    assert empty.any() == (mkind in ("empty", "left"))
    assert np.all(out.numpy()[empty] == 0.0)
    assert np.all(lse.numpy().transpose(0, 2, 1)[empty] == tla.NEG_INF)


# (name, B, T, Hq, Hkv, D, window, block, masked prefix of batch row 0)
BWD_CASES = [
    # tests/test_local_attention.py:92-126: GQA and a masked prefix
    ("gqa_masked_prefix", 2, 64, 4, 2, 8, 12, 16, 7),
    # a prefix longer than the band: rows that see no valid key (dq = 0)
    ("fully_masked_rows", 2, 64, 4, 2, 8, 4, 16, 20),
    # the band covers everything; ragged T
    ("window_covers_all", 1, 50, 2, 1, 8, 100, 16, 0),
    # the diagonal alone, with a masked prefix (its rows see no key)
    ("window_0", 2, 64, 4, 2, 8, 0, 16, 7),
    # the band's edge on a block boundary
    ("edge_on_block_T200_W64", 1, 200, 2, 2, 8, 64, 64, 0),
    # every pair but the two corners visible
    ("window_t_minus_1", 1, 50, 2, 1, 8, 49, 16, 3),
    # GQA, left pads longer than the band
    ("gqa_left_pads_w63", 2, 200, 8, 2, 8, 63, 64, 70),
]


@pytest.mark.parametrize("case", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_bwd_ref_matches_pallas_vjp(case):
    """`local_attention_bwd_ref` against jax.vjp of the interpret-mode
    kernels, given the same cotangent; dq on every row (both give exactly 0
    on rows with no visible key), dk and dv everywhere."""
    _, b, t, hq, hkv, d, window, block, prefix = case
    q, k, v = rand((b, t, hq, d), 7), rand((b, t, hkv, d), 8), rand((b, t, hkv, d), 9)
    cot = rand((b, t, hq, d), 10)
    mask = np.ones((b, t), np.int32)
    mask[0, :prefix] = 0
    f = lambda q, k, v: jla.local_attention(q, k, v, window, kv_mask=jnp.asarray(mask),
                                            block=block, interpret=True)
    jdq, jdk, jdv = jax.jit(lambda q, k, v, c: jax.vjp(f, q, k, v)[1](c))(q, k, v, cot)
    tq, tk, tv, tmask, tcot = tt(q, k, v, mask, cot)
    out, lse = tla.local_attention_ref(tq, tk, tv, window, tmask)
    dq, dk, dv = tla.local_attention_bwd_ref(tq, tk, tv, window, tmask, out, lse, tcot)
    for port, ref in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=BWD_TOL, rtol=BWD_TOL)
    empty = ~visible(b, t, window, mask).any(-1)
    assert empty.any() == (prefix > window)     # row 0 sees keys 0..window
    assert np.all(dq.numpy()[empty] == 0.0)


def test_function_gradient_equals_autograd_of_the_plain_forward():
    """`LocalAttention` on CPU tensors (forward `local_attention_ref`,
    backward `local_attention_bwd_ref`) against torch autograd through
    `local_attention_ref`; fp32, atol 1e-5."""
    q, k, v = (torch.tensor(x, requires_grad=True)
               for x in (rand((2, 40, 4, 16), 11), rand((2, 40, 2, 16), 12),
                         rand((2, 40, 2, 16), 13)))
    mask = torch.ones((2, 40), dtype=torch.int32)
    mask[0, :15] = 0
    mask[1, 33:] = 0
    dout = torch.from_numpy(rand((2, 40, 4, 16), 14))
    before = (tla.local_attention.launches, tla.local_bwd.launches)
    out = tla.local_attention(q, k, v, 6, kv_mask=mask)
    assert type(out.grad_fn).__name__.startswith("LocalAttention")
    got = torch.autograd.grad(out, (q, k, v), dout)
    ref_out, _ = tla.local_attention_ref(q, k, v, 6, mask)
    want = torch.autograd.grad(ref_out, (q, k, v), dout)
    torch.testing.assert_close(out, ref_out, atol=0, rtol=0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    # the CPU runs the plain versions: no launch counted
    assert (tla.local_attention.launches, tla.local_bwd.launches) == before


def test_plain_versions_over_query_chunks_equal_one_pass():
    """Past Q_CHUNK query rows the plain versions step over chunks with the
    keys each band reaches; they equal one pass of the generic plain
    attention over the whole [T, T] band (fp32, atol 1e-6)."""
    t, window = tla.Q_CHUNK + 76, 40
    q, k, v, dout = tt(rand((2, t, 2, 8), 15), rand((2, t, 1, 8), 16),
                       rand((2, t, 1, 8), 17), rand((2, t, 2, 8), 18))
    mask = torch.ones((2, t), dtype=torch.int32)
    mask[1, :12] = 0
    mask[0, t - 30:] = 0
    i = torch.arange(t)
    band = ((i[:, None] - i[None, :]).abs() <= window)[None, None, None] \
        & mask.bool()[:, None, None, None, :]
    chunked = tla.local_attention_ref(q, k, v, window, mask)
    for a, b in zip(chunked, FA.attention_ref(q, k, v, band)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    grads = tla.local_attention_bwd_ref(q, k, v, window, mask, *chunked, dout)
    for a, b in zip(grads, FA.attention_bwd_ref(q, k, v, band, *chunked, dout)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    q, k, v = tt(rand((2, 30, 4, 64), 19), rand((2, 30, 2, 64), 20), rand((2, 30, 2, 64), 21))
    mask = torch.ones((2, 30), dtype=torch.int32)
    mask[0, 25:] = 0
    before = tla.local_attention.launches
    out, lse = tla.local_attention(q, k, v, 9, mask, return_lse=True)
    ref_out, ref_lse = tla.local_attention_ref(q, k, v, 9, mask)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert tla.local_attention.launches == before
    # the dispatch's banded route is the same function
    assert torch.equal(attention(q, k, v, kv_mask=mask, impl="local:9"), out)


def test_wrapper_and_dispatch_refusals():
    q = torch.zeros((1, 16, 2, 8))
    with pytest.raises(ValueError):                   # Tq != Tk
        tla.local_attention(q, q[:, :8], q[:, :8], 4)
    with pytest.raises(ValueError):
        tla.local_attention(q, q, q, -1)
    with pytest.raises(NotImplementedError):          # bidirectional only
        attention(q, q, q, causal=True, impl="local:4")


# -- the encoder on the banded route -------------------------------------------------

@functools.lru_cache(maxsize=None)
def encoder_models():
    jcfg = dataclasses.replace(JC.FusionConfig.tiny(), encoder=dataclasses.replace(
        JC.EncoderConfig.tiny(), attention_impl="local:16"))
    tcfg = dataclasses.replace(TC.FusionConfig.tiny(), encoder=dataclasses.replace(
        TC.EncoderConfig.tiny(), attention_impl="local:16"))
    params = jax.jit(JF.init_fusion, static_argnums=1)(jax.random.PRNGKey(3), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return jcfg, params, tcfg, model


def test_encoder_forward_local_matches_jax():
    """The tiny NT encoder with attention_impl="local:16" over 48 tokens
    (the band is narrower than the sequence), with left and right pads,
    against the JAX encoder on the same converted weights; all rows, fp32,
    atol 1e-5."""
    jcfg, params, tcfg, model = encoder_models()
    rng = np.random.default_rng(4)
    ids = rng.integers(6, 4107, (3, 48)).astype(np.int32)
    ids[:, 0] = 3                                       # <cls>
    mask = np.ones_like(ids)
    mask[0, 30:] = mask[2, 41:] = 0
    ids[mask == 0] = 1                                  # <pad>
    ref = jax.jit(lambda p, i, m: JE.encoder_forward(p, jcfg.encoder, i, m))(
        params["encoder"], ids, mask)
    before = tla.local_attention.launches
    with torch.no_grad():
        out = TE.encoder_forward(model.encoder, tcfg.encoder, *tt(ids, mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    assert tla.local_attention.launches == before
