"""The port's vocab-chunked CE (ops/fused_ce.py) against the JAX package's:
losses and the hidden (and head) gradients, at a chunk of 128 rows over a
300-row vocabulary, so three chunks and a ragged tail run. fp32 on the CPU,
atol 1e-5 (both sides fp32; the gap is summation order), except where the
bf16 chunk logits are kept (`save_logits`, see its test)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioreason_tpu.ops import fused_ce as J
from bioreason_tpu_torch.ops import fused_ce as T

# one intra-op thread: the tensors here are tiny, and pytest-xdist runs
# several workers on the host's cores, which torch's default of a thread
# per core oversubscribes many times over
torch.set_num_threads(1)

V, H, CHUNK = 300, 32, 128
ATOL = 1e-5
RNG = np.random.default_rng(0)
EMB = (RNG.standard_normal((V, H)) * 0.3).astype(np.float32)


def t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def targets(n, holes=True, seed=1):
    y = np.random.default_rng(seed).integers(0, V, n).astype(np.int32)
    y[-2:] = V - 1 - np.arange(2)          # targets in the ragged last chunk
    if holes:
        y[::3] = -100
    return y


def close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=0)


@functools.lru_cache(maxsize=None)
def jax_xent(need_embedding_grad, save_logits):
    def f(h, e, y):
        return J.fused_softmax_xent(h, e, y, -100, CHUNK, need_embedding_grad, save_logits)
    return jax.jit(jax.value_and_grad(f, argnums=(0, 1)))


@pytest.mark.parametrize("need_embedding_grad", [False, True])
def test_fused_softmax_xent(need_embedding_grad):
    h = RNG.standard_normal((24, H)).astype(np.float32)
    y = targets(24)
    (loss, (dh, de)) = jax_xent(need_embedding_grad, False)(h, EMB, y)
    th, te = t(h, True), t(EMB, True)
    out = T.fused_softmax_xent(th, te, t(y).long(), -100, CHUNK, need_embedding_grad)
    out.backward()
    close(out, loss)
    close(th.grad, dh)
    if need_embedding_grad:
        close(te.grad, de)
    else:                        # a frozen head: no gradient (JAX returns zeros)
        assert te.grad is None and not np.asarray(de).any()


def test_fused_softmax_xent_saved_logits():
    """`save_logits` keeps the shifted chunk logits in bf16 on both sides:
    the recomputed softmax carries their rounding (|x| * 2^-9 in each
    exponent), so the gradients agree with the JAX ones to 1e-3, and with
    the port's own recompute path to the same."""
    h = RNG.standard_normal((16, H)).astype(np.float32)
    y = targets(16, seed=2)
    (loss, (dh, _)) = jax_xent(False, True)(h, EMB, y)
    th = t(h, True)
    out = T.fused_softmax_xent(th, t(EMB), t(y).long(), -100, CHUNK, False, True)
    out.backward()
    close(out, loss)
    close(th.grad, dh, atol=1e-3)
    th2 = t(h, True)
    T.fused_softmax_xent(th2, t(EMB), t(y).long(), -100, CHUNK).backward()
    close(th.grad, th2.grad.numpy(), atol=1e-3)


@pytest.mark.parametrize("need_embedding_grad", [False, True])
def test_chunked_token_logps(need_embedding_grad):
    h = RNG.standard_normal((20, H)).astype(np.float32)
    y = targets(20, holes=False, seed=3)
    cot = RNG.standard_normal(20).astype(np.float32)

    def f(h, e):
        return jnp.sum(J.chunked_token_logps(h, e, y, CHUNK, need_embedding_grad) * cot)
    logps = J.chunked_token_logps(h, EMB, y, CHUNK, need_embedding_grad)
    dh, de = jax.jit(jax.grad(f, argnums=(0, 1)))(h, EMB)
    th, te = t(h, True), t(EMB, True)
    out = T.chunked_token_logps(th, te, t(y).long(), CHUNK, need_embedding_grad)
    (out * t(cot)).sum().backward()
    close(out, logps)
    close(th.grad, dh)
    if need_embedding_grad:
        close(te.grad, de)


def lm_inputs(seed):
    r = np.random.default_rng(seed)
    hidden = r.standard_normal((3, 12, H)).astype(np.float32)
    labels = r.integers(0, V, (3, 12)).astype(np.int32)
    labels[:, :5] = -100
    labels[1, 9:] = -100
    return hidden, labels


@pytest.mark.parametrize("form", ["plain", "gathered", "focal", "focal_gathered"])
def test_decoder_lm_losses(form):
    hidden, labels = lm_inputs(4)
    pos, tgt, val = J.gather_label_positions(labels, bucket=8)
    gamma = 1.5

    def jloss(h, e):
        if form == "plain":
            return J.decoder_lm_loss(h, e, labels, chunk=CHUNK, need_embedding_grad=True)
        if form == "gathered":
            return J.decoder_lm_loss_gathered(h, e, pos, tgt, val, chunk=CHUNK,
                                              need_embedding_grad=True)
        if form == "focal":
            return J.decoder_lm_loss_focal(h, e, labels, gamma, chunk=CHUNK,
                                           need_embedding_grad=True)
        return J.decoder_lm_loss_focal_gathered(h, e, pos, tgt, val, gamma, chunk=CHUNK,
                                                need_embedding_grad=True)
    loss, (dh, de) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(hidden, EMB)
    th, te = t(hidden, True), t(EMB, True)
    tl, tp, tt, tv = t(labels).long(), t(pos), t(tgt), t(val)
    if form == "plain":
        out = T.decoder_lm_loss(th, te, tl, chunk=CHUNK, need_embedding_grad=True)
    elif form == "gathered":
        out = T.decoder_lm_loss_gathered(th, te, tp, tt, tv, chunk=CHUNK,
                                         need_embedding_grad=True)
    elif form == "focal":
        out = T.decoder_lm_loss_focal(th, te, tl, gamma, chunk=CHUNK, need_embedding_grad=True)
    else:
        out = T.decoder_lm_loss_focal_gathered(th, te, tp, tt, tv, gamma, chunk=CHUNK,
                                               need_embedding_grad=True)
    out.backward()
    close(out, loss)
    close(th.grad, dh)
    close(te.grad, de)


def test_gathered_loss_equals_plain_and_positions_match():
    hidden, labels = lm_inputs(5)
    for bucket in (1, 8, 64):
        ours = T.gather_label_positions(labels, bucket)
        for a, b in zip(ours, J.gather_label_positions(labels, bucket)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == np.int32
    pos, tgt, val = (t(x) for x in T.gather_label_positions(labels, 8))
    a = T.decoder_lm_loss(t(hidden), t(EMB), t(labels).long(), chunk=CHUNK)
    b = T.decoder_lm_loss_gathered(t(hidden), t(EMB), pos, tgt, val, chunk=CHUNK)
    assert float(a) == pytest.approx(float(b), rel=1e-6)


def test_focal_gamma_zero_is_the_mean_ce():
    hidden, labels = lm_inputs(6)
    a = T.decoder_lm_loss(t(hidden), t(EMB), t(labels).long(), chunk=CHUNK)
    b = T.decoder_lm_loss_focal(t(hidden), t(EMB), t(labels).long(), 0.0, chunk=CHUNK)
    assert float(a) == pytest.approx(float(b), rel=1e-5)
