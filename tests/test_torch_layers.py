"""The port's `models/layers.py` against the JAX package's, function by
function: the same numpy inputs and parameters through both, fp32 on the
CPU, atol 1e-5 (both sides compute in fp32; the gap is summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioreason_tpu.models import layers as JL
from bioreason_tpu_torch.models import layers as TL

# one intra-op thread: the tensors here are tiny, and pytest-xdist runs
# several workers on the host's cores, which torch's default of a thread
# per core oversubscribes many times over
torch.set_num_threads(1)

ATOL = 1e-5
RNG = np.random.default_rng(0)


def arr(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=0)


def linear_from(p):
    """An nn.Linear holding the JAX dense leaf `p` ([in, out] kernel)."""
    k = p["kernel"]
    lin = TL.linear(k.shape[0], k.shape[1], "bias" in p)
    with torch.no_grad():
        lin.weight.copy_(t(k.T.copy()))
        if "bias" in p:
            lin.bias.copy_(t(p["bias"]))
    return lin


def dense_params(i, o, bias):
    p = {"kernel": arr(i, o, scale=i ** -0.5)}
    if bias:
        p["bias"] = arr(o)
    return p


@pytest.mark.parametrize("bias", [False, True])
def test_dense(bias):
    p, x = dense_params(24, 40, bias), arr(3, 5, 24)
    close(TL.dense(linear_from(p), t(x)), JL.dense(p, x, jnp.float32))


def test_qkv_proj():
    ps = {n: dense_params(32, o, False) for n, o in (("q", 48), ("k", 16), ("v", 16))}
    x = arr(2, 7, 32)
    mod = torch.nn.Module()
    for n, p in ps.items():
        setattr(mod, n, linear_from(p))
    for a, b in zip(TL.qkv_proj(mod, t(x)), JL.qkv_proj(ps, x, jnp.float32, 48, 16)):
        close(a, b)


def test_embed_and_out_of_vocab_clamp():
    table = arr(50, 16, scale=0.02)
    emb = TL.Embedding(50, 16)
    with torch.no_grad():
        emb.weight.copy_(t(table))
    ids = RNG.integers(0, 50, (3, 9)).astype(np.int32)
    close(TL.embed(emb, t(ids)), JL.embed({"embedding": table}, ids, jnp.float32))
    # ids past the vocab (the DNA placeholder can lie there) are clamped for
    # the lookup instead of faulting; the splice replaces those rows
    oov = torch.tensor([[0, 49, 50, 151938]])
    np.testing.assert_array_equal(TL.embed(emb, oov).detach().numpy(), table[[0, 49, 49, 49]][None])


@pytest.mark.parametrize("tied", [True, False])
def test_lm_logits(tied):
    vocab, h = 60, 24
    table = arr(vocab, h, scale=0.02)
    dec = torch.nn.Module()
    dec.embed = TL.Embedding(vocab, h)
    with torch.no_grad():
        dec.embed.weight.copy_(t(table))
    jparams = {"embed": {"embedding": table}}
    dec.lm_head = None
    if not tied:
        head = dense_params(h, vocab, False)
        jparams["lm_head"] = head
        dec.lm_head = linear_from(head)
    x = arr(2, 5, h)
    out = TL.lm_logits(dec, t(x))
    assert out.dtype == torch.float32
    close(out, JL.lm_logits(jparams, x))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms(kind):
    d = 32
    x = arr(4, 6, d, scale=3.0) + 1.5
    scale, bias = arr(d) + 1.0, arr(d)
    if kind == "rmsnorm":
        mod = TL.RMSNorm(d)
        with torch.no_grad():
            mod.scale.copy_(t(scale))
        close(TL.rmsnorm(mod, t(x), 1e-6), JL.rmsnorm({"scale": scale}, x, 1e-6))
    else:
        mod = TL.LayerNorm(d)
        with torch.no_grad():
            mod.scale.copy_(t(scale))
            mod.bias.copy_(t(bias))
        close(TL.layernorm(mod, t(x), 1e-12),
              JL.layernorm({"scale": scale, "bias": bias}, x, 1e-12))


@pytest.mark.parametrize("bias", [False, True])
def test_swiglu(bias):
    d, hdn = 24, 40
    ps = {"gate": dense_params(d, hdn, bias), "up": dense_params(d, hdn, bias),
          "down": dense_params(hdn, d, bias)}
    mod = TL.SwiGLU(d, hdn, bias)
    for n, p in ps.items():
        setattr(mod, n, linear_from(p))
    x = arr(2, 5, d)
    close(TL.swiglu(mod, t(x)), JL.swiglu(ps, x, jnp.float32))


@pytest.mark.parametrize("bias", [False, True])
def test_gelu_mlp(bias):
    d, hdn = 24, 40
    ps = {"up": dense_params(d, hdn, bias), "down": dense_params(hdn, d, bias)}
    mod = TL.GeluMLP(d, hdn, bias)
    for n, p in ps.items():
        setattr(mod, n, linear_from(p))
    x = arr(2, 5, d)
    close(TL.gelu_mlp(mod, t(x)), JL.gelu_mlp(ps, x, jnp.float32))


@pytest.mark.parametrize("theta,max_pos", [(10_000.0, 64), (1_000_000.0, 1200)])
def test_apply_rope(theta, max_pos):
    x = arr(2, 9, 3, 16)
    pos = RNG.integers(0, max_pos, (2, 9)).astype(np.int32)
    close(TL.apply_rope(t(x), t(pos), theta), JL.apply_rope(x, pos, theta))


def test_positions_from_mask_left_padded():
    mask = np.array([[0, 0, 1, 1, 1], [1, 1, 1, 1, 1], [0, 0, 0, 0, 1]], np.int32)
    np.testing.assert_array_equal(TL.positions_from_mask(t(mask)).numpy(),
                                  np.asarray(JL.positions_from_mask(mask)))


def test_init_normal_distributions():
    """Dense N(0, 1/in) with zero bias, embeddings N(0, 0.02^2), norms ones."""
    mod = torch.nn.Module()
    mod.lin = TL.linear(400, 300, True)
    mod.emb = TL.Embedding(500, 64)
    mod.norm = TL.RMSNorm(64)
    TL.init_normal_(mod, torch.Generator().manual_seed(0))
    assert abs(mod.lin.weight.std().item() - 400 ** -0.5) < 2e-3
    assert abs(mod.emb.weight.std().item() - 0.02) < 1e-3
    assert torch.all(mod.lin.bias == 0) and torch.all(mod.norm.scale == 1)


def lora_leaf(i, o, r=4, bias=False):
    p = dense_params(i, o, bias)
    p.update(lora_a=arr(i, r, scale=0.3), lora_b=arr(r, o, scale=0.3),
             lora_scale=np.float32(2.0))
    return p


def with_adapter(p):
    lin = linear_from(p)
    TL.add_adapter(lin, t(p["lora_a"]), t(p["lora_b"]), float(p["lora_scale"]))
    return lin


@pytest.mark.parametrize("bias", [False, True])
def test_dense_with_lora_adapter(bias):
    p, x = lora_leaf(24, 40, bias=bias), arr(3, 5, 24)
    lin = with_adapter(p)
    close(TL.dense(lin, t(x)), JL.dense(p, x, jnp.float32))
    close(TL.lora_delta(lin, t(x), torch.float32), JL.lora_delta(p, x, jnp.float32))
    assert TL.lora_delta(linear_from(p), t(x), torch.float32) is None


def test_swiglu_with_adapters():
    d, hdn = 24, 40
    ps = {"gate": lora_leaf(d, hdn), "up": lora_leaf(d, hdn), "down": lora_leaf(hdn, d)}
    mod = TL.SwiGLU(d, hdn)
    for n, p in ps.items():
        setattr(mod, n, with_adapter(p))
    x = arr(2, 5, d)
    close(TL.swiglu(mod, t(x)), JL.swiglu(ps, x, jnp.float32))


def test_dense_computes_in_the_given_dtype():
    """An fp32 master weight used at bf16 compute gives a bf16 result that
    agrees with JAX dense(params, x, bfloat16) to one bf16 ulp at |y| < 8
    (2^-5: the two round the adapter's partial products at other places)."""
    p, x = lora_leaf(32, 16), arr(4, 32)
    lin = with_adapter(p)
    out = TL.dense(lin, t(x), torch.bfloat16)
    assert out.dtype == torch.bfloat16 and lin.weight.dtype == torch.float32
    ref = JL.dense({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jnp.bfloat16)
    assert ref.dtype == jnp.bfloat16 and float(jnp.abs(ref).max()) < 8
    np.testing.assert_allclose(out.float().detach().numpy(), np.asarray(ref, np.float32),
                               atol=2 ** -5, rtol=0)


def test_lora_dropout_statistics():
    """Inverted dropout at rate 0.5 on the adapter input: about half the
    entries kept, each scaled by 2 (the random streams of the two packages
    differ, so the port is checked by statistics); the base path is
    untouched and the same generator state draws the same mask."""
    lin = TL.linear(1, 1, False)
    with torch.no_grad():
        lin.weight.zero_()
    TL.add_adapter(lin, torch.ones(1, 1), torch.ones(1, 1), 1.0)
    x = torch.ones(200_000, 1)
    gen = torch.Generator().manual_seed(0)
    y = TL.dense(lin, x, torch.float32, (gen, 0.5))
    vals = set(torch.unique(y).tolist())
    assert vals <= {0.0, 2.0}
    assert abs(float((y == 2.0).float().mean()) - 0.5) < 0.005
    assert abs(float(y.detach().mean()) - 1.0) < 0.01
    again = TL.dense(lin, x, torch.float32, (torch.Generator().manual_seed(0), 0.5))
    assert torch.equal(y, again)


def test_remat_full_gives_the_same_gradients_and_dots_raises():
    """remat 'full' and, since the dots policy is ported, 'dots' (the dense
    products kept, the rest recomputed) give remat off's gradients bitwise;
    a policy neither names raises."""
    from types import SimpleNamespace
    mod = TL.SwiGLU(16, 32)
    TL.init_normal_(mod, torch.Generator().manual_seed(0))
    x = torch.randn(3, 16, generator=torch.Generator().manual_seed(1))
    grads = []
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        mod.zero_grad()
        fn = TL.remat(lambda m, x: TL.swiglu(m, x), SimpleNamespace(remat=remat,
                                                                     remat_policy=policy))
        fn(mod, x).square().sum().backward()
        grads.append(mod.up.weight.grad.clone())
    torch.testing.assert_close(grads[0], grads[1], atol=0, rtol=0)
    torch.testing.assert_close(grads[0], grads[2], atol=0, rtol=0)
    with pytest.raises(ValueError, match="remat_policy"):
        TL.remat(TL.swiglu, SimpleNamespace(remat=True, remat_policy="offload"))
