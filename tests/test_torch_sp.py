"""Sequence parallelism of the port (bioreason_tpu_torch/parallel/sp.py,
sp_hyena.py) in worlds of 2 and 4 gloo ranks on the CPU, fp32: each op's
output and the gradients of its inputs (and filter parameters) against the
port's one-device path (1e-5; the FFT convs 1e-4, their chunked FFTs round
differently) and, for the attention and hyena ops, against the JAX
package's `parallel/sp*.py` on its CPU mesh with the same inputs (1e-5
forward, 1e-4 gradients); the NT encoder and the Evo2 tower forward and
backward; and two SFT steps with `sp` and `sp_local:16` against the
one-device `xla` / `local:16` steps (losses 1e-5, parameters 1e-5; the
sharded runs recompute their layers in the backward, remat). The
sequence lengths are not multiples of the world size where the op pads.

Each world is spawned once (module fixtures) and runs every case; the
inputs are drawn from seeds with numpy on both sides. The loss of a case is
sum(out * w) over the whole output, which every rank holds after
`unshard_sequence`; an input's gradient is the sum of the ranks' chunks."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from test_torch_mesh import spawn_world

torch.set_num_threads(1)

ATTN = {
    # name: (B, S, Hq, Hkv, D, route, causal, window)
    "attn_bidir": (2, 13, 4, 2, 16, "sp", False, None),
    "attn_causal": (2, 13, 4, 2, 16, "sp", True, None),
    "attn_kernel_route": (2, 13, 4, 2, 64, "sp_pallas", True, None),
    "local_halo": (2, 41, 4, 2, 16, "sp_local", False, 4),
    "local_gather": (2, 19, 4, 2, 16, "sp_local", False, 12),
}
CONV = {
    # name: (B, T, C, K)
    "conv_short": (2, 22, 6, 3),
    "conv_long_filter": (2, 67, 6, 32),
    "conv_chunk_shorter": (2, 13, 6, 7),
}
LI = (2, 27, 6, 3)            # B, T, D, K


def attn_inputs(name):
    b, s, hq, hkv, d, _, _, _ = ATTN[name]
    rng = np.random.default_rng(len(name))
    q, w = (rng.standard_normal((b, s, hq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, s, hkv, d)).astype(np.float32) for _ in range(2))
    mask = np.ones((b, s), np.int32)
    mask[1, -3:] = 0
    return q, k, v, mask, w


def conv_inputs(name):
    b, t, c, k = CONV[name]
    rng = np.random.default_rng(len(name) + 100)
    return (rng.standard_normal((b, t, c)).astype(np.float32),
            (rng.standard_normal((c, k)) * 0.3).astype(np.float32),
            rng.standard_normal((b, t, c)).astype(np.float32))


def li_inputs():
    b, t, d, k = LI
    rng = np.random.default_rng(7)
    poles = np.stack([rng.normal(1.0, 0.5, (d, k)), rng.uniform(-0.5, 0.5, (d, k))], -1)
    return (rng.standard_normal((b, t, d)).astype(np.float32), poles.astype(np.float32),
            (rng.standard_normal((d, k, 2)) * 0.5).astype(np.float32),
            rng.standard_normal((b, t, d)).astype(np.float32))


# -- the port's ops, one device or sharded ---------------------------------------------

def _attn(name, q, k, v, mask, sharded):
    from bioreason_tpu_torch.models.attention import attention
    from bioreason_tpu_torch.ops.local_attention import local_attention
    _, s, _, _, _, route, causal, window = ATTN[name]
    if not sharded:
        if route == "sp_local":
            return local_attention(q, k, v, window, kv_mask=mask)
        return attention(q, k, v, kv_mask=mask, causal=causal,
                         impl="pallas" if route == "sp_pallas" else "xla")
    from bioreason_tpu_torch.parallel import sp
    impl = f"sp_local:{window}" if route == "sp_local" else route
    ql, kl, vl, ml = (sp.shard_sequence(x) for x in (q, k, v, mask))
    return sp.unshard_sequence(attention(ql, kl, vl, kv_mask=ml, causal=causal, impl=impl), s)


def _with_grads(fn, arrays, w, axis=None):
    """fn(*tensors) -> (out, grads of every input), the grads summed over
    `axis` (the chunks of a sharded run)."""
    from bioreason_tpu_torch.parallel import comm
    ts = [torch.tensor(a, requires_grad=a.dtype == np.float32) for a in arrays]
    out = fn(*ts)
    grads = torch.autograd.grad((out * torch.tensor(w)).sum(),
                                [t for t in ts if t.requires_grad])
    if axis is not None:
        grads = [comm.all_reduce(g, axis) for g in grads]
    return out.detach().numpy(), [g.numpy() for g in grads]


def port_attn(name, axis=None):
    q, k, v, mask, w = attn_inputs(name)
    return _with_grads(lambda *t: _attn(name, *t, sharded=axis is not None),
                       (q, k, v, mask), w, axis)


def port_conv(name, axis=None):
    from bioreason_tpu_torch.models import evo2
    x, f, w = conv_inputs(name)
    k = CONV[name][3]

    def fn(x, f):
        if axis is None:
            return (evo2.fft_causal_conv(x, f) if k > 16 else evo2.depthwise_causal_conv(x, f))
        from bioreason_tpu_torch.parallel import sp
        from bioreason_tpu_torch.parallel.sp_hyena import sp_causal_conv
        return sp.unshard_sequence(sp_causal_conv(sp.shard_sequence(x), f), x.shape[1])
    return _with_grads(fn, (x, f), w, axis)


def port_li(axis=None):
    from bioreason_tpu_torch.models import evo2
    g, poles, res, w = li_inputs()

    def fn(g, poles, res):
        if axis is None:
            return evo2.fft_causal_conv(g, evo2.materialize_li_filter(poles, res, g.shape[1]))
        from bioreason_tpu_torch.parallel import sp
        from bioreason_tpu_torch.parallel.sp_hyena import sp_li_conv
        return sp.unshard_sequence(sp_li_conv(sp.shard_sequence(g), poles, res), g.shape[1])
    return _with_grads(fn, (g, poles, res), w, axis)


def _tower(kind, axis=None):
    """The tiny NT encoder or Evo2 tower: (hidden, grads of its parameters)
    with the route 'sp' under `axis`, its one-device route without."""
    from bioreason_tpu_torch import config as TC
    from bioreason_tpu_torch.parallel import comm
    from bioreason_tpu_torch.parallel.sp import sequence_sharding
    rng = np.random.default_rng(11)
    if kind == "nt":
        from bioreason_tpu_torch.models.layers import init_normal_
        from bioreason_tpu_torch.models.nt_encoder import NTEncoder, encoder_forward
        cfg = TC.EncoderConfig.tiny()
        cfg = dataclasses.replace(cfg, attention_impl="sp" if axis else "xla")
        tower = init_normal_(NTEncoder(cfg), torch.Generator().manual_seed(0))
        ids = rng.integers(5, cfg.vocab_size, (2, 37))
        fwd = encoder_forward
    else:
        from bioreason_tpu_torch.models.evo2 import hyena_forward, init_hyena
        cfg = TC.HyenaConfig.tiny()
        cfg = dataclasses.replace(cfg, attention_impl="sp" if axis else "xla")
        tower = init_hyena(cfg, seed=0, device="cpu")
        ids = rng.integers(65, 90, (2, 37))
        fwd = hyena_forward
    mask = np.ones(ids.shape, np.int32)
    mask[1, :5] = 0
    ids, mask = torch.tensor(ids), torch.tensor(mask)
    with sequence_sharding(axis):
        h = fwd(tower, cfg, ids, mask)
    # the loss reads the valid positions only: a left pad's query sees no
    # key under the causal mask, and the grouped einsums return the mean of
    # V there, over the padded sequence's keys on a sharded run
    w = torch.tensor(rng.standard_normal(tuple(h.shape)).astype(np.float32)) * mask[..., None]
    names = [n for n, p in tower.named_parameters() if p.dtype == torch.float32]
    params = [dict(tower.named_parameters())[n] for n in names]
    grads = torch.autograd.grad((h.float() * w).sum(), params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    if axis is not None:
        grads = [comm.all_reduce(g, axis) for g in grads]
    h = h.detach().float() * mask[..., None]
    return h.numpy(), dict(zip(names, (g.numpy() for g in grads)))


def _sft(impl, mesh=None):
    """Two SFT steps with the encoder trained on `impl`: losses and the
    final trainable parameters."""
    from test_torch_parallel_train import sft_setup
    from bioreason_tpu_torch.train.sft import SFTTrainer
    fcfg, scfg, batches = sft_setup(enc_impl=impl, freeze_encoder=False, remat=mesh is not None)
    tr = SFTTrainer(fcfg, scfg, device="cpu", mesh=mesh)
    losses = [tr.train_step(b)["loss"] for b in batches]
    return losses, {k: v.detach().numpy() for k, v in tr.trainable_state().items()}


# -- the world -----------------------------------------------------------------------

def _sp_world(rank, world, with_sft):
    from bioreason_tpu_torch.config import MeshConfig
    from bioreason_tpu_torch.parallel import comm
    from bioreason_tpu_torch.parallel.mesh import make_mesh, topology
    from bioreason_tpu_torch.parallel.sp import sequence_sharding
    mesh = make_mesh(MeshConfig(data=1, fsdp=1, model=world), device="cpu")
    axis = topology(mesh).model
    calls = {"ppermute": 0, "all_gather_sum": 0}
    for fn in list(calls):
        real = getattr(comm, fn)

        def counted(*a, _real=real, _fn=fn, **kw):
            calls[_fn] += 1
            return _real(*a, **kw)
        setattr(comm, fn, counted)
    out = {}
    with sequence_sharding(axis):
        for name in ATTN:
            before = dict(calls)
            out[name] = port_attn(name, axis) + ({k: calls[k] - before[k] for k in calls},)
        for name in CONV:
            before = dict(calls)
            out[name] = port_conv(name, axis) + ({k: calls[k] - before[k] for k in calls},)
        out["li"] = port_li(axis)
    out["nt"] = _tower("nt", axis)
    out["hyena"] = _tower("hyena", axis)
    if with_sft:
        out["sft_sp"] = _sft("sp", mesh)
        out["sft_sp_local"] = _sft("sp_local:16", mesh)
    return out


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return spawn_world(_sp_world, 2, tmp_path_factory.mktemp("sp2"), True)[0]


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return spawn_world(_sp_world, 4, tmp_path_factory.mktemp("sp4"), False)[0]


def _world(request, n):
    return request.getfixturevalue(f"world{n}")


# -- the JAX package's sp ops on its CPU mesh ---------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_attn(name, n):
    import jax
    import jax.numpy as jnp
    from bioreason_tpu import config as JC
    from bioreason_tpu.parallel import make_mesh
    from bioreason_tpu.parallel import sp as JSP
    _, _, _, _, _, route, causal, window = ATTN[name]
    q, k, v, mask, w = attn_inputs(name)
    mesh = make_mesh(JC.MeshConfig(data=1, fsdp=1, model=n), devices=jax.devices()[:n])

    def loss(q, k, v):
        if route == "sp_local":
            out = JSP.sp_local_attention(q, k, v, window, kv_mask=jnp.asarray(mask))
        else:
            out = JSP.sp_attention(q, k, v, kv_mask=jnp.asarray(mask), causal=causal,
                                   impl="xla")
        return (out * w).sum(), out
    with JSP.sequence_sharding(mesh):
        (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
            q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@functools.lru_cache(maxsize=None)
def jax_hyena(name, n):
    import jax
    from bioreason_tpu import config as JC
    from bioreason_tpu.parallel import make_mesh
    from bioreason_tpu.parallel import sp as JSP
    from bioreason_tpu.parallel import sp_hyena as JH
    mesh = make_mesh(JC.MeshConfig(data=1, fsdp=1, model=n), devices=jax.devices()[:n])
    if name == "li":
        g, poles, res, w = li_inputs()
        fn = lambda g, p, r: JH.sp_li_conv(g, {"poles": p, "residues": r})
        args = (g, poles, res)
    else:
        x, f, w = conv_inputs(name)
        fn = JH.sp_causal_conv
        args = (x, f)

    def loss(*a):
        out = fn(*a)
        return (out * w).sum(), out
    with JSP.sequence_sharding(mesh):
        if name in JAX_FORWARD_ONLY:
            return np.asarray(jax.jit(fn)(*args)), []
        (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(len(args))),
                                                     has_aux=True))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


# JAX cannot differentiate its FFT-based sp ops (jax 0.9: "cotangent type does
# not match function output" on the complex FFT under shard_map); their
# gradients are held to the port's one-device path only
JAX_FORWARD_ONLY = ("conv_long_filter", "li")


def _close(got, want, fwd, bwd):
    np.testing.assert_allclose(got[0], want[0], atol=fwd, rtol=fwd)
    for g, r in zip(got[1], want[1]):
        np.testing.assert_allclose(g, r, atol=bwd, rtol=bwd)


# -- the tests -------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(ATTN))
def test_sp_attention_matches_one_device_and_jax(request, name, n):
    """Output and dq / dk / dv against the one-device route (1e-5) and JAX's
    sp op (1e-5, 1e-4). The halo case exchanges by ppermute, the gather
    fallback (window >= chunk) and the full attention by all-gathers."""
    got = _world(request, n)[name]
    _close(got[:2], port_attn(name), 1e-5, 1e-5)
    _close(got[:2], jax_attn(name, n), 1e-5, 1e-4)
    calls = got[2]
    if name == "local_halo":
        assert calls["ppermute"] == 6 and calls["all_gather_sum"] == 0
    else:
        assert calls["ppermute"] == 0 and calls["all_gather_sum"] == 2


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(CONV))
def test_sp_causal_conv_matches_one_device_and_jax(request, name, n):
    """Output and the input's and filter's gradients; the halo path where
    the chunk covers K-1 steps, the gather fallback where it does not (the
    long filter's gradients against one device only: JAX_FORWARD_ONLY)."""
    got = _world(request, n)[name]
    _close(got[:2], port_conv(name), 1e-4, 1e-4)
    _close(got[:2], jax_hyena(name, n), 1e-4, 1e-4)
    b, t, c, k = CONV[name]
    chunk = -(-t // n)
    halo = chunk >= k - 1
    assert (got[2]["ppermute"], got[2]["all_gather_sum"]) == ((1, 0) if halo else (0, 1))


@pytest.mark.parametrize("n", [2, 4])
def test_sp_li_conv_matches_fft_conv_and_jax(request, n):
    """The chunked modal state form against the whole-sequence FFT conv:
    output and the gradients of g, the poles and the residues (against JAX:
    the output; JAX_FORWARD_ONLY)."""
    got = _world(request, n)["li"]
    _close(got, port_li(), 1e-4, 1e-4)
    _close(got, jax_hyena("li", n), 1e-4, 1e-4)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["nt", "hyena"])
def test_tower_forward_and_gradients_sharded(request, kind, n):
    """The tiny NT encoder and Evo2 tower on 'sp' against their one-device
    route: hidden states at the valid positions 1e-5 (1e-4 for the tower's
    FFT convs) and every parameter's gradient (summed over the ranks) 1e-4
    (5e-4 for the tower: its embedding's gradient sums the chunked FFTs'
    rounding over every position)."""
    h, grads = _world(request, n)[kind]
    rh, rgrads = _tower(kind)
    tol = 1e-5 if kind == "nt" else 1e-4
    np.testing.assert_allclose(h, rh, atol=tol, rtol=tol)
    assert set(grads) == set(rgrads)
    gtol = 1e-4 if kind == "nt" else 5e-4
    for name in rgrads:
        np.testing.assert_allclose(grads[name], rgrads[name], atol=gtol, rtol=gtol,
                                   err_msg=name)


@pytest.mark.parametrize("impl,ref", [("sp", "xla"), ("sp_local:16", "local:16")])
def test_sft_steps_with_sequence_parallel_encoder(world2, impl, ref):
    """Two SFT steps, encoder trained, at mesh (1, 1, 2) against the
    one-device trainer on the route they shard: losses 1e-5, every trained
    parameter after two steps 1e-5."""
    losses, state = world2["sft_sp" if impl == "sp" else "sft_sp_local"]
    rl, rstate = _sft(ref)
    np.testing.assert_allclose(losses, rl, rtol=1e-5)
    assert set(state) == set(rstate) and any(k.startswith("encoder.") for k in state)
    for k in rstate:
        np.testing.assert_allclose(state[k], rstate[k], atol=1e-5, rtol=0, err_msg=k)
