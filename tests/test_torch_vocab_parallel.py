"""The vocab-parallel table, head and DNA projection (parallel/partition.py,
models/layers.py, ops/fused_ce.py, models/fusion.py) on a fake 'model'
axis of two ranks run as two threads of this process (no gloo world):
`comm.all_reduce` and `comm.all_gather` go through a barrier.

Each rank holds its V/2 rows of a 266-row table (the byte tokenizer's
vocabulary), its H/2 output rows of the projection; the chunk of 48 rows
gives each rank three chunks and a ragged tail. The split functions are
held, fp32, to the JAX package's unsharded ones on the same numpy inputs
and to the port's on one device: values and the gradients of the hidden,
the table and the bias at 1e-5 relative (1e-6 absolute), with ignored
rows and targets in the last row of each rank's range. Ids past the
vocabulary (the DNA placeholder) are held to one device's clamped lookup;
JAX's `take` fills those rows instead. The plan keeps a table whole where
'model' does not divide its rows (vocab 266 at m = 4), as JAX's
`_valid_spec`, and an int8 table whole with its `model_dims` set."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioreason_tpu.models import layers as JL
from bioreason_tpu.ops import fused_ce as JCE
from bioreason_tpu_torch.models import layers as L
from bioreason_tpu_torch.ops import fused_ce as CE
from bioreason_tpu_torch.parallel import comm
from test_torch_tp_generate import ThreadAxis

torch.set_num_threads(1)

V, H, D, CHUNK, M = 266, 32, 24, 48, 2
HALF = V // M
RTOL, ATOL = 1e-5, 1e-6
RNG = np.random.default_rng(22)
TABLE = (RNG.standard_normal((V, H)) * 0.3).astype(np.float32)


class GatherAxis(ThreadAxis):
    """`ThreadAxis` with the all-gather the split head and the CE take."""

    def all_gather(self, x, axis, dim):
        self.slots[axis.index] = x.detach().clone()
        self.barrier.wait()
        out = torch.cat(self.slots, dim)
        self.barrier.wait()
        return out


@pytest.fixture
def fake(monkeypatch):
    axis = GatherAxis(M)
    monkeypatch.setattr(comm, "all_reduce", axis.all_reduce)
    monkeypatch.setattr(comm, "all_gather", axis.all_gather)
    return axis


def close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=err_msg)


def np_(t):
    return t.detach().numpy()


def rows(x, axis, dim=0):
    """This rank's piece of a whole tensor, as the plan stores it."""
    return comm.local_slice(x, axis, dim).clone()


def labels(b, t, seed):
    """[b, t] ids with ignored holes, targets in the last row of each rank's
    range (HALF - 1, V - 1) and on the first row of the second (HALF)."""
    y = np.random.default_rng(seed).integers(0, V, (b, t)).astype(np.int64)
    y[:, 1:5] = [HALF - 1, HALF, V - 1, 0]
    y[0, 6::3] = -100
    y[-1, -2:] = -100
    return y


def table_module(int8=False, split_axis=None):
    """An `Embedding` of TABLE (int8 with per-row scales), with this rank's
    rows and its `tp` marker under `split_axis` (an int8 table stays whole)."""
    from bioreason_tpu_torch.train.quant import quantize_embedding_int8, store_int8
    emb = L.Embedding(V, H)
    with torch.no_grad():
        emb.weight.copy_(torch.as_tensor(TABLE))
    if int8:
        store_int8(emb, *quantize_embedding_int8(emb.weight.detach()))
    if split_axis is not None:
        if not int8:
            emb.weight = torch.nn.Parameter(rows(emb.weight.detach(), split_axis))
        emb.tp = ("vocab", split_axis)
    return emb


def jax_table(int8):
    from bioreason_tpu.train.quant import quantize_embedding_int8
    return quantize_embedding_int8(TABLE) if int8 else jnp.asarray(TABLE)


# -- embed ------------------------------------------------------------------------------

@pytest.mark.parametrize("int8", [False, True])
def test_embed_split_matches_jax_and_one_device(fake, int8):
    """Ids on both sides of the ranks' boundary, the last id, and ids past
    the vocabulary (clamped to V - 1, as one device does); the rows against
    JAX's `embed` where the ids are in range, and against one device's
    everywhere; the float table's gradient: each rank's rows of one
    device's."""
    ids = np.array([[0, HALF - 1, HALF, V - 1, V, V + 2, 5, 200]], np.int64)
    gy = torch.as_tensor(RNG.standard_normal(ids.shape + (H,)), dtype=torch.float32)
    inside = ids[0] < V
    want_j = np.asarray(JL.embed({"embedding": jax_table(int8)}, jnp.asarray(ids[:, inside]),
                                 jnp.float32))
    one = table_module(int8)
    y1 = L.embed(one, torch.as_tensor(ids), torch.float32)
    if not int8:
        (y1 * gy).sum().backward()

    def rank(axis):
        emb = table_module(int8, axis)
        y = L.embed(emb, torch.as_tensor(ids), torch.float32)
        if int8:
            return np_(y), None
        (y * gy).sum().backward()
        return np_(y), np_(emb.weight.grad)
    out = fake.run(rank)
    for y, _ in out:
        close(y[:, inside], want_j)
        close(y, np_(y1))
    if not int8:
        close(np.concatenate([g for _, g in out]), np_(one.weight.grad))


# -- lm_logits --------------------------------------------------------------------------

def _decoder(table, head=None):
    dec = torch.nn.Module()
    dec.embed, dec.lm_head = table, head
    return dec


@pytest.mark.parametrize("case", ["tied", "untied", "int8"])
def test_lm_logits_split_matches_jax_and_one_device(fake, case):
    """The logits gathered in vocabulary order on every rank against JAX's
    `lm_logits` (tied, untied head, int8 tied) and one device's; the hidden
    state's gradient summed over the ranks (float heads)."""
    h = RNG.standard_normal((2, 3, H)).astype(np.float32)
    gy = torch.as_tensor(RNG.standard_normal((2, 3, V)), dtype=torch.float32)
    int8 = case == "int8"
    jp = {"embed": {"embedding": jax_table(int8)}}
    if case == "untied":
        jp["lm_head"] = {"kernel": jnp.asarray(TABLE[::-1].T.copy())}
    want_j = np.asarray(JL.lm_logits(jp, jnp.asarray(h)))

    def build(axis=None):
        if case != "untied":
            return _decoder(table_module(int8, axis))
        head = L.linear(H, V, False)
        with torch.no_grad():
            head.weight.copy_(torch.as_tensor(TABLE[::-1].copy()))
        if axis is not None:
            head.weight = torch.nn.Parameter(rows(head.weight.detach(), axis))
            head.tp = ("vocab", axis)
        return _decoder(table_module(), head)

    th = torch.as_tensor(h).requires_grad_(True)
    y1 = L.lm_logits(build(), th)
    (y1 * gy).sum().backward()

    def rank(axis):
        x = torch.as_tensor(h).requires_grad_(True)
        y = L.lm_logits(build(axis), x)
        (y * gy).sum().backward()
        return np_(y), np_(x.grad)
    for y, dx in fake.run(rank):
        close(y, want_j)
        close(y, np_(y1))
        close(dx, np_(th.grad))


# -- the chunked CE and logps -----------------------------------------------------------

HID = RNG.standard_normal((3, 12, H)).astype(np.float32)
LABELS = labels(3, 12, seed=4)
GAMMA = 2.0


def _gathered_inputs():
    pos, tgt, val = CE.gather_label_positions(LABELS, bucket=8)
    return pos, tgt, val


def port_loss(kind, hidden, table, vocab_axis=None):
    """The port's loss `kind` on hidden [B, T, H] and a head (its rows)."""
    y = torch.as_tensor(LABELS)
    pos, tgt, val = (torch.as_tensor(a) for a in _gathered_inputs())
    if kind in ("plain", "plain_saved"):
        return CE.decoder_lm_loss(hidden, table, y, chunk=CHUNK, need_embedding_grad=True,
                                  save_logits=kind == "plain_saved", vocab_axis=vocab_axis)
    if kind in ("gathered", "gathered_saved"):
        return CE.decoder_lm_loss_gathered(hidden, table, pos, tgt, val, chunk=CHUNK,
                                           need_embedding_grad=True,
                                           save_logits=kind == "gathered_saved",
                                           vocab_axis=vocab_axis)
    if kind == "focal":
        return CE.decoder_lm_loss_focal(hidden, table, y, GAMMA, chunk=CHUNK,
                                        need_embedding_grad=True, vocab_axis=vocab_axis)
    return CE.decoder_lm_loss_focal_gathered(hidden, table, pos, tgt, val, GAMMA,
                                             chunk=CHUNK, need_embedding_grad=True,
                                             vocab_axis=vocab_axis)


@functools.lru_cache(maxsize=None)
def jax_loss(kind):
    """The JAX package's loss `kind` and its gradients (hidden, table)."""
    pos, tgt, val = (jnp.asarray(a) for a in _gathered_inputs())
    y = jnp.asarray(LABELS)
    saved = kind.endswith("_saved")

    def f(h, e):
        if kind in ("plain", "plain_saved"):
            return JCE.decoder_lm_loss(h, e, y, -100, CHUNK, True, saved)
        if kind in ("gathered", "gathered_saved"):
            return JCE.decoder_lm_loss_gathered(h, e, pos, tgt, val, CHUNK, True, saved)
        if kind == "focal":
            return JCE.decoder_lm_loss_focal(h, e, y, GAMMA, -100, CHUNK, True)
        return JCE.decoder_lm_loss_focal_gathered(h, e, pos, tgt, val, GAMMA, CHUNK, True)
    loss, (dh, de) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(HID),
                                                          jnp.asarray(TABLE))
    return float(loss), np.asarray(dh), np.asarray(de)


def split_loss(fake, kind):
    """Every rank's (loss, hidden gradient, table rows' gradient)."""
    def rank(axis):
        h = torch.as_tensor(HID).requires_grad_(True)
        e = rows(torch.as_tensor(TABLE), axis).requires_grad_(True)
        loss = port_loss(kind, h, e, axis)
        loss.backward()
        return float(loss.detach()), np_(h.grad), np_(e.grad)
    return fake.run(rank)


def one_device_loss(kind):
    h = torch.as_tensor(HID).requires_grad_(True)
    e = torch.as_tensor(TABLE).requires_grad_(True)
    loss = port_loss(kind, h, e)
    loss.backward()
    return float(loss.detach()), np_(h.grad), np_(e.grad)


@pytest.mark.parametrize("kind", ["plain", "plain_saved", "gathered", "gathered_saved",
                                  "focal", "focal_gathered"])
def test_chunked_ce_split_matches_jax_and_one_device(fake, kind):
    """`decoder_lm_loss`, `decoder_lm_loss_gathered` (recomputed and with the
    bf16 chunk logits kept) and the focal pair with the head split over two
    ranks: every rank's loss, its hidden gradient (summed over the ranks by
    the CE's `copy_to`) and its rows of the table's gradient, against the
    JAX functions and one device's. With `save_logits` the chunk logits are
    rounded to bf16 after the shift by the running row max, which a rank
    takes over its own rows only: its gradients carry another rounding
    than one device's (1.4e-5 of a largest 0.04 here), so they are held to
    2^-8 of the largest gradient, twice bf16's unit roundoff; the loss, an
    fp32 forward, at 1e-5."""
    jl, jdh, jde = jax_loss(kind)
    ol, odh, ode = one_device_loss(kind)
    out = split_loss(fake, kind)
    grad_close = (close if not kind.endswith("_saved") else
                  lambda g, w, err_msg="": np.testing.assert_allclose(
                      g, w, rtol=0, atol=2.0 ** -8 * np.abs(w).max(), err_msg=err_msg))
    de = np.concatenate([g for _, _, g in out])
    for loss, dh, _ in out:
        assert loss == pytest.approx(jl, rel=RTOL, abs=ATOL)
        assert loss == pytest.approx(ol, rel=RTOL, abs=ATOL)
        for want_h, want_e, side in ((jdh, jde, "jax"), (odh, ode, "one device")):
            grad_close(dh, want_h, err_msg=f"hidden vs {side}")
            grad_close(de, want_e, err_msg=f"table vs {side}")


def test_chunked_token_logps_split_matches_jax_and_one_device(fake):
    """GRPO's logp primitive: per-token log p on every rank, the hidden's
    gradient and the table rows' under a random upstream gradient."""
    hid = HID.reshape(-1, H)
    tgt = np.where(LABELS < 0, 0, LABELS).reshape(-1)
    g = RNG.standard_normal(tgt.shape).astype(np.float32)

    def jf(h, e):
        return (JCE.chunked_token_logps(h, e, jnp.asarray(tgt), CHUNK, True) * g).sum()
    want = np.asarray(JCE.chunked_token_logps(jnp.asarray(hid), jnp.asarray(TABLE),
                                              jnp.asarray(tgt), CHUNK, True))
    jdh, jde = (np.asarray(a) for a in jax.grad(jf, argnums=(0, 1))(jnp.asarray(hid),
                                                                   jnp.asarray(TABLE)))
    h1 = torch.as_tensor(hid).requires_grad_(True)
    e1 = torch.as_tensor(TABLE).requires_grad_(True)
    lp1 = CE.chunked_token_logps(h1, e1, torch.as_tensor(tgt), CHUNK, True)
    (lp1 * torch.as_tensor(g)).sum().backward()

    def rank(axis):
        h = torch.as_tensor(hid).requires_grad_(True)
        e = rows(torch.as_tensor(TABLE), axis).requires_grad_(True)
        lp = CE.chunked_token_logps(h, e, torch.as_tensor(tgt), CHUNK, True, vocab_axis=axis)
        (lp * torch.as_tensor(g)).sum().backward()
        return np_(lp), np_(h.grad), np_(e.grad)
    out = fake.run(rank)
    de = np.concatenate([x for _, _, x in out])
    for lp, dh, _ in out:
        close(lp, want)
        close(lp, np_(lp1))
        close(dh, jdh)
        close(dh, np_(h1.grad))
    close(de, jde)
    close(de, np_(e1.grad))


def test_split_ce_reduces_once_a_call_and_builds_no_full_logits(fake, monkeypatch):
    """A split CE forward and backward: one all-gather (the LSE stats) and
    one all-reduce (the hidden's gradient) per rank and call, whatever the
    chunk count; every head product a rank makes is one chunk of its own
    rows, never [N, V]."""
    calls = {"all_gather": 0, "all_reduce": 0}
    products = []

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    def mm(a, b):
        out = L.mm_f32(a, b)
        products.append(tuple(out.shape))
        return out
    monkeypatch.setattr(comm, "all_gather", counted("all_gather", comm.all_gather))
    monkeypatch.setattr(comm, "all_reduce", counted("all_reduce", comm.all_reduce))
    monkeypatch.setattr(CE, "mm_f32", mm)

    def rank(axis):
        h = torch.as_tensor(HID).requires_grad_(True)
        e = rows(torch.as_tensor(TABLE), axis).requires_grad_(True)
        port_loss("plain", h, e, axis).backward()
    fake.run(rank)
    assert calls == {"all_gather": M, "all_reduce": M}
    assert len(products) == M * 2 * 3 and max(c for _, c in products) == CHUNK


# -- the DNA projection -----------------------------------------------------------------

def test_projection_split_matches_jax_and_one_device(fake):
    """`fusion.project_dna` with its bias, colwise over two ranks (H/2
    output rows each, the bias whole) and gathered: the output on every
    rank against JAX's `dense` and one device's; the input's gradient, each
    rank's rows of the weight's, and the bias's summed over the ranks."""
    from bioreason_tpu_torch.models.fusion import project_dna
    w = RNG.standard_normal((H, D)).astype(np.float32) * D ** -0.5
    b = RNG.standard_normal(H).astype(np.float32)
    x = RNG.standard_normal((2, 5, D)).astype(np.float32)
    gy = torch.as_tensor(RNG.standard_normal((2, 5, H)), dtype=torch.float32)
    want_j = np.asarray(JL.dense({"kernel": jnp.asarray(w.T), "bias": jnp.asarray(b)},
                                 jnp.asarray(x), jnp.float32))

    def build(axis=None):
        proj = L.linear(D, H, True)
        with torch.no_grad():
            proj.weight.copy_(torch.as_tensor(w))
            proj.bias.copy_(torch.as_tensor(b))
        if axis is not None:
            proj.weight = torch.nn.Parameter(rows(proj.weight.detach(), axis))
            proj.tp = ("col", axis)
        return proj
    one = build()
    x1 = torch.as_tensor(x).requires_grad_(True)
    y1 = project_dna(one, x1, torch.float32)
    (y1 * gy).sum().backward()

    def rank(axis):
        proj = build(axis)
        xr = torch.as_tensor(x).requires_grad_(True)
        y = project_dna(proj, xr, torch.float32)
        (y * gy).sum().backward()
        return np_(y), np_(xr.grad), np_(proj.weight.grad), np_(proj.bias.grad)
    out = fake.run(rank)
    for y, dx, _, _ in out:
        close(y, want_j)
        close(y, np_(y1))
        close(dx, np_(x1.grad))
    close(np.concatenate([dw for _, _, dw, _ in out]), np_(one.weight.grad))
    close(sum(db for _, _, _, db in out), np_(one.bias.grad))


# -- the plan ---------------------------------------------------------------------------

def _tiny_model(vocab, untied=False, int8=False):
    import dataclasses

    from bioreason_tpu_torch import config as TC
    from bioreason_tpu_torch.models.fusion import init_fusion
    from bioreason_tpu_torch.train.quant import quantize_frozen_int8
    cfg = TC.FusionConfig.tiny(text_vocab=vocab)
    if untied:
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
            cfg.decoder, tie_word_embeddings=False))
    model = init_fusion(cfg, seed=0, device="cpu")
    if int8:
        quantize_frozen_int8(model, include_embed=True)
    return cfg, model


@pytest.mark.parametrize("vocab,m,untied,int8,pp", [
    (266, 2, False, False, False), (266, 4, False, False, False),
    (300, 2, True, False, False), (266, 2, False, True, False),
    (300, 2, True, False, True)])
def test_plan_splits_the_tables_and_projection_as_jax_places_them(vocab, m, untied, int8,
                                                                  pp):
    """`ShardPlan` at fsdp 2, model m: a float table (and an untied head)
    stores [V/m, H/2] rows with a ("vocab", axis) marker where m divides V,
    and stays whole over 'model' where it does not (266 at m = 4, JAX's
    `_valid_spec`); an int8 table stays whole on every rank with its
    `model_dims` set; the projection stores [H/m, D/2] with a colwise
    marker and its bias whole, partial over 'model'; under GPipe the tables
    and the projection stay replicated over 'model'."""
    from bioreason_tpu_torch.parallel.partition import ShardPlan
    from test_torch_mesh import _fake_topology
    cfg, model = _tiny_model(vocab, untied, int8)
    dec, enc = cfg.decoder, cfg.encoder
    plan = ShardPlan(model, dec, _fake_topology(2, m), pp=pp, encoder_cfg=enc)
    plan.apply(model)
    split = not pp and vocab % m == 0
    tables = ["decoder.embed.weight"] + (["decoder.lm_head.weight"] if untied else [])
    for name in tables:
        mod = model.get_submodule(name.rsplit(".", 1)[0])
        assert (name in plan.model_dims) == split, name
        assert L.vocab_axis(mod) is (plan.topo.model if split else None), name
        if int8:
            assert mod.weight.dtype == torch.int8 and tuple(mod.weight.shape) == (vocab, 64)
            assert plan.placements[name] == []
        else:
            rows_ = vocab // m if split else vocab
            cols = 64 if (pp and name == "decoder.embed.weight") else 32
            assert tuple(mod.weight.shape) == (rows_, cols), name
    proj = model.dna_projection
    assert tuple(proj.weight.shape) == ((64 // m, 32) if not pp else (64, 32))
    assert tuple(proj.bias.shape) == (64,)
    assert (getattr(proj, "tp", None) is not None) == (not pp)
    assert ("dna_projection.bias" in plan.partial_over_model) == (not pp)
