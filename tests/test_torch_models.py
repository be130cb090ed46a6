"""The port's towers and splice against the JAX package, with the JAX
parameters converted by `bioreason_tpu_torch.weights.from_jax_params`.

Tiny configs in fp32 on the CPU; inputs from a numpy seed. Compared on valid
positions only: on fully masked (left-pad) query rows the JAX plain
attention returns the mean of V while the kernel route returns 0, and no
valid token ever reads those rows. Tolerance atol 1e-5 on hidden states and
logits (fp32 on both sides, summation order only).
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
from bioreason_tpu.models import qwen3 as JQ
from bioreason_tpu_torch import config as TC
from bioreason_tpu_torch.models import fusion as TF
from bioreason_tpu_torch.models import nt_encoder as TE
from bioreason_tpu_torch.models import qwen3 as TQ
from bioreason_tpu_torch.weights import from_jax_params

# one intra-op thread: the tensors here are tiny, and pytest-xdist runs
# several workers on the host's cores, which torch's default of a thread
# per core oversubscribes many times over
torch.set_num_threads(1)

ATOL = 1e-5
DNA_PAD = 260


def configs(enc_kw=None, dec_kw=None):
    jcfg = JC.FusionConfig.tiny()
    tcfg = TC.FusionConfig.tiny()
    if enc_kw:
        jcfg = dataclasses.replace(jcfg, encoder=dataclasses.replace(jcfg.encoder, **enc_kw))
        tcfg = dataclasses.replace(tcfg, encoder=dataclasses.replace(tcfg.encoder, **enc_kw))
    if dec_kw:
        jcfg = dataclasses.replace(jcfg, decoder=dataclasses.replace(jcfg.decoder, **dec_kw))
        tcfg = dataclasses.replace(tcfg, decoder=dataclasses.replace(tcfg.decoder, **dec_kw))
    return jcfg, tcfg


# encoder fields that change no parameter: configurations that differ only
# in them share the parameters drawn once for the configuration without them
PARAM_FREE = ("token_dropout", "num_heads", "attention_impl")


@functools.lru_cache(maxsize=None)
def _params(enc_items, dec_items):
    jcfg, _ = configs(dict(enc_items), dict(dec_items))
    return jax.jit(JF.init_fusion, static_argnums=1)(jax.random.PRNGKey(0), jcfg)


@functools.lru_cache(maxsize=None)
def _models(enc_items, dec_items):
    jcfg, tcfg = configs(dict(enc_items), dict(dec_items))
    params = _params(tuple(i for i in enc_items if i[0] not in PARAM_FREE), dec_items)
    tree = jax.tree.map(np.asarray, params)
    return jcfg, params, tcfg, from_jax_params(tree, tcfg, device="cpu")


def models(enc_kw=None, dec_kw=None):
    """JAX config, params, port config and converted port model; one per
    configuration (tests only read them). The decoder's head dim is 64, one
    the kernel takes, in every configuration, so all share one set of
    shapes and the JAX side compiles its ops once."""
    dec_kw = {"head_dim": 64, **(dec_kw or {})}
    return _models(tuple(sorted((enc_kw or {}).items())), tuple(sorted(dec_kw.items())))


def jitted(fn, cfg, **static):
    """`fn(params, cfg, ...)` of the JAX package compiled as a whole: run
    eagerly, JAX compiles each op on its own, seconds per test here."""
    return jax.jit(lambda params, *args, **kw: fn(params, cfg, *args, **kw, **static))


def t(x):
    return torch.from_numpy(np.asarray(x))


def valid_close(port, ref, mask, atol=ATOL):
    m = np.asarray(mask).astype(bool)
    np.testing.assert_allclose(port.detach().numpy()[m], np.asarray(ref)[m], atol=atol, rtol=0)


def left_padded_ids(rng, b, t_len, vocab, min_len):
    ids = rng.integers(0, vocab, (b, t_len)).astype(np.int32)
    mask = np.ones((b, t_len), np.int32)
    for i in range(b):
        mask[i, :t_len - rng.integers(min_len, t_len + 1)] = 0
    return ids, mask


@pytest.mark.parametrize("enc_kw", [
    {},
    {"token_dropout": True},
    {"use_swiglu": False, "mlp_bias": True},
    # one head of width 64, so the kernel route (its plain version on the
    # CPU) takes the bidirectional masked attention
    {"num_heads": 1, "attention_impl": "pallas"},
], ids=["swiglu", "token_dropout", "gelu_bias", "kernel_route"])
def test_encoder_forward(enc_kw):
    jcfg, params, tcfg, model = models(enc_kw)
    rng = np.random.default_rng(1)
    ids = rng.integers(3, 4107, (3, 20)).astype(np.int32)
    ids[:, 0] = 3                                       # <cls>
    ids[1, 4] = ids[2, 7] = 2                           # <mask> tokens
    mask = np.ones_like(ids)
    mask[0, 12:] = mask[2, 17:] = 0
    ids[mask == 0] = 1                                  # <pad>
    ref = jitted(JE.encoder_forward, jcfg.encoder)(params["encoder"], ids, mask)
    with torch.no_grad():
        out = TE.encoder_forward(model.encoder, tcfg.encoder, t(ids), t(mask))
    valid_close(out, ref, mask)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("tied", [True, False])
def test_decoder_forward_no_cache(impl, tied):
    jcfg, params, tcfg, model = models(dec_kw={"tie_word_embeddings": tied})
    tcfg = dataclasses.replace(tcfg.decoder, attention_impl=impl)
    ids, mask = left_padded_ids(np.random.default_rng(2), 3, 16, 266, 5)
    ref, _ = jitted(JQ.decoder_forward, jcfg.decoder)(params["decoder"], input_ids=ids,
                                                      attention_mask=mask)
    with torch.no_grad():
        out, cache = TQ.decoder_forward(model.decoder, tcfg, input_ids=t(ids),
                                        attention_mask=t(mask))
    assert cache is None and out.dtype == torch.float32
    valid_close(out, ref, mask)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_decoder_forward_with_cache(impl):
    """Prefill a left-padded prompt into a cache wider than the prompt
    (q_offset 0), then one decode step; logits and cache contents agree."""
    jcfg, params, tcfg, model = models()
    dcfg_j, dcfg_t = jcfg.decoder, dataclasses.replace(tcfg.decoder, attention_impl=impl)
    b, p, extra = 3, 12, 4
    ids, mask = left_padded_ids(np.random.default_rng(3), b, p, 266, 4)
    cmask = np.pad(mask, ((0, 0), (0, extra)))
    jcache = JQ.init_cache(dcfg_j, b, p + extra, jnp.float32)
    ref, jcache = jitted(JQ.decoder_forward, dcfg_j, cache_index=0)(
        params["decoder"], input_ids=ids, attention_mask=mask, cache=jcache, cache_mask=cmask)
    tcache = TQ.init_cache(dcfg_t, b, p + extra, torch.float32, "cpu")
    tmask = t(cmask).clone()
    with torch.no_grad():
        out, tcache2 = TQ.decoder_forward(model.decoder, dcfg_t, input_ids=t(ids),
                                          attention_mask=t(mask), cache=tcache,
                                          cache_index=0, cache_mask=tmask)
    assert tcache2 is tcache                            # written in place
    valid_close(out, ref, mask)
    for je, te in zip(jcache, tcache):
        valid_close(te["k"][:, :p], je["k"][:, :p], mask)
        valid_close(te["v"][:, :p], je["v"][:, :p], mask)

    # one decode step at slot p
    nxt = np.array([[5], [17], [200]], np.int32)
    pos = mask.sum(-1, keepdims=True).astype(np.int32)
    cmask[:, p] = 1
    tmask[:, p] = 1
    ref1, _ = jitted(JQ.decoder_forward, dcfg_j, cache_index=p)(
        params["decoder"], input_ids=nxt, attention_mask=np.ones((b, 1), np.int32),
        positions=pos, cache=jcache, cache_mask=cmask)
    with torch.no_grad():
        out1, _ = TQ.decoder_forward(model.decoder, dcfg_t, input_ids=t(nxt),
                                     attention_mask=torch.ones((b, 1), dtype=torch.int32),
                                     positions=t(pos), cache=tcache, cache_index=p,
                                     cache_mask=tmask)
    np.testing.assert_allclose(out1.numpy(), np.asarray(ref1), atol=ATOL, rtol=0)


def test_cache_entry_update_in_place():
    cfg = TC.DecoderConfig.tiny()
    cache = TQ.init_cache(cfg, 2, 8, torch.float32, "cpu")
    buf = cache[0]["k"]
    k = torch.randn(2, 3, cfg.num_kv_heads, cfg.head_dim)
    entry = TQ.cache_entry_update(cache[0], k, -k, 4)
    assert entry["k"] is buf and entry["k"].data_ptr() == buf.data_ptr()
    assert torch.equal(buf[:, 4:7], k) and torch.equal(cache[0]["v"][:, 4:7], -k)
    assert torch.all(buf[:, :4] == 0) and torch.all(buf[:, 7:] == 0)


def splice_case(rng, per_item, b=2, ld=10, h=8, t_len=40):
    dna_mask = np.zeros((b * per_item, ld), np.int32)
    for s in range(b * per_item):
        dna_mask[s, :rng.integers(0, ld + 1)] = 1
    counts = dna_mask.reshape(b, -1).sum(-1)
    ids = rng.integers(0, 250, (b, t_len)).astype(np.int32)
    for i in range(b):
        slots = rng.choice(np.arange(2, t_len), counts[i], replace=False)
        ids[i, np.sort(slots)] = DNA_PAD
    text = rng.standard_normal((b, t_len, h)).astype(np.float32)
    dna = rng.standard_normal((b * per_item, ld, h)).astype(np.float32)
    return text, ids, dna, dna_mask


@pytest.mark.parametrize("per_item", [1, 2])
def test_splice_embeddings_per_item(per_item):
    text, ids, dna, dmask = splice_case(np.random.default_rng(4), per_item)
    ref = JF.splice_embeddings_per_item(text, ids, dna, dmask, DNA_PAD, per_item)
    out = TF.splice_embeddings_per_item(t(text), t(ids), t(dna), t(dmask), DNA_PAD, per_item)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_splice_embeddings_batch_global():
    text, ids, dna, dmask = splice_case(np.random.default_rng(5), 2)
    ref = JF.splice_embeddings(text, ids, dna, dmask, DNA_PAD)
    out = TF.splice_embeddings(t(text), t(ids), t(dna), t(dmask), DNA_PAD)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_fused_input_embeddings():
    """Embedding lookup + encoder + projection + splice, as prefill sees it."""
    jcfg, params, tcfg, model = models()
    rng = np.random.default_rng(6)
    dna_ids = rng.integers(6, 4102, (4, 12)).astype(np.int32)
    dna_mask = np.ones_like(dna_ids)
    dna_mask[1, 9:] = dna_mask[3, 5:] = 0
    dna_ids[dna_mask == 0] = 1
    counts = dna_mask.reshape(2, -1).sum(-1)
    ids = rng.integers(0, 250, (2, 48)).astype(np.int32)
    for i in range(2):
        ids[i, 3:3 + counts[i]] = DNA_PAD
    ref = jitted(JF.fused_input_embeddings, jcfg)(params, ids, dna_ids, dna_mask)
    with torch.no_grad():
        out = TF.fused_input_embeddings(model, tcfg, t(ids), t(dna_ids), t(dna_mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_from_jax_params_layout():
    """Stacked [L, ...] leaves unstack per layer; [in, out] kernels are
    stored transposed as nn.Linear's [out, in]."""
    jcfg, params, tcfg, model = models()
    q0 = np.asarray(params["decoder"]["layers"]["attn"]["q"]["kernel"][1])
    np.testing.assert_array_equal(model.decoder.layers[1].attn.q.weight.detach().numpy(), q0.T)
    ob = np.asarray(params["encoder"]["layers"]["attn"]["o"]["bias"][0])
    np.testing.assert_array_equal(model.encoder.layers[0].attn.o.bias.detach().numpy(), ob)
    assert model.decoder.lm_head is None                # tied: the embedding is the head
    with pytest.raises(ValueError):
        from_jax_params(jax.tree.map(np.asarray, params),
                        dataclasses.replace(tcfg, decoder=dataclasses.replace(
                            tcfg.decoder, tie_word_embeddings=False)), device="cpu")


def test_init_fusion_is_seeded():
    cfg = TC.FusionConfig.tiny()
    a = TF.init_fusion(cfg, seed=3, device="cpu")
    b = TF.init_fusion(cfg, seed=3, device="cpu")
    c = TF.init_fusion(cfg, seed=4, device="cpu")
    wa, wb, wc = (m.decoder.layers[0].mlp.up.weight for m in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert torch.all(a.dna_projection.bias == 0)
