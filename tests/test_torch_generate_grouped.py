"""The port's grouped decode (GRPO rollouts) against the JAX package:
`_grouped_decode_attention`, `decoder_decode_step_grouped` and the engine's
`group_size > 1`, plus the sampler's answer on non-finite logit rows.

Tiny configs in fp32 on the CPU; weights drawn once by the JAX package and
carried over by `from_jax_params`; the JAX calls compiled whole with
`jax.jit`. Modules agree at 1e-5; greedy completions token for token."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioreason_tpu import config as JC
from bioreason_tpu.data import chat_template as j_chat
from bioreason_tpu.data import kegg as j_kegg
from bioreason_tpu.data.nt_tokenizer import KmerTokenizer as JKmer
from bioreason_tpu.data.processor import BioProcessor as JProc
from bioreason_tpu.data.text_tokenizer import ByteTextTokenizer as JByte
from bioreason_tpu.generate.engine import GenerationEngine as JEngine
from bioreason_tpu.models import qwen3 as JQ
from bioreason_tpu.models.fusion import init_fusion as j_init
from bioreason_tpu.ops import sampling as j_sampling
from bioreason_tpu_torch import config as TC
from bioreason_tpu_torch.generate.engine import GenerationEngine as TEngine
from bioreason_tpu_torch.models import qwen3 as TQ
from bioreason_tpu_torch.ops import sampling as t_sampling
from bioreason_tpu_torch.weights import from_jax_params

# one intra-op thread: the tensors here are tiny, and pytest-xdist runs
# several workers on the host's cores, which torch's default of a thread
# per core oversubscribes many times over
torch.set_num_threads(1)

TOK = JByte()


def t(x):
    return torch.from_numpy(np.asarray(x))


@functools.lru_cache(maxsize=None)
def setup():
    """JAX and port tiny configs (GQA: 4 query heads over 2 KV heads), the
    JAX params and the converted port model."""
    jcfg = JC.FusionConfig.tiny(text_vocab=TOK.vocab_size, dna_pad_token_id=TOK.dna_pad_id)
    tcfg = TC.FusionConfig.tiny(text_vocab=TOK.vocab_size, dna_pad_token_id=TOK.dna_pad_id)
    params = jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(3), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return jcfg, params, tcfg, model


def grouped_inputs(seed, bu=2, g=3, p=7, n=5, hq=4, hkv=2, d=16):
    """Random q, prompt K/V with left pads, decode K/V with the first
    `filled` slots valid (one fewer in the last row)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    pmask = np.ones((bu, p), np.int32)
    pmask[0, :3] = 0                                       # left pads
    dmask = np.zeros((bu * g, n), np.int32)
    dmask[:, :3] = 1
    dmask[-1, 2] = 0
    return (f(bu * g, 1, hq, d), f(bu, p, hkv, d), f(bu, p, hkv, d), pmask,
            f(bu * g, n, hkv, d), f(bu * g, n, hkv, d), dmask)


def test_grouped_decode_attention_matches():
    args = grouped_inputs(0)
    ref = jax.jit(JQ._grouped_decode_attention, static_argnums=7)(*args, 3)
    out = TQ._grouped_decode_attention(*(t(a) for a in args), 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    # the same as attending each completion to its own copy of the prompt
    q, pk, pv, pmask, dk, dv, dmask = (t(a) for a in args)
    from bioreason_tpu_torch.models.attention import xla_attention
    k = torch.cat([pk.repeat_interleave(3, 0), dk], 1)
    v = torch.cat([pv.repeat_interleave(3, 0), dv], 1)
    full = xla_attention(q, k, v, kv_mask=torch.cat([pmask.repeat_interleave(3, 0), dmask], 1))
    np.testing.assert_allclose(out.numpy(), full.numpy(), atol=1e-5, rtol=0)


def test_decoder_decode_step_grouped_matches():
    jcfg, params, tcfg, model = setup()
    dec = jcfg.decoder
    bu, g, p, n, idx = 2, 3, 7, 5, 3
    rng = np.random.default_rng(1)
    shape = lambda b, s: (b, s, dec.num_kv_heads, dec.head_dim)
    prompt = [{"k": rng.standard_normal(shape(bu, p)).astype(np.float32),
               "v": rng.standard_normal(shape(bu, p)).astype(np.float32)}
              for _ in range(dec.num_layers)]
    cache = [{"k": rng.standard_normal(shape(bu * g, n)).astype(np.float32),
              "v": rng.standard_normal(shape(bu * g, n)).astype(np.float32)}
             for _ in range(dec.num_layers)]
    ids = rng.integers(0, TOK.vocab_size, (bu * g, 1)).astype(np.int32)
    pos = rng.integers(4, 9, (bu * g, 1)).astype(np.int32)
    pmask = np.ones((bu, p), np.int32)
    pmask[1, :2] = 0
    dmask = np.zeros((bu * g, n), np.int32)
    dmask[:, :idx + 1] = 1

    @jax.jit
    def jstep(params, ids, pos, prompt, pmask, cache, dmask):
        return JQ.decoder_decode_step_grouped(params["decoder"], dec, ids, pos, prompt, pmask,
                                              cache, idx, dmask, g)
    jlogits, jcache = jstep(params, ids, pos, prompt, pmask, cache, dmask)
    tcache = [{k: t(v.copy()) for k, v in e.items()} for e in cache]
    with torch.no_grad():
        logits, out_cache = TQ.decoder_decode_step_grouped(
            model.decoder, tcfg.decoder, t(ids), t(pos),
            [{k: t(v) for k, v in e.items()} for e in prompt], t(pmask), tcache, idx,
            t(dmask), g)
    assert out_cache is tcache                              # written in place
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-5, rtol=0)
    for te, je in zip(tcache, jcache):
        for key in ("k", "v"):
            np.testing.assert_allclose(te[key].numpy(), np.asarray(je[key]), atol=1e-5, rtol=0)


@functools.lru_cache(maxsize=None)
def prompt_batch():
    items = j_kegg.synthetic_kegg_items(n=2, seq_len=40, seed=5)
    examples = [j_kegg.format_kegg_prompt_only(it) for it in items]
    out = JProc(TOK, JKmer())([j_chat.render_chat(ex["prompt"], add_generation_prompt=True)
                               for ex in examples],
                              [ex["dna_sequences"] for ex in examples],
                              max_length_dna=64, padding_side="left")
    return (out.input_ids, out.attention_mask, out.dna_input_ids, out.dna_attention_mask)


def test_generate_grouped_greedy_matches_jax_engine():
    """group_size=3: token for token the JAX engine's, the G copies of a
    group identical, and equal to the port's ungrouped generation."""
    jcfg, params, tcfg, model = setup()
    args = prompt_batch()
    jids, jmask = JEngine(jcfg, eos_token_id=TOK.eos_token_id).generate(
        params, *args, greedy=True, max_new_tokens=8, group_size=3)
    engine = TEngine(tcfg, eos_token_id=TOK.eos_token_id, device="cpu")
    ids, mask = engine.generate(model, *args, greedy=True, max_new_tokens=8, group_size=3)
    assert ids.shape == (6, 8) and engine.last_stats["batch"] == 6
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_array_equal(mask, np.asarray(jmask))
    single, smask = engine.generate(model, *args, greedy=True, max_new_tokens=8)
    for g in range(3):
        np.testing.assert_array_equal(ids[g], single[0])
        np.testing.assert_array_equal(ids[3 + g], single[1])
        np.testing.assert_array_equal(mask[3 + g], smask[1])
    assert engine.nonfinite_rows == 0


def test_grouped_prefill_holds_the_prompt_slots_only(monkeypatch):
    """The grouped engine prefills B_u rows into P slots and decodes into
    per-completion [B_u*G, N] caches: no cache of B_u*G rows over the prompt."""
    _, _, tcfg, model = setup()
    args = prompt_batch()
    shapes = []
    real = TQ.init_cache

    def spy(cfg, batch, max_len, *a, **kw):
        shapes.append((batch, max_len))
        return real(cfg, batch, max_len, *a, **kw)
    monkeypatch.setattr(TQ, "init_cache", spy)
    from bioreason_tpu_torch.generate import engine as E
    monkeypatch.setattr(E, "init_cache", spy)
    TEngine(tcfg, eos_token_id=TOK.eos_token_id, device="cpu").generate(
        model, *args, max_new_tokens=4, group_size=4, generator=torch.Generator().manual_seed(0))
    p = args[0].shape[1]
    assert shapes == [(2, p), (8, 4)]


def test_grouped_sampling_varies_within_a_group():
    _, _, tcfg, model = setup()
    ids = np.array([[3, 5, 9, 11]], np.int32)
    s = TC.SamplingConfig(temperature=1.5, top_k=50, top_p=1.0)
    toks, _ = TEngine(tcfg, eos_token_id=TOK.eos_token_id, device="cpu").generate(
        model, ids, np.ones_like(ids), sampling=s, max_new_tokens=6, group_size=4,
        generator=torch.Generator().manual_seed(5))
    assert len({tuple(r) for r in toks.tolist()}) > 1


@pytest.mark.parametrize("greedy", [False, True])
def test_sampler_is_total_on_nonfinite_rows(greedy):
    """A NaN row and an all -inf row give the JAX sampler's ids (0 for both)
    without raising; the finite rows keep the draws they get alone."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((4, 300)).astype(np.float32) * 3
    bad = logits.copy()
    bad[1] = np.nan
    bad[2] = -np.inf
    kw = dict(temperature=0.6, top_k=20, top_p=0.95, greedy=greedy)
    got = t_sampling.sample_logits(t(bad), **kw, generator=torch.Generator().manual_seed(0))
    want = np.asarray(j_sampling.sample_logits(jax.random.PRNGKey(0), jnp.asarray(bad), **kw))
    np.testing.assert_array_equal(got.numpy()[1:3], want[1:3])
    assert got.numpy()[1:3].tolist() == [0, 0]
    alone = t_sampling.sample_logits(t(logits), **kw, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got.numpy()[[0, 3]], alone.numpy()[[0, 3]])


def test_engine_counts_nonfinite_rows_and_still_answers():
    """A NaN final norm makes every logit row NaN: a sampled generate call
    returns ids in the vocabulary and counts the rows."""
    _, _, tcfg, model = setup()
    import copy
    broken = copy.deepcopy(model)
    with torch.no_grad():
        broken.decoder.final_norm.scale.fill_(float("nan"))
    engine = TEngine(tcfg, eos_token_id=TOK.eos_token_id, device="cpu")
    ids = np.array([[3, 5, 9, 11], [4, 4, 4, 4]], np.int32)
    toks, _ = engine.generate(broken, ids, np.ones_like(ids), max_new_tokens=3, group_size=2,
                              generator=torch.Generator().manual_seed(0))
    assert toks.shape == (4, 3) and ((toks >= 0) & (toks < tcfg.decoder.vocab_size)).all()
    assert engine.last_stats["nonfinite_rows"] == engine.nonfinite_rows == 4 * 3
