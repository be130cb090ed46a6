"""The port's continuous batcher (generate/continuous.py) against the JAX
package's `ContinuousBatcher` and the port's engine.

Tiny configs in fp32 on the CPU, weights drawn once by the JAX package and
carried over by `from_jax_params`. The JAX batcher runs once per reference
(cached): with EOS -1 it gives every prompt's whole greedy stream, and each
regime's expected tokens are that stream cut at the regime's EOS and
max_new_tokens (greedy decoding of one slot depends only on its own prompt,
which the JAX package's own tests show regime by regime). The port must give
those tokens in every scheduling regime: mixed prompt lengths with DNA,
staggered admission, slot reuse, windows k in {1, 3, 4}, EOS mid-window,
first-token EOS, pipelined churn, dedupe, the prefix cache, eviction,
preemption, drain packing and guided decoding."""

import functools
import json
import re

import jax
import numpy as np
import pytest
import torch

from bioreason_tpu import config as JC
from bioreason_tpu.data.nt_tokenizer import KmerTokenizer as JKmer
from bioreason_tpu.data.processor import BioProcessor as JProc
from bioreason_tpu.data.text_tokenizer import ByteTextTokenizer as JByte
from bioreason_tpu.generate import continuous as JCB
from bioreason_tpu.generate.guided import guided_spec_for as j_spec_for
from bioreason_tpu.models.fusion import init_fusion as j_init
from bioreason_tpu_torch import config as TC
from bioreason_tpu_torch.data.text_tokenizer import ByteTextTokenizer as TByte
from bioreason_tpu_torch.generate.continuous import ContinuousBatcher, Request, slot_attention
from bioreason_tpu_torch.generate.engine import GenerationEngine as TEngine
from bioreason_tpu_torch.generate.guided import guided_spec_for as t_spec_for
from bioreason_tpu_torch.weights import from_jax_params

# one intra-op thread: the tensors here are tiny, and pytest-xdist runs
# several workers on the host's cores, which torch's default of a thread
# per core oversubscribes many times over
torch.set_num_threads(1)

TOK = JByte()
PROC = JProc(TOK, JKmer())
EOS = TOK.eos_token_id
STREAM = 12                    # tokens of each reference stream
DNA = "ACGTACGTACGTACGT"
PROMPTS = ["hello world, this is a longer prompt " * 3, "short", "dna question",
           "another prompt of medium length here", "x" * 100, "final request in the queue",
           "probe", "another prompt", "third request text", "shared prompt",
           "first unique prompt", "second unique prompt", "long running request to preempt",
           "urgent request", "first request prompt text", "second arrives later",
           "short a", "short b request", "short c text here", "long request one " * 4]
PATTERN = r"<answer>(yes|no)</answer>"


def arrays(text):
    """(input_ids, attention_mask, dna_ids, dna_mask) of one prompt; the
    "dna question" carries one DNA sequence."""
    dna = [[DNA]] if text == "dna question" else None
    out = PROC(text=[text], batch_dna_sequences=dna, max_length_text=256, max_length_dna=32)
    return out.input_ids, out.attention_mask, out.dna_input_ids, out.dna_attention_mask


def req(rid, text, max_new=6, cls=Request, greedy=True):
    return cls(rid, *arrays(text), max_new_tokens=max_new, greedy=greedy)


@functools.lru_cache(maxsize=None)
def setup():
    jcfg = JC.FusionConfig.tiny(text_vocab=TOK.vocab_size, dna_pad_token_id=TOK.dna_pad_id)
    tcfg = TC.FusionConfig.tiny(text_vocab=TOK.vocab_size, dna_pad_token_id=TOK.dna_pad_id)
    params = jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return jcfg, params, tcfg, model


@functools.lru_cache(maxsize=None)
def jax_streams():
    """Every prompt's greedy stream of STREAM tokens from the JAX batcher
    (EOS -1: nothing stops early; capacity 8, windows of 4)."""
    jcfg, params, _, _ = setup()
    reqs = [req(i, t, STREAM, JCB.Request) for i, t in enumerate(PROMPTS)]
    cb = JCB.ContinuousBatcher(params, jcfg, eos_token_id=-1, capacity=8, max_len=256,
                               max_new=16, prompt_bucket=64)
    assert len(cb.run(reqs, window=4)) == len(reqs)
    return {t: r.tokens for t, r in zip(PROMPTS, reqs)}


def expected(text, max_new, eos=EOS):
    """The JAX batcher's tokens for `text` under `eos` and `max_new`."""
    out = []
    for t in jax_streams()[text][:max_new]:
        out.append(t)
        if t == eos:
            break
    return out


def batcher(eos=EOS, **kw):
    _, _, tcfg, model = setup()
    kw = {"capacity": 2, "max_len": 256, "prompt_bucket": 64, **kw}
    return ContinuousBatcher(model, tcfg, eos, device="cpu", **kw)


def check(reqs, eos=EOS):
    for r in reqs:
        assert r.done and r.tokens == expected(PROMPTS[r.rid], r.max_new_tokens, eos), (
            r.rid, r.tokens, expected(PROMPTS[r.rid], r.max_new_tokens, eos))


def churn():
    """Six requests with staggered quotas over two slots (constant slot
    rebinding; under run_pipelined, through the predicted-retire path)."""
    return [req(0, PROMPTS[0], 7), req(1, PROMPTS[1], 3), req(2, PROMPTS[2], 9),
            req(3, PROMPTS[3], 5), req(4, PROMPTS[4], 4), req(5, PROMPTS[5], 6)]


def test_reference_streams_agree_with_the_port_engine():
    """The JAX batcher's streams are the port engine's greedy tokens."""
    _, _, tcfg, model = setup()
    engine = TEngine(tcfg, eos_token_id=-1, device="cpu")
    for text in PROMPTS:
        ids, _ = engine.generate(model, *arrays(text), greedy=True, max_new_tokens=STREAM)
        assert ids[0].tolist() == jax_streams()[text], text


@pytest.mark.parametrize("mode", ["run", "run_pipelined"])
@pytest.mark.parametrize("window", [1, 3, 4])
def test_mixed_lengths_dna_and_slot_churn(window, mode):
    reqs = churn()
    done = getattr(batcher(), mode)(reqs, window=window)
    assert sorted(r.rid for r in done) == list(range(6))
    check(reqs)


def test_staggered_admission():
    cb = batcher(capacity=4)
    r1, r2 = req(14, PROMPTS[14]), req(15, PROMPTS[15])
    assert cb.admit(r1)
    for _ in range(3):                          # r1 decodes alone for 3 steps
        cb.step()
    assert cb.admit(r2)                         # joins at a token boundary
    while cb.active.any():
        cb.step()
    check([r1, r2])


def test_slot_reuse():
    reqs = [req(10, PROMPTS[10], 4), req(11, PROMPTS[11], 4)]
    assert len(batcher(capacity=1).run(reqs)) == 2
    check(reqs)


@pytest.mark.parametrize("mode", ["run", "run_pipelined"])
def test_eos_mid_window(mode):
    """EOS inside a window: the device deactivates the row, the replay
    stops at EOS, and the freed slot serves the queue."""
    eos = jax_streams()["probe"][2]
    reqs = [req(6, "probe", 8), req(7, "another prompt", 6), req(8, "third request text", 6)]
    assert len(getattr(batcher(eos), mode)(reqs, window=4)) == 3
    check(reqs, eos)
    assert reqs[0].tokens[-1] == eos and len(reqs[0].tokens) <= 3


def test_first_token_eos_is_deferred_to_the_window():
    first = jax_streams()["probe"][0]
    cb = batcher(first, max_new=8)
    r0, r1 = req(6, "probe", 4), req(7, "another prompt", 4)
    assert len(cb.admit_many([r0, r1])) == 2
    assert cb._pending_first and not r0.done          # resolution deferred
    fin = cb.step_window(4)
    assert r0 in fin and r0.done and r0.tokens == [first]
    cb.run([], window=4)
    check([r0, r1], first)
    # the same regime pipelined, with a third request taking the freed slot
    reqs = [req(6, "probe", 4), req(7, "another prompt", 4), req(8, "third request text", 4)]
    assert len(batcher(first, max_new=8).run_pipelined(reqs, window=4)) == 3
    check(reqs, first)


def test_max_new_one_resolves_at_admission():
    cb = batcher(-1, max_new=8)
    r = req(1, PROMPTS[1], 1)
    out = cb.admit_many([r])
    assert not cb._pending_first and out[0].done
    assert r.tokens == expected(PROMPTS[1], 1, -1)


def test_dedupe_and_prefix_cache_skip_the_prefill():
    cb = batcher(capacity=4, prefix_cache=True)
    reqs = [req(9, "shared prompt", 5) for _ in range(3)]
    assert len(cb.run_pipelined(reqs, window=2)) == 3
    assert cb.prefill_calls == 1                # one prefill for all three
    check(reqs)
    later = req(9, "shared prompt", 5)
    cb.run([later], window=2)
    assert cb.prefill_calls == 1                # a hit: no new prefill
    check([later])


def test_prefix_cache_eviction():
    cb = batcher(capacity=1, prefix_cache=True)
    a, b, a2 = req(10, PROMPTS[10], 3), req(11, PROMPTS[11], 3), req(10, PROMPTS[10], 3)
    cb.run([a], window=2)
    cb.run([b], window=2)                       # evicts a's retained row
    cb.run([a2], window=2)                      # must prefill again
    assert cb.prefill_calls == 3
    check([a, b, a2])


@pytest.mark.parametrize("mode", ["run", "run_pipelined"])
def test_preemption_resumes_the_same_trajectory(mode):
    cb = batcher()
    a = req(12, PROMPTS[12], 8)
    assert cb.admit(a)
    for _ in range(3):
        cb.step()
    assert not a.done and len(a.tokens) == 4
    cont = cb.preempt(a.slot)
    assert not cb.active.any()
    urgent = req(13, PROMPTS[13], 3)
    cb.run([urgent])                            # the freed slot serves a newcomer
    done = getattr(cb, mode)([cont], window=3)
    assert done == [cont] and cont.tokens is a.tokens
    check([cont, urgent])


def test_drain_packing():
    """Once the queue drains, live rows pack to the front and the windows
    step down the row buckets; tokens stay the same and the shape-stable
    pools serve the next run."""
    mk = lambda: [req(16, PROMPTS[16], 2), req(17, PROMPTS[17], 2), req(18, PROMPTS[18], 3),
                  req(19, PROMPTS[19], 12)]
    cb = batcher(capacity=4)
    assert cb.row_buckets == [1, 2, 4]
    cb.timers = {}
    reqs = mk()
    assert len(cb.run_pipelined(reqs, window=2)) == 4
    assert "pack" in cb.timers                  # the drain branch ran
    check(reqs)
    again = mk()
    cb.run_pipelined(again, window=2)
    check(again)


def test_warmup_is_state_neutral_and_sampling_properties():
    cb = batcher()
    cb.warmup([64], windows=(1, 3))
    reqs = churn()
    cb.run(reqs, window=3)
    check(reqs)
    # sampled rows: top_k = 1 samples the argmax; a seeded batcher repeats
    sampled = TC.SamplingConfig(temperature=0.6, top_k=1, top_p=0.95)
    reqs = [req(r.rid, PROMPTS[r.rid], r.max_new_tokens, greedy=False) for r in churn()]
    batcher(sampling=sampled).run_pipelined(reqs, window=3)
    check(reqs)
    free = TC.SamplingConfig(temperature=1.0, top_k=0, top_p=1.0)
    runs = []
    for _ in range(2):
        reqs = [req(r.rid, PROMPTS[r.rid], r.max_new_tokens, greedy=False) for r in churn()]
        batcher(-1, sampling=free, seed=3).run(reqs, window=3)
        assert all(len(r.tokens) == r.max_new_tokens for r in reqs)
        assert all(0 <= t < TOK.vocab_size for r in reqs for t in r.tokens)
        runs.append([r.tokens for r in reqs])
    assert runs[0] == runs[1]


def test_slot_attention_is_the_jax_merged_softmax():
    """The port's two tiers (prompt pool; decode pool holding this window's
    tokens) against the JAX function's three (prompt, decode, window)."""
    rng = np.random.default_rng(0)
    c, hq, hkv, d, p, n, k = 3, 4, 2, 16, 7, 5, 3
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, pk, pv, dk, dv, wk, wv = (f(c, 1, hq, d), f(c, p, hkv, d), f(c, p, hkv, d),
                                 f(c, n, hkv, d), f(c, n, hkv, d), f(c, k, hkv, d),
                                 f(c, k, hkv, d))
    pmask = (rng.random((c, p)) < 0.7).astype(np.int32)
    pmask[:, -1] = 1
    dmask = np.zeros((c, n), np.int32)
    dmask[0, :2], dmask[1, :5] = 1, 1           # row 2: no decode history
    wmask = np.zeros((c, k), np.int32)
    wmask[:, :2] = 1
    jcb = JCB.ContinuousBatcher.__new__(JCB.ContinuousBatcher)
    ref = jax.jit(jcb._slot_attention)(q, {"k": pk, "v": pv}, pmask, {"k": dk, "v": dv},
                                       dmask, wk, wv, wmask)
    hm = lambda x: torch.from_numpy(x).transpose(1, 2)          # head-major
    out = slot_attention(torch.from_numpy(q), hm(pk), hm(pv), torch.from_numpy(pmask).bool(),
                         hm(np.concatenate([dk, wk], 1)), hm(np.concatenate([dv, wv], 1)),
                         torch.from_numpy(np.concatenate([dmask, wmask], 1)).bool())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@functools.lru_cache(maxsize=None)
def jax_guided_tokens():
    jcfg, params, _, _ = setup()
    reqs = [JCB.Request(i, np.array([[3, 5, 9, 11 + i]], np.int32), np.ones((1, 4), np.int32),
                        max_new_tokens=24, greedy=True) for i in range(3)]
    cb = JCB.ContinuousBatcher(params, jcfg, eos_token_id=EOS, capacity=2, max_len=64,
                               prompt_bucket=16, max_new=24, guided=j_spec_for(TOK, PATTERN))
    cb.run(reqs, window=4)
    return [r.tokens for r in reqs]


@pytest.mark.parametrize("window", [1, 4])
def test_guided_batcher_matches_jax_and_the_engine(window):
    _, _, tcfg, model = setup()
    spec = t_spec_for(TByte(), PATTERN, vocab_size=tcfg.decoder.vocab_size)
    reqs = [Request(i, np.array([[3, 5, 9, 11 + i]], np.int32), np.ones((1, 4), np.int32),
                    max_new_tokens=24, greedy=True) for i in range(3)]
    cb = batcher(max_len=64, prompt_bucket=16, max_new=24, guided=spec)
    assert len(cb.run_pipelined(reqs, window=window)) == 3   # guided: run()
    assert [r.tokens for r in reqs] == jax_guided_tokens()
    engine = TEngine(tcfg, eos_token_id=EOS, device="cpu")
    for r in reqs:
        ids, mask = engine.generate(model, r.input_ids, r.attention_mask, greedy=True,
                                    max_new_tokens=24, guided=spec)
        assert ids[0][mask[0].astype(bool)].tolist() == r.tokens
        assert re.fullmatch(PATTERN, TByte().decode(r.tokens))
    with pytest.raises(NotImplementedError):
        cb.preempt(0)


def test_slot_attention_with_int8_pools_is_the_jax_function():
    """int8 prompt and decode tiers with their scales (on the logits and the
    probabilities) and a float window tier, against the JAX function."""
    rng = np.random.default_rng(1)
    c, hq, hkv, d, p, n, k = 3, 4, 2, 16, 7, 5, 3
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    i8 = lambda *s: rng.integers(-127, 128, s).astype(np.int8)
    sc = lambda *s: rng.uniform(0.005, 0.03, s).astype(np.float32)
    q, wk, wv = f(c, 1, hq, d), f(c, k, hkv, d), f(c, k, hkv, d)
    pe = {"k": i8(c, p, hkv, d), "v": i8(c, p, hkv, d), "k_scale": sc(c, p, hkv, 1),
          "v_scale": sc(c, p, hkv, 1)}
    de = {"k": i8(c, n, hkv, d), "v": i8(c, n, hkv, d), "k_scale": sc(c, n, hkv, 1),
          "v_scale": sc(c, n, hkv, 1)}
    pmask = (rng.random((c, p)) < 0.7).astype(np.int32)
    pmask[:, -1] = 1
    dmask = np.zeros((c, n), np.int32)
    dmask[0, :2], dmask[1, :5] = 1, 1
    wmask = np.zeros((c, k), np.int32)
    wmask[:, :2] = 1
    jcb = JCB.ContinuousBatcher.__new__(JCB.ContinuousBatcher)
    ref = jax.jit(jcb._slot_attention)(q, pe, pmask, de, dmask, wk, wv, wmask)
    hm = lambda x: torch.from_numpy(x).transpose(1, 2)          # head-major
    b = lambda x: torch.from_numpy(x).bool()
    out = slot_attention(torch.from_numpy(q), hm(pe["k"]), hm(pe["v"]), b(pmask), hm(de["k"]),
                         hm(de["v"]), b(dmask), (hm(pe["k_scale"]), hm(pe["v_scale"])),
                         (hm(de["k_scale"]), hm(de["v_scale"])), (hm(wk), hm(wv), b(wmask)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_kv_int8_and_oversized_requests_raise():
    """Oversized requests raise, with float and with int8 pools (kv_int8 is
    served since the int8 pools came; it no longer raises itself)."""
    for kv_int8 in (False, True):
        cb = batcher(max_new=4, kv_int8=kv_int8)
        assert cb.prompt_pool[0]["k"].dtype == (torch.int8 if kv_int8 else torch.float32)
        with pytest.raises(ValueError, match="decode-pool depth"):
            cb.admit(req(1, PROMPTS[1], 8))
        with pytest.raises(ValueError, match="prompt-pool width"):
            batcher(max_len=64, kv_int8=kv_int8).admit(req(4, PROMPTS[4], 2))


@functools.lru_cache(maxsize=None)
def jax_kv_int8_churn(window):
    """The JAX batcher with int8 pools over `churn()` (2 slots, EOS -1): an
    int8 stream depends on where windows fold into the pool, so the port
    runs the same schedule."""
    jcfg, params, _, _ = setup()
    reqs = [req(r.rid, PROMPTS[r.rid], r.max_new_tokens, JCB.Request) for r in churn()]
    cb = JCB.ContinuousBatcher(params, jcfg, eos_token_id=-1, capacity=2, max_len=256,
                               max_new=16, prompt_bucket=64, kv_int8=True)
    assert len(cb.run(reqs, window=window)) == len(reqs)
    return {r.rid: r.tokens for r in reqs}


@pytest.mark.parametrize("window", [3, 4])
def test_kv_int8_batcher_matches_the_jax_batcher_under_churn(window):
    """int8 prompt / decode pools (scales [C, Hkv, S, 1], head-major; JAX
    keeps [C, S, Hkv, 1]) and a float window tier: greedy tokens equal to
    the JAX int8 batcher's over six requests cycling through two slots, and
    the prompt pool's int8 rows equal to the JAX pool's, transposed."""
    cb = batcher(eos=-1, kv_int8=True, max_new=16)
    reqs = churn()
    cb.run(reqs, window=window)
    assert {r.rid: r.tokens for r in reqs} == jax_kv_int8_churn(window)
    assert cb.dec_pool[0]["k_scale"].shape == (2, 2, 17, 1)


TINY_BENCH = ["--decoder", "tiny", "--encoder", "tiny", "--device", "cpu", "--capacity", "4",
              "--max_new", "8", "--max_len", "64", "--prompt_len", "64", "--dna_len", "16",
              "--window", "4"]


@pytest.mark.parametrize("extra", [[], ["--no_pipeline"], ["--shared", "3"],
                                   ["--tiers", "2x128,2x256", "--requests", "8"]])
def test_bench_serve_at_tiny(extra, capsys):
    """tools/bench_serve.py on the CPU at tiny widths: every request is
    served to its quota (8 / 4 / 2 new tokens in rotation), the JSON line is
    printed, --shared prefills each unique prompt once, --tiers routes by
    prompt width."""
    from bioreason_tpu_torch.tools import bench_serve
    res = bench_serve.main(TINY_BENCH + extra)
    n = 8 if "--tiers" in extra else 12
    assert res["requests"] == n
    assert res["decoded_tokens"] == sum((8, 4, 2)[i % 3] for i in range(n))
    assert res["value"] > 0 and res["windows"] > 0 and 0 < res["mean_occupancy"] <= 1
    assert res["prefill_calls"] >= (4 if "--shared" in extra else 3)
    if "--shared" in extra:
        assert res["prefill_calls"] == 4                     # 12 requests, 4 prompts
    assert res["metric"].endswith("_tiered") == ("--tiers" in extra)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["decoded_tokens"] == res["decoded_tokens"]


@pytest.mark.parametrize("flag", [["--frozen", "int8"], ["--kv", "int8"], ["--fuse"],
                                  ["--w8a8"]])
def test_bench_serve_refuses_item_7(flag, capsys):
    """The JAX bench's storage flags, refused before the int8 slice came,
    now run (bf16 weights below unless the flag asks for int8): every
    request served to its quota, the flag in the JSON line; --w8a8 without
    int8 weights is refused as the JAX bench refuses it."""
    from bioreason_tpu_torch.tools import bench_serve
    frozen = [] if flag[0] in ("--frozen", "--w8a8") else ["--frozen", "bfloat16"]
    res = bench_serve.main(TINY_BENCH + frozen + flag)
    assert res["decoded_tokens"] == sum((8, 4, 2)[i % 3] for i in range(12))
    assert res["frozen"] == ("bfloat16" if frozen else "int8")
    assert (res["kv"] == "int8") == (flag == ["--kv", "int8"])
    assert res["fuse"] == (flag == ["--fuse"]) and res["w8a8"] == (flag == ["--w8a8"])
    if flag == ["--w8a8"]:
        with pytest.raises(SystemExit):
            bench_serve.main(TINY_BENCH + ["--frozen", "bfloat16", "--w8a8"])
    capsys.readouterr()
