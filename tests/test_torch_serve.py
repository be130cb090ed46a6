"""The port's serving slice as a whole against the JAX package: the data
front end (tokenizers, chat template, KEGG formatting, processor), the
generation engine with the same converted weights, and the server on the
CPU. Plus the package rule: the port imports neither JAX nor anything of
`bioreason_tpu`.

Tiny configs, fp32, CPU. Greedy completions must be identical; the
last-column prefill logits agree to atol 1e-4 (fp32 through the encoder,
the splice and two decoder layers)."""

import json
import re
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
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
from bioreason_tpu.models.fusion import fused_input_embeddings as j_fused
from bioreason_tpu.models.fusion import init_fusion as j_init
from bioreason_tpu.models.qwen3 import decoder_forward as j_decoder, init_cache as j_cache
from bioreason_tpu.ops import sampling as j_sampling
from bioreason_tpu.train.rewards import extract_answer as j_extract
from bioreason_tpu_torch import config as TC
from bioreason_tpu_torch.data import chat_template as t_chat
from bioreason_tpu_torch.data import kegg as t_kegg
from bioreason_tpu_torch.data.nt_tokenizer import KmerTokenizer as TKmer
from bioreason_tpu_torch.data.processor import BioProcessor as TProc
from bioreason_tpu_torch.data.text_tokenizer import ByteTextTokenizer as TByte
from bioreason_tpu_torch.generate.engine import GenerationEngine as TEngine
from bioreason_tpu_torch.ops import sampling as t_sampling
from bioreason_tpu_torch.serve import (InferenceServer, main, make_http_server, parse_args,
                                       server_from_args)
from bioreason_tpu_torch.train.rewards import extract_answer as t_extract
from bioreason_tpu_torch.utils.devices import resolve_device
from bioreason_tpu_torch.weights import from_jax_params

# one intra-op thread: the tensors here are tiny, and pytest-xdist runs
# several workers on the host's cores, which torch's default of a thread
# per core oversubscribes many times over
torch.set_num_threads(1)

ITEMS = j_kegg.synthetic_kegg_items(n=3, seq_len=40, seed=2)


# -- data front end -----------------------------------------------------------

@pytest.mark.parametrize("text", [
    "<|im_start|>user\nwhich pathway?<|im_end|>\n<think>\nok</think>",
    "plain ascii", "ünïcødé ✓ <|dna_start|><|dna_pad|><|dna_end|>", ""])
def test_byte_tokenizer_ids(text):
    j, t = JByte(), TByte()
    assert t.encode(text) == j.encode(text)
    ids = j.encode(text)
    assert t.decode(ids) == j.decode(ids)
    assert t.decode(ids, skip_special_tokens=False) == j.decode(ids, skip_special_tokens=False)
    for side in ("left", "right"):
        a = t([text, "ab"], padding_side=side)
        b = j([text, "ab"], padding_side=side)
        for key in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("seq", ["ACGTACGTACGTAC", "ACGTNNACGTTTGCAGGA", "AC", "acgtx",
                                 ITEMS[0]["reference_sequence"]])
def test_kmer_tokenizer_ids_identical(seq):
    j, t = JKmer(), TKmer()
    assert t.encode(seq) == j.encode(seq)
    a, b = t([seq, seq[:5]], max_length=8), j([seq, seq[:5]], max_length=8)
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(a[key], b[key])


def test_kegg_chat_and_answer_extraction():
    assert t_kegg.synthetic_kegg_items(n=5, seq_len=40, seed=2)[:3] == ITEMS
    for kw in ({}, {"learnable": True}, {"fixed_positions": True}):
        assert (t_kegg.synthetic_kegg_items(n=4, seq_len=32, **kw)
                == j_kegg.synthetic_kegg_items(n=4, seq_len=32, **kw))
    for item in ITEMS:
        jp, tp = j_kegg.format_kegg_prompt_only(item), t_kegg.format_kegg_prompt_only(item)
        assert tp == jp
        for kw in ({"add_generation_prompt": True}, {"add_dna_id": True},
                   {"add_generation_prompt": True, "enable_thinking": False}):
            assert t_chat.render_chat(tp["prompt"], **kw) == j_chat.render_chat(jp["prompt"], **kw)
    chat = j_kegg.format_kegg_for_dna_llm({**ITEMS[0], "reasoning": "step\none"})
    assert t_chat.render_chat(chat["prompt"]) == j_chat.render_chat(chat["prompt"])
    for text in ("<think>x</think> Answer: apoptosis", "no tags", "a</think>b</think> c "):
        assert t_extract(text) == j_extract(text)


def test_processor_outputs_identical():
    examples = [j_kegg.format_kegg_prompt_only(it) for it in ITEMS]
    rendered = [j_chat.render_chat(ex["prompt"], add_generation_prompt=True) for ex in examples]
    dna = [ex["dna_sequences"] for ex in examples]
    dna[1] = dna[1][:1]                       # a ragged item: uniformized with a pad row
    rendered[1] = rendered[1].replace("<|dna_start|><|dna_pad|><|dna_end|>", "", 1)
    a = TProc(TByte(), TKmer())(rendered, dna, max_length_dna=30, padding_side="left")
    b = JProc(JByte(), JKmer())(rendered, dna, max_length_dna=30, padding_side="left")
    for key in ("input_ids", "attention_mask", "dna_input_ids", "dna_attention_mask"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
    assert a.batch_idx_map == b.batch_idx_map


def test_sampling_kept_set_and_eos_mask():
    """Draws differ between jax.random and torch.Generator, so the check is
    on greedy ids, the top-k/top-p kept set and the EOS mask."""
    logits = np.random.default_rng(3).standard_normal((4, 300)).astype(np.float32) * 3
    np.testing.assert_array_equal(
        t_sampling.sample_logits(torch.from_numpy(logits), greedy=True).numpy(),
        np.asarray(j_sampling.sample_logits(jax.random.PRNGKey(0), logits, greedy=True)))
    vals, idx = t_sampling.top_k_top_p_filter(torch.from_numpy(logits), 0.6, 20, 0.95)
    kept = [set(i[v > -np.inf].tolist()) for v, i in zip(vals.numpy(), idx.numpy())]
    # reference kept set, computed as sampling.py:39-46 does
    lj, ij = jax.lax.top_k(logits / 0.6, 20)
    pj = jax.nn.softmax(lj, axis=-1)
    keep = (np.cumsum(pj, -1) - pj) < 0.95
    assert kept == [set(np.asarray(i)[k].tolist()) for i, k in zip(ij, keep)]
    gen = torch.Generator().manual_seed(0)
    draws = t_sampling.sample_logits(torch.from_numpy(logits), 0.6, 20, 0.95, generator=gen)
    assert all(d in s for d, s in zip(draws.tolist(), kept))
    toks = np.array([[5, 7, 9, 7], [1, 2, 3, 4], [7, 1, 1, 1]], np.int32)
    np.testing.assert_array_equal(
        t_sampling.completion_mask_from_eos(torch.from_numpy(toks), 7).numpy(),
        np.asarray(j_sampling.completion_mask_from_eos(toks, 7)))


# -- the engine against the JAX engine ----------------------------------------

@pytest.fixture(scope="module")
def slice_setup():
    tok, dtok = JByte(), JKmer()
    jcfg = JC.FusionConfig.tiny(text_vocab=tok.vocab_size, dna_pad_token_id=tok.dna_pad_id)
    tcfg = TC.FusionConfig.tiny(text_vocab=tok.vocab_size, dna_pad_token_id=tok.dna_pad_id)
    params = jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(7), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    examples = [j_kegg.format_kegg_prompt_only(it) for it in ITEMS]
    out = JProc(tok, dtok)([j_chat.render_chat(ex["prompt"], add_generation_prompt=True)
                            for ex in examples],
                           [ex["dna_sequences"] for ex in examples],
                           max_length_dna=64, padding_side="left")
    return jcfg, params, tcfg, model, out, tok


def test_generate_greedy_matches_jax_engine(slice_setup):
    jcfg, params, tcfg, model, batch, tok = slice_setup
    args = (batch.input_ids, batch.attention_mask, batch.dna_input_ids,
            batch.dna_attention_mask)
    jids, jmask = JEngine(jcfg, eos_token_id=tok.eos_token_id).generate(
        params, *args, greedy=True, max_new_tokens=8)
    engine = TEngine(tcfg, eos_token_id=tok.eos_token_id, device="cpu")
    tids, tmask = engine.generate(model, *args, greedy=True, max_new_tokens=8)
    np.testing.assert_array_equal(tids, np.asarray(jids))
    np.testing.assert_array_equal(tmask, np.asarray(jmask))
    assert engine.nonfinite_rows == 0 and engine.last_stats["batch"] == len(ITEMS)

    # last-column prefill logits
    b, p = batch.input_ids.shape
    @jax.jit              # compiled whole: eagerly, JAX compiles op by op
    def jax_prefill(params, ids, mask, dna_ids, dna_mask):
        embeds = j_fused(params, jcfg, ids, dna_ids, dna_mask)
        cache = j_cache(jcfg.decoder, b, p + 8, np.float32)
        return j_decoder(params["decoder"], jcfg.decoder, inputs_embeds=embeds,
                         attention_mask=mask, cache=cache, cache_index=0,
                         cache_mask=jax.numpy.pad(mask, ((0, 0), (0, 8))))[0]
    jlog = jax_prefill(params, *args)
    tlog, _, _ = engine.prefill(model, *(torch.from_numpy(a) for a in args), max_new_tokens=8)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog[:, -1]), atol=1e-4, rtol=0)


def test_server_request_and_http_round_trip(slice_setup):
    _, _, tcfg, model, _, tok = slice_setup
    server = InferenceServer(model, tcfg, TProc(TByte(), TKmer()), max_new_tokens=6,
                             greedy_default=True, device="cpu").start()
    httpd = make_http_server(server, port=0, host="127.0.0.1")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        direct = server.generate(ITEMS[0])
        port = httpd.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"status": "ok"}
        body = json.dumps({k: ITEMS[0][k] for k in
                           ("question", "reference_sequence", "variant_sequence")}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            over_http = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop()
    assert set(direct) == {"completion", "answer"}
    assert over_http == direct                        # greedy repeats are identical
    assert server.engine_calls == 2


TINY_MAIN = ["--decoder", "tiny", "--encoder", "tiny", "--device", "cpu", "--max_new_tokens", "6"]


@pytest.mark.parametrize("flag", ["--int8", "--kv_int8", "--fuse", "--w8a8"])
def test_main_refuses_later_slices(flag):
    """The serving flags the earlier slices refused are served now; the one
    refusal left is the JAX server's own: --w8a8 without --int8."""
    if flag == "--w8a8":
        with pytest.raises(SystemExit):
            main(TINY_MAIN + [flag])
        return
    server = server_from_args(parse_args(TINY_MAIN + [flag]))
    layer = server.model.decoder.layers[0]
    assert (layer.mlp.down.weight.dtype == torch.int8) == (flag == "--int8")
    assert (server.model.decoder.embed.weight.dtype == torch.int8) == (flag == "--int8")
    assert hasattr(layer.attn, "qkv") == (flag == "--fuse")
    assert server.engine.kv_int8 == (flag == "--kv_int8")


def test_main_serves_int8_kv_int8_fuse_w8a8_over_http():
    """`serve --int8 --kv_int8 --fuse --w8a8` on the tiny presets answers
    over HTTP, greedy repeats identical."""
    server = server_from_args(parse_args(TINY_MAIN + ["--int8", "--kv_int8", "--fuse", "--w8a8"]))
    assert server.cfg.decoder.act_int8 and server.cfg.encoder.act_int8
    layer = server.model.encoder.layers[0]
    assert layer.attn.qkv.weight.dtype == torch.int8 and layer.attn.qkv.bias is not None
    port, close = _serve(server)
    try:
        answers = [_post(port, ITEMS[0], greedy=True) for _ in range(2)]
    finally:
        close()
    assert [code for code, _ in answers] == [200, 200]
    assert answers[0] == answers[1] and set(answers[0][1]) == {"completion", "answer"}


PATTERN = r"<answer>(yes|no)</answer>"


def _post(port, item, **extra):
    body = json.dumps({**{k: item[k] for k in ("question", "reference_sequence",
                                               "variant_sequence")}, **extra}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _serve(server):
    server.start()
    httpd = make_http_server(server, port=0, host="127.0.0.1")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()

    def close():
        httpd.shutdown()
        httpd.server_close()
        server.stop()
    return httpd.server_address[1], close


def test_continuous_tiers_and_guided_over_http(slice_setup):
    """`--continuous --tiers --guided_regex --decode_window` on `tiny`: two
    prompt lengths route to the two depth classes, every request is
    answered over HTTP, every completion fullmatches the server's pattern,
    greedy completions equal the micro-batch server's, and a request
    asking for another pattern is refused without stopping the loop."""
    _, _, tcfg, model, _, tok = slice_setup
    items = [ITEMS[0], {**ITEMS[1], "question": "ok?"}, ITEMS[2], {**ITEMS[0], "question": "why"}]
    kw = dict(max_new_tokens=24, greedy_default=True, device="cpu", guided_regex=PATTERN)
    server = InferenceServer(model, tcfg, TProc(TByte(), TKmer()), continuous=True,
                             tiers="2x256,2x128", decode_window=3, **kw)
    assert server.tiers == [(2, 128), (2, 256)]
    port, close = _serve(server)
    try:
        results = [None] * 6

        def one(i):
            results[i] = _post(port, items[i % 4])
        threads = [threading.Thread(target=one, args=(i,)) for i in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        refused = _post(port, items[0], guided_regex="(yes|no)")
        after = _post(port, items[1])
    finally:
        close()
    assert [code for code, _ in results] == [200] * 6 and after[0] == 200
    assert refused[0] == 400 and "server-level" in refused[1]["error"]
    assert server.routed == [4, 3]                  # short prompts to 2x128, long to 2x256
    for _, out in results:
        assert re.fullmatch(PATTERN, out["completion"]), out
    micro = InferenceServer(model, tcfg, TProc(TByte(), TKmer()), **kw).start()
    try:
        for i, (_, out) in enumerate(results[:4]):
            assert micro.generate(items[i]) == out
    finally:
        micro.stop()


def test_micro_batch_per_request_guided_regex(slice_setup):
    """Micro-batch mode groups a batch's requests by pattern: one engine
    call per pattern, each completion matching its own."""
    _, _, tcfg, model, _, tok = slice_setup
    server = InferenceServer(model, tcfg, TProc(TByte(), TKmer()), max_new_tokens=24,
                             greedy_default=False, batch_window_ms=300.0, device="cpu")
    port, close = _serve(server)
    try:
        pats = [PATTERN, r"(yes|no){1,2}", PATTERN, None]
        results = [None] * 4

        def one(i):
            extra = {} if pats[i] is None else {"guided_regex": pats[i]}
            results[i] = _post(port, ITEMS[i % 3], **extra)
        threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        close()
    assert [code for code, _ in results] == [200] * 4
    for pat, (_, out) in zip(pats, results):
        if pat is not None:
            assert re.fullmatch(pat, out["completion"]), (pat, out)
    assert server.engine_calls >= 3 and len(server._guided_cache) == 2


def test_continuous_server_refuses_kv_int8(slice_setup):
    """A continuous server with kv_int8 (refused before the int8 pools came)
    builds int8 pools for every tier and answers."""
    _, _, tcfg, model, _, _ = slice_setup
    server = InferenceServer(model, tcfg, TProc(TByte(), TKmer()), continuous=True,
                             kv_int8=True, tiers="2x256,2x512", max_new_tokens=6,
                             greedy_default=True, device="cpu")
    port, close = _serve(server)
    try:
        code, out = _post(port, ITEMS[0])
    finally:
        close()
    assert code == 200 and set(out) == {"completion", "answer"}
    assert [cb.prompt_pool[0]["k"].dtype for cb in server.batchers] == [torch.int8] * 2


def test_cuda_asked_for_and_absent_raises():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            TEngine(TC.FusionConfig.tiny(), eos_token_id=258)
    assert resolve_device("cpu").type == "cpu"


def test_port_imports_no_jax_and_nothing_of_bioreason_tpu(tmp_path):
    """Every module of the port, imported in a fresh interpreter, leaves
    `jax`, `bioreason_tpu` and `bioreason_tpu.*` out of sys.modules (the
    port's own name shares the prefix, so names are matched exactly), and
    `transformers`, `tokenizers`, `safetensors` and `regex` too: the card's
    machine has none of them."""
    import pathlib
    repo = pathlib.Path(__file__).resolve().parent.parent
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {str(repo)!r})
import bioreason_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "bioreason_tpu_torch.")]
training = {{"bioreason_tpu_torch.ops.fused_ce", "bioreason_tpu_torch.train.lora",
            "bioreason_tpu_torch.train.trainable", "bioreason_tpu_torch.train.optim",
            "bioreason_tpu_torch.train.sft", "bioreason_tpu_torch.train.checkpoint",
            "bioreason_tpu_torch.train.dataflow", "bioreason_tpu_torch.data.collate",
            "bioreason_tpu_torch.data.utils", "bioreason_tpu_torch.data.loaders",
            "bioreason_tpu_torch.cli.common", "bioreason_tpu_torch.cli.train_sft",
            "bioreason_tpu_torch.train.grpo", "bioreason_tpu_torch.train.rewards",
            "bioreason_tpu_torch.train.metrics", "bioreason_tpu_torch.cli.reason",
            "bioreason_tpu_torch.models.evo2", "bioreason_tpu_torch.data.char_tokenizer",
            "bioreason_tpu_torch.utils.evo2_import", "bioreason_tpu_torch.utils.pretrained",
            "bioreason_tpu_torch.utils.safetensors_io", "bioreason_tpu_torch.utils.hf_import",
            "bioreason_tpu_torch.utils.ref_ckpt", "bioreason_tpu_torch.utils.profiling",
            "bioreason_tpu_torch.data.bpe", "bioreason_tpu_torch.data.variant_effect",
            "bioreason_tpu_torch.train.eval", "bioreason_tpu_torch.generate.continuous",
            "bioreason_tpu_torch.generate.guided", "bioreason_tpu_torch.tools.bench_serve",
            "bioreason_tpu_torch.models.classifier", "bioreason_tpu_torch.train.classifier",
            "bioreason_tpu_torch.train.quant", "bioreason_tpu_torch.train.fuse",
            "bioreason_tpu_torch.cli.train_dna_only",
            "bioreason_tpu_torch.tools.bench_classifier", "bioreason_tpu_torch.tools.bench_sft",
            "bioreason_tpu_torch.tools.bench_grpo", "bioreason_tpu_torch.tools.bench_rollout",
            "bioreason_tpu_torch.tools.unicode_classes", "bioreason_tpu_torch.tools.rehearsal",
            "bioreason_tpu_torch.tools.diagnose_quality", "bioreason_tpu_torch.utils.debug_nans"}}
assert training <= set(names), sorted(training - set(names))
for n in names:
    importlib.import_module(n)
banned = ("jax", "jaxlib", "bioreason_tpu", "transformers", "tokenizers", "safetensors", "regex")
bad = sorted(m for m in sys.modules
             if m in banned or m.startswith(tuple(b + "." for b in banned)))
print(len(names), bad)
assert not bad, bad
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 71
