"""The port's guided decoding (generate/guided.py) against the JAX package:
the regex -> DFA compiler and the token tables bit for bit (over the byte
tokenizer and a tiny byte-level BPE), the device half (`mask_logits`,
`advance`), greedy guided completions token for token (micro-batch and
grouped), sampled ones matching the pattern, the table past a tokenizer
smaller than the decoder's head, and `reason --guided_decoding_regex`.

Tiny configs in fp32 on the CPU; weights drawn once by the JAX package and
carried over by `from_jax_params`."""

import functools
import json
import re

import jax
import numpy as np
import pytest
import torch

from bioreason_tpu import config as JC
from bioreason_tpu.data.text_tokenizer import ByteTextTokenizer as JByte
from bioreason_tpu.data.text_tokenizer import load_hf_tokenizer as j_load_tok
from bioreason_tpu.generate import guided as JG
from bioreason_tpu.generate.engine import GenerationEngine as JEngine
from bioreason_tpu.models.fusion import init_fusion as j_init
from bioreason_tpu_torch import config as TC
from bioreason_tpu_torch.data.text_tokenizer import ByteTextTokenizer as TByte
from bioreason_tpu_torch.data.text_tokenizer import load_hf_tokenizer as t_load_tok
from bioreason_tpu_torch.generate import guided as TG
from bioreason_tpu_torch.generate.engine import GenerationEngine as TEngine
from bioreason_tpu_torch.weights import from_jax_params

# one intra-op thread: the tensors here are tiny, and pytest-xdist runs
# several workers on the host's cores, which torch's default of a thread
# per core oversubscribes many times over
torch.set_num_threads(1)

# the patterns of tests/test_guided.py
PATTERNS = [r"abc", r"a*b+c?", r"(yes|no)", r"<answer>(yes|no)</answer>", r"[a-c]{2,5}",
            r"\d+\.\d{2}", r"(ab)*c+", r"[^x]*x", r"a{3}", r"a{2,}b", r"(a|bc)(d|e)*",
            r"[A-Za-z_]\w*", r"\s?yes\s?", r"no|nope|nothing", r"^anchored$", r"a.c"]
PATTERN = r"<answer>(yes|no)</answer>"
TOK = JByte()


@functools.lru_cache(maxsize=None)
def bpe_dir(root):
    """A tiny byte-level BPE tokenizer.json (Qwen's Split regex, added and
    special tokens), built by `tokenizers` as tests/test_torch_pretrained.py
    builds one."""
    tokenizers = pytest.importorskip("tokenizers")
    from tokenizers import AddedToken, Regex, Tokenizer
    from tokenizers.models import BPE
    from tokenizers.pre_tokenizers import ByteLevel, Sequence, Split
    split = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
             r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
    alphabet = sorted(tokenizers.pre_tokenizers.ByteLevel.alphabet())
    vocab = {ch: i for i, ch in enumerate(alphabet)}
    merges = []
    for a, b in [("e", "s"), ("y", "es"), ("n", "o"), ("a", "n"), ("an", "s"), ("w", "e"),
                 ("ans", "we"), ("answe", "r"), ("<", "/"), ("<", "answer"), ("</", "answer"),
                 ("Ġ", "y"), ("Ġy", "es")]:
        if a + b not in vocab:
            vocab[a + b] = len(vocab)
        merges.append((a, b))
    raw = Tokenizer(BPE(vocab=vocab, merges=merges))
    raw.pre_tokenizer = Sequence([Split(Regex(split), behavior="isolated"),
                                  ByteLevel(add_prefix_space=False, use_regex=False)])
    raw.add_special_tokens([AddedToken(t, special=True)
                            for t in ("<|endoftext|>", "<|im_start|>", "<|im_end|>")])
    raw.add_tokens(["<think>", "</think>"])
    raw.save(f"{root}/tokenizer.json")
    with open(f"{root}/tokenizer_config.json", "w") as f:
        json.dump({"eos_token": "<|im_end|>"}, f)
    return root


def jax_tables(spec):
    return np.asarray(spec.next_state), np.asarray(spec.accepting), spec.dead, spec.eos_token_id


def port_tables(spec):
    return spec.next_state.numpy(), spec.accepting.numpy(), spec.dead, spec.eos_token_id


def assert_same_tables(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    assert a[0].dtype == b[0].dtype == np.int32
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2:] == b[2:]


@pytest.mark.parametrize("pattern", PATTERNS)
def test_dfa_and_byte_tokenizer_tables_bitwise(pattern):
    j, t = JG.compile_regex(pattern), TG.compile_regex(pattern)
    np.testing.assert_array_equal(t.table, j.table)
    np.testing.assert_array_equal(t.accepting, j.accepting)
    assert t.dead == j.dead
    assert TG.token_bytes_for(TByte()) == JG.token_bytes_for(TOK)
    assert_same_tables(port_tables(TG.guided_spec_for(TByte(), pattern)),
                       jax_tables(JG.guided_spec_for(TOK, pattern)))


def test_bpe_tables_bitwise(tmp_path_factory):
    root = bpe_dir(str(tmp_path_factory.mktemp("bpe")))
    jtok, ttok = j_load_tok(root), t_load_tok(root)
    assert TG.token_bytes_for(ttok) == JG.token_bytes_for(jtok)
    assert ttok.vocab_size == jtok.vocab_size
    for pattern in (PATTERN, r"\s?yes\s?", r"[A-Za-z_]\w*", r"(yes|no){1,2}"):
        assert_same_tables(port_tables(TG.guided_spec_for(ttok, pattern)),
                           jax_tables(JG.guided_spec_for(jtok, pattern)))
    with pytest.raises(TypeError):
        TG.token_bytes_for(object())
    with pytest.raises(TG.RegexError):
        TG.compile_regex(r"(?P<x>a)")


def test_mask_logits_and_advance_match_jax():
    spec_j = JG.guided_spec_for(TOK, PATTERN)
    spec_t = TG.guided_spec_for(TByte(), PATTERN)
    rng = np.random.default_rng(0)
    states = rng.integers(0, spec_t.dead + 1, 9).astype(np.int32)
    states[:3] = [0, spec_t.dead, int(np.nonzero(spec_t.accepting.numpy())[0][0])]
    logits = rng.standard_normal((9, TOK.vocab_size)).astype(np.float32)
    got = TG.mask_logits(torch.from_numpy(logits), torch.from_numpy(states), spec_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(JG.mask_logits(logits, states, spec_j)))
    toks = rng.integers(0, TOK.vocab_size, 9).astype(np.int32)
    toks[0] = ord("<")
    nxt = TG.advance(torch.from_numpy(states), torch.from_numpy(toks), spec_t)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(JG.advance(states, toks, spec_j)))


@functools.lru_cache(maxsize=None)
def setup(extra_vocab=0):
    """JAX and port tiny configs (the head `extra_vocab` rows past the byte
    tokenizer), the JAX params and the converted port model."""
    v = TOK.vocab_size + extra_vocab
    jcfg = JC.FusionConfig.tiny(text_vocab=v, dna_pad_token_id=TOK.dna_pad_id)
    tcfg = TC.FusionConfig.tiny(text_vocab=v, dna_pad_token_id=TOK.dna_pad_id)
    params = jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return jcfg, params, tcfg, model


IDS = np.array([[3, 5, 9, 11], [1, 2, 3, 4]], np.int32)


def completions(ids, mask):
    return TByte().batch_decode([r[m.astype(bool)] for r, m in zip(ids, mask)])


@pytest.mark.parametrize("group_size", [1, 3])
def test_greedy_guided_engine_matches_jax(group_size):
    jcfg, params, tcfg, model = setup()
    jids, jmask = JEngine(jcfg, eos_token_id=TOK.eos_token_id).generate(
        params, IDS, np.ones_like(IDS), greedy=True, max_new_tokens=24,
        group_size=group_size, guided=JG.guided_spec_for(TOK, PATTERN))
    ids, mask = TEngine(tcfg, eos_token_id=TOK.eos_token_id, device="cpu").generate(
        model, IDS, np.ones_like(IDS), greedy=True, max_new_tokens=24, group_size=group_size,
        guided=TG.guided_spec_for(TByte(), PATTERN, vocab_size=tcfg.decoder.vocab_size))
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_array_equal(mask, np.asarray(jmask))
    assert all(re.fullmatch(PATTERN, c) for c in completions(ids, mask))


@pytest.mark.parametrize("group_size", [1, 3])
def test_sampled_guided_completions_match(group_size):
    _, _, tcfg, model = setup()
    engine = TEngine(tcfg, eos_token_id=TOK.eos_token_id, device="cpu")
    spec = TG.guided_spec_for(TByte(), PATTERN)
    gen = torch.Generator().manual_seed(1)
    free = TC.SamplingConfig(temperature=1.0, top_k=0, top_p=1.0)
    ids, mask = engine.generate(model, IDS, np.ones_like(IDS), sampling=free, max_new_tokens=32,
                                generator=gen, group_size=group_size, guided=spec)
    texts = completions(ids, mask)
    assert len(texts) == 2 * group_size
    assert all(re.fullmatch(PATTERN, c) for c in texts), texts
    assert (ids == TOK.eos_token_id).any(-1).all()
    # without the constraint the random model matches nothing
    ids, mask = engine.generate(model, IDS, np.ones_like(IDS), sampling=free, max_new_tokens=32,
                                generator=gen)
    assert not any(re.fullmatch(PATTERN, c) for c in completions(ids, mask))


def test_tokenizer_smaller_than_the_head():
    """The head has 14 rows past the byte tokenizer's 266 ids: the JAX
    engine's mask does not broadcast there (its table is as wide as the
    tokenizer), the port's table is as wide as the head, its extra columns
    dead, so no completion holds an id the tokenizer cannot decode."""
    jcfg, params, tcfg, model = setup(14)
    jspec = JG.guided_spec_for(TOK, PATTERN)
    with pytest.raises(ValueError, match="broadcast"):
        JEngine(jcfg, eos_token_id=TOK.eos_token_id).generate(
            params, IDS, np.ones_like(IDS), greedy=True, max_new_tokens=4, guided=jspec)
    spec = TG.guided_spec_for(TByte(), PATTERN, vocab_size=tcfg.decoder.vocab_size)
    assert spec.next_state.shape == (spec.dead + 1, TOK.vocab_size + 14)
    assert (spec.next_state[:, TOK.vocab_size:] == spec.dead).all()
    np.testing.assert_array_equal(spec.next_state[:, :TOK.vocab_size].numpy(),
                                  np.asarray(jspec.next_state))
    engine = TEngine(tcfg, eos_token_id=TOK.eos_token_id, device="cpu")
    for greedy in (True, False):
        ids, mask = engine.generate(model, IDS, np.ones_like(IDS), greedy=greedy,
                                    max_new_tokens=32, generator=torch.Generator().manual_seed(2),
                                    guided=spec)
        assert ids.max() < TOK.vocab_size
        assert all(re.fullmatch(PATTERN, c) for c in completions(ids, mask))
    with pytest.raises(ValueError, match="smaller"):
        TG.guided_spec_for(TByte(), PATTERN, vocab_size=TOK.vocab_size - 1)


def test_reason_cli_guided_rollouts(tmp_path):
    """`reason --guided_decoding_regex` for 2 GRPO steps on `tiny`: the
    trainer compiles the spec once, and every rollout matches."""
    from bioreason_tpu_torch.cli import reason
    pattern = r"(yes|no){1,2}"
    assert TC.GRPOConfig(guided_decoding_regex=pattern).guided_decoding_regex == pattern
    trainer = reason.main([
        "--decoder", "tiny", "--encoder", "tiny", "--device", "cpu",
        "--guided_decoding_regex", pattern, "--num_generations", "2", "--batch_size", "4",
        "--max_steps", "2", "--max_completion_length", "16", "--max_length_dna", "128",
        "--n_synthetic", "8", "--checkpoint_dir", str(tmp_path / "ckpt"),
        "--log_dir", str(tmp_path / "logs")])
    assert trainer.guided is not None and trainer.step_count == 2
    assert trainer.guided.next_state.shape[1] == trainer.fusion_cfg.decoder.vocab_size
    assert len(trainer.last_completions) == 4
    for c in trainer.last_completions:
        assert re.fullmatch(pattern, c), repr(c)
    assert all(np.isfinite(m["loss"]) for m in trainer.metrics_history)
