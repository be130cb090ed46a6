"""The port's reasoning-trace generation (`data/traces.py`,
`cli/make_traces.py`) against the JAX package's: the cases of
tests/test_traces.py run on the port, every deterministic function's
output held equal to JAX's on the same inputs, and the engine backend's
greedy replies on the same tiny weights (`from_jax_params`) equal to the
JAX engine's, the reply that does not parse falling back to the template
on both sides."""

import json
import re

import jax
import numpy as np
import pytest
import torch

from bioreason_tpu import config as JC
from bioreason_tpu.cli import make_traces as JMT
from bioreason_tpu.data import traces as JT
from bioreason_tpu.data.nt_tokenizer import KmerTokenizer as JKmer
from bioreason_tpu.data.processor import BioProcessor as JProc
from bioreason_tpu.data.text_tokenizer import ByteTextTokenizer as JByte
from bioreason_tpu.generate.engine import GenerationEngine as JEngine
from bioreason_tpu.models.fusion import init_fusion as j_init
from bioreason_tpu_torch import config as TC
from bioreason_tpu_torch.cli import make_traces as TMT
from bioreason_tpu_torch.data import BioProcessor, ByteTextTokenizer, KmerTokenizer
from bioreason_tpu_torch.data import traces as TT
from bioreason_tpu_torch.generate.engine import GenerationEngine
from bioreason_tpu_torch.weights import from_jax_params
from test_traces import VARIANT

# one intra-op thread: the tensors here are tiny, and pytest-xdist runs
# several workers on the host's cores, which torch's default of a thread
# per core oversubscribes many times over
torch.set_num_threads(1)

VARIANTS = [VARIANT,
            {**VARIANT, "Var_ID": "rs2", "Chr": "X", "Start": "5", "RefAllele": "AT",
             "AltAllele": "A", "Gene": "TP53", "Disease": "", "Network Definition": "p53"},
            {"Var_ID": "rs3", "Chr": "1", "Start": "10", "RefAllele": "A", "AltAllele": "AGG"},
            {"Var_ID": "rs4", "Chr": "1", "Start": "10", "RefAllele": "AC", "AltAllele": "GT",
             "Gene": '{"a": "X1; x", "b": "Y2"}', "Disease": '{broken'}]


def test_parsing_cases():
    """tests/test_traces.py's TestParsing on the port."""
    assert TT.gene_names(VARIANT) == "KRAS"
    assert TT.disease_name(VARIANT) == "Pancreatic cancer"
    assert TT.gene_names({"Gene": "TP53"}) == "TP53"
    assert TT.disease_name({}) == "Unknown"
    assert TT.hgvs_g("12", 25245350, "C", "T") == "chr12:g.25245350C>T"
    assert TT.hgvs_g("chrX", 5, "AT", "A") == "chrX:g.6del"
    assert TT.hgvs_g("1", 10, "ATT", "A") == "chr1:g.11_12del"
    assert TT.hgvs_g("1", 10, "A", "AGG") == "chr1:g.10_11insGG"
    assert TT.hgvs_g("1", 10, "AC", "GT") == "chr1:g.10_11delinsGT"


def test_tsv_and_deterministic_functions_match_jax(tmp_path):
    """The TSV loader (malformed rows skipped), the field helpers, the
    prompts, the template analyses (with and without a known answer), the
    items and the combined file equal JAX's on the same rows."""
    p = tmp_path / "v.tsv"
    cols = list(VARIANT)
    lines = ["\t".join(cols)] + ["\t".join(v.get(c, "") for c in cols) for v in VARIANTS]
    p.write_text("\n".join(lines[:2] + ["broken line without tabs"] + lines[2:]) + "\n")
    rows = TT.load_variant_tsv(str(p))
    assert rows == JT.load_variant_tsv(str(p)) and len(rows) == len(VARIANTS)
    for v in VARIANTS + rows:
        for fn in ("gene_names", "disease_name"):
            assert getattr(TT, fn)(v) == getattr(JT, fn)(v)
        for ans in ("", "benign"):
            assert TT.build_analysis_prompt(v, ans) == JT.build_analysis_prompt(v, ans)
            assert TT.template_analysis(v, ans) == JT.template_analysis(v, ans)
    a = TT.template_analysis(VARIANT)
    assert set(a) == {"raw_data", "question", "answer", "reasoning", "backend"}
    assert 8 <= len(a["reasoning"]["reasoning_steps"]) <= 12
    assert TT.template_analysis(VARIANT, known_answer="benign")["answer"] == "benign"
    answers = ["x", "y", "", "z"]
    out = TT.generate_analyses(VARIANTS, known_answers=answers)
    assert out == JT.generate_analyses(VARIANTS, known_answers=answers)
    assert [x["answer"] for x in out][:2] == ["x", "y"]
    assert all(x["backend"] == "template" for x in out)
    assert [TT.analysis_to_item(x) for x in out] == [JT.analysis_to_item(x) for x in out]
    TT.combine_analyses(out, str(tmp_path / "t.json"))
    JT.combine_analyses(out, str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    with pytest.raises(ValueError):
        TT.generate_analyses(VARIANTS, backend="api")


@pytest.mark.parametrize("text", [
    json.dumps({"question": "q?", "answer": "a.", "reasoning_steps": ["s1", "s2"]}),
    "Here is the analysis:\n```json\n" + json.dumps(
        {"question": "q", "answer": "a", "reasoning_steps": ["s"], "hgvs": "h",
         "labels": {"genes": ["G"]}}) + "\n```\nDone.",
    json.dumps({"question": "q", "answer": "a", "reasoning": {"reasoning_steps": ["r"]}}),
    "no json here", '{"answer": "a"}',
    '{"question": "q", "answer": "a", "reasoning_steps": []}', "{not json}", "[1, 2]"])
def test_json_parsing_matches_jax(text):
    """`parse_analysis_json` on replies that parse (clean, fenced with
    prose, nested reasoning) and on those that must not (no object,
    missing fields, empty steps, bad JSON): the port's result equals
    JAX's."""
    got = TT.parse_analysis_json(text, VARIANT)
    assert got == JT.parse_analysis_json(text, VARIANT)
    if got is not None:
        assert got["backend"] == "engine" and got["reasoning"]["reasoning_steps"]


def test_guided_regex_matches_jax_and_the_skeleton():
    rx = TT.guided_regex_for_analysis()
    assert rx == JT.guided_regex_for_analysis()
    assert TT.guided_regex_for_analysis(3) == JT.guided_regex_for_analysis(3)
    assert re.fullmatch(rx, '{"question": "q", "answer": "a", "reasoning_steps": ["s1", "s2"]}')


def engines():
    """(JAX engine, params, processor), (port engine, model, processor) on
    the same tiny weights."""
    jtok, ttok = JByte(), ByteTextTokenizer()
    jcfg = JC.FusionConfig.tiny(text_vocab=jtok.vocab_size, dna_pad_token_id=jtok.dna_pad_id)
    tcfg = TC.FusionConfig.tiny(text_vocab=ttok.vocab_size, dna_pad_token_id=ttok.dna_pad_id)
    params = j_init(jax.random.PRNGKey(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return ((JEngine(jcfg, eos_token_id=jtok.eos_token_id), params, JProc(jtok, JKmer())),
            (GenerationEngine(tcfg, eos_token_id=ttok.eos_token_id, device="cpu"), model,
             BioProcessor(ttok, KmerTokenizer())))


def test_engine_backend_greedy_replies_match_jax_and_fall_back(monkeypatch):
    """tests/test_traces.py's engine case on both packages with greedy
    decoding (temperature 0): every prompt's reply text equals the JAX
    engine's on the same weights, an untrained model's reply does not
    parse and takes the template's analysis ("template-fallback", never
    silent) on both sides, equal analyses."""
    (je, jp, jproc), (te, tm, tproc) = engines()
    seen = {"jax": [], "port": []}
    for mod, key in ((JT, "jax"), (TT, "port")):
        real = mod.parse_analysis_json

        def recording(text, variant, real=real, key=key):
            seen[key].append(text)
            return real(text, variant)
        monkeypatch.setattr(mod, "parse_analysis_json", recording)
    greedy = dict(sampling=TC.SamplingConfig(temperature=0.0), max_new_tokens=8, batch_size=2)
    got = TT.generate_analyses(VARIANTS[:3], backend="engine", engine=te, model=tm,
                               processor=tproc, **greedy)
    want = JT.generate_analyses(VARIANTS[:3], backend="engine", engine=je, params=jp,
                                processor=jproc, **{**greedy, "sampling": JC.SamplingConfig(
                                    temperature=0.0)})
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 3
    assert got == want
    assert all(a["backend"] == "template-fallback" for a in got)
    assert all(8 <= len(a["reasoning"]["reasoning_steps"]) <= 12 for a in got)


def test_engine_backend_keeps_a_reply_that_parses(monkeypatch):
    """A reply holding the analysis JSON is kept (backend "engine"), one
    that does not falls back, row by row."""
    (_, _, _), (te, tm, tproc) = engines()
    good = json.dumps({"question": "q", "answer": "a", "reasoning_steps": ["s1", "s2"]})
    tok = tproc.text_tokenizer

    def scripted(model, ids, *a, **kw):
        rows = [tok.encode(good), tok.encode("garbage")]
        width = max(map(len, rows))
        out = np.zeros((2, width), np.int64)
        mask = np.zeros((2, width), np.int32)
        for i, r in enumerate(rows):
            out[i, :len(r)], mask[i, :len(r)] = r, 1
        return out, mask
    monkeypatch.setattr(te, "generate", scripted)
    got = TT.generate_analyses(VARIANTS[:2], backend="engine", engine=te, model=tm,
                               processor=tproc, batch_size=2)
    assert [a["backend"] for a in got] == ["engine", "template-fallback"]
    assert got[0]["reasoning"]["reasoning_steps"] == ["s1", "s2"]
    with pytest.raises(ValueError, match="needs engine"):
        TT.generate_analyses(VARIANTS[:1], backend="engine")


def write_tsv(path):
    cols = list(VARIANT) + ["answer"]
    lines = ["\t".join(cols)] + ["\t".join([*(VARIANT.get(c, "") for c in cols[:-1]), f"ans{i}"])
                                 for i in range(3)]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_make_traces_cli_matches_jax(tmp_path):
    """`make_traces` with the template backend: the analyses and items
    files equal the JAX CLI's byte for byte (with `--answer_col` and
    `--num`); with `--backend engine --device cpu` at the tiny presets it
    runs the port's engine (int8 storage, guided JSON) and writes an
    analysis per row, each marked with the path that made it."""
    tsv = write_tsv(tmp_path / "v.tsv")
    for mod, tag in ((TMT, "t"), (JMT, "j")):
        mod.main(["--tsv", tsv, "--out", str(tmp_path / f"{tag}.json"), "--items_out",
                  str(tmp_path / f"{tag}.jsonl"), "--answer_col", "answer", "--num", "2"])
    for ext in ("json", "jsonl"):
        assert (tmp_path / f"t.{ext}").read_text() == (tmp_path / f"j.{ext}").read_text()
    out = TMT.main(["--tsv", tsv, "--out", str(tmp_path / "e.json"), "--backend", "engine",
                    "--decoder", "tiny", "--encoder", "tiny", "--device", "cpu",
                    "--max_new_tokens", "8", "--batch_size", "2", "--guided_json"])
    assert len(out) == 3 and {a["backend"] for a in out} <= {"engine", "template-fallback"}
    assert json.loads((tmp_path / "e.json").read_text()) == out
