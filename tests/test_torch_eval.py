"""The port's generative evaluation (train/eval.py) against the JAX
package's: `evaluate_generative` greedy through the port's engine, its
scores, rows and CSV; `teacher_forced_probe`; `multilabel_substring_accuracy`;
and the `train_sft` flags that drive them (--eval_every with --keep_top_k
and --probe_markers / --stop_probe_acc, --sample_every, --test_generative,
--profile_dir).

Tiny configs in fp32 on the CPU, the same weights in both packages
(`from_jax_params`); JAX calls jitted and cached.
"""

import csv
import dataclasses
import functools
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from bioreason_tpu import config as JC
from bioreason_tpu.data import kegg as JK
from bioreason_tpu.data.nt_tokenizer import KmerTokenizer as JKmer
from bioreason_tpu.data.processor import BioProcessor as JProc
from bioreason_tpu.data.text_tokenizer import ByteTextTokenizer as JByte
from bioreason_tpu.generate.engine import GenerationEngine as JEngine
from bioreason_tpu.models.fusion import fusion_forward as j_forward
from bioreason_tpu.models.fusion import init_fusion as j_init
from bioreason_tpu.train import eval as JE
from bioreason_tpu_torch import config as TC
from bioreason_tpu_torch.data import BioProcessor, ByteTextTokenizer, KmerTokenizer
from bioreason_tpu_torch.generate.engine import GenerationEngine
from bioreason_tpu_torch.train import eval as TE
from bioreason_tpu_torch.weights import from_jax_params

# one intra-op thread: the tensors here are tiny, and pytest-xdist runs
# several workers on the host's cores, which torch's default of a thread
# per core oversubscribes many times over
torch.set_num_threads(1)

JTOK = JByte()
PROC = BioProcessor(ByteTextTokenizer(), KmerTokenizer())
JPROC = JProc(JTOK, JKmer())
MARKERS = {"answer": "Answer:", "think": "<think>"}


def examples():
    """Seven KEGG SFT examples whose truths are 'e', 'a' (the labels) or a
    string no generation holds; one has a ';' tail."""
    exs = [JK.format_kegg_for_dna_llm(x) for x in JK.synthetic_kegg_items(7, seq_len=40, seed=4)]
    for i, ex in enumerate(exs):
        ex["answer"] = ("e", "a; tail", "zz-other")[i % 3]
    return exs


@functools.lru_cache(maxsize=None)
def setup():
    jcfg = JC.FusionConfig.tiny(text_vocab=JTOK.vocab_size, dna_pad_token_id=JTOK.dna_pad_id)
    tcfg = TC.FusionConfig.tiny(text_vocab=JTOK.vocab_size, dna_pad_token_id=JTOK.dna_pad_id)
    params = jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(11), jcfg)
    return jcfg, tcfg, params


@functools.lru_cache(maxsize=None)
def jax_eval(csv_path):
    jcfg, _, params = setup()
    return JE.evaluate_generative(JEngine(jcfg, eos_token_id=JTOK.eos_token_id), params, JPROC,
                                  examples(), labels=("a", "e"), max_new_tokens=16,
                                  batch_size=3, greedy=True, csv_path=csv_path,
                                  max_length_dna=64)


def test_evaluate_generative_greedy_matches_jax(tmp_path_factory):
    """Greedy generation in batches of 3 (a short last batch): every score,
    count and row of the JAX EvalResult, exactly, and the same CSV."""
    root = tmp_path_factory.mktemp("eval")
    want = jax_eval(str(root / "jax.csv"))
    _, tcfg, params = setup()
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    engine = GenerationEngine(tcfg, eos_token_id=JTOK.eos_token_id, device="cpu")
    got = TE.evaluate_generative(engine, model, PROC, examples(), labels=("a", "e"),
                                 max_new_tokens=16, batch_size=3, greedy=True,
                                 csv_path=str(root / "port.csv"), max_length_dna=64)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)     # two classes
    assert got.total == 7 and {g["prediction_category"] for g in got.generations} >= {"OTHER"}
    with open(root / "port.csv") as a, open(root / "jax.csv") as b:
        assert list(csv.reader(a)) == list(csv.reader(b))
    assert TE.multilabel_substring_accuracy(got.generations) == \
        JE.multilabel_substring_accuracy(want.generations)
    assert TE.multilabel_substring_accuracy([]) == 0.0


def test_scores_follow_the_reference_scheme():
    """TP / FN / TN / FP / OTHER, the ';' cut and the max(.., 1) guards, on
    a stub engine whose completions are fixed strings."""
    class Stub:
        def __init__(self, texts):
            self.texts = texts

        def generate(self, model, input_ids, *a, **kw):
            b = input_ids.shape[0]
            rows = [list(self.texts.pop(0).encode()) for _ in range(b)]
            width = max(len(r) for r in rows)
            ids = np.zeros((b, width), np.int64)
            mask = np.zeros((b, width), np.int64)
            for i, r in enumerate(rows):
                ids[i, :len(r)], mask[i, :len(r)] = r, 1
            return ids, mask
    exs = examples()[:6]                  # truths e, a, other, e, a, other
    texts = ["the e", "no", "zz-other", "x", "an a", "y"]
    res = TE.evaluate_generative(Stub(list(texts)), None, PROC, exs, labels=("a", "e"),
                                 batch_size=4, max_length_dna=64)
    cats = [g["prediction_category"] for g in res.generations]
    assert cats == ["TP", "FP", "OTHER", "FN", "TN", "OTHER"]
    assert (res.true_positives, res.false_positives, res.true_negatives,
            res.false_negatives, res.total) == (1, 1, 1, 1, 6)
    assert res.accuracy == pytest.approx(2 / 6) and res.f1 == pytest.approx(0.5)
    assert res.generations[1]["ground_truth"] == "a"


@functools.lru_cache(maxsize=None)
def jax_probe():
    jcfg, _, params = setup()
    fwd = jax.jit(lambda p, ids, am, dids, dam: j_forward(p, jcfg, ids, am, dids, dam)[0])
    return JE.teacher_forced_probe(params, jcfg, JPROC, examples(), markers=MARKERS,
                                   batch_size=3, max_length_dna=64, forward_fn=fwd)


def test_teacher_forced_probe_matches_jax():
    _, tcfg, params = setup()
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    got = TE.teacher_forced_probe(model, tcfg, PROC, examples(), markers=MARKERS,
                                  batch_size=3, max_length_dna=64)
    assert got == jax_probe()
    assert set(got) == {"answer_acc", "think_acc", "span_acc"}


TINY = ["--decoder", "tiny", "--encoder", "tiny", "--device", "cpu", "--n_synthetic", "24",
        "--batch_size", "2", "--max_length_dna", "64"]


def test_train_sft_eval_flags(tmp_path):
    """--eval_every with --keep_top_k and --probe_markers, --sample_every,
    --test_generative and --profile_dir on the tiny presets: val loss and
    probe accuracies in the history, at most k best checkpoints kept, a
    sampled generation, the test split scored into the CSV, a trace."""
    from bioreason_tpu_torch.cli import train_sft
    ck = tmp_path / "ck"
    trainer = train_sft.main(TINY + [
        "--max_steps", "6", "--eval_every", "2", "--keep_top_k", "2", "--sample_every", "3",
        "--probe_markers", json.dumps(MARKERS), "--probe_n", "2", "--test_generative",
        "--max_new_tokens", "6", "--profile_dir", str(tmp_path / "prof"),
        "--checkpoint_dir", str(ck), "--learning_rate", "1e-2"])
    hist = trainer.history
    assert len(hist) == 6 and all(math.isfinite(m["loss"]) for m in hist)
    assert [("val_loss" in m) for m in hist] == [False, True] * 3
    assert {"probe_answer_acc", "probe_think_acc", "probe_span_acc"} <= set(hist[1])
    assert isinstance(hist[2]["sample"], str) and "sample" not in hist[1]
    best = sorted(os.listdir(ck / "best"))
    assert best[-1] == "index.json" and 1 <= len(best) - 1 <= 2
    res = trainer.test_result
    assert res.total == 3 and len(res.generations) == 3      # 10% of 24 items
    with open(ck / "test_generations.csv") as f:
        header = next(csv.reader(f))
    assert header == list(res.generations[0])
    assert (tmp_path / "prof" / "trace.json").exists()
    assert (ck / "sft_final" / "state.pt").exists()


def test_stop_probe_acc_stops_training(tmp_path, monkeypatch):
    """Once every marker's probe accuracy reaches --stop_probe_acc, the run
    stops at that evaluation (the probe stubbed to a perfect score)."""
    from bioreason_tpu_torch.cli import train_sft
    monkeypatch.setattr(TE, "teacher_forced_probe",
                        lambda *a, **kw: {"answer_acc": 1.0, "span_acc": 0.0})
    trainer = train_sft.main(TINY + ["--max_steps", "6", "--eval_every", "2",
                                     "--probe_markers", json.dumps({"answer": "Answer:"}),
                                     "--stop_probe_acc", "0.95",
                                     "--checkpoint_dir", str(tmp_path)])
    assert len(trainer.history) == 2 and trainer.history[-1]["probe_answer_acc"] == 1.0
    assert (tmp_path / "sft_final" / "state.pt").exists()


@pytest.mark.parametrize("argv", [["--keep_top_k", "2"], ["--hf_llm_dir", "x"],
                                  ["--hf_dna_dir", "x"]])
def test_train_sft_refuses_incomplete_flag_sets(argv):
    from bioreason_tpu_torch.cli import train_sft
    with pytest.raises(SystemExit):
        train_sft.parse_args(TINY + argv)
