"""The port's quality rehearsal against the JAX package: the `auto`
attention rule at NT-v2-50M's 32-wide heads, the rehearsal's corpus and
split, `train_sft --log_dir`'s rows, the best-k rule, and the two tools
(`tools/rehearsal.py`, `tools/diagnose_quality.py`) end to end at tiny.

Tiny configs in fp32 on the CPU. The JAX tool (tools/rehearsal.py, not a
package) is loaded from its file; the JAX CLI runs on one CPU device.
"""

import functools
import importlib.util
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from bioreason_tpu import config as JC
from bioreason_tpu.cli import common as JCommon
from bioreason_tpu_torch import config as TC
from bioreason_tpu_torch.cli import common as TCommon
from bioreason_tpu_torch.models.attention import attention, kernel_rule
from bioreason_tpu_torch.tools import rehearsal as TR
from bioreason_tpu_torch.weights import from_jax_params

# one intra-op thread: the tensors here are tiny, and pytest-xdist runs
# several workers on the host's cores, which torch's default of a thread
# per core oversubscribes many times over
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def jax_tool():
    """The JAX package's tools/rehearsal.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_rehearsal", os.path.join(REPO, "tools", "rehearsal.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one_device_mesh(spec="auto"):
    from bioreason_tpu.parallel import make_mesh
    return make_mesh(JC.MeshConfig(data=1), devices=jax.devices()[:1])


# -- the attention rule --------------------------------------------------------------

def jax_auto_route(tq, d):
    """The route the JAX `attention(impl="auto")` takes on the chip for a
    [1, tq, 2, d] query: its Pallas clause, with the platform test true."""
    import bioreason_tpu.models.attention as JA
    import bioreason_tpu.ops.flash_attention as JFA
    route = []
    q = np.zeros((1, tq, 2, d), np.float32)
    saved = JA._on_tpu, JA.xla_attention, JFA.flash_attention
    JA._on_tpu = lambda: True
    JA.xla_attention = lambda *a, **kw: route.append("xla")
    JFA.flash_attention = lambda *a, **kw: route.append("pallas")
    try:
        JA.attention(q, q, q, impl="auto")
    finally:
        JA._on_tpu, JA.xla_attention, JFA.flash_attention = saved
    return route[0]


def test_auto_rule_takes_the_kernel_only_where_its_contract_holds():
    """NT-v2-50M's heads are 32 wide: the old rule (any CUDA query of more
    than one row) sent them to the kernel, whose wrapper raises; the rule now
    takes the kernel only at a CUDA query of Tq > 1 with a head dim in
    HEAD_DIMS, as the JAX rule's head-dim clause does (D = 32 and Tq = 1 go
    to the plain path there too; JAX's Tq >= 128 floor aside)."""
    enc = TC.EncoderConfig.nt_v2_50m()
    d50 = enc.hidden_size // enc.num_heads
    assert d50 == 32

    def old_rule(device_type, tq):
        return device_type == "cuda" and tq > 1
    assert old_rule("cuda", 40)
    assert not kernel_rule("cuda", 40, d50)
    for d in (32, 64, 128):
        assert kernel_rule("cuda", 128, d) == (jax_auto_route(128, d) == "pallas")
    assert jax_auto_route(1, 64) == "xla" and not kernel_rule("cuda", 1, 64)
    assert not kernel_rule("cpu", 128, 64)
    q = torch.zeros((1, 8, 2, d50), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 32"):
        attention(q, q, q, impl="pallas")              # the kernel's wrapper refuses


# -- the corpus and its split ------------------------------------------------------

def test_write_corpus_files_and_split_match_jax(tmp_path):
    a, b = tmp_path / "port", tmp_path / "jax"
    assert TR.write_corpus(str(a), 24, 32, 7) == jax_tool().write_corpus(str(b), 24, 32, 7)
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and len(names) == 24
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n
    assert (TCommon.load_items("kegg", str(a), 0, 0, 7)
            == JCommon.load_items("kegg", str(a), 0, 0, 7))
    assert TR.load_curve(str(tmp_path), "val/loss") == jax_tool().load_curve(
        str(tmp_path), "val/loss") == []


# -- train_sft --log_dir against the JAX CLI -----------------------------------------

SFT_ARGV = ["--decoder", "tiny", "--encoder", "tiny", "--no_lora", "--dna_model_finetune",
            "--supervise_eos", "--dna_kmer", "1", "--truncate_dna_per_side", "0",
            "--max_length_dna", "40", "--batch_size", "4", "--seed", "7",
            "--learning_rate", "1e-3", "--max_steps", "2", "--eval_every", "1",
            "--probe_markers", TR.PROBE_MARKERS, "--probe_n", "4"]


def read_rows(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@functools.lru_cache(maxsize=None)
def jax_cli_run(root):
    """The JAX train_sft CLI on the rehearsal's corpus, one CPU device: its
    initial parameters (numpy) and its metrics rows."""
    import bioreason_tpu.cli.common as jcommon
    import bioreason_tpu.train.sft as JS
    from bioreason_tpu.cli import train_sft as jcli
    corpus = os.path.join(root, "corpus")
    jax_tool().write_corpus(corpus, 40, 32, 7)
    seen = {}
    real_init, real_mesh = JS.init_fusion, jcommon.build_mesh

    def init(rng, cfg):
        seen["params"] = jax.tree.map(np.asarray, real_init(rng, cfg))
        return seen["params"]
    JS.init_fusion, jcommon.build_mesh = init, one_device_mesh
    try:
        jcli.main(SFT_ARGV + ["--data_dir", corpus, "--checkpoint_dir", os.path.join(root, "jck"),
                              "--log_dir", os.path.join(root, "jlogs")])
    finally:
        JS.init_fusion, jcommon.build_mesh = real_init, real_mesh
    return seen["params"], read_rows(os.path.join(root, "jlogs"))


def test_train_sft_log_dir_rows_match_the_jax_cli(tmp_path_factory, monkeypatch):
    """Two full-finetune steps (the rehearsal's flags) from the JAX CLI's
    own initial weights: the same rows in the same order with the same keys
    (`train/<k>` every step, `val/loss`, `val/probe_<k>` every eval), the
    losses, grad norms, val losses and probe accuracies equal at 1e-4."""
    import bioreason_tpu_torch.train.sft as TS
    from bioreason_tpu_torch.cli import train_sft
    root = str(tmp_path_factory.mktemp("rows"))
    params, jrows = jax_cli_run(root)
    monkeypatch.setattr(TS, "init_fusion",
                        lambda cfg, seed=0, device=None: from_jax_params(params, cfg, device))
    logs = os.path.join(root, "tlogs")
    train_sft.main(SFT_ARGV + ["--data_dir", os.path.join(root, "corpus"), "--device", "cpu",
                               "--checkpoint_dir", os.path.join(root, "tck"),
                               "--log_dir", logs])
    trows = read_rows(logs)
    assert [sorted(r) for r in trows] == [sorted(r) for r in jrows]
    assert [r["step"] for r in trows] == [0, 1, 1, 1, 2, 2]
    for t, j in zip(trows, jrows):
        for k in t:
            if k in ("time", "train/step_time", "train/examples_per_sec"):
                continue
            assert t[k] == pytest.approx(j[k], rel=1e-4, abs=1e-6), (k, t, j)
    assert {"val/probe_base_acc", "val/probe_half_acc", "val/probe_answer_acc",
            "val/probe_span_acc"} <= set(trows[-1])


# -- best-k under the JAX rule ------------------------------------------------------

# val loss by training step: the rate limit keeps steps 1, 3, 5 and 7; the
# probe stops the run at step 8, whose save bypasses the limit
SCRIPT = {1: 1.0, 2: 0.9, 3: 0.7, 4: 0.72, 5: 0.5, 6: 0.45, 7: 0.3, 8: 0.31}
STOP_AT = 8
BEST_ARGV = ["--decoder", "tiny", "--encoder", "tiny", "--no_lora", "--n_synthetic", "40",
             "--max_length_dna", "64", "--batch_size", "2", "--seed", "3", "--max_steps", "12",
             "--eval_every", "1", "--keep_top_k", "2", "--stop_probe_acc", "0.95",
             "--probe_markers", json.dumps({"answer": "Answer:"}), "--probe_n", "2"]


def scripted_probe(step_of):
    def probe(*a, **kw):
        acc = 1.0 if step_of() >= STOP_AT else 0.5
        return {"answer_acc": acc, "span_acc": acc}
    return probe


class FakeJaxTrainer:
    """The JAX CLI's trainer, scripted: no model, the val losses of SCRIPT,
    saves recorded as (path, params_only)."""
    saves = []

    def __init__(self, *a, **kw):
        self.step, self.params = 0, {}

    def train_step(self, batch):
        self.step += 1
        return {"loss": 1.0, "grad_norm": 0.0, "lr": 0.0}

    def eval_step(self, batch):
        return SCRIPT[self.step]

    def save(self, path, params_only=False, **kw):
        os.makedirs(path, exist_ok=True)
        FakeJaxTrainer.saves.append((os.path.basename(path), params_only))

    def finish_saves(self):
        pass


def test_best_k_keeps_the_jax_rule_params_only_and_feeds_reason(tmp_path, monkeypatch):
    """A scripted val-loss sequence through both CLIs: the port keeps the
    checkpoints the JAX CLI keeps (rate limit, stop-step save, top 2), each
    written without optimizer state, and the best one loads through
    `reason --sft_checkpoint`."""
    import bioreason_tpu.cli.common as jcommon
    import bioreason_tpu.train.checkpoint as JCk
    import bioreason_tpu.train.eval as JE
    import bioreason_tpu.train.sft as JS
    import bioreason_tpu_torch.train.eval as TE
    import bioreason_tpu_torch.train.sft as TS
    from bioreason_tpu.cli import train_sft as jcli
    from bioreason_tpu_torch.cli import reason, train_sft
    from bioreason_tpu_torch.train.checkpoint import TopKKeeper, load_checkpoint

    jroot = tmp_path / "jax"
    FakeJaxTrainer.saves = []
    fake = {}
    monkeypatch.setattr(JS, "SFTTrainer",
                        lambda *a, **kw: fake.setdefault("t", FakeJaxTrainer()))
    monkeypatch.setattr(JE, "teacher_forced_probe", scripted_probe(lambda: fake["t"].step))
    monkeypatch.setattr(JCk, "save_checkpoint", lambda *a, **kw: None)
    monkeypatch.setattr(jcommon, "build_mesh", one_device_mesh)
    jcli.main(BEST_ARGV + ["--checkpoint_dir", str(jroot), "--log_dir", str(tmp_path / "jl")])
    jkept = [(v, s, os.path.basename(p)) for v, s, p in
             json.load(open(jroot / "best" / "index.json"))["kept"]]
    assert FakeJaxTrainer.saves == [(f"best-step{s}", True) for s in (1, 3, 5, 7, 8)]

    troot = tmp_path / "port"
    monkeypatch.setattr(TS.SFTTrainer, "eval_step", lambda self, batch: SCRIPT[self.step])
    trainer = {}
    monkeypatch.setattr(TE, "teacher_forced_probe",
                        scripted_probe(lambda: trainer["t"].step))
    real_init = TS.SFTTrainer.__init__

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        trainer["t"] = self
    monkeypatch.setattr(TS.SFTTrainer, "__init__", init)
    train_sft.main(BEST_ARGV + ["--device", "cpu", "--checkpoint_dir", str(troot)])
    assert trainer["t"].step == STOP_AT
    keeper = TopKKeeper(str(troot / "best"), k=2)
    tkept = [(v, s, os.path.basename(p)) for v, s, p in keeper._kept]
    assert tkept == jkept == [(0.3, 7, "best-step7"), (0.31, 8, "best-step8")]
    assert sorted(os.listdir(troot / "best")) == ["best-step7", "best-step8", "index.json"]
    for _, _, name in tkept:
        state = load_checkpoint(str(troot / "best" / name))
        assert "opt_state" not in state and state["trainable"]
    assert "opt_state" in load_checkpoint(str(troot / "sft_final"))
    grpo = reason.main(["--decoder", "tiny", "--encoder", "tiny", "--device", "cpu",
                        "--seed", "3", "--sft_checkpoint", keeper.best_path(),
                        "--n_synthetic", "40", "--max_length_dna", "64",
                        "--num_generations", "2", "--batch_size", "2", "--max_steps", "1",
                        "--max_completion_length", "4", "--checkpoint_dir",
                        str(tmp_path / "g"), "--log_dir", str(tmp_path / "gl")])
    assert grpo.step_count == 1


# -- the tools end to end ------------------------------------------------------------

def test_rehearsal_tiny_end_to_end_writes_the_jax_artifact_keys(tmp_path, monkeypatch):
    """`tools/rehearsal.py --scale tiny --device cpu`: both stages, both
    tests; the artifact holds the keys of the JAX run's committed
    artifacts/rehearsal_bench.json (read, never written) plus the card, and
    the curves the rehearsal reads from the two metrics files. It is written
    twice: once the SFT test is done (the GRPO fields None, so a run cut in
    GRPO keeps its SFT record) and at the end."""
    with open(os.path.join(REPO, "artifacts", "rehearsal_bench.json")) as f:
        ref = json.load(f)
    out = tmp_path / "art.json"
    written = []
    real_write = TR.write_record
    monkeypatch.setattr(TR, "write_record",
                        lambda rec, path: (written.append(json.loads(json.dumps(rec))),
                                           real_write(rec, path)))
    art = TR.main(["--scale", "tiny", "--device", "cpu", "--work_dir", str(tmp_path / "w"),
                   "--out", str(out)])
    assert json.loads(out.read_text()) == art
    first, last = written
    assert last == json.loads(json.dumps(art))
    assert first["test_accuracy_after_grpo"] is None and first["grpo"]["wall_s"] is None
    assert first["grpo"]["reward_curve"] == [] and first["accuracy_delta"] is None
    assert first["sft"] == last["sft"]
    assert first["test_accuracy_after_sft"] == last["test_accuracy_after_sft"]
    assert set(art) == set(ref) | {"card"} and art["card"] is None
    for key in ("corpus", "sft", "grpo"):
        assert set(art[key]) == set(ref[key]), key
    assert set(art["sft"]["probe_curves"]) == set(ref["sft"]["probe_curves"])
    assert art["platform"] == "cpu" and art["corpus"]["split"] == [51, 6, 7]
    assert len(art["sft"]["val_loss_curve"]) == 6 and len(art["grpo"]["reward_curve"]) == 2
    assert all(len(c) == 6 for c in art["sft"]["probe_curves"].values())
    assert 0.0 <= art["test_accuracy_after_sft"] <= 1.0
    assert 0.0 <= art["test_accuracy_after_grpo"] <= 1.0
    assert os.path.isfile(tmp_path / "w" / "generations_grpo.csv")
    assert os.path.dirname(TR.default_out("bench")) == os.path.join(
        REPO, "bioreason_tpu_torch", "artifacts")


def test_diagnose_quality_tiny_probes_train_and_held_out(tmp_path):
    from bioreason_tpu_torch.tools import diagnose_quality
    out = tmp_path / "d.json"
    res = diagnose_quality.main(["--preset", "tiny", "--device", "cpu", "--items", "16",
                                 "--holdout", "8", "--steps", "4", "--probe_every", "2",
                                 "--probe_n", "4", "--batch_size", "4", "--gen_eval_n", "4",
                                 "--out", str(out)])
    assert json.loads(out.read_text()) == res
    assert [h["step"] for h in res["history"]] == [2, 4]
    for h in res["history"]:
        assert math.isfinite(h["loss"])
        for split in ("train", "test"):
            assert set(h[split]) == {"base_acc", "half_acc", "answer_acc", "span_acc"}
    assert 0.0 <= res["generative_accuracy"] <= 1.0 and len(res["samples"]) == 4
