"""The port's DNA-only classifier (models/classifier.py, train/classifier.py,
data/collate.classifier_collate, cli/train_dna_only.py) against the JAX
package.

Tiny configs in fp32 on the CPU, weights drawn once by the JAX package and
carried over by `from_jax_params` (a classifier tree gives a
`DnaClassifier`). The pool and the forward at 1e-5, the collate and the
metrics equal, two trainer steps (frozen, and finetuned with the encoder's
updates scaled by 0.1) in loss, predictions and parameters at 1e-5 with
Adam eps 1e-3 on both sides (ROADMAP 3, note 7), and the CLI's
`dna_only_final` rebuilt to the same logits. JAX references are jitted
once and cached."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioreason_tpu import config as JC
from bioreason_tpu.data.collate import classifier_collate as j_collate
from bioreason_tpu.data.kegg import synthetic_kegg_items
from bioreason_tpu.data.nt_tokenizer import KmerTokenizer as JKmer
from bioreason_tpu.models import classifier as JM
from bioreason_tpu.parallel import make_mesh
from bioreason_tpu.train.classifier import ClassifierTrainer as JTrainer
from bioreason_tpu.train.classifier import multiclass_prf as j_prf
from bioreason_tpu_torch import config as TC
from bioreason_tpu_torch.data.collate import classifier_collate as t_collate
from bioreason_tpu_torch.data.nt_tokenizer import KmerTokenizer as TKmer
from bioreason_tpu_torch.models import classifier as TM
from bioreason_tpu_torch.train.checkpoint import load_classifier
from bioreason_tpu_torch.train.classifier import ClassifierTrainer as TTrainer
from bioreason_tpu_torch.train.classifier import multiclass_prf as t_prf
from bioreason_tpu_torch.train.optim import AdamW
from bioreason_tpu_torch.weights import from_jax_params

# one intra-op thread: the tensors here are tiny, and pytest-xdist runs
# several workers on the host's cores, which torch's default of a thread
# per core oversubscribes many times over
torch.set_num_threads(1)

CLASSES = 4
ITEMS = synthetic_kegg_items(8, seq_len=60, seed=1)
LABELS = sorted({it["answer"] for it in ITEMS})[:CLASSES]
LABEL2ID = {lab: i for i, lab in enumerate(LABELS)}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def setup():
    jcfg, tcfg = JC.EncoderConfig.tiny(), TC.EncoderConfig.tiny()
    tree = np_tree(jax.jit(JM.init_classifier, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jcfg, CLASSES))
    return jcfg, tcfg, tree


def batch(bucket=32, seed=0):
    """4 items with their labels remapped onto CLASSES classes; the
    variants cut short so both sides carry right pads."""
    rng = np.random.default_rng(seed)
    items = []
    for i, it in enumerate(ITEMS[:4]):
        items.append({**it, "variant_sequence": it["variant_sequence"][:20 + 9 * i],
                      "answer": LABELS[int(rng.integers(CLASSES))]})
    return items, j_collate(items, JKmer(), LABEL2ID, max_length=40, bucket=bucket)


def t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("bucket", [None, 16])
def test_classifier_collate_equal(bucket):
    items, want = batch(bucket)
    got = t_collate(items, TKmer(), LABEL2ID, max_length=40, bucket=bucket)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert want["alt_attention_mask"].sum(-1).min() < want["alt_ids"].shape[1]   # right pads


def test_multiclass_prf_equal():
    rng = np.random.default_rng(3)
    preds, labels = rng.integers(0, 5, 40), rng.integers(0, 5, 40)
    assert t_prf(preds, labels, 5) == j_prf(preds, labels, 5)
    assert t_prf(preds[:0], labels[:0], 5) == j_prf(preds[:0], labels[:0], 5)


def test_attention_pool_and_forward_match_jax():
    jcfg, tcfg, tree = setup()
    model = from_jax_params(tree, tcfg, device="cpu")
    assert isinstance(model, TM.DnaClassifier)
    _, b = batch()
    rng = np.random.default_rng(4)
    h = rng.standard_normal((4, 12, jcfg.hidden_size)).astype(np.float32)
    mask = np.ones((4, 12), np.int32)
    mask[1, 7:], mask[3, 2:] = 0, 0
    want = jax.jit(JM.attention_pool)(tree["pooler"], h, mask)
    with torch.no_grad():
        got = TM.attention_pool(model.pooler, t(h), t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    keys = ("ref_ids", "alt_ids", "ref_attention_mask", "alt_attention_mask")
    want = jax.jit(JM.classifier_forward, static_argnums=1)(tree, jcfg, *(b[k] for k in keys))
    with torch.no_grad():
        got = TM.classifier_forward(model, tcfg, *(t(b[k]) for k in keys))
    assert got.dtype == torch.float32 and got.shape == (4, CLASSES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


OPTIM = dict(learning_rate=1e-3, total_steps=20, warmup_ratio=0.0, eps=1e-3)


@functools.lru_cache(maxsize=None)
def jax_run(finetune):
    """Two JAX ClassifierTrainer steps on two batches: metrics and params."""
    jcfg, _, tree = setup()
    trainer = JTrainer(jcfg, CLASSES, optim=JC.OptimConfig(**OPTIM),
                       train_just_classifier=not finetune, encoder_lr_scale=0.1,
                       mesh=make_mesh(JC.MeshConfig(data=1), devices=jax.devices()[:1]),
                       params=jax.tree.map(jnp.asarray, tree))
    metrics = [trainer.train_step(batch(seed=s)[1]) for s in (0, 1)]
    return metrics, np_tree(trainer.params), trainer.eval_step(batch(seed=2)[1])


@pytest.mark.parametrize("finetune", [False, True])
def test_two_trainer_steps_match_jax(finetune):
    """Loss, predictions' metrics and every parameter after two steps; with
    finetune the encoder trains with its updates scaled by 0.1 after the
    whole AdamW update (optax.chain(adamw, masked(scale(0.1))))."""
    _, tcfg, tree = setup()
    trainer = TTrainer(tcfg, CLASSES, optim=TC.OptimConfig(**OPTIM),
                       train_just_classifier=not finetune, encoder_lr_scale=0.1,
                       model=from_jax_params(tree, tcfg, device="cpu"), device="cpu")
    assert any(n.startswith("encoder") for n in trainer.names) == finetune
    metrics = [trainer.train_step(batch(seed=s)[1]) for s in (0, 1)]
    jmetrics, jparams, jeval = jax_run(finetune)
    for got, want in zip(metrics + [trainer.eval_step(batch(seed=2)[1])], jmetrics + [jeval]):
        assert got["loss"] == pytest.approx(want["loss"], abs=1e-5)
        for k in ("accuracy", "precision", "recall", "f1"):
            assert got[k] == want[k], k
    ref = dict(from_jax_params(jparams, tcfg, device="cpu").named_parameters())
    init = dict(from_jax_params(tree, tcfg, device="cpu").named_parameters())
    moved = 0
    for name, p in trainer.model.named_parameters():
        np.testing.assert_allclose(p.detach().float().numpy(), ref[name].detach().numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)
        moved += name.startswith("encoder") and not torch.equal(p.detach().float(), init[name])
    assert (moved > 0) == finetune


def test_scaled_update_equals_a_scaled_learning_rate():
    """`lr_scales` multiplies the whole AdamW update after the learning
    rate, weight decay included; with decoupled decay applied as lr*wd*p
    that equals the same optimizer at lr x scale (the optax chain the JAX
    classifier trainer builds for its encoder leaves)."""
    rng = np.random.default_rng(5)
    p0 = rng.standard_normal((6, 5)).astype(np.float32)
    grads = [rng.standard_normal((6, 5)).astype(np.float32) * 0.01 for _ in range(3)]
    cfg = TC.OptimConfig(learning_rate=1e-2, total_steps=10, warmup_ratio=0.0, eps=1e-3,
                         weight_decay=0.1)
    a, b = torch.nn.Parameter(t(p0).clone()), torch.nn.Parameter(t(p0).clone())
    opt_a = AdamW([a], cfg, lr_scales=[0.1])
    opt_b = AdamW([b], dataclasses.replace(cfg, learning_rate=1e-3))
    for g in grads:
        opt_a.step([t(g)])
        opt_b.step([t(g)])
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-7, rtol=0)
    assert not np.allclose(a.detach().numpy(), p0)


def test_cli_writes_a_dna_only_final_the_loader_rebuilds(tmp_path):
    """train_dna_only on synthetic items: the checkpoint rebuilds to the
    trained model's logits; another preset, dtype or a non-classifier
    checkpoint is refused."""
    from bioreason_tpu_torch.cli import train_dna_only
    trainer = train_dna_only.main([
        "--encoder", "tiny", "--device", "cpu", "--batch_size", "4", "--max_length_dna", "64",
        "--max_steps", "2", "--n_synthetic", "16", "--checkpoint_dir", str(tmp_path),
        "--log_dir", str(tmp_path / "logs")])
    assert trainer.opt.cfg.learning_rate == 2e-5              # the JAX CLI's lr
    path = str(tmp_path / "dna_only_final")
    cfg = TC.EncoderConfig.tiny()
    model, labels = load_classifier(path, cfg, encoder="tiny", device="cpu")
    assert len(labels) == trainer.num_classes
    _, b = batch()
    keys = ("ref_ids", "alt_ids", "ref_attention_mask", "alt_attention_mask")
    with torch.no_grad():
        want = TM.classifier_forward(trainer.model, cfg, *(t(b[k]) for k in keys))
        got = TM.classifier_forward(model, cfg, *(t(b[k]) for k in keys))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError, match="encoder"):
        load_classifier(path, cfg, encoder="nt-500m", device="cpu")
    with pytest.raises(ValueError, match="trained in"):
        load_classifier(path, dataclasses.replace(cfg, dtype="bfloat16"), device="cpu")
    with pytest.raises(NotImplementedError):
        train_dna_only.main(["--encoder", "tiny", "--device", "cpu", "--wandb"])
