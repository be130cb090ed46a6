"""The training-loop pieces of the port against the JAX package: the
params-only checkpoint and `load_metadata`, `AsyncSaver`, `remat_policy=
"dots"` and the processor's `decode` / `batch_decode` / `asdict`.

Tiny configs in fp32 on the CPU; the JAX trainer runs on one CPU device,
compiled whole with `jax.jit`, on weights carried over by `from_jax_params`.
"""

import dataclasses
import functools
import math
import os

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bioreason_tpu import config as JC
from bioreason_tpu.data.nt_tokenizer import KmerTokenizer as JKmer
from bioreason_tpu.data.processor import BioProcessor as JProc
from bioreason_tpu.data.text_tokenizer import ByteTextTokenizer as JByte
from bioreason_tpu.parallel import make_mesh
from bioreason_tpu.train.sft import SFTTrainer as JTrainer
from bioreason_tpu_torch import config as TC
from bioreason_tpu_torch.data import BioProcessor, ByteTextTokenizer, KmerTokenizer
from bioreason_tpu_torch.data import collate as TD
from bioreason_tpu_torch.data import kegg as TK
from bioreason_tpu_torch.train import checkpoint as TCk
from bioreason_tpu_torch.train.sft import SFTTrainer
from bioreason_tpu_torch.weights import from_jax_params

# one intra-op thread: the tensors here are tiny, and pytest-xdist runs
# several workers on the host's cores, which torch's default of a thread
# per core oversubscribes many times over
torch.set_num_threads(1)

TOK = ByteTextTokenizer()
PROC = BioProcessor(TOK, KmerTokenizer())


def fusion_cfgs(**dec_kw):
    """JAX and port tiny configs, decoder head dim 64 (one the kernel takes)."""
    dec_kw = {"head_dim": 64, **dec_kw}
    jcfg = JC.FusionConfig.tiny(text_vocab=TOK.vocab_size, dna_pad_token_id=TOK.dna_pad_id)
    tcfg = TC.FusionConfig.tiny(text_vocab=TOK.vocab_size, dna_pad_token_id=TOK.dna_pad_id)
    return (dataclasses.replace(jcfg, decoder=dataclasses.replace(jcfg.decoder, **dec_kw)),
            dataclasses.replace(tcfg, decoder=dataclasses.replace(tcfg.decoder, **dec_kw)))


def sft_cfg(C):
    return C.SFTConfig(batch_size=2, max_length_dna=64, bucket=None, frozen_dtype="",
                       optim=C.OptimConfig(learning_rate=1e-2, total_steps=20, warmup_ratio=0.0,
                                           eps=1e-3),
                       lora=C.LoRAConfig(r=4, alpha=8, dropout=0.0))


@functools.lru_cache(maxsize=None)
def batch(seed=10):
    exs = [TK.format_kegg_for_dna_llm(it) for it in TK.synthetic_kegg_items(2, 40, seed)]
    return TD.sft_collate(exs, PROC, 512, 64)


def tiny_trainer(**dec_kw):
    _, tcfg = fusion_cfgs(**dec_kw)
    return SFTTrainer(tcfg, sft_cfg(TC), device="cpu")


# -- checkpoints --------------------------------------------------------------------

def test_params_only_save_loads_for_eval_and_refuses_to_resume(tmp_path):
    """`save(params_only=True)` writes the trainable parameters without the
    optimizer state (JAX `save(..., params_only=True)`); `load_sft_model`
    rebuilds the model from it, `restore` refuses it, and `load_metadata`
    reads the step and the base without the tensors."""
    trainer = tiny_trainer()
    trainer.train_step(batch())
    full = trainer.save(str(tmp_path / "full"), {"decoder": "tiny", "encoder": "tiny"})
    lean = trainer.save(str(tmp_path / "lean"), {"decoder": "tiny", "encoder": "tiny"},
                        params_only=True)
    a, b = (TCk.load_checkpoint(os.path.dirname(p)) for p in (full, lean))
    assert "opt_state" in a and "opt_state" not in b
    assert sorted(a["trainable"]) == sorted(b["trainable"]) == sorted(trainer.names)
    assert all(torch.equal(a["trainable"][k], b["trainable"][k]) for k in a["trainable"])
    assert os.path.getsize(lean) < os.path.getsize(full)
    meta = TCk.load_metadata(str(tmp_path / "lean"))
    assert meta["step"] == 1 and meta["seed"] == 0 and meta["decoder"] == "tiny"
    with pytest.raises(ValueError, match="params_only"):
        tiny_trainer().restore(str(tmp_path / "lean"))
    model = TCk.load_sft_model(str(tmp_path / "lean"), trainer.fusion_cfg, 0, "tiny", "tiny",
                               device="cpu")
    got = dict(model.named_parameters())
    for name, p in trainer.trainable_state().items():
        assert torch.equal(got[name].detach(), p.detach()), name


def test_async_saver_writes_what_a_blocking_save_writes(tmp_path):
    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(3, 4, generator=gen), "b": torch.randn(5, generator=gen)}
    opt = {"mu": [torch.randn(3, 4, generator=gen)], "nu": [torch.rand(5, generator=gen)],
           "count": 7}
    TCk.save_checkpoint(str(tmp_path / "sync"), params, opt, 3, {"x": 1})
    saver = TCk.AsyncSaver()
    saver.save(str(tmp_path / "async"), params, opt, 3, {"x": 1})
    saver.wait()
    a, b = (TCk.load_checkpoint(str(tmp_path / d)) for d in ("sync", "async"))
    assert sorted(a) == sorted(b) and a["step"] == b["step"] == 3
    assert a["metadata"] == b["metadata"] == {"x": 1}
    for k in params:
        assert torch.equal(a["trainable"][k], b["trainable"][k])
    for k in ("mu", "nu"):
        assert all(torch.equal(x, y) for x, y in zip(a["opt_state"][k], b["opt_state"][k]))
    assert a["opt_state"]["count"] == b["opt_state"]["count"] == 7
    assert not [f for f in os.listdir(tmp_path / "async") if f.endswith(".tmp")]


def test_async_save_holds_the_parameters_of_its_step(tmp_path):
    """`save(block=False)` snapshots the parameters and optimizer state
    before the next `opt.step()` changes them in place: the file holds the
    snapshot's values, not the stepped ones."""
    trainer = tiny_trainer()
    trainer.train_step(batch())
    before = {k: v.detach().clone() for k, v in trainer.trainable_state().items()}
    mu = [m.clone() for m in trainer.opt.mu]
    trainer.save(str(tmp_path / "s"), block=False)
    trainer.train_step(batch(11))                        # steps the parameters in place
    trainer.finish_saves()
    state = TCk.load_checkpoint(str(tmp_path / "s"))
    assert state["step"] == 1
    moved = 0
    for k, v in before.items():
        assert torch.equal(state["trainable"][k], v), k
        moved += not torch.equal(trainer.trainable_state()[k].detach(), v)
    assert moved > 0
    assert all(torch.equal(a, b) for a, b in zip(state["opt_state"]["mu"], mu))
    trainer.finish_saves()                               # nothing in flight: a no-op


def test_async_saver_reraises_a_failed_write(tmp_path):
    """A write that fails in the thread is raised at the next `wait` (and
    would be at the next `save`), as RuntimeError from the failure."""
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    saver = TCk.AsyncSaver()
    saver.save(str(blocker / "ck"), {"a": torch.ones(2)}, None, 0)
    with pytest.raises(RuntimeError, match="async checkpoint save failed") as err:
        saver.wait()
    assert isinstance(err.value.__cause__, OSError)
    saver.save(str(blocker / "ck"), {"a": torch.ones(2)}, None, 0)
    with pytest.raises(RuntimeError):
        saver.save(str(tmp_path / "ok"), {"a": torch.ones(2)}, None, 0)
    saver.save(str(tmp_path / "ok"), {"a": torch.ones(2)}, None, 0)
    saver.wait()
    assert "opt_state" not in TCk.load_checkpoint(str(tmp_path / "ok"))


# -- remat_policy="dots" ----------------------------------------------------------------

class CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.addmm)
        return func(*args, **(kwargs or {}))


@functools.lru_cache(maxsize=None)
def jax_dots_step():
    """The JAX SFTTrainer with remat 'dots' on the decoder: its initial
    parameters and its first step's metrics."""
    jcfg, _ = fusion_cfgs(remat=True, remat_policy="dots")
    jt = JTrainer(jcfg, sft_cfg(JC),
                  mesh=make_mesh(JC.MeshConfig(data=1), devices=jax.devices()[:1]))
    init = jax.tree.map(np.asarray, jt.params)
    return init, jt.train_step(batch())


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_remat_dots_matches_remat_off_and_the_jax_dots_step(impl):
    """One loss and its gradients with remat 'dots' equal remat off's
    bitwise (the plain attention routes; 'pallas' is the flash wrapper's
    plain forward and backward), the backward recomputes no dense product
    ('full' recomputes them), and a trainer step equals the JAX trainer's
    'dots' step on the same weights at 1e-5."""
    init, jm = jax_dots_step()
    grads, matmuls = {}, {}
    for policy in ("off", "full", "dots"):
        _, tcfg = fusion_cfgs(remat=policy != "off",
                              remat_policy="full" if policy == "off" else policy,
                              attention_impl=impl)
        trainer = SFTTrainer(tcfg, sft_cfg(TC), model=from_jax_params(init, tcfg, device="cpu"),
                             device="cpu")
        loss = trainer._loss(trainer._device_batch(batch()), train=True)
        with CountMatmuls() as count:
            grads[policy] = (loss, torch.autograd.grad(loss, trainer.params))
        matmuls[policy] = count.n
        if policy == "dots":
            m = trainer.train_step(batch())
            assert m["loss"] == pytest.approx(jm["loss"], rel=1e-5)
            assert m["grad_norm"] == pytest.approx(jm["grad_norm"], rel=1e-5)
    for policy in ("full", "dots"):
        assert torch.equal(grads[policy][0], grads["off"][0])
        assert all(torch.equal(a, b) for a, b in zip(grads[policy][1], grads["off"][1]))
    assert matmuls["dots"] == matmuls["off"] < matmuls["full"]


# -- the processor's decode and asdict ------------------------------------------------

def test_processor_decode_batch_decode_and_asdict_match_jax():
    jproc = JProc(JByte(), JKmer())
    text = ["<|im_start|>user\nwhich pathway? <|dna_pad|><|im_end|>", "a b c"]
    dna = [["ACGTACGTAAAC"], ["GGGTTTAAACCC"]]
    a = PROC(text=text, batch_dna_sequences=dna, max_length_text=64, max_length_dna=16)
    b = jproc(text=text, batch_dna_sequences=dna, max_length_text=64, max_length_dna=16)
    da, db = a.asdict(), b.asdict()
    assert list(da) == list(db)
    for k in da:
        np.testing.assert_array_equal(np.asarray(da[k]), np.asarray(db[k]), err_msg=k)
    rows = [list(r) for r in a.input_ids]
    for skip in (True, False):
        assert PROC.batch_decode(rows, skip_special_tokens=skip) == jproc.batch_decode(
            rows, skip_special_tokens=skip)
        assert PROC.decode(rows[0], skip_special_tokens=skip) == jproc.decode(
            rows[0], skip_special_tokens=skip)
    assert PROC.decode(TOK.encode("Answer: MAPK")) == "Answer: MAPK"


# -- --debug_nans in the DNA-only CLI ------------------------------------------------

def test_train_dna_only_debug_nans_runs_clean(tmp_path):
    """`train_dna_only --debug_nans` on a sound model raises nothing (every
    aten op's output read for NaN) and trains as without the flag."""
    from bioreason_tpu_torch.cli import train_dna_only
    argv = ["--encoder", "tiny", "--device", "cpu", "--batch_size", "4",
            "--max_length_dna", "64", "--max_steps", "1", "--n_synthetic", "16",
            "--checkpoint_dir", str(tmp_path / "ck"), "--log_dir", str(tmp_path / "l")]
    checked = train_dna_only.main(argv + ["--debug_nans"])
    plain = train_dna_only.main(argv)
    for (n, p), (_, q) in zip(checked.model.named_parameters(), plain.model.named_parameters()):
        assert torch.equal(p, q), n
    assert math.isfinite(float(next(checked.model.parameters()).sum()))
