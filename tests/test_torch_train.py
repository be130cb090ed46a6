"""The port's SFT slice against the JAX package: optimizer, LoRA transforms,
data collation, `fusion_forward`'s losses and the `train_sft` CLI (the
whole `SFTTrainer` step: test_torch_train_steps.py, which shares the
helpers here).

Tiny configs in fp32 on the CPU; batches and parameters made once from a
seed and fed to both packages (parameters through `from_jax_params`). The
JAX calls are compiled whole with `jax.jit`, as the other port tests do.
"""

import copy
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bioreason_tpu import config as JC
from bioreason_tpu.data import collate as JD
from bioreason_tpu.data import kegg as JK
from bioreason_tpu.data import utils as JU
from bioreason_tpu.data.chat_template import apply_chat_template as j_apply_chat_template
from bioreason_tpu.data.nt_tokenizer import KmerTokenizer as JKmer
from bioreason_tpu.data.processor import BioProcessor as JProc
from bioreason_tpu.data.text_tokenizer import ByteTextTokenizer as JByte
from bioreason_tpu.models import fusion as JF
from bioreason_tpu.train import lora as JL
from bioreason_tpu.train.optim import make_optimizer
from bioreason_tpu_torch import config as TC
from bioreason_tpu_torch.data import BioProcessor, ByteTextTokenizer, KmerTokenizer
from bioreason_tpu_torch.data import collate as TD
from bioreason_tpu_torch.data import kegg as TK
from bioreason_tpu_torch.data import utils as TU
from bioreason_tpu_torch.data.chat_template import apply_chat_template
from bioreason_tpu_torch.models import fusion as TF
from bioreason_tpu_torch.ops.fused_ce import gather_label_positions
from bioreason_tpu_torch.train import lora as TL
from bioreason_tpu_torch.train import trainable as TT
from bioreason_tpu_torch.train.dataflow import batch_iterator, prefetch
from bioreason_tpu_torch.train.optim import AdamW, cosine_warmup_schedule
from bioreason_tpu_torch.weights import from_jax_params

# one intra-op thread: the tensors here are tiny, and pytest-xdist runs
# several workers on the host's cores, which torch's default of a thread
# per core oversubscribes many times over
torch.set_num_threads(1)

TOK = ByteTextTokenizer()
PROC = BioProcessor(TOK, KmerTokenizer())
JPROC = JProc(JByte(), JKmer())
LORA = dict(r=4, alpha=8, dropout=0.0)


def t(x):
    return torch.from_numpy(np.asarray(x))


# -- data ----------------------------------------------------------------------

def items(n, seed):
    return TK.synthetic_kegg_items(n, seq_len=40, seed=seed)


def test_kegg_formatting_and_chat_template_match():
    for it in items(3, 0):
        ex = TK.format_kegg_for_dna_llm(dict(it))
        assert ex == JK.format_kegg_for_dna_llm(dict(it))
        assert apply_chat_template(ex) == j_apply_chat_template(ex)
    raw = {"question": " q ", "answer": " Apoptosis ", "reasoning": {"reasoning_steps": ["a", "b"]},
           "reference_sequence": " acgt ", "variant_sequence": "acct"}
    assert TK.process_kegg_item(raw) == JK.process_kegg_item(raw)


def test_split_and_truncate_match():
    xs = list(range(37))
    assert TU.split_dataset(xs, seed=3) == JU.split_dataset(xs, seed=3)
    for per_side in (0, 4, 30):
        it = items(1, 1)[0]
        assert TU.truncate_dna(dict(it), per_side) == JU.truncate_dna(dict(it), per_side)


@pytest.mark.parametrize("bucket,supervise_eos", [(None, False), (64, True)])
def test_sft_collate_matches(bucket, supervise_eos):
    exs = [TK.format_kegg_for_dna_llm(it) for it in items(3, 2)]
    a = TD.sft_collate(exs, PROC, 512, 64, bucket=bucket, supervise_eos=supervise_eos,
                       return_answer=True)
    b = JD.sft_collate(exs, JPROC, 512, 64, bucket=bucket, supervise_eos=supervise_eos,
                       return_answer=True)
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]))
    assert (a["labels"] != -100).any()


def test_load_local_dataset_matches(tmp_path):
    from bioreason_tpu.data.loaders import load_local_dataset as jload
    from bioreason_tpu_torch.data.loaders import load_local_dataset as tload
    import json
    (tmp_path / "a_1.json").write_text(json.dumps(
        {"question": "q?", "answer": " MAPK ", "reasoning": {"reasoning_steps": ["x", "y"]},
         "reference_sequence": "acgt", "variant_sequence": "acct"}))
    (tmp_path / "b.jsonl").write_text("\n".join(json.dumps(
        {"question": f"q{i}", "answer": "p53", "reasoning": "r", "reference_sequence": "aa",
         "variant_sequence": "ag"}) for i in range(3)))
    assert tload(str(tmp_path)) == jload(str(tmp_path))
    assert len(tload(str(tmp_path))) == 4


def test_batch_iterator_and_prefetch():
    seen = list(prefetch(batch_iterator(list(range(10)), list, 3, seed=1, epochs=2)))
    assert len(seen) == 6 and all(len(b) == 3 for b in seen)
    for epoch in (seen[:3], seen[3:]):         # 9 distinct items, the 10th dropped
        assert len(set(sum(epoch, []))) == 9
    assert seen[:3] != seen[3:]
    tail = list(batch_iterator(list(range(5)), list, 3, shuffle=False, drop_last=False))
    assert tail == [[0, 1, 2], [3, 4, 3]]


# -- optimizer -----------------------------------------------------------------

@pytest.mark.parametrize("warmup_ratio", [0.1, 0.0])
def test_schedule_matches_optax(warmup_ratio):
    cfg = JC.OptimConfig(learning_rate=3e-3, total_steps=40, warmup_ratio=warmup_ratio)
    _, sched = make_optimizer(cfg)
    ours = cosine_warmup_schedule(TC.OptimConfig(**dataclasses.asdict(cfg)))
    # optax computes in fp32: 1e-6 of the peak
    for step in (0, 1, 3, 4, 5, 20, 39, 40, 55):
        assert ours(step) == pytest.approx(float(sched(step)), rel=0, abs=3e-9)
    if warmup_ratio:
        assert ours(0) == 0.0


def test_adamw_matches_optax_three_steps():
    """Clip (the first step's norm is above the limit), weight decay, lr 0 at
    step 0 (warmup), and a NaN gradient skipped without advancing the
    count; atol 1e-6 on parameters of size ~1 (fp32 on both sides)."""
    cfg = JC.OptimConfig(learning_rate=1e-2, weight_decay=0.1, total_steps=10,
                         warmup_ratio=0.2, grad_clip=1.0, skip_nonfinite_after=2)
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (5,), (2, 2, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * 2.0 for s in shapes] for _ in range(4)]
    grads[2][1][3] = np.nan
    tx, _ = make_optimizer(cfg)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(t(p.copy())) for p in params]
    opt = AdamW(tp, TC.OptimConfig(**dataclasses.asdict(cfg)))
    for i, g in enumerate(grads):
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        norm = opt.step([t(x) for x in g])
        if i == 0:
            assert norm > cfg.grad_clip
            # lr is exactly 0 at step 0: nothing moved
            for p, p0 in zip(tp, params):
                np.testing.assert_array_equal(p.detach().numpy(), p0)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-6, rtol=0)
    assert opt.count == 3 and opt.total_notfinite == 1 and opt.notfinite_count == 0
    assert int(state.total_notfinite) == 1


def test_adamw_gives_up_after_consecutive_nonfinite():
    p = torch.nn.Parameter(torch.ones(3))
    opt = AdamW([p], TC.OptimConfig(learning_rate=0.1, warmup_ratio=0.0,
                                    skip_nonfinite_after=1, weight_decay=0.0))
    bad = torch.tensor([1.0, float("nan"), 1.0])
    opt.step([bad])
    assert opt.count == 0 and torch.equal(p.detach(), torch.ones(3))
    opt.step([bad])                 # 2 consecutive > 1: applied anyway
    assert opt.count == 1 and opt.notfinite_count == 2


def test_config_refuses_later_slices():
    """Pipeline parallelism is ported (parallel/pp.py): pp_micro constructs,
    and the trainer runs it under a mesh whose model axis is above 1."""
    assert TC.SFTConfig(pp_micro=2).pp_micro == 2
    # QLoRA is ported: the config constructs, and the trainer checks it
    assert TC.SFTConfig(frozen_dtype="int8").frozen_dtype == "int8"


# -- models: LoRA, fusion_forward ------------------------------------------------

def fusion_cfgs(**dec_kw):
    """JAX and port tiny configs, decoder head dim 64 (one the kernel takes)."""
    dec_kw = {"head_dim": 64, **dec_kw}
    jcfg = JC.FusionConfig.tiny(text_vocab=TOK.vocab_size, dna_pad_token_id=TOK.dna_pad_id)
    tcfg = TC.FusionConfig.tiny(text_vocab=TOK.vocab_size, dna_pad_token_id=TOK.dna_pad_id)
    return (dataclasses.replace(jcfg, decoder=dataclasses.replace(jcfg.decoder, **dec_kw)),
            dataclasses.replace(tcfg, decoder=dataclasses.replace(tcfg.decoder, **dec_kw)))


@functools.lru_cache(maxsize=None)
def lora_params():
    """JAX tiny fusion params with adapters whose B is nonzero."""
    jcfg, _ = fusion_cfgs()
    params = jax.jit(JF.init_fusion, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    lp = JL.attach_lora(jax.random.PRNGKey(1), params, JC.LoRAConfig(r=4, alpha=8))
    rng = np.random.default_rng(5)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: (x + rng.standard_normal(x.shape).astype(np.float32) * 0.05
                      if "lora_b" in jax.tree_util.keystr(p) else np.asarray(x)), lp)


@functools.lru_cache(maxsize=None)
def collated(n, seed, bucket=None):
    exs = [TK.format_kegg_for_dna_llm(it) for it in items(n, seed)]
    return TD.sft_collate(exs, PROC, 512, 64, bucket=bucket)


def model_args(batch):
    return tuple(t(batch[k]) for k in ("input_ids", "attention_mask", "dna_input_ids",
                                       "dna_attention_mask"))


def test_lora_attach_merge_strip_give_the_same_functions():
    """Attach (B = 0) keeps the function; merge folds a nonzero adapter into
    the weights at fp32 rounding (atol 1e-5); strip returns the base."""
    _, tcfg = fusion_cfgs()
    args = model_args(collated(2, 3))
    model = TF.init_fusion(tcfg, seed=0, device="cpu")
    with torch.no_grad():
        base, _ = TF.fusion_forward(model, tcfg, *args)
        TL.attach_lora(model, TC.LoRAConfig(r=4, alpha=8), torch.Generator().manual_seed(0))
        names = [n for n, _ in model.named_parameters() if "lora_a" in n]
        assert len(names) == 7 * tcfg.decoder.num_layers
        assert all(n.startswith("decoder.layers.") for n in names)
        torch.testing.assert_close(TF.fusion_forward(model, tcfg, *args)[0], base,
                                   atol=1e-6, rtol=0)
        gen = torch.Generator().manual_seed(1)
        for n, p in model.named_parameters():
            if "lora_b" in n:
                p.add_(torch.randn(p.shape, generator=gen) * 0.05)
        adapted, _ = TF.fusion_forward(model, tcfg, *args)
        assert (adapted - base).abs().max() > 1e-3
        merged = TL.merge_lora(copy.deepcopy(model))
        assert not TL.has_lora(merged) and TL.has_lora(model)
        torch.testing.assert_close(TF.fusion_forward(merged, tcfg, *args)[0], adapted,
                                   atol=1e-5, rtol=0)
        TL.strip_lora(model)
        torch.testing.assert_close(TF.fusion_forward(model, tcfg, *args)[0], base,
                                   atol=1e-6, rtol=0)


def test_from_jax_params_learns_lora_leaves():
    _, tcfg = fusion_cfgs()
    tree = lora_params()
    model = from_jax_params(tree, tcfg, device="cpu")
    q = model.decoder.layers[1].attn.q
    np.testing.assert_array_equal(q.lora_a.detach().numpy(),
                                  tree["decoder"]["layers"]["attn"]["q"]["lora_a"][1])
    np.testing.assert_array_equal(q.lora_b.detach().numpy(),
                                  tree["decoder"]["layers"]["attn"]["q"]["lora_b"][1])
    assert float(q.lora_scale) == 2.0
    assert q.lora_a.dtype == torch.float32 and model.dna_projection.weight.dtype == torch.float32


def jax_fusion_loss(jcfg, **static):
    def f(params, ids, am, dids, dam, **kw):
        return JF.fusion_forward(params, jcfg, ids, am, dids, dam, **kw, **static)[1]
    return jax.jit(jax.value_and_grad(f))


@pytest.mark.parametrize("mode", ["labels", "gathered", "focal_labels", "focal_gathered"])
def test_fusion_forward_loss_and_grads_match(mode):
    """Loss and the projection's gradient, LoRA adapters active; fp32,
    rtol 1e-5 on the loss, atol 1e-5 on gradients of size ~1e-2."""
    jcfg, tcfg = fusion_cfgs()
    tree = lora_params()
    batch = collated(2, 4)
    gamma = 2.0 if mode.startswith("focal") else 0.0
    kw = {}
    if mode.endswith("gathered"):
        pos, tgt, val = gather_label_positions(batch["labels"])
        kw = dict(label_positions=pos, label_targets=tgt, label_valid=val)
    else:
        kw = dict(labels=batch["labels"])
    jloss, jgrad = jax_fusion_loss(jcfg, focal_gamma=gamma)(
        tree, *(batch[k] for k in ("input_ids", "attention_mask", "dna_input_ids",
                                   "dna_attention_mask")), **{k: jnp.asarray(v) for k, v in kw.items()})
    model = from_jax_params(tree, tcfg, device="cpu")
    _, loss = TF.fusion_forward(model, tcfg, *model_args(batch), focal_gamma=gamma,
                                **{k: t(v) for k, v in kw.items()})
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    np.testing.assert_allclose(model.dna_projection.weight.grad.numpy(),
                               np.asarray(jgrad["dna_projection"]["kernel"]).T, atol=1e-5, rtol=0)
    np.testing.assert_allclose(model.decoder.layers[0].mlp.down.lora_b.grad.numpy(),
                               np.asarray(jgrad["decoder"]["layers"]["mlp"]["down"]["lora_b"][0]),
                               atol=1e-5, rtol=0)
    # the frozen encoder ran without autograd
    assert all(p.grad is None for p in model.encoder.parameters())


def test_cross_entropy_loss_matches():
    from bioreason_tpu.models.qwen3 import cross_entropy_loss as jce
    from bioreason_tpu_torch.models.qwen3 import cross_entropy_loss as tce
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, 9, 30)).astype(np.float32) * 3
    labels = rng.integers(0, 30, (2, 9))
    labels[:, :4] = -100
    assert float(tce(t(logits), t(labels))) == pytest.approx(float(jce(logits, labels)), rel=1e-6)


# -- the CLI ------------------------------------------------------------------------

def test_cli_train_sft_runs_and_checkpoint_round_trips(tmp_path):
    from bioreason_tpu_torch.cli import train_sft
    argv = ["--decoder", "tiny", "--encoder", "tiny", "--device", "cpu", "--max_steps", "2",
            "--max_length_dna", "64", "--n_synthetic", "16", "--batch_size", "2",
            "--checkpoint_dir", str(tmp_path), "--save_every", "1", "--eval_every", "2"]
    trainer = train_sft.main(argv)
    assert trainer.step == 2 and len(trainer.history) == 2
    assert all(math.isfinite(m["loss"]) for m in trainer.history)
    assert math.isfinite(trainer.history[-1]["val_loss"])
    saved = {n: p.detach().clone() for n, p in trainer.trainable_state().items()}
    with torch.no_grad():
        for p in trainer.params:
            p.zero_()
    trainer.restore(str(tmp_path / "sft_final"))
    assert trainer.step == 2 and trainer.opt.count == 2
    for n, p in trainer.trainable_state().items():
        assert torch.equal(p.detach(), saved[n]), n
    resumed = train_sft.main(argv + ["--resume", "--max_steps", "1"])
    assert resumed.step == 3


def test_cli_long_dna_trains_the_encoder_through_the_band(tmp_path):
    """`--dna_attention local:16 --dna_model_finetune` on the CPU: 2 finite
    steps over 512 bp items cut to 64 DNA tokens, the encoder on the banded
    route, and every encoder leaf moved from its seeded init."""
    from bioreason_tpu_torch.cli import train_sft
    trainer = train_sft.main(["--decoder", "tiny", "--encoder", "tiny", "--device", "cpu",
                              "--dna_attention", "local:16", "--dna_model_finetune",
                              "--max_steps", "2", "--max_length_dna", "64", "--n_synthetic",
                              "16", "--batch_size", "2", "--checkpoint_dir", str(tmp_path)])
    assert trainer.fusion_cfg.encoder.attention_impl == "local:16"
    assert len(trainer.history) == 2 and all(math.isfinite(m["loss"]) for m in trainer.history)
    init = TF.init_fusion(trainer.fusion_cfg, seed=42, device="cpu")
    state = trainer.trainable_state()
    enc = [(n, p) for n, p in init.named_parameters() if n.startswith("encoder.")]
    assert enc and all(n in state for n, _ in enc)
    assert all(not torch.equal(state[n].detach(), p) for n, p in enc)


def test_cli_rejects_an_unknown_dna_attention():
    from bioreason_tpu_torch.cli import train_sft
    with pytest.raises(SystemExit):
        train_sft.parse_args(["--dna_attention", "local:x"])


@pytest.mark.parametrize("flag", ["--sp_dna", "--dna_attention=sp_local:64",
                                  "--dna_attention=sp", "--mesh=1,1,1",
                                  "--cpu_devices=2", "--wandb"])
def test_cli_refuses_later_slices(flag, tmp_path):
    """--wandb is still refused. The multi-device flags are ported
    (parallel/): each trains one finite step (--sp_dna and the sp routes on
    a world of one rank, --cpu_devices=2 on two spawned gloo ranks)."""
    from bioreason_tpu_torch.cli import train_sft
    argv = ["--decoder", "tiny", "--encoder", "tiny", "--device", "cpu", flag]
    if flag == "--wandb":
        with pytest.raises(NotImplementedError):
            train_sft.main(argv)
        return
    out = train_sft.main(argv + ["--max_steps", "1", "--max_length_dna", "64",
                                 "--checkpoint_dir", str(tmp_path)])
    assert len(out.history) == 1 and math.isfinite(out.history[0]["loss"])


def plant_nan(monkeypatch):
    """Every rmsnorm's output times NaN: the first op that makes a NaN."""
    from bioreason_tpu_torch.models import layers as TLayers
    real = TLayers.rmsnorm
    monkeypatch.setattr(TLayers, "rmsnorm", lambda *a, **kw: real(*a, **kw) * float("nan"))


def test_cli_debug_nans_raises_at_a_planted_nan(tmp_path, monkeypatch):
    """`--debug_nans` (ported; was refused): a sound run trains as without
    it; with a NaN planted in every rmsnorm it raises FloatingPointError
    naming the op that made it, where the run without the flag goes on
    with a NaN loss (the optimizer's non-finite guard skips the step)."""
    from bioreason_tpu_torch.cli import train_sft
    argv = ["--decoder", "tiny", "--encoder", "tiny", "--device", "cpu", "--max_steps", "1",
            "--max_length_dna", "64", "--checkpoint_dir", str(tmp_path)]
    sound = train_sft.main(argv + ["--debug_nans"])
    assert sound.history[0]["loss"] == train_sft.main(argv).history[0]["loss"]
    plant_nan(monkeypatch)
    with pytest.raises(FloatingPointError, match="aten.mul"):
        train_sft.main(argv + ["--debug_nans"])
    assert math.isnan(train_sft.main(argv).history[0]["loss"])


def test_trainable_regexes():
    _, tcfg = fusion_cfgs()
    model = TF.init_fusion(tcfg, seed=0, device="cpu")
    TL.attach_lora(model, TC.LoRAConfig(r=4, alpha=8))
    lora = TT.set_trainable(model, TT.LORA_TRAINABLE)
    names = TT.trainable_names(model)
    assert len(lora) == len(names) == 2 * 7 * 2 + 2
    assert {"dna_projection.weight", "dna_projection.bias"} <= set(names)
    TT.set_trainable(model, TT.FULL_FINETUNE)
    names = TT.trainable_names(model)
    assert "decoder.embed.weight" in names and not any(n.startswith("encoder.") for n in names)
