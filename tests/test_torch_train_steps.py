"""The port's `SFTTrainer` against the JAX trainer: two steps with the
encoder frozen and trained, remat's dropout masks, gradient accumulation,
the trainer's own adapters. Split from test_torch_train.py, whose helpers
(configs, batches, the JAX LoRA tree) it shares.

Tiny configs in fp32 on the CPU; the JAX trainers are compiled once and
cached.
"""

import dataclasses
import functools
import math

import jax
import numpy as np
import pytest
import torch

from bioreason_tpu import config as JC
from bioreason_tpu.parallel import make_mesh
from bioreason_tpu.train.sft import SFTTrainer as JTrainer
from bioreason_tpu_torch import config as TC
from bioreason_tpu_torch.data import collate as TD
from bioreason_tpu_torch.data import kegg as TK
from bioreason_tpu_torch.models import fusion as TF
from bioreason_tpu_torch.ops.fused_ce import gather_label_positions
from bioreason_tpu_torch.train.sft import SFTTrainer
from bioreason_tpu_torch.weights import from_jax_params
from test_torch_train import LORA, PROC, collated, fusion_cfgs, lora_params, model_args, t

# one intra-op thread: the tensors here are tiny, and pytest-xdist runs
# several workers on the host's cores, which torch's default of a thread
# per core oversubscribes many times over
torch.set_num_threads(1)


# -- the slice as a whole: two trainer steps ----------------------------------------

def sft_cfgs(tcfg_cls, jcfg_cls):
    kw = dict(batch_size=2, max_length_dna=64, bucket=None, frozen_dtype="",
              optim=dict(learning_rate=1e-2, total_steps=20, warmup_ratio=0.0, eps=1e-3))
    make = lambda C: C.SFTConfig(**{**kw, "optim": C.OptimConfig(**kw["optim"]),
                                    "lora": C.LoRAConfig(**LORA)})
    return make(tcfg_cls), make(jcfg_cls)


@functools.lru_cache(maxsize=None)
def jax_run():
    """The JAX SFTTrainer on a one-device mesh: its initial parameters and
    the metrics and trainable leaves after each of two steps."""
    jcfg, _ = fusion_cfgs()
    _, jsft = sft_cfgs(TC, JC)
    trainer = JTrainer(jcfg, jsft, mesh=make_mesh(JC.MeshConfig(data=1), devices=jax.devices()[:1]))
    init = jax.tree.map(np.asarray, trainer.params)
    metrics = [trainer.train_step(collated(2, s)) for s in (10, 11)]
    final = jax.tree.map(np.asarray, trainer.params)
    return init, metrics, final


def flat_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_trainer_two_steps_match_jax(impl):
    """Per-step loss and grad-norm at 1e-5 relative. The port's decoder runs
    the grouped einsums ('xla') or the flash route's plain forward and
    backward ('pallas'; the JAX side stays on 'xla': the two differ only on
    fully masked pad rows, which no supervised position reads). Trainable
    leaves after two steps at atol 1e-5. Adam divides each gradient by its
    own RMS plus eps: with the default eps = 1e-8 an element whose gradient
    is near 0 (the adapters' A after one step from B = 0) moves by up to a
    full lr step in a direction set by fp noise, so both sides run with
    eps = 1e-3, which keeps the update a smooth function of the gradient
    (slope <= 0.53 / eps) while the rest of the arithmetic is unchanged."""
    init, jmetrics, jfinal = jax_run()
    _, tcfg = fusion_cfgs(attention_impl=impl)
    tsft, _ = sft_cfgs(TC, JC)
    trainer = SFTTrainer(tcfg, tsft, model=from_jax_params(init, tcfg, device="cpu"),
                         device="cpu")
    assert not any(n.startswith(("encoder.", "decoder.embed")) for n in trainer.names)
    for s, jm in zip((10, 11), jmetrics):
        m = trainer.train_step(collated(2, s))
        assert math.isfinite(m["loss"])
        assert m["loss"] == pytest.approx(jm["loss"], rel=1e-5)
        assert m["grad_norm"] == pytest.approx(jm["grad_norm"], rel=1e-5)
        assert m["lr"] == pytest.approx(jm["lr"], rel=1e-6)
    jf = flat_leaves(jfinal)
    state = trainer.trainable_state()
    n_lora = 0
    for name, p in state.items():
        parts = name.split(".")
        if parts[0] == "dna_projection":
            ref = jf[f"dna_projection/{'kernel' if parts[1] == 'weight' else 'bias'}"]
            ref = ref.T if parts[1] == "weight" else ref
        else:                                   # decoder.layers.<i>.<mod>.<lin>.lora_x
            i, mod, lin, leaf = int(parts[2]), parts[3], parts[4], parts[5]
            ref = jf[f"decoder/layers/{mod}/{lin}/{leaf}"][i]
            n_lora += 1
        np.testing.assert_allclose(p.detach().numpy(), ref, atol=1e-5, rtol=0, err_msg=name)
    assert n_lora == 2 * 7 * tcfg.decoder.num_layers


def jax_leaf(jf, name):
    """The JAX leaf of the port parameter `name` (dots, nn.Linear `weight`
    transposed) in the flat tree `jf` (slashes, stacked [L, ...] layers)."""
    parts = name.split(".")
    if len(parts) > 2 and parts[1] == "layers":     # <tower>.layers.<i>.<path>.<leaf>
        path, i = f"{parts[0]}/layers/{'/'.join(parts[3:-1])}", int(parts[2])
    else:
        path, i = "/".join(parts[:-1]), None
    leaf = parts[-1]
    key = ("embedding" if path.endswith("embed") else "kernel") if leaf == "weight" else leaf
    ref = jf[f"{path}/{key}"]
    ref = ref if i is None else ref[i]
    return ref.T if key == "kernel" else ref


def long_dna_collated(seed):
    """Two items of 2 x 240 bp: 41 DNA tokens per sequence, so a band of 16
    is narrower than the sequence."""
    exs = [TK.format_kegg_for_dna_llm(it)
           for it in TK.synthetic_kegg_items(2, seq_len=240, seed=seed)]
    return TD.sft_collate(exs, PROC, 512, 64, bucket=None)


@functools.lru_cache(maxsize=None)
def jax_run_unfrozen(enc_impl):
    """As `jax_run`, with the encoder trained (freeze_encoder=False) on
    attention_impl `enc_impl` and batches of longer DNA."""
    jcfg, _ = fusion_cfgs()
    jcfg = dataclasses.replace(jcfg, encoder=dataclasses.replace(jcfg.encoder,
                                                                 attention_impl=enc_impl))
    _, jsft = sft_cfgs(TC, JC)
    jsft = dataclasses.replace(jsft, freeze_encoder=False)
    trainer = JTrainer(jcfg, jsft, mesh=make_mesh(JC.MeshConfig(data=1), devices=jax.devices()[:1]))
    init = jax.tree.map(np.asarray, trainer.params)
    metrics = [trainer.train_step(long_dna_collated(s)) for s in (20, 21)]
    final = jax.tree.map(np.asarray, trainer.params)
    return init, metrics, final


@pytest.mark.parametrize("enc_impl", ["local:16", "xla"])
def test_trainer_unfrozen_encoder_two_steps_match_jax(enc_impl):
    """`freeze_encoder=False` (the CLI's --dna_model_finetune): the encoder's
    leaves become fp32 masters and train, through the banded route
    ('local:16': `LocalAttention` with its plain versions on the CPU against
    the interpret-mode Pallas kernels) or the grouped einsums ('xla'). Loss
    and grad-norm at rel 1e-5; LoRA, projection and encoder leaves after two
    steps at atol 1e-5, eps = 1e-3 on both sides (see
    test_trainer_two_steps_match_jax)."""
    init, jmetrics, jfinal = jax_run_unfrozen(enc_impl)
    _, tcfg = fusion_cfgs()
    tcfg = dataclasses.replace(tcfg, encoder=dataclasses.replace(tcfg.encoder,
                                                                 attention_impl=enc_impl))
    tsft, _ = sft_cfgs(TC, JC)
    tsft = dataclasses.replace(tsft, freeze_encoder=False)
    trainer = SFTTrainer(tcfg, tsft, model=from_jax_params(init, tcfg, device="cpu"),
                         device="cpu")
    enc_names = [n for n in trainer.names if n.startswith("encoder.")]
    assert len(enc_names) == len(list(trainer.model.encoder.parameters()))
    assert all(p.dtype == torch.float32 for p in trainer.params)
    before = {n: p.detach().clone() for n, p in trainer.trainable_state().items()}
    for s, jm in zip((20, 21), jmetrics):
        m = trainer.train_step(long_dna_collated(s))
        assert m["loss"] == pytest.approx(jm["loss"], rel=1e-5)
        assert m["grad_norm"] == pytest.approx(jm["grad_norm"], rel=1e-5)
    jf = flat_leaves(jfinal)
    state = trainer.trainable_state()
    for name, p in state.items():
        np.testing.assert_allclose(p.detach().numpy(), jax_leaf(jf, name), atol=1e-5, rtol=0,
                                   err_msg=name)
    moved = [n for n in enc_names if not torch.equal(state[n].detach(), before[n])]
    assert len(moved) == len(enc_names)


def test_remat_recomputes_the_same_dropout_masks():
    """Per-layer dropout generators are seeded before the layer runs, so a
    layer recomputed in backward (remat) draws the masks it drew forward:
    loss and gradients equal those without remat."""
    _, tcfg = fusion_cfgs()
    batch = collated(2, 13)
    pos, tgt, val = (t(x) for x in gather_label_positions(batch["labels"]))
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, decoder=dataclasses.replace(tcfg.decoder, remat=remat))
        model = from_jax_params(lora_params(), cfg, device="cpu")
        _, loss = TF.fusion_forward(model, cfg, *model_args(batch), label_positions=pos,
                                    label_targets=tgt, label_valid=val,
                                    lora_dropout_gen=torch.Generator().manual_seed(7),
                                    lora_dropout_rate=0.3)
        loss.backward()
        out.append((float(loss.detach()), model.decoder.layers[1].attn.q.lora_a.grad.clone()))
    assert out[0][0] == out[1][0]
    torch.testing.assert_close(out[0][1], out[1][1], atol=0, rtol=0)


def test_grad_accumulation_applies_the_mean_gradient():
    """Two micro-steps of one batch with grad_accum_steps=2 move the
    parameters as one step of that batch does (the mean of equal grads)."""
    _, tcfg = fusion_cfgs()
    batch = collated(2, 14)
    finals = []
    for k, steps in ((1, 1), (2, 2)):
        sft = TC.SFTConfig(batch_size=2, bucket=None, frozen_dtype="", grad_accum_steps=k,
                           lora=TC.LoRAConfig(**LORA),
                           optim=TC.OptimConfig(learning_rate=1e-2, warmup_ratio=0.0))
        trainer = SFTTrainer(tcfg, sft, model=from_jax_params(lora_params(), tcfg, device="cpu"),
                             device="cpu")
        for _ in range(steps):
            trainer.train_step(batch)
        assert trainer.opt.count == 1
        finals.append(torch.cat([p.detach().flatten() for p in trainer.params]))
    torch.testing.assert_close(finals[0], finals[1], atol=1e-6, rtol=0)


def test_trainer_attaches_adapters_and_trains_on_its_own():
    _, tcfg = fusion_cfgs()
    sft = TC.SFTConfig(batch_size=2, max_length_dna=64, bucket=None,
                       lora=TC.LoRAConfig(r=4, alpha=8, dropout=0.1),
                       optim=TC.OptimConfig(learning_rate=1e-2, total_steps=10))
    trainer = SFTTrainer(tcfg, sft, device="cpu")
    frozen = {n: p.detach().clone() for n, p in trainer.model.named_parameters()
              if not p.requires_grad}
    assert all(p.dtype == torch.float32 for p in trainer.params)
    # bf16 storage of the frozen leaves JAX stores in bf16: those of >= 2
    # dims and the per-layer norms (2-D [L, D] in JAX's stacked tree); the
    # final norm stays fp32
    assert trainer.model.decoder.layers[0].mlp.up.weight.dtype == torch.bfloat16
    assert trainer.model.decoder.layers[0].ln1.scale.dtype == torch.bfloat16
    assert trainer.model.decoder.final_norm.scale.dtype == torch.float32
    batch = collated(2, 12)
    losses = [trainer.train_step(batch)["loss"] for _ in range(4)]
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
    assert math.isfinite(trainer.eval_step(batch))
    for n, p in trainer.model.named_parameters():
        if n in frozen:
            assert torch.equal(p.detach(), frozen[n]), n
