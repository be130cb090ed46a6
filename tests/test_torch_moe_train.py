"""The port's MoE training against the JAX package: SFT (frozen bf16 and
int8, the kernel route's plain versions and the grouped einsums), the
router's adapters, GRPO updates, the full finetune's bank gradients, the
int8 bank product's backward, `train_sft` / `reason` on a `qwen3_moe`
directory and a MoE `sft_final` saved, rebuilt and served.

Tiny MoE decoders (E=4, k=2, I=32, head dim 64) in fp32 on the CPU with a
capacity factor of 1.0, so the drops bind in every call (counted by
wrapping `layers.moe_slots`) and parity covers them. Weights are drawn by
the JAX package and carried over by `from_jax_params`; the JAX trainers are
compiled once and cached."""

import dataclasses
import functools
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioreason_tpu import config as JC
from bioreason_tpu.models.fusion import init_fusion as j_init
from bioreason_tpu.parallel import make_mesh
from bioreason_tpu.train import grpo as JG
from bioreason_tpu.train import lora as JL
from bioreason_tpu.train import rewards as JR
from bioreason_tpu.train.sft import SFTTrainer as JSFT
from bioreason_tpu_torch import config as TC
from bioreason_tpu_torch.models import layers as L
from bioreason_tpu_torch.models.fusion import fusion_forward
from bioreason_tpu_torch.ops.fused_ce import gather_label_positions
from bioreason_tpu_torch.train import grpo as TG
from bioreason_tpu_torch.train import lora as TLoRA
from bioreason_tpu_torch.train import quant as TQ
from bioreason_tpu_torch.train import rewards as TR
from bioreason_tpu_torch.train.sft import SFTTrainer
from bioreason_tpu_torch.weights import from_jax_params
from test_torch_grpo import (CASES, CLEN, G, JPROC, PROC, fed, fixed_buffer, flat_leaves,
                             grpo_cfgs, indexed_reward)
from test_torch_grpo import fusion_cfgs as grpo_fusion_cfgs
from test_torch_moe import write_moe_dir
from test_torch_qlora import saved_tensors
from test_torch_train import collated, fusion_cfgs, jax_fusion_loss, t
from test_torch_train_steps import jax_leaf as dense_jax_leaf

# one intra-op thread: the tensors here are tiny, and pytest-xdist runs
# several workers on the host's cores, which torch's default of a thread
# per core oversubscribes many times over
torch.set_num_threads(1)

# the tiny MoE decoder: capacity factor 1.0 makes C = ceil(k * N / E), so
# any expert chosen by more than its share of the call's rows drops some
MOE = dict(head_dim=64, num_experts=4, num_experts_per_tok=2, moe_intermediate_size=32,
           moe_capacity_factor=1.0)
LORA = dict(r=4, alpha=8, dropout=0.0)
BANK = re.compile(r"\.experts\.(gate|up|down)\.weight$")


def jax_leaf(jf, name):
    """The JAX leaf of the port parameter `name` in the flat tree `jf`: an
    expert bank `<tower>.layers.<i>.mlp.experts.<gate|up|down>.weight` is
    the stacked [L, E, in, out] leaf `.../experts/<gate|up|down>` at layer
    i, in the same layout; anything else as `test_torch_train_steps.
    jax_leaf` maps it."""
    if BANK.search(name):
        parts = name.split(".")
        return jf[f"{parts[0]}/layers/{'/'.join(parts[3:-1])}"][int(parts[2])]
    return dense_jax_leaf(jf, name)


def moe_cfgs(impl="xla"):
    """(JAX, port) tiny fusion configs with the tiny MoE decoder, both
    decoders on attention route `impl`. The routes differ on fully masked
    pad rows (the mean of V on 'xla', 0 through the kernels), and a MoE
    reads those rows: they are routed and take capacity, so their values
    move the drops of real tokens. Each route is held to its own JAX
    route (the Pallas kernels in interpret mode)."""
    return fusion_cfgs(**MOE, attention_impl=impl)


def mesh():
    return make_mesh(JC.MeshConfig(data=1), devices=jax.devices()[:1])


@functools.lru_cache(maxsize=None)
def jax_init():
    """The JAX tiny MoE fusion tree (fp32, no adapters), as numpy."""
    jcfg, _ = moe_cfgs()
    return jax.tree.map(np.asarray, jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(0),
                                                                       jcfg))


def with_lora(tree, seed=0):
    """`tree` with the adapters a JAX SFT trainer of `seed` attaches."""
    return jax.tree.map(np.asarray, JL.attach_lora(
        jax.random.fold_in(jax.random.PRNGKey(seed), 1), tree, JC.LoRAConfig(**LORA)))


class DropCount:
    """Counts the (token, choice) pairs `layers.moe_slots` drops."""

    def __init__(self, monkeypatch):
        self.dropped = self.pairs = 0
        real = L.moe_slots

        def counting(idx, num_experts, cap):
            slot, keep = real(idx, num_experts, cap)
            self.dropped += int((~keep).sum())
            self.pairs += keep.numel()
            return slot, keep
        monkeypatch.setattr(L, "moe_slots", counting)


# -- SFT ------------------------------------------------------------------------------

def sft_cfgs(frozen, **kw):
    opt = dict(learning_rate=1e-2, total_steps=20, warmup_ratio=0.0, eps=1e-3)
    base = dict(batch_size=2, max_length_dna=64, bucket=None, frozen_dtype=frozen, **kw)
    return tuple(C.SFTConfig(**base, optim=C.OptimConfig(**opt), lora=C.LoRAConfig(**LORA))
                 for C in (TC, JC))


@functools.lru_cache(maxsize=None)
def jax_sft_run(impl, frozen):
    """The JAX SFTTrainer's metrics and flat parameters after two steps on
    the MoE decoder (attention route `impl`), frozen leaves stored as
    `frozen`."""
    jcfg, _ = moe_cfgs(impl)
    _, jsft = sft_cfgs(frozen)
    trainer = JSFT(jcfg, jsft, mesh=mesh(), params=jax_init())
    metrics = [trainer.train_step(collated(2, s)) for s in (10, 11)]
    return metrics, flat_leaves(jax.tree.map(np.asarray, trainer.params))


def port_sft(impl, frozen):
    _, tcfg = moe_cfgs(impl)
    tsft, _ = sft_cfgs(frozen)
    return SFTTrainer(tcfg, tsft, model=from_jax_params(with_lora(jax_init()), tcfg,
                                                        device="cpu"), device="cpu")


@pytest.mark.parametrize("frozen", ["bfloat16", "int8"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_sft_two_steps_match_jax(impl, frozen, monkeypatch):
    """Two SFT steps through the MoE decoder against the JAX trainer: loss
    and grad norm at rel 1e-5, every trainable leaf (the adapters of q, k,
    v, o and the router, the projection) at atol 1e-5 (Adam eps 1e-3 on
    both sides, see test_torch_train_steps). Frozen leaves bf16, or int8
    (QLoRA: the banks and the router int8 with bf16 scales) as both trainers
    store them; the drops bind in both steps. The banks stay frozen: they
    have no `kernel` leaf in JAX and no nn.Linear here."""
    jmetrics, jfinal = jax_sft_run(impl, frozen)
    drops = DropCount(monkeypatch)
    trainer = port_sft(impl, frozen)
    for s, jm in zip((10, 11), jmetrics):
        m = trainer.train_step(collated(2, s))
        assert math.isfinite(m["loss"])
        assert m["loss"] == pytest.approx(jm["loss"], rel=1e-5)
        assert m["grad_norm"] == pytest.approx(jm["grad_norm"], rel=1e-5)
    assert drops.dropped > 0, "the capacity must bind for parity to cover the drops"
    for name, p in trainer.trainable_state().items():
        np.testing.assert_allclose(p.detach().numpy(), jax_leaf(jfinal, name), atol=1e-5,
                                   rtol=0, err_msg=name)
    n_layers = trainer.fusion_cfg.decoder.num_layers
    assert len(trainer.names) == 2 * 5 * n_layers + 2
    banks = [m for m in trainer.model.modules() if isinstance(m, L.ExpertBank)]
    assert len(banks) == 3 * n_layers
    want = torch.int8 if frozen == "int8" else torch.bfloat16
    assert all(b.weight.dtype == want and not b.weight.requires_grad for b in banks)
    if frozen == "int8":
        # JAX's bank scales [L, E, 1, out] are frozen leaves of ndim >= 2: bf16
        assert all(b.scale.dtype == torch.bfloat16 for b in banks)
        for i, layer in enumerate(trainer.model.decoder.layers):
            for n in ("gate", "up", "down"):
                bank = getattr(layer.mlp.experts, n)
                np.testing.assert_array_equal(
                    bank.weight.numpy(), jfinal[f"decoder/layers/mlp/experts/{n}/q"][i])
                np.testing.assert_array_equal(
                    bank.scale.float().numpy(),
                    jfinal[f"decoder/layers/mlp/experts/{n}/scale"][i].astype(np.float32))


def test_router_adapters_train_as_jax_and_take_no_dropout(monkeypatch):
    """The router is an nn.Linear: `attach_lora` gives it an adapter, as JAX
    gives `mlp/router` one (a `kernel` leaf); after two steps its A and B
    moved and equal JAX's. Under LoRA dropout every adapted projection of
    the attention draws a mask, the router none (`moe_route` calls `dense`
    without one, as JAX `moe_apply` does)."""
    jmetrics, jfinal = jax_sft_run("xla", "bfloat16")
    trainer = port_sft("xla", "bfloat16")
    start = {n: p.detach().clone() for n, p in trainer.trainable_state().items()}
    for s in (10, 11):
        trainer.train_step(collated(2, s))
    routers = [n for n in trainer.names if ".mlp.router.lora_" in n]
    assert len(routers) == 2 * trainer.fusion_cfg.decoder.num_layers
    state = trainer.trainable_state()
    for name in routers:
        assert not torch.equal(state[name].detach(), start[name]), name
        np.testing.assert_allclose(state[name].detach().numpy(), jax_leaf(jfinal, name),
                                   atol=1e-5, rtol=0, err_msg=name)
    seen = []
    real = L.dense

    def recording(lin, x, dtype=None, dropout=None, act8=False):
        seen.append((lin, dropout))
        return real(lin, x, dtype, dropout, act8)
    monkeypatch.setattr(L, "dense", recording)
    _, tcfg = moe_cfgs()
    tsft, _ = sft_cfgs("bfloat16")
    tsft = dataclasses.replace(tsft, lora=TC.LoRAConfig(r=4, alpha=8, dropout=0.5))
    dropped = SFTTrainer(tcfg, tsft, model=from_jax_params(with_lora(jax_init()), tcfg,
                                                           device="cpu"), device="cpu")
    dropped.train_step(collated(2, 10))
    dec = dropped.model.decoder
    router_ids = {id(layer.mlp.router) for layer in dec.layers}
    attn_ids = {id(getattr(layer.attn, n)) for layer in dec.layers for n in "qkvo"}
    assert any(id(lin) in router_ids for lin, _ in seen)
    assert all(d is None for lin, d in seen if id(lin) in router_ids)
    assert all(d is not None for lin, d in seen if id(lin) in attn_ids)


def test_full_finetune_bank_gradients_match_jax():
    """`lora=None` trains the decoder whole (`FULL_FINETUNE`): the expert
    banks and the router are trainable fp32 masters, and their gradients
    of one step equal JAX's `value_and_grad` of the same loss on the same
    weights and batch (atol 1e-5 of each tensor's largest magnitude)."""
    jcfg, tcfg = moe_cfgs()
    tree = jax_init()
    batch = collated(2, 10)
    pos, tgt, val = gather_label_positions(batch["labels"])
    jloss, jgrad = jax_fusion_loss(jcfg)(
        tree, *(batch[k] for k in ("input_ids", "attention_mask", "dna_input_ids",
                                   "dna_attention_mask")),
        label_positions=jnp.asarray(pos), label_targets=jnp.asarray(tgt),
        label_valid=jnp.asarray(val))
    tsft, _ = sft_cfgs("")
    trainer = SFTTrainer(tcfg, dataclasses.replace(tsft, lora=None),
                         model=from_jax_params(tree, tcfg, device="cpu"), device="cpu")
    banks = [n for n in trainer.names if BANK.search(n)]
    assert len(banks) == 3 * tcfg.decoder.num_layers
    assert all(trainer.trainable_state()[n].dtype == torch.float32 for n in banks)
    grads = {}
    real = trainer.opt.accumulate

    def capture(gs, steps):
        grads.update(zip(trainer.names, gs))
        return real(gs, steps)
    trainer.opt.accumulate = capture
    m = trainer.train_step(batch)
    assert m["loss"] == pytest.approx(float(jloss), rel=1e-5)
    jf = flat_leaves(jax.tree.map(np.asarray, jgrad))
    for name in banks + [n for n in trainer.names if n.endswith("mlp.router.weight")]:
        want = jax_leaf(jf, name)
        np.testing.assert_allclose(grads[name].numpy(), want,
                                   atol=1e-5 * max(1.0, float(np.abs(want).max())), rtol=0,
                                   err_msg=name)


# -- the int8 bank product --------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_bank_product_keeps_the_int8_bank(dtype):
    """`Int8Bank` (through `bank_product`) equals `torch.bmm` on
    `expert_bank` bit for bit, forward and d(input), and autograd saves the
    int8 bank and its scale, no float [E, in, out] tensor; the plain bmm on
    the dequantized bank would save one."""
    rng = np.random.default_rng(3)
    e, c, d_in, d_out = 4, 5, 16, 24
    bank = L.ExpertBank(e, d_in, d_out)
    with torch.no_grad():
        bank.weight.copy_(t(rng.standard_normal((e, d_in, d_out)).astype(np.float32)))
    TQ.store_int8(bank, *TQ.quantize_bank_int8(bank.weight))
    x0 = t(rng.standard_normal((e, c, d_in)).astype(np.float32)).to(dtype)
    g = t(rng.standard_normal((e, c, d_out)).astype(np.float32)).to(dtype)
    x = x0.clone().requires_grad_()
    y, saved = saved_tensors(lambda: L.bank_product(x, bank, dtype))
    x_ref = x0.clone().requires_grad_()
    y_ref, saved_ref = saved_tensors(lambda: torch.bmm(x_ref, L.expert_bank(bank, dtype)))
    assert torch.equal(y, y_ref)
    (dx,) = torch.autograd.grad(y, x, g)
    (dx_ref,) = torch.autograd.grad(y_ref, x_ref, g)
    assert torch.equal(dx, dx_ref)
    assert ((e, d_in, d_out), torch.int8) in saved
    assert not any(s == (e, d_in, d_out) and dt.is_floating_point for s, dt in saved)
    assert ((e, d_in, d_out), dtype) in saved_ref


# -- GRPO -------------------------------------------------------------------------------

def grpo_moe_cfgs():
    return grpo_fusion_cfgs(**MOE)


@functools.lru_cache(maxsize=None)
def jax_grpo_params():
    jcfg, _ = grpo_moe_cfgs()
    return jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)


def jax_logps(params, buf):
    jcfg, _ = grpo_moe_cfgs()
    fn = jax.jit(JG.per_token_logps, static_argnames=("cfg", "completion_len"))
    return np.asarray(fn(params, jcfg, buf["full_ids"], buf["full_mask"], buf["dna_input_ids"],
                         buf["dna_attention_mask"], completion_len=CLEN))


@functools.lru_cache(maxsize=None)
def jax_grpo_run(case):
    """The JAX GRPOTrainer's two steps on the fixed buffer with the MoE
    decoder (see test_torch_grpo.jax_run)."""
    jcfg, _ = grpo_moe_cfgs()
    _, jg = grpo_cfgs(**CASES[case])
    tr = JG.GRPOTrainer(jcfg, jg, JPROC, [indexed_reward, JR.correctness_reward], mesh=mesh(),
                        params=jax_grpo_params())
    init = jax.tree.map(np.asarray, tr.params)
    buf = dict(fixed_buffer())
    rng = np.random.default_rng(12)
    noise = lambda: (rng.standard_normal((2 * G, CLEN)) * 0.3).astype(np.float32)
    if tr.cfg.beta > 0.0:
        buf["ref_logps"] = jax_logps(tr._ref_params, buf) + noise()
    if tr.cfg.num_iterations > 1:
        buf["old_logps"] = jax_logps(tr.params, buf) + noise()
    fed(tr, {k: jnp.asarray(v) for k, v in buf.items()})
    metrics = [tr.step([]) for _ in range(2)]
    final = flat_leaves(jax.tree.map(np.asarray, tr.params))
    ref_logps = jax_logps(tr._ref_params, buf) if tr.cfg.beta > 0.0 else None
    return init, buf, metrics, final, ref_logps


@pytest.mark.parametrize("case", sorted(CASES))
def test_grpo_two_updates_match_jax(case, monkeypatch):
    """Two GRPO updates of each trainer on one fixed rollout buffer through
    the MoE decoder: loss, kl, clip_ratio and grad_norm at rel 1e-5, the
    trainable leaves (the router's adapters among them) at atol 1e-5, the
    drops binding. Case "kl" (beta > 0, TR-DPO sync after step 2) then
    holds the synced reference's logps at atol 1e-4 (its bf16 weights
    merged from adapters that agree at ~1e-7; test_torch_grpo says why).
    The buffer carries JAX's initial tree, banks included (`jax_leaf`)."""
    init, buf, jmetrics, jfinal, jref_logps = jax_grpo_run(case)
    _, tcfg = grpo_moe_cfgs()
    tg, _ = grpo_cfgs(**CASES[case])
    drops = DropCount(monkeypatch)
    trainer = fed(TG.GRPOTrainer(tcfg, tg, PROC, [indexed_reward, TR.correctness_reward],
                                 model=from_jax_params(init, tcfg, device="cpu"), device="cpu"),
                  {k: t(v) for k, v in buf.items()})
    for jm in jmetrics:
        m = trainer.step([])
        for key in ("loss", "kl", "clip_ratio", "grad_norm"):
            assert math.isfinite(m[key])
            assert m[key] == pytest.approx(jm[key], rel=1e-5, abs=1e-7), key
    assert drops.dropped > 0
    assert any(".mlp.router.lora_" in n for n in trainer.names)
    for name, p in trainer.trainable_state().items():
        np.testing.assert_allclose(p.detach().numpy(), jax_leaf(jfinal, name), atol=1e-5,
                                   rtol=0, err_msg=name)
    if jref_logps is not None:
        with torch.no_grad():
            ref = TG.per_token_logps(trainer.ref_model, trainer.fusion_cfg,
                                     *(t(buf[k]) for k in ("full_ids", "full_mask",
                                                           "dna_input_ids",
                                                           "dna_attention_mask")), CLEN)
        np.testing.assert_allclose(ref.numpy(), jref_logps, atol=1e-4, rtol=0)


# -- the CLIs and the checkpoint round trip -------------------------------------------

@pytest.fixture(scope="module")
def moe_dirs(tmp_path_factory):
    """A tiny `qwen3_moe` directory with a byte-level BPE tokenizer (the
    vocab 8 rows past it) and a tiny NT-v2 one."""
    from test_torch_pretrained import write_nt_dir, write_tokenizer
    root = tmp_path_factory.mktemp("moe_hf")
    llm, nt = root / "moe", root / "nt"
    hf = write_tokenizer(str(llm))
    write_moe_dir(llm, vocab=len(hf) + 8)
    write_nt_dir(str(nt))
    return str(llm), str(nt)


@pytest.fixture(scope="module")
def moe_sft_final(moe_dirs, tmp_path_factory):
    """`train_sft --hf_llm_dir <qwen3_moe>` for 2 steps at fp32."""
    from bioreason_tpu_torch.cli import train_sft
    llm, nt = moe_dirs
    root = str(tmp_path_factory.mktemp("moe_sft"))
    trainer = train_sft.main(["--hf_llm_dir", llm, "--hf_dna_dir", nt, "--device", "cpu",
                              "--dtype", "float32", "--max_steps", "2", "--batch_size", "2",
                              "--n_synthetic", "8", "--max_length_dna", "64",
                              "--max_length_text", "256", "--lora_r", "4", "--lora_alpha", "8",
                              "--lora_dropout", "0", "--learning_rate", "1e-2", "--seed", "5",
                              "--checkpoint_dir", root])
    return root, trainer


def test_train_sft_and_reason_on_a_qwen3_moe_dir(moe_dirs, moe_sft_final, tmp_path):
    """`train_sft` and `reason` accept a `qwen3_moe` `--hf_llm_dir`: the
    MoE config comes from its config.json, two finite SFT steps train the
    routers' adapters, and `reason --sft_checkpoint` runs a finite GRPO
    step from the sft_final (its adapters merged, the routers' among them,
    and fresh ones attached)."""
    from bioreason_tpu_torch.cli import reason
    llm, nt = moe_dirs
    root, trainer = moe_sft_final
    dec = trainer.fusion_cfg.decoder
    assert (dec.num_experts, dec.moe_intermediate_size, dec.norm_topk_prob) == (4, 24, False)
    assert trainer.step == 2 and all(math.isfinite(m["loss"]) for m in trainer.history)
    assert sum(".mlp.router.lora_" in n for n in trainer.names) == 2 * dec.num_layers
    gr = reason.main(["--hf_llm_dir", llm, "--hf_dna_dir", nt, "--device", "cpu",
                      "--dtype", "float32", "--sft_checkpoint", f"{root}/sft_final",
                      "--seed", "5", "--max_steps", "1", "--num_generations", "2",
                      "--batch_size", "2", "--n_synthetic", "4", "--max_completion_length", "8",
                      "--max_length_dna", "64", "--max_length_text", "256", "--lora_r", "4",
                      "--lora_alpha", "8", "--checkpoint_dir", str(tmp_path / "ck"),
                      "--log_dir", str(tmp_path / "logs")])
    assert gr.fusion_cfg.decoder.num_experts == 4
    assert gr.metrics_history and math.isfinite(gr.metrics_history[-1]["loss"])
    assert any(".mlp.router.lora_" in n for n in gr.names)


def hf_batch(tok, dna_tok, seed):
    """Two KEGG items collated with the directory's tokenizers."""
    from bioreason_tpu_torch.data import BioProcessor
    from bioreason_tpu_torch.data import collate as TD
    from bioreason_tpu_torch.data import kegg as TK
    exs = [TK.format_kegg_for_dna_llm(it) for it in TK.synthetic_kegg_items(2, seq_len=40,
                                                                             seed=seed)]
    return TD.sft_collate(exs, BioProcessor(tok, dna_tok), 256, 64)


def tensors(model):
    return {**dict(model.named_parameters()), **dict(model.named_buffers())}


@pytest.mark.parametrize("frozen", ["bfloat16", "int8"])
def test_moe_sft_final_rebuilds_and_serves(moe_dirs, tmp_path, frozen):
    """A MoE SFT trainer on the pretrained base (the Python API; frozen bf16
    or QLoRA) saves an sft_final that `rebuild_sft` builds again with the
    MoE config: every parameter and buffer equal to the trainer's, dtype
    included (the banks and routers int8 with bf16 scales under QLoRA), the
    logits equal. `serve --checkpoint` keeps a QLoRA model's adapters
    beside its int8 weights and answers the trainer model's greedy tokens;
    over bf16 weights it merges them, the routers' too (`merge_lora`: no
    adapter left, each router's weight the fold of its adapter, the typical
    logit within bf16 rounding of the unmerged model's)."""
    from bioreason_tpu_torch import serve
    from bioreason_tpu_torch.train.checkpoint import rebuild_sft
    from bioreason_tpu_torch.utils.pretrained import base_record, load_pretrained_fusion
    llm, nt = moe_dirs
    cfg, model, tok, dna_tok = load_pretrained_fusion(llm, nt, 256, 64, seed=5,
                                                      dtype="float32", device="cpu")
    tsft, _ = sft_cfgs(frozen, seed=5)
    trainer = SFTTrainer(cfg, tsft, model=model, base=base_record(llm, nt, None), device="cpu")
    for s in (10, 11):
        assert math.isfinite(trainer.train_step(hf_batch(tok, dna_tok, s))["loss"])
    path = str(tmp_path / "sft_final")
    trainer.save(path)
    rcfg, rebuilt, _, _ = rebuild_sft(path, device="cpu", max_length_text=256,
                                      max_length_dna=64)
    assert rcfg.decoder == cfg.decoder and rcfg.decoder.num_experts == 4
    want, got = tensors(trainer.model), tensors(rebuilt)
    assert sorted(got) == sorted(want)
    for name, v in got.items():
        assert v.dtype == want[name].dtype and torch.equal(v, want[name]), name
    if frozen == "int8":
        bank = rebuilt.decoder.layers[0].mlp.experts.gate
        assert bank.weight.dtype == torch.int8 and bank.scale.dtype == torch.bfloat16
    batch = {k: torch.as_tensor(np.asarray(v)) for k, v in hf_batch(tok, dna_tok, 12).items()
             if k in ("input_ids", "attention_mask", "dna_input_ids", "dna_attention_mask")}

    def logits(m):
        with torch.no_grad():
            return fusion_forward(m, cfg, **batch)[0]
    ref = logits(trainer.model)
    assert torch.equal(logits(rebuilt), ref)
    server = serve.build_server(checkpoint=path, device="cpu", max_length_dna=64)
    assert server.cfg.decoder.num_experts == 4
    if frozen == "int8":
        assert TLoRA.has_lora(server.model)
        items = [{"question": f"Is variant {k} pathogenic?", "answer": "",
                  "reference_sequence": "ACGTTGCA" * (k + 2),
                  "variant_sequence": "ACGTAGCA" * (k + 2)} for k in range(2)]
        inputs = serve.prepare_batch(server.processor, server.cfg, items)
        for a, b in zip(*(server.engine.generate(m, *inputs, max_new_tokens=6, greedy=True)
                          for m in (server.model, trainer.model))):
            np.testing.assert_array_equal(a, b)
        with pytest.raises(ValueError, match="int8 weights"):
            TLoRA.merge_lora(rebuilt)
    else:
        assert not TLoRA.has_lora(server.model)
        router = rebuilt.decoder.layers[1].mlp.router
        np.testing.assert_array_equal(
            server.model.decoder.layers[1].mlp.router.weight.float().numpy(),
            TLoRA.merged_weight(router).float().numpy())
        merged = logits(server.model)
        assert torch.equal(merged, logits(TLoRA.merge_lora(rebuilt)))
        # the fold rounds each merged weight to bf16; a router whose top-k
        # then flips moves a token's logits by O(1), so the bound is on the
        # typical logit, not the largest
        diff = (merged - ref).abs().flatten()
        assert float(diff.median()) <= 1e-2 * float(ref.abs().max())
